#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: ``python3 chip_smoke.py`` from the repo root.

Phases, one or more lines each; any failure raises and the script exits 1
without its final line:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
2. build: nvcc builds the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card,
   bf16 and fp32: flash at musicgen-large, qwen2-7b, kimi-k2 (hd 112)
   and qwen3-14b's 20 heads a rank under tensor parallelism (ragged
   lengths); decode at G 1, 2, 5, 7 and 8 over the head dims and G 1, 7
   and 8 at hd 112 (musicgen, qwen2, qwen3 whole and at 20/4 heads a
   rank, arctic and kimi-k2 heads among them), each with a row of length
   0, one
   at cap and rows ending mid-split, shuffled pages, paged == contiguous
   bit for bit and two calls of each equal bit for bit; decode and paged
   decode at the dsp fleet's shape (musicgen's heads, page size 8, a
   48-position cache, table tails on the null page); moe_gmm at the C
   of every arctic-480b and jamba-smoke prefill group and decode step
   (every instance: C tile, 16-byte or element-wise loads, split over d
   or not), ssd_scan at every mamba2-1.3b and jamba-smoke prefill group
   shape, at mamba2's 32 heads a rank under tensor parallelism, grouped,
   and at each (hp, ds) instance; then the device
   kernels one call of each wrapper runs at phase 5's shapes
   (torch.profiler). After arctic's and kimi-k2's serve runs, moe_gmm
   with the filled counts of a decode step and of the largest prefill
   group, from ``route`` + ``dispatch`` on the path's weights (rows past
   a count must be exact zero).
4. serve: six paths, one model resident at a time (weights from a
   seeded ``torch.Generator``): musicgen-large at full width and depth,
   mamba2-1.3b at full width and depth, qwen3-14b at full width and depth
   (27.51 GiB of bf16 weights: the first full-size dense GQA model with
   QK-norm), arctic-480b at full width cut to
   2 of its 35 layers (its 128 experts take 26.8 GB a layer), kimi-k2 at
   published widths cut to 1 of its 61 layers (hd 112; its 384 experts
   take 33.8 GB a layer), and jamba-1.5-large at its smoke config (a
   wiring check: full width does not fit one card). Each serves 16
   requests through ``Engine.run``,
   contiguous and then paged; tokens and finish order must agree, every
   page must come back, and the launch counters, set to 0 just before
   each run and read just after, must show that every prefill and decode
   step went through the path's kernels; on the MoE paths, ``plan`` at
   every C and weight of the path must pick the bf16 tensor-core design
   with 16-byte loads. A 2-layer cut of musicgen
   and of mamba2 at full width in fp32 is held against the CPU's plain
   path. The contiguous runs of qwen3, mamba2 and arctic record their
   first decode step for the parallel phase.
parallel. serving across ranks (``repro_torch.parallel``): a world of 2
   ranks on the card over gloo (``torch.multiprocessing.spawn``), phase
   4's weights (each rank draws the whole stream and keeps its slices)
   and requests. (T1) qwen3-14b at full width and depth, tensor-parallel
   (heads, MLP and vocab halved: 13.76 GiB a rank), contiguous and paged,
   equal tokens; (T3) mamba2-1.3b at full width and depth, its 64 SSM
   heads split 32 a rank; (A) arctic's 2-layer cut, tensor- and
   expert-parallel (64 of 128 experts a rank, 64 router columns); each
   held against phase 4's first decode step by ``check_tp_run``. (B) adds
   to (A) the sequence-sharded decode cache and ring prefill, held
   against (A) by ``check_seq_run``, with its two collectives at the
   path's shapes against the decode and flash kernels. (C) is (A) with
   the sequence-sharded decode cache alone: attention on the column path
   (its leaves column-cut, q, k, v gathered whole), prefill split by
   padded heads, 28 a rank through the flash kernel, held against (A) by
   ``check_seq_run``. T3's 2-layer fp32 cut of mamba2 at published
   widths against one rank on the card ((T2), qwen3's, went for time in
   PR 26: T1 and tp-train's (f1) hold qwen3's split). The launch counters and the head counts each kernel saw show
   every step through the kernels at the rank's heads. Per rank:
   backend, bytes held against the whole model, peak memory, prefill ms
   a group and decode ms a step beside phase 5's one-rank numbers.
batch. serving with the batch split over the batch axes (``Runtime.rows``,
   the ``Engine``'s slots): a world of BATCH_WORLD gloo ranks on the card
   at (data BATCH_WORLD) (``launch.world.spawn_world``), each holding 4 of
   the 8 slots, their caches and pages, and computing only its rows. (h1)
   BATCH_ARCH (musicgen-large) at published widths and depth serves phase
   4's 16 requests, contiguous then paged: every rank's tokens and finish
   order equal phase 4's one-rank run; the first admit window's prefill
   logits (its 512-token group split, both rows moving to the other
   rank's slots) and the first decode step on the rank's rows within
   BATCH_LOGITS_TOL of one rank's (bit-equal at 0); a rank's caches
   exactly half of one rank's bytes (``launch.counter.storage_bytes``)
   and its page pool 1 + 4 x 8 pages; it prints the peak memory, prefill
   ms a group with the seconds of the rows' moves, and decode ms a step
   beside phase 5's one rank. (h2) jamba's smoke config in fp32 at
   capacity factor 0.5 (all five kernels), against one rank on the card:
   tokens equal, the first window's logits within REF_TOL on each rank's
   rows, the assignments each MoE call drops summed over the ranks equal
   one rank's call by call (C and the fill over the whole batch at
   model 1). Launches, set to 0 just before each engine run and read just
   after, go into the kernels line.
dsp. the DSP control plane on musicgen-large at full width, depth cut to
   DSP_LAYERS of 48 (``benchmarks/torch_serve_fleet.py``, max_batch 8,
   max_len 48; phase 4 serves it at full depth): a
   ``ServeDriver`` on one Montage DAG (paged), equal to its
   ``EmulatedEngine`` twin, then the mix-1/2/4 fleet, 1 workflow per
   tenant, paged (page size 8), contiguous (the decode kernel's split at 8
   positions) and on its twin: every ``FleetStats`` field equal, every
   request's tokens equal paged and contiguous bit for bit, no
   over-admission or isolation violation,
   the page ledgers equal; decode steps, wall seconds, ms per decode step
   and billed / dedicated node-hours printed.
5. times: per path, prefill ms per group, decode ms per step, tokens/s,
   peak device memory and the device-busy share of a decode step under
   torch.profiler; then CUDA-event times of each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call, at the shapes of phase 4 and of the tensor-parallel runs (flash,
   decode and paged decode at qwen3's 20/4 heads a rank, ssd_scan at
   mamba2's 32), beside the least time the card could
   take, and the device kernels per call from phase 3: flash at
   musicgen's, arctic's and kimi-k2's heads (SDPA pinned to its flash
   backend), decode and paged decode at the same three (SDPA with a
   length mask beside), ssd_scan at each mamba2 prefill group shape with
   every hp tile of its bf16 grid, moe_gmm at C 1 and 30 with every row
   filled (beside torch.bmm) and at a real decode step's counts (bound on
   the filled experts' weights); and moe_gmm at every C of arctic's path,
   with the counts of the call that gives it, at several splits over d
   beside the one ``plan`` picks (the measurements its split rule rests
   on).

dryrun. the dry run (``repro_torch.launch.dryrun``) against the card:
   (a) for musicgen-large and qwen3-14b (DRYRUN_ARCHS), after phase 5, a
   prefill group (2 x 512) and a decode step (batch 8 over a 1024-deep
   cache) of phase 5's shapes, run on meta tensors (on the host) and on
   the card: the dry run's launches by kernel must equal
   ``ops.launch_counts()`` on the card, and its params, cache and batch
   bytes the live tensors'; its predicted peak is printed beside
   ``max_memory_allocated`` with the gap, and (c) its counted FLOPs over
   the card's step time as a share of the bf16 peak (a report). (b) In
   the parallel phase's T1, each rank records the collectives of one
   prefill group and one decode step; they must equal, in order, kind,
   dtype, bytes and group, the dry run's for the same rank of a fake
   group at mesh (1, 2).

train. the HTC training job (``repro_torch.train``), which reaches no
   kernel (the kernels are forward-only; every launch counter stays 0
   across the phase): (a) a 2-layer cut of musicgen-large at published
   widths in fp32, seq 512, batch 2: loss and every gradient leaf on the
   card against the CPU's on the same weights and batch; (b) the same cut
   in bf16 through ``train_loop``: 12 steps with checkpoints every 4 and
   a preemption before step 6, whose 14 losses equal the uninterrupted
   run's step for step, bit for bit, and fall; one loss and backward under
   ``torch.use_deterministic_algorithms``; (c) musicgen-large at full
   width and depth in bf16, seq 4096, batch 8 in 8 microbatches, remat
   per layer: 1 step from a fresh init with seconds, tokens/s and model
   FLOPs as a share of the bf16 peak per step, the peak device memory,
   and one microbatch under torch.profiler (busy share, top items); (d)
   jamba's smoke config (Mamba2, attention and MoE in one stack) in fp32,
   card against CPU as in (a). (a) and (d) each end with a control: the
   card's gradients with TF32 products, which their bound must reject.

elastic. the live ``ElasticController`` (``repro_torch.core.controller``)
   on mix D of ``benchmarks/torch_elastic.py``: DSP policies grant,
   grow, shrink, preempt and destroy two training jobs of the (b) cut
   (2 layers of musicgen-large at published widths, bf16, seq 512, batch
   2) on a pool of 4 slots of the card. Its decisions must equal a stub
   segment's, each job's losses a straight ``train_loop`` run's bit for
   bit (train-0 replays step 3 after its preemption), nothing may stay
   allocated after the destroy, and no kernel may launch; it prints each
   segment's entry (init or restore), steps and save times, each job's
   share of wall time in checkpoint I/O and tokens/s inside the steps,
   the node-ticks billed, the peak device memory and the phase's wall.

dp. data-parallel training (``train.train_step`` under a mesh): a world
   of 2 gloo ranks on the card (``launch.world.spawn_world``) against one
   rank at the same global batch, on the (b) cut of musicgen-large. (e1)
   fp32, seq 512, global batch 2 (one row a rank), a mask that leaves the
   ranks' rows 128 and 512 tokens, ZeRO-1 on, one step: the loss within
   TRAIN_LOSS_RTOL, every gradient leaf (summed over the ranks) and every
   updated param within TRAIN_RTOL / TRAIN_ATOL["dense"], then the TF32
   control; (e2) bf16 through ``train_loop(mesh=)``: 8 steps with
   checkpoints every 4 and a preemption before step 6, whose 10 losses
   equal the uninterrupted world's bit for bit, and step 8 from the
   world's last checkpoint on one rank outside any world within
   DP_NEXT_RTOL of the world's; (e3) jamba's smoke config in fp32 at
   capacity factor 0.5: assignments dropped (as many over the ranks as on
   one rank), loss within TRAIN_LOSS_RTOL and gradients within
   TRAIN_ATOL["dp jamba"] (16 layers, 14 of them Mamba2, amplify a changed
   sum order past (e1)'s dense bound: 2.4x it on the H100). It prints each
   rank's seconds a bf16 step beside one rank's, the shares of the step
   in the gradient reduction and in the ZeRO-1 all-gathers,
   the moment bytes a rank holds (measured and counted) against the
   whole, the full-depth ZeRO-1 bytes from ``meta_params``, and the launch
   counters, which stay 0 here and in the ranks.

tp-train. training under the ``model`` axis (``train.train_step`` on a
   (model 2) mesh, ``bridge.ModelSplit``): a world of 2 gloo ranks on the
   card (``spawn_world(..., model=2)``), each holding its half of the
   heads, MLP columns, vocab rows (and Mamba2 heads, experts), against
   one rank at the same batch. (f1) qwen3-14b at published widths cut to
   TP_TRAIN_LAYERS of 40 layers (2.216 B params), fp32, seq 512, global
   batch 2: each rank takes the one-rank step in turn, alone on the card,
   and keeps its slices of it; the world's loss and grad norm within
   TRAIN_LOSS_RTOL, every gradient and updated param slice within the
   train phase's fp32 bounds (scaled by the whole leaf), the gradients of
   the leaves every rank holds whole equal bit for bit on the ranks, the
   params a rank holds measured against the count, then the TF32
   control; (f2) the cut in bf16 through ``train_loop(mesh=)``:
   TP_TRAIN_STEPS steps with one checkpoint, at the end, and a
   preemption before step TP_PREEMPT, whose restart from the start
   repeats the first steps' losses bit for bit, and the next step from
   the world's checkpoint, in the world and on one rank outside any
   world, within DP_NEXT_RTOL; (e3)'s jamba smoke at
   capacity factor 0.5 as (f3): attention, Mamba2 heads and experts split,
   each rank dropping what one rank drops, gradients within
   TRAIN_ATOL["deep ssm"]. It prints each rank's seconds a bf16 step
   beside one rank's with the share in the ``model`` collectives, and the
   launch counters, which stay 0 here and in the ranks.

fsdp. FSDP parameter storage (``ParallelConfig(strategy="fsdp_tp")``): a
   world of 2 gloo ranks on the card at (data 2)
   (``launch.world.spawn_world``), each storing its half of every leaf
   with an ``embed`` dim and gathering a layer while it runs, against
   one rank. (g1) the tp-train phase's qwen3-14b cut (2 of 40 layers,
   bf16) serves the first FSDP_REQUESTS of phase 4's requests,
   FSDP_NEW_TOKENS new tokens each, contiguous then paged, through the
   kernels (the launch counters set to 0 just before each engine run and
   read just after): every rank's tokens, finish order, prefill logits
   and first decode step (embedding, logits, layer-0 K/V) on its rows
   equal one rank's bit for bit, a rank stores half the bytes (measured and
   counted); it prints prefill ms a group and decode ms a step beside one
   rank's and the gathers' seconds (the ``head`` table and the layers).
   (g2) the dp phase's musicgen cut in fp32, one row a rank: each rank
   takes the one-rank step itself and keeps its stored slices of it;
   loss, grad norm, gradient and updated param slices within the train
   phase's fp32 bounds, the leaves stored whole bit-equal on the ranks,
   params a rank as counted, then the TF32 control. (g3) the cut in bf16
   through ``train_loop(mesh=)``: 8 steps, checkpoints every 4, a
   preemption before step 6, the replayed steps bit for bit, the next
   step from the world's checkpoint on one rank within DP_NEXT_RTOL; a
   rank's step timed with its gathers and their backward's all-reduces,
   beside the dp phase's tp + ZeRO-1 rank. (g4) jamba's smoke config in
   fp32 at capacity factor 0.5: drops over the ranks equal one rank's,
   gradients within TRAIN_ATOL["dp jamba"]. Training launches no kernel.

The last three lines are the ``nvidia-smi`` name and power limit, a JSON
object with one entry per kernel, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {"float32": 2e-5,       # tests/test_kernels.py:24: fp32 sums reorder
       "bfloat16": 5e-2}      # tests/test_kernels.py:25: one bf16 ulp ~ 1e-2
# (rtol, atol): tests/test_kernels.py:81-82 (ssd) and :98-99 (gmm)
SSD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (8e-2, 8e-2)}
GMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-2, 4e-1)}
REF_TOL = 1e-3                # fp32 logits, card vs CPU (cuBLAS sum order)
# fp32 training, card vs CPU, as tests/test_torch_train_parity.py holds the
# port against JAX: loss within 1e-5 relative; each gradient leaf within
# rtol 1e-4 and atol ATOL x max(1, the leaf's largest |gradient|), ATOL
# 1e-6, or 1e-4 for a deep stack of Mamba2 layers, which amplifies fp32
# rounding with depth (benchmarks/torch_train_tolerance.py measures it)
TRAIN_LOSS_RTOL, TRAIN_RTOL = 1e-5, 1e-4
# The dp phase's (e3) holds jamba's 16-layer stack in a world against one
# rank, both on the card: the changed sum order read 2.42 x the dense
# bound on the H100 (2.4e-6 of the leaf's scale) and 0.034 of the deep-ssm
# one (PERF.md §6); its atol is about 4x the clean reading
TRAIN_ATOL = {"dense": 1e-6, "deep ssm": 1e-4, "dp jamba": 1e-5}
# the control: the card's gradients with TF32 products must exceed the
# bound by this much (the bound must see a lower precision)
TF32_CONTROL_MIN = 2.0
SPIN_CYCLES = 1_000_000       # ~0.5 ms of device spin ahead of a timed call
ARCH = "musicgen-large"
# the dsp phase's depth: its fleet runs are host-bound (a decode step's
# time grows with the layers, ~7 s of the phase a layer), and phase 4
# serves the full 48 (24 until the batch phase took the script to 900 s
# after the fsdp and tp-train phases' cuts; 16 until run (C) and a slow
# host took it to 993 s, 8 at 948 s)
DSP_LAYERS = 4
# (arch, layers kept or None for all, smoke config, why)
PATHS = (
    ("musicgen-large", None, False, "full width and depth"),
    ("mamba2-1.3b", None, False, "full width and depth"),
    ("qwen3-14b", None, False, "full width and depth: 40 layers, 40/8 "
     "heads x 128 with QK-norm, 27.51 GiB of bf16 weights"),
    ("arctic-480b", 2, False, "full width, depth cut to 2 of 35 layers: "
     "each layer's 128 experts are 26.8 GB"),
    ("kimi-k2-1t-a32b", 1, False, "published widths, depth cut to 1 of 61 "
     "layers: one layer's 384 experts are 384 x 3 x 7168 x 2048 x 2 B = "
     "33.8 GB, with the shared expert (88 MB), attention (0.22 GB) and "
     "embedding + head (4.7 GB) about 38.8 GB; two layers come to about "
     "72.7 GB before caches and init buffers, more than the card holds"),
    ("jamba-1.5-large-398b", None, True, "smoke config, a wiring check: "
     "full width does not fit one card"),
)
N_REQ, PLENS, NEW_TOKENS = 16, (128, 256, 512), 32
MAX_BATCH, MAX_LEN = 8, 1024
# the parallel phase: a mesh (1, 2) of two ranks on the card. Each run:
# (name, arch, layers kept or None, ParallelConfig overrides, engine
# modes); phase 4 records the first decode step of each arch's
# contiguous run, which ``check_tp_run`` holds the run against, and the
# runs of SEQ_RUNS are held against (A). (C) takes attention's column
# path at full width: every published KV-head count divides by 2, so only
# the "seq" mode leaves it there in a world of 2 (the smallest world that
# pads heads is 8 ranks, qwen2-7b's 4 KV heads)
PARALLEL_WORLD = 2
PARALLEL_RUNS = (
    ("T1", "qwen3-14b", None, {}, ("contiguous", "paged")),
    ("T3", "mamba2-1.3b", None, {}, ("contiguous",)),
    ("A", "arctic-480b", 2, {}, ("contiguous",)),
    ("B", "arctic-480b", 2, {"decode_kv_shard": "seq",
                             "attn_seq_parallel": True}, ("contiguous",)),
    ("C", "arctic-480b", 2, {"decode_kv_shard": "seq"}, ("contiguous",)),
)
SEQ_RUNS = ("B", "C")
# the batch phase: a world of BATCH_WORLD gloo ranks on the card at (data
# BATCH_WORLD), each holding MAX_BATCH / BATCH_WORLD slots and computing
# only its rows: (h1) BATCH_ARCH at published widths and depth on phase
# 4's requests, held to phase 4's one-rank run; (h2) jamba's smoke config
# in fp32 at capacity factor DP_CAPACITY_FACTOR, held to one rank on the
# card
BATCH_WORLD, BATCH_ARCH = 2, "musicgen-large"
# (h1)'s first admit window's prefill logits and first decode step's on a
# rank's rows against one rank's (bf16): bit-equal in every run on the
# H100 (PERF.md §6), so any gap fails the phase
BATCH_LOGITS_TOL = 0.0
RECORDED = {arch for _, arch, _, _, _ in PARALLEL_RUNS} | {BATCH_ARCH}
# T3's cut: published widths, 2 layers, fp32, against one rank ((T2),
# qwen3's, went when run (C) and a slow host took the script to 993 s:
# T1 serves qwen3 split in bf16 and tp-train's (f1) trains it in fp32)
TP_CUTS = ("mamba2-1.3b",)
# qwen3-14b over 2 ranks: half of every leaf but the norms
T1_GIB = 13.76
# (B)'s and (C)'s first decode step against (A)'s, on the rows whose fed
# token and every MoE layer's experts agree: their logits move only by
# bf16 rounding (ring against flash, the sequence-sharded partials against
# the decode kernel; (C) gathers its q, k, v and attends with the same
# heads as (A) at prefill, so its layer-0 K/V equal (A)'s bit for bit).
# (B) read 0.0547-0.0859 on those rows on the H100, 0.0820 with attention
# column-cut; (C) 0.0703, every row kept, and its limit is 3x that. A row
# whose near-tied top-2 flips moves by units (5.24) and is left out, but
# at least half the rows must keep their experts: the column path's
# planted faults (the other rank's output columns through wo, the padded
# heads joined in swapped order) kept none (PERF.md section 6).
PARALLEL_LOGITS_TOL = {"B": 0.25, "C": 0.21}
# a tensor-parallel run's first window's prefill (every row) and first
# decode step (the rows whose fed token, experts and greedy token agree)
# against one rank's: bf16 rounding of the row-parallel sums moves them,
# by 0.1094 (qwen3, both), 0.0859 and 0.0791 (arctic) and 0.7344 and
# 0.7695 (mamba2) on the H100; each limit is about 3x its arch's largest
# clean reading, and the planted faults read 5.4-7.2 (PERF.md §6).
# mamba2's 48 bf16 layers carry the rounding furthest: its near-tied
# greedy tokens flip (1 of its 3 rows with an agreeing fed token kept
# its greedy token), so its decode rows need only their fed token
TP_LOGITS_TOL = {"qwen3-14b": 0.33, "mamba2-1.3b": 2.3, "arctic-480b": 0.26}
TP_GREEDY = {"qwen3-14b", "arctic-480b"}
# the dp phase: a world of DP_WORLD gloo ranks on the card, global batch
# DP_WORLD (one row a rank); (e2) runs DP_STEPS steps; the timed run
# DP_TIMED_STEPS after a warm-up step; (e3) drops at DP_CAPACITY_FACTOR
DP_WORLD, DP_STEPS, DP_TIMED_STEPS = 2, 8, 4
DP_CAPACITY_FACTOR = 0.5
# (e2): step DP_STEPS's bf16 loss on one rank from the world's checkpoint
# against the world's: an fp32 reduction of bf16 logits, where one row a
# rank and both rows in one product may round the bf16 activations
# differently; it read 1.2e-7 on the H100 at step 12 of a 12-step run
# (one fp32 ulp), and a params leaf restored wrong moves it by units
DP_NEXT_RTOL = 1e-3


# the tp-train phase: a world of TP_TRAIN_WORLD gloo ranks on the card at
# (model TP_TRAIN_WORLD); qwen3-14b at published widths cut to
# TP_TRAIN_LAYERS of 40 layers, seq 512, global batch 2; (f2) runs
# TP_TRAIN_STEPS bf16 steps with a preemption before step TP_PREEMPT and
# one checkpoint (13.3 GB), at the end (8 steps, checkpoints every 4 and
# a preemption before step 6, until the batch phase took the script past
# 900 s); the timed run TP_TIMED_STEPS after a warm-up
TP_TRAIN_WORLD, TP_TRAIN_LAYERS = 2, 2
TP_TRAIN_STEPS, TP_PREEMPT, TP_TIMED_STEPS = 4, 2, 3
# the train phase's (c): full-width, full-depth musicgen steps (25-36 s
# each on the H100; 3 until the fsdp phase came, 2 until the dryrun phase
# took the script past 900 s)
TRAIN_FULL_STEPS = 1
# the dryrun phase: the one-rank paths whose prefill group and decode
# step the dry run (``repro_torch.launch.dryrun``) is held to on the card;
# the parallel phase's T1 holds its record of collectives
DRYRUN_ARCHS = ("musicgen-large", "qwen3-14b")
# the fsdp phase: a world of FSDP_WORLD gloo ranks on the card at (data
# FSDP_WORLD) under strategy "fsdp_tp"; (g1) serves the first
# FSDP_REQUESTS of phase 4's requests, FSDP_NEW_TOKENS each, on the
# tp-train phase's qwen3-14b cut, contiguous then paged: three prefill
# groups, the 512-token one split over the two ranks, and one decode step
# (4 new tokens, three steps, until the batch phase took the script past
# 900 s: each pass here gathers for 3-4 s)
FSDP_WORLD, FSDP_REQUESTS, FSDP_NEW_TOKENS = 2, 8, 2


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def phase(n, name, msg):
    print(f"[{n} {name}] {msg}", flush=True)


# --------------------------------------------------------------- helpers
def max_err(out, ref, tol, atol=None):
    """Max abs error, after checking |out - ref| <= atol + tol * |ref|
    (atol defaults to tol)."""
    atol = tol if atol is None else atol
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    check(bool((err <= atol + tol * ref.abs()).all()),
          f"max abs err {err.max().item():.3e} over tolerance rtol {tol} "
          f"atol {atol}")
    return err.max().item()


def paged_layout(cache, ps, gen):
    """(B, S, KVH, hd) -> pool (1 + B*S/ps, ps, KVH, hd) with page 0 a NaN
    null page, and a (B, S/ps) int32 table with shuffled placement."""
    B, S, KVH, hd = cache.shape
    n_pt = S // ps
    perm = torch.randperm(B * n_pt, generator=gen, device="cpu") + 1
    pool = torch.full((1 + B * n_pt, ps, KVH, hd), float("nan"),
                      dtype=cache.dtype, device=cache.device)
    table = perm.reshape(B, n_pt).to(torch.int32)
    pool[table.reshape(-1).long().to(cache.device)] = cache.reshape(
        B * n_pt, ps, KVH, hd)
    return pool, table.to(cache.device)


def time_ms(fn, flush, iters=20, warmup=3, spin=True):
    """Mean device ms of ``fn`` by CUDA events, with L2 flushed before each
    call (outside the events): each layer's real call finds its inputs
    cold. A spin kernel between the flush and the first event keeps the
    host ahead of the card, so the events bracket the call's device time
    and not the host time of its Python wrapper (without it, short calls
    read up to three times their device time). ``spin=False`` times the
    earlier way, event to event with the host in between."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        total += e0.elapsed_time(e1)
    return total / iters


def bound(nbytes, *work):
    """(ms, by): the larger of ``nbytes`` over the memory rate and the
    operations, each (FLOPs, peak rate of their operands' type) pair at
    its own rate."""
    t_ops = sum(flops / peak for flops, peak in work)
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rand(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# ---------------------------------------------------------------- phases
def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    phase(1, "device", f"{name}; nvidia-smi: {smi}; torch {torch.__version__}"
          f" cuda {torch.version.cuda}; allow_tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")
    return name, smi


def phase_build():
    from repro_torch.kernels import build
    secs = build.build_all()
    for name in build.SOURCES:
        build.library(name)
        log = build.library_path(name).with_suffix(".log").read_text()
        regs = [ln.split("ptxas info    :")[-1].strip()
                for ln in log.splitlines() if "registers" in ln]
        phase(2, "build", f"{name}.cu: {len(regs)} kernels; "
              + " | ".join(regs[:2]) + (" | ..." if len(regs) > 2 else ""))
    phase(2, "build", f"nvcc wall {secs:.1f} s (sm_90a, one nvcc per source,"
          " in parallel)")


def phase_kernels():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import (
        decode_attention_ref, flash_attention_ref, paged_decode_attention_ref)
    from repro_torch.models.blocks import DECODE_BLOCK_S

    gen = torch.Generator(device="cuda").manual_seed(1)
    cpu_gen = torch.Generator().manual_seed(1)
    flash_cases = [  # (label, BH, S, Sk, hd, causal)
        ("musicgen S=128", 2 * 32, 128, 128, 64, True),
        ("musicgen S=512", 2 * 32, 512, 512, 64, True),
        ("musicgen ragged S=333", 2 * 32, 333, 333, 64, True),
        ("qwen2 S=512", 28, 512, 512, 128, True),
        ("qwen2 ragged S=200", 28, 200, 200, 128, True),
        ("qwen2 cross S=128 Sk=320", 28, 128, 320, 128, False),
        # kimi-k2's hd 112 (7168 / 64): a lone token, a ragged tile, and
        # the largest prefill group's prompts
        ("kimi hd=112 S=1", 64, 1, 1, 112, True),
        ("kimi hd=112 S=40", 2 * 64, 40, 40, 112, True),
        ("kimi hd=112 S=512", 64, 512, 512, 112, True),
        # qwen3-14b's 20 heads a rank under tensor parallelism: the
        # largest prefill group (2 prompts of 512) and a ragged one
        ("qwen3 TP2 BH=2x20 S=512", 2 * 20, 512, 512, 128, True),
        ("qwen3 TP2 BH=3x20 S=333", 3 * 20, 333, 333, 128, True),
    ]
    # (label, B, H, KVH, hd, S, lengths): G 1, 2, 5, 7 and 8 over the
    # hds, G 1, 7 and 8 at hd 112;
    # each case has a row of length 0, one at cap, and rows ending
    # mid-split
    decode_cases = [
        ("musicgen G=1 hd=64", 8, 32, 32, 64, 1024,
         [0, 1, 127, 128, 129, 540, 1023, 1024]),
        ("qwen2 G=7 hd=128", 4, 28, 4, 128, 1024, [0, 300, 1024, 777]),
        ("arctic G=7 hd=128", 8, 56, 8, 128, 1024,
         [1024, 0, 128, 200, 513, 1, 896, 1000]),
        ("G=2 hd=16", 4, 8, 4, 16, 512, [512, 0, 200, 77]),
        ("G=8 hd=32", 3, 16, 2, 32, 640, [640, 333, 0]),
        # hd 112: a row is 14 (bf16) or 28 (fp32) lanes of 16-byte loads
        ("kimi G=8 hd=112", 8, 64, 8, 112, 1024,
         [1024, 0, 128, 200, 513, 1, 896, 1000]),
        ("G=7 hd=112", 4, 28, 4, 112, 1024, [0, 300, 1024, 777]),
        ("G=1 hd=112", 4, 8, 8, 112, 512, [512, 0, 129, 77]),
        # qwen3-14b's G 5 (bucket 8, 3 idle query slots): whole on one
        # rank, and its 20/4 heads a rank under tensor parallelism
        ("qwen3 G=5 hd=128", 8, 40, 8, 128, 1024,
         [1024, 0, 128, 200, 513, 1, 896, 1000]),
        ("qwen3 TP2 G=5 hd=128", 8, 20, 4, 128, 1024,
         [0, 1, 127, 300, 540, 777, 1023, 1024]),
    ]
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for label, BH, S, Sk, hd, causal in flash_cases:
            q = rand((BH, S, hd), dtype, gen)
            k = rand((BH, Sk, hd), dtype, gen)
            v = rand((BH, Sk, hd), dtype, gen)
            err = max_err(flash_attention(q, k, v, causal=causal),
                          flash_attention_ref(q, k, v, causal=causal), tol)
            phase(3, "kernels", f"flash_attention {label} {dtype}: max abs "
                  f"err {err:.3e} (tol {tol})")
        for label, B, H, KVH, hd, S, lens in decode_cases:
            q = rand((B, H, hd), dtype, gen)
            kc = rand((B, S, KVH, hd), dtype, gen)
            vc = rand((B, S, KVH, hd), dtype, gen)
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            ref = decode_attention_ref(q, kc, vc, lengths)
            out = decode_attention(q, kc, vc, lengths,
                                   block_s=DECODE_BLOCK_S)
            err = max_err(out, ref, tol)
            zero = [i for i, n in enumerate(lens) if n == 0]
            check(bool((out[zero] == 0).all()), "length-0 row not zero")
            check(torch.equal(decode_attention(q, kc, vc, lengths,
                                               block_s=DECODE_BLOCK_S), out),
                  f"decode_attention not bitwise repeatable ({label}, "
                  f"{dtype})")
            kp, table = paged_layout(kc, DECODE_BLOCK_S, cpu_gen)
            vp = torch.full_like(kp, float("nan"))
            vp[table.reshape(-1).long()] = vc.reshape(-1, DECODE_BLOCK_S,
                                                      KVH, hd)
            paged = paged_decode_attention(q, kp, vp, table, lengths)
            perr = max_err(paged, paged_decode_attention_ref(
                q, kp, vp, table, lengths), tol)
            check(torch.equal(paged, out),
                  f"paged != contiguous bitwise ({label}, {dtype})")
            check(torch.equal(paged_decode_attention(q, kp, vp, table,
                                                     lengths), paged),
                  f"paged_decode_attention not bitwise repeatable ({label},"
                  f" {dtype})")
            phase(3, "kernels", f"decode_attention {label} (B {B}, H {H}, "
                  f"KVH {KVH}, S {S}, lengths {lens}) {dtype}: max abs err "
                  f"{err:.3e}; paged_decode_attention max abs err {perr:.3e}"
                  f" (tol {tol}); paged == contiguous bitwise at page_size =="
                  f" block_s == {DECODE_BLOCK_S}; two calls of each equal "
                  "bitwise; length-0 rows exact zero")
        check_fleet_decode(dtype, tol, gen, cpu_gen)
    check_gmm(gen)
    check_ssd(gen)


def check_fleet_decode(dtype, tol, gen, cpu_gen):
    """Decode at the dsp phase's shape: musicgen's heads (H 32, hd 64),
    8 rows, a 48-position cache in pages of 8 at shuffled places, each
    row's table past its last page on the NaN null page as the engine's
    is. Lengths 0, 1, one page, mid-page, the cap, and the cap + 1 that a
    full row's step passes. Paged and contiguous (block_s 8) against the
    plain version, equal to each other bit for bit, each repeatable."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import decode_attention_ref
    B, H, hd, S, ps = 8, 32, 64, 48, 8
    lens = [0, 1, 8, 13, 33, 47, 48, 49]
    q = rand((B, H, hd), dtype, gen)
    kc = rand((B, S, H, hd), dtype, gen)
    vc = rand((B, S, H, hd), dtype, gen)
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kp, table = paged_layout(kc, ps, cpu_gen)
    vp = torch.full_like(kp, float("nan"))
    vp[table.reshape(-1).long()] = vc.reshape(-1, ps, H, hd)
    for b, n in enumerate(lens):
        table[b, -(-min(n, S) // ps):] = 0
    ref = decode_attention_ref(q, kc, vc, lengths)
    out = decode_attention(q, kc, vc, lengths, block_s=ps)
    paged = paged_decode_attention(q, kp, vp, table, lengths)
    err = max_err(out, ref, tol)
    perr = max_err(paged, ref, tol)
    check(bool((paged[0] == 0).all()), "fleet-shape length-0 row not zero")
    check(torch.equal(paged, out), f"fleet-shape paged != contiguous "
          f"bitwise at block_s == page_size == {ps} ({dtype})")
    check(torch.equal(decode_attention(q, kc, vc, lengths, block_s=ps), out)
          and torch.equal(paged_decode_attention(q, kp, vp, table, lengths),
                          paged),
          f"fleet-shape decode not bitwise repeatable ({dtype})")
    phase(3, "kernels", f"paged_decode_attention at the dsp fleet's shape (B "
          f"{B}, H {H}, KVH {H}, hd {hd}, cap {S}, page_size {ps}, tables "
          f"past each row's last page on the NaN null page, lengths {lens})"
          f" {dtype}: max abs err {perr:.3e}; decode_attention block_s {ps} "
          f"{err:.3e} (tol {tol}); paged == contiguous bitwise; two calls of"
          " each equal bitwise; length-0 row exact zero")


def path_capacities(cfg):
    """moe_gmm's C on phase 4's path: each prefill group (1 to 3 prompts of
    one length: a window of 8 cycles through 3 lengths) and a decode step
    of the whole batch."""
    from repro_torch.models.moe import capacity
    per_len = -(-MAX_BATCH // len(PLENS))
    tokens = {k * p for k in range(1, per_len + 1) for p in PLENS}
    return sorted({capacity(t, cfg) for t in tokens | {MAX_BATCH}})


def gmm_instance(x, w):
    """(C tile, 16-byte loads, split over d) of moe_gmm(x, w)."""
    from repro_torch.kernels.moe_gmm import plan
    p = plan(x, w)
    return p.c_tile, p.vec, p.splits > 1


# every instance plan() picks, by dtype: fp32 C tiles 1-32 on CUDA cores;
# bf16 N tiles 8/16/32 on mma.sync with 16-byte loads, split over d where
# C <= 10 (tiles 8 and 16), and element-wise loads for ragged d or f
GMM_INSTANCES = {
    "float32": {(bc, False, False) for bc in (1, 2, 4, 8, 16, 32)},
    "bfloat16": ({(bn, True, False) for bn in (8, 16, 32)}
                 | {(8, True, True), (16, True, True), (8, False, False)}),
}


def check_gmm(gen):
    """moe_gmm at the C of every prefill group and decode step of arctic
    (128 experts, d 7168 <-> f 4864) and of jamba smoke, at a ragged shape,
    and at C 2 and 12: every instance of the kernel is held against
    the plain version, and every bf16 call of the two paths' shapes runs
    the tensor-core design with 16-byte loads."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    arctic = get_config("arctic-480b")
    jamba = get_smoke_config("jamba-1.5-large-398b")
    a_cs = path_capacities(arctic)
    j_cs = path_capacities(jamba)
    cases = [("arctic d->f", 128, 7168, 4864, a_cs + [2], True),
             ("arctic f->d", 128, 4864, 7168, a_cs, True),
             ("jamba smoke", jamba.n_experts, jamba.d_model,
              jamba.d_ff_expert, j_cs, True),
             ("C 12, one d range", 4, 512, 256, [12], False),
             ("ragged", 3, 37, 53, [5], False)]   # (E, d, f, Cs, a path's)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[1]
        rtol, atol = GMM_TOL[name]
        seen = set()
        for label, E, d, f, cs, on_path in cases:
            w = rand((E, d, f), torch.float32, gen).mul_(d ** -0.5).to(dtype)
            errs, inst = [], set()
            for C in cs:
                x = rand((E, C, d), dtype, gen)
                errs.append(max_err(moe_gmm(x, w), moe_gmm_ref(x, w), rtol,
                                    atol))
                inst.add(gmm_instance(x, w))
                del x
            if on_path and dtype == torch.bfloat16:
                check(all(i[1] for i in inst),
                      f"moe_gmm {label}: a path shape left the 16-byte "
                      f"loads: {sorted(inst)}")
            seen |= inst
            phase(3, "kernels", f"moe_gmm {label} (E {E}, d {d}, f {f}) "
                  f"{dtype}: C {cs}; instances (C tile, 16-byte "
                  f"loads, split over d) {sorted(inst)}: max abs err "
                  f"{max(errs):.3e} (rtol {rtol}, atol {atol})")
            del w
            torch.cuda.empty_cache()
        check(seen == GMM_INSTANCES[name],
              f"moe_gmm {dtype} instances checked {sorted(seen)}, want "
              f"{sorted(GMM_INSTANCES[name])}")


def moe_counts(lm):
    """{T: (E,) int32 filled counts} of layer 0's MoE dispatch (attention
    + MoE, as in arctic) for each prefill group of phase 4 (T its rows)
    and a decode step of the whole batch (T = MAX_BATCH): ``route`` +
    ``dispatch`` on the path's own weights, fed the layer's own input
    (embedding, attention, norms) for phase 4's prompts. A decode step's
    rows are each request's last prompt token."""
    from repro_torch.models.blocks import attn_block
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.lm import tree_map
    from repro_torch.models.moe import dispatch, route
    from repro_torch.serve.engine import Request
    cfg = lm.cfg
    check(cfg.block_kind(0) == "attn" and cfg.is_moe_layer(0),
          f"{cfg.name}: layer 0 is not attention + MoE")
    p = tree_map(lambda t: t[0], lm.params["blocks"]["pos0"])
    reqs = make_requests(cfg, Request)
    calls = {MAX_BATCH: torch.stack([torch.from_numpy(r.tokens[-1:])
                                     for r in reqs[:MAX_BATCH]])}
    for n in PLENS:
        prompts = [torch.from_numpy(r.tokens) for r in reqs
                   if len(r.tokens) == n]
        for k in range(1, -(-MAX_BATCH // len(PLENS)) + 1):
            calls[k * n] = torch.stack(prompts[:k])
    counts = {}
    with torch.no_grad():
        for T, toks in sorted(calls.items()):
            x = lm.embed({"tokens": toks})
            B, S = x.shape[:2]
            pos = torch.arange(S, device=x.device).expand(B, S)
            a, _ = attn_block(p["attn"], cfg, rmsnorm(p["norm1"], x,
                                                      cfg.norm_eps), pos)
            h = rmsnorm(p["norm2"], x + a, cfg.norm_eps)
            tok, _, _ = dispatch(route(p["moe"], cfg, h)[0], cfg)
            counts[T] = (tok < T).sum(dim=1, dtype=torch.int32)
    return counts


def moe_plans(lm):
    """moe_gmm's instance, (C tile, 16-byte loads, split over d), for every
    expert weight of every MoE layer at every C of phase 4's path, x
    allocated fresh as the layer allocates it."""
    from repro_torch.kernels.moe_gmm import plan
    cfg = lm.cfg
    inst = set()
    for i in range(cfg.pattern_period):
        if not cfg.is_moe_layer(i):
            continue
        moe = lm.params["blocks"][f"pos{i}"]["moe"]
        for key in ("w_in", "w_gate", "w_out"):
            for w in moe.get(key, ()):       # one (E, d, f) per repeat
                E, d, _ = w.shape
                for C in path_capacities(cfg):
                    p = plan(torch.empty((E, C, d), dtype=w.dtype,
                                         device=w.device), w)
                    inst.add((p.c_tile, p.vec, p.splits > 1))
    return inst


def check_gmm_counts(cfg, counts_by_t, gen):
    """moe_gmm with the filled counts of a decode step and of the largest
    prefill group of an MoE path (``moe_counts``: route + dispatch on the
    path's weights; arctic: 128 experts, top-2; kimi-k2: 384 experts,
    top-8, its shared expert a dense MLP beside them), both orientations,
    on an x that is non-zero in every row: filled rows match the plain
    version, rows past the count are exact zero."""
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    from repro_torch.models.moe import capacity
    E, dm, fe = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    steps = (("decode step", MAX_BATCH), ("prefill group", max(counts_by_t)))
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = GMM_TOL[str(dtype).split(".")[1]]
        for d, f in ((dm, fe), (fe, dm)):
            w = rand((E, d, f), torch.float32, gen).mul_(d ** -0.5).to(dtype)
            for step, T in steps:
                counts = counts_by_t[T]
                C = capacity(T, cfg)
                x = rand((E, C, d), dtype, gen)
                out = moe_gmm(x, w, counts)
                err = max_err(out, moe_gmm_ref(x, w, counts), rtol, atol)
                empty = (torch.arange(C, device="cuda")[None, :]
                         >= counts[:, None])
                check(bool((out[empty] == 0).all()),
                      f"moe_gmm {step}: a row past its count is not zero")
                live = int((counts > 0).sum())
                phase(3, "kernels", f"moe_gmm {cfg.name} {step} counts (T {T}"
                      f", C {C}, {live} of {E} experts filled, top-{cfg.top_k},"
                      f" {int(counts.sum())} rows) d {d} -> f {f} {dtype}: max"
                      f" abs err {err:.3e} "
                      f"(rtol {rtol}, atol {atol}); {int(empty.sum())} empty "
                      "rows exact zero")
                del x, out
            del w
            torch.cuda.empty_cache()


def ssd_inputs(B, S, nh, hp, ng, ds, dtype, gen):
    x = rand((B, S, nh, hp), torch.float32, gen).mul_(0.5).to(dtype)
    dt = 0.01 + 0.29 * torch.rand((B, S, nh), generator=gen, device="cuda")
    A = -(0.5 + 1.5 * torch.rand((nh,), generator=gen, device="cuda"))
    Bg = rand((B, S, ng, ds), torch.float32, gen).mul_(0.3).to(dtype)
    Cg = rand((B, S, ng, ds), torch.float32, gen).mul_(0.3).to(dtype)
    return x, dt, A, Bg, Cg


def check_ssd(gen):
    """ssd_scan at every prefill group shape of mamba2 (nh 64, hp 64, ds
    128; chunk min(256, S)), at its 32 heads a rank under tensor
    parallelism, and of jamba smoke, with grouped B/C, and at the (hp, ds)
    instances no path runs: y and the final state."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    cases = []
    for label, cfg in (("mamba2", get_config("mamba2-1.3b")),
                       ("jamba smoke",
                        get_smoke_config("jamba-1.5-large-398b"))):
        for S in PLENS:
            cases.append((f"{label} S={S}", 3, S, cfg.n_ssm_heads,
                          cfg.ssm_head_dim, cfg.ssm_groups, cfg.d_state,
                          min(cfg.ssm_chunk, S)))
    mamba2 = get_config("mamba2-1.3b")
    for S in PLENS:                # 32 of its 64 heads a rank, TP 2
        cases.append((f"mamba2 TP2 S={S}", 3, S, mamba2.n_ssm_heads // 2,
                      mamba2.ssm_head_dim, mamba2.ssm_groups,
                      mamba2.d_state, min(mamba2.ssm_chunk, S)))
    cases += [("grouped ng=2", 2, 512, 64, 64, 2, 128, 256),
              ("hp 16 ds 128", 1, 96, 4, 16, 2, 128, 48),
              ("hp 64 ds 16", 2, 48, 8, 64, 1, 16, 12)]
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = SSD_TOL[str(dtype).split(".")[1]]
        for label, B, S, nh, hp, ng, ds, chunk in cases:
            args = ssd_inputs(B, S, nh, hp, ng, ds, dtype, gen)
            y, st = ssd_scan(*args, chunk=chunk)
            y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
            ey = max_err(y, y_ref, rtol, atol)
            es = max_err(st, st_ref, rtol, atol)
            phase(3, "kernels", f"ssd_scan {label} (B {B}, S {S}, nh {nh}, "
                  f"hp {hp}, ng {ng}, ds {ds}, chunk {chunk}) {dtype}: max "
                  f"abs err y {ey:.3e}, state {es:.3e} (rtol {rtol}, atol "
                  f"{atol})")


def make_requests(cfg, Request):
    import numpy as np
    rng = np.random.default_rng(0)
    shape = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    return [Request(rid=i, tokens=rng.integers(
        1, cfg.vocab_size, (PLENS[i % len(PLENS)],) + shape
    ).astype(np.int32), max_new_tokens=NEW_TOKENS) for i in range(N_REQ)]


def serve_run(lm, page_size, record=False):
    """Phase 4's requests through one engine. Returns (engine, finished
    requests, launch counts, wall s, the first decode step's record
    (``first_decode_recorded``) or None)."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine, Request
    eng = Engine(lm, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 page_size=page_size, device="cuda")
    reqs = make_requests(lm.cfg, Request)
    with (first_decode_recorded(lm) if record
          else contextlib.nullcontext([])) as first:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        done = eng.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
    return eng, done, counts, wall, first[0] if first else None


@contextlib.contextmanager
def first_decode_recorded(lm):
    """Inside, the first call of ``lm.decode`` appends to the yielded list
    a record, on the host: the logits of every prefill before it (the
    first admit window's groups, rows in call order; "prefills" keeps
    them call by call), the step's fed
    tokens and lengths, its embedding output, its logits, each MoE
    layer's choice of experts (or None) and layer 0's K/V cache after it
    (the rank's heads or positions; None without attention at pattern
    position 0). Contiguous caches only. ``lm.prefill`` and ``lm.decode``
    are wrapped by instance attributes, removed on the way out."""
    from repro_torch.models import blocks
    prefill, decode, route, embed = (lm.prefill, lm.decode, blocks.route,
                                     lm.embed)
    into, prefills = [], []

    def pre(*args, **kw):
        out = prefill(*args, **kw)
        if not into:
            prefills.append(out[0].float().cpu())
        return out

    def call(tokens, lengths, caches, *args, **kw):
        if into:
            return decode(tokens, lengths, caches, *args, **kw)
        routed, embs = [], []

        def rec_route(*a, **k):
            ids, wts, aux = route(*a, **k)
            routed.append(ids.cpu())
            return ids, wts, aux

        def rec_embed(*a, **k):
            x = embed(*a, **k)
            embs.append(x.to("cpu", copy=True))
            return x

        blocks.route, lm.embed = rec_route, rec_embed
        try:
            out = decode(tokens, lengths, caches, *args, **kw)
        finally:
            blocks.route = route
            del lm.embed
        rec = {"prefill": torch.cat(prefills), "prefills": list(prefills),
               "tokens": tokens.to("cpu", copy=True),
               "lengths": lengths.to("cpu", copy=True), "emb": embs[0],
               "logits": out[0].float().cpu(),
               "ids": torch.stack(routed) if routed else None,
               "k0": None, "v0": None}
        if lm.cfg.block_kind(0) == "attn":
            rec["k0"], rec["v0"] = (t[0].to("cpu", copy=True)
                                    for t in caches["pos0"])
        into.append(rec)
        return out

    lm.prefill, lm.decode = pre, call
    try:
        yield into
    finally:
        del lm.prefill, lm.decode


def serve_steps(lm, rt, device):
    """Phase 5's one-rank prefill group (the first window's prompts of the
    longest length: 2 x 512) and decode step (batch MAX_BATCH over a
    MAX_LEN cache, half way through the first wave) on ``lm`` under the
    runtime ``rt`` (None: one rank), as (name, step, args) triples for
    ``launch.dryrun.record``: tokens drawn from a seed on the card, or
    meta tensors of the same shapes for the dry run."""
    cfg = lm.cfg
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    S = max(first)
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    gen = torch.Generator().manual_seed(8)

    def ints(shape, high):
        if device == "meta":
            return torch.empty(shape, dtype=torch.int32, device="meta")
        return torch.randint(1, high, shape, generator=gen,
                             dtype=torch.int32).to(device)

    pre = {"tokens": ints((first.count(S), S) + ncb, cfg.vocab_size)}
    window = rt.seq_window(cfg, MAX_LEN) if rt is not None else None
    caches = lm.init_cache(MAX_BATCH, MAX_LEN if window is None
                           else window[1] - window[0], rt)
    lens = [p + NEW_TOKENS // 2 for p in first]
    dec = {"tokens": ints((MAX_BATCH, 1) + ncb, cfg.vocab_size),
           "lengths": (torch.empty((MAX_BATCH,), dtype=torch.int32,
                                   device="meta") if device == "meta" else
                       torch.tensor(lens, dtype=torch.int32, device=device))}
    return [("prefill", lambda: lm.prefill(pre, rt),
             {"params": lm.params, "batch": pre}),
            ("decode", lambda: lm.decode(dec["tokens"], dec["lengths"],
                                         caches, rt=rt),
             {"params": lm.params, "batch": dec, "caches": caches})]


def phase_dryrun_one_rank(lm, smi):
    """(a) and (c) of the dryrun phase on a path of phase 4 (its weights
    resident): the dry run of its prefill group and decode step on meta
    tensors (``launch.dryrun.record``), then the same step on the card
    after one warm-up call. The dry run's launches by kernel must equal
    ``ops.launch_counts()`` on the card, and its params, cache and batch
    bytes the live tensors'; its predicted peak is printed beside
    ``max_memory_allocated`` with the gap, and its counted FLOPs over the
    card's step time as a share of the bf16 peak (a report)."""
    from repro_torch.bridge import meta_params
    from repro_torch.kernels import ops
    from repro_torch.launch.dryrun import record
    from repro_torch.models.lm import LM
    from repro_torch.parallel.check import bytes_held
    cfg = lm.cfg
    meta = LM(cfg, meta_params(cfg), device="meta")
    for (name, step, args), (_, mstep, margs) in zip(
            serve_steps(lm, None, "cuda"), serve_steps(meta, None, "meta")):
        rec, _, _ = record(mstep, margs)
        step()                                # warm-up: cuBLAS, scratch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        want = {k: rec["kernels"].get(k, {}).get("launches", 0)
                for k in counts}
        check(counts == want, f"dryrun {cfg.name} {name}: the card launched"
              f" {counts}, the dry run counts {want}")
        held = rec["memory"]["held"]
        live = {"params": bytes_held(lm.params),
                "caches": bytes_held(args.get("caches", {})),
                "batch": bytes_held(args["batch"])}
        check(all(held[k] == v for k, v in live.items()),
              f"dryrun {cfg.name} {name}: the dry run holds {held}, the "
              f"card's tensors {live}")
        m = rec["memory"]
        temp = peak - base
        flops = rec["cost"]["flops"]
        phase("dryrun", "one rank", f"{cfg.name} {name}: launches {counts} "
              f"on the card = the dry run's; params {live['params']} B, "
              f"caches {live['caches']} B, batch {live['batch']} B as the "
              f"dry run holds them; peak predicted {m['peak_bytes'] / 2**30:.3f}"
              f" GiB (args {m['argument_bytes'] / 2**30:.3f} + step "
              f"{(m['peak_bytes'] - m['argument_bytes']) / 2**30:.3f}), "
              f"max_memory_allocated {peak / 2**30:.3f} GiB (resident "
              f"before the step {base / 2**30:.3f}, step {temp / 2**30:.3f})"
              f": gap {(peak - m['peak_bytes']) / 2**30:+.3f} GiB, of it the "
              f"step's {(temp - (m['peak_bytes'] - m['argument_bytes'])) / 2**30:+.3f}"
              f" (allocator rounding, cuBLAS workspace; the rest is what "
              f"else is resident: at prefill the decode step's caches, "
              f"built with it, and the decode kernel's scratch); step "
              f"{secs * 1e3:.3f} ms on the card, {flops:.4e} FLOPs counted "
              f"({rec['cost']['flops_kernels']:.4e} in the kernels) = "
              f"{flops / secs / PEAK_BF16_FLOPS:.2%} of the bf16 peak; dry "
              f"run {rec['run_s']:.3f} s on the host; {smi}")


def layer_kinds(cfg):
    """(attention layers, Mamba2 layers, MoE layers) of a config."""
    kinds = [cfg.block_kind(i) for i in range(cfg.n_layers)]
    return (kinds.count("attn"), kinds.count("ssm"),
            sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers)))


def expected_launches(cfg, eng, paged):
    """Launches the path must show: flash and ssd_scan once per layer of
    their kind per prefill, the decode kernel once per attention layer
    per step, moe_gmm once per expert product per MoE layer per forward."""
    n_attn, n_ssm, n_moe = layer_kinds(cfg)
    per_moe = 3 if cfg.mlp_act == "swiglu" else 2
    dec = n_attn * eng.steps
    return {"flash_attention": n_attn * eng.prefills,
            "decode_attention": 0 if paged else dec,
            "paged_decode_attention": dec if paged else 0,
            "moe_gmm": per_moe * n_moe * (eng.prefills + eng.steps),
            "ssd_scan": n_ssm * eng.prefills}


def path_config(arch, layers, smoke):
    from repro_torch.configs import get_config, get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def phase_serve(arch, layers, smoke, why, smi):
    """Serve one path contiguous and paged, check it, time its engine.
    Returns a namespace: ``counts`` (launches), ``moe_counts`` (or None),
    ``served`` (the contiguous run's (rid, tokens) in finish order),
    ``first`` (its first decode step, ``first_decode_recorded``, for the
    archs the parallel phase runs; else None) and ``times`` (phase 5's
    engine ms). Its weights are freed by the caller."""
    import numpy as np
    from repro_torch.bridge import init_params
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.models.lm import LM, tree_leaves

    cfg = path_config(arch, layers, smoke)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lm = LM(cfg, params, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    n_attn, n_ssm, n_moe = layer_kinds(cfg)
    per_moe = 3 if cfg.mlp_act == "swiglu" else 2
    phase(4, "serve", f"{cfg.name} ({why}): {cfg.n_layers} layers ({n_attn} "
          f"attention, {n_ssm} Mamba2, {n_moe} MoE), d_model {cfg.d_model}, "
          f"{cfg.dtype}; {n_params / 1e9:.3f} B params drawn in "
          f"{time.perf_counter() - t0:.2f} s")
    runs = {}
    tok_shape = (NEW_TOKENS, cfg.n_codebooks) if cfg.n_codebooks > 1 \
        else (NEW_TOKENS,)
    first = None
    for mode, ps in (("contiguous", None), ("paged", DECODE_BLOCK_S)):
        eng, done, counts, wall, rec = serve_run(
            lm, ps, record=ps is None and arch in RECORDED)
        first = first or rec
        check(len(done) == N_REQ and not any(r.rejected for r in done),
              f"{cfg.name} {mode}: served {len(done)} of {N_REQ}")
        for r in done:
            toks = np.asarray(r.out_tokens)
            check(toks.shape == tok_shape,
                  f"{mode}: request {r.rid} tokens {toks.shape}")
            check(bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()),
                  f"{mode}: token out of range")
        want = expected_launches(cfg, eng, ps is not None)
        check(eng.prefills > 0 and eng.steps > 0 and counts == want,
              f"{cfg.name} {mode}: launches {counts} != expected {want}")
        for kern in ("flash_attention", "ssd_scan", "moe_gmm"):
            check(counts[kern] > 0 or want[kern] == 0,
                  f"{cfg.name} {mode}: {kern} never launched")
        if eng.pager is not None:
            check(eng.pager.used_pages == 0, "paged: pages not freed")
            eng.pager.check_conservation()
        toks = sum(len(r.out_tokens) for r in done)
        phase(4, "serve", f"{cfg.name} {mode}: {len(done)} requests, {toks} "
              f"token steps in {wall:.3f} s ({toks / wall:.1f} tok/s); "
              f"{eng.prefills} prefills, {eng.steps} decode steps; launches "
              f"{counts} (per prefill group: {n_attn} flash, {n_ssm} "
              f"ssd_scan, {per_moe * n_moe} moe_gmm; per decode step: "
              f"{n_attn} decode, {per_moe * n_moe} moe_gmm)")
        runs[mode] = (done, counts)
        del eng   # one engine's caches resident at a time
    a, b = runs["contiguous"][0], runs["paged"][0]
    check([r.rid for r in a] == [r.rid for r in b],
          f"{cfg.name}: finish order differs between contiguous and paged")
    for ra, rb in zip(a, b):
        check(np.array_equal(np.asarray(ra.out_tokens),
                             np.asarray(rb.out_tokens)),
              f"{cfg.name} request {ra.rid}: tokens differ between "
              "contiguous and paged")
    phase(4, "serve", f"{cfg.name} contiguous and paged: equal tokens and "
          "finish order; every page freed, conservation holds")
    moe_counts_by_t = None
    if n_moe:
        inst = moe_plans(lm)
        check(lm.dtype == torch.bfloat16 and all(i[1] for i in inst),
              f"{cfg.name}: a moe_gmm call leaves the bf16 tensor-core design"
              f" with 16-byte loads: {cfg.dtype}, {sorted(inst)}")
        phase(4, "serve", f"{cfg.name}: every moe_gmm call of the path runs "
              f"the bf16 tensor-core design with 16-byte loads; instances "
              f"(C tile, 16-byte loads, split over d) {sorted(inst)}")
        if cfg.block_kind(0) == "attn" and cfg.is_moe_layer(0):
            moe_counts_by_t = moe_counts(lm)
    times = time_engine(lm, smi)
    peak = torch.cuda.max_memory_allocated() / 2**30
    if arch in DRYRUN_ARCHS:
        phase_dryrun_one_rank(lm, smi)
    phase(5, "times", f"{cfg.name}: peak device memory {peak:.2f} GiB "
          f"(max_memory_allocated, weights {n_params * lm.dtype.itemsize / 2**30:.2f}"
          f" GiB); {smi}")
    served = [(r.rid, np.asarray(r.out_tokens).tolist())
              for r in runs["contiguous"][0]]
    return SimpleNamespace(
        counts={k: runs["contiguous"][1][k] + runs["paged"][1][k]
                for k in runs["contiguous"][1]},
        moe_counts=moe_counts_by_t, served=served,
        first=first, times=dict(times, peak_gib=peak))


def cut_config(arch):
    """A 2-layer cut of ``arch`` at published widths, in fp32."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")


def cut_logits(lm, rt=None):
    """The prefill logits of 2 prompts of 128 tokens (numpy seed 3) and
    one decode step's after it, at lengths 128 and 100, on the host; with
    ``rt``, as one rank of its mesh."""
    import numpy as np
    cfg = lm.cfg
    rng = np.random.default_rng(3)
    ncb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    toks = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (2, 128) + ncb).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(
        1, cfg.vocab_size, (2, 1) + ncb).astype(np.int32))
    logits, pre = lm.prefill({"tokens": toks}, rt=rt)
    caches = lm.init_cache(2, 256, rt)
    for row in range(2):
        lm.splice(caches, pre, row, row)
    lengths = torch.tensor([128, 100], dtype=torch.int32, device=lm.device)
    dec, _ = lm.decode(nxt.to(lm.device), lengths, caches, rt=rt)
    check(logits.shape == (2,) + ncb + (cfg.vocab_padded,),
          f"prefill logits shape {tuple(logits.shape)}")
    return {"prefill": logits.cpu(), "decode": dec.cpu()}


def reference_check(arch):
    """A 2-layer cut at full width, fp32: card (kernels) vs CPU (plain)."""
    from repro_torch.bridge import init_params
    from repro_torch.models.lm import LM, tree_map

    small = cut_config(arch)
    params = init_params(small, torch.Generator(device="cuda").manual_seed(2),
                         "cuda")
    card = cut_logits(LM(small, params, device="cuda"))
    cpu = cut_logits(LM(small, tree_map(lambda t: t.cpu(), params),
                        device="cpu"))
    e_pre = max_err(card["prefill"], cpu["prefill"], REF_TOL)
    e_dec = max_err(card["decode"], cpu["decode"], REF_TOL)
    phase(4, "serve", f"reference {small.name}: 2-layer full-width fp32 cut, "
          f"card vs CPU plain path: prefill logits max abs err {e_pre:.3e}, "
          f"decode logits {e_dec:.3e} (tol {REF_TOL}); all finite")


def time_engine(lm, name):
    """One admit window (timed prefill) and its decode steps, after an
    untimed warm-up window of the same shapes; then a profiled step.
    Returns the window's prefill ms a group and decode ms a step."""
    from repro_torch.serve.engine import Engine, Request
    cfg = lm.cfg
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    eng = Engine(lm, max_batch=MAX_BATCH, max_len=MAX_LEN, device="cuda")
    for _ in ("warm-up", "timed"):
        reqs = make_requests(cfg, Request)[:MAX_BATCH]
        p0, s0 = eng.prefills, eng.steps
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.admit_many(reqs)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        while eng.active:
            eng.step()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    n_pre, n_steps = eng.prefills - p0, eng.steps - s0
    toks = MAX_BATCH * NEW_TOKENS
    cb = f" x {cfg.n_codebooks} codebooks" if cfg.n_codebooks > 1 else ""
    pre_ms, step_ms = 1e3 * (t1 - t0) / n_pre, 1e3 * (t2 - t1) / n_steps
    phase(5, "times", f"engine {cfg.name} {cfg.dtype}, {MAX_BATCH} requests "
          f"of prompts {first}: prefill {pre_ms:.3f} ms per "
          f"group ({n_pre} groups), decode {step_ms:.3f} ms"
          f" per step ({n_steps} steps of batch {MAX_BATCH}), "
          f"{toks / (t2 - t0):.1f} tok/s ({toks} tokens{cb}); {name}")
    profile_steps(eng, make_requests(cfg, Request)[:MAX_BATCH], step_ms,
                  name)
    return {"prefill_ms": pre_ms, "decode_ms": step_ms}


def profile_steps(eng, reqs, step_ms, name, n=4):
    """Device time of a few decode steps under torch.profiler, against
    the unprofiled step time: how busy the card is, and on what."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.admit_many(reqs)
    eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
    while eng.active:
        eng.step()
    by_name, launches = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            launches += 1
    busy_ms = sum(by_name.values()) / 1e3 / n
    if not launches:
        phase(5, "times", "decode step device time: not measured (the "
              "profiler saw no CUDA kernels)")
        return
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    phase(5, "times", f"{eng.lm.cfg.name} decode step under torch.profiler: "
          f"{launches / n:.0f} kernels and {busy_ms:.3f} ms of device time "
          f"per step against {step_ms:.3f} ms unprofiled "
          f"({busy_ms / step_ms:.1%} busy); top: "
          + "; ".join(f"{k[:60]} {v / 1e3 / n:.3f} ms" for k, v in top)
          + f"; {name}")


def free_device_memory():
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _timed(fn, into):
    """``fn`` with each call's wall seconds, between two device syncs,
    appended to ``into``."""
    def call(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out
    return call


@contextlib.contextmanager
def kernel_widths():
    """{kernel: the set of widths its calls took} while inside: the query
    heads of flash (through ``blocks.prefill_attention``), decode and
    paged decode, the SSM heads of ssd_scan, the experts of moe_gmm."""
    from repro_torch.kernels import ops
    from repro_torch.models import blocks
    seen = {k: set() for k in ops.launch_counts()}
    taps = {(blocks, "prefill_attention"): ("flash_attention", 2),
            (ops, "decode"): ("decode_attention", 1),
            (ops, "paged_decode"): ("paged_decode_attention", 1),
            (ops, "ssd"): ("ssd_scan", 2), (ops, "gmm"): ("moe_gmm", 0)}
    saved = {}
    for (mod, attr), (kern, dim) in taps.items():
        fn = saved[(mod, attr)] = getattr(mod, attr)

        def tap(x, *a, fn=fn, kern=kern, dim=dim, **k):
            seen[kern].add(int(x.shape[dim]))
            return fn(x, *a, **k)

        setattr(mod, attr, tap)
    try:
        yield seen
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


def _tp_run(mesh, arch, layers, over, modes, first_path, record=False):
    """One parallel run on this rank: draw the path's weights (phase 4's
    seed) keeping this rank's slices, serve phase 4's requests in each
    engine mode, check the launches, the widths each kernel saw and the
    pages; the contiguous run's first decode step
    (``first_decode_recorded``) goes to ``first_path``. With ``record``,
    the collectives of one prefill group and one decode step
    (``serve_steps``) under the dry run's recorder
    (``launch.comm_analysis``), for the dryrun phase's (b). Returns what
    the parent prints and checks."""
    import numpy as np
    from repro_torch.bridge import init_params, meta_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.parallel.check import bytes_held
    from repro_torch.serve.engine import Engine, Request
    cfg = path_config(arch, layers, False)
    parallel = ParallelConfig(**over)
    rt = Runtime(parallel, mesh)
    tp = rt.tensor(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda", mesh=mesh, parallel=parallel)
    torch.cuda.synchronize()
    lm = LM(cfg, params, device="cuda")
    h0, h1 = tp.ssm_heads(cfg) if cfg.ssm else (0, 0)
    n_exp = cfg.n_experts // tp.n if tp.experts else cfg.n_experts
    res = {"draw_s": time.perf_counter() - t0,
           "held_gib": bytes_held(params) / 2**30,
           "whole_gib": bytes_held(meta_params(cfg)) / 2**30,
           "split": {"attention by heads": tp.attn,
                     "attention by columns": tp.columns,
                     "router": tp.experts, "vocab": tp.vocab,
                     "ssm heads": tp.ssm, "mlp": tp.mlp(cfg.d_ff)},
           "decode_kv_shard": rt.decode_kv_shard(cfg)}
    for mode in modes:
        ps = DECODE_BLOCK_S if mode == "paged" else None
        eng = Engine(lm, rt=rt, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     page_size=ps, device="cuda")
        pre_s, step_s = [], []
        eng._prefill_group = _timed(eng._prefill_group, pre_s)
        eng.step = _timed(eng.step, step_s)
        reqs = make_requests(cfg, Request)
        torch.cuda.synchronize()
        with kernel_widths() as widths, (
                first_decode_recorded(lm) if ps is None
                else contextlib.nullcontext([])) as first:
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            done = eng.run(reqs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
        want = expected_launches(cfg, eng, ps is not None)
        if rt.decode_kv_shard(cfg) == "seq":
            want["decode_attention"] = 0
        if parallel.attn_seq_parallel:     # every prompt divides by 2
            want["flash_attention"] = 0
        check(counts == want, f"parallel {arch} {mode}: launches {counts} "
              f"!= expected {want}")
        lo, hi = tp.padded_heads(cfg)
        want_w = {"flash_attention": {hi - lo if tp.columns
                                      else tp.heads(cfg)},
                  "decode_attention": {tp.heads(cfg)},
                  "paged_decode_attention": {tp.heads(cfg)},
                  "ssd_scan": {h1 - h0}, "moe_gmm": {n_exp}}
        want_w = {k: v if want[k] else set() for k, v in want_w.items()}
        check(widths == want_w, f"parallel {arch} {mode}: the kernels saw "
              f"widths {widths}, not this rank's {want_w}")
        if eng.pager is not None:
            check(eng.pager.used_pages == 0, f"parallel {arch} paged: pages"
                  " not freed")
            eng.pager.check_conservation()
        if first:
            torch.save(first[0], first_path)
        res[mode] = {"served": [(r.rid, np.asarray(r.out_tokens).tolist())
                                for r in done],
                     "counts": counts,
                     "widths": {k: sorted(v) for k, v in widths.items()},
                     "prefills": eng.prefills, "steps": eng.steps,
                     "wall_s": wall, "prefill_ms": [1e3 * x for x in pre_s],
                     "decode_ms": [1e3 * x for x in step_s]}
        del eng
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if record:
        from repro_torch.launch.comm_analysis import record_collectives
        res["recorded"] = {}
        for name, step, _ in serve_steps(lm, rt, "cuda"):
            with record_collectives() as rec:
                step()
            torch.cuda.synchronize()
            res["recorded"][name] = [op.key() for op in rec.ops]
    return res


def _parallel_rank(rank, world, port, out_dir, runs, cuts):
    """One rank of the parallel phase: ``torch.multiprocessing.spawn``'s
    target, in a process of its own on the card. Runs each of ``runs``
    (``PARALLEL_RUNS``' entries) through ``_tp_run``, the fp32 ``cuts``
    as this rank of the mesh, and the collectives and row-parallel
    products at the path's shapes; writes what the parent checks to
    ``out_dir``."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist
    from repro_torch.bridge import init_params
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM, Runtime
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(1, world, device="cuda")
        out = Path(out_dir)
        res = {"backend": dist.get_backend(), "device": str(mesh.device),
               "coords": mesh.coords}
        for name, arch, layers, over, modes in runs:
            res[name] = _tp_run(mesh, arch, layers, over, modes,
                                out / f"first_{name}_{rank}.pt",
                                record=name == "T1")
            free_device_memory()
        for arch in cuts:
            small = cut_config(arch)
            lm = LM(small, init_params(
                small, torch.Generator(device="cuda").manual_seed(2),
                "cuda", mesh=mesh), device="cuda")
            torch.save(cut_logits(lm, Runtime(mesh=mesh)),
                       out / f"cut_{arch}_{rank}.pt")
            del lm
            free_device_memory()
        names = {name for name, *_ in runs}
        if "B" in names:
            res["collectives"] = _collectives_at_path_shapes(
                mesh, path_config("arctic-480b", 2, False))
        if "T1" in names:
            res["row_parallel"] = _row_parallel_at_path_shapes(
                mesh, path_config("qwen3-14b", None, False))
        (out / f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def _row_parallel_at_path_shapes(mesh, cfg):
    """qwen3-14b's two row-parallel products at a decode step (8 rows),
    bf16: ``wo`` (5120 -> 5120) and the MLP's ``w_out`` (17408 -> 5120),
    each rank's partial summed over ``model`` against the whole product
    (``parallel.check``). Every rank draws the same inputs. Returns the
    max abs errors."""
    from repro_torch.models.lm import Runtime
    from repro_torch.parallel.check import row_parallel_against_whole
    gen = torch.Generator(device="cuda").manual_seed(8)
    tp = Runtime(mesh=mesh).tensor(cfg)
    errs = {}
    for name, k in (("wo", cfg.q_dim), ("w_out", cfg.d_ff)):
        x = rand((MAX_BATCH, k), torch.bfloat16, gen)
        w = rand((k, cfg.d_model), torch.float32, gen).mul_(
            k ** -0.5).to(torch.bfloat16)
        got, want = row_parallel_against_whole(tp, x, w)
        errs[name] = max_err(got, want, TOL["bfloat16"])
    return errs


def _collectives_at_path_shapes(mesh, cfg):
    """Run (B)'s two collectives at the path's shapes against the kernels
    that one rank runs on the whole tensors, bf16 (``parallel.check``):
    the sequence-sharded decode against the decode kernel at the first
    wave's lengths (B 8, arctic's 56/8 heads x 128, a 1024-position cache,
    one row empty and one full), and the ring against flash at the largest
    prefill group (3 x 512). Every rank draws the same inputs. Returns the
    max abs errors."""
    from repro_torch.parallel.check import collectives_against_kernels
    gen = torch.Generator(device="cuda").manual_seed(9)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lengths = torch.tensor([p + NEW_TOKENS // 2 for p in PLENS]
                           + [p + 3 for p in PLENS] + [0, MAX_LEN],
                           dtype=torch.int32, device="cuda")
    B, S = len(lengths), max(PLENS)
    got = collectives_against_kernels(
        mesh, rand((B, H, hd), torch.bfloat16, gen),
        *(rand((B, MAX_LEN, KVH, hd), torch.bfloat16, gen) for _ in "kv"),
        lengths, *(rand((B, KVH, hd), torch.bfloat16, gen) for _ in "kv"),
        rand((3, S, H, hd), torch.bfloat16, gen),
        *(rand((3, S, KVH, hd), torch.bfloat16, gen) for _ in "kv"))
    check(got["caches_equal"], "parallel: the sequence-sharded caches "
          "differ from the whole cache's writes")
    return {"decode": max_err(got["decode"], got["decode_want"],
                              TOL["bfloat16"]),
            "ring": max_err(got["ring"], got["ring_want"], TOL["bfloat16"])}


def caches_agree(got, want, keep, what):
    """Layer 0's K or V of two runs on the (row, position) pairs ``keep``:
    None when they are equal bit for bit, else (elements that differ,
    elements compared, the largest difference). A difference must lie
    within 1 bf16 ulp of the larger of the two values, or of the cache's
    largest magnitude: a narrower product that cuBLAS sums in another
    order rounds an element to its neighbour, and RoPE mixes two such
    elements into one that may lie near zero. That layer's K/V come from
    the tokens alone, so a wrong slice, offset or splice differs by the
    values' own size."""
    g, w = got[keep], want[keep]
    if torch.equal(g, w):
        return None
    g, w = g.float(), w.float()
    diff = (g - w).abs()
    limit = 2.0 ** -7 * torch.maximum(torch.maximum(g.abs(), w.abs()),
                                      w.abs().max())
    bad = diff > limit
    check(not bool(bad.any()), f"{what}: layer 0's cache differs beyond "
          f"1 ulp at {int(bad.sum())} of {diff.numel()} values (largest "
          f"{diff.max().item():.3e})")
    return int((diff > 0).sum()), diff.numel(), diff.max().item()


def _fed_rows(one, other, what):
    """The rows whose fed token agrees between two first-decode records,
    after checking their lengths agree."""
    check(torch.equal(one["lengths"], other["lengths"]),
          f"{what}: the first decode step's lengths differ")
    B = one["tokens"].shape[0]
    return (one["tokens"] == other["tokens"]).reshape(B, -1).all(-1)


def _flipped(one, other):
    """Rows where any MoE layer chose other experts (False without MoE)."""
    B = one["tokens"].shape[0]
    if one["ids"] is None:
        return torch.zeros(B, dtype=torch.bool)
    return (one["ids"].sort(dim=-1).values != other["ids"].sort(
        dim=-1).values).reshape(one["ids"].shape[0], B, -1).any(-1).any(0)


def check_tp_run(one, recs, tol, what, greedy=True):
    """Hold a tensor-parallel run's first admit window and first decode
    step against one rank's: ``one`` is phase 4's record
    (``first_decode_recorded``), ``recs`` the run's, one a rank.

    Exact: the embedding output on the rows whose fed token agrees, bit
    for bit (the vocab-split lookup adds only zeros). Where the run
    splits attention: layer 0's K/V, the ranks' slices joined by heads,
    equal one rank's on every row at every position but the one this step
    wrote, and there too where the fed token agrees, or lie within
    ``caches_agree``'s rounding. Within ``tol``: the first window's
    prefill logits, every row (the same prompts on both sides), and the
    decode step's logits on the rows whose fed token, experts and, with
    ``greedy``, greedy token agree, which must be at least half the rows
    (with ``greedy``) or at least one. Returns (the prefill's max abs
    error, the kept decode rows', every decode row's, the rows left out,
    the logits' largest magnitude, layer 0's K/V difference or None)."""
    from repro_torch.parallel.check import join_heads
    fb = recs[0]
    pre = (fb["prefill"] - one["prefill"]).abs().max().item()
    check(pre <= tol, f"{what}: the first window's prefill logits {pre:.3e}"
          f" from one rank's, over {tol}")
    same_tok = _fed_rows(one, fb, what)
    B = same_tok.shape[0]
    check(torch.equal(fb["emb"][same_tok], one["emb"][same_tok]),
          f"{what}: the first decode step's embedding differs from one "
          "rank's")
    kv = None
    check(one["k0"] is None or fb["k0"].shape != one["k0"].shape,
          f"{what}: attention is not split by heads")
    if one["k0"] is not None:
        S = one["k0"].shape[1]
        keep = same_tok[:, None] | (torch.arange(S)[None, :]
                                    != one["lengths"].long()[:, None])
        got = [caches_agree(join_heads(r[n] for r in recs), one[n], keep,
                            f"{what} {n}") for n in ("k0", "v0")]
        kv = {n: x for n, x in zip("KV", got) if x is not None} or None
    same_greedy = (one["logits"].argmax(-1) == fb["logits"].argmax(-1)
                   ).reshape(B, -1).all(-1)
    flipped = _flipped(one, fb)
    kept = same_tok & ~flipped & (same_greedy if greedy else True)
    row_err = (fb["logits"] - one["logits"]).abs().reshape(B, -1).amax(-1)
    need = -(-B // 2) if greedy else 1
    check(int(kept.sum()) >= need, f"{what}: only {int(kept.sum())} of {B}"
          " rows kept their fed token, experts"
          + (" and greedy token" if greedy else "")
          + f" (fed token agrees {same_tok.tolist()}, greedy token "
          f"{same_greedy.tolist()}, experts flipped {flipped.tolist()}; "
          f"logits by row {[round(e, 4) for e in row_err.tolist()]})")
    err = row_err[kept].max().item()
    check(err <= tol, f"{what}: first decode step's logits {err:.3e} from "
          f"one rank's on the rows that agree, over {tol}")
    return (pre, err, row_err.tolist(), (~kept).nonzero().flatten().tolist(),
            one["logits"].abs().max().item(), kv)


def check_seq_run(fa, fbs, name):
    """Hold run ``name`` of SEQ_RUNS' first decode step against run (A)'s:
    ``fa`` is (A)'s record, its first-layer caches joined by heads;
    ``fbs`` the run's, one a rank, each holding a slice of the positions.

    Exact: the run's first-layer caches, its ranks' slices laid end to
    end, equal (A)'s on every row at every position but the one this step
    wrote, and there too on the rows whose fed token agrees, or within
    the rounding of a narrower K/V product (``caches_agree``). That
    layer's K/V come from the tokens alone, so a prefill splice outside
    its rank's window, a decode write at a wrong offset or K/V columns
    gathered out of order differ here, whatever rounding did. Within
    ``PARALLEL_LOGITS_TOL[name]``: the logits of the rows whose fed token
    and every MoE layer's experts agree, at least half the rows. Returns
    (the kept rows' max abs error, every row's, the rows left out, the
    logits' largest magnitude, the caches' difference or None)."""
    fb, what, tol = fbs[0], f"parallel ({name})", PARALLEL_LOGITS_TOL[name]
    same_tok = _fed_rows(fa, fb, what)
    B, S = fa["k0"].shape[:2]
    keep = same_tok[:, None] | (torch.arange(S)[None, :]
                                != fa["lengths"].long()[:, None])
    got = [caches_agree(torch.cat([x[n] for x in fbs], dim=1), fa[n],
                        keep, f"{what} {n}") for n in ("k0", "v0")]
    kv = {n: x for n, x in zip("KV", got) if x is not None} or None
    row_err = (fb["logits"] - fa["logits"]).abs().reshape(B, -1).amax(-1)
    kept = same_tok & ~_flipped(fa, fb)
    check(2 * int(kept.sum()) >= B, f"{what}: only {int(kept.sum())} of {B}"
          " rows kept their token and experts at the first decode step "
          f"(logits by row {[round(e, 4) for e in row_err.tolist()]})")
    err = row_err[kept].max().item()
    check(err <= tol, f"{what}: first decode step's logits {err:.3e} from "
          f"(A)'s on the rows whose token and experts agree, over {tol}")
    return (err, row_err.tolist(), (~kept).nonzero().flatten().tolist(),
            fa["logits"].abs().max().item(), kv)


def describe_kv(kv, one):
    """The K/V comparison's outcome in words: ``caches_agree``'s results
    (None: equal), or not compared."""
    if one["k0"] is None:
        return "not compared (no attention at layer 0)"
    if kv is None:
        return "equal bit for bit"
    return ("within 1 bf16 ulp (cuBLAS sums the narrower product in "
            "another order): " + "; ".join(
                f"{name}: {n} of {t} values differ, by {m:.3e} at most"
                for name, (n, t, m) in kv.items()))


def _median(xs):
    return statistics.median(xs) if xs else float("nan")


def check_recorded_collectives(cfg, parallel, recorded, smi):
    """(b) of the dryrun phase: each rank's recorded collectives of a
    prefill group and a decode step (``_tp_run(record=True)``) equal the
    dry run's for the same rank of a fake group of the same world at
    mesh (1, W), kind for kind, dtype, bytes and group, in order."""
    from repro_torch.bridge import meta_params
    from repro_torch.launch.dryrun import fake_world, record
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.lm import LM, Runtime
    W = len(recorded)
    for r in range(W):
        t0 = time.perf_counter()
        with fake_world(W, r):
            mesh = make_mesh(1, W, device="meta")
            meta = LM(cfg, meta_params(cfg, mesh=mesh, parallel=parallel),
                      device="meta")
            for name, step, args in serve_steps(
                    meta, Runtime(parallel, mesh), "meta"):
                _, _, coll = record(step, args, transport="gloo")
                got = json.loads(json.dumps([op.key() for op in coll]))
                want = recorded[r][name]
                check(got == want, f"dryrun (T1) rank {r} {name}: the dry "
                      f"run records {len(got)} collectives, the card's "
                      f"ranks {len(want)}; first difference at "
                      f"{next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))}")
                kinds = {}
                for kind, _, nbytes, _ in got:
                    kinds[kind] = kinds.get(kind, 0) + nbytes
                phase("dryrun", "T1", f"{cfg.name} rank {r} of (1, {W}) "
                      f"{name}: {len(got)} collectives on the card's gloo "
                      f"ranks = the dry run's, in order (kind, dtype, bytes,"
                      f" group); bytes by kind {kinds}; dry run "
                      f"{time.perf_counter() - t0:.2f} s on the host; {smi}")


def phase_parallel(single, smi, runs=PARALLEL_RUNS, cuts=TP_CUTS):
    """Serving across ranks (``repro_torch.parallel``): a world of 2 ranks
    on the card over gloo, each drawing phase 4's weights and keeping its
    slices. ``single``: {arch: phase 4's ``phase_serve`` result} for the
    archs of ``runs``. Every run serves phase 4's 16 requests, the same
    tokens and finish order on both ranks, through the kernels at the
    rank's widths. (T1) qwen3-14b and (T3) mamba2-1.3b tensor-parallel,
    and (A) arctic's cut tensor- and expert-parallel, pass
    ``check_tp_run`` against phase 4's first decode step; T1 serves
    contiguous and paged with equal tokens, every page freed, and holds
    ``T1_GIB`` a rank. (B), (A) with the sequence-sharded decode cache and
    ring prefill (attention on the column path, whole at the ring),
    passes ``check_seq_run`` against (A), and each rank holds those
    collectives at the path's shapes against the kernels one rank runs.
    (C), (A) with the sequence-sharded decode cache alone (the column
    path: prefill by padded heads through flash), passes
    ``check_seq_run`` against (A) too. The fp32 ``cuts`` (T3's) match
    one rank on the card within ``REF_TOL``. The share of (B)'s
    and (C)'s tokens equal to (A)'s is printed, not gated: bf16 rounding
    that differs flips near-tied top-2 choices and greedy argmaxes, and
    the runs part from there. Each rank sets its launch counters to 0
    just before each engine run and reads them just after. Returns (the
    runs' summed launch counts, each run's)."""
    import shutil
    import socket

    import torch.multiprocessing as mp
    from repro_torch.bridge import init_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.lm import LM
    from repro_torch.parallel.check import join_heads
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_parallel_"))
    t0 = time.perf_counter()
    W = PARALLEL_WORLD
    try:
        mp.spawn(_parallel_rank, args=(W, port, str(out), runs, cuts),
                 nprocs=W, join=True)
        wall = time.perf_counter() - t0
        ranks = [json.loads((out / f"rank{r}.json").read_text())
                 for r in range(W)]
        first = {name: [torch.load(out / f"first_{name}_{r}.pt")
                        for r in range(W)] for name, *_ in runs}
        cut = {arch: [torch.load(out / f"cut_{arch}_{r}.pt")
                      for r in range(W)] for arch in cuts}
    finally:
        shutil.rmtree(out, ignore_errors=True)
    total, by_run = {}, {}
    for name, arch, layers, over, modes in runs:
        cfg = path_config(arch, layers, False)
        one = single[arch]
        by_run[name] = {}
        for r, res in enumerate(ranks):
            x = res[name]
            for mode in modes:
                y = x[mode]
                check(y["served"] == ranks[0][name][mode]["served"],
                      f"parallel ({name}) {mode}: rank {r} served other "
                      "tokens or another finish order than rank 0")
                check(len(y["served"]) == N_REQ and all(
                    len(t) == NEW_TOKENS and 0 <= min(map(min, [
                        t if isinstance(t[0], int) else sum(t, [])]))
                    and max(map(max, [t if isinstance(t[0], int)
                                      else sum(t, [])])) < cfg.vocab_padded
                    for _, t in y["served"]),
                    f"parallel ({name}) {mode}: a request unserved, short "
                    "or out of range")
                for k, v in y["counts"].items():
                    total[k] = total.get(k, 0) + v
                    by_run[name][k] = by_run[name].get(k, 0) + v
                pre, dec = y["prefill_ms"], y["decode_ms"]
                phase("parallel", name, f"{cfg.name} rank {r} of {W} on "
                      f"{res['device']} over {res['backend']} {mode}: "
                      f"decode_kv_shard {x['decode_kv_shard']}, split "
                      f"{x['split']}; {len(y['served'])} requests, "
                      f"{y['prefills']} prefills at {_median(pre):.3f} ms a"
                      f" group (median; mean {statistics.mean(pre):.3f}, "
                      f"first {pre[0]:.3f}; one rank "
                      f"{one.times['prefill_ms']:.3f}), {y['steps']} decode"
                      f" steps at {_median(dec):.3f} ms a step (median; "
                      f"mean {statistics.mean(dec):.3f}; one rank "
                      f"{one.times['decode_ms']:.3f}), wall "
                      f"{y['wall_s']:.3f} s; launches {y['counts']}, "
                      f"widths {y['widths']}; {smi}")
            phase("parallel", name, f"{cfg.name} rank {r}: holds "
                  f"{x['held_gib']:.2f} GiB of the whole model's "
                  f"{x['whole_gib']:.2f} ({x['held_gib'] / x['whole_gib']:.1%}"
                  f"), drawn in {x['draw_s']:.2f} s; peak device memory "
                  f"{x['peak_gib']:.2f} GiB (one rank: "
                  f"{one.times['peak_gib']:.2f}); {smi}")
        if name == "T1":
            held = ranks[0][name]["held_gib"]
            check(abs(held - T1_GIB) <= 0.02 * T1_GIB,
                  f"parallel (T1): a rank holds {held:.2f} GiB, not "
                  f"{T1_GIB} +- 2 %")
            check_recorded_collectives(
                cfg, ParallelConfig(**over),
                [res[name]["recorded"] for res in ranks], smi)
        if len(modes) > 1:
            a, b = (ranks[0][name][m]["served"] for m in modes[:2])
            check(a == b, f"parallel ({name}): tokens or finish order "
                  f"differ between {modes[0]} and {modes[1]}")
        for key in ("tokens", "lengths", "logits", "emb"):
            check(all(torch.equal(x[key], first[name][0][key])
                      for x in first[name]),
                  f"parallel ({name}): the ranks' first decode steps differ "
                  f"({key})")
        if name in SEQ_RUNS:
            continue
        pre, err, row_err, left, scale, kv = check_tp_run(
            one.first, first[name], TP_LOGITS_TOL[arch], f"parallel ({name})",
            greedy=arch in TP_GREEDY)
        same = sum(t == u for (_, ta), (_, tb) in zip(
            sorted(one.served), sorted(ranks[0][name]["contiguous"]["served"]))
            for t, u in zip(ta, tb))
        n_tok = sum(len(t) for _, t in one.served)
        phase("parallel", name, f"{cfg.name} against phase 4's one rank: the "
              f"first window's prefill logits {pre:.3e} at most (every row); "
              f"at the first decode step, embedding equal bit for bit; layer "
              f"0's K/V joined by heads {describe_kv(kv, one.first)}; logits "
              f"{err:.3e} at most on the rows that keep their fed token, "
              f"experts" + (" and greedy token" if arch in TP_GREEDY else "")
              + f" (limit {TP_LOGITS_TOL[arch]}; |logit| up to {scale:.3f}), "
              f"by row {[round(e, 4) for e in row_err]} (left out: {left}); "
              f"{same} of {n_tok} tokens ({same / n_tok:.1%}) equal to one "
              f"rank's; {smi}")
    names = {name for name, *_ in runs}
    for name in SEQ_RUNS:
        if not {"A", name} <= names:
            continue
        fa = dict(first["A"][0], **{k: join_heads(x[k] for x in first["A"])
                                    for k in ("k0", "v0")})
        err, row_err, left, scale, kv = check_seq_run(fa, first[name], name)
        a = ranks[0]["A"]["contiguous"]["served"]
        b = ranks[0][name]["contiguous"]["served"]
        same = sum(t == u for (_, ta), (_, tb) in zip(sorted(a), sorted(b))
                   for t, u in zip(ta, tb))
        n_tok = sum(len(t) for _, t in a)
        coll = ""
        if name == "B":     # (B)'s collectives at the path's shapes
            got = [res["collectives"] for res in ranks]
            coll = (f" at the path's shapes, bf16, by rank: sequence-sharded "
                    f"decode max abs err {[round(c['decode'], 6) for c in got]}"
                    f" against the decode kernel, ring "
                    f"{[round(c['ring'], 6) for c in got]} against flash "
                    f"(tol {TOL['bfloat16']});")
        phase("parallel", name, f"against (A) at the first decode step: the "
              f"first layer's K/V caches, the ranks' slices end to end, "
              f"against (A)'s joined by heads: {describe_kv(kv, fa)}; logits "
              f"{err:.3e} from (A)'s at most on the rows whose token and "
              f"experts agree (limit {PARALLEL_LOGITS_TOL[name]}; |logit| up "
              f"to {scale:.3f}), by row {[round(e, 4) for e in row_err]} "
              f"(left out: {left}); {same} of {n_tok} tokens "
              f"({same / n_tok:.1%}) equal to (A)'s;{coll} {smi}")
    if "T1" in names:
        errs = {k: [round(r["row_parallel"][k], 6) for r in ranks]
                for k in ("wo", "w_out")}
        phase("parallel", "T1", "row-parallel products at a decode step, "
              "bf16, summed over 2 ranks against the whole product, by "
              "rank: " + "; ".join(f"{k} max abs err {v}"
                                   for k, v in errs.items())
              + f" (tol {TOL['bfloat16']})")
    for arch in cuts:
        small = cut_config(arch)
        want = cut_logits(LM(small, init_params(
            small, torch.Generator(device="cuda").manual_seed(2), "cuda"),
            device="cuda"))
        errs = [[max_err(c[k], want[k], REF_TOL) for k in ("prefill",
                                                             "decode")]
                for c in cut[arch]]
        free_device_memory()
        phase("parallel", "T2" if arch == "qwen3-14b" else "T3",
              f"{small.name} 2-layer fp32 cut at published widths, TF32 off,"
              f" tensor-parallel over {W} ranks against one rank on the "
              f"card: (prefill, decode) logits max abs err by rank "
              f"{[[float(f'{e:.3e}') for e in x] for x in errs]} (tol "
              f"{REF_TOL})")
    phase("parallel", "done", f"{len(runs)} runs and {len(cuts)} fp32 cuts "
          f"over {W} ranks; phase {wall:.1f} s of spawn and runs; {smi}")
    return total, by_run


def batch_jamba_cfg():
    """(h2): jamba's smoke config in fp32 at capacity factor
    DP_CAPACITY_FACTOR, where the MoE layers drop assignments."""
    return dataclasses.replace(path_config("jamba-1.5-large-398b", None, True),
                               dtype="float32",
                               capacity_factor=DP_CAPACITY_FACTOR)


@contextlib.contextmanager
def dispatch_drops(into):
    """Append to ``into`` each serving MoE dispatch's dropped assignments
    and whether it ran on a rank's rows of a split batch."""
    from repro_torch.models import moe
    orig = moe.dispatch

    def dispatch(ids, cfg, data=None):
        tok, slot, kept = orig(ids, cfg, data)
        into.append((int((~kept).sum()), data is not None))
        return tok, slot, kept

    moe.dispatch = dispatch
    try:
        yield into
    finally:
        moe.dispatch = orig


def batch_serve(lm, rt=None, modes=("contiguous", "paged")):
    """Phase 4's requests through an engine on this rank (``rt``) or alone,
    in each mode: tokens, launches (set to 0 just before each run, read
    just after, held to ``expected_launches``), the first decode step
    (contiguous), prefill ms a group, decode ms a step, the caches' bytes
    (``launch.counter.storage_bytes``), the pages of the pool, the rows
    moved and their seconds (``parallel.collectives.exchange``, device-
    synced), and each MoE dispatch's drops."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.launch.counter import storage_bytes
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.engine import Engine, Request
    out = {}
    exchange = engine_mod.exchange
    for mode in modes:
        ps = DECODE_BLOCK_S if mode == "paged" else None
        eng = Engine(lm, rt=rt, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     page_size=ps, device="cuda")
        pre_s, step_s, move_s, drops = [], [], [], []
        eng._prefill_group = _timed(eng._prefill_group, pre_s)
        eng.step = _timed(eng.step, step_s)
        engine_mod.exchange = _timed(exchange, move_s)
        try:
            with (first_decode_recorded(lm) if ps is None
                  else contextlib.nullcontext([])) as first, \
                    dispatch_drops(drops):
                torch.cuda.synchronize()
                ops.reset_launch_counts()
                done = eng.run(make_requests(lm.cfg, Request))
                torch.cuda.synchronize()
                counts = ops.launch_counts()
        finally:
            engine_mod.exchange = exchange
        want = expected_launches(lm.cfg, eng, ps is not None)
        check(counts == want, f"batch {lm.cfg.name} {mode}: launches "
              f"{counts} != expected {want}")
        if eng.pager is not None:
            check(eng.pager.used_pages == 0,
                  f"batch {lm.cfg.name} paged: pages not freed")
            eng.pager.check_conservation()
        out[mode] = {
            "served": [(r.rid, np.asarray(r.out_tokens).tolist())
                       for r in done],
            "counts": counts, "prefill_ms": [1e3 * x for x in pre_s],
            "decode_ms": [1e3 * x for x in step_s], "drops": drops,
            "move_s": sum(move_s), "cache_bytes": storage_bytes(eng.caches),
            "pages": None if eng.pager is None else eng.pager.n_pages,
            "own": (eng.own.start, eng.own.stop), "moved": eng.moved_rows,
            "first": first[0] if first else None}
        # the timing wrappers hold the engine in a cycle: collect it, so
        # one engine's caches are resident at a time
        del eng
        free_device_memory()
    return out


def _batch_rank(rank, mesh):
    """One rank of the batch phase (``launch.world.spawn_world``'s target
    at (data BATCH_WORLD)): (h1) and (h2) of the module docstring, with
    the rank's peak memory (over the weights' draw, then over serving
    alone) and the one-rank cache bytes its runtime counts
    (``LM.cache_shapes`` at MAX_BATCH)."""
    import torch.distributed as dist
    from repro_torch.bridge import init_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.parallel.check import bytes_held
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rt = Runtime(ParallelConfig(), mesh)
    out = {"backend": dist.get_backend(), "device": str(mesh.device),
           "coords": mesh.coords}
    for name, cfg in (("h1", path_config(BATCH_ARCH, None, False)),
                      ("h2", batch_jamba_cfg())):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lm = LM(cfg, init_params(cfg, torch.Generator(
            device="cuda").manual_seed(0), "cuda", mesh=mesh), device="cuda")
        torch.cuda.synchronize()
        out[name + "_draw_peak"] = torch.cuda.max_memory_allocated()
        out[name + "_weights"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out[name] = batch_serve(lm, rt)
        out[name + "_peak"] = torch.cuda.max_memory_allocated()
        out[name + "_one_cache"] = bytes_held(lm.cache_shapes(
            MAX_BATCH, MAX_LEN, rt))
        del lm
        free_device_memory()
    return out


def check_batch_rank(r, one, tol, what):
    """A rank's run against one rank's: tokens and finish order in both
    modes, the first admit window's prefill logits and first decode step
    on the rank's rows within ``tol`` (bit-equal at 0), half of one
    rank's cache bytes and slots; returns the largest logit gap."""
    i = r["coords"]["data"]
    for mode in ("contiguous", "paged"):
        check(r[what][mode]["served"] == one[mode]["served"],
              f"batch {what} {mode}: rank {r['coords']} served other tokens"
              " or another finish order than one rank")
    gap = 0.0
    for key, (got, want) in first_against_one(
            r[what]["contiguous"]["first"], one["contiguous"]["first"],
            i).items():
        if key in ("tokens", "lengths", "emb"):
            check(torch.equal(got, want), f"batch {what}: rank "
                  f"{r['coords']}'s first decode step fed other {key}")
            continue
        err = (got.float() - want.float()).abs().max().item()
        gap = max(gap, err)
        check(err <= tol, f"batch {what}: rank {r['coords']}'s {key} is "
              f"{err:.4e} from one rank's rows, over {tol}")
    return gap


def phase_batch(single, smi):
    """Serving with the batch split over the batch axes: a world of
    BATCH_WORLD gloo ranks on the card at (data BATCH_WORLD) against one
    rank: (h1) and (h2) of the module docstring. ``single``: phase 4's
    records by arch (BATCH_ARCH's first decode step, tokens and phase 5's
    times). Returns the ranks' launch counts, summed over the ranks and
    modes."""
    from repro_torch.bridge import init_params
    from repro_torch.launch.world import spawn_world
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.models.lm import LM
    check(not torch.backends.cuda.matmul.allow_tf32, "batch: TF32 is on")
    cfg = path_config(BATCH_ARCH, None, False)
    phase("batch", "setup", f"a world of {BATCH_WORLD} ranks on the card "
          f"at (data {BATCH_WORLD}) (launch.world.spawn_world), "
          f"{MAX_BATCH // BATCH_WORLD} of {MAX_BATCH} slots a rank: (h1) "
          f"{cfg.name} at published widths and depth ({cfg.n_layers} "
          f"layers), phase 4's {N_REQ} requests; (h2) jamba smoke, fp32, "
          f"capacity factor {DP_CAPACITY_FACTOR}")
    # (h2) on one rank
    jcfg = batch_jamba_cfg()
    lm = LM(jcfg, init_params(jcfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    h2_one = batch_serve(lm)
    del lm
    free_device_memory()
    one = single[BATCH_ARCH]
    h1_one = {"contiguous": {"served": one.served, "first": one.first},
              "paged": {"served": one.served}}
    t0 = time.perf_counter()
    ranks = spawn_world(BATCH_WORLD, _batch_rank,
                        devices=["cuda:0"] * BATCH_WORLD)
    world_s = time.perf_counter() - t0
    total = {}
    for r in ranks:
        for what in ("h1", "h2"):
            for mode in ("contiguous", "paged"):
                for k, v in r[what][mode]["counts"].items():
                    total[k] = total.get(k, 0) + v
    # (h1)
    for r in ranks:
        gap = check_batch_rank(r, h1_one, BATCH_LOGITS_TOL, "h1")
        c, pg = r["h1"]["contiguous"], r["h1"]["paged"]
        lo, hi = c["own"]
        check(hi - lo == MAX_BATCH // BATCH_WORLD and pg["own"] == c["own"],
              f"batch h1: rank {r['coords']} holds slots {lo}-{hi - 1}")
        check(BATCH_WORLD * c["cache_bytes"] == r["h1_one_cache"],
              f"batch h1: rank {r['coords']} holds {c['cache_bytes']} B of "
              f"caches, not 1/{BATCH_WORLD} of one rank's "
              f"{r['h1_one_cache']}")
        pps = MAX_LEN // DECODE_BLOCK_S
        check(pg["pages"] == 1 + (hi - lo) * pps,
              f"batch h1: rank {r['coords']}'s pool holds {pg['pages']} "
              "pages")
        check(c["moved"] > 0 and pg["moved"] > 0,
              "batch h1: no prefill row moved to its slot's rank")
        phase("batch", "h1", f"rank {r['coords']} ({r['backend']}, "
              f"{r['device']}): tokens and finish order equal one rank's, "
              f"contiguous and paged; slots {lo}-{hi - 1}; first window's "
              f"prefill logits and first decode step on its rows "
              f"{'bit-equal to' if gap == 0 else f'{gap:.4e} from'} one "
              f"rank's; {c['moved']} prefill rows moved in; caches "
              f"{c['cache_bytes']} B (one rank {r['h1_one_cache']} B: "
              f"{c['cache_bytes'] / r['h1_one_cache']:.4f}), pool "
              f"{pg['pages']} pages; peak {r['h1_draw_peak'] / 2**30:.2f} "
              f"GiB over the weights' draw (one rank, phase 4: "
              f"{one.times['peak_gib']:.2f}), "
              f"{r['h1_peak'] / 2**30:.2f} GiB serving with "
              f"{r['h1_weights'] / 2**30:.2f} GiB of weights resident; "
              f"prefill {_median(c['prefill_ms']):.3f} ms a group (median "
              f"of {len(c['prefill_ms'])}; one rank "
              f"{one.times['prefill_ms']:.3f}; rows moved in "
              f"{c['move_s']:.3f} s of {sum(c['prefill_ms']) / 1e3:.3f} s "
              f"of prefill), decode "
              f"{_median(c['decode_ms']):.3f} ms a step contiguous, "
              f"{_median(pg['decode_ms']):.3f} paged (medians of "
              f"{len(c['decode_ms'])}; one rank "
              f"{one.times['decode_ms']:.3f}); launches "
              f"{c['counts']} contiguous; {smi}")
    # (h2)
    for r in ranks:
        gap = check_batch_rank(r, h2_one, REF_TOL, "h2")
        phase("batch", "h2", f"rank {r['coords']}: jamba smoke fp32 tokens "
              f"equal one rank's, logits on its rows within {gap:.3e} "
              f"(REF_TOL {REF_TOL}); launches contiguous "
              f"{r['h2']['contiguous']['counts']}, paged "
              f"{r['h2']['paged']['counts']}")
    for mode in ("contiguous", "paged"):
        want = h2_one[mode]["drops"]
        got = [sum(r["h2"][mode]["drops"][j][0] for r in ranks)
               if ranks[0]["h2"][mode]["drops"][j][1]
               else ranks[0]["h2"][mode]["drops"][j][0]
               for j in range(len(want))]
        check(len(ranks[0]["h2"][mode]["drops"]) == len(want)
              and got == [d for d, _ in want] and sum(got) > 0,
              f"batch h2 {mode}: drops by MoE call {sum(got)} over the "
              f"ranks, one rank {sum(d for d, _ in want)}")
        phase("batch", "h2", f"{mode}: {sum(got)} assignments dropped over "
              f"the ranks in {len(got)} MoE calls, equal call by call to "
              "one rank's (C and the fill over the whole batch at model 1)")
    for kern in ("flash_attention", "decode_attention",
                 "paged_decode_attention", "moe_gmm", "ssd_scan"):
        check(total.get(kern, 0) > 0, f"batch: {kern} never launched")
    phase("batch", "done", f"world {world_s:.1f} s; launches over the ranks "
          f"{total}; {smi}")
    return total


def phase_dsp(smi):
    """The DSP control plane (``repro_torch.core``, ``serve.driver``,
    ``serve.fleet``) driving musicgen-large at its published widths, depth
    cut to DSP_LAYERS, through ``benchmarks/torch_serve_fleet.py``: a
    ``ServeDriver``
    on one Montage DAG (paged engine) against its ``EmulatedEngine`` twin,
    then the mix-1/2/4 fleet (1 workflow per tenant) paged, contiguous and
    on its twin, with every request's tokens equal paged and contiguous
    (phase 3 holds the kernels at this shape against their plain
    versions). Every launch counter is set to 0 just before each engine
    run and read just after. Returns the runs' summed launch counts."""
    import torch_serve_fleet as tsf
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM
    from repro_torch.serve.driver import EmulatedEngine
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(ARCH), n_layers=DSP_LAYERS)
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    check(cfg.d_model == 2048 and cfg.n_codebooks == 4
          and lm.dtype == torch.bfloat16,
          f"dsp: {cfg.name} is not musicgen-large at published widths, bf16")
    phase("dsp", "serve", f"{cfg.name}: {cfg.n_layers} of 48 layers, d_model "
          f"{cfg.d_model}, {cfg.n_codebooks} codebooks, {cfg.dtype}, drawn in "
          f"{time.perf_counter() - t0:.2f} s; engine max_batch "
          f"{tsf.REAL_MAX_BATCH}, max_len {tsf.REAL_MAX_LEN}")

    eng = tsf.build_engine(lm, tsf.PAGE_SIZE)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    stats, times, order = tsf.dag_run(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dag_launches = ops.launch_counts()
    want = expected_launches(cfg, eng, True)
    check(dag_launches == want and eng.steps > 0,
          f"dsp DAG: launches {dag_launches} != {want}")
    check(not eng.active and len(eng.free) == eng.max_batch
          and eng.pager.used_pages == 0, "dsp DAG: a slot or page not freed")
    eng.pager.check_conservation()
    twin = tsf.dag_run(EmulatedEngine(tsf.REAL_MAX_BATCH,
                                      max_len=tsf.REAL_MAX_LEN))
    check((stats, times, order) == twin, "dsp DAG: ServeStats, task (start, "
          "finish) or completion order differ from the EmulatedEngine twin")
    phase("dsp", "serve", f"ServeDriver, one Montage DAG on the paged engine: "
          f"{stats['tasks_completed']} tasks completed in dependency order, "
          f"{stats['ticks']} ticks, {eng.steps} decode steps, {eng.prefills} "
          f"prefills in {wall:.3f} s; every slot and page freed; ServeStats "
          f"and every task's (start, finish) equal the EmulatedEngine twin's;"
          f" launches {dag_launches}")
    del eng
    free_device_memory()

    row = tsf.fleet_row(lm, "1/2/4", **tsf.DEFAULTS)
    for mode, pre in (("paged", ""), ("contiguous", "contiguous_")):
        run = SimpleNamespace(prefills=row[pre + "prefills"],
                              steps=row[pre + "decode_steps"])
        want = expected_launches(cfg, run, mode == "paged")
        check(row[pre + "launches"] == want, f"dsp fleet {mode}: launches "
              f"{row[pre + 'launches']} != expected {want}")
    check(row["token_mismatches"] == 0 and row["requests"] == row["tasks"],
          f"dsp fleet: {row['token_mismatches']} of {row['requests']} "
          f"requests ({row['tasks']} tasks) differ paged vs contiguous")
    phase("dsp", "fleet", f"mix 1/2/4 (widths {row['widths']}), "
          f"{row['workflows']} workflows, {row['tasks']} tasks, coordinated: "
          f"{row['parity_mismatches']} mismatches against the EmulatedEngine "
          f"twin, {row['paged_vs_contiguous_mismatches']} paged vs "
          f"contiguous; {row['requests']} requests, {row['tokens_out']} "
          f"token steps, {row['token_mismatches']} requests with other tokens"
          f" paged (page 8) than contiguous (block_s 8); "
          f"{row['over_admissions']} over-admissions, "
          f"{row['isolation_violations']} isolation violations; engine and "
          f"pool page ledgers equal, conservation holds (pool "
          f"{row['pool_pages']} pages, peak {row['peak_pages_used']})")
    phase("dsp", "fleet", f"decode steps {row['decode_steps']} paged, "
          f"{row['contiguous_decode_steps']} contiguous, "
          f"{row['twin_decode_steps']} twin; wall {row['wall_s']:.3f} s paged "
          f"({row['ms_per_decode_step']:.3f} ms per decode step), "
          f"{row['contiguous_wall_s']:.3f} s contiguous "
          f"({row['contiguous_ms_per_decode_step']:.3f} ms); billed "
          f"{row['billed_node_hours']} node-h against dedicated "
          f"{row['dedicated_node_hours']} (billed / dedicated "
          f"{row['billed_vs_dedicated']:.4f}); launches paged "
          f"{row['launches']}, contiguous {row['contiguous_launches']}; {smi}")
    total = dict(dag_launches)
    for counts in (row["launches"], row["contiguous_launches"]):
        for k, v in counts.items():
            total[k] += v
    return total


def flash_shape(label, heads, hdim, first, flush, gen, plain=True):
    """Flash at the largest prefill group of phase 4's first admit window
    (``first``'s prompts of the longest length) at ``heads`` x ``hdim``,
    bf16, causal: kernel, plain (where ``plain``) and SDPA-flash times,
    bound and error."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.kernels import flash_attention as fa
    S = max(first)
    BH = first.count(S) * heads
    q, k, v = (rand((BH, S, hdim), torch.bfloat16, gen) for _ in range(3))
    b_ms, b_by = fa.cost(BH, S, S, hdim, torch.bfloat16).bound()
    err = max_err(flash_attention(q, k, v, causal=True),
                  flash_attention_ref(q, k, v), TOL["bfloat16"])
    ms = time_ms(lambda: flash_attention(q, k, v), flush)
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), flush)
    return dict(
        label=f"{label} BH={BH} S={S} hd={hdim} bf16 causal", err=err,
        ms=ms, lib=lib, b_ms=b_ms, b_by=b_by,
        plain=(time_ms(lambda: flash_attention_ref(q, k, v), flush)
               if plain else None))


def tp_rows(by_run, flush, gen):
    """Rows at the tensor-parallel runs' shapes, launches from those runs
    (both ranks): flash, decode and paged decode at qwen3-14b's 20/4 heads
    a rank (T1; G 5), ssd_scan at mamba2's 32 SSM heads a rank (T3, its
    largest prefill group, 3 x 512)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.blocks import DECODE_BLOCK_S
    qwen3 = get_config("qwen3-14b")
    H, KVH, hd = qwen3.n_heads // 2, qwen3.n_kv_heads // 2, qwen3.head_dim
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    t1 = by_run["T1"]
    fl = flash_shape("qwen3 TP2", H, hd, first, flush, gen)
    rows = [dict(
        name="flash_attention qwen3-tp2", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=t1["flash_attention"], max_abs_err=fl["err"], ms=fl["ms"],
        plain_ms=fl["plain"], bound_ms=fl["b_ms"], bound_by=fl["b_by"],
        library_ms=fl["lib"],
        shape=f"{fl['label']} (qwen3-14b's heads a rank over 2; launches: "
              "T1's, both ranks); library: scaled_dot_product_attention "
              "under sdpa_kernel(SDPBackend.FLASH_ATTENTION)")]
    dc = decode_shape("qwen3 TP2", H, KVH, hd, first, flush, gen)
    for name, replaces, pre in (
            ("decode_attention", "decode_attention.py:83", ""),
            ("paged_decode_attention", "paged_decode_attention.py:90",
             "paged_")):
        rows.append(dict(
            name=f"{name} qwen3-tp2", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=f"src/repro/kernels/{replaces}",
            launches=t1[name], max_abs_err=dc[pre + "err"],
            ms=dc[pre + "ms"], plain_ms=dc[pre + "plain"],
            bound_ms=dc[pre + "b_ms"], bound_by=dc[pre + "b_by"],
            library_ms=None if pre else dc["lib"],
            shape=f"{dc['label']} (G 5, qwen3-14b's heads a rank over 2; "
                  "launches: T1's, both ranks); "
                  + (f"page_size={DECODE_BLOCK_S}, shuffled pages; library "
                     "n/a: no single PyTorch call attends through a page "
                     "table" if pre else "library: scaled_dot_product_"
                     "attention with a length mask and enable_gqa")))
    mamba2 = get_config("mamba2-1.3b")
    B, S = 3, max(PLENS)
    nh, hp, ng, ds = (mamba2.n_ssm_heads // 2, mamba2.ssm_head_dim,
                      mamba2.ssm_groups, mamba2.d_state)
    chunk = min(mamba2.ssm_chunk, S)
    args = ssd_inputs(B, S, nh, hp, ng, ds, torch.bfloat16, gen)
    b_ms, b_by = ssd_bound(B, S, nh, hp, ng, ds, chunk, 2)
    y, st = ssd_scan(*args, chunk=chunk)
    y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
    err = max(max_err(y, y_ref, *SSD_TOL["bfloat16"]),
              max_err(st, st_ref, *SSD_TOL["bfloat16"]))
    rows.append(dict(
        name="ssd_scan mamba2-tp2", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:85",
        launches=by_run["T3"]["ssd_scan"], max_abs_err=err,
        ms=time_ms(lambda: ssd_scan(*args, chunk=chunk), flush),
        plain_ms=time_ms(lambda: ssd_scan_ref(*args, chunk=chunk), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"mamba2 B={B} S={S} nh={nh} hp={hp} ng={ng} ds={ds} "
              f"chunk={chunk} bf16 in, fp32 out (32 of its 64 SSM heads a "
              "rank over 2; launches: T3's, both ranks); library n/a: no "
              "single PyTorch call computes a chunked SSD scan"))
    return rows


def attention_rows(launches, kimi_launches, arctic_launches, flush, gen):
    """Rows of flash, decode and paged decode at musicgen's heads (arctic's
    decode beside them in the shape text), of flash at arctic's hd-128
    heads (H 56), whose launches are the arctic path's, and of the same
    three at kimi-k2's hd-112 heads (H 64, KVH 8), whose launches are the
    kimi path's."""
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import DECODE_BLOCK_S

    cfg = get_config(ARCH)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    rows = []

    # flash at the largest prefill group of phase 4's first admit window,
    # musicgen's (the row), arctic's hd-128 and kimi-k2's hd-112 heads (a
    # row of its own); the library is SDPA pinned to its flash backend
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    arctic = get_config("arctic-480b")
    kimi = get_config("kimi-k2-1t-a32b")
    mg, ar, km = (flash_shape(label, heads, hdim, first, flush, gen)
                  for label, heads, hdim in (
                      ("musicgen", H, hd),
                      ("arctic", arctic.n_heads, arctic.head_dim),
                      ("kimi-k2", kimi.n_heads, kimi.head_dim)))
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=launches["flash_attention"], max_abs_err=mg["err"],
        ms=mg["ms"], plain_ms=mg["plain"], bound_ms=mg["b_ms"],
        bound_by=mg["b_by"], library_ms=mg["lib"],
        shape=f"{mg['label']}; library: scaled_dot_product_attention "
              "under sdpa_kernel(SDPBackend.FLASH_ATTENTION)"))
    rows.append(dict(
        name="flash_attention hd128", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=arctic_launches["flash_attention"], max_abs_err=ar["err"],
        ms=ar["ms"], plain_ms=ar["plain"], bound_ms=ar["b_ms"],
        bound_by=ar["b_by"], library_ms=ar["lib"],
        shape=f"{ar['label']} (arctic-480b's heads; launches: the arctic "
              "path's); library: scaled_dot_product_attention under "
              "sdpa_kernel(SDPBackend.FLASH_ATTENTION)"))
    rows.append(dict(
        name="flash_attention hd112", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=kimi_launches["flash_attention"], max_abs_err=km["err"],
        ms=km["ms"], plain_ms=km["plain"], bound_ms=km["b_ms"],
        bound_by=km["b_by"], library_ms=km["lib"],
        shape=f"{km['label']} (kimi-k2's heads; launches: the kimi path's); "
              "library: scaled_dot_product_attention under sdpa_kernel("
              "SDPBackend.FLASH_ATTENTION)"))

    # decode at phase 4's first wave, half way through its new tokens:
    # musicgen's heads (the rows) and arctic's GQA heads beside them
    shapes = [decode_shape(label, heads, kvh, hdim, first, flush, gen)
              for label, heads, kvh, hdim in (
                  ("musicgen", H, KVH, hd),
                  ("arctic", arctic.n_heads, arctic.n_kv_heads,
                   arctic.head_dim),
                  ("kimi-k2", kimi.n_heads, kimi.n_kv_heads,
                   kimi.head_dim))]
    mg, ar, km = shapes
    for name, replaces, lib in (
            ("decode_attention", "decode_attention.py:83", "lib"),
            ("paged_decode_attention", "paged_decode_attention.py:90",
             None)):
        pre = "" if name == "decode_attention" else "paged_"
        rows.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=f"src/repro/kernels/{replaces}",
            launches=launches[name], max_abs_err=mg[pre + "err"],
            ms=mg[pre + "ms"], plain_ms=mg[pre + "plain"],
            bound_ms=mg[pre + "b_ms"], bound_by=mg[pre + "b_by"],
            library_ms=mg["lib"] if lib else None,
            shape=f"{mg['label']}; {ar['label']}: kernel "
                  f"{ar[pre + 'ms']:.4f} ms, "
                  + (f"library {ar['lib']:.4f} ms, " if lib else "")
                  + f"plain {ar[pre + 'plain']:.4f} ms, bound "
                  f"{ar[pre + 'b_ms']:.4f} ms ({ar[pre + 'b_by']}), "
                  f"{ar[pre + 'b_ms'] / ar[pre + 'ms']:.1%} of bound, max "
                  f"abs err {ar[pre + 'err']:.3e}; "
                  + ("library: scaled_dot_product_attention with a length "
                     "mask (enable_gqa at G > 1)" if lib else
                     f"page_size={DECODE_BLOCK_S}, shuffled pages; library "
                     "n/a: no single PyTorch call attends through a page "
                     "table")))
        rows.append(dict(
            name=f"{name} hd112", route="cuda",
            source="src/repro_torch/kernels/csrc/decode_attention.cu",
            replaces=f"src/repro/kernels/{replaces}",
            launches=kimi_launches[name], max_abs_err=km[pre + "err"],
            ms=km[pre + "ms"], plain_ms=km[pre + "plain"],
            bound_ms=km[pre + "b_ms"], bound_by=km[pre + "b_by"],
            library_ms=km["lib"] if lib else None,
            shape=f"{km['label']} (kimi-k2's heads, G 8; launches: the kimi "
                  "path's); "
                  + ("library: scaled_dot_product_attention with a length "
                     "mask and enable_gqa" if lib else
                     f"page_size={DECODE_BLOCK_S}, shuffled pages; library "
                     "n/a: no single PyTorch call attends through a page "
                     "table")))
    return rows


def decode_shape(label, H, KVH, hd, first, flush, gen):
    """Contiguous and paged decode at batch MAX_BATCH, half way through
    phase 4's first wave, bf16: kernel, plain and masked-SDPA times,
    bounds and errors."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import cost, decode_attention
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.models.blocks import DECODE_BLOCK_S
    B, dtype = MAX_BATCH, torch.bfloat16
    lens = [p + NEW_TOKENS // 2 for p in first]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qd = rand((B, H, hd), dtype, gen)
    kc = rand((B, MAX_LEN, KVH, hd), dtype, gen)
    vc = rand((B, MAX_LEN, KVH, hd), dtype, gen)
    r = dict(label=f"{label} B={B} H={H} KVH={KVH} hd={hd} S={MAX_LEN} "
                   f"block_s={DECODE_BLOCK_S} lengths={lens} bf16")
    r["b_ms"], r["b_by"] = cost(B, H, KVH, hd, sum(lens), dtype).bound()
    valid = (torch.arange(MAX_LEN, device="cuda")[None, :]
             < lengths[:, None])[:, None, None, :]
    kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    gqa = {"enable_gqa": True} if H != KVH else {}

    def run():
        return decode_attention(qd, kc, vc, lengths, block_s=DECODE_BLOCK_S)

    out = run()
    r["err"] = max_err(out, decode_attention_ref(qd, kc, vc, lengths),
                       TOL["bfloat16"])
    r["ms"] = time_ms(run, flush)
    r["plain"] = time_ms(lambda: decode_attention_ref(qd, kc, vc, lengths),
                         flush)
    r["lib"] = time_ms(lambda: F.scaled_dot_product_attention(
        qd[:, :, None], kt, vt, attn_mask=valid, **gqa), flush)

    kp, table = paged_layout(kc, DECODE_BLOCK_S, torch.Generator(
    ).manual_seed(5))
    vp = torch.full_like(kp, float("nan"))
    vp[table.reshape(-1).long()] = vc.reshape(-1, DECODE_BLOCK_S, KVH, hd)

    def run_paged():
        return paged_decode_attention(qd, kp, vp, table, lengths)

    paged = run_paged()
    check(torch.equal(paged, out), f"timed shapes ({label}): paged != "
          "contiguous")
    r["paged_b_ms"], r["paged_b_by"] = cost(
        B, H, KVH, hd, sum(lens), dtype, table=table.numel()).bound()
    r["paged_err"] = max_err(paged, paged_decode_attention_ref(
        qd, kp, vp, table, lengths), TOL["bfloat16"])
    r["paged_ms"] = time_ms(run_paged, flush)
    r["paged_plain"] = time_ms(lambda: paged_decode_attention_ref(
        qd, kp, vp, table, lengths), flush)
    return r


def launches_per_call(fn):
    """Device kernels one call of ``fn`` runs, counted by torch.profiler
    (None where it sees no CUDA kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    return n or None


def phase_launches_per_call():
    """{kernel: device kernels one wrapper call runs} at phase 5's shapes,
    bf16: flash and decode at musicgen's heads, moe_gmm at arctic's C 1
    (split over d), ssd_scan at mamba2's 3 x 512. Counted before the
    serve phase: profiler sessions opened after the engine's profiled
    decode steps have seen no CUDA kernel."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ssd_scan import ssd_scan
    from repro_torch.models.blocks import DECODE_BLOCK_S
    gen = torch.Generator(device="cuda").manual_seed(7)
    bf16, ps = torch.bfloat16, DECODE_BLOCK_S
    q, k, v = (rand((64, 512, 64), bf16, gen) for _ in range(3))
    n = {"flash_attention": launches_per_call(
        lambda: flash_attention(q, k, v))}
    qd = rand((MAX_BATCH, 32, 64), bf16, gen)
    kc, vc = (rand((MAX_BATCH, MAX_LEN, 32, 64), bf16, gen)
              for _ in range(2))
    lengths = torch.full((MAX_BATCH,), 300, dtype=torch.int32, device="cuda")
    table = torch.arange(MAX_BATCH * MAX_LEN // ps, dtype=torch.int32,
                         device="cuda").reshape(MAX_BATCH, -1)
    kp, vp = (t.reshape(-1, ps, 32, 64) for t in (kc, vc))
    n["decode_attention"] = launches_per_call(
        lambda: decode_attention(qd, kc, vc, lengths, block_s=ps))
    n["paged_decode_attention"] = launches_per_call(
        lambda: paged_decode_attention(qd, kp, vp, table, lengths))
    w = rand((128, 7168, 4864), bf16, gen)
    x = rand((128, 1, 7168), bf16, gen)
    n["moe_gmm"] = launches_per_call(lambda: moe_gmm(x, w))
    del w
    args = ssd_inputs(3, 512, 64, 64, 1, 128, bf16, gen)
    n["ssd_scan"] = launches_per_call(lambda: ssd_scan(*args, chunk=256))
    phase(3, "kernels", "device kernels one call runs (torch.profiler), at "
          "phase 5's shapes: " + ", ".join(f"{k} {v}" for k, v in n.items()))
    return n


def gmm_row(launches, counts_by_t, flush, gen):
    """moe_gmm at arctic's decode step: C = 1 with every row filled (the
    row: the contract torch.bmm computes), then with the filled counts of
    a decode step (``moe_counts``), whose bound prices only the filled
    experts' weights; arctic's largest prefill group (C = 30) beside."""
    from repro_torch.kernels.moe_gmm import cost, moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    E, d, f = 128, 7168, 4864
    w = rand((E, d, f), torch.float32, gen).mul_(d ** -0.5).to(torch.bfloat16)
    extra = []
    for C in (30, 1):
        x = rand((E, C, d), torch.bfloat16, gen)
        b_ms, b_by = cost(E, C, d, f, torch.bfloat16).bound()
        ms = time_ms(lambda: moe_gmm(x, w), flush)
        lib = time_ms(lambda: torch.bmm(x, w), flush)
        extra.append(f"C={C}: kernel {ms:.4f} ms, torch.bmm {lib:.4f} ms, "
                     f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
    T, counts = MAX_BATCH, counts_by_t[MAX_BATCH]
    live, filled = int((counts > 0).sum()), int(counts.sum())
    c_ms, c_by = cost(E, 1, d, f, torch.bfloat16, live=live,
                      rows=filled).bound()
    err = max_err(moe_gmm(x, w, counts), moe_gmm_ref(x, w, counts),
                  *GMM_TOL["bfloat16"])
    cms = time_ms(lambda: moe_gmm(x, w, counts), flush)
    extra.append(f"C=1 at a real decode step's counts (T {T}: {live} of {E} "
                 f"experts filled, {filled} rows): kernel {cms:.4f} ms, bound "
                 f"{c_ms:.4f} ms ({c_by}) on the filled experts' weights, "
                 f"{c_ms / cms:.1%} of bound, max abs err {err:.3e}")
    row = dict(
        name="moe_gmm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:58",
        launches=launches["moe_gmm"],
        max_abs_err=max_err(moe_gmm(x, w), moe_gmm_ref(x, w),
                            *GMM_TOL["bfloat16"]),
        ms=ms, plain_ms=time_ms(lambda: moe_gmm_ref(x, w), flush, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=f"arctic E={E} C=1 d={d} f={f} bf16, every row filled; "
              + "; ".join(extra) + "; library: torch.bmm")
    del x, w
    return row


SWEEP_SPLITS = (1, 2, 3, 4, 7)


def gmm_split_sweep(counts_by_t, flush, gen, name):
    """moe_gmm at every C of arctic's path, both orientations, with the
    filled counts of the call that gives that C (``moe_counts``), and at
    C 1 with every row filled: times at several splits over d beside the
    one ``plan`` picks. The split rule in kernels/moe_gmm.py rests on
    these times."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm import cost, launch, plan
    from repro_torch.kernels.ref import moe_gmm_ref
    from repro_torch.models.moe import capacity
    arctic = get_config("arctic-480b")
    E = arctic.n_experts
    cases = [(capacity(T, arctic), T, c) for T, c in sorted(
        counts_by_t.items())] + [(1, None, None)]
    for d, f in ((7168, 4864), (4864, 7168)):
        w = rand((E, d, f), torch.float32, gen).mul_(d ** -0.5).to(
            torch.bfloat16)
        for C, T, counts in cases:
            x = rand((E, C, d), torch.bfloat16, gen)
            p = plan(x, w)
            ref = moe_gmm_ref(x, w, counts)
            times = {}
            for sp in sorted(set(SWEEP_SPLITS) | {p.splits}):
                q = p._replace(splits=sp)
                max_err(launch(x, w, counts, q), ref, *GMM_TOL["bfloat16"])
                times[sp] = time_ms(lambda: launch(x, w, counts, q), flush)
            best = min(times, key=times.get)
            live = E if counts is None else int((counts > 0).sum())
            rows = E * C if counts is None else int(counts.sum())
            b_ms, b_by = cost(E, C, d, f, torch.bfloat16, live=live,
                              rows=rows).bound()
            what = ("every row filled" if counts is None else
                    f"T {T}: {live} of {E} experts filled, {rows} rows")
            phase(5, "times", f"moe_gmm split sweep d {d} -> f {f}, C {C} "
                  f"({what}): " + ", ".join(
                      f"{sp} ranges {t:.4f} ms" for sp, t in times.items())
                  + f"; plan picks {p.splits} ({times[p.splits]:.4f} ms, "
                  f"{b_ms / times[p.splits]:.1%} of the {b_ms:.4f} ms bound "
                  f"({b_by}) on the filled experts), fastest {best} "
                  f"({times[best] / times[p.splits]:.1%} of plan's time); "
                  f"{name}")
            del x, ref
        del w
        free_device_memory()


def ssd_bound(B, S, nh, hp, ng, ds, chunk, elt):
    """(ms, by) of one bf16 ssd_scan call (``kernels.ssd_scan.cost``)."""
    from repro_torch.kernels.ssd_scan import cost
    return cost(B, S, nh, hp, ng, ds, chunk, torch.bfloat16).bound()


def ssd_bound_fp32(B, S, nh, hp, ng, ds, chunk, elt):
    """The bound of a kernel that runs the fp32-operand products on CUDA
    cores, as PERF.md counted it before the tensor-core kernel: the
    scores once per head at the bf16 rate, the rest at the fp32 rate."""
    from repro_torch.kernels.ssd_scan import io_bytes
    tri = chunk * (chunk + 1) // 2
    n = 2 * (S // chunk) * B * nh
    return bound(io_bytes(B, S, nh, hp, ng, ds, elt),
                 (n * tri * ds, PEAK_BF16_FLOPS),
                 (n * (tri * hp + 2 * chunk * hp * ds), PEAK_FP32_FLOPS))


def ssd_row(launches, flush, gen, name):
    """ssd_scan at each mamba2 prefill group shape of phase 4 (1 to 3
    prompts of 128, 256 or 512 tokens; the row is 3 x 512), with every hp
    tile of the bf16 grid timed beside the one ``hp_tile`` picks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels.ref import ssd_scan_ref
    cfg = get_config("mamba2-1.3b")
    nh, hp, ng, ds = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                      cfg.d_state)
    extra, row = [], None
    for B in range(1, -(-MAX_BATCH // len(PLENS)) + 1):
        for S in PLENS:
            chunk = min(cfg.ssm_chunk, S)
            args = ssd_inputs(B, S, nh, hp, ng, ds, torch.bfloat16, gen)
            b_ms, b_by = ssd_bound(B, S, nh, hp, ng, ds, chunk, 2)
            o_ms, _ = ssd_bound_fp32(B, S, nh, hp, ng, ds, chunk, 2)
            y, st = ssd.ssd_scan(*args, chunk=chunk)
            y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
            err = max(max_err(y, y_ref, *SSD_TOL["bfloat16"]),
                      max_err(st, st_ref, *SSD_TOL["bfloat16"]))
            ms = time_ms(lambda: ssd.ssd_scan(*args, chunk=chunk), flush)
            tiles = {}
            for tile in ssd.HP_TILES:
                if hp % tile:
                    continue
                yt, stt = torch.empty_like(y), torch.empty_like(st)
                ssd.launch(*args, yt, stt, chunk, tile)
                max_err(yt, y_ref, *SSD_TOL["bfloat16"])
                tiles[tile] = time_ms(
                    lambda: ssd.launch(*args, yt, stt, chunk, tile), flush)
            pick = ssd.hp_tile(B, nh, hp, torch.bfloat16,
                               lambda t: ssd._wave(0, t, ds))
            best = min(tiles, key=tiles.get)
            phase(5, "times", f"ssd_scan hp-tile sweep mamba2 B={B} S={S} "
                  f"chunk={chunk}: " + ", ".join(
                      f"tile {t} {v:.4f} ms ({B * nh * hp // t} blocks, "
                      f"{ssd._wave(0, t, ds)} a wave)"
                      for t, v in tiles.items())
                  + f"; hp_tile picks {pick}, fastest {best} "
                  f"({tiles[best] / tiles[pick]:.1%} of the pick's time); "
                  f"{name}")
            label = (f"mamba2 B={B} S={S} nh={nh} hp={hp} ng={ng} ds={ds} "
                     f"chunk={chunk} bf16 in, fp32 out")
            if (B, S) == (3, max(PLENS)):
                row = dict(
                    name="ssd_scan", route="cuda",
                    source="src/repro_torch/kernels/csrc/ssd_scan.cu",
                    replaces="src/repro/kernels/ssd_scan.py:85",
                    launches=launches["ssd_scan"], max_abs_err=err, ms=ms,
                    plain_ms=time_ms(
                        lambda: ssd_scan_ref(*args, chunk=chunk), flush),
                    bound_ms=b_ms, bound_by=b_by, library_ms=None)
                row_label = (f"{label} (bound with the products at the "
                             f"fp32 rate {o_ms:.4f} ms)")
            else:
                extra.append(f"B={B} S={S}: kernel {ms:.4f} ms, bound "
                             f"{b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of "
                             f"bound, at the fp32 rate {o_ms:.4f} ms, max "
                             f"abs err {err:.3e}")
            del args, y, st, y_ref, st_ref
    row["shape"] = (f"{row_label}; " + "; ".join(extra) + "; bound: the C.B "
                    "scores once per group at the bf16 tensor-core rate, "
                    "the products with an fp32 operand at the TF32 rate; "
                    "library n/a: no single PyTorch call computes a chunked "
                    "SSD scan")
    return row


def phase_times(launches, by_path, by_run, arctic_counts, name,
                per_call):
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = attention_rows(launches, by_path["kimi-k2-1t-a32b"],
                          by_path["arctic-480b"], flush, gen)
    rows.append(gmm_row(launches, arctic_counts, flush, gen))
    free_device_memory()
    gmm_split_sweep(arctic_counts, flush, gen, name)
    rows.append(ssd_row(launches, flush, gen, name))
    rows += tp_rows(by_run, flush, gen)
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        n = per_call[r["name"].split()[0]]
        phase(5, "times", f"{r['name']} [{r.pop('shape')}]: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['bound_ms'] / r['ms']:.1%} of bound; launches "
              f"{r['launches']} on the serve paths, "
              + (f"{n} device kernels per call" if n else "device kernels "
                 "per call not measured (the profiler saw none)")
              + f"; {name}")
    return rows


# ----------------------------------------------------------------- train
def loss_and_grads(lm, batch, parallel):
    """(loss, metrics, {path: gradient}) of one forward and backward."""
    from repro_torch.models.lm import tree_leaves
    paths, leaves = zip(*tree_leaves(lm.params))
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = lm.loss(batch, parallel)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), metrics, dict(zip(paths, grads))


def grad_errors(card, cpu, kind, scales=None):
    """(worst |card - cpu|, worst (err / bound), its leaf, {leaf: (worst
    err, ratio, scale)}) of two {path: gradient} maps, on ``cpu``'s
    devices. ``scales``: {path: the whole leaf's largest |gradient|} where
    the maps hold slices of the leaves, else None."""
    worst_abs, worst_ratio, worst_leaf, per_leaf = 0.0, 0.0, "", {}
    for path, ref in cpu.items():
        out = card[path].to(ref.device)
        scale = max(1.0, scales[path] if scales is not None
                    else ref.abs().max().item())
        bound = TRAIN_RTOL * ref.abs() + TRAIN_ATOL[kind] * scale
        err = (out - ref).abs()
        check(bool(torch.isfinite(out).all()), f"{path}: gradient not "
              "finite on the card")
        ratio = (err / bound).max().item()
        per_leaf[path] = (err.max().item(), ratio, scale)
        if ratio > worst_ratio:
            worst_ratio, worst_leaf = ratio, path
        worst_abs = max(worst_abs, err.max().item())
    return worst_abs, worst_ratio, worst_leaf, per_leaf


def train_card_vs_cpu(label, cfg, rcfg, kind):
    """Loss and every gradient leaf on the card against the CPU's plain
    path, on the same weights and batch, fp32; prints the worst errors.
    Then the control: the card's gradients again with TF32 products, a
    lower precision, which the same bound must reject (worst err / bound
    above TF32_CONTROL_MIN)."""
    from repro_torch.bridge import init_params
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_map
    check(cfg.dtype == "float32" and not torch.backends.cuda.matmul.allow_tf32,
          f"train {label}: the card check needs fp32 without TF32")
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(7),
                         "cuda")
    cpu_params = tree_map(lambda t: t.cpu(), params)
    batch = synthetic_batches(rcfg, "cuda")(0)
    t0 = time.perf_counter()
    lg, mg, gg = loss_and_grads(LM(cfg, params, device="cuda"), batch,
                                rcfg.parallel)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    lc, mc, gc_ = loss_and_grads(LM(cfg, cpu_params, device="cpu"),
                                 {k: v.cpu() for k, v in batch.items()},
                                 rcfg.parallel)
    t2 = time.perf_counter()
    loss_err = abs(lg - lc) / abs(lc)
    check(math.isfinite(lg) and loss_err <= TRAIN_LOSS_RTOL,
          f"train {label}: loss card {lg!r} vs CPU {lc!r}, rel err "
          f"{loss_err:.3e} > {TRAIN_LOSS_RTOL}")
    worst_abs, worst_ratio, worst_leaf, per_leaf = grad_errors(gg, gc_, kind)
    for path, (err, ratio, scale) in per_leaf.items():
        check(ratio <= 1.0, f"train {label}: gradient {path} off by "
              f"{err:.3e}, {ratio:.2f} x its bound (rtol {TRAIN_RTOL}, "
              f"atol {TRAIN_ATOL[kind]} x {scale:.3g})")
    phase("train", label, f"{cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, fp32, seq {rcfg.shape.seq_len}, batch "
          f"{rcfg.shape.global_batch}: loss card {lg:.6f} vs CPU {lc:.6f} "
          f"(rel err {loss_err:.3e}, tol {TRAIN_LOSS_RTOL}); metrics ce "
          f"{mg['ce'].item():.6f}/{mc['ce'].item():.6f}, moe_lb "
          f"{mg['moe_lb_loss'].item():.6f}/{mc['moe_lb_loss'].item():.6f}; "
          f"{len(gc_)} gradient leaves: worst abs err {worst_abs:.3e}, "
          f"worst err / bound {worst_ratio:.3f} ({worst_leaf}; rtol "
          f"{TRAIN_RTOL}, atol {TRAIN_ATOL[kind]} x max(1, leaf max)); "
          f"card {t1 - t0:.2f} s, CPU {t2 - t1:.2f} s")
    del gg
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lt, _, gt = loss_and_grads(LM(cfg, params, device="cuda"), batch,
                                   rcfg.parallel)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    t_abs, t_ratio, t_leaf, _ = grad_errors(gt, gc_, kind)
    phase("train", label, f"control, TF32 products on the card: loss rel "
          f"err {abs(lt - lc) / abs(lc):.3e}; worst abs err {t_abs:.3e}, "
          f"worst err / bound {t_ratio:.3f} ({t_leaf}), must exceed "
          f"{TF32_CONTROL_MIN}")
    check(t_ratio > TF32_CONTROL_MIN, f"train {label}: with TF32 on, the "
          f"gradients land at {t_ratio:.3f} of the bound: the bound cannot "
          "tell TF32 from fp32")


def musicgen_cut(dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), n_layers=2, dtype=dtype)


def train_resume(smi):
    """(b): the preemptible loop on the card, bf16: losses bitwise equal to
    the uninterrupted run's, falling; then one loss and backward under
    torch.use_deterministic_algorithms (raises on an op that has no
    deterministic implementation)."""
    import numpy as np
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.train.loop import train_loop
    cfg = musicgen_cut("bfloat16")
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("train_cut", "train", 512,
                                                  2),
                     learning_rate=3e-3, warmup_steps=2, total_steps=12)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        ref = train_loop(rcfg, ckpt_dir=os.path.join(d, "ref"), num_steps=12,
                         ckpt_every=4, device="cuda")
        t1 = time.perf_counter()
        rep = train_loop(rcfg, ckpt_dir=os.path.join(d, "pre"), num_steps=12,
                         ckpt_every=4, fail_at={6: True}, device="cuda")
    t2 = time.perf_counter()
    check(rep.restarts == 1 and len(rep.losses) == 14,
          f"train resume: {rep.restarts} restarts, {len(rep.losses)} losses")
    check(rep.losses[:6] == ref.losses[:6] and rep.losses[6:] == ref.losses[4:]
          and rep.final_loss == ref.final_loss,
          f"train resume: losses differ from the uninterrupted run's: "
          f"{rep.losses} vs {ref.losses}")
    first, last = np.mean(ref.losses[:5]), np.mean(ref.losses[-5:])
    check(all(math.isfinite(x) for x in ref.losses) and last < first - 0.1,
          f"train resume: loss did not fall: first 5 mean {first}, last 5 "
          f"mean {last}")
    phase("train", "resume", f"{cfg.name}: {cfg.n_layers} layers, bf16, seq "
          f"512, batch 2, lr 3e-3, warmup 2: 12 steps in {t1 - t0:.2f} s; "
          f"with a preemption before step 6, {rep.restarts} restart and "
          f"{len(rep.losses)} losses in {t2 - t1:.2f} s, equal to the "
          f"uninterrupted run's step for step, bit for bit; mean of the "
          f"first 5 {first:.4f}, of the last 5 {last:.4f}; losses "
          + ", ".join(f"{x:.4f}" for x in ref.losses) + f"; {smi}")
    from repro_torch.bridge import init_params
    from repro_torch.models.lm import LM
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    torch.use_deterministic_algorithms(True)
    try:
        loss_and_grads(lm, synthetic_batches(rcfg, "cuda")(0), rcfg.parallel)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    phase("train", "resume", "one loss and backward under torch."
          "use_deterministic_algorithms(True): no op of the training route "
          "lacks a deterministic implementation")


def train_full(smi):
    """(c): musicgen-large at full width and depth, bf16, seq 4096, batch
    8 in 8 microbatches, remat per layer: TRAIN_FULL_STEPS steps from a
    fresh init."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.bridge import init_params
    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_config)
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_leaves
    from repro_torch.train.train_step import build_train_step
    cfg = get_config(ARCH)
    shape = ShapeConfig("train_card", "train", 4096, 8)
    rcfg = RunConfig(model=cfg, shape=shape,
                     parallel=ParallelConfig(microbatches=8))
    check(cfg.n_layers == 48 and cfg.d_model == 2048 and cfg.dtype ==
          "bfloat16" and rcfg.parallel.remat == "block",
          "train full: not musicgen-large at published widths, bf16, remat")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    step_fn, opt = build_train_step(lm, rcfg)
    state = opt.init(lm.params)
    batches = synthetic_batches(rcfg, "cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(lm.params))
    tokens = shape.global_batch * shape.seq_len
    S, L, d = shape.seq_len, cfg.n_layers, cfg.d_model
    flops = 6 * n_params * tokens + 12 * L * S * S * d * shape.global_batch
    phase("train", "full", f"{cfg.name}: {L} layers, d_model {d}, "
          f"{cfg.n_codebooks} codebooks, bf16, {n_params / 1e9:.3f} B params "
          f"and optimizer state in {time.perf_counter() - t0:.2f} s; seq {S}, "
          f"batch {shape.global_batch} in {rcfg.parallel.microbatches} "
          f"microbatches, remat {rcfg.parallel.remat}; model FLOPs per step "
          f"{flops / 1e12:.1f} T (6 N tokens + 12 L S^2 d per sequence, "
          "recompute left out)")
    for step in range(TRAIN_FULL_STEPS):
        batch = batches(step)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step_fn(state, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        loss, gnorm = met["loss"].item(), met["grad_norm"].item()
        check(math.isfinite(loss) and math.isfinite(gnorm),
              f"train full: step {step} loss {loss} grad_norm {gnorm}")
        phase("train", "full", f"step {step}: {dt:.3f} s, "
              f"{tokens / dt:.1f} tokens/s, model FLOPs {flops / dt / 1e12:.1f}"
              f" T/s = {flops / dt / PEAK_BF16_FLOPS:.1%} of the "
              f"{PEAK_BF16_FLOPS / 1e12:.0f} T/s bf16 peak; loss {loss:.4f}, "
              f"ce {met['ce'].item():.4f}, grad_norm {gnorm:.4f}, lr "
              f"{met['lr'].item():.3e}; {smi}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase("train", "full", f"peak device memory {peak:.2f} GiB "
          f"(max_memory_allocated; bf16 params {n_params * 2 / 2**30:.2f} "
          f"GiB, m and v {n_params * 4 / 2**30:.2f} GiB); {smi}")
    check(peak < 80, f"train full: peak {peak:.2f} GiB")

    # one microbatch's loss and backward: unprofiled, then profiled
    leaves = [t for _, t in tree_leaves(lm.params)]
    mb = {k: v[:1] for k, v in batches(0).items()}

    def micro():
        loss, _ = lm.loss(mb, rcfg.parallel)
        torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()

    micro()
    t0 = time.perf_counter()
    micro()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        micro()
    by_name, n = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total
            n += 1
    if not n:
        phase("train", "full", "microbatch device time: not measured (the "
              "profiler saw no CUDA kernels)")
        return
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    phase("train", "full", f"one microbatch (seq {S}, loss and backward) "
          f"under torch.profiler: {n} kernels, {busy_ms:.3f} ms of device "
          f"time against {wall_ms:.3f} ms unprofiled ({busy_ms / wall_ms:.1%}"
          " busy); top: " + "; ".join(f"{k[:70]} {v / 1e3:.3f} ms"
                                      for k, v in top) + f"; {smi}")


def phase_train(smi):
    """The HTC training job on the card: (a)-(d) of the module docstring.
    Every launch counter is set to 0 just before and read just after: the
    training route reaches no kernel."""
    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_smoke_config)
    from repro_torch.kernels import ops
    check(not torch.backends.cuda.matmul.allow_tf32, "train: TF32 is on")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    cut = musicgen_cut("float32")
    train_card_vs_cpu("fp32", cut, RunConfig(
        model=cut, shape=ShapeConfig("train_cut", "train", 512, 2)), "dense")
    free_device_memory()
    train_resume(smi)
    free_device_memory()
    train_full(smi)
    free_device_memory()
    jamba = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                                dtype="float32")
    train_card_vs_cpu("jamba", jamba, RunConfig(
        model=jamba, shape=ShapeConfig("train_smoke", "train", 64, 2),
        parallel=ParallelConfig(attn_q_chunk=32, attn_kv_chunk=32)),
        "deep ssm")
    counts = ops.launch_counts()
    check(not any(counts.values()), f"train: kernel launches {counts}: the "
          "training route must reach no kernel")
    phase("train", "done", f"launches across (a)-(d) {counts}; phase "
          f"{time.perf_counter() - t0:.1f} s")


def phase_elastic(smi):
    """Mix D on the live controller over the (b) cut: the elastic phase
    of the module docstring. Every launch counter is set to 0 just before
    and read just after."""
    import shutil
    import torch_elastic as te
    from repro_torch.configs import RunConfig, ShapeConfig
    from repro_torch.kernels import ops
    cfg = musicgen_cut("bfloat16")
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("train_cut", "train", 512,
                                                  2),
                     learning_rate=3e-3, warmup_steps=2, total_steps=12)
    n_params = cfg.param_count()
    # bf16 params, bf16 m and v
    ckpt_gib = n_params * 3 * 2 / 2**30
    # at most 3 kept per job (6), the straight run's 1, one being written
    need_gib = 8 * ckpt_gib
    tmp = tempfile.gettempdir()
    disk = shutil.disk_usage(tmp)
    phase("elastic", "setup", f"{cfg.name}: {cfg.n_layers} of 48 layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, {cfg.n_codebooks} codebooks of "
          f"{cfg.vocab_size}, bf16, {n_params / 1e6:.1f} M params; seq 512, "
          f"batch 2, lr 3e-3, warmup 2; a checkpoint {ckpt_gib:.2f} GiB; "
          f"{tmp}: {disk.free / 2**30:.1f} GiB free of "
          f"{disk.total / 2**30:.1f}")
    check(disk.free / 2**30 > need_gib, f"elastic: {tmp} has "
          f"{disk.free / 2**30:.1f} GiB free, the mix needs about "
          f"{need_gib:.1f} GiB of checkpoints: the card's disk is short")
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        row = te.elastic_row(rcfg, "cuda", d)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    for seg in row["segments"]:
        phase("elastic", "segment", f"tick {seg['tick']} {seg['job']} on "
              f"{seg['alloc']} slot(s): steps {seg['first']}-"
              f"{seg['first'] + seg['steps'] - 1}"
              + (" then preempted" if seg["preempted"] else "")
              + f"; {'init' if seg['fresh'] else 'restore'} "
              f"{seg['entry_s']:.3f} s, {seg['steps']} steps "
              f"{seg['steps_s']:.3f} s, save "
              + ("none" if seg["save_s"] is None else f"{seg['save_s']:.3f} s")
              + f", wall {seg['wall_s']:.3f} s; {smi}")
    dec, stub = row["decisions"], row["stub"]
    check(dec == stub, f"elastic: live decisions {dec} differ from the "
          f"stub segment's {stub}")
    for name, job in row["jobs"].items():
        check(job["losses"] == row["expected"][name], f"elastic: {name}'s "
              f"losses {job['losses']} differ from the straight run's "
              f"{row['expected'][name]}")
    check(dec["allocated"] == 0, f"elastic: {dec['allocated']} nodes "
          "allocated after the destroy")
    check(not any(counts.values()), f"elastic: kernel launches {counts}: "
          "the training route must reach no kernel")
    resident = [seg["resident"] - before for seg in row["segments"]]
    # a state that outlived its segment would hold a checkpoint's worth
    check(max(resident) < 0.5 * ckpt_gib * 2**30, f"elastic: "
          f"{max(resident) / 2**30:.3f} GiB still allocated after a "
          "segment: a segment's state outlives it")
    phase("elastic", "decisions", f"provision deltas {dec['deltas']}, "
          f"finish order {dec['order']}, (steps, resizes, restarts) "
          f"{dec['jobs']}, {dec['ticks']} ticks, {dec['allocated']} nodes "
          f"after the destroy: equal to the stub segment's; billed "
          f"{row['node_ticks']:.0f} node-lease units over the ticks, "
          f"{row['adjusts']} node adjustments")
    for name, job in row["jobs"].items():
        phase("elastic", "job", f"{name}: {job['steps']} steps in "
              f"{job['segments']} segments, wall {job['wall_s']:.3f} s, "
              f"checkpoint I/O {job['io_s']:.3f} s = {job['io_share']:.1%} "
              f"of it; {job['tokens_per_s']:.1f} tokens/s inside the steps;"
              f" losses equal to the straight run's bit for bit: "
              + ", ".join(f"{x:.4f}" for x in job["losses"]) + f"; {smi}")
    phase("elastic", "done", f"straight run {row['straight_s']:.3f} s, live "
          f"run {row['live_s']:.3f} s; peak device memory {peak:.2f} GiB "
          f"(max_memory_allocated), {min(resident) / 2**20:.1f}-"
          f"{max(resident) / 2**20:.1f} MiB left allocated after a segment "
          f"(a state is {ckpt_gib * 1024:.0f} MiB); launches {counts}; "
          f"phase {wall:.1f} "
          f"s; {smi}")


# -------------------------------------------------------------------- dp
def dp_run(cfg, seq, batch, **over):
    """A RunConfig of the dp phase: ``cfg`` at ``seq`` x ``batch``."""
    from repro_torch.configs import ParallelConfig, RunConfig, ShapeConfig
    return RunConfig(model=cfg, shape=ShapeConfig("dp", "train", seq, batch),
                     parallel=ParallelConfig(**over.pop("parallel", {})),
                     **over)


def dp_uneven_batch(rcfg):
    """Step 0's synthetic batch, its first row's mask cut to the first
    quarter of the positions: the ranks' rows hold different token
    counts."""
    from repro_torch.data.synthetic import synthetic_batches
    batch = synthetic_batches(rcfg, "cuda")(0)
    batch["mask"][0, batch["mask"].shape[1] // 4:] = 0
    return batch


@contextlib.contextmanager
def captured_grads(into, device="cpu"):
    """Record the gradients ``AdamW.apply`` is given (fp32 copies on
    ``device``, by path) into ``into``: under a mesh, the ones summed over
    the ranks (a rank's slices under a ``model`` axis)."""
    from repro_torch.models.lm import tree_leaves
    from repro_torch.train import optimizer
    orig = optimizer.AdamW.apply

    def apply(self, state, grads, zero=None, split=None):
        into.update({p: g.detach().float().to(device)
                     for p, g in tree_leaves(grads)})
        return orig(self, state, grads, zero, split)

    optimizer.AdamW.apply = apply
    try:
        yield into
    finally:
        optimizer.AdamW.apply = orig


@contextlib.contextmanager
def counted_drops(into):
    """Add to ``into["drops"]`` the assignments each MoE layer's training
    route drops (``moe.slots``; a layer under remat counts twice)."""
    from repro_torch.models import moe
    orig = moe.slots

    def slots(ids, cfg, data=None):
        slot, kept, C = orig(ids, cfg, data)
        into["drops"] = into.get("drops", 0) + int((~kept).sum())
        return slot, kept, C

    moe.slots = slots
    try:
        yield into
    finally:
        moe.slots = orig


def card_step(rcfg, batch, mesh=None, split=None, seed=7):
    """One train step of ``rcfg`` from a fresh init of ``seed`` on the card,
    as one rank of ``mesh`` (its slices over ``model``) or, with ``mesh``
    None, alone on the whole model. Returns a dict: the metrics as floats;
    the updated params and the gradients ``AdamW.apply`` was given, fp32
    on the card, each cut to ``split``'s slices (``bridge.ModelSplit``)
    when alone with one given; each leaf's whole (largest |gradient|,
    largest |param|) when alone; the bytes the params and the moments
    took (``memory_allocated``)."""
    from repro_torch.bridge import init_params
    from repro_torch.models.lm import LM, tree_leaves
    from repro_torch.train.train_step import build_train_step
    cfg = rcfg.model
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(
        seed), "cuda", mesh=mesh, parallel=rcfg.parallel)
    held = torch.cuda.memory_allocated() - before
    lm = LM(cfg, params, device="cuda")
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    before = torch.cuda.memory_allocated()
    state = opt.init(lm.params, step_fn.zero)
    moment_bytes = torch.cuda.memory_allocated() - before
    grads = {}
    with captured_grads(grads, "cuda"):
        state, met = step_fn(state, batch)
    out = {"metrics": {k: float(v) for k, v in met.items()},
           "held": held, "moment_bytes": moment_bytes}
    params = {p: t.detach() for p, t in tree_leaves(lm.params)}
    del state, step_fn, lm
    if mesh is None:
        out["scales"] = {p: (grads[p].abs().max().item(),
                             t.abs().max().item()) for p, t in params.items()}
    cut = (lambda p, t: split.local(p, t).float().clone()) if (
        mesh is None and split is not None) else (lambda p, t: t.float())
    out["params"] = {p: cut(p, t) for p, t in params.items()}
    out["grads"] = {p: cut(p, g) for p, g in grads.items()}
    return out


def against_one(one, world, kind):
    """This rank's slices of the world's step against the same slices of
    one rank's: loss, grad norm, every gradient leaf and every updated
    param, as numbers (each bound scaled by the whole leaf's maximum)."""
    lw, lo = world["metrics"]["loss"], one["metrics"]["loss"]
    nw, no = world["metrics"]["grad_norm"], one["metrics"]["grad_norm"]
    g_abs, g_ratio, g_leaf, _ = grad_errors(
        world["grads"], one["grads"], kind,
        {p: s[0] for p, s in one["scales"].items()})
    p_ratio, p_leaf, widened = param_errors(
        world["params"], one["params"], one["grads"],
        one["metrics"]["lr"], kind, one["scales"])
    return {"loss": lw, "loss_one": lo, "loss_err": abs(lw - lo) / abs(lo),
            "norm": nw, "norm_one": no, "norm_err": abs(nw - no) / abs(no),
            "g_abs": g_abs, "g_ratio": g_ratio, "g_leaf": g_leaf,
            "p_ratio": p_ratio, "p_leaf": p_leaf, "widened": widened,
            "lr": one["metrics"]["lr"], "leaves": len(one["grads"])}


def step_times(rcfg, mesh=None, steps=DP_TIMED_STEPS, timed=()):
    """Seconds of each of ``steps`` bf16 steps from a fresh init after one
    warm-up step, as one rank of ``mesh`` (its slices over ``model``) or
    alone, and {name: the seconds each step spends in calls to
    ``module.name``} for each (module, name) of ``timed``, each call
    device-synced on both sides."""
    from repro_torch.bridge import init_params
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM
    from repro_torch.train import train_step as ts
    cfg = rcfg.model
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda", mesh=mesh, parallel=rcfg.parallel), device="cuda")
    step_fn, opt = ts.build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
    batches = synthetic_batches(rcfg, "cuda")
    spent = {name: [] for _, name in timed}
    orig = [getattr(module, name) for module, name in timed]

    def clocked(fn, name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spent[name][-1] += time.perf_counter() - t0
            return out
        return call

    for (module, name), fn in zip(timed, orig):
        setattr(module, name, clocked(fn, name))
    times = []
    try:
        for step in range(steps + 1):
            batch = batches(step)
            for name in spent:
                spent[name].append(0.0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, _ = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    finally:
        for (module, name), fn in zip(timed, orig):
            setattr(module, name, fn)
    return times[1:], {name: v[1:] for name, v in spent.items()}


def dp_resume(rcfg, work, mesh):
    """(e2) on one rank of the world: ``train_loop(mesh=)`` uninterrupted
    and with a preemption before step 6, then the world's loss at step
    DP_STEPS from the uninterrupted run's last checkpoint."""
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.train.loop import _start, train_loop
    ref = train_loop(rcfg, ckpt_dir=os.path.join(work, "ref"),
                     num_steps=DP_STEPS, ckpt_every=4, mesh=mesh)
    pre = train_loop(rcfg, ckpt_dir=os.path.join(work, "pre"),
                     num_steps=DP_STEPS, ckpt_every=4, fail_at={6: True},
                     mesh=mesh)
    state, start, step_fn = _start(rcfg, os.path.join(work, "ref"),
                                   mesh.device, mesh)
    _, met = step_fn(state, synthetic_batches(rcfg, mesh=mesh)(start))
    return {"ref": ref.losses, "pre": pre.losses, "restarts": pre.restarts,
            "next": float(met["loss"]), "start": start}


def _dp_rank(rank, mesh, work):
    """One rank of the dp phase (``launch.world.spawn_world``'s target):
    (e1) with its TF32 control, the timed steps, (e2) and (e3); every
    launch counter set to 0 just before and read just after. Rank 0 also
    takes (e1)'s and (e3)'s one-rank steps, alone on the card before the
    world's, and holds the world against them here: only numbers go
    back to the parent."""
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.train import optimizer
    from repro_torch.train import train_step as ts
    from repro_torch.parallel.fsdp import BatchCuts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    out = {"backend": dist.get_backend(), "device": str(mesh.device),
           "coords": mesh.coords}
    e1 = dp_e1_run()
    one = card_step(e1, dp_uneven_batch(e1)) if rank == 0 else None
    free_device_memory()
    world = card_step(e1, dp_uneven_batch(e1), mesh)
    zero = BatchCuts(e1.model, mesh)
    out["e1"] = {"metrics": world["metrics"],
                 "moment_bytes": world["moment_bytes"],
                 "counted": sum(2 * 2 * math.prod(zero.local(p, t).shape)
                                for p, t in world["params"].items())}
    if rank == 0:
        out["e1"].update(against_one(one, world, "dense"),
                         one_moment_bytes=one["moment_bytes"])
    del world
    free_device_memory()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tgrads = card_step(e1, dp_uneven_batch(e1), mesh)["grads"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    if rank == 0:
        out["tf32"] = grad_errors(tgrads, one["grads"], "dense")[:3]
    del tgrads, one
    free_device_memory()
    out["times"], spent = step_times(dp_e2_run(), mesh, timed=(
        (ts, "reduce_grads"), (optimizer, "all_gather")))
    out["reduce"], out["gather"] = spent["reduce_grads"], spent["all_gather"]
    free_device_memory()
    out["e2"] = dp_resume(dp_e2_run(), work, mesh)
    free_device_memory()
    e3 = dp_e3_run()
    drops = {}
    if rank == 0:
        with counted_drops(drops):
            one = card_step(e3, dp_uneven_batch(e3))
        out["e3_one_drops"] = drops.pop("drops", 0)
    with counted_drops(drops):
        world = card_step(e3, dp_uneven_batch(e3), mesh)
    out["e3"] = {"metrics": world["metrics"], "drops": drops.get("drops", 0)}
    if rank == 0:
        # jamba's 14 Mamba2 layers of 16 carry a changed sum order deeper
        # than (e1)'s 2 dense layers: TRAIN_ATOL["dp jamba"]
        out["e3"].update(against_one(one, world, "dp jamba"))
    out["launches"] = ops.launch_counts()
    return out


def dp_e1_run():
    return dp_run(musicgen_cut("float32"), 512, DP_WORLD)


def dp_e2_run():
    return dp_run(musicgen_cut("bfloat16"), 512, DP_WORLD,
                  learning_rate=3e-3, warmup_steps=2, total_steps=DP_STEPS)


def dp_e3_run():
    from repro_torch.configs import get_smoke_config
    jamba = dataclasses.replace(get_smoke_config("jamba-1.5-large-398b"),
                                dtype="float32",
                                capacity_factor=DP_CAPACITY_FACTOR)
    return dp_run(jamba, 64, DP_WORLD,
                  parallel=dict(attn_q_chunk=32, attn_kv_chunk=32))


def param_errors(world, one, grads, lr, kind, scales=None):
    """(worst err / bound, its leaf, entries whose bound was widened) of
    the world's updated params against one rank's. Each entry's bound is
    the gradient bound's form (TRAIN_RTOL x |p| + TRAIN_ATOL x max(1,
    leaf max)); where one rank's gradient lies within its own bound of 0
    its sign, and so the sign of AdamW's first update (at most lr in
    size), is not fixed by the gradient check, and the bound there is 2 x
    lr. A gradient of exactly 0 (an embedding row no token reads) is 0 on
    both sides and keeps the tight bound. ``scales``: {path: (the whole
    leaf's largest |gradient|, largest |param|)} where the maps hold
    slices of the leaves, else None."""
    worst, leaf, widened = 0.0, "", 0
    for path, ref in one.items():
        g = grads[path]
        gscale, pscale = (scales[path] if scales is not None else (
            g.abs().max().item(), ref.abs().max().item()))
        gbound = TRAIN_RTOL * g.abs() + TRAIN_ATOL[kind] * max(1.0, gscale)
        free = (g != 0) & (g.abs() <= gbound)
        bound = TRAIN_RTOL * ref.abs() + TRAIN_ATOL[kind] * max(1.0, pscale)
        bound = torch.where(free, torch.clamp(bound, min=2 * lr), bound)
        widened += int(free.sum())
        ratio = ((world[path] - ref).abs() / bound).max().item()
        if ratio > worst:
            worst, leaf = ratio, path
    return worst, leaf, widened


def zero_bytes_full_depth():
    """(whole, a rank's) bytes of musicgen-large's bf16 moments at full
    depth under ZeRO-1 at data 2, counted from ``meta_params`` on a
    shape-only mesh."""
    from repro_torch.bridge import meta_params
    from repro_torch.configs import get_config
    from repro_torch.models.lm import tree_leaves
    from repro_torch.parallel.fsdp import BatchCuts
    cfg = get_config(ARCH)
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           shape={"data": DP_WORLD, "model": 1},
                           coords={"data": 0, "model": 0})
    zero = BatchCuts(cfg, mesh)
    whole = rank = 0
    for path, t in tree_leaves(meta_params(cfg)):
        whole += 2 * 2 * t.numel()
        rank += 2 * 2 * math.prod(zero.local(path, t).shape)
    return whole, rank


def phase_dp(smi):
    """Data-parallel training (``train.train_step`` under a mesh) on a
    world of DP_WORLD gloo ranks on the card against one rank: (e1)-(e3)
    of the module docstring. Every launch counter is set to 0 just before
    and read just after, here and in every rank: the training route
    reaches no kernel."""
    import shutil
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.world import spawn_world
    from repro_torch.train.loop import _start
    check(not torch.backends.cuda.matmul.allow_tf32, "dp: TF32 is on")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    cfg = dp_e1_run().model
    phase("dp", "setup", f"{cfg.name}: {cfg.n_layers} of 48 layers, d_model "
          f"{cfg.d_model}, {cfg.param_count() / 1e6:.1f} M params; a world "
          f"of {DP_WORLD} ranks on the card (launch.world.spawn_world), "
          f"global batch {DP_WORLD} at seq 512, one row a rank")
    one_times = step_times(dp_e2_run())[0]
    free_device_memory()
    work = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    try:
        t1 = time.perf_counter()
        ranks = spawn_world(DP_WORLD, _dp_rank, work,
                            devices=["cuda:0"] * DP_WORLD)
        world_s = time.perf_counter() - t1
        r0 = ranks[0]
        for r in ranks:
            check(r["e1"]["metrics"] == r0["e1"]["metrics"],
                  f"dp e1: ranks' metrics differ: {r['e1']['metrics']} vs "
                  f"{r0['e1']['metrics']}")
        # (e1)
        e1 = r0["e1"]
        check(math.isfinite(e1["loss"]) and e1["loss_err"] <= TRAIN_LOSS_RTOL,
              f"dp e1: loss {DP_WORLD} ranks {e1['loss']!r} vs one "
              f"{e1['loss_one']!r}, rel err {e1['loss_err']:.3e} > "
              f"{TRAIN_LOSS_RTOL}")
        check(e1["g_ratio"] <= 1.0, f"dp e1: gradient {e1['g_leaf']} off by "
              f"{e1['g_ratio']:.2f} x its bound")
        check(e1["p_ratio"] <= 1.0, f"dp e1: updated param {e1['p_leaf']} "
              f"off by {e1['p_ratio']:.2f} x its bound")
        mw = [r["e1"]["moment_bytes"] for r in ranks]
        phase("dp", "e1", f"fp32, the ranks' rows hold {512 // 4} and 512 "
              f"tokens of the mask: loss {DP_WORLD} ranks {e1['loss']:.6f} vs "
              f"one {e1['loss_one']:.6f} (rel err {e1['loss_err']:.3e}, tol "
              f"{TRAIN_LOSS_RTOL}); {e1['leaves']} gradient leaves: worst abs "
              f"err {e1['g_abs']:.3e}, worst err / bound {e1['g_ratio']:.3f} "
              f"({e1['g_leaf']}); updated params: worst err / bound "
              f"{e1['p_ratio']:.3f} ({e1['p_leaf']}; {e1['widened']} entries "
              f"whose one-rank gradient lies within its bound held to 2 x lr "
              f"= {2 * e1['lr']:.3e}); ZeRO-1 moments a rank {mw} B measured "
              f"(memory_allocated), {e1['counted']} B counted, whole "
              f"{e1['one_moment_bytes']} B on one rank; {smi}")
        t_abs, t_ratio, t_leaf = r0["tf32"]
        phase("dp", "e1", f"control, TF32 products in the world: worst abs "
              f"err {t_abs:.3e}, worst err / bound {t_ratio:.3f} ({t_leaf}),"
              f" must exceed {TF32_CONTROL_MIN}")
        check(t_ratio > TF32_CONTROL_MIN, f"dp e1: with TF32 on, the world's "
              f"gradients land at {t_ratio:.3f} of the bound: the bound "
              "cannot tell TF32 from fp32")
        for r in ranks:
            med = statistics.median(r["times"])
            red = statistics.median(r["reduce"])
            gat = statistics.median(r["gather"])
            phase("dp", "time", f"rank {r['coords']} ({r['backend']}, "
                  f"{r['device']}): bf16 step median {med:.4f} s (of "
                  f"{', '.join(f'{x:.4f}' for x in r['times'])}), gradient "
                  f"reduction median {red:.4f} s = {red / med:.1%} of the "
                  f"step, ZeRO-1 all-gathers median {gat:.4f} s = "
                  f"{gat / med:.1%}; one rank at the same global batch "
                  f"{statistics.median(one_times):.4f} s (of "
                  f"{', '.join(f'{x:.4f}' for x in one_times)}); {smi}")
        whole, per_rank = zero_bytes_full_depth()
        phase("dp", "zero", f"musicgen-large at full depth: bf16 m and v "
              f"{whole / 1e9:.3f} GB whole, {per_rank / 1e9:.3f} GB a rank "
              f"under ZeRO-1 at data {DP_WORLD} (counted from meta_params)")
        # (e2)
        e2 = r0["e2"]
        for r in ranks:
            check(r["e2"] == e2, "dp e2: the ranks' losses differ")
        check(e2["restarts"] == 1 and len(e2["pre"]) == DP_STEPS + 2,
              f"dp e2: {e2['restarts']} restarts, {len(e2['pre'])} losses")
        check(e2["pre"][:6] == e2["ref"][:6]
              and e2["pre"][6:] == e2["ref"][4:],
              f"dp e2: losses differ from the uninterrupted world's: "
              f"{e2['pre']} vs {e2['ref']}")
        e2r = dp_e2_run()
        state, start, step_fn = _start(e2r, os.path.join(work, "ref"), "cuda")
        _, met = step_fn(state, synthetic_batches(e2r, "cuda")(start))
        one_next = float(met["loss"])
        del state, step_fn
        next_err = abs(one_next - e2["next"]) / abs(e2["next"])
        check(start == e2["start"] == DP_STEPS and next_err <= DP_NEXT_RTOL,
              f"dp e2: step {start}'s loss on one rank from the world's "
              f"checkpoint {one_next!r} vs the world's {e2['next']!r}, rel "
              f"err {next_err:.3e} > {DP_NEXT_RTOL}")
        phase("dp", "e2", f"bf16 train_loop(mesh=): {DP_STEPS} steps with "
              f"checkpoints every 4; with a preemption before step 6, "
              f"{e2['restarts']} restart and {len(e2['pre'])} losses equal to "
              f"the uninterrupted world's bit for bit; step {start} from its "
              f"last checkpoint on one rank {one_next:.6f} vs the world "
              f"{e2['next']:.6f} (rel err {next_err:.3e}, tol {DP_NEXT_RTOL});"
              f" losses " + ", ".join(f"{x:.4f}" for x in e2["ref"])
              + f"; {smi}")
        # (e3)
        e3 = r0["e3"]
        one_drops = r0["e3_one_drops"]
        world_drops = sum(r["e3"]["drops"] for r in ranks)
        check(one_drops > 0, f"dp e3: capacity factor {DP_CAPACITY_FACTOR} "
              "drops no assignment")
        check(e3["loss_err"] <= TRAIN_LOSS_RTOL, f"dp e3: loss "
              f"{e3['loss']!r} vs one {e3['loss_one']!r}, rel err "
              f"{e3['loss_err']:.3e}")
        check(e3["g_ratio"] <= 1.0, f"dp e3: gradient {e3['g_leaf']} off by "
              f"{e3['g_ratio']:.2f} x its bound")
        phase("dp", "e3", f"{dp_e3_run().model.name}, fp32, capacity factor "
              f"{DP_CAPACITY_FACTOR}: {one_drops} assignments dropped on one "
              f"rank, {world_drops} over the world's ranks; loss "
              f"{e3['loss']:.6f} vs {e3['loss_one']:.6f} (rel err "
              f"{e3['loss_err']:.3e}); {e3['leaves']} gradient leaves, worst "
              f"abs err {e3['g_abs']:.3e}, worst err / bound "
              f"{e3['g_ratio']:.3f} ({e3['g_leaf']}; rtol {TRAIN_RTOL}, atol "
              f"{TRAIN_ATOL['dp jamba']} x max(1, leaf max))")
        check(world_drops == one_drops, f"dp e3: the world dropped "
              f"{world_drops} assignments, one rank {one_drops}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = ops.launch_counts()
    for r in ranks:
        check(not any(r["launches"].values()), f"dp: rank {r['coords']} "
              f"launched kernels {r['launches']}")
    check(not any(counts.values()), f"dp: kernel launches {counts}: the "
          "training route must reach no kernel")
    phase("dp", "done", f"launches {counts} here and "
          f"{[r['launches'] for r in ranks]} in the ranks; world {world_s:.1f}"
          f" s; phase {time.perf_counter() - t0:.1f} s; {smi}")
    return [statistics.median(r["times"]) for r in ranks]

# -------------------------------------------------------------- tp-train
def qwen3_cut(dtype):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("qwen3-14b"),
                               n_layers=TP_TRAIN_LAYERS, dtype=dtype)


def tpt_f1_run():
    return dp_run(qwen3_cut("float32"), 512, TP_TRAIN_WORLD)


def tpt_f2_run():
    return dp_run(qwen3_cut("bfloat16"), 512, TP_TRAIN_WORLD,
                  learning_rate=3e-3, warmup_steps=2,
                  total_steps=TP_TRAIN_STEPS)


def whole_leaves_equal(grads, split, group):
    """Whether every gradient of a leaf the ``model`` ranks hold whole is
    equal bit for bit on every rank (all-gathered: they are the norms'
    and a few more, small), and how many such leaves there are."""
    from repro_torch.parallel.collectives import all_gather
    whole = [p for p in sorted(grads) if p not in split.split]
    n = torch.distributed.get_world_size(group)
    for p in whole:
        parts = all_gather(grads[p][None], 0, group)
        if not all(torch.equal(parts[0], parts[i]) for i in range(1, n)):
            return False, len(whole), p
    return True, len(whole), ""


def tpt_resume(rcfg, work, mesh, steps, every, preempt):
    """(f2) or (g3) on one rank of the world: ``train_loop(mesh=)`` for
    ``steps`` steps with checkpoints every ``every`` and a preemption
    before step ``preempt``, whose restart replays the steps from the
    last checkpoint before it (from the start without one); then the
    world's loss at step ``steps`` from the run's last checkpoint."""
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.train.loop import _start, train_loop
    t0 = time.perf_counter()
    pre = train_loop(rcfg, ckpt_dir=os.path.join(work, "pre"),
                     num_steps=steps, ckpt_every=every,
                     fail_at={preempt: True}, mesh=mesh)
    loop_s = time.perf_counter() - t0
    state, start, step_fn = _start(rcfg, os.path.join(work, "pre"),
                                   mesh.device, mesh)
    _, met = step_fn(state, synthetic_batches(rcfg, mesh=mesh)(start))
    return {"pre": pre.losses, "restarts": pre.restarts,
            "next": float(met["loss"]), "start": start, "loop_s": loop_s}


def _tpt_rank(rank, mesh, work):
    """One rank of the tp-train phase (``launch.world.spawn_world``'s
    target at (model TP_TRAIN_WORLD)): (f1) with its TF32 control, the
    timed steps, (f2) and (f3); every launch counter set to 0 just before
    and read just after. Each rank takes (f1)'s one-rank step in turn,
    alone on the card, and keeps its slices of it; rank 0 takes (f3)'s.
    Only numbers go back to the parent."""
    import torch.distributed as dist
    from repro_torch.bridge import ModelSplit, meta_params
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.models.lm import tree_leaves
    from repro_torch.parallel import collectives
    from repro_torch.parallel.check import bytes_held
    from repro_torch.parallel.collectives import all_reduce
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.reset_launch_counts()
    group = mesh.group("model")
    out = {"backend": dist.get_backend(), "device": str(mesh.device),
           "coords": mesh.coords}
    # (f1)
    f1 = tpt_f1_run()
    split = ModelSplit(f1.model, mesh, f1.parallel)
    batch = synthetic_batches(f1, "cuda")(0)
    one = None
    for r in range(TP_TRAIN_WORLD):        # one rank at a time on the card
        if r == rank:
            one = card_step(f1, batch, split=split)
            free_device_memory()
        dist.barrier()
    world = card_step(f1, batch, mesh)
    torch.cuda.synchronize()
    out["f1"] = against_one(one, world, "dense")
    out["f1"].update(
        held=world["held"], counted=bytes_held(meta_params(
            f1.model, mesh=mesh, parallel=f1.parallel)),
        whole=bytes_held(meta_params(f1.model)), one_held=one["held"],
        metrics=world["metrics"], split=len(split.split))
    same, n_whole, bad = whole_leaves_equal(world["grads"], split, group)
    out["f1"].update(whole_equal=same, n_whole=n_whole, unequal=bad)
    del world
    free_device_memory()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tgrads = card_step(f1, batch, mesh)["grads"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratio = grad_errors(tgrads, one["grads"], "dense",
                        {p: s[0] for p, s in one["scales"].items()})[1]
    # the control's worst over the ranks
    out["tf32"] = float(all_reduce(torch.tensor(ratio), group,
                                   dist.ReduceOp.MAX))
    del tgrads, one
    free_device_memory()
    # (f2)
    out["times"], spent = step_times(tpt_f2_run(), mesh, TP_TIMED_STEPS, (
        (collectives, "all_reduce"), (collectives, "all_gather")))
    out["coll"] = [a + b for a, b in zip(spent["all_reduce"],
                                         spent["all_gather"])]
    free_device_memory()
    out["f2"] = tpt_resume(tpt_f2_run(), work, mesh, TP_TRAIN_STEPS,
                           TP_TRAIN_STEPS, TP_PREEMPT)
    free_device_memory()
    # (f3): the dp phase's (e3) run, jamba smoke at capacity factor 0.5
    f3 = dp_e3_run()
    fsplit = ModelSplit(f3.model, mesh, f3.parallel)
    batch = synthetic_batches(f3, "cuda")(0)
    drops = {}
    one = None
    if rank == 0:
        with counted_drops(drops):
            one = card_step(f3, batch)
        out["f3_one_drops"] = drops.pop("drops", 0)
    with counted_drops(drops):
        world = card_step(f3, batch, mesh)
    grads = dict(tree_leaves(fsplit.gather_tree(world["grads"])))
    params = dict(tree_leaves(fsplit.gather_tree(world["params"])))
    out["f3"] = {"drops": drops.get("drops", 0), "metrics": world["metrics"],
                 "split": len(fsplit.split)}
    if rank == 0:
        out["f3"].update(against_one(
            one, dict(world, grads=grads, params=params), "deep ssm"))
    out["launches"] = ops.launch_counts()
    return out


def phase_tp_train(smi):
    """Training under the ``model`` axis (``train.train_step`` on a
    (model TP_TRAIN_WORLD) mesh) on a world of gloo ranks on the card
    against one rank: (f1)-(f3) of the module docstring. Every launch
    counter is set to 0 just before and read just after, here and in
    every rank: the training route reaches no kernel."""
    import shutil
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.world import spawn_world
    from repro_torch.train.loop import _start
    check(not torch.backends.cuda.matmul.allow_tf32, "tp-train: TF32 is on")
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    f1r = tpt_f1_run()
    cfg = f1r.model
    phase("tp-train", "setup", f"{cfg.name}: {cfg.n_layers} of 40 layers, "
          f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_count() / 1e9:.3f} B params; a world of "
          f"{TP_TRAIN_WORLD} ranks on the card at (model {TP_TRAIN_WORLD}) "
          f"(launch.world.spawn_world), seq {f1r.shape.seq_len}, global "
          f"batch {f1r.shape.global_batch}, every row on every rank")
    one_times = step_times(tpt_f2_run(), steps=TP_TIMED_STEPS)[0]
    free_device_memory()
    work = tempfile.mkdtemp(prefix="chip_smoke_tpt_")
    try:
        t1 = time.perf_counter()
        ranks = spawn_world(TP_TRAIN_WORLD, _tpt_rank, work,
                            devices=["cuda:0"] * TP_TRAIN_WORLD,
                            model=TP_TRAIN_WORLD)
        world_s = time.perf_counter() - t1
        r0 = ranks[0]
        # (f1): the readings first, so a failing run shows them all
        f1s = [r["f1"] for r in ranks]
        worst = max(f1s, key=lambda f: f["g_ratio"])
        pworst = max(f1s, key=lambda f: f["p_ratio"])
        f1 = r0["f1"]
        phase("tp-train", "f1", f"fp32: loss {TP_TRAIN_WORLD} ranks "
              f"{f1['loss']:.6f} vs one {f1['loss_one']:.6f} (rel err "
              f"{f1['loss_err']:.3e}, tol {TRAIN_LOSS_RTOL}); grad norm "
              f"{f1['norm']:.6f} vs {f1['norm_one']:.6f} (rel err "
              f"{f1['norm_err']:.3e}, tol {TRAIN_RTOL}: the leaves' bound); "
              f"{f1['leaves']} gradient leaves, "
              f"{f1['split']} split: worst abs err "
              f"{max(f['g_abs'] for f in f1s):.3e}, worst err / bound "
              f"{worst['g_ratio']:.3f} ({worst['g_leaf']}; rtol {TRAIN_RTOL}"
              f", atol {TRAIN_ATOL['dense']} x max(1, leaf max)); updated "
              f"params: worst err / bound {pworst['p_ratio']:.3f} "
              f"({pworst['p_leaf']}; "
              f"{sum(f['widened'] for f in f1s)} entries held to 2 x lr); "
              f"the {f1['n_whole']} leaves every rank holds whole: "
              + ("gradients equal bit for bit on the ranks" if all(
                  f["whole_equal"] for f in f1s) else "gradients differ on "
                 "the ranks (" + ", ".join(f["unequal"] for f in f1s) + ")")
              + f"; {smi}")
        for r in ranks:
            f1 = r["f1"]
            check(f1["metrics"] == r0["f1"]["metrics"],
                  f"tp-train f1: ranks' metrics differ: {f1['metrics']} vs "
                  f"{r0['f1']['metrics']}")
            check(math.isfinite(f1["loss"])
                  and f1["loss_err"] <= TRAIN_LOSS_RTOL,
                  f"tp-train f1: loss {f1['loss']!r} vs one "
                  f"{f1['loss_one']!r}, rel err {f1['loss_err']:.3e} > "
                  f"{TRAIN_LOSS_RTOL}")
            check(f1["norm_err"] <= TRAIN_RTOL, f"tp-train f1: grad norm "
                  f"{f1['norm']!r} vs one {f1['norm_one']!r}, rel err "
                  f"{f1['norm_err']:.3e} > {TRAIN_RTOL}")
            check(f1["g_ratio"] <= 1.0, f"tp-train f1: rank {r['coords']}: "
                  f"gradient {f1['g_leaf']} off by {f1['g_ratio']:.2f} x its "
                  "bound")
            check(f1["p_ratio"] <= 1.0, f"tp-train f1: rank {r['coords']}: "
                  f"updated param {f1['p_leaf']} off by {f1['p_ratio']:.2f} "
                  "x its bound")
            check(f1["whole_equal"], f"tp-train f1: the gradient of "
                  f"{f1['unequal']}, held whole by every rank, differs "
                  "between the ranks")
        phase("tp-train", "f1", "bytes a rank: params "
              + ", ".join(f"{r['f1']['held']}" for r in ranks)
              + f" B measured (memory_allocated), {f1['counted']} B counted "
              f"(meta_params), whole {f1['whole']} B counted, "
              f"{f1['one_held']} B measured on one rank "
              f"({f1['counted'] / f1['whole']:.4f} of the whole)")
        check(all(abs(r["f1"]["held"] - f1["counted"])
                  <= 0.01 * f1["counted"] for r in ranks),
              f"tp-train f1: a rank's params take "
              f"{[r['f1']['held'] for r in ranks]} B, counted "
              f"{f1['counted']} B")
        phase("tp-train", "f1", f"control, TF32 products in the world: "
              f"worst err / bound {r0['tf32']:.3f}, must exceed "
              f"{TF32_CONTROL_MIN}")
        check(r0["tf32"] > TF32_CONTROL_MIN, f"tp-train f1: with TF32 on, "
              f"the world's gradients land at {r0['tf32']:.3f} of the "
              "bound: the bound cannot tell TF32 from fp32")
        for r in ranks:
            med = statistics.median(r["times"])
            col = statistics.median(r["coll"])
            phase("tp-train", "time", f"rank {r['coords']} ({r['backend']}, "
                  f"{r['device']}): bf16 step median {med:.4f} s (of "
                  f"{', '.join(f'{x:.4f}' for x in r['times'])}), model "
                  f"collectives median {col:.4f} s = {col / med:.1%} of the "
                  f"step; one rank at the same batch "
                  f"{statistics.median(one_times):.4f} s (of "
                  f"{', '.join(f'{x:.4f}' for x in one_times)}); {smi}")
        # (f2)
        f2 = r0["f2"]
        for r in ranks:
            check(r["f2"]["pre"] == f2["pre"] and r["f2"]["next"]
                  == f2["next"], "tp-train f2: the ranks' losses differ")
        pre = f2["pre"]
        P = TP_PREEMPT
        check(f2["restarts"] == 1 and len(pre) == TP_TRAIN_STEPS + P,
              f"tp-train f2: {f2['restarts']} restarts, {len(pre)} losses")
        check(pre[P:2 * P] == pre[:P], f"tp-train f2: the steps replayed "
              f"after the preemption give {pre[P:2 * P]}, first {pre[:P]}")
        f2r = tpt_f2_run()
        state, start, step_fn = _start(f2r, os.path.join(work, "pre"),
                                       "cuda")
        _, met = step_fn(state, synthetic_batches(f2r, "cuda")(start))
        one_next = float(met["loss"])
        del state, step_fn
        free_device_memory()
        next_err = abs(one_next - f2["next"]) / abs(f2["next"])
        check(start == f2["start"] == TP_TRAIN_STEPS
              and next_err <= DP_NEXT_RTOL,
              f"tp-train f2: step {start}'s loss on one rank from the "
              f"world's checkpoint {one_next!r} vs the world's "
              f"{f2['next']!r}, rel err {next_err:.3e} > {DP_NEXT_RTOL}")
        phase("tp-train", "f2", f"bf16 train_loop(mesh=): {TP_TRAIN_STEPS} "
              f"steps with one checkpoint, at the end, and a preemption "
              f"before step {P}: {f2['restarts']} restart, steps 0-{P - 1} "
              f"replayed bit for bit ({len(pre)} losses); step {start} "
              f"from the checkpoint "
              f"on one rank {one_next:.6f} vs the world {f2['next']:.6f} "
              f"(rel err {next_err:.3e}, tol {DP_NEXT_RTOL}); losses "
              + ", ".join(f"{x:.4f}" for x in pre)
              + f"; the loop {f2['loop_s']:.1f} s; {smi}")
        # (f3)
        f3 = r0["f3"]
        check(r0["f3_one_drops"] > 0, "tp-train f3: capacity factor "
              f"{DP_CAPACITY_FACTOR} drops no assignment")
        check(all(r["f3"]["drops"] == r0["f3_one_drops"] for r in ranks),
              f"tp-train f3: the ranks dropped "
              f"{[r['f3']['drops'] for r in ranks]} assignments, one rank "
              f"{r0['f3_one_drops']}: at data 1 each rank fills every row")
        check(f3["loss_err"] <= TRAIN_LOSS_RTOL, f"tp-train f3: loss "
              f"{f3['loss']!r} vs one {f3['loss_one']!r}, rel err "
              f"{f3['loss_err']:.3e}")
        check(f3["norm_err"] <= TRAIN_RTOL, f"tp-train f3: grad norm "
              f"{f3['norm']!r} vs {f3['norm_one']!r}, rel err "
              f"{f3['norm_err']:.3e} > {TRAIN_RTOL}")
        check(f3["g_ratio"] <= 1.0, f"tp-train f3: gradient {f3['g_leaf']} "
              f"off by {f3['g_ratio']:.2f} x its bound")
        check(f3["p_ratio"] <= 1.0, f"tp-train f3: param {f3['p_leaf']} off "
              f"by {f3['p_ratio']:.2f} x its bound")
        phase("tp-train", "f3", f"{dp_e3_run().model.name}, fp32, capacity "
              f"factor {DP_CAPACITY_FACTOR}, {f3['split']} leaves split "
              f"(attention, Mamba2 heads, experts): {r0['f3_one_drops']} "
              f"assignments dropped on one rank, "
              f"{[r['f3']['drops'] for r in ranks]} on the world's ranks "
              f"(each fills every row); loss "
              f"{f3['loss']:.6f} vs {f3['loss_one']:.6f} (rel err "
              f"{f3['loss_err']:.3e}), grad norm rel err "
              f"{f3['norm_err']:.3e}; {f3['leaves']} gradient leaves, worst "
              f"abs err {f3['g_abs']:.3e}, worst err / bound "
              f"{f3['g_ratio']:.3f} ({f3['g_leaf']}; atol "
              f"{TRAIN_ATOL['deep ssm']} x max(1, leaf max)); params "
              f"{f3['p_ratio']:.3f} ({f3['p_leaf']})")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    counts = ops.launch_counts()
    for r in ranks:
        check(not any(r["launches"].values()), f"tp-train: rank "
              f"{r['coords']} launched kernels {r['launches']}")
    check(not any(counts.values()), f"tp-train: kernel launches {counts}: "
          "the training route must reach no kernel")
    phase("tp-train", "done", f"launches {counts} here and "
          f"{[r['launches'] for r in ranks]} in the ranks; world "
          f"{world_s:.1f} s; phase {time.perf_counter() - t0:.1f} s; {smi}")


# ------------------------------------------------------------------ fsdp
class Stored:
    """The slices of a model's leaves that this rank of ``mesh`` stores
    under ``parallel`` (``bridge.storage_cuts``): ``local`` cuts a whole
    leaf to it, ``split`` names the leaves some rank cuts."""

    def __init__(self, cfg, mesh, parallel):
        from repro_torch.bridge import meta_params, storage_cuts
        from repro_torch.models.lm import tree_leaves
        self.cuts = storage_cuts(cfg, mesh, parallel)
        self.split = {p for p, t in tree_leaves(meta_params(cfg))
                      if self.cuts(p, t.shape)}

    def local(self, path, t):
        for dim, lo, hi in self.cuts(path, t.shape):
            t = t.narrow(dim, lo, hi - lo)
        return t


def fsdp_serve_cfg():
    return qwen3_cut("bfloat16")


def fsdp_requests(cfg):
    from repro_torch.serve.engine import Request
    reqs = make_requests(cfg, Request)[:FSDP_REQUESTS]
    for r in reqs:
        r.max_new_tokens = FSDP_NEW_TOKENS
    return reqs


@contextlib.contextmanager
def gathers_timed(into):
    """Seconds of each FSDP gather (``BatchCuts.gather``), device-synced on
    both sides, added to ``into[("table" or "layer", what)]`` where
    ``what`` is ``into["now"]``, the engine call under way."""
    from repro_torch.parallel.fsdp import BatchCuts
    orig = BatchCuts.gather

    def gather(self, path, t, lead=0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(self, path, t, lead)
        torch.cuda.synchronize()
        key = ("table" if path in ("embed", "head") else "layer",
               into.get("now"))
        into[key] = into.get(key, 0.0) + time.perf_counter() - t0
        return out

    BatchCuts.gather = gather
    try:
        yield into
    finally:
        BatchCuts.gather = orig


def fsdp_serve(lm, rt=None):
    """(g1) on this rank (``rt`` an "fsdp_tp" runtime) or alone: the
    requests contiguous, with the first decode step recorded, then paged;
    per mode the tokens, launches (set to 0 just before, read just after
    each run, held to ``expected_launches``), prefill ms a group, decode
    ms a step, and under ``rt`` the gathers' seconds in each."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.serve.engine import Engine
    out = {}
    for mode in ("contiguous", "paged"):
        ps = DECODE_BLOCK_S if mode == "paged" else None
        eng = Engine(lm, rt=rt, max_batch=MAX_BATCH, max_len=MAX_LEN,
                     page_size=ps, device="cuda")
        pre_s, step_s, spent = [], [], {}

        def marked(fn, what, into):
            timed = _timed(fn, into)

            def call(*a, **kw):
                spent["now"] = what
                try:
                    return timed(*a, **kw)
                finally:
                    spent["now"] = None
            return call

        eng._prefill_group = marked(eng._prefill_group, "prefill", pre_s)
        eng.step = marked(eng.step, "decode", step_s)
        reqs = fsdp_requests(lm.cfg)
        with (first_decode_recorded(lm) if ps is None
              else contextlib.nullcontext([])) as first, (
                gathers_timed(spent) if rt is not None
                else contextlib.nullcontext(spent)):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            done = eng.run(reqs)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        want = expected_launches(lm.cfg, eng, ps is not None)
        check(counts == want, f"fsdp g1 {mode}: launches {counts} != "
              f"expected {want}")
        if eng.pager is not None:
            check(eng.pager.used_pages == 0, "fsdp g1 paged: pages not freed")
            eng.pager.check_conservation()
        out[mode] = {
            "served": [(r.rid, np.asarray(r.out_tokens).tolist())
                       for r in done],
            "counts": counts, "prefill_ms": [1e3 * x for x in pre_s],
            "decode_ms": [1e3 * x for x in step_s],
            "gathers": {f"{k[0]} {k[1]}": v for k, v in spent.items()
                        if isinstance(k, tuple)},
            "first": first[0] if first else None}
        del eng
    return out


def _fsdp_rank(rank, mesh, work):
    """One rank of the fsdp phase (``launch.world.spawn_world``'s target
    at (data FSDP_WORLD)): (g1)-(g4) of the module docstring, every launch
    counter set to 0 just before and read just after each part. Each rank
    takes (g2)'s and (g4)'s one-rank steps itself (small cuts) and keeps
    its stored slices of them. Only numbers and (g1)'s records go back."""
    import torch.distributed as dist
    from repro_torch.bridge import init_params, meta_params
    from repro_torch.configs.base import ParallelConfig
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.models.lm import LM, Runtime
    from repro_torch.parallel import collectives
    from repro_torch.parallel.check import bytes_held
    from repro_torch.parallel.collectives import all_reduce
    from repro_torch.train import train_step as ts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group = mesh.group("data")
    out = {"backend": dist.get_backend(), "device": str(mesh.device),
           "coords": mesh.coords}
    # (g1)
    cfg = fsdp_serve_cfg()
    parallel = ParallelConfig(strategy="fsdp_tp")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda", mesh=mesh, parallel=parallel), device="cuda")
    torch.cuda.synchronize()
    out["g1_held"] = torch.cuda.memory_allocated() - before
    out["g1_counted"] = bytes_held(meta_params(cfg, mesh=mesh,
                                               parallel=parallel))
    out["g1"] = fsdp_serve(lm, Runtime(parallel, mesh))
    out["g1_peak"] = torch.cuda.max_memory_allocated()
    del lm
    free_device_memory()
    ops.reset_launch_counts()
    # (g2)
    g2 = fsdp_g2_run()
    stored = Stored(g2.model, mesh, g2.parallel)
    batch = dp_uneven_batch(g2)
    one = card_step(g2, batch, split=stored)
    free_device_memory()
    world = card_step(g2, batch, mesh)
    out["g2"] = against_one(one, world, "dense")
    same, n_whole, bad = whole_leaves_equal(world["grads"], stored, group)
    out["g2"].update(
        held=world["held"], counted=bytes_held(meta_params(
            g2.model, mesh=mesh, parallel=g2.parallel)),
        whole=bytes_held(meta_params(g2.model)), one_held=one["held"],
        moment_bytes=world["moment_bytes"], metrics=world["metrics"],
        split=len(stored.split), whole_equal=same, n_whole=n_whole,
        unequal=bad)
    del world
    free_device_memory()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tgrads = card_step(g2, batch, mesh)["grads"]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ratio = grad_errors(tgrads, one["grads"], "dense",
                        {p: s[0] for p, s in one["scales"].items()})[1]
    out["tf32"] = float(all_reduce(torch.tensor(ratio), group,
                                   dist.ReduceOp.MAX))
    del tgrads, one
    free_device_memory()
    # (g3): the step timed, to set beside the dp phase's tp + ZeRO-1 step
    # on the same cut
    timed = ((collectives, "all_gather"), (collectives, "all_reduce"),
             (ts, "reduce_grads"))
    out["times"], out["spent"] = step_times(fsdp_g3_run(), mesh,
                                            timed=timed)
    free_device_memory()
    out["g3"] = tpt_resume(fsdp_g3_run(), work, mesh, DP_STEPS, 4, 6)
    free_device_memory()
    # (g4)
    g4 = fsdp_g4_run()
    stored = Stored(g4.model, mesh, g4.parallel)
    batch = synthetic_batches(g4, "cuda")(0)
    drops = {}
    with counted_drops(drops):
        one = card_step(g4, batch, split=stored)
    out["g4_one_drops"] = drops.pop("drops", 0)
    with counted_drops(drops):
        world = card_step(g4, batch, mesh)
    out["g4"] = against_one(one, world, "dp jamba")
    out["g4"].update(drops=drops.get("drops", 0), split=len(stored.split))
    del world, one
    out["launches"] = ops.launch_counts()
    return out


def fsdp_g2_run():
    return dp_run(musicgen_cut("float32"), 512, FSDP_WORLD,
                  parallel={"strategy": "fsdp_tp"})


def fsdp_g3_run():
    return dp_run(musicgen_cut("bfloat16"), 512, FSDP_WORLD,
                  learning_rate=3e-3, warmup_steps=2, total_steps=DP_STEPS,
                  parallel={"strategy": "fsdp_tp"})


def fsdp_g4_run():
    r = dp_e3_run()
    return dataclasses.replace(r, parallel=dataclasses.replace(
        r.parallel, strategy="fsdp_tp"))


def own_rows(want, got, index):
    """The rows of one rank's tensor ``want`` that batch rank ``index``
    holds, where its ``got`` holds fewer (the batch split over the batch
    axes: ``index``'s block); ``want`` itself where they hold as many."""
    per = got.shape[0]
    return want if per == want.shape[0] else want[index * per:
                                                 (index + 1) * per]


def first_against_one(got, want, index):
    """{what: (a rank's tensor, one rank's at its rows)} of two
    ``first_decode_recorded`` records: each prefill call of the first
    admit window, and the first decode step's fed tokens, lengths,
    embedding, logits and layer-0 K/V."""
    pairs = {}
    check(len(got["prefills"]) == len(want["prefills"]),
          f"{len(got['prefills'])} prefill calls before the first decode "
          f"step, one rank {len(want['prefills'])}")
    for j, (g, w) in enumerate(zip(got["prefills"], want["prefills"])):
        pairs[f"prefill {j}"] = (g, own_rows(w, g, index))
    for key in ("tokens", "lengths", "emb", "logits", "k0", "v0"):
        if want[key] is not None:
            pairs[key] = (got[key], own_rows(want[key], got[key], index))
    return pairs


def check_fsdp_serve(one, ranks, smi):
    """(g1): every rank's tokens, finish order, prefill logits, first
    decode step's embedding, logits and layer-0 K/V on its rows equal one
    rank's bit for bit, contiguous and paged."""
    for r in ranks:
        for mode in ("contiguous", "paged"):
            check(r["g1"][mode]["served"] == one[mode]["served"],
                  f"fsdp g1 {mode}: rank {r['coords']} served other tokens "
                  "or another finish order than one rank")
        pairs = first_against_one(r["g1"]["contiguous"]["first"],
                                  one["contiguous"]["first"],
                                  r["coords"]["data"])
        for key, (got, want) in pairs.items():
            check(torch.equal(got, want), f"fsdp g1: rank "
                  f"{r['coords']}'s first decode step differs from one "
                  f"rank's ({key}: {max_err(got, want, 1e9):.3e})")
    check(one["contiguous"]["served"] == one["paged"]["served"],
          "fsdp g1: one rank's tokens differ contiguous and paged")


def phase_fsdp(smi, dp_steps=None):
    """FSDP parameter storage (``strategy="fsdp_tp"``) on a world of
    FSDP_WORLD gloo ranks on the card at (data FSDP_WORLD), against one
    rank: (g1)-(g4) of the module docstring. ``dp_steps``: the dp phase's
    ranks' median bf16 step seconds on the same cut (``phase_dp``), set
    beside (g3)'s. Returns (g1)'s launch counts, summed over the ranks
    and modes."""
    import shutil
    from repro_torch.bridge import init_params, meta_params
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.kernels import ops
    from repro_torch.launch.world import spawn_world
    from repro_torch.models.lm import LM
    from repro_torch.parallel.check import bytes_held
    from repro_torch.train.loop import _start
    check(not torch.backends.cuda.matmul.allow_tf32, "fsdp: TF32 is on")
    t0 = time.perf_counter()
    cfg = fsdp_serve_cfg()
    phase("fsdp", "setup", f"{cfg.name}: {cfg.n_layers} of 40 layers, "
          f"{cfg.param_count() / 1e9:.3f} B params, bf16; a world of "
          f"{FSDP_WORLD} ranks on the card at (data {FSDP_WORLD}) under "
          f"strategy fsdp_tp (launch.world.spawn_world); {FSDP_REQUESTS} of "
          f"phase 4's requests, {FSDP_NEW_TOKENS} new tokens each")
    torch.cuda.reset_peak_memory_stats()
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    one = fsdp_serve(lm)
    one_peak = torch.cuda.max_memory_allocated()
    whole = bytes_held(meta_params(cfg))
    del lm
    free_device_memory()
    work = tempfile.mkdtemp(prefix="chip_smoke_fsdp_")
    try:
        t1 = time.perf_counter()
        ranks = spawn_world(FSDP_WORLD, _fsdp_rank, work,
                            devices=["cuda:0"] * FSDP_WORLD)
        world_s = time.perf_counter() - t1
        r0 = ranks[0]
        # (g1)
        served = {}
        for r in ranks:
            for mode in ("contiguous", "paged"):
                y, o = r["g1"][mode], one[mode]
                for k, v in y["counts"].items():
                    served[k] = served.get(k, 0) + v
                dec = sum(y["decode_ms"]) / 1e3
                pre = sum(y["prefill_ms"]) / 1e3
                g = {k: y["gathers"].get(k, 0.0) for k in (
                    "table decode", "layer decode", "table prefill",
                    "layer prefill")}
                share = (g["table decode"] + g["layer decode"]) / dec
                phase("fsdp", "g1", f"rank {r['coords']} ({r['backend']}, "
                      f"{r['device']}) {mode}: {len(y['served'])} requests; "
                      f"prefill {_median(y['prefill_ms']):.3f} ms a group "
                      f"(median of {len(y['prefill_ms'])}; one rank "
                      f"{_median(o['prefill_ms']):.3f}), decode "
                      f"{_median(y['decode_ms']):.3f} ms a step (median of "
                      f"{len(y['decode_ms'])}; one rank "
                      f"{_median(o['decode_ms']):.3f}); gathers: the head "
                      f"table {g['table decode']:.4f} s and the layers "
                      f"{g['layer decode']:.4f} s of {dec:.4f} s of decode "
                      f"steps ({share:.1%}), the head table "
                      f"{g['table prefill']:.4f} s and the layers "
                      f"{g['layer prefill']:.4f} s of {pre:.4f} s of "
                      f"prefill groups; launches "
                      f"{y['counts']}; {smi}")
            phase("fsdp", "g1", f"rank {r['coords']}: params "
                  f"{r['g1_held']} B measured (memory_allocated), "
                  f"{r['g1_counted']} B counted (meta_params), whole "
                  f"{whole} B ({r['g1_counted'] / whole:.4f} of it); peak "
                  f"{r['g1_peak'] / 2**30:.2f} GiB (one rank "
                  f"{one_peak / 2**30:.2f}); {smi}")
            check(abs(r["g1_held"] - r["g1_counted"])
                  <= 0.01 * r["g1_counted"], f"fsdp g1: rank "
                  f"{r['coords']} holds {r['g1_held']} B, counted "
                  f"{r['g1_counted']}")
            check(r["g1_counted"] <= 0.51 * whole, f"fsdp g1: a rank "
                  f"stores {r['g1_counted']} B of {whole}")
        check_fsdp_serve(one, ranks, smi)
        phase("fsdp", "g1", "every rank's tokens and finish order equal one "
              "rank's, contiguous and paged; the first window's prefill "
              "logits, the first decode step's embedding, logits and layer "
              "0's K/V on the rank's rows equal one rank's bit for bit")
        # (g2)
        g2s = [r["g2"] for r in ranks]
        worst = max(g2s, key=lambda f: f["g_ratio"])
        pworst = max(g2s, key=lambda f: f["p_ratio"])
        g2 = r0["g2"]
        phase("fsdp", "g2", f"fp32 {fsdp_g2_run().model.name}: loss "
              f"{FSDP_WORLD} ranks {g2['loss']:.6f} vs one "
              f"{g2['loss_one']:.6f} (rel err {g2['loss_err']:.3e}, tol "
              f"{TRAIN_LOSS_RTOL}); grad norm {g2['norm']:.6f} vs "
              f"{g2['norm_one']:.6f} (rel err {g2['norm_err']:.3e}); "
              f"{g2['leaves']} gradient leaves, {g2['split']} stored as "
              f"slices: worst abs err {max(f['g_abs'] for f in g2s):.3e}, "
              f"worst err / bound {worst['g_ratio']:.3f} ({worst['g_leaf']});"
              f" updated params: worst err / bound {pworst['p_ratio']:.3f} "
              f"({pworst['p_leaf']}; {sum(f['widened'] for f in g2s)} "
              f"entries held to 2 x lr); the {g2['n_whole']} leaves every "
              "rank stores whole: " + ("gradients equal bit for bit on the "
                                       "ranks" if all(f["whole_equal"] for f
                                                      in g2s) else
                                       "gradients differ ("
                                       + ", ".join(f["unequal"] for f in g2s)
                                       + ")") + f"; {smi}")
        for r in ranks:
            f = r["g2"]
            check(f["metrics"] == g2["metrics"], "fsdp g2: the ranks' "
                  "metrics differ")
            check(math.isfinite(f["loss"]) and f["loss_err"]
                  <= TRAIN_LOSS_RTOL, f"fsdp g2: loss {f['loss']!r} vs one "
                  f"{f['loss_one']!r}, rel err {f['loss_err']:.3e}")
            check(f["norm_err"] <= TRAIN_RTOL, f"fsdp g2: grad norm "
                  f"{f['norm']!r} vs {f['norm_one']!r}, rel err "
                  f"{f['norm_err']:.3e} > {TRAIN_RTOL}")
            check(f["g_ratio"] <= 1.0, f"fsdp g2: rank {r['coords']}: "
                  f"gradient {f['g_leaf']} off by {f['g_ratio']:.2f} x its "
                  "bound")
            check(f["p_ratio"] <= 1.0, f"fsdp g2: rank {r['coords']}: "
                  f"updated param {f['p_leaf']} off by {f['p_ratio']:.2f} x "
                  "its bound")
            check(f["whole_equal"], f"fsdp g2: the gradient of "
                  f"{f['unequal']}, stored whole by every rank, differs "
                  "between the ranks")
            check(abs(f["held"] - f["counted"]) <= 0.01 * f["counted"],
                  f"fsdp g2: a rank's params take {f['held']} B, counted "
                  f"{f['counted']} B")
        phase("fsdp", "g2", "bytes a rank: params " + ", ".join(
            str(r["g2"]["held"]) for r in ranks) + f" B measured "
            f"(memory_allocated), {g2['counted']} B counted, whole "
            f"{g2['whole']} B ({g2['counted'] / g2['whole']:.4f} of it), "
            f"{g2['one_held']} B measured on one rank; moments a rank "
            f"{g2['moment_bytes']} B; control, TF32 products in the world: "
            f"worst err / bound {r0['tf32']:.3f}, must exceed "
            f"{TF32_CONTROL_MIN}")
        check(r0["tf32"] > TF32_CONTROL_MIN, f"fsdp g2: with TF32 on, the "
              f"world's gradients land at {r0['tf32']:.3f} of the bound")
        # (g3)
        tp = ("the dp phase's tp + ZeRO-1 rank on the same cut, this run: "
              + ", ".join(f"{x:.4f}" for x in dp_steps) + " s"
              if dp_steps else "the dp phase did not run in this call")
        for r in ranks:
            med = statistics.median(r["times"])
            sp = {k: statistics.median(v) for k, v in r["spent"].items()}
            phase("fsdp", "time", f"rank {r['coords']} ({r['backend']}): "
                  f"bf16 fsdp_tp step median {med:.4f} s (of "
                  f"{', '.join(f'{x:.4f}' for x in r['times'])}): the "
                  f"layers' and tables' gathers {sp['all_gather']:.4f} s = "
                  f"{sp['all_gather'] / med:.1%}, their backward's "
                  f"all-reduces {sp['all_reduce']:.4f} s = "
                  f"{sp['all_reduce'] / med:.1%}, reduce_grads (the leaves "
                  f"stored whole) {sp['reduce_grads']:.4f} s; {tp}; {smi}")
        g3 = r0["g3"]
        for r in ranks:
            check(r["g3"]["pre"] == g3["pre"] and r["g3"]["next"]
                  == g3["next"], "fsdp g3: the ranks' losses differ")
        pre = g3["pre"]
        check(g3["restarts"] == 1 and len(pre) == DP_STEPS + 2,
              f"fsdp g3: {g3['restarts']} restarts, {len(pre)} losses")
        check(pre[6:8] == pre[4:6], f"fsdp g3: the steps replayed after the "
              f"preemption give {pre[6:8]}, first {pre[4:6]}")
        g3r = fsdp_g3_run()
        state, start, step_fn = _start(g3r, os.path.join(work, "pre"),
                                       "cuda")
        _, met = step_fn(state, synthetic_batches(g3r, "cuda")(start))
        one_next = float(met["loss"])
        del state, step_fn
        free_device_memory()
        next_err = abs(one_next - g3["next"]) / abs(g3["next"])
        check(start == g3["start"] == DP_STEPS and next_err <= DP_NEXT_RTOL,
              f"fsdp g3: step {start}'s loss on one rank from the world's "
              f"checkpoint {one_next!r} vs the world's {g3['next']!r}, rel "
              f"err {next_err:.3e} > {DP_NEXT_RTOL}")
        phase("fsdp", "g3", f"bf16 train_loop(mesh=): {DP_STEPS} steps with "
              f"checkpoints every 4 and a preemption before step 6: "
              f"{g3['restarts']} restart, steps 4-5 replayed bit for bit "
              f"({len(pre)} losses); step {start} from its last checkpoint "
              f"on one rank {one_next:.6f} vs the world {g3['next']:.6f} "
              f"(rel err {next_err:.3e}, tol {DP_NEXT_RTOL}); losses "
              + ", ".join(f"{x:.4f}" for x in pre)
              + f"; the loop {g3['loop_s']:.1f} s; {smi}")
        # (g4)
        g4 = r0["g4"]
        one_drops = r0["g4_one_drops"]
        world_drops = sum(r["g4"]["drops"] for r in ranks)
        check(one_drops > 0 and all(r["g4_one_drops"] == one_drops
                                    for r in ranks),
              "fsdp g4: one rank's drops "
              f"{[r['g4_one_drops'] for r in ranks]}")
        check(world_drops == one_drops, f"fsdp g4: the world dropped "
              f"{world_drops} assignments, one rank {one_drops}")
        for r in ranks:
            f = r["g4"]
            check(f["loss_err"] <= TRAIN_LOSS_RTOL, f"fsdp g4: loss "
                  f"{f['loss']!r} vs one {f['loss_one']!r}, rel err "
                  f"{f['loss_err']:.3e}")
            check(f["g_ratio"] <= 1.0, f"fsdp g4: rank {r['coords']}: "
                  f"gradient {f['g_leaf']} off by {f['g_ratio']:.2f} x its "
                  "bound")
        phase("fsdp", "g4", f"{fsdp_g4_run().model.name}, fp32, capacity "
              f"factor {DP_CAPACITY_FACTOR}, {g4['split']} leaves stored as "
              f"slices: {one_drops} assignments dropped on one rank, "
              f"{world_drops} over the world's ranks; loss {g4['loss']:.6f} "
              f"vs {g4['loss_one']:.6f} (rel err {g4['loss_err']:.3e}); "
              f"{g4['leaves']} gradient leaves, worst err / bound "
              f"{max(r['g4']['g_ratio'] for r in ranks):.3f} "
              f"({g4['g_leaf']}; rtol {TRAIN_RTOL}, atol "
              f"{TRAIN_ATOL['dp jamba']} x max(1, leaf max))")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r in ranks:
        check(not any(r["launches"].values()), f"fsdp: rank {r['coords']} "
              f"launched kernels {r['launches']} in training")
    phase("fsdp", "done", f"g1 launches {served} over the ranks and modes; "
          f"training launches {[r['launches'] for r in ranks]}; world "
          f"{world_s:.1f} s; phase {time.perf_counter() - t0:.1f} s; {smi}")
    return served


def clock(t0, what):
    """Print the script's seconds so far, after ``what``: the phases'
    share of the time limit."""
    phase("clock", what, f"{time.perf_counter() - t0:.1f} s into the script")


def main():
    t0 = time.perf_counter()
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "benchmarks"))
    # the train phase's deterministic-mode check needs cuBLAS configured
    # before it starts (32 MiB of workspace, the H100 default)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    name, smi = phase_device()
    phase_build()
    phase_kernels()
    free_device_memory()
    per_call = phase_launches_per_call()
    free_device_memory()
    clock(t0, "kernels")
    launches, by_path, served = {}, {}, {}
    for arch, layers, smoke, why in PATHS:
        served[arch] = phase_serve(arch, layers, smoke, why, smi)
        by_path[arch] = served[arch].counts
        for k, v in served[arch].counts.items():
            launches[k] = launches.get(k, 0) + v
        free_device_memory()
        if served[arch].moe_counts is not None:
            check_gmm_counts(path_config(arch, layers, smoke),
                             served[arch].moe_counts,
                             torch.Generator(device="cuda").manual_seed(6))
            free_device_memory()
        if arch in ("musicgen-large", "mamba2-1.3b"):
            reference_check(arch)
            free_device_memory()
    clock(t0, "serve")
    total, by_run = phase_parallel(served, smi)
    for k, v in total.items():
        launches[k] += v
    free_device_memory()
    clock(t0, "parallel")
    for k, v in phase_batch(served, smi).items():
        launches[k] += v
    free_device_memory()
    clock(t0, "batch")
    for k, v in phase_dsp(smi).items():
        launches[k] += v
    free_device_memory()
    clock(t0, "dsp")
    rows = phase_times(launches, by_path, by_run,
                       served["arctic-480b"].moe_counts, smi, per_call)
    free_device_memory()
    clock(t0, "times")
    phase_train(smi)
    free_device_memory()
    clock(t0, "train")
    phase_elastic(smi)
    free_device_memory()
    dp_steps = phase_dp(smi)
    free_device_memory()
    clock(t0, "dp")
    phase_tp_train(smi)
    free_device_memory()
    clock(t0, "tp-train")
    phase_fsdp(smi, dp_steps)
    clock(t0, "fsdp")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeError as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
