#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: ``python3 chip_smoke.py`` from the repo root.

Phases, one or more lines each; any failure raises and the script exits 1
without its final line:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
2. build: nvcc builds the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card,
   bf16 and fp32: flash at musicgen-large and qwen2-7b widths (ragged
   lengths); decode at G 1, 2, 7 and 8 over every head dim (musicgen,
   qwen2 and arctic heads among them), each with a row of length 0, one
   at cap and rows ending mid-split, shuffled pages, paged == contiguous
   bit for bit and two calls of each equal bit for bit; moe_gmm at the C
   of every arctic-480b and jamba-smoke prefill group and decode step
   (every instance: C tile, 16-byte or element-wise loads, split over d
   or not), ssd_scan at every mamba2-1.3b and jamba-smoke prefill group
   shape, grouped, and at each (hp, ds) instance; then the device
   kernels one call of each wrapper runs at phase 5's shapes
   (torch.profiler). After arctic's serve run, moe_gmm with the filled
   counts of a decode step and of the largest prefill group, from
   ``route`` + ``dispatch`` on the path's weights (rows past a count must
   be exact zero).
4. serve: four paths, one model resident at a time (weights from a
   seeded ``torch.Generator``): musicgen-large at full width and depth,
   mamba2-1.3b at full width and depth, arctic-480b at full width cut to
   2 of its 35 layers (its 128 experts take 26.8 GB a layer), and
   jamba-1.5-large at its smoke config (a wiring check: full width does
   not fit one card). Each serves 16 requests through ``Engine.run``,
   contiguous and then paged; tokens and finish order must agree, every
   page must come back, and the launch counters, set to 0 just before
   each run and read just after, must show that every prefill and decode
   step went through the path's kernels; on the MoE paths, ``plan`` at
   every C and weight of the path must pick the bf16 tensor-core design
   with 16-byte loads. A 2-layer cut of musicgen
   and of mamba2 at full width in fp32 is held against the CPU's plain
   path.
5. times: per path, prefill ms per group, decode ms per step, tokens/s,
   peak device memory and the device-busy share of a decode step under
   torch.profiler; then CUDA-event times of each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call, at the shapes of phase 4, beside the least time the card could
   take, and the device kernels per call from phase 3: flash at
   musicgen's and arctic's heads (SDPA pinned to its flash backend),
   decode and paged decode at musicgen's and arctic's heads (SDPA with a
   length mask beside), ssd_scan at each mamba2 prefill group shape with
   every hp tile of its bf16 grid, moe_gmm at C 1 and 30 with every row
   filled (beside torch.bmm) and at a real decode step's counts (bound on
   the filled experts' weights); and moe_gmm at every C of arctic's path,
   with the counts of the call that gives it, at several splits over d
   beside the one ``plan`` picks (the measurements its split rule rests
   on).

The last three lines are the ``nvidia-smi`` name and power limit, a JSON
object with one entry per kernel, and ``{"ok": true, "device": ...}``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_FP32_FLOPS = 67e12       # H100 SXM fp32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12      # H100 SXM dense TF32 tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {"float32": 2e-5,       # tests/test_kernels.py:24: fp32 sums reorder
       "bfloat16": 5e-2}      # tests/test_kernels.py:25: one bf16 ulp ~ 1e-2
# (rtol, atol): tests/test_kernels.py:81-82 (ssd) and :98-99 (gmm)
SSD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (8e-2, 8e-2)}
GMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-2, 4e-1)}
REF_TOL = 1e-3                # fp32 logits, card vs CPU (cuBLAS sum order)
SPIN_CYCLES = 1_000_000       # ~0.5 ms of device spin ahead of a timed call
ARCH = "musicgen-large"
# (arch, layers kept or None for all, smoke config, why)
PATHS = (
    ("musicgen-large", None, False, "full width and depth"),
    ("mamba2-1.3b", None, False, "full width and depth"),
    ("arctic-480b", 2, False, "full width, depth cut to 2 of 35 layers: "
     "each layer's 128 experts are 26.8 GB"),
    ("jamba-1.5-large-398b", None, True, "smoke config, a wiring check: "
     "full width does not fit one card"),
)
N_REQ, PLENS, NEW_TOKENS = 16, (128, 256, 512), 32
MAX_BATCH, MAX_LEN = 8, 1024


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
    ]
    # (label, B, H, KVH, hd, S, lengths): G 1, 2, 7 and 8 over every hd;
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
    check_gmm(gen)
    check_ssd(gen)


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


def check_gmm_counts(counts_by_t, gen):
    """moe_gmm with the filled counts of an arctic decode step and of its
    largest prefill group (``moe_counts``: route + dispatch on the path's
    weights), both orientations, on an x that is non-zero in every row:
    filled rows match the plain version, rows past the count are exact
    zero."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    from repro_torch.models.moe import capacity
    arctic = get_config("arctic-480b")
    steps = (("decode step", MAX_BATCH), ("prefill group", max(counts_by_t)))
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = GMM_TOL[str(dtype).split(".")[1]]
        for d, f in ((7168, 4864), (4864, 7168)):
            w = rand((128, d, f), torch.float32, gen).mul_(d ** -0.5).to(dtype)
            for step, T in steps:
                counts = counts_by_t[T]
                C = capacity(T, arctic)
                x = rand((128, C, d), dtype, gen)
                out = moe_gmm(x, w, counts)
                err = max_err(out, moe_gmm_ref(x, w, counts), rtol, atol)
                empty = (torch.arange(C, device="cuda")[None, :]
                         >= counts[:, None])
                check(bool((out[empty] == 0).all()),
                      f"moe_gmm {step}: a row past its count is not zero")
                live = int((counts > 0).sum())
                phase(3, "kernels", f"moe_gmm arctic {step} counts (T {T}, C "
                      f"{C}, {live} of 128 experts filled, {int(counts.sum())}"
                      f" rows) d {d} -> f {f} {dtype}: max abs err {err:.3e} "
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
    128; chunk min(256, S)) and of jamba smoke, with grouped B/C, and at
    the (hp, ds) instances no path runs: y and the final state."""
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


def serve_run(lm, page_size):
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import Engine, Request
    eng = Engine(lm, max_batch=MAX_BATCH, max_len=MAX_LEN,
                 page_size=page_size, device="cuda")
    reqs = make_requests(lm.cfg, Request)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    return eng, done, counts, wall


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
    """Serve one path contiguous and paged, check it, time its engine;
    returns its launch counts. Its weights are freed by the caller."""
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
    for mode, ps in (("contiguous", None), ("paged", DECODE_BLOCK_S)):
        eng, done, counts, wall = serve_run(lm, ps)
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
    time_engine(lm, smi)
    phase(5, "times", f"{cfg.name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(max_memory_allocated, weights {n_params * lm.dtype.itemsize / 2**30:.2f}"
          f" GiB); {smi}")
    return ({k: runs["contiguous"][1][k] + runs["paged"][1][k]
             for k in runs["contiguous"][1]}, moe_counts_by_t)


def reference_check(arch):
    """A 2-layer cut at full width, fp32: card (kernels) vs CPU (plain)."""
    import numpy as np
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM, tree_map

    small = dataclasses.replace(get_config(arch), n_layers=2, dtype="float32")
    params = init_params(small, torch.Generator(device="cuda").manual_seed(2),
                         "cuda")
    lm_gpu = LM(small, params, device="cuda")
    lm_cpu = LM(small, tree_map(lambda t: t.cpu(), params), device="cpu")
    rng = np.random.default_rng(3)
    ncb = (small.n_codebooks,) if small.n_codebooks > 1 else ()
    toks = torch.from_numpy(rng.integers(
        1, small.vocab_size, (2, 128) + ncb).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(
        1, small.vocab_size, (2, 1) + ncb).astype(np.int32))
    errs = []
    for lm in (lm_gpu, lm_cpu):
        logits, pre = lm.prefill({"tokens": toks})
        caches = lm.init_cache(2, 256)
        for row in range(2):
            lm.splice(caches, pre, row, row)
        lengths = torch.tensor([128, 100], dtype=torch.int32,
                               device=lm.device)
        dec, _ = lm.decode(nxt.to(lm.device), lengths, caches)
        errs.append((logits.cpu(), dec.cpu()))
    (pg, dg), (pc, dc) = errs
    check(pg.shape == (2,) + ncb + (small.vocab_padded,),
          f"prefill logits shape {tuple(pg.shape)}")
    e_pre = max_err(pg, pc, REF_TOL)
    e_dec = max_err(dg, dc, REF_TOL)
    phase(4, "serve", f"reference {small.name}: 2-layer full-width fp32 cut, "
          f"card vs CPU plain path: prefill logits max abs err {e_pre:.3e}, "
          f"decode logits {e_dec:.3e} (tol {REF_TOL}); all finite")


def time_engine(lm, name):
    """One admit window (timed prefill) and its decode steps, after an
    untimed warm-up window of the same shapes; then a profiled step."""
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
    phase(5, "times", f"engine {cfg.name} {cfg.dtype}, {MAX_BATCH} requests "
          f"of prompts {first}: prefill {1e3 * (t1 - t0) / n_pre:.3f} ms per "
          f"group ({n_pre} groups), decode {1e3 * (t2 - t1) / n_steps:.3f} ms"
          f" per step ({n_steps} steps of batch {MAX_BATCH}), "
          f"{toks / (t2 - t0):.1f} tok/s ({toks} tokens{cb}); {name}")
    profile_steps(eng, make_requests(cfg, Request)[:MAX_BATCH],
                  1e3 * (t2 - t1) / n_steps, name)


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


def attention_rows(launches, flush, gen):
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models.blocks import DECODE_BLOCK_S

    cfg = get_config(ARCH)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = torch.bfloat16
    elt = 2
    rows = []

    # flash at the largest prefill group of phase 4's first admit window,
    # musicgen's (the row) and arctic's hd-128 heads; the library is SDPA
    # pinned to its flash backend
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    S = max(first)
    arctic = get_config("arctic-480b")
    shapes = []
    for label, heads, hdim in (("musicgen", H, hd),
                               ("arctic", arctic.n_heads, arctic.head_dim)):
        BH = first.count(S) * heads
        q, k, v = (rand((BH, S, hdim), dtype, gen) for _ in range(3))
        pairs = sum(min(i + 1, S) for i in range(S))
        b_ms, b_by = bound(4 * BH * S * hdim * elt,
                           (4 * hdim * pairs * BH, PEAK_BF16_FLOPS))
        err = max_err(flash_attention(q, k, v, causal=True),
                      flash_attention_ref(q, k, v), TOL["bfloat16"])
        ms = time_ms(lambda: flash_attention(q, k, v), flush)
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), flush)
        shapes.append(dict(
            label=f"{label} BH={BH} S={S} hd={hdim} bf16 causal", err=err,
            ms=ms, lib=lib, b_ms=b_ms, b_by=b_by,
            plain=(time_ms(lambda: flash_attention_ref(q, k, v), flush)
                   if label == "musicgen" else None)))
        del q, k, v
    mg, ar = shapes
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=launches["flash_attention"], max_abs_err=mg["err"],
        ms=mg["ms"], plain_ms=mg["plain"], bound_ms=mg["b_ms"],
        bound_by=mg["b_by"], library_ms=mg["lib"],
        shape=f"{mg['label']}; {ar['label']}: kernel {ar['ms']:.4f} ms, "
              f"library {ar['lib']:.4f} ms, bound {ar['b_ms']:.4f} ms "
              f"({ar['b_by']}), max abs err {ar['err']:.3e}; library: "
              "scaled_dot_product_attention under sdpa_kernel("
              "SDPBackend.FLASH_ATTENTION)"))

    # decode at phase 4's first wave, half way through its new tokens:
    # musicgen's heads (the rows) and arctic's GQA heads beside them
    shapes = [decode_shape(label, heads, kvh, hdim, first, flush, gen)
              for label, heads, kvh, hdim in (
                  ("musicgen", H, KVH, hd),
                  ("arctic", arctic.n_heads, arctic.n_kv_heads,
                   arctic.head_dim))]
    mg, ar = shapes
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
    return rows


def decode_shape(label, H, KVH, hd, first, flush, gen):
    """Contiguous and paged decode at batch MAX_BATCH, half way through
    phase 4's first wave, bf16: kernel, plain and masked-SDPA times,
    bounds and errors."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import (
        decode_attention_ref, paged_decode_attention_ref)
    from repro_torch.models.blocks import DECODE_BLOCK_S
    B, dtype, elt = MAX_BATCH, torch.bfloat16, 2
    lens = [p + NEW_TOKENS // 2 for p in first]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qd = rand((B, H, hd), dtype, gen)
    kc = rand((B, MAX_LEN, KVH, hd), dtype, gen)
    vc = rand((B, MAX_LEN, KVH, hd), dtype, gen)
    kv_bytes = 2 * sum(lens) * KVH * hd * elt
    io_bytes = 2 * B * H * hd * elt + 4 * B
    flops = 4 * sum(lens) * H * hd
    r = dict(label=f"{label} B={B} H={H} KVH={KVH} hd={hd} S={MAX_LEN} "
                   f"block_s={DECODE_BLOCK_S} lengths={lens} bf16")
    r["b_ms"], r["b_by"] = bound(kv_bytes + io_bytes, (flops, PEAK_BF16_FLOPS))
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
    r["paged_b_ms"], r["paged_b_by"] = bound(
        kv_bytes + io_bytes + table.numel() * 4, (flops, PEAK_BF16_FLOPS))
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
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    E, d, f = 128, 7168, 4864
    w = rand((E, d, f), torch.float32, gen).mul_(d ** -0.5).to(torch.bfloat16)
    extra = []
    for C in (30, 1):
        x = rand((E, C, d), torch.bfloat16, gen)
        b_ms, b_by = bound(2 * (E * d * f + E * C * d + E * C * f),
                           (2 * E * C * d * f, PEAK_BF16_FLOPS))
        ms = time_ms(lambda: moe_gmm(x, w), flush)
        lib = time_ms(lambda: torch.bmm(x, w), flush)
        extra.append(f"C={C}: kernel {ms:.4f} ms, torch.bmm {lib:.4f} ms, "
                     f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of bound")
    T, counts = MAX_BATCH, counts_by_t[MAX_BATCH]
    live, filled = int((counts > 0).sum()), int(counts.sum())
    c_ms, c_by = bound(2 * (live * d * f + filled * d + E * f),
                       (2 * filled * d * f, PEAK_BF16_FLOPS))
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
    from repro_torch.kernels.moe_gmm import launch, plan
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
            b_ms, b_by = bound(2 * (live * d * f + rows * d + E * C * f),
                               (2 * rows * d * f, PEAK_BF16_FLOPS))
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


def ssd_bytes(B, S, nh, hp, ng, ds, elt):
    """Bytes one ssd_scan call must move: x, dt, A, B and C read once, y
    and the final state written once."""
    return (elt * B * S * nh * hp + 4 * B * S * nh + 4 * nh
            + 2 * elt * B * S * ng * ds + 4 * B * S * nh * hp
            + 4 * B * nh * hp * ds)


def ssd_bound(B, S, nh, hp, ng, ds, chunk, elt):
    """(ms, by) of one ssd_scan call: ``ssd_bytes``; the C.B scores
    (operands in x's dtype) once per (b, chunk, group) at the bf16
    tensor-core rate, the products with an fp32 operand (the scores times
    dt x, the inter-chunk term, the state update) per head at the TF32
    tensor-core rate the bf16 kernel runs them at."""
    tri = chunk * (chunk + 1) // 2
    nc = S // chunk
    scores = 2 * nc * B * ng * tri * ds
    rest = 2 * nc * B * nh * (tri * hp + 2 * chunk * hp * ds)
    return bound(ssd_bytes(B, S, nh, hp, ng, ds, elt),
                 (scores, PEAK_BF16_FLOPS), (rest, PEAK_TF32_FLOPS))


def ssd_bound_fp32(B, S, nh, hp, ng, ds, chunk, elt):
    """The bound of a kernel that runs the fp32-operand products on CUDA
    cores, as PERF.md counted it before the tensor-core kernel: the
    scores once per head at the bf16 rate, the rest at the fp32 rate."""
    tri = chunk * (chunk + 1) // 2
    n = 2 * (S // chunk) * B * nh
    return bound(ssd_bytes(B, S, nh, hp, ng, ds, elt),
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


def phase_times(launches, arctic_counts, name, per_call):
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = attention_rows(launches, flush, gen)
    rows.append(gmm_row(launches, arctic_counts, flush, gen))
    free_device_memory()
    gmm_split_sweep(arctic_counts, flush, gen, name)
    rows.append(ssd_row(launches, flush, gen, name))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        n = per_call[r["name"]]
        phase(5, "times", f"{r['name']} [{r.pop('shape')}]: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['bound_ms'] / r['ms']:.1%} of bound; launches "
              f"{r['launches']} on the serve paths, "
              + (f"{n} device kernels per call" if n else "device kernels "
                 "per call not measured (the profiler saw none)")
              + f"; {name}")
    return rows


def main():
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    name, smi = phase_device()
    phase_build()
    phase_kernels()
    free_device_memory()
    per_call = phase_launches_per_call()
    free_device_memory()
    launches, arctic_counts = {}, None
    for arch, layers, smoke, why in PATHS:
        counts, moe_counts_by_t = phase_serve(arch, layers, smoke, why, smi)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        free_device_memory()
        if arch == "arctic-480b":
            arctic_counts = moe_counts_by_t
            check_gmm_counts(arctic_counts,
                             torch.Generator(device="cuda").manual_seed(6))
            free_device_memory()
        if arch in ("musicgen-large", "mamba2-1.3b"):
            reference_check(arch)
            free_device_memory()
    rows = phase_times(launches, arctic_counts, smi, per_call)
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
