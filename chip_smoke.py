#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: ``python3 chip_smoke.py`` from the repo root.

Phases, one or more lines each; any failure raises and the script exits 1
without its final line:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
2. build: nvcc builds the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card,
   bf16 and fp32: attention at musicgen-large and qwen2-7b widths (ragged
   lengths, zero-length rows, shuffled pages, paged == contiguous bit for
   bit), moe_gmm at the C of every arctic-480b and jamba-smoke prefill
   group and decode step (every C-tile instance), ssd_scan at every
   mamba2-1.3b and jamba-smoke prefill group shape, grouped, and at each
   (hp, ds) instance.
4. serve: four paths, one model resident at a time (weights from a
   seeded ``torch.Generator``): musicgen-large at full width and depth,
   mamba2-1.3b at full width and depth, arctic-480b at full width cut to
   2 of its 35 layers (its 128 experts take 26.8 GB a layer), and
   jamba-1.5-large at its smoke config (a wiring check: full width does
   not fit one card). Each serves 16 requests through ``Engine.run``,
   contiguous and then paged; tokens and finish order must agree, every
   page must come back, and the launch counters, set to 0 just before
   each run and read just after, must show that every prefill and decode
   step went through the path's kernels. A 2-layer cut of musicgen and of
   mamba2 at full width in fp32 is held against the CPU's plain path.
5. times: per path, prefill ms per group, decode ms per step, tokens/s,
   peak device memory and the device-busy share of a decode step under
   torch.profiler; then CUDA-event times of each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call, at the shapes of phase 4, beside the least time the card could
   take.

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
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {"float32": 2e-5,       # tests/test_kernels.py:24: fp32 sums reorder
       "bfloat16": 5e-2}      # tests/test_kernels.py:25: one bf16 ulp ~ 1e-2
# (rtol, atol): tests/test_kernels.py:81-82 (ssd) and :98-99 (gmm)
SSD_TOL = {"float32": (2e-4, 2e-4), "bfloat16": (8e-2, 8e-2)}
GMM_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (8e-2, 4e-1)}
REF_TOL = 1e-3                # fp32 logits, card vs CPU (cuBLAS sum order)
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


def time_ms(fn, flush, iters=20, warmup=3):
    """Mean ms of ``fn`` by CUDA events, with L2 flushed before each call
    (outside the events): each layer's real call finds its inputs cold."""
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
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
    decode_cases = [  # (label, B, H, KVH, hd, S, lengths)
        ("musicgen", 8, 32, 32, 64, 1024,
         [0, 1, 127, 128, 129, 540, 1023, 1024]),
        ("qwen2 G=7", 4, 28, 4, 128, 1024, [0, 300, 1024, 777]),
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
            kp, table = paged_layout(kc, DECODE_BLOCK_S, cpu_gen)
            vp = torch.full_like(kp, float("nan"))
            vp[table.reshape(-1).long()] = vc.reshape(-1, DECODE_BLOCK_S,
                                                      KVH, hd)
            paged = paged_decode_attention(q, kp, vp, table, lengths)
            perr = max_err(paged, paged_decode_attention_ref(
                q, kp, vp, table, lengths), tol)
            check(torch.equal(paged, out),
                  f"paged != contiguous bitwise ({label}, {dtype})")
            phase(3, "kernels", f"decode_attention {label} {dtype}: max abs"
                  f" err {err:.3e}; paged_decode_attention max abs err "
                  f"{perr:.3e} (tol {tol}); paged == contiguous bitwise at "
                  f"page_size == block_s == {DECODE_BLOCK_S}; length-0 rows "
                  "exact zero")
    check_gmm(gen)
    check_ssd(gen)


def gmm_tile(C):
    """The C tile that moe_gmm.cu's dispatch_c instantiates for C."""
    return next((bc for bc in (1, 2, 4, 8, 16) if C <= bc), 32)


def path_capacities(cfg):
    """moe_gmm's C on phase 4's path: each prefill group (1 to 3 prompts of
    one length: a window of 8 cycles through 3 lengths) and a decode step
    of the whole batch."""
    from repro_torch.models.moe import capacity
    per_len = -(-MAX_BATCH // len(PLENS))
    tokens = {k * p for k in range(1, per_len + 1) for p in PLENS}
    return sorted({capacity(t, cfg) for t in tokens | {MAX_BATCH}})


def check_gmm(gen):
    """moe_gmm at the C of every prefill group and decode step of arctic
    (128 experts, d 7168 <-> f 4864) and of jamba smoke, at a ragged shape,
    and at C = 2: every C-tile instance of the kernel is held against the
    plain version."""
    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import moe_gmm_ref
    arctic = get_config("arctic-480b")
    jamba = get_smoke_config("jamba-1.5-large-398b")
    a_cs = path_capacities(arctic)
    j_cs = path_capacities(jamba)
    cases = [("arctic d->f", 128, 7168, 4864, a_cs + [2]),   # (E, d, f, Cs)
             ("arctic f->d", 128, 4864, 7168, a_cs),
             ("jamba smoke", jamba.n_experts, jamba.d_model,
              jamba.d_ff_expert, j_cs),
             ("ragged", 3, 37, 53, [5])]
    for dtype in (torch.bfloat16, torch.float32):
        rtol, atol = GMM_TOL[str(dtype).split(".")[1]]
        tiles = set()
        for label, E, d, f, cs in cases:
            w = rand((E, d, f), torch.float32, gen).mul_(d ** -0.5).to(dtype)
            errs = []
            for C in cs:
                x = rand((E, C, d), dtype, gen)
                errs.append(max_err(moe_gmm(x, w), moe_gmm_ref(x, w), rtol,
                                    atol))
                tiles.add(gmm_tile(C))
                del x
            phase(3, "kernels", f"moe_gmm {label} (E {E}, d {d}, f {f}) "
                  f"{dtype}: C {cs} (C tiles "
                  f"{sorted({gmm_tile(C) for C in cs})}): max abs err "
                  f"{max(errs):.3e} (rtol {rtol}, atol {atol})")
            del w
            torch.cuda.empty_cache()
        check(tiles == {1, 2, 4, 8, 16, 32},
              f"moe_gmm C tiles checked {sorted(tiles)}, not all six")


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
    time_engine(lm, smi)
    phase(5, "times", f"{cfg.name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"(max_memory_allocated, weights {n_params * lm.dtype.itemsize / 2**30:.2f}"
          f" GiB); {smi}")
    return {k: runs["contiguous"][1][k] + runs["paged"][1][k]
            for k in runs["contiguous"][1]}


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
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import (
        decode_attention_ref, flash_attention_ref, paged_decode_attention_ref)
    from repro_torch.models.blocks import DECODE_BLOCK_S

    cfg = get_config(ARCH)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = torch.bfloat16
    elt = 2
    rows = []

    # flash at the largest prefill group of phase 4's first admit window
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    S = max(first)
    BH = first.count(S) * H
    q, k, v = (rand((BH, S, hd), dtype, gen) for _ in range(3))
    pairs = sum(min(i + 1, S) for i in range(S))
    b_ms, b_by = bound(4 * BH * S * hd * elt,
                       (4 * hd * pairs * BH, PEAK_BF16_FLOPS))
    out = flash_attention(q, k, v, causal=True)
    rows.append(dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:98",
        launches=launches["flash_attention"],
        max_abs_err=max_err(out, flash_attention_ref(q, k, v), TOL[cfg.dtype]),
        ms=time_ms(lambda: flash_attention(q, k, v), flush),
        plain_ms=time_ms(lambda: flash_attention_ref(q, k, v), flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[None], k[None], v[None], is_causal=True), flush),
        shape=f"musicgen BH={BH} S={S} hd={hd} {cfg.dtype} causal"))

    # decode at phase 4's first wave, half way through its new tokens
    B = MAX_BATCH
    lens = [p + NEW_TOKENS // 2 for p in first]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    qd = rand((B, H, hd), dtype, gen)
    kc = rand((B, MAX_LEN, KVH, hd), dtype, gen)
    vc = rand((B, MAX_LEN, KVH, hd), dtype, gen)
    kv_bytes = 2 * sum(lens) * KVH * hd * elt
    io_bytes = 2 * B * H * hd * elt + 4 * B
    flops = 4 * sum(lens) * H * hd
    b_ms, b_by = bound(kv_bytes + io_bytes, (flops, PEAK_BF16_FLOPS))
    valid = (torch.arange(MAX_LEN, device="cuda")[None, :]
             < lengths[:, None])[:, None, None, :]
    kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
    out = decode_attention(qd, kc, vc, lengths, block_s=DECODE_BLOCK_S)
    rows.append(dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/decode_attention.py:83",
        launches=launches["decode_attention"],
        max_abs_err=max_err(out, decode_attention_ref(qd, kc, vc, lengths),
                            TOL[cfg.dtype]),
        ms=time_ms(lambda: decode_attention(qd, kc, vc, lengths,
                                            block_s=DECODE_BLOCK_S), flush),
        plain_ms=time_ms(lambda: decode_attention_ref(qd, kc, vc, lengths),
                         flush),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], kt, vt, attn_mask=valid), flush),
        shape=f"musicgen B={B} H={H} KVH={KVH} hd={hd} S={MAX_LEN} "
              f"block_s={DECODE_BLOCK_S} lengths={lens} {cfg.dtype}"))

    cpu_gen = torch.Generator().manual_seed(5)
    kp, table = paged_layout(kc, DECODE_BLOCK_S, cpu_gen)
    vp = torch.full_like(kp, float("nan"))
    vp[table.reshape(-1).long()] = vc.reshape(-1, DECODE_BLOCK_S, KVH, hd)
    b_ms, b_by = bound(kv_bytes + io_bytes + table.numel() * 4,
                       (flops, PEAK_BF16_FLOPS))
    paged = paged_decode_attention(qd, kp, vp, table, lengths)
    check(torch.equal(paged, out), "timed shapes: paged != contiguous")
    rows.append(dict(
        name="paged_decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces="src/repro/kernels/paged_decode_attention.py:90",
        launches=launches["paged_decode_attention"],
        max_abs_err=max_err(paged, paged_decode_attention_ref(
            qd, kp, vp, table, lengths), TOL[cfg.dtype]),
        ms=time_ms(lambda: paged_decode_attention(qd, kp, vp, table,
                                                  lengths), flush),
        plain_ms=time_ms(lambda: paged_decode_attention_ref(
            qd, kp, vp, table, lengths), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"as decode_attention, page_size={DECODE_BLOCK_S}, shuffled "
              "pages; library n/a: no single PyTorch call attends through a "
              "page table"))
    return rows


def gmm_row(launches, flush, gen):
    """moe_gmm at arctic's decode step (C = 1, the most launched shape),
    with its prefill shape (C = 30) timed beside it."""
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
                     f"bound {b_ms:.4f} ms ({b_by})")
    row = dict(
        name="moe_gmm", route="cuda",
        source="src/repro_torch/kernels/csrc/moe_gmm.cu",
        replaces="src/repro/kernels/moe_gmm.py:58",
        launches=launches["moe_gmm"],
        max_abs_err=max_err(moe_gmm(x, w), moe_gmm_ref(x, w),
                            *GMM_TOL["bfloat16"]),
        ms=ms, plain_ms=time_ms(lambda: moe_gmm_ref(x, w), flush, iters=5),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib,
        shape=f"arctic E={E} C=1 d={d} f={f} bf16 (a decode step); "
              + "; ".join(extra) + "; library: torch.bmm")
    return row


def ssd_flops(B, S, nh, hp, ds, chunk):
    """FLOPs of the dual form, as (C.B scores, the rest): per chunk and
    head, the scores over the lower triangle (both operands in x's dtype),
    and their product with dt x, the inter-chunk term and the state update
    (one operand fp32: dt, the scores or the state)."""
    tri = chunk * (chunk + 1) // 2
    n = 2 * (S // chunk) * B * nh
    return n * tri * ds, n * (tri * hp + 2 * chunk * hp * ds)


def ssd_row(launches, flush, gen):
    """ssd_scan at mamba2's largest prefill group of phase 4 (3 x 512)."""
    from repro_torch.kernels.ref import ssd_scan_ref
    from repro_torch.kernels.ssd_scan import ssd_scan
    B, S, nh, hp, ng, ds, chunk = 3, 512, 64, 64, 1, 128, 256
    args = ssd_inputs(B, S, nh, hp, ng, ds, torch.bfloat16, gen)
    nbytes = (2 * B * S * nh * hp + 4 * B * S * nh + 4 * nh
              + 2 * 2 * B * S * ng * ds + 4 * B * S * nh * hp
              + 4 * B * nh * hp * ds)
    scores, rest = ssd_flops(B, S, nh, hp, ds, chunk)
    b_ms, b_by = bound(nbytes, (scores, PEAK_BF16_FLOPS),
                       (rest, PEAK_FP32_FLOPS))
    y, st = ssd_scan(*args, chunk=chunk)
    y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
    max_err(st, st_ref, *SSD_TOL["bfloat16"])
    return dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan.py:85",
        launches=launches["ssd_scan"],
        max_abs_err=max_err(y, y_ref, *SSD_TOL["bfloat16"]),
        ms=time_ms(lambda: ssd_scan(*args, chunk=chunk), flush),
        plain_ms=time_ms(lambda: ssd_scan_ref(*args, chunk=chunk), flush),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"mamba2 B={B} S={S} nh={nh} hp={hp} ng={ng} ds={ds} chunk="
              f"{chunk} bf16 in, fp32 out; bound: the C.B scores (bf16 "
              "operands) at the bf16 tensor-core rate, the products with an "
              "fp32 operand at the fp32 rate; library n/a: no single "
              "PyTorch call computes a chunked SSD scan")


def phase_times(launches, name):
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = attention_rows(launches, flush, gen)
    rows.append(gmm_row(launches, flush, gen))
    free_device_memory()
    rows.append(ssd_row(launches, flush, gen))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        phase(5, "times", f"{r['name']} [{r.pop('shape')}]: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['bound_ms'] / r['ms']:.1%} of bound; launches "
              f"{r['launches']}; {name}")
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
    launches = {}
    for arch, layers, smoke, why in PATHS:
        counts = phase_serve(arch, layers, smoke, why, smi)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        free_device_memory()
        if arch in ("musicgen-large", "mamba2-1.3b"):
            reference_check(arch)
            free_device_memory()
    rows = phase_times(launches, smi)
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
