#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: ``python3 chip_smoke.py`` from the repo root.

Phases, one or more lines each; any failure raises and the script exits 1
without its final line:

1. device: the card's name and power limit; TF32 off for matmul and cuDNN.
2. build: nvcc builds the kernels from ``src/repro_torch/kernels/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   musicgen-large and qwen2-7b widths, bf16 and fp32, with ragged lengths,
   zero-length rows and shuffled pages; paged == contiguous bit for bit.
4. serve: musicgen-large at full width (48 layers, d_model 2048, bf16,
   weights from a seeded ``torch.Generator``) serves 16 requests through
   ``Engine.run``, contiguous and then paged; tokens and finish order must
   agree, every page must come back, and the launch counters must show
   that prefill and decode went through the kernels. A 2-layer cut of the
   same widths in fp32 is then held against the CPU's plain path.
5. times: CUDA-event times of each kernel, its plain version and, where
   one PyTorch call computes the same function, that call, at the shapes
   of phase 4, beside the least time the card could take; then prefill
   ms per group, decode ms per step and tokens/s of the engine, and the
   device-busy share of a decode step under torch.profiler.

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
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
TOL = {"float32": 2e-5,       # tests/test_kernels.py:24: fp32 sums reorder
       "bfloat16": 5e-2}      # tests/test_kernels.py:25: one bf16 ulp ~ 1e-2
REF_TOL = 1e-3                # fp32 logits, card vs CPU (cuBLAS sum order)
ARCH = "musicgen-large"
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
def max_err(out, ref, tol):
    """Max abs error, after checking |out - ref| <= tol + tol * |ref|."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    check(bool(torch.isfinite(out).all()), "non-finite kernel output")
    check(bool((err <= tol + tol * ref.abs()).all()),
          f"max abs err {err.max().item():.3e} over tolerance {tol}")
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


def bound(flops, nbytes, peak_flops):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
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


def make_requests(cfg, Request):
    import numpy as np
    rng = np.random.default_rng(0)
    return [Request(rid=i, tokens=rng.integers(
        1, cfg.vocab_size, (PLENS[i % len(PLENS)], cfg.n_codebooks)
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


def phase_serve():
    import numpy as np
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.models.lm import LM, tree_leaves

    cfg = get_config(ARCH)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         "cuda")
    lm = LM(cfg, params, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    phase(4, "serve", f"{cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads x {cfg.head_dim}, "
          f"{cfg.n_codebooks} codebooks, {cfg.dtype}; {n_params / 1e9:.3f} B"
          f" params drawn in {time.perf_counter() - t0:.2f} s")
    runs = {}
    for mode, ps in (("contiguous", None), ("paged", DECODE_BLOCK_S)):
        eng, done, counts, wall = serve_run(lm, ps)
        check(len(done) == N_REQ and not any(r.rejected for r in done),
              f"{mode}: served {len(done)} of {N_REQ}")
        for r in done:
            toks = np.asarray(r.out_tokens)
            check(toks.shape == (NEW_TOKENS, cfg.n_codebooks),
                  f"{mode}: request {r.rid} tokens {toks.shape}")
            check(bool(((toks >= 0) & (toks < cfg.vocab_padded)).all()),
                  f"{mode}: token out of range")
        layers = cfg.n_layers
        check(counts["flash_attention"] == layers * eng.prefills > 0,
              f"{mode}: flash launches {counts['flash_attention']} != "
              f"{layers} x {eng.prefills} prefills")
        kern = ("decode_attention" if ps is None
                else "paged_decode_attention")
        other = ("paged_decode_attention" if ps is None
                 else "decode_attention")
        check(counts[kern] == layers * eng.steps > 0,
              f"{mode}: {kern} launches {counts[kern]} != {layers} x "
              f"{eng.steps} steps")
        check(counts[other] == 0, f"{mode}: {other} launched")
        if eng.pager is not None:
            check(eng.pager.used_pages == 0, "paged: pages not freed")
            eng.pager.check_conservation()
        toks = sum(len(r.out_tokens) for r in done)
        phase(4, "serve", f"{mode}: {len(done)} requests, {toks} token steps"
              f" x {cfg.n_codebooks} codebooks in {wall:.3f} s "
              f"({toks / wall:.1f} tok/s); {eng.prefills} prefills, "
              f"{eng.steps} decode steps; launches {counts}")
        runs[mode] = (done, counts)
    a, b = runs["contiguous"][0], runs["paged"][0]
    check([r.rid for r in a] == [r.rid for r in b],
          "finish order differs between contiguous and paged")
    for ra, rb in zip(a, b):
        check(np.array_equal(np.asarray(ra.out_tokens),
                             np.asarray(rb.out_tokens)),
              f"request {ra.rid}: tokens differ between contiguous and paged")
    phase(4, "serve", "contiguous and paged: equal tokens and finish order; "
          "every page freed, conservation holds")
    launches = {k: runs["contiguous"][1][k] + runs["paged"][1][k]
                for k in runs["contiguous"][1]}
    reference_check(cfg)
    return lm, launches


def reference_check(cfg):
    """A 2-layer cut at full width, fp32: card (kernels) vs CPU (plain)."""
    import numpy as np
    from repro_torch.bridge import init_params
    from repro_torch.models.lm import LM, tree_map

    small = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = init_params(small, torch.Generator(device="cuda").manual_seed(2),
                         "cuda")
    lm_gpu = LM(small, params, device="cuda")
    lm_cpu = LM(small, tree_map(lambda t: t.cpu(), params), device="cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(
        1, small.vocab_size, (2, 128, small.n_codebooks)).astype(np.int32))
    nxt = torch.from_numpy(rng.integers(
        1, small.vocab_size, (2, 1, small.n_codebooks)).astype(np.int32))
    errs = []
    for lm in (lm_gpu, lm_cpu):
        logits, pre = lm.prefill({"tokens": toks})
        caches = lm.init_cache(2, 256)
        for key, pair in caches.items():
            for dst, src in zip(pair, pre[key]):
                dst[:, :, :128].copy_(src)
        lengths = torch.tensor([128, 100], dtype=torch.int32,
                               device=lm.device)
        dec, _ = lm.decode(nxt.to(lm.device), lengths, caches)
        errs.append((logits.cpu(), dec.cpu()))
    (pg, dg), (pc, dc) = errs
    check(pg.shape == (2, small.n_codebooks, small.vocab_padded),
          f"prefill logits shape {tuple(pg.shape)}")
    e_pre = max_err(pg, pc, REF_TOL)
    e_dec = max_err(dg, dc, REF_TOL)
    phase(4, "serve", f"reference: 2-layer full-width fp32 cut, card vs CPU "
          f"plain path: prefill logits max abs err {e_pre:.3e}, decode "
          f"logits {e_dec:.3e} (tol {REF_TOL}); all finite")


def phase_times(lm, launches, name):
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import (
        decode_attention_ref, flash_attention_ref, paged_decode_attention_ref)
    from repro_torch.models.blocks import DECODE_BLOCK_S
    from repro_torch.serve.engine import Engine, Request

    cfg = lm.cfg
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    dtype = lm.dtype
    elt = torch.finfo(dtype).bits // 8
    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    rows = []

    # flash at the largest prefill group of phase 4's first admit window
    first = [PLENS[i % len(PLENS)] for i in range(MAX_BATCH)]
    S = max(first)
    BH = first.count(S) * H
    q, k, v = (rand((BH, S, hd), dtype, gen) for _ in range(3))
    pairs = sum(min(i + 1, S) for i in range(S))
    b_ms, b_by = bound(4 * hd * pairs * BH, 4 * BH * S * hd * elt,
                       PEAK_BF16_FLOPS)
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
        shape=f"BH={BH} S={S} hd={hd} {cfg.dtype} causal"))

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
    b_ms, b_by = bound(flops, kv_bytes + io_bytes, PEAK_BF16_FLOPS)
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
        shape=f"B={B} H={H} KVH={KVH} hd={hd} S={MAX_LEN} "
              f"block_s={DECODE_BLOCK_S} lengths={lens} {cfg.dtype}"))

    cpu_gen = torch.Generator().manual_seed(5)
    kp, table = paged_layout(kc, DECODE_BLOCK_S, cpu_gen)
    vp = torch.full_like(kp, float("nan"))
    vp[table.reshape(-1).long()] = vc.reshape(-1, DECODE_BLOCK_S, KVH, hd)
    b_ms, b_by = bound(flops, kv_bytes + io_bytes + table.numel() * 4,
                       PEAK_BF16_FLOPS)
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
              "pages"))
    for r in rows:
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        phase(5, "times", f"{r['name']} [{r.pop('shape')}]: kernel "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
              f"{lib} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
              f"{r['bound_ms'] / r['ms']:.1%} of bound; {name}")

    # the engine: one admit window (timed prefill) and its decode steps,
    # after an untimed warm-up window of the same shapes
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
    phase(5, "times", f"engine {cfg.name} {cfg.dtype}, {MAX_BATCH} requests "
          f"of prompts {first}: prefill {1e3 * (t1 - t0) / n_pre:.3f} ms per "
          f"group ({n_pre} groups), decode {1e3 * (t2 - t1) / n_steps:.3f} ms"
          f" per step ({n_steps} steps of batch {MAX_BATCH}), "
          f"{toks / (t2 - t0):.1f} tok/s ({toks} tokens x {cfg.n_codebooks} "
          f"codebooks); {name}")
    profile_steps(eng, make_requests(cfg, Request)[:MAX_BATCH],
                  1e3 * (t2 - t1) / n_steps, name)
    return rows


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
    phase(5, "times", f"decode step under torch.profiler: {launches / n:.0f} "
          f"kernels and {busy_ms:.3f} ms of device time per step against "
          f"{step_ms:.3f} ms unprofiled ({busy_ms / step_ms:.1%} busy); top: "
          + "; ".join(f"{k[:60]} {v / 1e3 / n:.3f} ms" for k, v in top)
          + f"; {name}")


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
    lm, launches = phase_serve()
    rows = phase_times(lm, launches, smi)
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
