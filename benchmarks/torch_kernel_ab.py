#!/usr/bin/env python3
"""Time this checkout's kernels beside another checkout's, on one card,
with ``chip_smoke.py``'s timer.

    python3 benchmarks/torch_kernel_ab.py --base DIR

DIR is another checkout of the repo, for example the parent commit
unpacked with ``git archive`` under ``build/``. The script runs four
processes in turn, the base, this tree, this tree, the base, each building
and timing its own tree's kernels on the same inputs (seeded), so a
difference between the trees is told from drift over the call. Both trees
are called through their public wrappers, so any two trees of the port
compare.

Shapes are those of ``chip_smoke.py``'s serve phase, bf16:
- flash: the largest prefill group of musicgen-large (BH 2 x 32, S 512,
  hd 64) and of arctic-480b (BH 2 x 56, S 512, hd 128), causal; SDPA's
  flash backend beside;
- moe_gmm: arctic's decode step (E 128, C 1, d 7168 -> f 4864) and
  largest prefill group (C 30), every row filled (the contract both trees
  share); ``torch.bmm`` beside;
- decode and paged (decode through shuffled 128-token pages): batch 8,
  cache 1024, lengths half way through the first admit window, at
  musicgen's heads (H = KVH = 32, hd 64) and arctic's (H 56, KVH 8, hd
  128); masked SDPA beside the contiguous form;
- ssd: mamba2-1.3b's prefill groups (B 3, S 128, 256, 512; nh 64, hp 64,
  ds 128, chunk min(256, S)).
Each kernel is timed twice: with ``time_ms``'s spin kernel (device time
only) and without it (event to event with the wrapper's host time in
between).

Prints one line per process and shape, the card's name and power limit,
then one JSON object: for each shape, each tree's times per run.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FLASH = (("musicgen", 64, 512, 64), ("arctic", 112, 512, 128))
GMM = (("arctic decode", 1), ("arctic prefill", 30))
E, D, F = 128, 7168, 4864
DECODE = (("musicgen", 32, 32, 64), ("arctic", 56, 8, 128))
SSD = (128, 256, 512)   # mamba2 prefill group lengths, B 3


def timed(cs, fn, flush, lib=None):
    """Kernel (and library) ms with and without the spin kernel."""
    r = dict(ms=cs.time_ms(fn, flush),
             ms_no_spin=cs.time_ms(fn, flush, spin=False))
    if lib is not None:
        r.update(library_ms=cs.time_ms(lib, flush),
                 library_ms_no_spin=cs.time_ms(lib, flush, spin=False))
    return r


def worker(tree: Path) -> dict:
    """Times of ``tree``'s kernels; runs in its own process."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ref import (
        decode_attention_ref, flash_attention_ref, moe_gmm_ref,
        paged_decode_attention_ref, ssd_scan_ref)
    from repro_torch.kernels.ssd_scan import ssd_scan

    pkg = Path(repro_torch.__file__).resolve()
    if tree.resolve() not in pkg.parents:
        raise SystemExit(f"repro_torch loaded from {pkg}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    res = {}
    for label, BH, S, hd in FLASH:
        q, k, v = (cs.rand((BH, S, hd), torch.bfloat16, gen)
                   for _ in range(3))
        err = cs.max_err(flash_attention(q, k, v),
                         flash_attention_ref(q, k, v), cs.TOL["bfloat16"])
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            r = timed(cs, lambda: flash_attention(q, k, v), flush,
                      lambda: Fn.scaled_dot_product_attention(
                          q[None], k[None], v[None], is_causal=True))
        res[f"flash {label} BH={BH} S={S} hd={hd}"] = dict(r, max_abs_err=err)
        del q, k, v
    w = cs.rand((E, D, F), torch.float32, gen).mul_(D ** -0.5).to(
        torch.bfloat16)
    for label, C in GMM:
        x = cs.rand((E, C, D), torch.bfloat16, gen)
        err = cs.max_err(moe_gmm(x, w), moe_gmm_ref(x, w),
                         *cs.GMM_TOL["bfloat16"])
        res[f"moe_gmm {label} E={E} C={C} d={D} f={F}"] = dict(
            timed(cs, lambda: moe_gmm(x, w), flush, lambda: torch.bmm(x, w)),
            max_abs_err=err)
        del x
    del w
    first = [cs.PLENS[i % len(cs.PLENS)] for i in range(cs.MAX_BATCH)]
    lens = [p + cs.NEW_TOKENS // 2 for p in first]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    B, Smax, ps = cs.MAX_BATCH, cs.MAX_LEN, 128
    for label, H, KVH, hd in DECODE:
        q = cs.rand((B, H, hd), torch.bfloat16, gen)
        kc, vc = (cs.rand((B, Smax, KVH, hd), torch.bfloat16, gen)
                  for _ in range(2))
        shape = f"{label} B={B} H={H} KVH={KVH} hd={hd} S={Smax}"
        out = decode_attention(q, kc, vc, lengths, block_s=ps)
        valid = (torch.arange(Smax, device="cuda")[None, :]
                 < lengths[:, None])[:, None, None, :]
        kt, vt = kc.permute(0, 2, 1, 3), vc.permute(0, 2, 1, 3)
        gqa = {"enable_gqa": True} if H != KVH else {}
        err = cs.max_err(out, decode_attention_ref(q, kc, vc, lengths),
                         cs.TOL["bfloat16"])
        res[f"decode {shape}"] = dict(timed(
            cs, lambda: decode_attention(q, kc, vc, lengths, block_s=ps),
            flush, lambda: Fn.scaled_dot_product_attention(
                q[:, :, None], kt, vt, attn_mask=valid, **gqa)),
            max_abs_err=err)
        kp, table = cs.paged_layout(kc, ps, torch.Generator().manual_seed(5))
        vp = torch.full_like(kp, float("nan"))
        vp[table.reshape(-1).long()] = vc.reshape(-1, ps, KVH, hd)
        paged = paged_decode_attention(q, kp, vp, table, lengths)
        if not torch.equal(paged, out):
            raise SystemExit(f"{shape}: paged != contiguous")
        err = cs.max_err(paged, paged_decode_attention_ref(
            q, kp, vp, table, lengths), cs.TOL["bfloat16"])
        res[f"paged {shape} page_size={ps}"] = dict(timed(
            cs, lambda: paged_decode_attention(q, kp, vp, table, lengths),
            flush), max_abs_err=err)
        del q, kc, vc, kp, vp
    for S in SSD:
        B, nh, hp, ng, ds, chunk = 3, 64, 64, 1, 128, min(256, S)
        args = cs.ssd_inputs(B, S, nh, hp, ng, ds, torch.bfloat16, gen)
        y, st = ssd_scan(*args, chunk=chunk)
        y_ref, st_ref = ssd_scan_ref(*args, chunk=chunk)
        err = max(cs.max_err(y, y_ref, *cs.SSD_TOL["bfloat16"]),
                  cs.max_err(st, st_ref, *cs.SSD_TOL["bfloat16"]))
        res[f"ssd mamba2 B={B} S={S} chunk={chunk}"] = dict(
            timed(cs, lambda: ssd_scan(*args, chunk=chunk), flush),
            max_abs_err=err)
        del args, y, st, y_ref, st_ref
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", type=Path, help="the other checkout")
    ap.add_argument("--worker", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if args.base is None or not (args.base / "src" / "repro_torch").is_dir():
        ap.error("--base must be a checkout holding src/repro_torch")
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    trees = {"base": args.base.resolve(), "this": ROOT}
    runs = {"base": [], "this": []}
    for which in ("base", "this", "this", "base"):
        out = subprocess.run([sys.executable, __file__, "--worker",
                              str(trees[which])], capture_output=True,
                             text=True)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        runs[which].append(res)
        for shape, r in res.items():
            lib = (f", library {r['library_ms']:.4f} ms "
                   f"({r['library_ms_no_spin']:.4f})" if "library_ms" in r
                   else "")
            print(f"{which} ({trees[which]}) {shape}: kernel {r['ms']:.4f} ms"
                  f" ({r['ms_no_spin']:.4f} without the spin){lib}, max abs "
                  f"err {r['max_abs_err']:.3e}; {smi}", flush=True)
    print(smi)
    print(json.dumps({shape: {which: [r[shape] for r in runs[which]]
                              for which in runs}
                      for shape in runs["this"][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
