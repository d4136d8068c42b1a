#!/usr/bin/env python3
"""Time this checkout's flash_attention and moe_gmm kernels beside another
checkout's, on one card, with ``chip_smoke.py``'s timer.

    python3 benchmarks/torch_kernel_ab.py --base DIR

DIR is another checkout of the repo, for example the parent commit
unpacked with ``git archive`` under ``build/``. The script runs four
processes in turn, the base, this tree, this tree, the base, each building
and timing its own tree's kernels on the same inputs (seeded), so a
difference between the trees is told from drift over the call.

Shapes are those of ``chip_smoke.py``'s serve phase, bf16: flash at the
largest prefill group of musicgen-large (BH 2 x 32, S 512, hd 64) and of
arctic-480b (BH 2 x 56, S 512, hd 128), causal; moe_gmm at arctic's decode
step (E 128, C 1, d 7168 -> f 4864) and largest prefill group (C 30), every
row filled (the contract both trees share). Each kernel is timed twice:
with ``time_ms``'s spin kernel (device time only) and without it (event to
event with the wrapper's host time in between, the timer of the first two
slices). SDPA's flash backend and ``torch.bmm`` are timed beside, as a
yardstick of the card.

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


def worker(tree: Path) -> dict:
    """Times of ``tree``'s kernels; runs in its own process."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(1, str(ROOT))
    import torch
    import torch.nn.functional as Fn
    from torch.nn.attention import SDPBackend, sdpa_kernel

    import chip_smoke as cs
    import repro_torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.ref import flash_attention_ref, moe_gmm_ref

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
        err = cs.max_err(flash_attention(q, k, v), flash_attention_ref(q, k, v),
                         cs.TOL["bfloat16"])
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            lib = [cs.time_ms(lambda: Fn.scaled_dot_product_attention(
                q[None], k[None], v[None], is_causal=True), flush, spin=sp)
                for sp in (True, False)]
        res[f"flash {label} BH={BH} S={S} hd={hd}"] = dict(
            ms=cs.time_ms(lambda: flash_attention(q, k, v), flush),
            ms_no_spin=cs.time_ms(lambda: flash_attention(q, k, v), flush,
                                  spin=False),
            library_ms=lib[0], library_ms_no_spin=lib[1], max_abs_err=err)
        del q, k, v
    w = cs.rand((E, D, F), torch.float32, gen).mul_(D ** -0.5).to(
        torch.bfloat16)
    for label, C in GMM:
        x = cs.rand((E, C, D), torch.bfloat16, gen)
        err = cs.max_err(moe_gmm(x, w), moe_gmm_ref(x, w), *cs.GMM_TOL[
            "bfloat16"])
        res[f"moe_gmm {label} E={E} C={C} d={D} f={F}"] = dict(
            ms=cs.time_ms(lambda: moe_gmm(x, w), flush),
            ms_no_spin=cs.time_ms(lambda: moe_gmm(x, w), flush, spin=False),
            library_ms=cs.time_ms(lambda: torch.bmm(x, w), flush),
            library_ms_no_spin=cs.time_ms(lambda: torch.bmm(x, w), flush,
                                          spin=False),
            max_abs_err=err)
        del x
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
            print(f"{which} ({trees[which]}) {shape}: kernel {r['ms']:.4f} ms"
                  f" ({r['ms_no_spin']:.4f} without the spin), library "
                  f"{r['library_ms']:.4f} ms ({r['library_ms_no_spin']:.4f}),"
                  f" max abs err {r['max_abs_err']:.3e}; {smi}", flush=True)
    print(smi)
    print(json.dumps({shape: {which: [r[shape] for r in runs[which]]
                              for which in runs}
                      for shape in runs["this"][0]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
