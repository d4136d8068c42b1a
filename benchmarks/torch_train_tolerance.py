#!/usr/bin/env python3
"""How far fp32 rounding alone moves the port's training gradients, and
whether the gradient tolerance of ``tests/test_torch_train_parity.py`` and
``chip_smoke.py`` still sees a real fault.

    PYTHONPATH=src python benchmarks/torch_train_tolerance.py

On the CPU, for the Mamba2 stacks of jamba-1.5-large's smoke config (8,
16 and 32 layers) and mamba2-1.3b's (2, 4, 8 and 16 layers), from seeded
weights and one synthetic batch (seq 64, batch 2), fp32:

- ``order``: the gradients of one run against those of a run that differs
  only in the order of its fp32 sums (the SSD chunk halved, the attention
  chunks 32 -> 16): the same function, other roundings;
- ``bf16 ssd``: a planted fault, the SSD scan's inputs rounded to bf16 in
  every Mamba2 layer;
- ``leaf x (1+1e-3)``: a planted fault, one leaf's gradient (the
  embedding's) scaled by 1.001.

For each it prints the worst |difference| as a share of its leaf's scale
max(1, the leaf's largest |gradient|), and the worst difference over the
bound rtol 1e-4 + atol x scale for the two atols the checks use: 1e-6
(dense stacks) and 1e-4 (deep Mamba2 stacks). A reading at or below 1
passes the check, above 1 fails it. The last line is one JSON object with
every reading.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ParallelConfig, RunConfig, ShapeConfig, get_smoke_config)
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.lm import LM, tree_leaves  # noqa: E402

RTOL = 1e-4
ATOLS = {"dense": 1e-6, "deep ssm": 1e-4}
STACKS = (("jamba-1.5-large-398b", (8, 16, 32)),
          ("mamba2-1.3b", (2, 4, 8, 16)))
SHAPE = ShapeConfig("tolerance", "train", 64, 2)


def grads(cfg, parallel, seed):
    params = init_params(cfg, torch.Generator().manual_seed(seed), "cpu")
    paths, leaves = zip(*tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    lm = LM(cfg, params, device="cpu")
    batch = synthetic_batches(RunConfig(model=cfg, shape=SHAPE,
                                        parallel=parallel), "cpu")(0)
    loss, _ = lm.loss(batch, parallel)
    return dict(zip(paths, torch.autograd.grad(loss, leaves)))


def compare(ref, out):
    """(worst |diff| / scale, {kind: worst diff / bound}) over all leaves."""
    share, ratios = 0.0, dict.fromkeys(ATOLS, 0.0)
    for path, r in ref.items():
        scale = max(1.0, r.abs().max().item())
        err = (out[path] - r).abs()
        share = max(share, err.max().item() / scale)
        for kind, atol in ATOLS.items():
            bound = RTOL * r.abs() + atol * scale
            ratios[kind] = max(ratios[kind], (err / bound).max().item())
    return share, ratios


def bf16_ssd():
    """Patch ``ssm.ssd_chunked`` to round its inputs to bf16; returns the
    undo."""
    orig = ssm.ssd_chunked

    def rounded(xh, dt, A, Bg, Cg, chunk, state0=None):
        r = [t.to(torch.bfloat16).to(t.dtype) for t in (xh, dt, Bg, Cg)]
        return orig(r[0], r[1], A, r[2], r[3], chunk, state0)

    ssm.ssd_chunked = rounded
    return lambda: setattr(ssm, "ssd_chunked", orig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    torch.manual_seed(args.seed)
    base = ParallelConfig(attn_q_chunk=32, attn_kv_chunk=32)
    other = ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16)
    rows = []
    for arch, depths in STACKS:
        smoke = get_smoke_config(arch)
        for depth in depths:
            cfg = dataclasses.replace(smoke, n_layers=depth, dtype="float32")
            ref = grads(cfg, base, args.seed)
            reorder = grads(dataclasses.replace(
                cfg, ssm_chunk=cfg.ssm_chunk // 2), other, args.seed)
            undo = bf16_ssd()
            try:
                low = grads(cfg, base, args.seed)
            finally:
                undo()
            leaf = dict(ref)
            leaf["embed"] = leaf["embed"] * (1 + 1e-3)
            for fault, out in (("order", reorder), ("bf16 ssd", low),
                               ("leaf x (1+1e-3)", leaf)):
                share, ratios = compare(ref, out)
                rows.append({"arch": arch, "layers": depth, "against": fault,
                             "worst_share_of_scale": share,
                             "worst_over_bound": ratios})
                print(f"{arch} {depth:2d} layers, {fault:16s}: worst "
                      f"|diff| {share:.3e} of scale; / bound: "
                      + ", ".join(f"atol {ATOLS[k]:g} {v:.3f}"
                                  for k, v in ratios.items()), flush=True)
    print(json.dumps({"rtol": RTOL, "atols": ATOLS, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
