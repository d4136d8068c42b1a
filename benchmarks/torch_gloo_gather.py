#!/usr/bin/env python3
"""Time the gloo transport of a one-card world: an all-gather of a CUDA
slice between 2 ranks on the card, as ``parallel.collectives.all_gather``
moves it, beside its parts and beside the pageable staging it replaced.

    python3 benchmarks/torch_gloo_gather.py

The slice is a rank's half of qwen3-14b's ``head`` table under FSDP
storage at (data 2): (1, 2560, 151936) bf16, 0.78 GB, gathered along
dim 1 to 1.56 GB, which the fsdp phase of ``chip_smoke.py`` gathers on
every serving pass. Each line is the best of 3 host-clock times between
device syncs and a barrier: the port's ``all_gather``; the earlier
staging (pageable ``cpu()``, gloo, a host ``cat``, ``to("cuda")``); and
the parts: the device-to-host copy to pageable and to pinned memory,
gloo's exchange of host tensors, the host ``cat``, the host-to-device
copy. It checks that the port's result equals the earlier staging's bit
for bit, prints the card's name and power limit, and needs one card.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE, DIM = (1, 2560, 151936), 1


def best(fn, reps=3):
    """(the least seconds of ``reps`` calls of ``fn``, its last result)."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return min(times), out


def _rank(rank, mesh):
    from repro_torch.parallel.collectives import all_gather
    group = mesh.group("data")
    gen = torch.Generator(device="cuda").manual_seed(rank)
    x = torch.randn(SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
    host = x.cpu()
    parts = [torch.empty_like(host) for _ in range(2)]

    def pageable():
        h = x.cpu()
        got = [torch.empty_like(h) for _ in range(2)]
        dist.all_gather(got, h, group=group)
        return torch.cat(got, dim=DIM).to("cuda")

    out = {}
    out["all_gather"], new = best(lambda: all_gather(x, DIM, group))
    out["pageable staging"], old = best(pageable)
    out["d2h pageable"], _ = best(lambda: x.cpu())
    pinned = torch.empty(SHAPE, dtype=x.dtype, pin_memory=True)
    out["d2h pinned"], _ = best(lambda: pinned.copy_(x))
    out["gloo exchange"], _ = best(
        lambda: dist.all_gather(parts, host, group=group))
    out["host cat"], whole = best(lambda: torch.cat(parts, dim=DIM))
    out["h2d pageable"], _ = best(lambda: whole.to("cuda"))
    out["equal"] = bool(torch.equal(new, old))
    return out


def main():
    if not torch.cuda.is_available():
        print("torch_gloo_gather: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch.world import spawn_world
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    ranks = spawn_world(2, _rank, devices=["cuda:0", "cuda:0"])
    for r, res in enumerate(ranks):
        if not res.pop("equal"):
            print(f"rank {r}: all_gather differs from the pageable staging",
                  file=sys.stderr)
            return 1
        print(f"rank {r}: " + ", ".join(f"{k} {v:.4f} s"
                                        for k, v in res.items()))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
