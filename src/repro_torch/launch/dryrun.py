"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) cell
on meta tensors, as one rank of a fake process group
(``repro.launch.dryrun``).

The reference lowers and compiles each cell for 512 forced host devices
and reads the per-device SPMD module: what a device holds, what it
computes and the collectives it makes. The port runs one rank's step for
real, through its own entry points (``launch.cells``), on the meta
device: shapes and dtypes without data. One rank stands for all, as the
reference's per-device module does. The process group is ``"fake"``
(``torch.testing._internal.distributed.fake_pg``): a collective
completes at once and moves nothing, standing for NCCL's transport by
default (``parallel.collectives.fake_backend``). Each cell records:

  - memory: argument, output, temp and peak bytes of the rank for one
    step (``launch.counter.StepCounter``), and the params, optimizer
    state, caches and batch it holds;
  - cost: the FLOPs it executes, torch's operations counted with
    ``torch.utils.flop_counter``'s formulas (``StepCounter``) and the
    kernels' by their ``cost`` (``kernels.ops.observed``);
  - kernels: calls, card launches (what ``ops.launch_counts`` would
    count), device kernels, FLOPs and bytes by kernel, and calls by
    ``ops`` function;
  - collectives: every collective it makes (``launch.comm_analysis``),
    summarized with the reference's ring wire model;
  - analytic: the reference's global MODEL/EXEC FLOPs and HBM bytes
    (``launch.flops``).

``launch.roofline`` derives H100 roofline terms from the artifacts. The
tests hold the record to real runs of the same cells over gloo; the card
check (``chip_smoke.py``'s dryrun phase) to the card's.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun       # all cells
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
      --shape train_4k --mesh pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import multiprocessing
import time
import traceback
from pathlib import Path

import torch.distributed as dist

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.kernels import ops
from repro_torch.launch.cells import build_cell, cell_applicable
from repro_torch.launch.comm_analysis import (
    collective_summary, record_collectives)
from repro_torch.launch.flops import cell_model
from repro_torch.launch.counter import StepCounter, storage_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.parallel.collectives import fake_backend

ARTIFACT_DIR = (Path(__file__).resolve().parents[3] / "artifacts"
                / "dryrun_torch")
MESH_RANKS = {"pod": 256, "multipod": 512}


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A ``"fake"`` default process group of ``world_size`` ranks with
    this process as ``rank``, destroyed on exit. Refuses when a process
    group is already initialized: the dry run never runs inside a real
    world."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "dry run starts its own fake one")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


class KernelRecord:
    """The calls of ``kernels.ops`` one step makes (``ops.observed``)."""

    def __init__(self):
        self.by_kernel: dict[str, dict] = {}
        self.by_op: dict[str, int] = {}

    def __call__(self, op: str, kernel: str, cost) -> None:
        self.by_op[op] = self.by_op.get(op, 0) + 1
        k = self.by_kernel.setdefault(kernel, dict(
            calls=0, launches=0, device_kernels=0, flops=0, bytes=0))
        k["calls"] += 1
        k["launches"] += int(cost.kernels > 0)
        k["device_kernels"] += cost.kernels
        k["flops"] += cost.total_flops
        k["bytes"] += cost.nbytes


def held_bytes(args: dict) -> dict:
    """Bytes of what the rank holds before a step (a cell's ``args``):
    params, the optimizer's moments, caches and the batch."""
    state = args.get("state")
    return {"params": storage_bytes(args["params"]),
            "state": storage_bytes(state.m, state.v) if state else 0,
            "caches": storage_bytes(args.get("caches", {})),
            "batch": storage_bytes(args["batch"])}


def record(step, args: dict, transport: str = "nccl"):
    """Run ``step()``, which reads the tensors of ``args`` ("params",
    "batch", optionally "state" and "caches"), under the recorders: on
    meta tensors the dry run, on real ones the same record of a real
    run. Returns (record, the step's outputs, the ``CollectiveOp``s in
    the order made). ``transport``: the backend a fake group stands for."""
    kernels = KernelRecord()
    held = held_bytes(args)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(fake_backend(transport))
        stack.enter_context(ops.observed(kernels))
        coll = stack.enter_context(record_collectives())
        live = stack.enter_context(StepCounter())
        out = step()
    secs = time.perf_counter() - t0
    total = sum(held.values())
    k_flops = sum(k["flops"] for k in kernels.by_kernel.values())
    rec = {
        "run_s": round(secs, 3),
        "memory": {"argument_bytes": total, "output_bytes": live.now,
                   "temp_bytes": live.peak - live.now,
                   "peak_bytes": total + live.peak, "held": held},
        "cost": {"flops": live.flops + k_flops,
                 "flops_torch": live.flops,
                 "flops_kernels": k_flops,
                 "kernel_bytes": sum(k["bytes"]
                                     for k in kernels.by_kernel.values())},
        "kernels": kernels.by_kernel,
        "ops": kernels.by_op,
        "collectives": collective_summary(coll.ops),
    }
    return rec, out, coll.ops


def run_cell(arch: str, shape_name: str, mesh_name: str, parallel=None,
             rank: int = 0) -> dict:
    """The artifact of one cell: rank ``rank`` of the production mesh
    ``mesh_name`` ("pod" 16 x 16, "multipod" 2 x 16 x 16) under a fake
    process group."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": why}
    n = MESH_RANKS[mesh_name]
    t0 = time.perf_counter()
    with fake_world(n, rank):
        mesh = make_production_mesh(multi_pod=mesh_name == "multipod",
                                    device="meta")
        cell = build_cell(arch, shape_name, mesh, parallel)
        build_s = time.perf_counter() - t0
        rec, _, _ = record(cell.step, cell.args)
    m = cell_model(cfg, shape, cell.parallel)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "status": "ok", "n_devices": n, "rank": rank,
            "parallel": dataclasses.asdict(cell.parallel),
            "build_s": round(build_s, 3), **rec,
            "param_count": cfg.param_count(),
            "param_count_active": cfg.param_count(active=True),
            "analytic": dataclasses.asdict(m)}


def save_artifact(art: dict) -> Path:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    path = ARTIFACT_DIR / f"{art['arch']}__{art['shape']}__{art['mesh']}.json"
    path.write_text(json.dumps(art, indent=1))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=list(ARCHS), nargs="*")
    ap.add_argument("--shape", default=None, choices=list(SHAPES), nargs="*")
    ap.add_argument("--mesh", default=None, choices=list(MESH_RANKS),
                    nargs="*")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in a process of its own")
    args = ap.parse_args(argv)
    cells = [(a, s, m) for a in args.arch or list(ARCHS)
             for s in args.shape or list(SHAPES)
             for m in args.mesh or list(MESH_RANKS)]
    if args.list:
        for c in cells:
            print(*c)
        return 0
    n_ok = n_skip = n_fail = 0
    t0 = time.perf_counter()
    if args.jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(args.jobs, maxtasksperchild=1) as pool:
            arts = pool.imap(_artifact, cells)
            for cell, art in zip(cells, arts):
                n = _report(cell, art)
                n_ok, n_skip, n_fail = n_ok + n[0], n_skip + n[1], n_fail + n[2]
    else:
        for cell in cells:
            n = _report(cell, _artifact(cell))
            n_ok, n_skip, n_fail = n_ok + n[0], n_skip + n[1], n_fail + n[2]
    print(f"\n{n_ok} ok, {n_skip} skipped, {n_fail} failed of {len(cells)} "
          f"cells ({time.perf_counter() - t0:.1f} s)")
    return 1 if n_fail else 0


def _artifact(cell) -> dict:
    """The saved artifact of one (arch, shape, mesh) cell, a failure's
    included."""
    arch, shape, mesh_name = cell
    try:
        art = run_cell(arch, shape, mesh_name)
    except Exception as e:  # a failure here is a port bug
        art = {"arch": arch, "shape": shape, "mesh": mesh_name,
               "status": "failed", "error": f"{type(e).__name__}: {e}",
               "traceback": traceback.format_exc()}
    save_artifact(art)
    return art


def _report(cell, art) -> tuple[int, int, int]:
    """Print one cell's line; (ok, skipped, failed) counts."""
    arch, shape, mesh_name = cell
    tag = f"{arch:22s} {shape:12s} {mesh_name:9s}"
    if art["status"] == "failed":
        print(f"{tag} FAILED  {art['error']}", flush=True)
        return 0, 0, 1
    if art["status"] == "skipped":
        print(f"{tag} skipped ({art['reason'][:50]})", flush=True)
        return 0, 1, 0
    m, c = art["memory"], art["collectives"]
    wire = c["wire_bytes_intra_pod"] + c["wire_bytes_cross_pod"]
    print(f"{tag} ok  {art['run_s']:8.2f}s "
          f"peak={m['peak_bytes'] / 2**30:8.2f}GiB "
          f"args={m['argument_bytes'] / 2**30:8.2f}GiB "
          f"flops={art['cost']['flops']:.2e} wire={wire / 2**30:.2f}GiB",
          flush=True)
    return 1, 0, 0


if __name__ == "__main__":
    raise SystemExit(main())
