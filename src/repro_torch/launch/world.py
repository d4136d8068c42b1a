"""Worlds of ranks: ``spawn_world(n, fn, *args, devices=...)``.

The reference needs no processes: one JAX program drives every device of
its mesh. The port's ranks are processes joined by ``torch.distributed``,
so this module has no counterpart in the JAX package. It is the one way
the port's training paths start a world: the launcher's ``--data`` and
``--model-axis``, the controller's segments across distinct devices and
the tests.

``spawn_world`` runs ``fn(rank, mesh, *args)`` in n processes through
``torch.multiprocessing.spawn`` and returns each rank's result, in rank
order. ``fn`` must be picklable (a module-level function) and its result
too; tensors in a result come back on the CPU. The backend follows a
fixed rule (``backend_for``): gloo on the CPU, gloo when two ranks share a
card (NCCL refuses that), NCCL when each rank has a card of its own. The
ranks meet through a file store in a fresh temporary directory, so two
worlds started at once (pytest-xdist workers, say) never share a
rendezvous. A rank that raises ends the world: ``spawn`` stops the other
ranks and raises in the caller.
"""
from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from repro_torch.models.lm import resolve_device


def rank_device(device) -> torch.device:
    """The device a rank runs on: a CPU device of any index is the CPU
    (tensors report plain ``cpu``), a card keeps its index."""
    device = torch.device(device)
    return torch.device("cpu") if device.type == "cpu" else device


def backend_for(devices) -> str:
    """gloo on the CPU or when two ranks share a card; NCCL when every
    rank has a card of its own."""
    devices = [torch.device(d) for d in devices]
    if any(d.type != "cuda" for d in devices):
        return "gloo"
    cards = [resolve_device(d) for d in devices]
    return "gloo" if len(set(cards)) < len(cards) else "nccl"


def _cpu_result(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu_result(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu_result(v) for v in x)
    return x


def _rank_main(rank, n, fn, args, devices, store, out, threads, model):
    from repro_torch.launch.mesh import make_mesh
    device = rank_device(devices[rank])
    if device.type == "cpu":
        torch.set_num_threads(threads)
    else:
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(devices), init_method=f"file://{store}",
                            rank=rank, world_size=n)
    try:
        mesh = make_mesh(n // model, model, device=device)
        result = fn(rank, mesh, *args)
        torch.save(_cpu_result(result), os.path.join(out, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_world(n: int, fn, *args, devices=None, model: int = 1) -> list:
    """Run ``fn(rank, mesh, *args)`` on n ranks and return their results.

    ``devices``: one per rank (``"cpu"``, ``"cpu:1"``, ``"cuda:0"``, ...);
    None gives rank r the card r modulo the cards, and raises without
    one. The mesh is (``data`` n / model, ``model`` model), built by
    ``launch.mesh.make_mesh`` on each rank's device; a caller that needs
    another layout builds it inside ``fn``, and so are the meshes of a
    ``train_loop``'s resizes: by every rank, in one order, before the
    loop starts (a mesh over some of the ranks too)."""
    if model < 1 or n % model:
        raise ValueError(f"spawn_world: {n} ranks do not divide into a "
                         f"model axis of {model}")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("spawn_world: no CUDA device; pass devices="
                               "['cpu'] * n to run the ranks on the CPU")
        devices = [f"cuda:{r % torch.cuda.device_count()}" for r in range(n)]
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f"spawn_world: {len(devices)} devices for {n} ranks")
    threads = max(1, (os.cpu_count() or 1) // n)
    work = tempfile.mkdtemp(prefix="repro_torch-world-")
    try:
        torch.multiprocessing.spawn(
            _rank_main, args=(n, fn, args, devices,
                              os.path.join(work, "store"), work, threads,
                              model),
            nprocs=n, join=True)
        return [torch.load(os.path.join(work, f"rank{r}.pt"),
                           weights_only=False) for r in range(n)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
