"""Cell construction: (architecture x input shape x mesh) -> one rank's
step (``repro.launch.cells``).

A *cell* bundles what the dry run (``launch.dryrun``) runs: one rank's
step through the port's own entry points (``build_train_step``,
``LM.prefill`` + argmax, ``LM.decode`` + argmax) and the arguments it
runs on. On the meta device (the default) the arguments are meta
tensors of the shapes this rank holds (``bridge.meta_params`` with the
mesh, the optimizer's moments, ``LM.cache_shapes``,
``data.synthetic.input_specs``), so no memory is allocated for any
full-size config; on a real device they are drawn from a seed, so the
tests hold the dry run to a real run of the same cell. A serving cell
holds and computes the rank's rows of its batch where the batch divides
over the batch axes (``Runtime.rows``; ``long_500k``'s one row stays
whole), its caches too; a train step takes the global batch and cuts its
rows itself.

The policy (``FSDP_THRESHOLD_BYTES``, ``LONG_OK_FAMILIES``,
``default_parallel``, ``cell_applicable``) is the reference's, copied.
The reference's trip counts (``_attn_trips``, ``scan_trips``) undo XLA
counting a ``while`` body once; the port executes every iteration and
its records count each call as made, so they are dropped.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.bridge import init_params, meta_params
from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import (
    ModelConfig, ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.data.synthetic import input_specs, synthetic_batches
from repro_torch.models.lm import LM, Runtime
from repro_torch.parallel.collectives import gather_rows
from repro_torch.parallel.sharding import batch_axes
from repro_torch.train.train_step import build_train_step

# param bytes above which storage goes FSDP (gather-per-layer)
FSDP_THRESHOLD_BYTES = 100e9

# archs whose full-attention makes long_500k meaningless (skip per spec)
LONG_OK_FAMILIES = ("ssm", "hybrid")


def default_parallel(cfg: ModelConfig, shape: ShapeConfig,
                     mesh=None) -> ParallelConfig:
    """The reference's per-cell parallel config: ``fsdp_tp`` past
    ``FSDP_THRESHOLD_BYTES`` of bf16 params, ZeRO-1, remat per block in
    training, microbatches of one row a data rank up to 16 (4 for FSDP
    MoE models, whose experts re-gather every microbatch), ring attention
    at prefill. ``mesh`` needs only ``axis_names`` and ``shape``."""
    param_bytes = cfg.param_count() * 2
    strategy = "fsdp_tp" if param_bytes > FSDP_THRESHOLD_BYTES else "tp"
    micro = 1
    if shape.kind == "train" and mesh is not None:
        rows = shape.global_batch
        for a in batch_axes(mesh):
            rows //= mesh.shape[a]
        cap = 4 if (strategy == "fsdp_tp" and cfg.moe) else 16
        micro = max(1, min(rows, cap))
        while rows % micro:
            micro -= 1
    ring = shape.kind == "prefill"
    return ParallelConfig(
        strategy=strategy,
        zero1=True,
        remat="block" if shape.kind == "train" else "none",
        microbatches=micro,
        attn_q_chunk=512,
        attn_kv_chunk=1024,
        attn_impl="masked",
        attn_seq_parallel=ring,
    )


def cell_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    if shape.name == "long_500k" and cfg.family not in LONG_OK_FAMILIES:
        return False, "pure full-attention arch: 524k cell skipped per shape rules"
    return True, ""


@dataclass
class Cell:
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    parallel: ParallelConfig
    args: dict            # "params", "state" (train), "caches" (decode), "batch"
    step: Callable[[], Any]   # one step on ``args``; returns its outputs


def _batch(cfg, shape, rcfg, device, seed: int, mesh, rows):
    """The step's batch: meta specs, or a seeded synthetic batch (decode:
    each row's first token, lengths inside the cache). A train step takes
    the global batch (its step cuts its rows); a serving step this rank's
    ``rows`` (``Runtime.rows``; None: the whole batch)."""
    serving = shape.kind != "train"
    if device.type == "meta":
        return input_specs(cfg, shape, mesh if serving else None)
    full = synthetic_batches(rcfg, device)(seed)
    if not serving:
        return full
    mine = rows[0] if rows else slice(None)
    if shape.kind == "prefill":
        return {k: v[mine] for k, v in full.items()
                if k in ("tokens", "patches")}
    B, S = shape.global_batch, shape.seq_len
    return {"tokens": full["tokens"][mine, :1],
            "lengths": ((torch.arange(B) * 7 + S // 2) % S).to(
                device, torch.int32)[mine]}


def build_cell(arch: str, shape_name: str, mesh=None,
               parallel: ParallelConfig | None = None, *,
               cfg: ModelConfig | None = None,
               shape: ShapeConfig | None = None, device=None,
               seed: int = 0) -> Cell:
    """One rank's step of the cell on ``mesh`` (``launch.mesh.Mesh``;
    None: one rank), on ``device`` (the mesh's; "meta" without a mesh).
    ``cfg`` and ``shape`` replace the arch's config and the named shape
    (the tests' smoke cells); ``parallel`` replaces ``default_parallel``.
    A real device draws the params from ``seed`` (``bridge.init_params``)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    parallel = parallel or default_parallel(cfg, shape, mesh)
    if device is None:
        device = mesh.device if mesh is not None else "meta"
    device = torch.device(device)
    if device.type == "meta":
        params = meta_params(cfg, mesh=mesh, parallel=parallel)
    else:
        params = init_params(cfg, torch.Generator(device).manual_seed(seed),
                             device, mesh=mesh, parallel=parallel)
    lm = LM(cfg, params, device=device)
    rt = Runtime(parallel, mesh)
    rcfg = RunConfig(model=cfg, shape=shape, parallel=parallel, seed=seed)
    rows = rt.rows(shape.global_batch)
    batch = _batch(cfg, shape, rcfg, device, seed, mesh, rows)
    args = {"params": params, "batch": batch}

    if shape.kind == "train":
        step_fn, opt = build_train_step(lm, rcfg, mesh)
        state = opt.init(params, step_fn.zero)
        args["state"] = state

        def step():
            return step_fn(state, batch)
    elif shape.kind == "prefill":
        def step():
            logits, caches = lm.prefill(batch, rt, rows=rows)
            return torch.argmax(logits, dim=-1), caches
    else:  # decode: one token against a cache of capacity seq_len
        S = shape.seq_len
        window = rt.seq_window(cfg, S)
        caches = lm.init_cache(batch["lengths"].shape[0], S if window is None
                               else window[1] - window[0], rt)
        args["caches"] = caches

        def step():
            logits, new = lm.decode(batch["tokens"], batch["lengths"],
                                    caches, rt=rt, rows=rows)
            # every rank's greedy ids, as the engine gathers them
            return gather_rows(torch.argmax(logits, dim=-1),
                               rows[1] if rows else None), new

    return Cell(arch=arch, shape=shape, cfg=cfg, parallel=parallel,
                args=args, step=step)
