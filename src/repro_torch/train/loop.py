"""Fault-tolerant training loop: the HTC-TRE payload (``repro.train.loop``).

A job that (a) checkpoints on an interval, (b) survives injected failures
and preemptions by resuming from its newest checkpoint, and (c) honours
resize requests by checkpointing and re-entering.

With ``mesh`` the loop runs as one rank of the caller's world (every
rank calls it with the same arguments; ``launch.world.spawn_world``
starts such a world): the step is data-parallel over the batch axes
and split over ``model`` (``train.train_step``), each rank drawing the
whole init stream and keeping the slices it stores (under ``fsdp_tp``,
cut over the batch axes too), and checkpoints are saved whole by rank 0
(``train.checkpoint``). A resize re-enters on the loop's own devices:
its value is None or a mesh equal to the loop's. A resize to another
data extent needs a world of another size, which the controller's
segments start (``core.controller``); the loop does not.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import torch

from repro_torch.bridge import init_params, meta_params
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.models.lm import DTYPES, LM, resolve_device, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import TrainState
from repro_torch.train.train_step import (
    build_train_step, make_optimizer, model_split, zero_for)


class Preemption(Exception):
    """Injected node failure / preemption (tests + emulated cluster)."""


@dataclass
class LoopReport:
    steps_run: int = 0
    restarts: int = 0
    resizes: int = 0
    losses: list = field(default_factory=list)
    final_loss: float = float("nan")


def train_loop(
    rcfg,
    *,
    ckpt_dir: str,
    num_steps: int,
    ckpt_every: int = 50,
    batch_fn: Callable | None = None,
    fail_at: dict | None = None,
    resize_at: dict | None = None,
    max_restarts: int = 10,
    device=None,
    mesh=None,
) -> LoopReport:
    """Run (and re-run, on failure) the training job to ``num_steps`` on
    ``device`` (the card by default), or as one rank of ``mesh``
    (``launch.mesh.Mesh``, on its device).

    fail_at: {step: True}, raise Preemption *before* running that step.
    resize_at: {step: None or a mesh equal to ``mesh``}, checkpoint and
    re-enter at that step; another mesh raises ValueError.
    """
    device = resolve_device(mesh.device if device is None and mesh is not None
                            else device)
    fail_at = dict(fail_at or {})
    resize_at = dict(resize_at or {})
    for step, new in resize_at.items():
        if new is not None and (mesh is None or dict(new.shape)
                                != dict(mesh.shape)):
            raise ValueError(
                f"resize_at step {step}: a mesh other than the loop's own "
                f"({None if mesh is None else dict(mesh.shape)}); a resize "
                "to another data extent is a new world, which the "
                "controller's segments start (core.controller)")
    report = LoopReport()
    while True:
        try:
            _run_attempt(rcfg, ckpt_dir, num_steps, ckpt_every, device,
                         mesh, batch_fn, fail_at, resize_at, report)
            return report
        except Preemption:
            report.restarts += 1
            if report.restarts > max_restarts:
                raise


def _like(rcfg, mesh=None) -> TrainState:
    """A TrainState of meta tensors with the shapes and dtypes that this
    rank of ``mesh`` stores (None: the whole run's)."""
    params = meta_params(rcfg.model, mesh=mesh, parallel=rcfg.parallel)
    zero = zero_for(rcfg, mesh)
    moments = tree_map(lambda t: t.to(DTYPES[rcfg.moment_dtype]),
                       params if zero is None else zero.slice_tree(params))
    return TrainState(0, params, moments, moments)


def _start(rcfg, ckpt_dir, device, mesh=None):
    """(state, start step, step_fn) of a job entering on ``device``, as
    one rank of ``mesh`` if given: a fresh state from the run's seed (the
    same on every rank), or the newest checkpoint in ``ckpt_dir``
    restored there; the params and moments are the rank's slices over
    ``model`` under ``step_fn.split``, and the moments its ZeRO-1 slices
    of those under ``step_fn.zero`` (the params too under ``fsdp_tp``).
    ``step_fn`` steps an LM over that state's params.
    The loop's attempts and the controller's segments all enter here."""
    zero, split = zero_for(rcfg, mesh), model_split(rcfg, mesh)
    start = ckpt.latest_step(ckpt_dir)
    if start is None:
        gen = torch.Generator(device=device).manual_seed(rcfg.seed)
        state = make_optimizer(rcfg).init(init_params(
            rcfg.model, gen, device, mesh=mesh, parallel=rcfg.parallel),
            zero)
        start = 0
    else:
        state, start = ckpt.restore(ckpt_dir, _like(rcfg, mesh),
                                    device=device, zero=zero, split=split)
    lm = LM(rcfg.model, state.params, device=device)
    step_fn, _ = build_train_step(lm, rcfg, mesh)
    return state, start, step_fn


def _run_attempt(rcfg, ckpt_dir, num_steps, ckpt_every, device, mesh,
                 batch_fn, fail_at, resize_at, report):
    if batch_fn is None:
        batch_fn = synthetic_batches(rcfg, device, mesh)
    state, start, step_fn = _start(rcfg, ckpt_dir, device, mesh)
    save = dict(mesh=mesh, zero=step_fn.zero, split=step_fn.split)

    saved = None                  # the step of the last interval save
    for step in range(start, num_steps):
        if fail_at.pop(step, None):
            raise Preemption(f"injected failure at step {step}")
        if step in resize_at:
            resize_at.pop(step)
            ckpt.save(ckpt_dir, step, state, **save)
            report.resizes += 1
            # re-enter on the same devices; the restore re-places the state
            return _run_attempt(rcfg, ckpt_dir, num_steps, ckpt_every,
                                device, mesh, batch_fn, fail_at, resize_at,
                                report)
        state, metrics = step_fn(state, batch_fn(step))
        report.steps_run += 1
        report.losses.append(float(metrics["loss"]))
        if ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state, **save)
            saved = step + 1
    if saved != num_steps:
        # the final state, unless the interval has just written it
        ckpt.save(ckpt_dir, num_steps, state, **save)
    report.final_loss = report.losses[-1] if report.losses else float("nan")
