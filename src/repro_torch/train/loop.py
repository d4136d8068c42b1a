"""Fault-tolerant elastic training loop: the HTC-TRE payload
(``repro.train.loop``).

A job that (a) checkpoints on an interval, (b) survives injected failures
and preemptions by resuming from its newest checkpoint, and (c) honours
elastic resize requests: at a resize step it checkpoints, changes its
mesh and goes on from that checkpoint, which is sharding-agnostic.

With ``mesh`` the loop runs as one rank of the caller's world: every rank
of the world calls it with the same arguments (``launch.world.
spawn_world`` starts such a world). The step is data-parallel over the
batch axes and split over ``model`` (``train.train_step``), each rank
drawing the whole init stream and keeping the slices it stores (under
``fsdp_tp``, cut over the batch axes too), and the mesh's first rank
writes the checkpoints whole (``train.checkpoint``).

A resize goes to another mesh of the same world (``launch.mesh.Mesh``
over all or some of its ranks: another ``pod``, ``data`` or ``model``
extent), or to None: the world's rank 0 alone, with no mesh, the
reference's one device. Every rank builds the resize meshes, in one
order, before it calls the loop. At a resize the current mesh's ranks
save together, the whole world meets, and the new mesh's ranks restore
that checkpoint with their own cuts. A rank outside the active mesh
holds no training state: it drops its params, moments, LM, step and
batch function and waits at the next meeting, where it learns where the
active ranks stopped and walks the same ``fail_at`` and ``resize_at`` to
that step, so every rank agrees which mesh is active. A ``Preemption``
restarts the job on the loop's first mesh from the newest checkpoint, as
the reference's retry does; resizes already taken are not taken again.

The meetings are collectives of a gloo group over the world that the
loop makes for itself, with ``WAIT_TIMEOUT`` as its timeout, and not of
the world's own group: an idle rank waits there for the whole of the
active ranks' segment, which may outlast the world's default timeout
(under NCCL a barrier would also time out and keep the idle card
polling), and gloo waits on the host. The store would serve as well,
but only through a private accessor.
"""
from __future__ import annotations

import gc
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.bridge import init_params, meta_params
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.launch.mesh import Mesh
from repro_torch.models.lm import DTYPES, LM, resolve_device, tree_map
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import TrainState
from repro_torch.train.train_step import (
    build_train_step, check_data_mesh, make_optimizer, model_split,
    zero_for)

# how long a rank outside the active mesh waits for the next meeting:
# longer than any segment of this repo's jobs
WAIT_TIMEOUT = timedelta(hours=24)


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
    (``launch.mesh.Mesh``, on its device) in the world that built it.

    fail_at: {step: True}, raise Preemption *before* running that step.
    resize_at: {step: a mesh or None}, checkpoint at that step and go on
    on that mesh of the loop's world or, with None, on the world's rank 0
    alone. With no world (``mesh`` None), None re-enters on ``device`` and
    a mesh raises ValueError. A mesh of another world, or one the run
    cannot take, raises ValueError before step 0.

    Rank 0's report holds every step the job ran, in the reference's
    order; another rank's holds the steps it ran. ``resizes`` and
    ``restarts`` are the job's on every rank.
    """
    fail_at = dict(fail_at or {})
    resize_at = dict(resize_at or {})
    if mesh is None:
        device = resolve_device(device)
        for step, new in resize_at.items():
            if new is not None:
                raise ValueError(
                    f"resize_at step {step}: a mesh given to a loop with no "
                    "world (mesh=None); a job that resizes across ranks "
                    "passes its first mesh as mesh=")
        meetings = None
    else:
        device = resolve_device(mesh.device if device is None else device)
        _check_mesh("the loop's", mesh, rcfg)
        for step, new in resize_at.items():
            if new is not None:
                _check_mesh(f"resize_at step {step}:", new, rcfg)
        meetings = _Meetings()
    report = LoopReport()
    try:
        while True:
            try:
                _run_attempt(rcfg, ckpt_dir, num_steps, ckpt_every, device,
                             mesh, batch_fn, fail_at, resize_at, report,
                             meetings)
                break
            except Preemption:
                report.restarts += 1
                if report.restarts > max_restarts:
                    raise
    finally:
        if meetings is not None:
            meetings.close()
    report.final_loss = report.losses[-1] if report.losses else float("nan")
    return report


def _check_mesh(what, mesh, rcfg):
    """Raise ValueError, naming ``what``, for a mesh that is not one of
    this world's or that the run cannot take."""
    if not isinstance(mesh, Mesh) or mesh.world_group is not dist.group.WORLD:
        raise ValueError(
            f"{what} mesh {getattr(mesh, 'shape', mesh)} is a mesh of another"
            " world: every rank builds the loop's meshes in this world, in "
            "one order (launch.mesh.make_mesh)")
    try:
        check_data_mesh(mesh, rcfg.parallel)
    except ValueError as e:
        raise ValueError(f"{what} mesh {mesh.shape}: {e}") from None


class _Meetings:
    """The loop's meetings of the whole world, in a gloo group made for
    them (see the module docstring for why)."""

    def __init__(self):
        self.group = dist.new_group(backend="gloo", timeout=WAIT_TIMEOUT)

    def meet(self, leader: int, record):
        """Every rank's ``record`` (start, outcome, losses) of the segment
        that ends here, None from a rank outside it; returns rank
        ``leader``'s, after checking that every rank of the segment
        stopped where it did."""
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, record, group=self.group)
        want = got[leader]
        for r, rec in enumerate(got):
            if rec is not None and rec[:2] != want[:2]:
                raise RuntimeError(
                    f"rank {r} ran steps {rec[:2]}, rank {leader} "
                    f"{want[:2]}: the ranks were given different schedules")
        return want

    def close(self):
        dist.destroy_process_group(self.group)


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


def _event(step, fail_at, resize_at):
    """What comes before ``step``: "fail", "resize", or None to run it.
    A ``fail_at`` entry is used up when passed, as the reference's is."""
    if fail_at.pop(step, None):
        return "fail"
    return "resize" if step in resize_at else None


def _run_attempt(rcfg, ckpt_dir, num_steps, ckpt_every, device, mesh,
                 batch_fn, fail_at, resize_at, report, meetings):
    """One attempt: from the newest checkpoint on ``mesh``, the loop's
    first, through each resize to ``num_steps``, or to a Preemption. Each
    segment ends in a meeting of the world when there is one."""
    on, rank = mesh, dist.get_rank() if meetings is not None else 0
    while True:
        if meetings is None or rank in (on.ranks if on is not None
                                        else (0,)):
            here = device if on is None else on.device
            record = _segment(rcfg, ckpt_dir, num_steps, ckpt_every, here,
                              on, batch_fn, fail_at, resize_at)
            losses = record[2]
        else:
            # outside the active mesh: the last segment's state is gone,
            # and so is the cache that held it
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
            record, losses = None, []
        if meetings is not None:
            start, outcome, theirs = meetings.meet(
                0 if on is None else on.ranks[0], record)
            if record is None:
                walked = _walk(start, num_steps, fail_at, resize_at)
                if walked != outcome:
                    raise RuntimeError(
                        f"rank {rank} walks to {walked} from step {start}, "
                        f"the active ranks stopped at {outcome}: the ranks "
                        "were given different schedules")
                if rank == 0:
                    losses = theirs
        else:
            outcome = record[1]
        report.losses += losses
        report.steps_run += len(losses)
        kind, step = outcome
        if kind == "fail":
            raise Preemption(f"injected failure at step {step}")
        if kind == "end":
            return
        on = resize_at.pop(step)
        report.resizes += 1


def _walk(start, num_steps, fail_at, resize_at):
    """The outcome a segment from ``start`` reaches, without its steps."""
    for step in range(start, num_steps):
        if kind := _event(step, fail_at, resize_at):
            return kind, step
    return "end", num_steps


def _segment(rcfg, ckpt_dir, num_steps, ckpt_every, device, mesh, batch_fn,
             fail_at, resize_at):
    """Run from the newest checkpoint on ``device`` (as one rank of
    ``mesh``, if given) to the next event; returns (start step, outcome,
    losses), the outcome ("fail" | "resize" | "end", step). A resize saves
    before it returns, the end saves the final state; what the segment
    held goes with it."""
    if batch_fn is None:
        batch_fn = synthetic_batches(rcfg, device, mesh)
    state, start, step_fn = _start(rcfg, ckpt_dir, device, mesh)
    save = dict(mesh=mesh, zero=step_fn.zero, split=step_fn.split)
    saved, losses = None, []      # the step of the last save
    for step in range(start, num_steps):
        if kind := _event(step, fail_at, resize_at):
            if kind == "resize" and saved != step:
                ckpt.save(ckpt_dir, step, state, **save)
            return start, (kind, step), losses
        state, metrics = step_fn(state, batch_fn(step))
        losses.append(float(metrics["loss"]))
        if ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, state, **save)
            saved = step + 1
    if saved != num_steps:
        # the final state, unless the interval has just written it
        ckpt.save(ckpt_dir, num_steps, state, **save)
    return start, ("end", num_steps), losses
