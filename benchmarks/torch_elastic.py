"""Mix D on the port's live ``ElasticController``: the paper's DSP
policies growing, shrinking and preempting real training jobs, and what
that elasticity costs an HTC provider in checkpoint I/O.

Mix D: ``MgmtPolicy.htc(1, 1.0)`` under ``ProvisionService(capacity=4)``
on a pool of 4 slots of one device, 3 steps a tick, a release check every
5 ticks, elastic growth on; ``train-0`` (1 node, 12 steps) is submitted
before tick 1 and preempted in tick 2, ``train-1`` (2 nodes, 9 steps) is
submitted before tick 3. It covers the initial grant, a DR grant, grows
and shrinks of a running job, a restart from a checkpoint and the final
destroy. Both jobs train the same ``RunConfig``.

``elastic_row`` runs the mix three times: on a stub segment that trains
nothing (the decisions do not depend on the work), the jobs'
``RunConfig`` straight through ``train_loop`` with no fault, and on the
live controller with each segment's phases timed. The live run's
decisions must equal the stub's, and each job's losses the straight
run's, bit for bit: ``train-0`` runs step 3 twice (its preempted segment
ran step 3 and died before step 4; the next one restored the step-3
checkpoint), and both copies must equal the straight run's step 3.
``chip_smoke.py``'s elastic phase runs it on the card over a 2-layer cut
of musicgen-large at published widths, ``tests/test_torch_controller.py``
on the CPU over qwen2-7b's smoke config; ``run_mix`` and
``stub_controller`` take either package's classes, and the test runs the
reference's controller on the same mix.
"""
from __future__ import annotations

import os
import time
from types import SimpleNamespace

import torch

from repro_torch.core import controller as port_controller
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provision import ProvisionService
from repro_torch.models.lm import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import train_loop

#: the port's classes, as ``run_mix`` takes them
PORT = SimpleNamespace(ElasticController=port_controller.ElasticController,
                       TrainTask=port_controller.TrainTask,
                       MgmtPolicy=MgmtPolicy, ProvisionService=ProvisionService)
POOL, CAPACITY, STEPS_PER_TICK, TICKS_PER_RELEASE = 4, 4, 3, 5
#: (job, nodes, steps, submitted before tick)
JOBS = (("train-0", 1, 12, 1), ("train-1", 2, 9, 3))
#: tick -> the job preempted in it
PREEMPT = {2: "train-0"}
#: job -> the step it runs twice
REPLAYED = {"train-0": 3}
MAX_TICKS = 50


def stub_controller(base):
    """``base`` (either package's ``ElasticController``) with a segment
    that trains nothing: it advances ``steps_per_tick`` steps, and a
    preempted segment of two or more steps counts a restart and advances
    none, as the live segment does."""
    class StubSegment(base):
        def _run_segment(self, task, fail=False):
            end = min(task.steps_done + self.steps_per_tick, task.num_steps)
            if fail and end - task.steps_done >= 2:
                task.restarts += 1
                return
            task.steps_done = end
    return StubSegment


def run_mix(core, rcfg, ckpt_root, devices, controller_cls=None):
    """Mix D through ``core``'s classes (``ElasticController``,
    ``TrainTask``, ``MgmtPolicy``, ``ProvisionService`` of one package),
    ticked as ``run`` ticks, then destroyed. Returns (controller,
    provision)."""
    prov = core.ProvisionService(capacity=CAPACITY)
    ctl = (controller_cls or core.ElasticController)(
        policy=core.MgmtPolicy.htc(1, 1.0), provision=prov, tre_name="mix-d",
        devices=devices, steps_per_tick=STEPS_PER_TICK,
        ticks_per_release=TICKS_PER_RELEASE, elastic_grow=True)
    pending = [(at, core.TrainTask(name, rcfg, nodes=n, num_steps=steps,
                                   ckpt_dir=os.path.join(ckpt_root, name)))
               for name, n, steps, at in JOBS]
    while pending or ctl.queue or ctl.running or ctl._done_last_tick:
        if ctl._tick >= MAX_TICKS:
            raise RuntimeError(f"mix D still running after {MAX_TICKS} ticks")
        k = ctl._tick + 1
        for at, task in [p for p in pending if p[0] == k]:
            ctl.submit(task)
        pending = [p for p in pending if p[0] != k]
        ctl.tick(fail_task=PREEMPT.get(k))
    ctl._flush_done(reschedule=False)
    ctl.destroy()
    return ctl, prov


def decisions(ctl, prov) -> dict:
    """What the control plane decided: provision deltas (grants, releases,
    the destroy), finish order, per job (steps, resizes, restarts), ticks
    and the nodes still allocated."""
    return {"deltas": [e.delta for e in prov.adjust_events],
            "order": [t.name for t in ctl.finished],
            "jobs": {t.name: [t.steps_done, t.resizes, t.restarts]
                     for t in ctl.finished},
            "ticks": ctl._tick, "allocated": prov.total_allocated}


def expected_losses(straight) -> dict:
    """Each job's losses under mix D from an uninterrupted run's."""
    out = {}
    for name, _, steps, _ in JOBS:
        r = REPLAYED.get(name)
        out[name] = (straight[:steps] if r is None
                     else straight[:r + 1] + straight[r:steps])
    return out


class TimedController(PORT.ElasticController):
    """The port's controller with each segment timed: the two calls its
    ``_run_segment`` makes into other modules, the entry
    (``train.loop._start``: init or restore, LM and step built) and the
    checkpoint save, are wrapped for the segment's length, each ending in
    a device sync; the steps take the rest of its wall. Each segment
    leaves a record in ``segments``, with the device memory still
    allocated after it (``resident``, the card only)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.segments = []

    def _run_segment(self, task, fail=False):
        dev = self.devices[0]
        start, save = port_controller._start, port_controller.ckpt.save
        seg = {"job": task.name, "fresh": ckpt.latest_step(task.ckpt_dir)
               is None, "save_s": None}
        n0 = len(task.losses)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed_start(*a):
            t0 = time.perf_counter()
            out = start(*a)
            sync()
            seg.update(first=out[1], entry_s=time.perf_counter() - t0)
            return out

        def timed_save(*a, **kw):
            sync()
            t0 = time.perf_counter()
            out = save(*a, **kw)
            seg["save_s"] = time.perf_counter() - t0
            return out

        port_controller._start = timed_start
        port_controller.ckpt = SimpleNamespace(save=timed_save)
        try:
            t0 = time.perf_counter()
            super()._run_segment(task, fail=fail)
            wall = time.perf_counter() - t0
        finally:
            port_controller._start, port_controller.ckpt = start, ckpt
        seg.update(tick=self._tick, alloc=task.alloc, wall_s=wall,
                   steps=len(task.losses) - n0, preempted=fail,
                   steps_s=wall - seg["entry_s"] - (seg["save_s"] or 0.0),
                   resident=(torch.cuda.memory_allocated(dev)
                             if dev.type == "cuda" else None))
        self.segments.append(seg)


def elastic_row(rcfg, device, tmp) -> dict:
    """Mix D of ``rcfg`` on ``device`` (the card by default), with
    checkpoints under ``tmp``: the stub, straight and live (timed) runs.
    Returns both runs' decisions (``stub``, ``decisions``), the straight
    run's losses and those each job must give (``expected``), the
    segments, and per job its losses, its share of wall time in
    checkpoint I/O (restores and saves) and tokens/s inside the steps."""
    device = resolve_device(device)
    pool = [device] * POOL
    stub = decisions(*run_mix(PORT, rcfg, os.path.join(tmp, "stub"), pool,
                              stub_controller(PORT.ElasticController)))
    # the straight run first: the live run's segments find the device warm
    t0 = time.perf_counter()
    straight = train_loop(rcfg, ckpt_dir=os.path.join(tmp, "straight"),
                          num_steps=max(steps for _, _, steps, _ in JOBS),
                          ckpt_every=0, device=device)
    straight_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ctl, prov = run_mix(PORT, rcfg, os.path.join(tmp, "live"), pool,
                        TimedController)
    live_s = time.perf_counter() - t0
    jobs = {}
    for task in ctl.finished:
        segs = [s for s in ctl.segments if s["job"] == task.name]
        wall = sum(s["wall_s"] for s in segs)
        io = sum(s["entry_s"] for s in segs if not s["fresh"]) + sum(
            s["save_s"] or 0.0 for s in segs)
        steps = sum(s["steps"] for s in segs)
        jobs[task.name] = {
            "losses": task.losses, "segments": len(segs), "wall_s": wall,
            "io_s": io, "io_share": io / wall, "steps": steps,
            "tokens_per_s": steps * rcfg.shape.tokens / sum(
                s["steps_s"] for s in segs)}
    return {"stub": stub, "decisions": decisions(ctl, prov),
            "straight": straight.losses,
            "expected": expected_losses(straight.losses),
            "segments": ctl.segments, "jobs": jobs,
            "node_ticks": prov.node_hours(None, ctl._tick),
            "adjusts": prov.adjust_count(), "live_s": live_s,
            "straight_s": straight_s}
