"""Live elastic controller: DSP policies driving real PyTorch training jobs
(``repro.core.controller``).

This is the *live driver* half of the ``repro_torch.core.tre`` split: an
``ElasticController`` owns execution — placing jobs on devices, running
optimizer steps, checkpoint/restore — while every control decision (queue
loading, DR1/DR2 grants, idle-averaged releases, lifecycle transitions)
comes from the very same ``HTCRuntimeEnv`` that the discrete-event
emulator drives. Where the emulator advances a simulated-seconds clock,
the controller advances a ``TickClock``: one control tick =
``steps_per_tick`` optimizer steps of every running job.

Per tick, mirroring the emulator's event order (finish events land
strictly before the boundary they precede; scans come last):

  1. tasks that completed last tick are reported via ``env.finish`` —
     freeing their nodes and (through the env's scheduler) chaining queued
     work onto them,
  2. every ``ticks_per_release`` ticks, the env's release check frees
     dynamic blocks covered by the window's time-averaged idle,
  3. the env scans the queue and negotiates node grants with the
     ``ProvisionService`` (1 node = 1 slot of the device pool), then
     first-fit schedules into free slots,
  4. beyond-paper elasticity: a *running* job can be resized into spare
     slots via the env's ``grow``/``shrink`` hooks — the controller
     checkpoints, re-enters on the job's device and resumes; injected
     preemptions are absorbed by restart-from-latest-checkpoint.

The port's pool is a list of ``torch.device``. A pool that names one
card n times is n slots of that card, as the reference's placeholder
host devices are n slots of one host: the reference's data axis places a
batch's rows and does not change what a step computes, so a grown job's
segment runs the same global batch on the same card, in this process. A
job whose slots name distinct devices (cards, or ``cpu:0``...``cpu:3``)
runs each segment as a world of one rank a slot
(``launch.world.spawn_world``): every rank restores the job's newest
checkpoint, runs the tick's steps data-parallel on its rows
(``train.train_step``) and joins the save, and the losses come back to
this process. A segment's world is data-only (``(data n)``, one slot a
rank): the controller grants slots as nodes of the data axis, and never
splits a model over ``model``, which ``train_loop(mesh=)`` can.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.configs.base import RunConfig
from repro_torch.core.lifecycle import LifecycleService
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provision import ProvisionService
from repro_torch.core.tre import HTCRuntimeEnv, TickClock
from repro_torch.data.synthetic import synthetic_batches
from repro_torch.launch.world import rank_device, spawn_world
from repro_torch.models.lm import resolve_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.loop import _start


@dataclass
class TrainTask:
    """One HTC job: train ``rcfg`` for ``num_steps`` on ``nodes`` devices."""
    name: str
    rcfg: RunConfig
    nodes: int
    num_steps: int
    ckpt_dir: str
    # estimated duration in control ticks (set by the controller at submit;
    # the env records it as a release reservation so backfill scheduling
    # has a profile to work against — restarts make it stale, which the
    # backfill scheduler treats conservatively)
    runtime: float | None = None
    # ---- runtime state ----
    steps_done: int = 0
    alloc: int = 0                    # devices currently assigned
    losses: list = field(default_factory=list)
    resizes: int = 0
    restarts: int = 0

    @property
    def done(self) -> bool:
        return self.steps_done >= self.num_steps


class ElasticController:
    def __init__(self, *, policy: MgmtPolicy, provision: ProvisionService,
                 tre_name: str = "train-tre", devices=None,
                 steps_per_tick: int = 10, ticks_per_release: int = 5,
                 elastic_grow: bool = True,
                 lifecycle: LifecycleService | None = None, scheduler=None):
        # indexed devices: "cuda" and "cuda:0" name one card
        self.devices = [resolve_device(d) for d in (
            devices if devices is not None else [None])]
        self.clock = TickClock()
        self.env = HTCRuntimeEnv(
            tre_name, provision=provision, clock=self.clock,
            launch=self._launch, policy=policy, lifecycle=lifecycle,
            scheduler=scheduler, max_nodes=len(self.devices))
        self.steps_per_tick = steps_per_tick
        self.ticks_per_release = ticks_per_release
        self.elastic_grow = elastic_grow
        self.running: list[TrainTask] = []
        self.finished: list[TrainTask] = []
        self._done_last_tick: list[TrainTask] = []

    # ----------------------------------------------------------- plumbing
    @property
    def name(self) -> str:
        return self.env.name

    @property
    def queue(self) -> list[TrainTask]:
        return self.env.queue

    @property
    def owned(self) -> int:
        return self.env.owned

    @property
    def busy(self) -> int:
        return self.env.busy

    @property
    def free(self) -> int:
        return self.env.free

    @property
    def _tick(self) -> int:
        return int(self.clock.now())

    def submit(self, task: TrainTask) -> None:
        if task.runtime is None:
            task.runtime = math.ceil(
                (task.num_steps - task.steps_done) / self.steps_per_tick)
        self.env.submit(task)

    def _launch(self, task: TrainTask) -> None:
        task.alloc = task.nodes
        self.running.append(task)

    def _mesh_for(self, n: int):
        """Where a job of ``n`` slots runs: one device (a pool that names
        it n times is n slots of it, and the job runs in this process), or
        the list of its n devices when they are distinct, on whose world
        of n ranks (``launch.world.spawn_world``) its segment runs data-
        parallel, as the reference's ``data`` mesh of n devices does. A
        CPU device of any index is the CPU (tensors report plain
        ``cpu``)."""
        # guarded raise, not assert: a job wider than the device pool
        # must fail loudly, under ``python -O`` too
        if n > len(self.devices):
            raise RuntimeError(
                f"mesh wider than device pool: {n} > {len(self.devices)}")
        first = self.devices[0]
        if all(d == first for d in self.devices[:n]):
            return rank_device(first)
        return list(self.devices[:n])

    @staticmethod
    def _segment_rank(rank, mesh, rcfg, ckpt_dir, steps, num_steps, fail):
        """One rank of a segment's world: restore the job's newest
        checkpoint (or init from its seed), run up to ``steps`` steps on
        the rank's rows and join the save. Returns (losses, the step
        saved, or None when preempted)."""
        state, start, step_fn = _start(rcfg, ckpt_dir, mesh.device, mesh)
        batch_fn = synthetic_batches(rcfg, mesh.device, mesh)
        end = min(start + steps, num_steps)
        losses = []
        for step in range(start, end):
            if fail and step == start + 1:
                return losses, None
            state, metrics = step_fn(state, batch_fn(step))
            losses.append(float(metrics["loss"]))
        ckpt.save(ckpt_dir, end, state, mesh=mesh, zero=step_fn.zero)
        return losses, end

    # ------------------------------------------------------------- a tick
    def _run_segment(self, task: TrainTask, fail: bool = False) -> None:
        """Run ``steps_per_tick`` steps of a task on its device, or on its
        devices' world."""
        place = self._mesh_for(task.alloc)
        if isinstance(place, list):
            results = spawn_world(
                len(place), ElasticController._segment_rank, task.rcfg,
                task.ckpt_dir, self.steps_per_tick, task.num_steps, fail,
                devices=place)
            losses, end = results[0]
            task.losses.extend(losses)
            if end is None:
                task.restarts += 1
            else:
                task.steps_done = end
            return
        state, start, step_fn = _start(task.rcfg, task.ckpt_dir, place)
        batch_fn = synthetic_batches(task.rcfg, place)
        end = min(start + self.steps_per_tick, task.num_steps)
        # the state, LM and step are this frame's alone (no reference
        # cycle holds them), so returning frees them: the next job's
        # segment finds the card free of this one's state
        for step in range(start, end):
            if fail and step == start + 1:
                task.restarts += 1
                return  # simulated preemption: resume from last checkpoint
            state, metrics = step_fn(state, batch_fn(step))
            task.losses.append(float(metrics["loss"]))
        ckpt.save(task.ckpt_dir, end, state)
        task.steps_done = end

    def tick(self, *, fail_task: str | None = None) -> None:
        """One control cycle: finishes -> release -> scan/schedule -> train."""
        k = int(self.clock.advance())
        # 1) report last tick's completions: frees nodes, chains queued work
        self._flush_done(reschedule=True)
        # 2) window-end release check on time-averaged idle (env integrates
        #    free-node time exactly; the tick is the time unit here)
        if self.ticks_per_release and k % self.ticks_per_release == 0:
            self.env.release_check()
        # 3) DSP scan: negotiate growth, then schedule queued tasks
        self.env.scan()
        # 4) beyond-paper: grow a running job into spare devices (2x max)
        if self.elastic_grow:
            for task in self.running:
                grow = task.alloc
                if self.env.free >= grow and task.alloc < 2 * task.nodes:
                    self.env.grow(task, grow)
                    task.alloc += grow
                    task.resizes += 1
        # 5) run one segment of every running job
        for task in list(self.running):
            self._run_segment(task, fail=(task.name == fail_task))
            if task.done:
                self.running.remove(task)
                self._done_last_tick.append(task)
        # 6) shrink grown jobs back when the queue needs their devices
        if self.env.queue:
            for task in self.running:
                if task.alloc > task.nodes:
                    self.env.shrink(task, task.alloc - task.nodes)
                    task.alloc = task.nodes
                    task.resizes += 1

    def _flush_done(self, *, reschedule: bool) -> None:
        for task in self._done_last_tick:
            task.alloc = 0
            self.finished.append(task)
            self.env.finish(task, reschedule=reschedule)
        self._done_last_tick.clear()

    def run(self, *, max_ticks: int = 1000, fail_at: dict | None = None) -> None:
        fail_at = dict(fail_at or {})
        while (self.env.queue or self.running or self._done_last_tick) \
                and self._tick < max_ticks:
            self.tick(fail_task=fail_at.pop(self._tick + 1, None))
        # hitting max_ticks must not strand final-tick completions in the
        # deferred list (unreported to the env = phantom busy nodes);
        # reschedule=False so the env doesn't launch queued work into a
        # driver that has stopped ticking
        self._flush_done(reschedule=False)

    def destroy(self) -> None:
        self.env.destroy()
