"""The tenant contract: what ``ServeFleet`` drives, extracted from the
serve stack — plus the first non-serve tenant species.

Before this module the fleet's lanes were hardwired ``ServeDriver``s:
the tick body named serve-specific phase methods and the roll-up read
serve-specific stats. The paper's economies-of-scale claim is about
consolidating *heterogeneous* workloads on one platform (MTC **and**
HTC, §2/§5; arXiv:1004.1276 asks the same question for batch-shaped
scientific communities), so the tenant itself must be an abstraction:

  - :class:`Tenant` — the phase-hook protocol ``ServeFleet._tick``
    drives, one hook per phase of THE serve tick body, in tick order.
    ``ServeDriver`` implements it by aliasing its existing phase
    methods, which is what keeps the all-MTC fleet bit-identical to the
    pre-refactor path (pinned field-for-field in ``tests/test_tenant``).
  - :class:`TrainTenant` — a gang-scheduled HTC *training* tenant
    sharing the provider with the serve lanes: all-or-nothing grants
    through the existing ``ResourceRequest.min_useful`` DR1/DR2 path (a
    single queued gang's deficit IS its useful floor), elastic between
    each job's min and max world size via the ``RuntimeEnv``
    grow/shrink hooks, and *preemptible*: when foreign requests park in
    the provider's admission queue the tenant checkpoints, vacates and
    releases nodes (``RuntimeEnv.yield_nodes`` ->
    ``ProvisionService.preempt``), and the requeued job later resumes
    from its last checkpoint step — the emulated twin of
    ``train.loop.Preemption`` + ``train.checkpoint.latest_step``
    (loss-bit-identical resume is pinned dynamically in
    ``tests/test_train.py``). Jobs come from ``sim.traces.TrainProfile``
    streams: many small heterogeneous runs over the ``repro_torch.configs``
    model registry, an HTC community in the NAS-trainer spirit.

Work model (emulated, deterministic): a job needs
``steps * world_min * step_ticks`` node-ticks of useful work; each tick
it accrues its current world size, so elastic growth is linear speedup.
``steps_done = work // (world_min * step_ticks)``; a checkpoint exists
at every ``ckpt_every`` step boundary, and a preemption rolls work back
to the last checkpoint — exactly what restarting a real ``train_loop``
from ``latest_step`` loses.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Sequence

from repro_torch.core.policy import HTC_SCAN_S, MgmtPolicy
from repro_torch.core.tre import HTCRuntimeEnv, TickClock
from repro_torch.sim.traces import TrainJob


class TenantInvariantError(RuntimeError):
    """A tenant-side invariant was violated (training allocation ledger
    divergence, a gang outside its world-size band). Raised — never
    ``assert``ed — so the checks survive ``python -O``."""


def due_tick_floor(t: float, tick_s: float) -> int:
    """A tick index guaranteed *not later* than the tick at which a
    timestamp ``t`` comes due under the serve loop's ``t <= now + 1e-9``
    check. ``floor`` (vs the exact ``ceil``) concedes at most one tick
    when ``t`` sits on the grid, in exchange for a one-sided guarantee
    that holds even as the accumulated ``TickClock`` drifts from
    ``k * tick_s`` by float error: event-skipping may land *early* (the
    tick is then a no-op and the loop resumes normal stepping) but can
    never jump *past* the event."""
    return int(math.floor((t - 1e-9) / tick_s))


def next_boundary(k: int, every: int, phase: int) -> int:
    """Smallest tick index > ``k`` on the ``k % every == phase % every``
    control-cycle grid (scan/release boundaries)."""
    r = phase % every
    k2 = (k // every) * every + r
    while k2 <= k:
        k2 += every
    return k2


class Tenant:
    """One tenant of the shared pool: the phase-hook contract
    ``ServeFleet._tick`` drives, in tick order. Implementations supply:

    ``name``
        the TRE name (provider leases and stats are keyed by it),
    ``env``
        the tenant's ``RuntimeEnv`` — the fleet reads ``env.owned`` for
        grant bookkeeping and ``env.destroyed`` at teardown,
    ``stats``
        a per-run stats object with ``as_dict()`` plus the roll-up
        fields :meth:`rollup` reads,
    ``tick_s`` / ``max_ticks``
        the tick grain and this tenant's own tick-budget bound.

    Phase hooks, in the order one fleet tick calls them (the fleet's
    pool decode step runs between :meth:`pre_step` and
    :meth:`post_step`):

    1. :meth:`begin_tick` — work intake (arrivals due at ``now``),
    2. :meth:`pre_step` — release cadence and any voluntary yielding
       (a training tenant's preemption check lives here so vacated
       nodes drain to parked serve requests within the same tick),
    3. :meth:`post_step` — consume the step's results (finished decode
       slots / emulated training progress),
    4. :meth:`control` — scan cadence: DR1/DR2 negotiation, elastic
       growth,
    5. :meth:`flush` — batched admissions,
    6. :meth:`check_invariants` — guarded-raise consistency sweeps,
    7. :meth:`accumulate` — per-tick stats integrals.

    Retirement: the fleet polls :meth:`retired` after each tick and
    calls :meth:`finalize` once (destroying the env settles billing);
    at a tick-budget cutoff it first calls :meth:`teardown` on every
    surviving tenant so no parked request can be granted between two
    finalize destroys.

    Event-skipping: :meth:`next_event_tick` names the earliest tick at
    which this tenant could act; :meth:`skip_quiet_stats` applies the
    closed form of ``dq`` quiet ticks to the tenant's own state (stats
    integrals, emulated progress). The fleet skips a span only when it
    is quiet for EVERY tenant.
    """

    name: str = ""
    tick_s: float = 1.0
    max_ticks: int = 0
    env: Any = None
    stats: Any = None

    # ------------------------------------------------------ phase hooks
    def begin_tick(self, now: float) -> None:
        """Phase 1: intake work due at ``now``."""

    def pre_step(self, k: int) -> None:
        """Phase 2: release cadence / voluntary yielding, before the
        pool's decode step."""

    def post_step(self, k: int) -> None:
        """Phase 3: consume the pool step's results."""

    def control(self, k: int) -> None:
        """Phase 4: scan cadence — negotiation and elastic growth."""

    def flush(self) -> None:
        """Phase 5: batched admissions."""

    def check_invariants(self) -> None:
        """Phase 6: guarded-raise consistency sweeps."""

    def accumulate(self) -> None:
        """Phase 7: per-tick stats integrals."""

    # ------------------------------------------------------- retirement
    @property
    def retired(self) -> bool:
        """All work complete: the fleet finalizes and drops the lane."""
        raise NotImplementedError

    def teardown(self, now: float) -> None:
        """Cutoff guard: withdraw any parked request WITHOUT letting the
        provider drain it to other tenants (a grant landing between two
        finalize destroys opens a zero-duration lease billed an hour)."""
        if self.env is not None and not self.env.destroyed:
            self.env.cancel_pending(now, drain=False)

    def finalize(self, ticks: int):
        """Close out: derived rates, destroy the env, settle billing.
        Returns the tenant's stats object."""
        raise NotImplementedError

    # --------------------------------------------------- event-skipping
    def next_event_tick(self, k: int) -> int:
        """Earliest tick after ``k`` at which this tenant could act.
        The conservative default — every tick is an event — disables
        skipping for tenants that don't model their horizons."""
        return k + 1

    def skip_quiet_stats(self, dq: int) -> None:
        """Closed form of ``dq`` quiet ticks of this tenant's own state
        (the busy/owned integrals; subclasses add emulated progress).
        The fleet advances the shared clock and pool itself."""
        self.stats.busy_node_ticks += self.env.busy * self.tick_s * dq
        self.stats.owned_node_ticks += self.env.owned * self.tick_s * dq

    # ----------------------------------------------------------- rollup
    def rollup(self, fleet_stats) -> None:
        """Fold this tenant's stats into a ``FleetStats``. The base form
        covers the fields every tenant species shares; ``ServeDriver``
        extends it with the serve-only counters."""
        ls = self.stats
        fleet_stats.busy_node_ticks += ls.busy_node_ticks
        fleet_stats.owned_node_ticks += ls.owned_node_ticks
        fleet_stats.node_hours += ls.node_hours
        fleet_stats.deferred_grants += ls.deferred_grants
        fleet_stats.deferred_nodes += ls.deferred_nodes
        fleet_stats.tenants.append(ls.as_dict())


# --------------------------------------------------------------------------
# the HTC training tenant
# --------------------------------------------------------------------------
@dataclass
class TrainStats:
    """One training tenant's run: gang/elastic/preemption accounting."""
    name: str
    ticks: int = 0
    tick_s: float = 1.0
    jobs_expected: int = 0
    jobs_completed: int = 0
    steps_expected: int = 0             # optimizer steps across all jobs
    steps_done: int = 0
    makespan_s: float = 0.0
    busy_node_ticks: float = 0.0        # integral of gang-held nodes
    owned_node_ticks: float = 0.0       # integral of granted nodes
    slot_utilization: float = 0.0       # busy / owned integrals
    node_hours: float = 0.0             # billed (per started lease hour)
    peak_owned: int = 0
    queue_peak: int = 0
    deferred_grants: int = 0            # gang grants landed via the queue
    deferred_nodes: int = 0
    preemptions: int = 0                # jobs vacated for foreign demand
    resumes: int = 0                    # preempted jobs relaunched
    rollback_steps: int = 0             # un-checkpointed steps lost
    grow_nodes: int = 0                 # elastic growth committed
    shrink_nodes: int = 0               # elastic shrink (incl. preempt)
    invariant_breaches: int = 0         # non-strict counted breaches

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class TrainTenant(Tenant):
    """A gang-scheduled, elastic, preemptible HTC training tenant.

    jobs: the tenant's HTC stream — ``sim.traces.TrainJob``s (from
        ``TrainProfile.stream`` / ``train_stream``), submitted at their
        arrival times. Each job is a *gang*: it starts only when
        ``world_min`` nodes are free in the env (first-fit over the
        queue), which the DR1/DR2 ``min_useful`` floor guarantees grants
        are sized for — a partial grant below the smallest queued gang
        is declined (``RuntimeEnv._apply_grant``), the all-or-nothing
        contract.
    provider: the shared provision service (a ``ResourceProvider`` for
        consolidation; a plain ``ProvisionService`` for a dedicated
        baseline).
    policy / fixed_nodes: DSP elasticity vs a dedicated fixed pool —
        exactly one, as everywhere.
    preempt_check_s: cadence of the yield check (default: the scan
        interval). At each boundary, if foreign requests are parked in
        the provider's admission queue, the tenant shrinks its gangs to
        ``world_min``, then fully preempts gangs (youngest first:
        checkpoint, vacate, requeue) until the foreign demand is
        covered, releasing the vacated dynamic blocks through
        ``RuntimeEnv.yield_nodes`` so the provider's drain re-grants
        them within the same tick.
    """

    def __init__(self, jobs: Sequence[TrainJob], *, provider,
                 clock: TickClock | None = None,
                 policy: MgmtPolicy | None = None,
                 fixed_nodes: int | None = None,
                 name: str = "htc-train", lifecycle=None,
                 tick_s: float = 1.0, strict: bool = True,
                 phase: int = 0, max_nodes: int | None = None,
                 preempt_check_s: float | None = None,
                 max_ticks: int | None = None):
        self.provider = provider
        self.tick_s = tick_s
        self.strict = strict
        self.clock = clock if clock is not None else TickClock()
        self.jobs = sorted(jobs, key=lambda j: (j.arrival, j.jid))
        for j in self.jobs:
            if j.nodes != j.world_min:
                raise TenantInvariantError(
                    f"train job {j.name!r} queues at nodes={j.nodes} but "
                    f"its gang floor is world_min={j.world_min}")
        self.stats = TrainStats(
            name=name, tick_s=tick_s, jobs_expected=len(self.jobs),
            steps_expected=sum(j.steps for j in self.jobs))
        self._stream_i = 0
        self._phase = phase
        scan_s = policy.scan_interval if policy is not None else HTC_SCAN_S
        self._scan_every = max(int(round(scan_s / tick_s)), 1)
        self._release_every = (max(int(round(policy.release_interval
                                             / tick_s)), 1)
                               if policy is not None else 0)
        pre_s = preempt_check_s if preempt_check_s is not None else scan_s
        self._preempt_every = max(int(round(pre_s / tick_s)), 1)
        # per-jid run state: the task handle, its live allocation, its
        # accrued work (node-ticks) and checkpointed step floor
        self._task: dict[int, TrainJob] = {}
        self._held: dict[int, int] = {}
        self._work: dict[int, int] = {}
        self._ckpt: dict[int, int] = {}     # last checkpointed step
        self._running: list[int] = []       # jids in launch order
        self._was_preempted: set[int] = set()
        self.env = HTCRuntimeEnv(
            name, provision=provider, clock=self.clock,
            launch=self._launch, policy=policy, fixed_nodes=fixed_nodes,
            lifecycle=lifecycle, max_nodes=max_nodes)
        self.env.grant_listener = self._on_grant
        self.env.track(())
        if max_ticks is None:
            span = self.jobs[-1].arrival if self.jobs else 0.0
            work = sum(j.steps * j.step_ticks for j in self.jobs)
            max_ticks = int(span / tick_s + 8 * work + 36_000)
        self.max_ticks = max_ticks

    @property
    def name(self) -> str:
        return self.env.name

    # ------------------------------------------------------- env hooks
    def _target_work(self, job: TrainJob) -> int:
        return job.steps * job.world_min * job.step_ticks

    def _steps_of(self, job: TrainJob, work: int) -> int:
        return min(work // (job.world_min * job.step_ticks), job.steps)

    def _launch(self, task: TrainJob) -> None:
        """The env's scheduler started this gang on ``world_min`` free
        nodes. A relaunch of a preempted job is a *resume*: it continues
        from its checkpointed step (the work floor set at preemption),
        recorded in the provider's lease ledger."""
        jid = task.jid
        self._task[jid] = task
        self._held[jid] = task.nodes
        self._running.append(jid)
        if jid in self._was_preempted:
            self._was_preempted.discard(jid)
            self.stats.resumes += 1
            record = getattr(self.provider, "record_resume", None)
            if record is not None:
                record(self.env.name, task.nodes, self.clock.now())

    def _on_grant(self, nodes: int, t: float, deferred: bool) -> None:
        if deferred:
            self.stats.deferred_grants += 1
            self.stats.deferred_nodes += nodes

    # ------------------------------------------------------ phase hooks
    def begin_tick(self, now: float) -> None:
        while (self._stream_i < len(self.jobs)
               and self.jobs[self._stream_i].arrival <= now + 1e-9):
            job = self.jobs[self._stream_i]
            self._stream_i += 1
            self._work.setdefault(job.jid, 0)
            self._ckpt.setdefault(job.jid, 0)
            self.env.track([job], extend=True)
            self.env.submit(job)

    def pre_step(self, k: int) -> None:
        if (self._release_every and k > 0
                and k % self._release_every == self._phase
                % self._release_every):
            self.env.release_check()
        if (k > 0 and k % self._preempt_every == self._phase
                % self._preempt_every):
            self._maybe_preempt()

    def _foreign_parked(self) -> int:
        """Node demand parked in the provider's admission queue by OTHER
        tenants — the signal that the pool is contended and training
        should get out of the way."""
        queue = getattr(self.provider, "admission_queue", None)
        if not queue:
            return 0
        return sum(r.nodes for r in queue
                   if r.tre != self.env.name and r.status == "queued")

    def _maybe_preempt(self) -> None:
        """Yield to parked foreign demand: elastic shrink first (gangs
        fall back to ``world_min``), then full preemption youngest-first
        — checkpoint (roll accrued work to the last ``ckpt_every``
        boundary), vacate the gang, requeue the job. Vacated nodes are
        released through ``yield_nodes`` -> ``provider.preempt``, whose
        drain re-grants them to the parked requests inline."""
        demand = self._foreign_parked()
        if demand <= 0 or not self._running:
            return
        # only dynamic blocks ever release (the B floor is the tenant's
        # reserved share, and a fixed pool never releases at all) —
        # vacating a gang that runs inside the floor frees nodes the
        # foreign tenant can never receive, so cap the yield at what
        # ``release_check`` could actually hand over.
        demand = min(demand, self.env.engine.dynamic_total
                     if self.env.engine is not None else 0)
        if demand <= 0:
            return
        freed = 0
        for jid in reversed(self._running):
            job = self._task[jid]
            surplus = self._held[jid] - job.world_min
            take = min(surplus, demand - freed)
            if take > 0:
                self.env.shrink(job, take)
                self._held[jid] -= take
                self.stats.shrink_nodes += take
                freed += take
            if freed >= demand:
                break
        while freed < demand and self._running:
            jid = self._running[-1]
            freed += self._preempt_job(jid)
        if freed > 0:
            self.env.yield_nodes()

    def _preempt_job(self, jid: int) -> int:
        """Checkpoint-and-vacate one running gang; returns the nodes
        freed. The job requeues at ``world_min`` and its accrued work
        rolls back to the last checkpoint boundary — the steps a real
        ``train_loop`` would redo after restoring ``latest_step``."""
        job = self._task[jid]
        held = self._held.pop(jid)
        self._running.remove(jid)
        self._task.pop(jid)
        steps = self._steps_of(job, self._work[jid])
        ckpt = (steps // job.ckpt_every) * job.ckpt_every
        self.stats.rollback_steps += steps - ckpt
        self._ckpt[jid] = ckpt
        self._work[jid] = ckpt * job.world_min * job.step_ticks
        self.env.shrink(job, held)
        self.stats.shrink_nodes += held
        self.stats.preemptions += 1
        self._was_preempted.add(jid)
        self.env.submit(job)
        return held

    def post_step(self, k: int) -> None:
        """Advance every running gang by its held nodes' worth of work;
        complete jobs whose step target is reached (freeing the gang and
        rescheduling the queue onto it)."""
        done: list[int] = []
        for jid in self._running:
            job = self._task[jid]
            self._work[jid] += self._held[jid]
            if self._work[jid] >= self._target_work(job):
                done.append(jid)
        for jid in done:
            job = self._task.pop(jid)
            held = self._held.pop(jid)
            self._running.remove(jid)
            # return elastic growth before finish: the env frees the
            # task's base allocation itself, and its ledger carries the
            # grown amount
            if held > job.world_min:
                self.env.shrink(job, held - job.world_min)
            self._work[jid] = self._target_work(job)
            self.stats.jobs_completed += 1
            self.env.finish(job)
        self.stats.steps_done = sum(
            self._steps_of(j, self._work.get(j.jid, 0))
            for j in self.jobs[:self._stream_i])

    def control(self, k: int) -> None:
        if not (self._scan_every and k > 0
                and k % self._scan_every == self._phase % self._scan_every):
            return
        self.env.scan()
        self._maybe_grow()

    def _maybe_grow(self) -> None:
        """Elastic growth, oldest gang first: soak spare owned nodes,
        then ask the provider directly for the rest of the band (a
        direct request is arbitration-aware — it never overtakes parked
        elders — so growth can only soak genuine troughs)."""
        for jid in list(self._running):
            job = self._task[jid]
            want = job.world_max - self._held[jid]
            if want <= 0:
                continue
            g = min(want, self.env.free)
            if g > 0:
                self.env.grow(job, g)
                self._held[jid] += g
                self.stats.grow_nodes += g
                want -= g
            if want > 0 and self.env.engine is not None:
                room = (self.env.max_nodes - self.env.owned
                        if self.env.max_nodes is not None else want)
                ask = min(want, room)
                if ask > 0 and self.provider.request(
                        self.env.name, ask, self.clock.now(),
                        count_adjust=self.env.count_adjust):
                    self.env.acquire(ask)
                    self.env.grow(job, ask)
                    self._held[jid] += ask
                    self.stats.grow_nodes += ask

    def check_invariants(self) -> None:
        held_total = sum(self._held.values())
        bad = None
        if held_total != self.env.busy:
            bad = ("gang ledger divergence: %d held nodes != %d busy"
                   % (held_total, self.env.busy))
        elif self.env.busy > self.env.owned:
            bad = ("gangs exceed grant: %d busy > %d owned"
                   % (self.env.busy, self.env.owned))
        else:
            for jid in self._running:
                job = self._task[jid]
                if not job.world_min <= self._held[jid] <= job.world_max:
                    bad = ("gang %r outside its world band: %d not in "
                           "[%d, %d]" % (job.name, self._held[jid],
                                         job.world_min, job.world_max))
                    break
        if bad is not None:
            self.stats.invariant_breaches += 1
            if self.strict:
                raise TenantInvariantError(bad)

    def accumulate(self) -> None:
        self.stats.busy_node_ticks += self.env.busy * self.tick_s
        self.stats.owned_node_ticks += self.env.owned * self.tick_s
        self.stats.peak_owned = max(self.stats.peak_owned, self.env.owned)
        self.stats.queue_peak = max(self.stats.queue_peak,
                                    len(self.env.queue))

    # ------------------------------------------------------- retirement
    @property
    def retired(self) -> bool:
        return (self._stream_i == len(self.jobs) and self.env.all_done
                and not self._running)

    def finalize(self, ticks: int) -> TrainStats:
        self.stats.ticks = ticks
        self.stats.makespan_s = self.clock.now()
        if self.stats.owned_node_ticks > 0:
            self.stats.slot_utilization = (self.stats.busy_node_ticks
                                           / self.stats.owned_node_ticks)
        if not self.env.destroyed:
            self.env.destroy()
        self.stats.node_hours = self.provider.node_hours(
            self.env.name, now=self.clock.now())
        return self.stats

    # --------------------------------------------------- event-skipping
    def next_event_tick(self, k: int) -> int:
        """Earliest tick after ``k`` at which this tenant could act: an
        arrival coming due, a release boundary, a scan boundary with
        anything to negotiate or grow, a preempt boundary while foreign
        demand is parked, or a running gang reaching its step target.
        Quiet ticks in between only accrue work and integrals, which
        :meth:`skip_quiet_stats` applies in closed form."""
        cands = []
        if self._stream_i < len(self.jobs):
            cands.append(due_tick_floor(self.jobs[self._stream_i].arrival,
                                        self.tick_s))
        if self._release_every:
            cands.append(next_boundary(k, self._release_every, self._phase))
        growth_wanted = any(
            self._held[j] < self._task[j].world_max for j in self._running)
        if self._scan_every and (self.env.queue or growth_wanted
                                 or self.env._pending_req is not None):
            cands.append(next_boundary(k, self._scan_every, self._phase))
        if self._foreign_parked() > 0 and self._running:
            cands.append(next_boundary(k, self._preempt_every, self._phase))
        for jid in self._running:
            job = self._task[jid]
            left = self._target_work(job) - self._work[jid]
            cands.append(k + max(-(-left // max(self._held[jid], 1)), 1))
        if not cands:
            return self.max_ticks
        return max(min(cands), k + 1)

    def skip_quiet_stats(self, dq: int) -> None:
        """``dq`` quiet ticks in closed form: gang work accrual plus the
        busy/owned integrals (no gang can complete inside the span —
        :meth:`next_event_tick` bounded it by the earliest target)."""
        for jid in self._running:
            self._work[jid] += self._held[jid] * dq
        super().skip_quiet_stats(dq)


@dataclass(frozen=True)
class TrainTenantSpec:
    """What ``ServeFleet`` needs to wire one training tenant into the
    shared pool: the job stream, the management policy (B = the gang
    floor it never releases), and the yield cadence."""
    jobs: tuple[TrainJob, ...]
    policy: MgmtPolicy
    name: str = ""
    preempt_check_s: float | None = None


def drive_tenant(tenant: Tenant, *, max_ticks: int | None = None,
                 event_skip: bool = True):
    """Run one tenant standalone through the protocol hooks — the
    dedicated-baseline counterpart of ``ServeFleet.run()`` for tenants
    that need no engine pool (e.g. a ``TrainTenant`` on its own fixed
    nodes). Same phase order as the fleet tick, minus the pool step."""
    clock = tenant.clock
    bound = max_ticks if max_ticks is not None else tenant.max_ticks

    def tick(k: int) -> None:
        now = clock.now()
        tenant.begin_tick(now)
        tenant.pre_step(k)
        tenant.post_step(k)
        tenant.control(k)
        tenant.flush()
        tenant.check_invariants()
        tenant.accumulate()

    k = 0
    tick(k)
    while not tenant.retired and k < bound:
        if event_skip:
            kn = min(tenant.next_event_tick(k), bound)
            dq = kn - k - 1
            if dq > 0:
                tenant.skip_quiet_stats(dq)
                clock.advance(tenant.tick_s * dq)
                k += dq
        k += 1
        clock.advance(tenant.tick_s)
        tick(k)
    tenant.teardown(clock.now())
    return tenant.finalize(k)
