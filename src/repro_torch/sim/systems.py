"""Emulated systems for the usage models (paper §4.1, Figs 6-8).

Since the ``repro_torch.core.tre`` redesign, this module contains no control-plane
logic of its own: the complete DSP cycle (queue + trigger monitor,
scheduler dispatch, ``PolicyEngine`` negotiation, time-integral idle
accounting, lifecycle transitions) lives in ``repro_torch.core.tre.RuntimeEnv``,
shared verbatim with the live JAX controller. What remains here is the
*discrete-event driver* side of the split:

  - ``REServer`` is a thin shell over ``HTCRuntimeEnv``/``MTCRuntimeEnv``:
    it owns simulated time — job arrivals, finish events ``runtime`` later,
    periodic scan/release ticks — and forwards each to the env. Fixed mode
    (DCS & SSP: the env owns a static configuration for the whole workload
    period) and dsp mode (DawningCloud: the env renegotiates via the same
    ``PolicyEngine`` that drives live training) are env modes, not forks.
  - ``DRPRunner`` models Deelman-style direct resource provision: each HTC
    job is an end user leasing its own nodes for ceil-hour of its runtime;
    an MTC workflow is one end-user application whose leased pool grows to
    its eager (no-queue) execution width and is held until the workflow
    finishes. No TRE exists, so it bypasses the runtime env by design.

Usage models are plugins: each is a ``repro_torch.core.registry.System``
registered under its name (``dcs`` / ``ssp`` / ``drp`` / ``dawningcloud``,
plus the beyond-paper ``dawningcloud-backfill`` / ``dawningcloud-easy``
(conservative vs EASY backfill), and the multi-tenant
``dawningcloud-coordinated`` / ``dawningcloud-quota`` scenarios that route
through ``repro_torch.core.provider.ResourceProvider`` — shared finite capacity,
admission queueing, PhoenixCloud-style coordination), and ``run_system`` is
registry dispatch — a new scenario is a new registered class, not an
``elif``. The serving-path counterpart, ``dawningcloud-serve-fleet``
(N serve TREs partitioning one engine pool on a ``TickClock``), registers
from ``repro_torch.serve.fleet`` and runs through its ``serve`` entry point
rather than ``run_system``. All billing goes through ``repro_torch.core.provision`` (1-hour lease
units); TRE creation/destruction goes through ``repro_torch.core.lifecycle``
(§3.1.3 state machine).
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.core.lifecycle import LifecycleService
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provider import ResourceProvider
from repro_torch.core.provision import BILL_UNIT_S, ProvisionService
from repro_torch.core.registry import System, get_system, register_system
from repro_torch.core.tre import HTCRuntimeEnv, MTCRuntimeEnv
from repro_torch.core.types import Job, Workload
from repro_torch.sim.engine import Sim


class SimClock:
    """Adapts the discrete-event kernel to the ``repro_torch.core.tre.Clock``
    protocol: env time *is* simulated wall time."""

    def __init__(self, sim: Sim):
        self._sim = sim

    def now(self) -> float:
        return self._sim.t


# --------------------------------------------------------------------------
# runtime-environment driver (DCS / SSP / DawningCloud)
# --------------------------------------------------------------------------
class REServer:
    """Discrete-event driver for one TRE: wires sim time into a RuntimeEnv.

    The driver schedules arrivals, turns ``launch`` into a finish event
    ``job.runtime`` later, and (dsp mode) fires the env's scan/release
    cycles at the policy's intervals. Everything else — scheduling,
    negotiation, idle accounting, lifecycle — happens inside the env.
    """

    def __init__(self, sim: Sim, workload: Workload,
                 provision: ProvisionService, *, mode: str,
                 fixed_nodes: int | None = None,
                 policy: MgmtPolicy | None = None, count_adjust: bool = True,
                 hold_until: float = 0.0,
                 lifecycle: LifecycleService | None = None, scheduler=None,
                 phase: float = 0.0):
        # guarded raise, not assert: a typo'd mode would silently run a
        # fixed env with dsp billing under ``python -O``
        if mode not in ("fixed", "dsp"):
            raise ValueError(
                f"unknown TRE mode {mode!r} (expected 'fixed' or 'dsp')")
        self.sim = sim
        self.wl = workload
        self.name = workload.name
        self.hold_until = hold_until   # fixed REs persist at least this long
        self.fixed_nodes = fixed_nodes  # configuration size (None in dsp)
        env_cls = HTCRuntimeEnv if workload.kind == "htc" else MTCRuntimeEnv
        self.env = env_cls(
            workload.name, provision=provision, clock=SimClock(sim),
            launch=self._launch, scheduler=scheduler, lifecycle=lifecycle,
            count_adjust=count_adjust,
            policy=policy if mode == "dsp" else None,
            fixed_nodes=fixed_nodes if mode == "fixed" else None)
        self.env.track(workload.jobs)
        if mode == "dsp":
            # phase in [0, 1) staggers this TRE's control cycles within
            # their intervals. The paper's single-tenant runs keep phase 0
            # (every cycle on the global grid — bit-for-bit with the paper's runs);
            # multi-tenant scenarios spread tenants out so scans/releases
            # do not collide at identical instants — and a parked
            # admission-queue request then waits O(interval/N) for the
            # next tenant's release instead of a whole synchronized window
            sim.after((1.0 + phase) * policy.scan_interval, self._scan)
            sim.after((1.0 + phase) * policy.release_interval,
                      self._release_check)
        # arrivals: only dependency-free jobs arrive by time; the trigger
        # monitor submits dependent tasks when their last dependency finishes
        for j in workload.jobs:
            if not j.deps:
                sim.at(j.arrival, self.env.submit, j)

    # ------------------------------------------------------ driver hooks
    def _launch(self, job: Job) -> None:
        self.sim.after(job.runtime, self._finish, job)

    def _finish(self, job: Job) -> None:
        if self.env.finish(job):
            # fixed REs (DCS/SSP) hold their configuration for the whole
            # workload period; DSP REs are destroyed once the work is done
            self.sim.at(max(self.sim.t, self.hold_until), self.env.destroy)

    def _scan(self) -> None:
        if self.env.destroyed:
            return
        self.env.scan()
        self.sim.after(self.env.engine.policy.scan_interval, self._scan)

    def _release_check(self) -> None:
        if self.env.destroyed:
            return
        self.env.release_check()
        self.sim.after(self.env.engine.policy.release_interval,
                       self._release_check)

    # ------------------------------------------------- env state mirror
    @property
    def completed(self) -> list[Job]:
        return self.env.completed

    @property
    def owned(self) -> int:
        return self.env.owned

    @property
    def destroyed(self) -> bool:
        return self.env.destroyed


# --------------------------------------------------------------------------
# DRP (direct resource provision, Deelman et al.)
# --------------------------------------------------------------------------
class DRPRunner:
    def __init__(self, sim: Sim, workload: Workload, provision: ProvisionService):
        self.sim = sim
        self.wl = workload
        self.provision = provision
        self.completed: list[Job] = []
        self._ndeps = {j.jid: len(j.deps) for j in workload.jobs}
        self._children: dict[int, list[Job]] = {}
        for j in workload.jobs:
            for d in j.deps:
                self._children.setdefault(d, []).append(j)
        if workload.kind == "htc":
            for j in workload.jobs:
                sim.at(j.arrival, self._run_htc_job, j)
        else:
            # one end-user pool for the whole workflow
            self.pool_name = f"{workload.name}-user"
            self.pool = 0          # leased high-watermark
            self.in_use = 0
            for j in workload.jobs:
                if not j.deps:
                    sim.at(j.arrival, self._run_mtc_task, j)

    # HTC: every job is its own end user/lease
    def _run_htc_job(self, job: Job):
        job.submit_time = job.start = self.sim.t
        user = f"{self.wl.name}-u{job.jid}"
        self.provision.request(user, job.nodes, self.sim.t)
        self.sim.after(job.runtime, self._finish_htc_job, job, user)

    def _finish_htc_job(self, job: Job, user: str):
        job.finish = self.sim.t
        self.provision.release(user, job.nodes, self.sim.t)
        self.completed.append(job)

    # MTC: eager execution; pool grows to peak width, held to the end
    def _run_mtc_task(self, job: Job):
        job.submit_time = job.start = self.sim.t
        need = self.in_use + job.nodes - self.pool
        if need > 0:
            self.provision.request(self.pool_name, need, self.sim.t)
            self.pool += need
        self.in_use += job.nodes
        self.sim.after(job.runtime, self._finish_mtc_task, job)

    def _finish_mtc_task(self, job: Job):
        job.finish = self.sim.t
        self.in_use -= job.nodes
        self.completed.append(job)
        for child in self._children.get(job.jid, ()):
            self._ndeps[child.jid] -= 1
            if self._ndeps[child.jid] == 0:
                self._run_mtc_task(child)
        if len(self.completed) == len(self.wl.jobs):
            self.provision.destroy(self.pool_name, self.sim.t)
            self.pool = 0


# --------------------------------------------------------------------------
# results
# --------------------------------------------------------------------------
@dataclass
class WorkloadResult:
    workload: str
    kind: str
    system: str
    completed_in_window: int
    completed_total: int
    node_hours: float
    makespan: float
    tasks_per_second: float
    mean_wait_s: float

    def as_dict(self):
        return dict(self.__dict__)


@dataclass
class SystemResult:
    system: str
    per_workload: dict[str, WorkloadResult]
    total_node_hours: float
    peak_nodes_per_hour: int
    adjust_count: int
    setup_overhead_s: float
    window_s: float
    capacity: int | None = None        # shared platform size (None = unbounded)

    @property
    def overhead_s_per_hour(self) -> float:
        return self.setup_overhead_s / max(self.window_s / 3600.0, 1e-9)


def _collect(system: str, wl: Workload, jobs_done: list[Job],
             node_hours: float, window: float) -> WorkloadResult:
    done_total = len(jobs_done)
    done_window = sum(1 for j in jobs_done if j.finish <= window + 1e-6)
    finish = max((j.finish for j in jobs_done), default=0.0)
    start = min((j.submit_time for j in jobs_done), default=0.0)
    makespan = finish - start
    tps = done_total / makespan if makespan > 0 else 0.0
    waits = [j.wait for j in jobs_done if j.wait >= 0]
    return WorkloadResult(
        workload=wl.name, kind=wl.kind, system=system,
        completed_in_window=done_window, completed_total=done_total,
        node_hours=node_hours, makespan=makespan, tasks_per_second=tps,
        mean_wait_s=sum(waits) / len(waits) if waits else 0.0)


# --------------------------------------------------------------------------
# registered usage models
# --------------------------------------------------------------------------
@dataclass
class EmulationContext:
    """Everything a registered ``System`` needs to build its runners. The
    billing horizon is NOT context state: ``finalize``/``node_hours``
    receive the authoritative ``end`` (the run's last fired event — or the
    horizon cutoff when the run was cut off — floored at the workload
    window) as a parameter."""
    sim: Sim
    provision: ProvisionService
    lifecycle: LifecycleService
    policies: dict[str, MgmtPolicy] = field(default_factory=dict)
    schedulers: dict[str, object] = field(default_factory=dict)
    mtc_fixed_nodes: int | None = None


class _EmulatedSystem(System):
    """Shared finalize: any TRE still running at the end of the window is
    destroyed through the lifecycle service (closing its leases at ``end``)."""

    def finalize(self, ctx: EmulationContext, runner, end: float) -> None:
        if isinstance(runner, REServer) and not runner.destroyed:
            runner.env.destroy(at=end)


@register_system("dcs")
class DCSSystem(_EmulatedSystem):
    """Dedicated cluster system: each provider owns a fixed configuration."""
    count_adjust = False     # owning a cluster is not a node adjustment

    def build(self, ctx: EmulationContext, wl: Workload) -> REServer:
        nodes = (wl.trace_nodes if wl.kind == "htc"
                 else (ctx.mtc_fixed_nodes or wl.trace_nodes))
        return REServer(ctx.sim, wl, ctx.provision, mode="fixed",
                        fixed_nodes=nodes, count_adjust=self.count_adjust,
                        hold_until=wl.period, lifecycle=ctx.lifecycle,
                        scheduler=ctx.schedulers.get(wl.name))

    def node_hours(self, ctx, runner, end) -> float:
        # paper §4.3: consumption = configuration size x workload period
        # (the immutable configuration, not post-destroy allocation state)
        return runner.fixed_nodes * math.ceil(runner.wl.period / BILL_UNIT_S)


@register_system("ssp")
class SSPSystem(DCSSystem):
    """Static service provision: same fixed configuration, but leased from
    the cloud — identical performance to DCS (§4.5.2), different TCO and
    adjustment accounting."""
    count_adjust = True


@register_system("drp")
class DRPSystem(System):
    """Direct resource provision: end users lease for themselves; no TRE."""

    def build(self, ctx: EmulationContext, wl: Workload) -> DRPRunner:
        return DRPRunner(ctx.sim, wl, ctx.provision)

    def node_hours(self, ctx, runner, end) -> float:
        # sum this workload's end-user leases
        wl = runner.wl
        return sum(l.billed_node_hours(end)
                   for l in ctx.provision.closed_leases
                   if l.tre.startswith(wl.name + "-u"))


@register_system("dawningcloud")
class DawningCloudSystem(_EmulatedSystem):
    """The paper's DSP model: elastic TREs negotiating with the provision
    service under per-provider (B, R) management policies."""

    def default_policy(self, wl: Workload) -> MgmtPolicy:
        return (MgmtPolicy.htc(40, 1.2) if wl.kind == "htc"
                else MgmtPolicy.mtc(10, 8.0))

    def default_scheduler(self, wl: Workload):
        return None                      # paper default for the workload kind

    def default_phase(self, wl: Workload) -> float:
        return 0.0                       # paper: every cycle on the grid

    def build(self, ctx: EmulationContext, wl: Workload) -> REServer:
        pol = ctx.policies.get(wl.name) or self.default_policy(wl)
        sched = ctx.schedulers.get(wl.name) or self.default_scheduler(wl)
        return REServer(ctx.sim, wl, ctx.provision, mode="dsp", policy=pol,
                        lifecycle=ctx.lifecycle, scheduler=sched,
                        phase=self.default_phase(wl))

    def node_hours(self, ctx, runner, end) -> float:
        return ctx.provision.node_hours(runner.wl.name, now=end)


@register_system("dawningcloud-backfill")
class DawningCloudBackfillSystem(DawningCloudSystem):
    """Beyond-paper consolidated scenario: the same DSP negotiation, but
    every HTC TRE schedules with conservative backfill while MTC TREs keep
    FCFS — a per-TRE scheduler mix the string-dispatch run_system could not
    express. Explicit ``schedulers={...}`` overrides still win."""

    def default_scheduler(self, wl: Workload):
        return "backfill" if wl.kind == "htc" else None


@register_system("dawningcloud-easy")
class DawningCloudEasySystem(DawningCloudBackfillSystem):
    """EASY-backfill variant: HTC TREs reserve only the blocked head
    (aggressive fills, the head's reserved start still inviolable) —
    higher utilization than conservative backfill at the cost of
    reservation guarantees for non-head queue positions."""

    def default_scheduler(self, wl: Workload):
        return "easy" if wl.kind == "htc" else None


# --------------------------------------------------------------------------
# multi-tenant scenarios (the economies-of-scale axis)
# --------------------------------------------------------------------------
def _aggregate_demand_events(workloads: list[Workload]):
    """(sorted times, demand levels) of the summed eager-execution demand
    across all tenants (HTC jobs at their trace arrivals/durations; a
    workflow TRE counts as its configured width over its period)."""
    ts, deltas = [], []
    for wl in workloads:
        if wl.kind == "htc":
            arr = np.array([j.arrival for j in wl.jobs])
            rt = np.array([j.runtime for j in wl.jobs])
            nd = np.array([j.nodes for j in wl.jobs])
            ts.append(arr)
            deltas.append(nd)
            ts.append(arr + rt)
            deltas.append(-nd)
        else:
            ts.append(np.array([0.0, wl.period]))
            deltas.append(np.array([wl.trace_nodes, -wl.trace_nodes]))
    t = np.concatenate(ts)
    d = np.concatenate(deltas)
    order = np.argsort(t, kind="stable")
    return t[order], np.cumsum(d[order])


def aggregate_demand_peak(workloads: list[Workload]) -> int:
    """Instantaneous peak of the summed eager-execution demand — the sum
    of per-tenant peaks grows linearly with the tenant count, but
    independent bursts do not align, so the peak of the sum grows
    sublinearly (statistical multiplexing)."""
    _, levels = _aggregate_demand_events(workloads)
    return int(levels.max())


def aggregate_hourly_peak(workloads: list[Workload]) -> int:
    """Peak *hourly-averaged* aggregate demand — the Fig 13 "nodes per
    hour" notion applied to the whole tenant fleet. This is the capacity a
    consolidated platform must host to serve every hour's average load:
    sub-hour bursts are buffered by the admission queue instead of being
    provisioned for, so the per-provider platform size falls as tenants
    consolidate (the economies-of-scale curve), while the sustained
    (week-scale, diurnal) plateaus every tenant shares stay fully covered
    — which is what keeps queueing delay bounded and tenants' workloads
    completing on schedule."""
    t, levels = _aggregate_demand_events(workloads)
    horizon = max(float(t.max()), max(wl.period for wl in workloads))
    # cumulative integral of the demand step function at event times, then
    # per-hour means via interpolation onto the hour grid
    t = np.concatenate([[0.0], t])
    levels = np.concatenate([[0], levels])
    integral = np.concatenate(
        [[0.0], np.cumsum(levels[:-1] * np.diff(t))])
    edges = np.arange(0.0, horizon + BILL_UNIT_S, BILL_UNIT_S)
    idx = np.searchsorted(t, edges, side="right") - 1
    at_edges = integral[idx] + levels[idx] * (edges - t[idx])
    hourly_mean = np.diff(at_edges) / BILL_UNIT_S
    return int(math.ceil(float(hourly_mean.max())))


@register_system("dawningcloud-coordinated")
class DawningCloudCoordinatedSystem(DawningCloudSystem):
    """PhoenixCloud-style consolidated scenario (arXiv:1006.1401): N DSP
    TREs share one *finite* platform sized at the aggregate demand peak
    (statistical multiplexing), simultaneous DR1/DR2 requests are
    arbitrated together by the coordinated policy, and deferred requests
    park in the provider's admission queue until another tenant's release
    frees capacity. At small N the shared capacity is an outlier far above
    typical demand and every request is served whole (DawningCloud
    semantics); as N grows the aggregate demand concentrates, the platform
    runs closer to its capacity, and burst requests get trimmed to fair
    shares — which is exactly where the per-provider consumption saving
    (the economies of scale) comes from."""

    coordination = "coordinated"

    def default_phase(self, wl: Workload) -> float:
        # deterministic per-tenant stagger (crc32: stable across processes,
        # unlike str hash) so N tenants' scans/releases interleave instead
        # of colliding at identical instants
        return (zlib.crc32(wl.name.encode()) % 997) / 997.0

    def default_capacity(self, workloads, policies) -> int:
        hourly = aggregate_hourly_peak(workloads)
        # liveness floor: when every tenant is back at its initial B, the
        # widest single job must still fit (else a DR2 can starve forever);
        # and creation must never be rejected (all Bs fit with margin)
        sum_b = sum((policies.get(wl.name) or self.default_policy(wl)).initial
                    for wl in workloads)
        widest = max(j.nodes for wl in workloads for j in wl.jobs)
        return max(hourly, sum_b + widest, math.ceil(1.25 * sum_b))


@register_system("dawningcloud-quota")
class DawningCloudQuotaSystem(DawningCloudSystem):
    """Per-tenant quota scenario: first-come provisioning (the paper's
    arrival-order semantics) on a shared platform, but no TRE may lease
    beyond its original dedicated-cluster size — the provider-side guard
    that one tenant's burst cannot crowd the platform (§3.2.2.3's provision
    policy parameterized per tenant)."""

    coordination = "first-come"

    def default_quotas(self, workloads, policies) -> dict[str, int]:
        return {wl.name: max(
            wl.trace_nodes,
            (policies.get(wl.name) or self.default_policy(wl)).initial)
            for wl in workloads}


# --------------------------------------------------------------------------
# registry-dispatched experiment runner
# --------------------------------------------------------------------------
def run_system(system: str, workloads: list[Workload], *,
               policies: dict[str, MgmtPolicy] | None = None,
               capacity: int | None = None,
               mtc_fixed_nodes: int | None = None,
               schedulers: dict[str, object] | None = None,
               coordination=None,
               quotas: dict[str, int] | None = None,
               reservations: dict[str, int] | None = None,
               horizon: float | None = None) -> SystemResult:
    """Run one registered system over consolidated workloads.

    system: any ``repro_torch.core.registry`` name ("dcs" | "ssp" | "drp" |
        "dawningcloud" | "dawningcloud-backfill" | "dawningcloud-coordinated"
        | "dawningcloud-quota" | plugins)
    policies: workload name -> MgmtPolicy (DSP systems only)
    mtc_fixed_nodes: DCS/SSP configuration for MTC workloads (paper: 166)
    schedulers: workload name -> scheduler callable or SCHEDULERS key
    coordination: multi-tenant coordination policy name/instance; defaults
        to the system's ``coordination`` attribute. Any of coordination /
        quotas / reservations (explicit or system defaults) routes the run
        through a ``ResourceProvider`` with an admission queue; otherwise
        the paper's plain grant-or-reject ``ProvisionService`` is used.
    quotas / reservations: per-TRE hard caps / guaranteed minimums
    horizon: hard simulation cutoff (default 16x the workload window). A
        capacity-starved multi-tenant run can cycle hourly forever
        (release-check frees idle blocks, the admission queue re-grants
        them); the bound guarantees termination and surfaces the stall as
        incomplete job counts instead of a hung emulator.
    """
    impl = get_system(system)
    workloads = [wl.fresh() for wl in workloads]
    policies = dict(policies or {})
    coordination = coordination if coordination is not None \
        else impl.coordination
    if quotas is None:
        quotas = impl.default_quotas(workloads, policies)
    if reservations is None:
        reservations = impl.default_reservations(workloads)
    if coordination is not None or quotas or reservations:
        if capacity is None:
            capacity = impl.default_capacity(workloads, policies)
        provision: ProvisionService = ResourceProvider(
            capacity, coordination=coordination, quotas=quotas,
            reservations=reservations)
    else:
        provision = ProvisionService(capacity)
    sim = Sim()
    lifecycle = LifecycleService(provision)
    window = max(wl.period for wl in workloads)
    ctx = EmulationContext(sim=sim, provision=provision, lifecycle=lifecycle,
                          policies=policies,
                          schedulers=dict(schedulers or {}),
                          mtc_fixed_nodes=mtc_fixed_nodes)
    runners = [impl.build(ctx, wl) for wl in workloads]
    sim.run(until=horizon if horizon is not None else 16.0 * window)
    # fixed REs persist for the whole workload period even after the last
    # job; a completed run's end is its last fired event (sim.t is bumped
    # to the cutoff even when the event heap drained long before it)
    end = max(sim.last_event_t if sim.drained else sim.t, window)
    # withdraw every parked request BEFORE the destroy loop: one tenant's
    # destroy releases capacity, and a horizon-cutoff run may still have
    # requests queued — a grant landing between two destroys would open a
    # zero-duration lease billed a whole hour. drain=False: each cancel
    # must not serve the *other* still-parked requests either
    for r in runners:
        env = getattr(r, "env", None)
        if env is not None and not env.destroyed:
            env.cancel_pending(end, drain=False)
    for r in runners:
        impl.finalize(ctx, r, end)
    per = {
        r.wl.name: _collect(system, r.wl, r.completed,
                            impl.node_hours(ctx, r, end), window)
        for r in runners
    }
    total = sum(res.node_hours for res in per.values())
    return SystemResult(
        system=system, per_workload=per, total_node_hours=total,
        peak_nodes_per_hour=provision.peak_nodes_per_hour(end),
        adjust_count=provision.adjust_count(),
        setup_overhead_s=provision.setup_overhead_s(),
        window_s=window, capacity=provision.capacity)
