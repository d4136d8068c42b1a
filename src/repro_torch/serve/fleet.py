"""Multi-tenant serving fleet: N serve TREs partitioning one engine pool.

The paper's economies-of-scale claim is about *consolidating heterogeneous
workloads on one platform*; ``repro_torch.serve.driver.ServeDriver``
serves one MTC tenant. This module is the consolidation step for the
*serving* path, following PhoenixCloud's coordinated runtime-environment
provisioning (arXiv:1006.1401) and continuous-batching slot scheduling à
la Orca/vLLM:

  - **N tenant drivers, one engine pool**: each tenant is a full
    ``ServeDriver`` lane — its own ``MTCRuntimeEnv`` (trigger monitor,
    FCFS dispatch, DR1/DR2 negotiation), its own management policy and
    workflow arrival stream — all replayed on ONE shared ``TickClock``
    against ONE ``ResourceProvider`` whose capacity **is** the engine
    pool: 1 batching slot = 1 node, partitioned across tenants by the
    provider's ``CoordinationPolicy`` (``first-come`` arrival-order vs
    ``coordinated`` urgency arbitration + water-filling). Deferred grants
    land between control ticks through each env's ``grant_listener``.
  - **slot isolation is enforced, not assumed**: ``PartitionedEngine``
    fronts one backing engine (``EmulatedEngine`` or ``TorchEngineAdapter``)
    with per-tenant admit accounting — a tenant's admit is checked against
    *its own* granted slot count at admission AND every tick, so tenant A
    can never decode in tenant B's granted slots. Violations raise
    ``ServeInvariantError`` (never ``assert``: the checks survive
    ``python -O``).
  - **one decode step per tick, fleet-wide**: all tenants' active slots
    decode together in a single backing-engine step (continuous batching
    across the fleet); finished jids are routed back to their owning
    tenant's env. A tenant whose stream completes is destroyed mid-run,
    returning its slots to the pool for the others — which is where the
    consolidated fleet's billed node-hours fall below N dedicated engines.

The fleet's tick replays the SAME phases as ``ServeDriver._tick`` in the
same order (arrivals -> contention -> release checks -> engine step ->
scans -> admission flush -> invariants), phase-major across tenants, so a
``ServeFleet`` of one tenant is bit-identical to a standalone
``ServeDriver`` on the same stream and grant sequence — the parity
contract in ``tests/README.md``.

The ``dawningcloud-serve-fleet`` scenario registers in
``repro_torch.core.registry`` next to the emulated usage models: it carries the
fleet's policy/capacity defaults (pool sized at the peak hourly-averaged
offered decode load — the serving analogue of
``sim.systems.aggregate_hourly_peak``) and serves as the benchmark entry
point. It is tick-driven, not ``Sim``-driven, so it runs through
:meth:`ServeFleetSystem.serve` (or ``ServeFleet`` directly), not
``run_system``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Sequence

from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provider import ResourceProvider
from repro_torch.core.provision import BILL_UNIT_S
from repro_torch.core.registry import System, register_system
from repro_torch.core.tre import TickClock
from repro_torch.core.types import Job
from repro_torch.serve.driver import (
    EmulatedEngine, ServeDriver, ServeInvariantError, ServeStats,
    decode_budget, default_max_ticks, due_tick_floor, engine_service_ticks,
    replay_contention,
)
from repro_torch.serve.paged import PagedKVAllocator, pages_for
from repro_torch.serve.tenant import Tenant, TrainTenant, TrainTenantSpec


# --------------------------------------------------------------------------
# slot-partitioned engine front
# --------------------------------------------------------------------------
class TenantSlice:
    """One tenant's view of the shared pool: the 3-method engine adapter
    contract (``capacity`` / ``active_count`` / ``admit_many`` / ``step``)
    a ``ServeDriver`` expects, scoped to the tenant's own slots. Admits
    are accounted against the tenant's granted node units by the owning
    ``PartitionedEngine``; ``step()`` drains the finished jids the pool's
    fleet-wide decode step routed to this tenant. ``capacity_units`` is
    the whole pool in node units — the slot width is carried by the
    tenant's driver (``ServeDriver.slot_width``), which weights every
    slots-vs-units comparison."""

    def __init__(self, pool: "PartitionedEngine", tenant: str):
        self._pool = pool
        self.tenant = tenant
        self.capacity = pool.capacity
        self.capacity_units = pool.capacity

    @property
    def width(self) -> int:
        return self._pool.width_of(self.tenant)

    @property
    def active_count(self) -> int:
        return self._pool.active_of(self.tenant)

    def service_ticks(self, job: Job) -> int:
        return engine_service_ticks(self._pool.backing, job)

    def admit_many(self, jobs: Sequence[Job]) -> Sequence[Job]:
        return self._pool.admit_many(self.tenant, jobs)

    def step(self) -> list[int]:
        return self._pool.take_finished(self.tenant)

    def next_finish_in(self):
        """Pool-wide finish horizon (not per-tenant): another tenant's
        finish frees shared slots, so a lane's quiet span must end there
        too — conservative is correct for event-skipping."""
        fn = getattr(self._pool.backing, "next_finish_in", None)
        return fn() if fn is not None else None


class PartitionedEngine:
    """One backing engine, N tenant partitions with per-tenant slot
    widths. Owns the jid -> tenant routing and the *weighted* per-tenant
    accounting that makes isolation a checked invariant: a slot of a
    width-``w`` tenant costs ``w`` node units of the shared pool, so an
    admit beyond the tenant's granted units — or beyond the pool's unit
    capacity — raises ``ServeInvariantError`` (counted instead when
    ``strict=False``), and :meth:`check_isolation` re-asserts every
    tenant's ``active_slots * width <= granted`` plus
    ``sum_i(active_i * width_i) <= capacity`` at every fleet tick. An
    all-width-1 pool is bit-identical to the unweighted partitioning.

    With a ``pager`` (``PagedKVAllocator``) the isolation invariant is
    enforced *physically* in KV-cache pages, not just slot arithmetic:
    every admitted job allocates its cache-budget worth of pages under
    its tenant's tag, a tenant's page quota is its live granted units
    times ``pages_per_unit``, and :meth:`check_isolation` adds page
    conservation + per-tenant quota sweeps. A job's page need is capped
    at its slot's width worth of pages, so page accounting can never bind
    tighter than the slot arithmetic — the paged fleet's admit/stat
    behavior is field-for-field identical to the unpaged one, with the
    ledger checked on top. When the backing engine carries its own
    allocator (a paged ``repro_torch.serve.engine.Engine`` under
    ``TorchEngineAdapter``), the two ledgers' totals are cross-checked
    every tick."""

    def __init__(self, backing, *, strict: bool = True,
                 pager: PagedKVAllocator | None = None):
        self.backing = backing
        self.capacity = backing.capacity
        self.strict = strict
        self.pager = pager
        self.isolation_violations = 0
        self._granted = {}                  # tenant -> () -> granted units
        self._active: dict[str, int] = {}   # tenant -> active slots
        self._width: dict[str, int] = {}    # tenant -> units per slot
        self._owner: dict[int, str] = {}    # active jid -> tenant
        self._finished: dict[str, list[int]] = {}
        self._deferred: set[int] = set()    # jids truncated (counted once)
        # non-engine pool consumers (training tenants' gang-held nodes):
        # name -> () -> live node units, counted in the capacity sweep
        self._external: dict = {}

    # ------------------------------------------------------------ wiring
    def view(self, tenant: str, width: int = 1) -> TenantSlice:
        if tenant in self._active:
            raise ValueError(f"tenant {tenant!r} already has a slice")
        if width < 1:
            raise ValueError(f"slot width must be >= 1, got {width}")
        if width > self.capacity:
            raise ValueError(
                f"tenant {tenant!r} slot width {width} exceeds the pool "
                f"({self.capacity} units): one slot could never be granted")
        self._active[tenant] = 0
        self._width[tenant] = int(width)
        self._finished[tenant] = []
        return TenantSlice(self, tenant)

    def bind(self, tenant: str, granted) -> None:
        """Attach the tenant's granted-slot supplier (its env's live
        ``owned`` count) — the ceiling its admits are checked against.
        With a pager the same supplier prices the tenant's page quota:
        granted units times ``pages_per_unit``."""
        self._granted[tenant] = granted
        if self.pager is not None:
            self.pager.set_quota(
                tenant,
                lambda: self.granted_of(tenant) * self.pager.pages_per_unit)

    def attach_external(self, name: str, units) -> None:
        """Register a pool consumer that holds nodes WITHOUT decoding in
        engine slots (a training tenant's gang-held nodes): its live unit
        count joins the capacity sweep in :meth:`check_isolation`, so
        serve decode + training gangs together can never exceed the pool
        — the mixed-species form of the weighted isolation invariant."""
        if name in self._external or name in self._active:
            raise ValueError(f"pool consumer {name!r} already registered")
        self._external[name] = units

    @property
    def external_units(self) -> int:
        """Node units held by non-engine consumers (training gangs)."""
        return sum(fn() for fn in self._external.values())

    # ---------------------------------------------------------- accounts
    def active_of(self, tenant: str) -> int:
        return self._active[tenant]

    def width_of(self, tenant: str) -> int:
        return self._width[tenant]

    def units_of(self, tenant: str) -> int:
        """Node units the tenant's active slots occupy."""
        return self._active[tenant] * self._width[tenant]

    @property
    def active_total(self) -> int:
        return sum(self._active.values())

    @property
    def active_units(self) -> int:
        """Weighted occupancy of the whole pool, in node units."""
        return sum(a * self._width[t] for t, a in self._active.items())

    def granted_of(self, tenant: str) -> int:
        fn = self._granted.get(tenant)
        return fn() if fn is not None else self.capacity

    def _violate(self, msg: str) -> None:
        self.isolation_violations += 1
        if self.strict:
            raise ServeInvariantError(msg)

    # ------------------------------------------------------------- admit
    def admit_many(self, tenant: str, jobs: Sequence[Job]) -> list[Job]:
        """Admit the tenant's batch; returns the jobs actually admitted.
        In strict mode that is all of them or a raise; a non-strict pool
        may truncate to what fits, and the CALLER must requeue the
        remainder (``ServeDriver._flush_admissions`` keeps it in the
        launch buffer) — dropping it silently loses workflows."""
        if not jobs:
            return []
        w = self._width[tenant]
        granted = self.granted_of(tenant)
        if (self._active[tenant] + len(jobs)) * w > granted:
            self._violate(
                "tenant %r admitting into another tenant's slots: "
                "(%d active + %d admitted) slots x width %d > "
                "%d granted units"
                % (tenant, self._active[tenant], len(jobs), w, granted))
        free = self.capacity - self.active_units
        if len(jobs) * w > free:
            # non-strict (counting) mode must not crash in the backing
            # engine: count the pool-level violation here and admit only
            # what fits — the remainder is returned to the caller's
            # launch buffer, never dropped. The caller retries that
            # remainder every tick, so a violation is counted only when
            # the batch contains jobs not already deferred — the counter
            # measures over-commit events, not backlog duration
            fit = max(free // w, 0)
            dropped = list(jobs)[fit:]
            if self.strict or any(j.jid not in self._deferred
                                  for j in dropped):
                self._violate(
                    "admitting beyond the pool: %d jobs x width %d > "
                    "%d free units"
                    % (len(jobs), w, free))
            self._deferred.update(j.jid for j in dropped)
            jobs = list(jobs)[:fit]
            if not jobs:
                return []
        for job in jobs:
            if job.jid in self._owner:
                raise ValueError(
                    f"jid {job.jid} already active (owned by "
                    f"{self._owner[job.jid]!r}); fleet streams need "
                    f"globally unique jids")
        self.backing.admit_many(jobs)       # raises beyond pool free slots
        self._active[tenant] += len(jobs)
        for job in jobs:
            self._owner[job.jid] = tenant
            self._deferred.discard(job.jid)
            if self.pager is not None:
                # the slot check above passed, and a job never needs more
                # pages than its slot's width worth — so this alloc can
                # only fail if the ledgers disagree (an invariant error)
                self.pager.alloc(job.jid, self._job_pages(tenant, job),
                                 tenant=tenant)
        return list(jobs)

    def _job_pages(self, tenant: str, job: Job) -> int:
        """Pages a job's cache budget needs, capped at its slot's width
        worth. Sized with THE shared ``decode_budget`` formula against
        the backing engine's cache depth, so a physically-paged backing
        engine (``Engine(page_size=...)``) reserves the same totals and
        the two ledgers stay cross-checkable."""
        g = self.pager
        quota_pages = self._width[tenant] * g.pages_per_unit
        depth = getattr(self.backing, "max_len", None)
        if depth is None:
            depth = quota_pages * g.page_size
        plen = min(max(job.prompt_len, 1), depth - 1)
        budget = decode_budget(job.decode_len, plen, depth)
        return min(pages_for(plen + budget, g.page_size), quota_pages)

    # -------------------------------------------------------------- step
    def step_all(self) -> None:
        """ONE decode tick for the whole pool; route finished jids to
        their owning tenant's buffer (drained by the slices' ``step``)."""
        for jid in self.backing.step():
            tenant = self._owner.pop(jid)
            self._active[tenant] -= 1
            self._finished[tenant].append(jid)
            if self.pager is not None:
                self.pager.free(jid)

    def take_finished(self, tenant: str) -> list[int]:
        out = self._finished[tenant]
        self._finished[tenant] = []
        return out

    # -------------------------------------------------------- invariants
    def check_isolation(self) -> None:
        """Every tick: no tenant decodes beyond its granted node units,
        and the weighted partitions together never exceed the pool —
        ``sum_i(active_i * width_i) <= capacity``, the heterogeneous
        isolation invariant."""
        for tenant, active in self._active.items():
            granted = self.granted_of(tenant)
            units = active * self._width[tenant]
            if units > granted:
                self._violate(
                    "tenant %r decoding in foreign slots: %d active x "
                    "width %d > %d granted units"
                    % (tenant, active, self._width[tenant], granted))
        ext = self.external_units
        if self.active_units + ext > self.capacity:
            if ext:
                self._violate(
                    "partitions exceed the pool: %d active + %d external "
                    "(training) units > %d"
                    % (self.active_units, ext, self.capacity))
            else:
                self._violate(
                    "partitions exceed the pool: %d active units > %d"
                    % (self.active_units, self.capacity))
        if self.pager is not None:
            # the physical form of the same invariant: pages conserved,
            # no tenant mapping pages beyond its granted quota
            self.pager.check_conservation()
            backing_pager = getattr(self.backing, "pager", None)
            if (backing_pager is not None
                    and backing_pager.used_pages != self.pager.used_pages):
                self._violate(
                    "page ledger divergence: engine maps %d pages, pool "
                    "accounts %d"
                    % (backing_pager.used_pages, self.pager.used_pages))


def rekey_disjoint(tenant_streams):
    """Clone per-tenant streams onto disjoint jid ranges (deps remapped in
    step) so independently-generated ``request_stream``s — which each
    re-key from 0 — can share one ``PartitionedEngine``. Job objects are
    replaced, not mutated; pass the clones wherever task timings are read
    back."""
    out, base = [], 0
    for stream in tenant_streams:
        jids = [j.jid for _, jobs in stream for j in jobs]
        lo = min(jids, default=0)
        off = base - lo
        out.append([(t, [replace(j, jid=j.jid + off,
                                 deps=tuple(d + off for d in j.deps))
                         for j in jobs]) for t, jobs in stream])
        base += (max(jids, default=lo) - lo + 1) if jids else 0
    return out


# --------------------------------------------------------------------------
# the fleet
# --------------------------------------------------------------------------
@dataclass
class FleetStats:
    """One fleet run: aggregates + the per-tenant ``ServeStats``."""
    name: str
    n_tenants: int
    capacity: int
    coordination: str
    ticks: int = 0
    tick_s: float = 1.0
    workflows_expected: int = 0
    workflows_completed: int = 0
    tasks_completed: int = 0
    makespan_s: float = 0.0
    busy_node_ticks: float = 0.0
    owned_node_ticks: float = 0.0
    slot_utilization: float = 0.0       # busy / owned integrals (leased)
    pool_utilization: float = 0.0       # busy integral / (capacity x span)
    node_hours: float = 0.0             # billed, summed over tenants
    peak_pool_active: int = 0           # peak fleet-wide busy slots
    peak_pool_units: int = 0            # peak width-weighted busy units
    widths: list[int] = field(default_factory=list)  # per-tenant slot width
    deferred_grants: int = 0
    deferred_nodes: int = 0
    over_admissions: int = 0            # summed over tenants (== 0)
    isolation_violations: int = 0       # PartitionedEngine checks (== 0)
    tenants: list[dict] = field(default_factory=list)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class ServeFleet:
    """N ``ServeDriver`` tenants partitioning one engine pool.

    tenant_streams: one ``request_stream``-style arrival stream per
        tenant. Jids must be globally unique ACROSS tenants (the shared
        engine routes finishes by jid): offset each tenant's stream, or
        build them with disjoint bases as ``benchmarks/serve_fleet.py``
        does.
    engine: the backing engine for the whole pool (``EmulatedEngine`` /
        ``TorchEngineAdapter``); its capacity IS the platform capacity.
    provider: optional pre-built ``ResourceProvider``; must have
        ``capacity == engine.capacity`` (1 slot = 1 node). Default: one is
        built with ``coordination`` / ``quotas`` / ``reservations``.
    policies: one ``MgmtPolicy`` for every tenant, or a per-tenant list.
    stagger: spread tenants' scan/release cycles across their intervals
        (phase ``i * interval / N``) so N tenants' control ticks
        interleave instead of colliding; a single tenant keeps phase 0,
        which is what makes ``ServeFleet`` of one tenant bit-identical to
        ``ServeDriver``.
    contention: fleet-level co-tenant load replayed against the provider,
        same format as ``ServeDriver``'s.
    widths: per-tenant slot widths in node units (the heterogeneous-fleet
        axis: a big-model tenant's batching slot costs ``w > 1`` units of
        the shared pool). Every task of tenant ``i`` must carry
        ``nodes == widths[i]`` — provider grants and env accounting are
        unit-denominated. Default: all 1 (bit-identical to the
        homogeneous fleet).
    page_size: tokens per KV page. When set, the pool's weighted
        isolation is enforced physically through a ``PagedKVAllocator``
        sized at ``capacity * ceil(max_len / page_size)`` pages — every
        admit allocates real pages under its tenant, quotas follow live
        grants, and conservation is swept each tick. Requires the backing
        engine to expose ``max_len`` (its cache depth prices a job's page
        need). Stats are unchanged field-for-field; the ledger rides
        underneath.
    train: ``TrainTenantSpec``s for gang-scheduled HTC training tenants
        sharing the provider pool (``repro_torch.serve.tenant.TrainTenant``).
        Their gangs hold provider nodes without decoding in engine
        slots, so they join the isolation sweep as *external* pool
        consumers: serve decode units + training gang units <= capacity,
        every tick. They preempt themselves for parked serve demand and
        appear in ``FleetStats.tenants`` next to the serve lanes. The
        default (none) leaves the all-MTC fleet bit-identical to one without it.
    """

    def __init__(self, tenant_streams: Sequence[Sequence[tuple[float, list[Job]]]],
                 *, engine, provider: ResourceProvider | None = None,
                 coordination="first-come",
                 quotas=None, reservations=None,
                 policies: MgmtPolicy | Sequence[MgmtPolicy] = None,
                 names: Sequence[str] | None = None,
                 tick_s: float = 1.0, stagger: bool = True,
                 contention: Sequence[tuple[float, str, int]] = (),
                 scheduler=None, max_ticks: int | None = None,
                 strict: bool = True, name: str = "serve-fleet",
                 widths: Sequence[int] | None = None,
                 event_skip: bool = False,
                 page_size: int | None = None,
                 train: Sequence[TrainTenantSpec] = ()):
        if not tenant_streams:
            raise ValueError("a fleet needs at least one tenant stream")
        n = len(tenant_streams)
        widths = [1] * n if widths is None else [int(w) for w in widths]
        if len(widths) != n:
            raise ValueError("need one slot width per tenant")
        seen: dict[int, int] = {}
        for i, stream in enumerate(tenant_streams):
            for _, jobs in stream:
                for j in jobs:
                    if j.jid in seen:
                        raise ValueError(
                            f"jid {j.jid} appears in tenant {seen[j.jid]} "
                            f"and tenant {i}: fleet streams must use "
                            f"globally unique jids (offset each tenant)")
                    seen[j.jid] = i
                    if j.nodes != widths[i]:
                        raise ValueError(
                            f"tenant {i} task {j.name!r} carries "
                            f"nodes={j.nodes} but the tenant's slot width "
                            f"is {widths[i]}: streams must be emitted at "
                            f"the tenant's width (request_stream(width=))")
        if provider is None:
            provider = ResourceProvider(
                engine.capacity, coordination=coordination,
                quotas=quotas, reservations=reservations)
        if provider.capacity != engine.capacity:
            raise ValueError(
                f"provider capacity ({provider.capacity}) must equal the "
                f"engine pool ({engine.capacity}): 1 batching slot = 1 node")
        if policies is None:
            policies = MgmtPolicy.mtc(4, 2.0)
        if isinstance(policies, MgmtPolicy):
            policies = [policies] * n
        if len(policies) != n:
            raise ValueError("need one policy per tenant")
        names = list(names) if names is not None else [
            f"{name}-t{i}" for i in range(n)]
        self.name = name
        self.provider = provider
        if page_size is not None:
            depth = getattr(engine, "max_len", None)
            if depth is None:
                raise ValueError(
                    "page_size needs an engine with a max_len cache depth "
                    "to price page quotas (EmulatedEngine(max_len=...) or "
                    "a paged engine)")
            ppu = -(-int(depth) // int(page_size))
            pager = PagedKVAllocator(engine.capacity * ppu,
                                     page_size=int(page_size),
                                     pages_per_unit=ppu)
        else:
            pager = None
        self.pool = PartitionedEngine(engine, strict=strict, pager=pager)
        self.clock = TickClock()
        self.tick_s = tick_s
        self.strict = strict
        self._contention = sorted(contention, key=lambda e: e[0])
        self._cont_i = 0
        self.lanes: list[Tenant] = []
        for i, (stream, pol, tname, w) in enumerate(
                zip(tenant_streams, policies, names, widths)):
            every = max(int(round(pol.scan_interval / tick_s)), 1)
            phase = int(round(i * every / n)) % every if stagger else 0
            lane = ServeDriver(
                stream, provider=provider,
                engine=self.pool.view(tname, width=w),
                policy=pol, name=tname, scheduler=scheduler,
                tick_s=tick_s, strict=strict, clock=self.clock, phase=phase,
                slot_width=w)
            self.pool.bind(tname, lambda env=lane.env: env.owned)
            self.lanes.append(lane)
        # training tenants: gang-held nodes come from the SAME provider
        # pool, counted against capacity through the pool's external sweep
        # (they hold nodes without decoding in engine slots)
        for i, spec in enumerate(train):
            tname = spec.name or f"{name}-train{i}"
            every = max(int(round(spec.policy.scan_interval / tick_s)), 1)
            phase = (int(round((n + i) * every / (n + len(train)))) % every
                     if stagger else 0)
            tt = TrainTenant(
                spec.jobs, provider=provider, clock=self.clock,
                policy=spec.policy, name=tname, tick_s=tick_s,
                strict=strict, phase=phase, max_nodes=engine.capacity,
                preempt_check_s=spec.preempt_check_s)
            self.pool.attach_external(tname, lambda env=tt.env: env.busy)
            self.lanes.append(tt)
        self._live = list(self.lanes)
        if max_ticks is None:
            merged = [ev for s in tenant_streams for ev in s]
            max_ticks = default_max_ticks(merged, engine, tick_s)
            for lane in self.lanes:
                if isinstance(lane, TrainTenant):
                    max_ticks = max(max_ticks, lane.max_ticks)
        self.max_ticks = max_ticks
        # fleet-level event-skipping: a tick is quiet only if it is quiet
        # for EVERY lane (and the shared pool can jump its countdowns)
        self.event_skip = bool(event_skip) and callable(
            getattr(engine, "next_finish_in", None)) and callable(
            getattr(engine, "advance_quiet", None))
        self.stats = FleetStats(
            name=name, n_tenants=n, capacity=engine.capacity,
            coordination=getattr(provider.policy, "name", "?"),
            tick_s=tick_s, widths=list(widths),
            workflows_expected=sum(len(s) for s in tenant_streams))

    # -------------------------------------------------------------- tick
    def _replay_contention(self, now: float) -> None:
        self._cont_i = replay_contention(self.provider, self._contention,
                                         self._cont_i, now, self.strict)

    def _tick(self, k: int) -> None:
        """``ServeDriver._tick``'s phases, phase-major across tenants,
        with ONE fleet-wide decode step between the release and scan
        phases — driven through the ``Tenant`` protocol hooks, which for
        a serve lane alias exactly the old phase methods (so the all-MTC
        fleet is bit-identical to the pre-protocol tick; pinned by
        ``tests/test_tenant.py``). A training lane's ``pre_step`` is its
        preemption check — deliberately in the release phase, so vacated
        nodes drain to parked serve requests before this tick's scans.
        Keep the order mirrored with the single-tenant tick body or
        fleet(N=1) parity breaks."""
        now = self.clock.now()
        for lane in self._live:
            lane.begin_tick(now)
        self._replay_contention(now)
        for lane in self._live:
            lane.pre_step(k)
        self.pool.step_all()
        for lane in self._live:
            lane.post_step(k)
        for lane in self._live:
            lane.control(k)
        for lane in self._live:
            lane.flush()
        for lane in self._live:
            lane.check_invariants()
        self.pool.check_isolation()
        for lane in self._live:
            lane.accumulate()
        self.stats.peak_pool_active = max(self.stats.peak_pool_active,
                                          self.pool.active_total)
        self.stats.peak_pool_units = max(self.stats.peak_pool_units,
                                         self.pool.active_units)
        # retire completed tenants: the destroy closes their leases and
        # hands the slots back to the pool for everyone still running —
        # the consolidation saving a dedicated engine can never realize
        for lane in [ln for ln in self._live if ln.retired]:
            lane.finalize(k)
            self._live.remove(lane)

    # ---------------------------------------------------- event-skipping
    def next_event_tick(self, k: int) -> int:
        """Earliest tick after ``k`` at which ANY lane could act — the
        fleet-wide quiet span is the min over the lanes' horizons (each
        lane's already folds in the shared pool's next finish through
        ``TenantSlice.next_finish_in``, so one tenant's finish ends every
        lane's quiet span: the freed slots are shared). The fleet-level
        contention stream is a separate candidate — it replays against
        the shared provider outside any lane."""
        cands = [lane.next_event_tick(k) for lane in self._live]
        if self._cont_i < len(self._contention):
            cands.append(due_tick_floor(self._contention[self._cont_i][0],
                                        self.tick_s))
        if not cands:
            return self.max_ticks
        return max(min(cands), k + 1)

    def _skip_quiet(self, dq: int) -> None:
        """Advance ``dq`` fleet-quiet ticks in closed form: ONE pool-wide
        countdown jump plus each live lane's stats integrals — the exact
        batch of what ``dq`` dense fleet ticks would have done (the pool
        refuses to jump past a finish)."""
        if self.pool.backing.active_count:
            self.pool.backing.advance_quiet(dq)
        for lane in self._live:
            lane.skip_quiet_stats(dq)
        self.clock.advance(self.tick_s * dq)

    # --------------------------------------------------------------- run
    def run(self) -> FleetStats:
        k = 0
        self._tick(k)
        while self._live and k < self.max_ticks:
            if self.event_skip:
                kn = min(self.next_event_tick(k), self.max_ticks)
                dq = kn - k - 1
                if dq > 0:
                    self._skip_quiet(dq)
                    k += dq
            k += 1
            self.clock.advance(self.tick_s)
            self._tick(k)
        # tick-budget cutoff stragglers: withdraw every parked request
        # BEFORE the finalize loop — one lane's destroy releases its
        # nodes, and a grant landing in another straggler's queue between
        # two destroys would open a zero-duration lease billed a whole
        # hour (same guard as the emulator teardown in sim.systems)
        now = self.clock.now()
        for lane in self._live:
            lane.teardown(now)
        for lane in self._live:
            lane.finalize(k)
        self._live = []
        s = self.stats
        s.ticks = k
        s.makespan_s = self.clock.now()
        for lane in self.lanes:
            lane.rollup(s)
        if s.owned_node_ticks > 0:
            s.slot_utilization = s.busy_node_ticks / s.owned_node_ticks
        span = max(s.makespan_s, self.tick_s)
        s.pool_utilization = s.busy_node_ticks / (s.capacity * span)
        s.isolation_violations = self.pool.isolation_violations
        return s


# --------------------------------------------------------------------------
# registered scenario
# --------------------------------------------------------------------------
def aggregate_decode_peak(tenant_streams, *, tick_s: float = 1.0) -> int:
    """Peak hourly-averaged offered decode load across the whole fleet, in
    node units — the serving analogue of ``sim.systems.
    aggregate_hourly_peak``: the unit count that serves every hour's
    *arriving* decode work within that hour. Width-weighted: a task of a
    width-``w`` tenant (``j.nodes == w``) occupies ``w`` units for its
    service ticks, so heterogeneous capacity planning charges big-model
    work at its true pool cost. Sub-hour bursts queue in the envs instead
    of being provisioned for, so the pool grows sublinearly in the tenant
    count while each tenant's dedicated engine must cover its own peak
    hour."""
    buckets: dict[int, float] = {}
    for stream in tenant_streams:
        for t, jobs in stream:
            # same service model as EmulatedEngine.service_ticks: token
            # marks when present, else runtime in ticks — capacity
            # planning must count the work the engine will actually
            # serve, weighted by each task's node units
            work = sum((j.decode_len if j.decode_len > 0
                        else max(int(math.ceil(j.runtime / tick_s)), 1))
                       * max(j.nodes, 1)
                       for j in jobs) * tick_s
            buckets[int(t // BILL_UNIT_S)] = (
                buckets.get(int(t // BILL_UNIT_S), 0.0) + work)
    if not buckets:
        return 1
    return max(int(math.ceil(max(buckets.values()) / BILL_UNIT_S)), 1)


@register_system("dawningcloud-serve-fleet")
class ServeFleetSystem(System):
    """Multi-tenant trace-rate serving (the serve-path counterpart of
    ``dawningcloud-coordinated``): N serve TREs on one engine pool sized
    at the peak hourly-averaged offered decode load, slots partitioned by
    the coordination policy. Tick-driven rather than ``Sim``-driven, so
    it runs through :meth:`serve`, not ``run_system``."""

    coordination = "coordinated"

    def default_policy(self) -> MgmtPolicy:
        # MTC serving: small never-released floor, eager growth, 5-minute
        # release windows (the 3 s scans are the MTC §3.2.2.2 cadence)
        return MgmtPolicy(initial=4, ratio=2.0, scan_interval=3.0,
                          release_interval=300.0)

    def default_capacity(self, tenant_streams, policies,
                         tick_s: float = 1.0,
                         widths: Sequence[int] | None = None) -> int:
        hourly = aggregate_decode_peak(tenant_streams, tick_s=tick_s)
        # liveness floor: every tenant's never-released B must coexist
        # with at least one more slot of the widest tenant to drain
        # (1 MTC task = width node units)
        sum_b = sum(p.initial for p in policies)
        return max(hourly, sum_b + max(widths or (1,)))

    def build(self, ctx, workload):
        raise NotImplementedError(
            f"{self.name} is tick-driven (TickClock), not "
            "Sim-driven: use ServeFleetSystem.serve(tenant_streams, ...) "
            "or repro_torch.serve.fleet.ServeFleet directly")

    def serve(self, tenant_streams, *, capacity: int | None = None,
              coordination=None, policies=None, engine=None,
              widths: Sequence[int] | None = None,
              **fleet_kw) -> FleetStats:
        """Build and run a fleet over ``tenant_streams`` with this
        scenario's defaults (an ``EmulatedEngine`` pool sized by
        :meth:`default_capacity` unless given)."""
        n = len(tenant_streams)
        if policies is None:
            policies = [self.default_policy()] * n
        elif isinstance(policies, MgmtPolicy):
            policies = [policies] * n
        if engine is None:
            if capacity is None:
                capacity = self.default_capacity(
                    tenant_streams, policies,
                    tick_s=fleet_kw.get("tick_s", 1.0), widths=widths)
            engine = EmulatedEngine(capacity,
                                    tick_s=fleet_kw.get("tick_s", 1.0))
        fleet = ServeFleet(
            tenant_streams, engine=engine,
            coordination=coordination if coordination is not None
            else self.coordination,
            policies=list(policies), widths=widths, **fleet_kw)
        return fleet.run()


@register_system("dawningcloud-serve-hetero")
class ServeHeteroFleetSystem(ServeFleetSystem):
    """Heterogeneous serving fleet: tenants of MIXED slot widths / model
    sizes consolidated on one weighted pool — the configuration the
    paper's economies-of-scale argument (§2, §5; arXiv:1004.1276 across
    communities of different sizes) is actually about. Tenant ``i``
    defaults to ``width_mix[i % len(width_mix)]`` node units per slot
    (small / medium / large model classes); grants, isolation and
    capacity planning are width-weighted throughout, and the billed
    node-hours come out in the same units as a dedicated width-sized
    engine's, so the consolidation ratio stays apples-to-apples."""

    width_mix: tuple[int, ...] = (1, 2, 4)

    def tenant_widths(self, n: int) -> list[int]:
        """Default width assignment: cycle the mix across the tenants."""
        return [self.width_mix[i % len(self.width_mix)] for i in range(n)]

    def default_policy(self, width: int = 1) -> MgmtPolicy:
        # the homogeneous scenario's 4-slot floor, priced at this
        # tenant's width (B and every grant are node units)
        base = super().default_policy()
        return replace(base, initial=base.initial * width)

    def serve(self, tenant_streams, *, widths=None, policies=None,
              **kw) -> FleetStats:
        n = len(tenant_streams)
        if widths is None:
            widths = self.tenant_widths(n)
        if policies is None:
            policies = [self.default_policy(w) for w in widths]
        return super().serve(tenant_streams, widths=widths,
                             policies=policies, **kw)


@register_system("dawningcloud-train-serve")
class TrainServeFleetSystem(ServeHeteroFleetSystem):
    """Train+serve consolidation: MTC serve tenants AND gang-scheduled
    HTC training tenants on ONE provider pool — the paper's
    heterogeneous-workload claim in its modern form (preemptible training
    soaking the serve troughs; the companion study arXiv:1004.1276 asks
    the same economies-of-scale question for batch-shaped scientific
    communities). Serve lanes keep the hetero scenario's defaults;
    training jobs ride in as ``TrainTenantSpec``s whose never-released
    floor (``MgmtPolicy.initial``) is added to the capacity plan so a
    parked gang floor can never strand the serve path."""

    def default_train_policy(self, world_min: int) -> MgmtPolicy:
        # HTC cadence (§3.2.2.2): 60 s scans, hourly release windows; the
        # floor is one smallest gang so a preempted tenant can always
        # restart its narrowest job without renegotiating
        return MgmtPolicy(initial=world_min, ratio=2.0,
                          scan_interval=60.0, release_interval=3600.0)

    def serve(self, tenant_streams, *, train_jobs=(), train_policy=None,
              train_specs: Sequence[TrainTenantSpec] = (),
              capacity: int | None = None, engine=None,
              widths=None, policies=None, **kw) -> FleetStats:
        """Run the mixed fleet: ``train_jobs`` become one training tenant
        (or pass prebuilt ``train_specs`` for several). Capacity defaults
        to the serve plan plus the training tenants' gang floors."""
        n = len(tenant_streams)
        if widths is None:
            widths = self.tenant_widths(n)
        if policies is None:
            policies = [self.default_policy(w) for w in widths]
        specs = list(train_specs)
        if train_jobs:
            floor = max(j.world_min for j in train_jobs)
            pol = (train_policy if train_policy is not None
                   else self.default_train_policy(floor))
            specs.append(TrainTenantSpec(jobs=tuple(train_jobs),
                                         policy=pol))
        if engine is None and capacity is None:
            capacity = self.default_capacity(
                tenant_streams, policies,
                tick_s=kw.get("tick_s", 1.0), widths=widths)
            capacity += sum(s.policy.initial for s in specs)
        return super().serve(tenant_streams, capacity=capacity,
                             engine=engine, widths=widths,
                             policies=policies, train=tuple(specs), **kw)
