"""Resource provision service (paper §3.1.2, §3.2.2.3) with lease accounting.

Grant-or-reject provisioning plus the metrics the paper evaluates:
  - per-TRE resource consumption in node*hours, billed per *started* hour
    (the paper's one-hour leasing time unit, §4.4(2)),
  - the provider's total + peak allocation ("nodes per hour", Fig 13),
  - accumulated node-adjustment counts and the setup overhead they imply
    (15.743 s per adjusted node, §4.5.4).

Leases are block-structured: every grant opens a block, releases close the
newest blocks first (matching ``PolicyEngine``'s LIFO block release), and a
partial release splits a block so billing stays exact.

Two request paths exist since the multi-tenant refactor:

  - :meth:`ProvisionService.request` — the raw grant-or-reject ledger entry
    (lifecycle creation, DRP end-user leases, internal lease opening);
  - :meth:`ProvisionService.submit_request` — the negotiation path used by
    ``RuntimeEnv`` DR1/DR2 scans. It carries a :class:`ResourceRequest`
    whose ``on_grant`` callback lets the provider complete a grant *later*
    (``repro_torch.core.provider.ResourceProvider`` parks rejected requests in an
    admission queue and re-grants on release). The base class keeps the
    paper's plain provision policy: grant now if available, else reject —
    nothing is ever queued, so the behavior is bit-for-bit the pre-refactor
    grant-or-reject bool.

The accounting hot paths (:meth:`node_hours`, :meth:`peak_nodes_per_hour`)
are NumPy-vectorized over columnar lease/event arrays — at fleet scale
(``benchmarks/scale_curve.py`` sweeps N providers x seeds) they dominate
the post-simulation cost. The per-lease Python reference implementations
are kept as ``*_loop`` for the benchmark comparison and equivalence tests.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

SETUP_COST_PER_NODE_S = 15.743   # measured in the paper's real test
BILL_UNIT_S = 3600.0             # one-hour leasing time unit


@dataclass
class Lease:
    tre: str
    nodes: int
    t0: float
    t1: float = -1.0             # -1 = still open

    def billed_hours(self, now: float) -> float:
        end = self.t1 if self.t1 >= 0 else now
        return math.ceil(max(end - self.t0, 1e-9) / BILL_UNIT_S)

    def billed_node_hours(self, now: float) -> float:
        return self.nodes * self.billed_hours(now)


@dataclass
class AdjustEvent:
    t: float
    tre: str
    delta: int                    # +granted / -released


# grant callback: (offered nodes, time) -> nodes accepted. The callee must
# commit its own bookkeeping for the returned amount; the provider opens the
# lease for exactly what was accepted.
GrantCallback = Callable[[int, float], int]


@dataclass
class ResourceRequest:
    """One DR1/DR2 negotiation in flight against the provision service.

    ``status`` lifecycle: ``granted`` (completed, possibly for less than
    asked if the requester's need shrank), ``queued`` (parked in a
    multi-tenant admission queue awaiting capacity), ``rejected`` (plain
    grant-or-reject provision with no queue), ``cancelled`` (withdrawn by
    the requester or stale at grant time).
    """
    tre: str
    nodes: int
    t: float                       # submission time (FIFO age — amends keep it)
    on_grant: GrantCallback
    count_adjust: bool = True
    priority: float = 0.0          # requester urgency (ratio of obtaining
    # resources, §3.2.2.1) — coordinated arbitration orders by it
    min_useful: int = 1            # smallest grant that lets the requester
    # progress: 1 for a divisible DR1 backlog, the whole deficit for an
    # indivisible DR2 (a single job wider than everything owned)
    status: str = "pending"
    granted: int = 0               # total nodes granted so far
    seq: int = field(default=0, compare=False)   # FIFO tiebreak


class ProvisionService:
    """The CSF resource provision service. ``capacity=None`` = unbounded
    (DRP peak measurement); DawningCloud runs use the platform size."""

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity
        self.allocated: dict[str, int] = {}
        self.open_leases: dict[str, list[Lease]] = {}
        self.closed_leases: list[Lease] = []
        self.adjust_events: list[AdjustEvent] = []
        # preemption ledger: nodes reclaimed from (negative delta) and
        # resumed to (positive delta) preemptible tenants — the lease
        # checkpoint/resume bookkeeping the train+serve consolidation
        # bench audits (how much churn did trough-soaking cost?)
        self.preempt_events: list[AdjustEvent] = []
        self.resume_events: list[AdjustEvent] = []
        self._alloc_curve: list[tuple[float, int]] = [(0.0, 0)]
        # columnar mirror of closed_leases (appended in lockstep by
        # _close) so the vectorized accounting never walks Lease objects
        self._tre_ids: dict[str, int] = {}
        self._c_tre: list[int] = []
        self._c_t0: list[float] = []
        self._c_t1: list[float] = []
        self._c_nodes: list[int] = []
        self._c_arrays: tuple | None = None   # ndarray cache of the above

    # ------------------------------------------------------------ state
    @property
    def total_allocated(self) -> int:
        return sum(self.allocated.values())

    def available(self) -> int | None:
        if self.capacity is None:
            return None
        return self.capacity - self.total_allocated

    def _record(self, t: float):
        self._alloc_curve.append((t, self.total_allocated))

    def _tre_id(self, tre: str) -> int:
        return self._tre_ids.setdefault(tre, len(self._tre_ids))

    def _close(self, lease: Lease) -> None:
        self.closed_leases.append(lease)
        self._c_tre.append(self._tre_id(lease.tre))
        self._c_t0.append(lease.t0)
        self._c_t1.append(lease.t1)
        self._c_nodes.append(lease.nodes)
        self._c_arrays = None

    def _closed_arrays(self):
        """ndarray view of the closed-lease columns, cached between closes
        — metric queries (one per tenant + one total per experiment) must
        not re-convert the whole ledger every call."""
        if self._c_arrays is None:
            self._c_arrays = (np.asarray(self._c_tre),
                              np.asarray(self._c_t0),
                              np.asarray(self._c_t1),
                              np.asarray(self._c_nodes, dtype=float))
        return self._c_arrays

    # ---------------------------------------------------------- actions
    def request(self, tre: str, n: int, t: float, *, count_adjust=True) -> bool:
        """Grant ``n`` nodes to ``tre`` or reject (provision policy)."""
        if n <= 0:
            return True
        if self.capacity is not None and self.total_allocated + n > self.capacity:
            return False
        self.allocated[tre] = self.allocated.get(tre, 0) + n
        self.open_leases.setdefault(tre, []).append(Lease(tre, n, t))
        if count_adjust:
            self.adjust_events.append(AdjustEvent(t, tre, n))
        self._record(t)
        return True

    def submit_request(self, tre: str, n: int, t: float, *,
                       on_grant: GrantCallback, count_adjust: bool = True,
                       priority: float = 0.0,
                       min_useful: int = 1) -> ResourceRequest:
        """Negotiation path for DR1/DR2 scans: the paper's plain provision
        policy — grant immediately if available, else reject. Nothing
        queues here; ``repro_torch.core.provider.ResourceProvider`` overrides
        this with admission queueing and coordinated arbitration."""
        req = ResourceRequest(tre, n, t, on_grant, count_adjust, priority,
                              min_useful)
        if n <= 0:
            req.status = "granted"
            return req
        avail = self.available()
        if avail is not None and avail < n:
            req.status = "rejected"
            return req
        take = on_grant(n, t)
        if take > 0:
            ok = self.request(tre, take, t, count_adjust=count_adjust)
            if not ok:
                # availability was checked above and nothing ran between:
                # a failure means the requester accepted more than offered
                raise RuntimeError(
                    f"grant exceeds capacity: {take} nodes to {tre!r} "
                    f"(offered {n}) at t={t}")
            req.granted = take
            req.status = "granted"
        else:
            req.status = "cancelled"     # requester declined (stale need)
        return req

    def amend(self, req: ResourceRequest, n: int, t: float,
              min_useful: int = 1,
              priority: float | None = None) -> ResourceRequest:
        """Refresh a queued request with the requester's live deficit. The
        base service never queues, so this only adjusts the record."""
        if req.status == "queued":       # pragma: no cover - base never queues
            req.nodes = n
            req.min_useful = min_useful
            if priority is not None:
                req.priority = priority
        return req

    def cancel(self, req: ResourceRequest, t: float | None = None, *,
               drain: bool = True) -> None:
        if req.status in ("pending", "queued"):
            req.status = "cancelled"

    def release(self, tre: str, n: int, t: float, *, count_adjust=True) -> None:
        """Passively reclaim ``n`` nodes (closes newest lease blocks first)."""
        if n <= 0:
            return
        held = self.allocated.get(tre, 0)
        if held < n:
            # guarded raise, not assert: releasing more than held would
            # silently corrupt lease accounting under ``python -O``
            raise RuntimeError(
                f"release exceeds holding: {n} nodes from {tre!r} "
                f"(holds {held}) at t={t}")
        self.allocated[tre] -= n
        remaining = n
        blocks = self.open_leases[tre]
        while remaining > 0:
            blk = blocks[-1]
            if blk.nodes <= remaining:
                blocks.pop()
                blk.t1 = t
                self._close(blk)
                remaining -= blk.nodes
            else:
                blk.nodes -= remaining
                self._close(Lease(tre, remaining, blk.t0, t))
                remaining = 0
        if count_adjust:
            self.adjust_events.append(AdjustEvent(t, tre, -n))
        self._record(t)

    def destroy(self, tre: str, t: float, *, count_adjust: bool = True) -> None:
        n = self.allocated.get(tre, 0)
        if n:
            self.release(tre, n, t, count_adjust=count_adjust)

    # ------------------------------------------------- preemption ledger
    def preempt(self, tre: str, n: int, t: float, *,
                count_adjust: bool = True) -> None:
        """Release ``n`` nodes a preemptible tenant vacated for foreign
        demand. Lease mechanics are a plain :meth:`release` (newest
        blocks close first — the dynamic blocks a training gang grew
        into); the separate ledger entry is what distinguishes *forced*
        churn from a tenant's own idle-release cadence."""
        if n <= 0:
            return
        self.preempt_events.append(AdjustEvent(t, tre, -n))
        self.release(tre, n, t, count_adjust=count_adjust)

    def record_resume(self, tre: str, n: int, t: float) -> None:
        """Record a preempted tenant relaunching ``n`` nodes' worth of
        work from its checkpoint (the grant itself came through the
        normal request path — this is ledger-only)."""
        if n <= 0:
            return
        self.resume_events.append(AdjustEvent(t, tre, n))

    def preempt_count(self, tre: str | None = None) -> int:
        return sum(1 for e in self.preempt_events
                   if tre is None or e.tre == tre)

    def preempted_nodes(self, tre: str | None = None) -> int:
        return sum(-e.delta for e in self.preempt_events
                   if tre is None or e.tre == tre)

    def resume_count(self, tre: str | None = None) -> int:
        return sum(1 for e in self.resume_events
                   if tre is None or e.tre == tre)

    # ---------------------------------------------------------- metrics
    def _iter_leases(self, tre: str | None):
        leases = [l for l in self.closed_leases
                  if tre is None or l.tre == tre]
        for name, blocks in self.open_leases.items():
            if tre is None or name == tre:
                leases.extend(blocks)
        return leases

    def node_hours(self, tre: str | None = None, now: float = 0.0) -> float:
        """Billed node*hours (per started hour) for one TRE or all.

        Vectorized: closed leases live in columnar arrays, so the ceil and
        the weighted sum are single NumPy expressions instead of a method
        call per lease (the fleet-scale hot path)."""
        tres, t0, end, nodes = self._closed_arrays()
        if tre is not None:
            tid = self._tre_ids.get(tre)
            if tid is None:
                mask = np.zeros(len(t0), dtype=bool)
            else:
                mask = tres == tid
            t0, end, nodes = t0[mask], end[mask], nodes[mask]
        total = float(np.sum(
            nodes * np.ceil(np.maximum(end - t0, 1e-9) / BILL_UNIT_S)))
        # open leases: a handful of blocks per TRE, loop is fine
        for name, blocks in self.open_leases.items():
            if tre is None or name == tre:
                total += sum(l.billed_node_hours(now) for l in blocks)
        return total

    def node_hours_loop(self, tre: str | None = None, now: float = 0.0) -> float:
        """Per-lease Python reference for :meth:`node_hours` (kept for the
        scale-curve benchmark and the vectorization equivalence tests)."""
        return sum(l.billed_node_hours(now) for l in self._iter_leases(tre))

    def peak_nodes(self) -> int:
        return max(v for _, v in self._alloc_curve)

    def peak_nodes_per_hour(self, horizon: float) -> int:
        """Max allocation within any wall-clock hour bucket (Fig 13).

        Vectorized over the allocation event curve: each level ``v_k``
        covers the hour buckets from its own event to the next event
        (inclusive on both clipped ends, matching the loop reference), and
        since event times are non-decreasing the covering set of any bucket
        is a contiguous index range found with two searchsorted calls."""
        n_buckets = int(math.ceil(horizon / BILL_UNIT_S)) + 1
        ts = np.array([t for t, _ in self._alloc_curve])
        vs = np.array([v for _, v in self._alloc_curve])
        last = n_buckets - 1
        # level v_k spans buckets [s_k, e_k] (the final level spans only
        # its own bucket — the loop's trailing point update)
        s = np.minimum((ts // BILL_UNIT_S).astype(np.int64), last)
        e = np.empty_like(s)
        e[:-1] = np.minimum((ts[1:] // BILL_UNIT_S).astype(np.int64), last)
        e[-1] = s[-1]
        buckets = np.arange(n_buckets)
        los = np.searchsorted(e, buckets, side="left")
        his = np.searchsorted(s, buckets, side="right")
        peak = 0
        for lo, hi in zip(los, his):
            if lo < hi:
                peak = max(peak, int(vs[lo:hi].max()))
        return peak

    def peak_nodes_per_hour_loop(self, horizon: float) -> int:
        """Per-event Python reference for :meth:`peak_nodes_per_hour`."""
        n_buckets = int(math.ceil(horizon / BILL_UNIT_S)) + 1
        peak = [0] * n_buckets
        level = 0
        prev_t = 0.0
        for t, v in self._alloc_curve:
            b0 = int(prev_t // BILL_UNIT_S)
            b1 = min(int(t // BILL_UNIT_S), n_buckets - 1)
            for b in range(b0, b1 + 1):
                peak[b] = max(peak[b], level)
            level = v
            prev_t = t
            peak[min(int(t // BILL_UNIT_S), n_buckets - 1)] = max(
                peak[min(int(t // BILL_UNIT_S), n_buckets - 1)], level)
        return max(peak)

    def adjust_count(self, tre: str | None = None) -> int:
        """Accumulated size of adjusted nodes (Fig 14)."""
        return sum(abs(e.delta) for e in self.adjust_events
                   if tre is None or e.tre == tre)

    def setup_overhead_s(self, tre: str | None = None) -> float:
        return self.adjust_count(tre) * SETUP_COST_PER_NODE_S
