"""Multi-tenant resource provider: shared capacity, admission queueing,
coordinated provisioning.

Paper mapping
-------------
§3.1.2 gives the cloud provider a *resource provision service* that the
paper models as grant-or-reject against a single consolidated platform;
§3.2.2.3 fixes its provision policy to "grant if available, else reject,
releases passively reclaimed" (that policy is ``ProvisionService``, kept
bit-for-bit). This module generalizes that service to the multi-tenant
form the paper's headline question needs — *do providers benefit from the
economies of scale?* is only answerable when one platform hosts N service
providers:

  - **finite capacity shared by N TREs** with per-TRE *quotas* (hard caps)
    and *reservations* (guaranteed minimums) — the §3.2.2.3 provision
    policy parameterized per tenant instead of globally,
  - an **admission queue**: a DR1/DR2 request that cannot be granted now
    parks instead of being dropped, and is re-granted when capacity frees
    (a release triggers a drain; the grant lands through the request's
    ``on_grant`` callback, so a ``RuntimeEnv``'s queued grow applies the
    moment another tenant shrinks — §3.2.2.3's "the resource provision
    service only passively receives requests" upgraded to an actively
    completing broker),
  - a pluggable **coordination policy** deciding which parked requests are
    served when capacity is contended. ``first-come`` reproduces the
    paper's arrival-order semantics (FIFO, head-of-line blocking on global
    capacity); ``coordinated`` is the PhoenixCloud-style policy
    (arXiv:1006.1401): requests pending at an arbitration point are
    decided *together* — most urgent first (the §3.2.2.1 ratio of
    obtaining resources is carried on each request as ``priority``), and a
    backlog wider than the remaining capacity is water-filled across
    tenants rather than served whole-block.

Requests complete through ``on_grant(offer, t) -> accepted``: the
requester re-validates its deficit at grant time (its queue may have
drained while parked), commits its own bookkeeping for the accepted
amount, and the provider opens the lease for exactly that. A stale request
(accepted == 0) is dropped, not granted — the admission queue can never
push nodes onto a tenant that no longer wants them.
"""
from __future__ import annotations

from typing import Callable, Mapping, Sequence

from repro_torch.core.provision import ProvisionService, ResourceRequest

_UNBOUNDED = 1 << 31


class CoordinationPolicy:
    """Arbitration strategy over the admission queue. ``arbitrate`` returns
    ``(request, offer)`` grants that are *jointly* feasible: offers must
    respect per-TRE headroom and global free capacity as if applied in
    order (the provider applies the batch without re-planning, clamping
    only against what requesters decline)."""

    name: str = ""

    def arbitrate(self, pending: Sequence[ResourceRequest],
                  provider: "ResourceProvider", t: float,
                  ) -> list[tuple[ResourceRequest, int]]:
        raise NotImplementedError

    def direct_claim(self, pending: Sequence[ResourceRequest],
                     provider: "ResourceProvider", tre: str,
                     t: float) -> int:
        """Free capacity a *direct* grant-or-reject request by ``tre``
        (lifecycle creation, DRP end users, scripted contention) must
        leave untouched for parked elder requests. The direct path cannot
        queue, so without this a newcomer's burst silently overtakes
        every request this policy would have served first — the elder's
        claim must be charged against the pool before the newcomer is
        judged against it. 0 = no parked request has a prior claim."""
        return 0


class FirstComePolicy(CoordinationPolicy):
    """Arrival-order service (the paper's §3.2.2.3 semantics): walk the
    queue FIFO, grant whole requests while they fit. A head blocked on
    *shared* capacity — including capacity set aside by other tenants'
    undrawn reservations — blocks everything behind it (FIFO-fair: later
    requests cannot overtake it into the pool it is waiting for), but a
    *divisible* blocked head (DR1 backlog, ``min_useful`` below the
    available pool) is served whatever the pool has rather than idling it
    — work-conserving FIFO; a DR1 deficit can exceed what the platform
    could ever grant (the tenant's own allocation counts against
    capacity), and whole-or-nothing service would park it, and the fleet
    behind it, forever. A head blocked only by its own quota is skipped,
    so one capped tenant cannot starve the fleet."""

    name = "first-come"

    def arbitrate(self, pending, provider, t):
        grants: list[tuple[ResourceRequest, int]] = []
        overlay = dict(provider.allocated)
        for req in pending:
            h = provider.headroom(req.tre, overlay=overlay)
            if req.nodes <= h:
                grants.append((req, req.nodes))
                overlay[req.tre] = overlay.get(req.tre, 0) + req.nodes
            else:
                # a divisible blocked request still takes what its headroom
                # allows (work-conserving — for a quota-capped tenant that
                # is everything up to its quota)
                if h >= max(req.min_useful, 1):
                    grants.append((req, h))
                    overlay[req.tre] = overlay.get(req.tre, 0) + h
                q = provider.quotas.get(req.tre)
                quota_room = (_UNBOUNDED if q is None
                              else q - overlay.get(req.tre, 0))
                if req.nodes - h > quota_room:
                    continue                 # own-quota-capped: skip
                break                        # shared-pool-blocked: FIFO-fair
        return grants

    def direct_claim(self, pending, provider, tre, t):
        """FIFO-fair against the direct path too: every parked request is
        an elder of a direct request arriving now, so its whole remaining
        shared-pool entitlement is spoken for. A head blocked only by its
        own quota claims just the room its quota leaves (the fleet is not
        starved by it — mirroring :meth:`arbitrate`'s skip); the
        requesting tenant's own parked request never blocks its own
        direct path (same tenant, nothing is overtaken)."""
        claim = 0
        for req in pending:
            if req.tre == tre:
                continue
            need = req.nodes
            q = provider.quotas.get(req.tre)
            if q is not None:
                need = min(need,
                           max(q - provider.allocated.get(req.tre, 0), 0))
            claim += need
        return claim


class CoordinatedPolicy(CoordinationPolicy):
    """PhoenixCloud-style coordinated provisioning (arXiv:1006.1401):
    simultaneous requests are arbitrated as one decision. Pass 1 serves
    whole requests in urgency order (highest §3.2.2.1 obtaining ratio
    first, FIFO tiebreak). Pass 2 water-fills the remaining capacity
    across every tenant still waiting — ascending remaining need, each
    gets at most an equal share of what is left — so a contended platform
    trims burst requests to fair partial grants instead of parking whole
    blocks behind a wide head. Partially served requests stay queued for
    the next drain."""

    name = "coordinated"

    #: a request parked longer than this is *starving*: the arbiter then
    #: sets aside (reserves) its useful floor out of the free capacity so
    #: younger requests cannot consume what is accumulating for it.
    #: Without it a contended platform regrants every released node to
    #: small requests instantly, so a wide DR2 (a job as wide as a whole
    #: original machine) can wait unboundedly — and the starved tenant's
    #: stretched lifetime bills its whole configuration for the duration.
    #: The reservation is conservative-backfill at the provider level:
    #: the elder's claim hardens, everyone else keeps flowing through the
    #: remaining capacity.
    starvation_s = 3600.0

    #: phantom overlay tenant charging blocked elders' reservations against
    #: free capacity during arbitration (never a real allocation)
    _RESERVE = "\x00starving-reserve"

    def __init__(self, starvation_s: float | None = None):
        if starvation_s is not None:
            self.starvation_s = starvation_s

    def arbitrate(self, pending, provider, t):
        grants: list[tuple[ResourceRequest, int]] = []
        overlay = dict(provider.allocated)
        served: set[int] = set()
        # pass 0: starving elders, oldest first — serve what fits the
        # useful floor; a still-blocked elder reserves its floor
        elders = sorted((r for r in pending if t - r.t >= self.starvation_s),
                        key=lambda r: (r.t, r.seq))
        for req in elders:
            offer = min(req.nodes, provider.headroom(req.tre, overlay=overlay))
            floor = max(req.min_useful, 1)
            if offer >= floor:
                grants.append((req, offer))
                overlay[req.tre] = overlay.get(req.tre, 0) + offer
            else:
                q = provider.quotas.get(req.tre)
                if q is not None and floor > q - overlay.get(req.tre, 0):
                    # own-quota-capped: accumulating shared capacity can
                    # never satisfy it — don't reserve the pool for it
                    continue
                overlay[self._RESERVE] = (overlay.get(self._RESERVE, 0)
                                          + floor)
            served.add(req.seq)
        rest = [r for r in pending if r.seq not in served]
        # pass 1: whole grants, most urgent first (§3.2.2.1 ratio), FIFO
        # tiebreak
        rest.sort(key=lambda r: (-r.priority, r.t, r.seq))
        waiting: list[ResourceRequest] = []
        for req in rest:
            if req.nodes <= provider.headroom(req.tre, overlay=overlay):
                grants.append((req, req.nodes))
                overlay[req.tre] = overlay.get(req.tre, 0) + req.nodes
            else:
                waiting.append(req)
        # pass 2: water-fill the leftovers — smallest remaining need
        # first, equal shares of the remaining free capacity, but never
        # below a request's useful floor (a partial DR2 would idle-thrash)
        waiting.sort(key=lambda r: (r.nodes, r.t, r.seq))
        for i, req in enumerate(waiting):
            share = provider.free_capacity(overlay=overlay) // (len(waiting) - i)
            offer = min(req.nodes, provider.headroom(req.tre, overlay=overlay),
                        share)
            if offer >= max(req.min_useful, 1):
                grants.append((req, offer))
                overlay[req.tre] = overlay.get(req.tre, 0) + offer
        return grants

    def direct_claim(self, pending, provider, tre, t):
        """Coordinated arbitration re-plans every drain, so younger
        parked requests hold no hard claim against a direct newcomer —
        but a *starving* elder's useful floor is already being reserved
        out of free capacity at every arbitration (pass 0), and a direct
        grant must honor the same reservation or it drains exactly the
        capacity accumulating for the elder."""
        claim = 0
        for req in pending:
            if req.tre == tre or t - req.t < self.starvation_s:
                continue
            floor = max(req.min_useful, 1)
            q = provider.quotas.get(req.tre)
            if q is not None and \
                    floor > max(q - provider.allocated.get(req.tre, 0), 0):
                continue                     # own-quota-capped: no claim
            claim += floor
        return claim


COORDINATION_POLICIES: dict[str, Callable[[], CoordinationPolicy]] = {
    "first-come": FirstComePolicy,
    "coordinated": CoordinatedPolicy,
}


def resolve_coordination(spec) -> CoordinationPolicy:
    """Accept a policy instance, a registry key, or None (= first-come)."""
    if spec is None:
        return FirstComePolicy()
    if isinstance(spec, CoordinationPolicy):
        return spec
    try:
        return COORDINATION_POLICIES[spec]()
    except KeyError:
        raise ValueError(
            f"unknown coordination policy {spec!r}; registered: "
            f"{sorted(COORDINATION_POLICIES)}") from None


class ResourceProvider(ProvisionService):
    """Multi-tenant provision service: finite capacity shared by N TREs,
    per-TRE quota/reservation policies, an admission queue for deferred
    DR1/DR2 requests, and pluggable cross-tenant coordination."""

    def __init__(self, capacity: int | None = None, *,
                 coordination=None,
                 quotas: Mapping[str, int] | None = None,
                 reservations: Mapping[str, int] | None = None):
        super().__init__(capacity)
        self.policy = resolve_coordination(coordination)
        self.quotas = dict(quotas or {})
        self.reservations = dict(reservations or {})
        if capacity is not None and sum(self.reservations.values()) > capacity:
            raise ValueError("reservations exceed capacity")
        self.admission_queue: list[ResourceRequest] = []
        self._seq = 0
        self._draining = False

    # ----------------------------------------------------------- headroom
    def free_capacity(self, *, overlay: Mapping[str, int] | None = None) -> int:
        alloc = self.allocated if overlay is None else overlay
        if self.capacity is None:
            return _UNBOUNDED
        return max(self.capacity - sum(alloc.values()), 0)

    def headroom(self, tre: str, *,
                 overlay: Mapping[str, int] | None = None) -> int:
        """Nodes grantable to ``tre`` right now: global free capacity minus
        other tenants' undrawn reservations (a tenant can always draw its
        own), capped by the tenant's quota."""
        alloc = self.allocated if overlay is None else overlay
        mine = alloc.get(tre, 0)
        if self.capacity is None:
            room = _UNBOUNDED
        else:
            free = self.capacity - sum(alloc.values())
            debt = sum(max(0, r - alloc.get(name, 0))
                       for name, r in self.reservations.items() if name != tre)
            room = free - debt
            own = self.reservations.get(tre, 0)
            room = max(room, min(own - mine, free))
        q = self.quotas.get(tre)
        if q is not None:
            room = min(room, q - mine)
        return max(int(room), 0)

    # ------------------------------------------------------------ actions
    def request(self, tre: str, n: int, t: float, *, count_adjust=True) -> bool:
        """Direct grant-or-reject (lifecycle creation, DRP end users) under
        the per-tenant quota/reservation policy, ARBITRATION-AWARE: a
        direct request cannot queue, so it is judged against the headroom
        left after parked elder requests' prior claims
        (:meth:`CoordinationPolicy.direct_claim`) — granting against live
        headroom alone would let a creation or DRP burst overtake a FIFO
        head (or a starving coordinated elder) that queued first. The
        tenant's own undrawn reservation stays senior to any parked
        claim: a guaranteed minimum is exactly the capacity no elder can
        speak for."""
        if n > 0:
            room = self.headroom(tre)
            if n > room:
                return False
            if self.admission_queue:
                claim = self.policy.direct_claim(
                    tuple(self.admission_queue), self, tre, t)
                if claim > 0:
                    free = self.free_capacity()
                    own = min(max(self.reservations.get(tre, 0)
                                  - self.allocated.get(tre, 0), 0), free)
                    if n > max(room - claim, own):
                        return False
        return super().request(tre, n, t, count_adjust=count_adjust)

    def submit_request(self, tre: str, n: int, t: float, *,
                       on_grant, count_adjust: bool = True,
                       priority: float = 0.0,
                       min_useful: int = 1) -> ResourceRequest:
        """Park the request in the admission queue and drain. An
        uncontended fitting request is granted within this call (status
        ``granted``); a deferred one stays ``queued`` and completes through
        ``on_grant`` when a release or amend frees its way."""
        req = ResourceRequest(tre, n, t, on_grant, count_adjust, priority,
                              min_useful)
        req.seq = self._seq
        self._seq += 1
        if n <= 0:
            req.status = "granted"
            return req
        req.status = "queued"
        self.admission_queue.append(req)
        self._drain(t)
        return req

    def amend(self, req: ResourceRequest, n: int, t: float,
              min_useful: int = 1,
              priority: float | None = None) -> ResourceRequest:
        """Refresh a queued request with the requester's live deficit and
        urgency (the env re-scans its queue every scan tick; a parked
        request must track the current need and priority, not the state
        at submission — coordinated arbitration orders by it). ``n <= 0``
        cancels.

        A *priority-only* change re-drains too: under ``coordinated``
        arbitration the urgency ordering IS the grant decision, so an
        urgency bump must be able to unblock a parked request right away —
        not sit until an unrelated release happens to trigger a drain
        (e.g. a request declined in an earlier drain whose tenant's
        backlog has since refilled at the same width)."""
        if req.status != "queued":
            return req
        if n <= 0:
            self.cancel(req, t)
            return req
        changed = (n != req.nodes or min_useful != req.min_useful
                   or (priority is not None and priority != req.priority))
        req.nodes = n
        req.min_useful = min_useful
        if priority is not None:
            req.priority = priority
        if changed:
            self._drain(t)
        return req

    def cancel(self, req: ResourceRequest, t: float | None = None, *,
               drain: bool = True) -> None:
        """Withdraw a parked request. A cancelled head unblocks everything
        FIFO-fair behind it, so the queue re-drains immediately — at ``t``
        (callers should pass the current time; the request's submission
        time is a last resort). ``drain=False`` detaches without serving
        anyone — for teardown, where a grant would open a lease that is
        destroyed moments later."""
        was_queued = req in self.admission_queue
        if was_queued:
            self.admission_queue.remove(req)
        super().cancel(req)
        if was_queued and drain:
            if t is None:
                # never backdate a drain: a grant stamped before already-
                # recorded allocation events would overbill the follower
                # and break the alloc curve's time order. With no
                # allocation event recorded yet the request's own
                # submission time is the only defensible floor
                last = self._alloc_curve[-1][0] if self._alloc_curve \
                    else req.t
                t = max(req.t, last)
            self._drain(t)

    def release(self, tre: str, n: int, t: float, *, count_adjust=True) -> None:
        super().release(tre, n, t, count_adjust=count_adjust)
        self._drain(t)        # freed capacity completes parked requests

    # -------------------------------------------------------------- drain
    def _drain(self, t: float) -> None:
        """Serve the admission queue until the coordination policy has no
        feasible grant left. Re-entrancy guarded: an ``on_grant`` callback
        may schedule work whose side effects land back here."""
        if self._draining:
            return
        self._draining = True
        declined: set[int] = set()
        try:
            while self.admission_queue:
                grants = self.policy.arbitrate(
                    tuple(self.admission_queue), self, t)
                if not grants:
                    break
                progress = False
                for req, offer in grants:
                    if req.seq in declined or req.status != "queued":
                        continue
                    offer = min(offer, req.nodes, self.headroom(req.tre))
                    if offer < max(req.min_useful, 1):
                        continue
                    take = req.on_grant(offer, t)
                    if take > 0:
                        ok = ProvisionService.request(
                            self, req.tre, take, t,
                            count_adjust=req.count_adjust)
                        if not ok:
                            # the offer was clamped against live headroom
                            # just above — a failure here means the ledger
                            # and the arbitration overlay disagree, and
                            # granting anyway would oversubscribe capacity
                            raise RuntimeError(
                                f"drain grant exceeds capacity: "
                                f"{take} nodes to {req.tre!r} at t={t}")
                        req.granted += take
                        progress = True
                    if take == 0:
                        # declined: the requester's live floor may have
                        # risen past the offer (or its need vanished).
                        # Keep it parked — FIFO position and starvation
                        # age survive; the tenant's next scan amends it
                        # to the live deficit or cancels it outright
                        declined.add(req.seq)
                    elif take < offer or offer == req.nodes:
                        # satisfied (possibly for less than asked: done)
                        self.admission_queue.remove(req)
                        req.status = "granted"
                    else:
                        req.nodes -= take           # partial: stay queued
                if not progress:
                    break
        finally:
            self._draining = False
