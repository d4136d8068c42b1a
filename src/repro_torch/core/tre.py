"""The unified DSP control plane: one RuntimeEnv, many drivers.

A *TRE* (thin runtime environment, paper §3.1) is the unit DawningCloud
leases resources to. Before this module existed the TRE server logic was
implemented twice — once inside the discrete-event emulator
(``repro_torch.sim.systems.REServer``) and once inside the live JAX controller
(``repro_torch.core.controller.ElasticController``) — sharing only the pure
``PolicyEngine``. ``RuntimeEnv`` owns the complete control cycle exactly
once:

  - **queue + trigger monitor** (§3.2.1): dependency bookkeeping; a task
    enters the queue only when every dependency has finished,
  - **scheduler dispatch** (§4.4): first-fit (HTC) / FCFS (MTC) / any
    ``repro_torch.core.scheduling.SCHEDULERS`` entry, per-TRE overridable,
  - **policy negotiation** (§3.2.2): ``PolicyEngine`` scan -> a DR1/DR2
    ``ResourceRequest`` submitted to the provision service. A plain
    ``ProvisionService`` answers grant-or-reject inline (the paper's
    §3.2.2.3 policy); a multi-tenant ``repro_torch.core.provider.
    ResourceProvider`` may instead *park* the request in its admission
    queue — the env then amends it with the live deficit at every scan
    and the deferred grant lands through the ``on_grant`` callback when
    another tenant's release frees capacity. Hourly release checks run
    over *time-averaged* idle,
  - **idle accounting**: explicit time-integral of free nodes (no lazy
    ``getattr`` state),
  - **elastic hooks** (beyond paper): ``grow``/``shrink`` let a live driver
    resize a running task's allocation while the env keeps busy/free exact,
  - **lifecycle** (§3.1.3): creation and destruction go through
    ``LifecycleService``, so every run exercises the
    inexistent -> planning -> created -> running state machine.

Drivers own *time and execution*, nothing else. A driver supplies

  - a ``Clock`` (``now() -> float``): the emulator's is the simulation
    clock in seconds; the live controller's is a ``TickClock`` counting
    control ticks,
  - a ``launch(task)`` callable: the emulator schedules a finish event
    ``task.runtime`` later; the live controller actually trains/serves,
    and calls :meth:`RuntimeEnv.finish` when the task completes,
  - the cadence: the emulator wires scan/release events onto its event
    heap; the live controller calls :meth:`scan` / :meth:`release_check`
    from its tick loop.

``HTCRuntimeEnv`` and ``MTCRuntimeEnv`` fix the paper's per-kind defaults.
Both the emulator and the live controller are thin shells over these — one
implementation, two drivers, which is what makes the reproduction a
framework rather than a simulator.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Protocol, runtime_checkable

from repro_torch.core.lifecycle import LifecycleService
from repro_torch.core.policy import MgmtPolicy, PolicyEngine
from repro_torch.core.provision import ProvisionService
from repro_torch.core.scheduling import resolve_scheduler


@runtime_checkable
class Clock(Protocol):
    """The only notion of time a RuntimeEnv has. Drivers define its unit:
    seconds (emulator) or control ticks (live controller)."""

    def now(self) -> float: ...


class TickClock:
    """Integer-stepped clock for tick-driven (live) drivers."""

    def __init__(self, start: float = 0.0):
        self._now = start

    def now(self) -> float:
        return self._now

    def advance(self, dt: float = 1.0) -> float:
        self._now += dt
        return self._now


class RuntimeEnv:
    """Driver-agnostic TRE server: the DSP control cycle, implemented once.

    Modes (mutually exclusive constructor arguments):
      - ``fixed_nodes=N``: DCS/SSP semantics — the env owns/leases a fixed
        configuration and never renegotiates; jobs schedule on submission.
      - ``policy=MgmtPolicy(...)``: DawningCloud semantics — starts at the
        policy's initial resources ``B`` and renegotiates at every
        :meth:`scan` / :meth:`release_check` the driver issues.
    """

    kind = "htc"

    def __init__(self, name: str, *, provision: ProvisionService,
                 clock: Clock, launch: Callable[[Any], None],
                 policy: MgmtPolicy | None = None,
                 fixed_nodes: int | None = None,
                 scheduler=None, lifecycle: LifecycleService | None = None,
                 count_adjust: bool = True, max_nodes: int | None = None):
        if (policy is None) == (fixed_nodes is None):
            raise ValueError("exactly one of policy / fixed_nodes required")
        self.name = name
        self.provision = provision
        self.clock = clock
        self._launch = launch
        self.count_adjust = count_adjust
        self.max_nodes = max_nodes
        self.mode = "fixed" if fixed_nodes is not None else "dsp"
        self.scheduler = resolve_scheduler(scheduler, self.kind)
        self.engine = PolicyEngine(policy) if policy is not None else None
        # ---- server state ----
        self.queue: list[Any] = []
        self.completed: list[Any] = []
        self._completed_n = 0     # == len(completed) for the scalar path;
        # a columnar driver tracks completions as array batches and bumps
        # only this counter, so ``all_done`` must never read len(completed)
        self.busy = 0
        self.destroyed = False
        # idle accounting: explicit time-integral state (not lazy getattr —
        # a silent 0.0 default here once hid whole-hour accounting gaps)
        t0 = clock.now()
        self._idle_acc = 0.0            # node*time integral of free nodes
        self._idle_t = t0               # last integration point
        self._release_t = t0            # start of the current release window
        # trigger monitor (populated by track())
        self._expected: int | None = None
        self._ndeps: dict[int, int] = {}
        self._children: dict[int, list[Any]] = {}
        # per-task allocation + projected release profile (for backfill)
        self._alloc: dict[int, int] = {}
        self._reserved: dict[int, tuple[float, int]] = {}
        # DR1/DR2 negotiation in flight: a multi-tenant provider may park
        # the request in its admission queue instead of rejecting it; while
        # one is parked the env amends it at each scan rather than
        # re-submitting (double-queueing would double-grant)
        self._pending_req = None
        # live-driver hook: called with (nodes, t, deferred) after every
        # committed grant. ``deferred`` is True when the grant landed
        # through the provider's admission-queue drain (another tenant's
        # release) rather than inside this env's own scan — a trace-rate
        # serving driver uses it to observe asynchronous slot growth
        # between its control ticks
        self.grant_listener: Callable[[int, float, bool], None] | None = None
        self._in_scan = False
        # ---- lifecycle: §3.1.3 creation path ----
        eff_policy = policy if policy is not None else \
            MgmtPolicy(fixed_nodes, 0.0, float("inf"))
        self.lifecycle = lifecycle or LifecycleService(provision)
        self.record = self.lifecycle.apply(name, self.kind, eff_policy, t0,
                                           count_adjust=count_adjust)
        if self.record is None:
            raise RuntimeError(
                f"TRE {name!r}: initial resources rejected by provision")
        self.owned = eff_policy.initial

    # ------------------------------------------------------------ state
    @property
    def free(self) -> int:
        return self.owned - self.busy

    @property
    def all_done(self) -> bool:
        return (self._expected is not None
                and self._completed_n == self._expected)

    def _account_idle(self) -> None:
        """Accumulate the time-integral of idle nodes. The release check
        frees blocks covered by the *time-averaged* idle of the past window:
        instantaneous idle thrashes (release->regrant bills a fresh lease
        hour), whole-window idle ratchets the pool up; average idle tracks
        the load curve with one window of lag. Call before every change to
        ``owned`` or ``busy``."""
        t = self.clock.now()
        self._idle_acc += self.free * (t - self._idle_t)
        self._idle_t = t

    # --------------------------------------------------- trigger monitor
    def track(self, jobs: Iterable[Any], *, extend: bool = False) -> None:
        """Register a workload's dependency graph with the trigger monitor.
        Dependency-free jobs must still be submitted by the driver (at their
        arrival times); dependent jobs are auto-submitted by :meth:`finish`
        when their last dependency completes.

        ``extend=True`` adds the jobs to the already-tracked graph instead
        of replacing it — a streaming driver registers each workflow as it
        arrives (jids must be globally unique across the stream)."""
        jobs = list(jobs)
        if not extend:
            self._expected = len(jobs)
            self._ndeps = {j.jid: len(j.deps) for j in jobs}
            self._children = {}
        else:
            self._expected = (self._expected or 0) + len(jobs)
            for j in jobs:
                # guarded raise, not assert: a duplicate jid silently
                # corrupts the dependency counts under ``python -O`` and
                # the workflow never completes (or completes twice)
                if j.jid in self._ndeps:
                    raise RuntimeError(
                        f"duplicate jid {j.jid} in extended track")
                self._ndeps[j.jid] = len(j.deps)
        for j in jobs:
            for d in j.deps:
                self._children.setdefault(d, []).append(j)

    def submit(self, task: Any) -> None:
        task.submit_time = self.clock.now()
        self.queue.append(task)
        # DSP envs load jobs at scan ticks (the scan both resizes and loads,
        # §3.2.2); fixed envs schedule on submission
        if self.mode == "fixed":
            self.schedule()

    # --------------------------------------------------------- scheduling
    def schedule(self) -> list[Any]:
        """Load the queue onto free nodes; returns (and launches) starts."""
        started = self.scheduler(
            self.queue, self.free, now=self.clock.now(),
            running=tuple(self._reserved.values()), busy=self.busy)
        if started:
            # one linear rebuild, not a remove() per start: a trace-scale
            # MTC queue holds thousands of ready tasks and a wide grant
            # starts hundreds of them in one schedule call
            started_ids = {id(t) for t in started}
            self.queue = [t for t in self.queue if id(t) not in started_ids]
        for task in started:
            task.start = self.clock.now()
            self._account_idle()
            self.busy += task.nodes
            self._alloc[id(task)] = task.nodes
            runtime = getattr(task, "runtime", None)
            if runtime is not None:
                self._reserved[id(task)] = (self.clock.now() + runtime,
                                            task.nodes)
            self._launch(task)
        return started

    def finish(self, task: Any, *, reschedule: bool = True) -> bool:
        """Driver reports a task completion. Frees its allocation, releases
        newly-ready dependents into the queue, reschedules. Returns True
        when the tracked workload is fully complete (driver may destroy).
        Pass ``reschedule=False`` when the driver is winding down and must
        not be handed freshly-launched work (e.g. a tick-budget cutoff)."""
        task.finish = self.clock.now()
        self._account_idle()
        self.busy -= self._alloc.pop(id(task), task.nodes)
        self._reserved.pop(id(task), None)
        self.completed.append(task)
        self._completed_n += 1
        jid = getattr(task, "jid", None)
        if jid is not None:
            for child in self._children.get(jid, ()):
                self._ndeps[child.jid] -= 1
                if self._ndeps[child.jid] == 0:
                    self.submit(child)
        if self.all_done:
            return True
        if reschedule:
            self.schedule()
        return False

    # ------------------------------------------------------ DSP control
    def _queue_demand_stats(self) -> tuple[int, int, int]:
        """(total, biggest, smallest) node demand of the queue — the only
        aggregates the policy engine's scan decision reads. The batch hook
        a columnar driver overrides: its queue is an index array of
        uniform-width tasks, so the stats are ``(len * width, width,
        width)`` with no per-job list ever materialized."""
        if not self.queue:
            return 0, 0, 0
        demands = [t.nodes for t in self.queue]
        return sum(demands), max(demands), min(demands)

    def _deficit(self, stats: tuple[int, int, int] | None = None,
                 ) -> tuple[int, int]:
        """(current DR1/DR2 need, minimum useful grant) per the policy
        engine, capped by the driver's node ceiling. When the ceiling cuts
        the need below its useful floor (e.g. a DR2 for a job wider than
        the driver will ever own), the request is suppressed entirely —
        nodes granted below the floor could never run the job and would
        idle-thrash through the hourly release checks."""
        if stats is None:
            stats = self._queue_demand_stats()
        total, biggest, smallest = stats
        need, min_useful = self.engine.scan_request_stats(
            total, biggest, smallest, self.owned)
        if need > 0 and self.max_nodes is not None:
            need = min(need, self.max_nodes - self.owned)
        if need < min_useful:
            return 0, 0
        return need, min_useful

    def _apply_grant(self, offer: int, t: float) -> int:
        """Grant callback for the provision service: validate the offer
        against the *live* deficit (a parked request's need may have
        drained while it queued), commit the accepted nodes, and load the
        queue onto them. Returns the nodes accepted — the provider opens
        the lease for exactly that amount, so a stale deferred grant can
        never push nodes onto a TRE that no longer wants them."""
        if self.destroyed or self.engine is None:
            return 0
        need, min_useful = self._deficit()
        take = min(offer, need)
        if take <= 0 or take < min_useful:
            # below the useful floor (e.g. a partial DR2 would idle until
            # the release check thrashes it): decline. The provider keeps
            # a declined request parked, so the pending handle stays — the
            # next scan amends it to the live deficit (or cancels it)
            return 0
        self._account_idle()
        self.engine.granted(take)
        self.owned += take
        if self.grant_listener is not None:
            self.grant_listener(take, t, not self._in_scan)
        self.schedule()
        return take

    def scan(self) -> int:
        """One DSP scan: negotiate growth with the provision service, then
        load the queue. Returns the nodes granted during this call (a
        deferred request granted later lands through :meth:`_apply_grant`
        when the provider's admission queue drains)."""
        if self.destroyed:
            return 0
        owned_before = self.owned
        self._in_scan = True
        try:
            if self.engine is not None:
                stats = self._queue_demand_stats()
                need, min_useful = self._deficit(stats)
                t = self.clock.now()
                pending = self._pending_req
                urgency = self.engine.urgency_stats(stats[0], self.owned)
                if pending is not None and pending.status == "queued":
                    # refresh the parked request with the live deficit and
                    # urgency; the amend may complete it immediately (a
                    # smaller need now fits)
                    self.provision.amend(pending, need, t, min_useful,
                                         priority=urgency)
                    if pending.status != "queued":
                        self._pending_req = None
                elif need > 0:
                    req = self.provision.submit_request(
                        self.name, need, t, on_grant=self._apply_grant,
                        count_adjust=self.count_adjust, priority=urgency,
                        min_useful=min_useful)
                    self._pending_req = req if req.status == "queued" else None
            self.schedule()
        finally:
            self._in_scan = False
        return self.owned - owned_before

    def release_check(self) -> int:
        """Window-end idle check: release every dynamic block covered by the
        window's time-averaged idle. Returns the nodes released."""
        if self.destroyed or self.engine is None:
            return 0
        self._account_idle()
        t = self.clock.now()
        elapsed = t - self._release_t
        idle_avg = self._idle_acc / elapsed if elapsed > 0 else 0.0
        rel = self.engine.release_check(int(min(idle_avg, self.free)))
        if rel > 0:
            # shrink owned BEFORE telling the provider: a multi-tenant
            # release drains the admission queue inline, which may re-grant
            # the freed nodes to this very env's parked request — its
            # deficit must be computed against the post-release pool, or
            # busy can end up exceeding owned
            self.owned -= rel
            self.provision.release(self.name, rel, t,
                                   count_adjust=self.count_adjust)
        self._idle_acc = 0.0
        self._release_t = t
        return rel

    def acquire(self, n: int) -> None:
        """Commit ``n`` directly-granted nodes (a ``provision.request``
        outside the scan path has already succeeded — e.g. a training
        tenant growing a gang into a trough): registers the dynamic
        block with the policy engine and keeps the idle integral exact,
        the same bookkeeping order as :meth:`_apply_grant`."""
        if n <= 0 or self.destroyed:
            return
        self._account_idle()
        if self.engine is not None:
            self.engine.granted(n)
        self.owned += n

    def yield_nodes(self, limit: int | None = None) -> int:
        """Preemption support: immediately release free dynamic blocks.
        Unlike :meth:`release_check` this reads the *instantaneous* free
        count, not the window-averaged idle — the caller has just
        vacated the nodes on purpose (checkpointed gangs shrunk away for
        foreign demand) and they must reach the provider's admission
        queue now, not at the next release window. Goes through
        ``provision.preempt`` so the lease ledger records forced churn
        separately from idle releases. Returns the nodes released."""
        if self.destroyed or self.engine is None:
            return 0
        self._account_idle()
        avail = self.free if limit is None else min(self.free, limit)
        rel = self.engine.release_check(int(avail))
        t = self.clock.now()
        if rel > 0:
            # owned shrinks BEFORE the provider call for the same drain
            # re-entrancy reason as release_check above
            self.owned -= rel
            self.provision.preempt(self.name, rel, t,
                                   count_adjust=self.count_adjust)
        # the vacated nodes are gone — they must not ALSO count toward
        # the next scheduled idle-release window
        self._idle_acc = 0.0
        self._release_t = t
        return rel

    # ---------------------------------------------------- elastic hooks
    def grow(self, task: Any, extra: int) -> None:
        """Beyond-paper: a live driver widens a *running* task into spare
        nodes (e.g. data-parallel mesh growth). Keeps busy/idle exact."""
        # guarded raise, not assert: growing past the free pool would
        # silently oversubscribe busy vs owned under ``python -O``
        if extra > self.free:
            raise RuntimeError(
                f"grow exceeds free nodes: {extra} > {self.free} "
                f"on {self.name!r}")
        self._account_idle()
        self.busy += extra
        self._alloc[id(task)] = self._alloc.get(id(task), task.nodes) + extra
        self._adjust_reservation(task, extra)

    def shrink(self, task: Any, n: int) -> None:
        """Inverse of :meth:`grow`: return ``n`` of the task's nodes."""
        held = self._alloc.get(id(task), task.nodes)
        # guarded raise, not assert: shrinking below the allocation would
        # drive busy negative and break idle accounting under ``python -O``
        if n > held:
            raise RuntimeError(
                f"shrink exceeds task allocation: {n} > {held} "
                f"on {self.name!r}")
        self._account_idle()
        self.busy -= n
        self._alloc[id(task)] -= n
        self._adjust_reservation(task, -n)

    def _adjust_reservation(self, task: Any, delta: int) -> None:
        """Keep the release profile in step with elastic resizes — a grown
        task frees its whole allocation at its estimated end, and a stale
        profile would silently degrade backfill scheduling to FCFS."""
        res = self._reserved.get(id(task))
        if res is not None:
            self._reserved[id(task)] = (res[0], res[1] + delta)

    def cancel_pending(self, at: float | None = None, *,
                       drain: bool = True) -> None:
        """Withdraw any parked DR1/DR2 request. ``drain=False`` detaches
        without letting the provider serve other tenants from the drain —
        required when tearing down a whole experiment (a grant landing
        between two finalize destroys would open a zero-duration lease
        billed a whole hour)."""
        if self._pending_req is not None:
            self.provision.cancel(self._pending_req,
                                  self.clock.now() if at is None else at,
                                  drain=drain)
            self._pending_req = None

    # --------------------------------------------------------- lifecycle
    def destroy(self, at: float | None = None) -> None:
        """All work done (or window over): the service provider destroys the
        TRE — §3.1.3 step 8, withdrawing every lease via the lifecycle
        service. Billing that depends on a configuration size must read it
        from the TRE record's policy, not from post-destroy state."""
        if self.destroyed:
            return
        self.destroyed = True
        self.cancel_pending(at)
        self.lifecycle.destroy(self.name,
                               self.clock.now() if at is None else at,
                               count_adjust=self.count_adjust)
        self.owned = 0


class HTCRuntimeEnv(RuntimeEnv):
    """HTC TRE: batch jobs, first-fit scheduling, 60 s scans (§3.2.2.1)."""
    kind = "htc"


class MTCRuntimeEnv(RuntimeEnv):
    """MTC TRE: workflow tasks under FCFS, 3 s scans (§3.2.2.2); the
    trigger monitor feeds the queue as dependencies complete."""
    kind = "mtc"
