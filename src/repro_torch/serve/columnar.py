"""Columnar serve tick: the ``ServeDriver`` control loop over NumPy task
arrays, for 10^5-10^6-workflow streams.

``ServeDriver`` holds per-task ``Job`` objects, per-jid dicts and a
Python queue; at a million tasks the interpreter work per finish dwarfs
the simulated work. This module keeps the EXACT control plane — the same
``MTCRuntimeEnv`` negotiation (DR1/DR2 scans, time-averaged release
checks, deferred provider grants), the same tick phases, the same billing
— but turns every per-task loop into a whole-array batch:

  - **tasks are positions**: a ``repro_torch.sim.traces.ColumnarStream`` indexes
    tasks by emission position; dep counts, service ticks, timings and the
    FCFS queue are preallocated vectors over them.
  - **batch finish sequencing**: a tick's finishes decrement their
    children's dep counts with one scatter-add; newly-ready children
    enter the queue ordered by the position of their *last* finished
    dependency within the batch — provably the order the scalar tick's
    one-at-a-time finish loop produces (pinned bit-identical in tests).
  - **batch FCFS dispatch**: uniform-width FCFS starts exactly
    ``min(queue_len, free // width)`` head-of-queue tasks, so scheduling
    is pointer arithmetic, and the policy engine's scan decision reads
    queue *summary stats* (``RuntimeEnv._queue_demand_stats``) instead of
    a per-job demand list.
  - **event-skipping** (``ServeDriver.next_event_tick``) is inherited —
    with arrays underneath, the quiet-tick jump plus the batched event
    ticks are what let one process sustain the ROADMAP's trace scale.

The scalar tick stays the reference implementation: ``ColumnarStream.
to_jobs()`` materializes the identical workload for ``ServeDriver``, and
the parity suite pins ``ServeStats``, per-task start/finish times and
completion order bit-identical between the two paths.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.lifecycle import LifecycleService
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provision import ProvisionService
from repro_torch.core.scheduling import fcfs
from repro_torch.core.tre import MTCRuntimeEnv, TickClock
from repro_torch.serve.driver import (
    ServeDriver, ServeInvariantError, ServeStats, service_ticks_batch,
)
from repro_torch.sim.traces import ColumnarStream


# --------------------------------------------------------------------------
# columnar engine
# --------------------------------------------------------------------------
class ColumnarEngine:
    """``EmulatedEngine`` over task positions: the same slot arrays, but
    the Python free *list* becomes a LIFO free *stack* (an int array +
    fill pointer) and admission takes a position batch with precomputed
    service ticks — no per-job attribute reads on the hot path. Slot
    assignment order, admit sequencing and finish ordering are
    bit-identical to ``EmulatedEngine`` (a batch of k admits pops the
    same k slots the scalar engine's ``free.pop()`` loop would)."""

    def __init__(self, capacity: int, *, tick_s: float = 1.0,
                 max_len: int | None = None):
        self.capacity = capacity
        self.tick_s = tick_s
        self.max_len = max_len
        self._free = np.arange(capacity, dtype=np.int64)
        self._ntop = capacity                      # free-stack fill
        self._nactive = 0
        self._active = np.zeros(capacity, bool)
        self._remaining = np.zeros(capacity, np.int64)
        self._pos = np.full(capacity, -1, np.int64)
        self._admit_seq = np.zeros(capacity, np.int64)
        self._seq = 0
        self.steps = 0

    @property
    def active_count(self) -> int:
        return self._nactive

    def admit_positions(self, pos: np.ndarray, remaining: np.ndarray) -> None:
        """Admit a batch of task positions with their service ticks."""
        k = len(pos)
        if k > self._ntop:
            raise ServeInvariantError(
                "admitted beyond free slots: %d jobs > %d free"
                % (k, self._ntop))
        # the scalar engine pops from the END of its free list one job at
        # a time: a batch of k takes the stack's top k slots, last first
        slots = self._free[self._ntop - k:self._ntop][::-1]
        self._ntop -= k
        self._active[slots] = True
        self._remaining[slots] = remaining
        self._pos[slots] = pos
        self._admit_seq[slots] = self._seq + np.arange(k)
        self._seq += k
        self._nactive += k

    def step(self) -> np.ndarray:
        """One decode tick; returns finished task positions in admission
        order (the scalar engine's finish-event order)."""
        if self._nactive == 0:
            return np.empty(0, np.int64)
        self._remaining[self._active] -= 1
        self.steps += 1
        done = np.nonzero(self._active & (self._remaining <= 0))[0]
        if len(done) == 0:
            return np.empty(0, np.int64)
        done = done[np.argsort(self._admit_seq[done], kind="stable")]
        out = self._pos[done].copy()
        self._active[done] = False
        self._pos[done] = -1
        # freed slots return to the stack in admit-seq order, exactly as
        # the scalar engine extends its free list
        self._free[self._ntop:self._ntop + len(done)] = done
        self._ntop += len(done)
        self._nactive -= len(done)
        return out

    def next_finish_in(self) -> int | None:
        if self._nactive == 0:
            return None
        return int(self._remaining[self._active].min())

    def advance_quiet(self, n: int) -> None:
        if n <= 0:
            return
        nf = self.next_finish_in()
        if nf is None:
            return
        if n >= nf:
            raise ServeInvariantError(
                "quiet advance of %d ticks would jump past a finish due "
                "in %d" % (n, nf))
        self._remaining[self._active] -= n
        self.steps += n


# --------------------------------------------------------------------------
# columnar runtime environment
# --------------------------------------------------------------------------
def _no_scalar_launch(task):
    raise ServeInvariantError(
        "scalar launch path reached from a columnar env — batch dispatch "
        "must go through _launch_positions")


class ColumnarEnv(MTCRuntimeEnv):
    """``MTCRuntimeEnv`` whose trigger monitor, queue and dispatch are
    arrays over a ``ColumnarStream``'s task positions. Everything the
    provider sees — scans, grants, releases, idle accounting, billing —
    is the inherited scalar machinery, byte for byte; only the per-task
    state changed representation:

      - dep counts: one ``int64`` vector (scatter-decremented per finish
        batch), children as a position-indexed CSR built by stable-sorting
        the dep edges (so a parent's children keep scalar track order),
      - the FCFS queue: an append-only index buffer with head/tail
        pointers — every task is enqueued exactly once, so no ring
        wraparound can occur by construction,
      - submit/start/finish times: float vectors (what the parity suite
        reads back against the scalar path's ``Job`` fields).

    Uniform task width + FCFS is REQUIRED (and checked): it is what makes
    batch dispatch a prefix take and the scan decision three summary
    stats. Cross-entry dependency gating matches the scalar trigger
    monitor exactly: a parent finishing before its child's entry arrives
    never decrements that child (the scalar path's documented starvation
    semantics), so divergence is impossible even on adversarial streams.
    """

    def __init__(self, name: str, *, cs: ColumnarStream, width: int,
                 launch_positions, provision: ProvisionService, clock,
                 policy: MgmtPolicy | None = None,
                 fixed_nodes: int | None = None, scheduler=None,
                 lifecycle: LifecycleService | None = None,
                 max_nodes: int | None = None):
        super().__init__(name, provision=provision, clock=clock,
                         launch=_no_scalar_launch, policy=policy,
                         fixed_nodes=fixed_nodes, scheduler=scheduler,
                         lifecycle=lifecycle, max_nodes=max_nodes)
        if self.scheduler is not fcfs:
            raise ValueError(
                "columnar serve requires the FCFS scheduler (batch "
                "dispatch is a queue-prefix take); got "
                f"{getattr(self.scheduler, '__name__', self.scheduler)!r}")
        self._cs = cs
        self._w = int(width)
        self._launch_positions = launch_positions
        n = cs.n_tasks
        self._ndeps_arr = np.diff(cs.dep_ptr).astype(np.int64)
        self._arrived_hi = 0          # positions < this are tracked
        # children CSR: stable sort of dep edges by parent keeps each
        # parent's children in child-position order — which IS the scalar
        # trigger monitor's per-parent list order (children are tracked in
        # position order)
        child_of_edge = np.repeat(np.arange(n, dtype=np.int64),
                                  np.diff(cs.dep_ptr))
        order = np.argsort(cs.dep_idx, kind="stable")
        self._child_idx = child_of_edge[order]
        self._child_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(cs.dep_idx, minlength=n))]
        ).astype(np.int64)
        # FCFS queue: append-only position buffer (each task queued once)
        self._qbuf = np.empty(n, np.int64)
        self._qhead = 0
        self._qtail = 0
        # per-task timings, read back by the parity suite
        self.submit_t = np.full(n, np.nan)
        self.start_t = np.full(n, np.nan)
        self.finish_t = np.full(n, np.nan)

    # ------------------------------------------------------------- queue
    @property
    def qlen(self) -> int:
        return self._qtail - self._qhead

    def _enqueue(self, pos: np.ndarray) -> None:
        k = len(pos)
        if k == 0:
            return
        self._qbuf[self._qtail:self._qtail + k] = pos
        self._qtail += k
        self.submit_t[pos] = self.clock.now()
        # fixed (dedicated) envs schedule on submission, like the scalar
        # ``submit``; DSP envs load at scan ticks
        if self.mode == "fixed":
            self.schedule()

    def _queue_demand_stats(self) -> tuple[int, int, int]:
        q = self.qlen
        if q == 0:
            return 0, 0, 0
        return q * self._w, self._w, self._w

    # ---------------------------------------------------------- dispatch
    def schedule(self):
        """Uniform-width FCFS in closed form: start exactly
        ``min(queue_len, free // width)`` head-of-queue tasks (the scalar
        prefix-greedy over a uniform queue starts the same set)."""
        cnt = min(self.qlen, self.free // self._w)
        if cnt <= 0:
            return []
        pos = self._qbuf[self._qhead:self._qhead + cnt]
        self._qhead += cnt
        self.start_t[pos] = self.clock.now()
        self._account_idle()
        self.busy += self._w * cnt
        self._launch_positions(pos)
        return pos

    def submit(self, task) -> None:
        raise ServeInvariantError(
            "scalar submit reached a columnar env — arrivals go through "
            "track_arrivals")

    # --------------------------------------------------- trigger monitor
    def track_arrivals(self, e_lo: int, e_hi: int) -> None:
        """Register entries ``[e_lo, e_hi)`` (their tasks become tracked)
        and enqueue the dependency-free roots in position order — exactly
        the scalar loop's track(extend=True) + submit-roots sequence."""
        lo = int(self._cs.entry_ptr[e_lo])
        hi = int(self._cs.entry_ptr[e_hi])
        if hi <= lo:
            return
        self._expected = (self._expected or 0) + (hi - lo)
        self._arrived_hi = hi
        span = np.arange(lo, hi, dtype=np.int64)
        self._enqueue(span[self._ndeps_arr[lo:hi] == 0])

    def finish_positions(self, pos: np.ndarray) -> None:
        """One finish batch (engine finish order): free the slots' node
        units, scatter-decrement the children's dep counts, enqueue the
        newly-ready in scalar submit order, dispatch once."""
        now = self.clock.now()
        self.finish_t[pos] = now
        self._account_idle()
        self.busy -= self._w * len(pos)
        self._completed_n += len(pos)
        # children of the batch, parent-major in finish order, each
        # parent's children in track order (multi-range CSR gather)
        starts = self._child_ptr[pos]
        cnts = self._child_ptr[pos + 1] - starts
        total = int(cnts.sum())
        if total:
            out_off = np.concatenate([[0], np.cumsum(cnts)[:-1]])
            idx = (np.arange(total, dtype=np.int64)
                   - np.repeat(out_off, cnts) + np.repeat(starts, cnts))
            cc = self._child_idx[idx]
            # gate on tracked children only: a parent finishing before its
            # child's entry arrived must NOT decrement it (scalar
            # starvation semantics)
            cc = cc[cc < self._arrived_hi]
            if len(cc):
                np.subtract.at(self._ndeps_arr, cc, 1)
                # a child becomes ready at its LAST occurrence in cc —
                # the batch position where the scalar one-at-a-time loop
                # would have submitted it
                u, rev_first = np.unique(cc[::-1], return_index=True)
                ready_m = self._ndeps_arr[u] == 0
                if ready_m.any():
                    lastpos = len(cc) - 1 - rev_first[ready_m]
                    self._enqueue(u[ready_m][np.argsort(lastpos,
                                                        kind="stable")])
        if not self.all_done:
            self.schedule()


# --------------------------------------------------------------------------
# columnar serve driver
# --------------------------------------------------------------------------
def default_max_ticks_columnar(cs: ColumnarStream, svc: np.ndarray,
                               tick_s: float) -> int:
    """Vectorized ``repro_torch.serve.driver.default_max_ticks``: arrival span
    (the stream is sorted, so the last entry) plus 8x the total service
    ticks — pinned equal to the scalar bound in the regression suite."""
    span = float(cs.entry_arrival[-1]) if cs.n_entries else 0.0
    work = int(svc.sum())
    return int(span / tick_s + 8 * work + 36_000)


class ColumnarServeDriver(ServeDriver):
    """``ServeDriver`` over a ``ColumnarStream``: the inherited run loop,
    control-cycle boundaries, contention replay, event-skipping and
    finalize — with the per-task tick phases (arrival submission, finish
    sequencing, admission flush, invariants) overridden as array batches
    against a ``ColumnarEnv`` + ``ColumnarEngine``. Event-skipping
    defaults ON here (the scalar driver defaults dense): this is the
    trace-scale path.

    Bit-parity contract: on ``cs.to_jobs()`` with the same provider,
    policy, contention and engine geometry, ``run()`` returns a
    ``ServeStats`` identical to the scalar driver's, with identical
    per-task start/finish times (``env.start_t`` / ``env.finish_t``)."""

    def __init__(self, cs: ColumnarStream, *,
                 provider: ProvisionService, engine: ColumnarEngine,
                 policy: MgmtPolicy | None = None,
                 fixed_nodes: int | None = None,
                 name: str = "mtc-serve", scheduler=None,
                 lifecycle: LifecycleService | None = None,
                 tick_s: float = 1.0,
                 contention=(), max_ticks: int | None = None,
                 strict: bool = True, clock: TickClock | None = None,
                 phase: int = 0, slot_width: int = 1,
                 event_skip: bool = True):
        if slot_width < 1:
            raise ValueError(f"slot_width must be >= 1, got {slot_width}")
        if not callable(getattr(engine, "admit_positions", None)):
            raise TypeError(
                "ColumnarServeDriver needs a position-batch engine "
                "(ColumnarEngine); scalar adapters drive ServeDriver")
        if cs.n_entries and np.any(np.diff(cs.entry_arrival) < 0):
            raise ValueError("columnar stream entries must be sorted "
                             "by arrival")
        if cs.n_tasks and not np.all(cs.nodes == slot_width):
            raise ServeInvariantError(
                f"1 MTC task = 1 batching slot (= {slot_width} node "
                f"unit(s) at this tenant's width); stream carries "
                f"other node counts")
        self.cs = cs
        self.stream = ()              # scalar entries never materialized
        self.provider = provider
        self.engine = engine
        self.slot_width = slot_width
        self.tick_s = tick_s
        self.strict = strict
        self.clock = clock if clock is not None else TickClock()
        self.stats = ServeStats(name=name, tick_s=tick_s,
                                slot_width=slot_width,
                                workflows_expected=cs.n_entries)
        self._admit_buf: list[np.ndarray] = []
        self._entry_i = 0             # arrival cursor over stream entries
        self._stream_i = 0            # kept 0/len-compatible via _done
        self._contention = sorted(contention, key=lambda e: e[0])
        self._cont_i = 0
        self._phase = phase
        if policy is not None:
            self._scan_every = max(int(round(policy.scan_interval / tick_s)),
                                   1)
            self._release_every = max(
                int(round(policy.release_interval / tick_s)), 1)
        else:
            self._scan_every = self._release_every = 0
        cap_units = engine.capacity * slot_width
        self.env = ColumnarEnv(
            name, cs=cs, width=slot_width,
            launch_positions=self._launch_positions,
            provision=provider, clock=self.clock, policy=policy,
            fixed_nodes=fixed_nodes, scheduler=scheduler,
            lifecycle=lifecycle, max_nodes=cap_units)
        self.env.grant_listener = self._on_grant
        self.env.track(())            # an empty stream is already all_done
        # per-task service ticks + per-workflow remaining-task counts,
        # both one vector pass
        self._svc = service_ticks_batch(
            cs.decode_len, cs.prompt_len, cs.runtime,
            tick_s=tick_s, max_len=engine.max_len)
        self._wf_left_arr = np.diff(cs.entry_ptr).astype(np.int64)
        if max_ticks is None:
            max_ticks = default_max_ticks_columnar(cs, self._svc, tick_s)
        self.max_ticks = max_ticks
        self.event_skip = bool(event_skip)

    # ------------------------------------------------------- env hooks
    def _launch_positions(self, pos: np.ndarray) -> None:
        # width already validated stream-wide at construction (the scalar
        # per-launch nodes check, hoisted out of the hot path)
        self._admit_buf.append(pos)

    def _buffered(self) -> int:
        return sum(len(a) for a in self._admit_buf)

    # ------------------------------------------------------- tick parts
    def _next_arrival_t(self) -> float | None:
        if self._entry_i < self.cs.n_entries:
            return float(self.cs.entry_arrival[self._entry_i])
        return None

    def _queue_len(self) -> int:
        return self.env.qlen

    def _submit_arrivals(self, now: float) -> None:
        hi = int(np.searchsorted(self.cs.entry_arrival, now + 1e-9,
                                 side="right"))
        if hi > self._entry_i:
            self.env.track_arrivals(self._entry_i, hi)
            self._entry_i = hi

    def _process_finishes(self, finished) -> None:
        pos = np.asarray(finished, np.int64)
        if len(pos) == 0:
            return
        self.env.finish_positions(pos)
        self.stats.tasks_completed += len(pos)
        # workflow roll-up: decrement each finished task's workflow and
        # count the ones that hit zero in this batch
        wfs = np.searchsorted(self.cs.entry_ptr, pos, side="right") - 1
        np.subtract.at(self._wf_left_arr, wfs, 1)
        done_wfs = np.unique(wfs)
        self.stats.workflows_completed += int(
            (self._wf_left_arr[done_wfs] == 0).sum())

    def _flush_admissions(self) -> None:
        if not self._admit_buf:
            return
        pos = (self._admit_buf[0] if len(self._admit_buf) == 1
               else np.concatenate(self._admit_buf))
        w = self.slot_width
        if (self.engine.active_count + len(pos)) * w > self.env.owned:
            self.stats.over_admissions += 1
            if self.strict:
                raise ServeInvariantError(
                    "over-admission: (%d active + %d buffered) slots x "
                    "width %d > %d granted units"
                    % (self.engine.active_count, len(pos), w,
                       self.env.owned))
        self.engine.admit_positions(pos, self._svc[pos])
        self._admit_buf = []

    def _check_invariants(self) -> None:
        active = (self.engine.active_count + self._buffered()) \
            * self.slot_width
        if active > self.env.owned or self.env.busy > self.env.owned:
            self.stats.over_admissions += 1
            if self.strict:
                raise ServeInvariantError(
                    "slots exceed grant: engine %d / env busy %d / owned %d"
                    % (active, self.env.busy, self.env.owned))
        if active != self.env.busy and self.strict:
            raise ServeInvariantError(
                "engine/env divergence: %d active units != %d busy nodes"
                % (active, self.env.busy))

    def _accumulate(self) -> None:
        self.stats.busy_node_ticks += self.env.busy * self.tick_s
        self.stats.owned_node_ticks += self.env.owned * self.tick_s
        self.stats.peak_owned = max(self.stats.peak_owned, self.env.owned)
        self.stats.queue_peak = max(self.stats.queue_peak, self.env.qlen)

    @property
    def _done(self) -> bool:
        return (self._entry_i == self.cs.n_entries and self.env.all_done
                and not self._admit_buf and self.engine.active_count == 0)
