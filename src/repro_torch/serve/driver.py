"""Trace-rate MTC serving driver over the shared resource provider.

This is the live-serving counterpart of the discrete-event emulator: the
same ``MTCRuntimeEnv`` control plane (trigger monitor, FCFS dispatch,
DR1/DR2 negotiation, time-averaged release checks) driving a
continuous-batching engine at *trace rate* — thousands of Montage-shaped
workflows replayed at their trace timestamps on a ``TickClock``:

  - **workflow arrivals** come from ``repro_torch.sim.traces.request_stream``:
    each arrival registers its DAG with the env's trigger monitor
    (``track(extend=True)``) and submits the dependency-free roots; the
    env loads them at scan ticks, exactly like the emulator's DSP mode,
  - **engine slots are provisioned, not assumed**: 1 batching slot = 1
    node. The env's scans emit ``ResourceRequest``s against the shared
    ``repro_torch.core.provider.ResourceProvider``; a contended platform *parks*
    the request and the deferred grant lands between control ticks through
    ``on_grant`` (observed via the env's ``grant_listener``),
  - **admission backpressure**: while a grant is deferred, newly arrived
    workflow roots wait in the env queue — the driver never admits a task
    into the engine beyond the granted slot count (asserted every tick;
    ``ServeStats.over_admissions`` stays 0),
  - **batched admission**: tasks launched during a tick are buffered and
    admitted together at the end of the tick (one prefill dispatch per
    prompt shape via ``Engine.admit_many``); they decode from the next
    tick on, so a task admitted at tick T with ``decode_len`` R finishes
    at T + R — the same timing the emulator's finish events produce,
    which is what makes emulator-vs-live parity bit-exact.

Engines plug in through a 3-method adapter (``capacity`` /
``admit_many(jobs)`` / ``step() -> finished jids``): ``EmulatedEngine`` is
the tick-accurate stand-in used for trace-scale runs and the parity/
property suite; ``TorchEngineAdapter`` drives the real
``repro_torch.serve.engine.Engine`` (prompts synthesized from the jobs'
token-length marks) so the same driver serves actual inference traffic.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from repro_torch.core.lifecycle import LifecycleService
from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provision import ProvisionService
from repro_torch.core.tre import MTCRuntimeEnv, TickClock
from repro_torch.core.types import Job
# the tick-grid helpers moved to the tenant module with the protocol
# extraction; re-exported here for the fleet/columnar/test importers
from repro_torch.serve.tenant import Tenant, due_tick_floor, next_boundary  # noqa: F401


class ServeInvariantError(RuntimeError):
    """A serve-path invariant was violated (over-admission, engine/env
    slot-count divergence, or an engine asked to admit beyond its free
    slots). Raised — never ``assert``ed — so zero-over-admission holds
    under ``python -O`` too; the numbers a serve run reports are only
    trustworthy because violating them is an error, not a debug check."""


def service_ticks_batch(decode_len, prompt_len, runtime, *, tick_s: float,
                        max_len: int | None) -> np.ndarray:
    """Vectorized :meth:`EmulatedEngine.service_ticks` over task arrays:
    ``decode_len`` marks (cache-capped via the shared :func:`decode_budget`
    formula when ``max_len`` is set) with the runtime-in-ticks fallback for
    unmarked tasks. One formula for the scalar engine, the columnar
    engine and the columnar max-ticks bound — elementwise equality with
    the scalar method is pinned in tests."""
    dl = np.asarray(decode_len, np.int64)
    rt = np.maximum(np.ceil(np.asarray(runtime, float) / tick_s),
                    1).astype(np.int64)
    if max_len is not None:
        pl = np.minimum(np.maximum(np.asarray(prompt_len, np.int64), 1),
                        max_len - 1)
        room = max_len - pl
        capped = np.maximum(
            np.maximum(np.minimum(dl + 1, room), np.minimum(2, room)) - 1, 1)
    else:
        capped = dl
    return np.where(dl > 0, capped, rt)


def decode_budget(decode_len: int, prompt_len: int, max_len: int) -> int:
    """Token budget a ``max_len``-deep cache can give a request: the
    ``decode_len`` service mark plus the prefill token, capped to the
    cache room left after the prompt, floored at 2 tokens where the room
    allows it (prefill emits token 1 at admit, so a budget of R+1
    finishes after exactly R decode steps).

    The prompt is clamped to ``max_len - 1`` first — the cache needs one
    free position for the decode write, so a prompt at/above ``max_len``
    must be truncated by the caller (``TorchEngineAdapter._request`` does)
    and budgets from it are sized for the truncated prompt. At
    ``prompt_len == max_len - 1`` the room is 1 and the budget is 1: a
    zero-decode job. Its pinned semantics on every backend: the request
    still holds a slot for exactly ONE service tick, because the engine's
    finish check runs after the step's append — ``EmulatedEngine`` /
    ``TorchEngineAdapter`` ``service_ticks`` floor at 1 accordingly. The
    unclamped formula returned 0 or negative budgets here, which drove
    emulated service ticks negative and desynced emulator-vs-jax parity.

    THE one formula every backend must share: ``TorchEngineAdapter`` sizes
    ``max_new_tokens`` with it, a cache-aware ``EmulatedEngine`` caps its
    service ticks to ``max(decode_budget(...) - 1, 1)``, and the columnar
    ``service_ticks_batch`` is its vectorized twin — computing the cap in
    two places is how the long-decode parity bug happened."""
    plen = min(max(prompt_len, 1), max_len - 1)
    room = max_len - plen
    return max(min(decode_len + 1, room), min(2, room))


@dataclass
class ServeStats:
    """One serve run's outcome + the invariants it maintained."""
    name: str
    ticks: int = 0
    tick_s: float = 1.0
    slot_width: int = 1                 # node units one batching slot costs
    workflows_expected: int = 0
    workflows_completed: int = 0
    tasks_completed: int = 0
    makespan_s: float = 0.0
    workflows_per_hour: float = 0.0
    busy_node_ticks: float = 0.0        # integral of serving slots
    owned_node_ticks: float = 0.0       # integral of granted slots
    slot_utilization: float = 0.0       # busy / owned integrals
    node_hours: float = 0.0             # billed (per started lease hour)
    peak_owned: int = 0
    queue_peak: int = 0
    deferred_grants: int = 0            # grants landed via admission queue
    deferred_nodes: int = 0
    over_admissions: int = 0            # ticks where engine > granted (== 0)

    def as_dict(self) -> dict:
        return dict(self.__dict__)


class EmulatedEngine:
    """Tick-accurate engine stand-in: a task admitted at tick T occupies a
    slot and finishes after its service ticks (``decode_len`` marks, else
    ceil(runtime / tick_s)) — slot accounting vectorized over NumPy arrays
    like the real engine's. Used for trace-scale runs and the parity suite
    (service ticks == emulator runtime => identical finish times).

    ``max_len`` emulates a real engine's cache depth: with it set, a
    ``decode_len`` mark is served only up to :func:`decode_budget`'s
    room — the same cap ``TorchEngineAdapter`` applies — so a trace whose
    decode marks exceed the cache keeps emulator-vs-jax finish ticks
    bit-identical. ``None`` (default) serves marks uncapped."""

    def __init__(self, capacity: int, *, tick_s: float = 1.0,
                 max_len: int | None = None):
        self.capacity = capacity
        self.tick_s = tick_s
        self.max_len = max_len
        self.free = list(range(capacity))
        self._active = np.zeros((capacity,), bool)
        self._remaining = np.zeros((capacity,), np.int64)
        self._rid = np.full((capacity,), -1, np.int64)
        self._admit_seq = np.zeros((capacity,), np.int64)
        self._seq = 0
        self.steps = 0

    @property
    def active_count(self) -> int:
        return int(self._active.sum())

    def service_ticks(self, job: Job) -> int:
        if job.decode_len > 0:
            if self.max_len is not None:
                # cap to the cache budget exactly as the jax backend does:
                # budget R+1 tokens = R decode steps in a slot; a
                # zero-decode budget of 1 still holds the slot for one
                # tick (the engine's finish check is post-append)
                return max(decode_budget(job.decode_len, job.prompt_len,
                                         self.max_len) - 1, 1)
            return job.decode_len
        return max(int(math.ceil(job.runtime / self.tick_s)), 1)

    def admit_many(self, jobs: Sequence[Job]) -> Sequence[Job]:
        if len(jobs) > len(self.free):
            raise ServeInvariantError(
                "admitted beyond free slots: %d jobs > %d free"
                % (len(jobs), len(self.free)))
        for job in jobs:
            slot = self.free.pop()
            self._active[slot] = True
            self._remaining[slot] = self.service_ticks(job)
            self._rid[slot] = job.jid
            self._admit_seq[slot] = self._seq
            self._seq += 1
        return jobs

    def step(self) -> list[int]:
        """One decode tick for every active slot; returns finished jids in
        admission order (matching the emulator's finish-event order)."""
        if not self._active.any():
            return []
        self._remaining[self._active] -= 1
        self.steps += 1
        done = np.nonzero(self._active & (self._remaining <= 0))[0]
        done = done[np.argsort(self._admit_seq[done], kind="stable")]
        finished = [int(self._rid[s]) for s in done]
        self._active[done] = False
        self._rid[done] = -1
        self.free.extend(int(s) for s in done)
        return finished

    # ------------------------------------------------- event-skipping
    def next_finish_in(self) -> int | None:
        """Ticks until the earliest active slot finishes (``None`` when
        idle) — the engine-side event horizon ``ServeDriver``'s
        event-skipping consults."""
        if not self._active.any():
            return None
        return int(self._remaining[self._active].min())

    def advance_quiet(self, n: int) -> None:
        """Decrement every active slot by ``n`` ticks in one shot — the
        closed form of ``n`` consecutive :meth:`step` calls that each
        return no finishes. Refuses to jump past a finish: that would
        silently reorder completions, so it is an invariant error, not a
        clamp."""
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


class TorchEngineAdapter:
    """Drives the real continuous-batching ``repro_torch.serve.engine.Engine``:
    each workflow task becomes an inference request whose prompt is
    synthesized (seeded) at its ``prompt_len`` mark and whose decode
    budget is its ``decode_len`` mark, capped to the engine's cache. The
    engine runs where it was built (the card, or the CPU when asked): the
    adapter moves no tensor and has no device of its own."""

    def __init__(self, engine, *, seed: int = 0):
        # lazy: serve.engine imports serve.paged, which imports this module
        from repro_torch.serve.engine import Request
        self._Request = Request
        self.engine = engine
        self.capacity = engine.max_batch
        cfg = engine.lm.cfg
        self._vocab = cfg.vocab_size
        self._ncb = cfg.n_codebooks
        self.max_len = engine.max_len
        # a physically-paged engine's ledger, surfaced so the fleet's
        # PartitionedEngine can cross-check its own page accounting
        self.pager = getattr(engine, "pager", None)
        self._rng = np.random.default_rng(seed)

    @property
    def active_count(self) -> int:
        return self.engine.active_count

    def service_ticks(self, job: Job) -> int:
        """Decode steps the engine will actually serve — the cache-capped
        budget (floored at one tick for zero-decode jobs: the engine's
        finish check is post-append), so a parity harness's
        ``EmulatedEngine(max_len=...)`` agrees with the live backend on
        every finish tick."""
        return max(decode_budget(job.decode_len, job.prompt_len,
                                 self.max_len) - 1, 1)

    def _request(self, job: Job) -> "Request":
        # prompts at/above the cache depth are truncated to max_len - 1:
        # the budget (>= 1) then always fits, so a synthesized request can
        # never be oversize for the engine
        plen = min(max(job.prompt_len, 1), self.max_len - 1)
        shape = (plen,) if self._ncb <= 1 else (plen, self._ncb)
        toks = self._rng.integers(1, self._vocab, shape).astype(np.int32)
        budget = decode_budget(job.decode_len, plen, self.max_len)
        return self._Request(rid=job.jid, tokens=toks, max_new_tokens=budget)

    def admit_many(self, jobs: Sequence[Job]) -> Sequence[Job]:
        admitted = self.engine.admit_many([self._request(j) for j in jobs])
        if len(admitted) != len(jobs):
            raise ServeInvariantError(
                "admitted beyond free slots: engine took %d of %d"
                % (len(admitted), len(jobs)))
        return jobs

    def step(self) -> list[int]:
        return [req.rid for req in self.engine.step()]


def engine_service_ticks(engine, job: Job) -> int:
    """Decode ticks ``job`` will hold a slot for on ``engine`` — the
    engine's own notion when it has one (``EmulatedEngine``, or a fleet
    slice over one), else the token-length mark."""
    fn = getattr(engine, "service_ticks", None)
    if fn is not None:
        return fn(job)
    return max(job.decode_len, 1)


def default_max_ticks(stream, engine, tick_s: float) -> int:
    """Generous tick budget for a stream: its arrival span plus a fat
    multiple of its total decode work (a starved run cycles; the bound
    surfaces the stall as incomplete counts, not a hang). ``stream`` need
    not be sorted — ``ServeFleet`` passes its tenants' events merged.

    Single pass over the stream (span and work folded together): at 10^5+
    workflows the old two-pass walk cost more than an event-skipped run.
    The returned bound is pinned unchanged by the regression suite."""
    span = 0.0
    work = 0
    for t, jobs in stream:
        if t > span:
            span = t
        for j in jobs:
            work += engine_service_ticks(engine, j)
    return int(span / tick_s + 8 * work + 36_000)


def replay_contention(provider, contention, i: int, now: float,
                      strict: bool) -> int:
    """Replay scripted co-tenant load events due at ``now`` (positive
    delta = request, negative = release) against ``provider``; returns
    the advanced cursor. Shared by ``ServeDriver`` and ``ServeFleet`` so
    the strictness and epsilon semantics cannot drift between the two
    tick bodies."""
    while i < len(contention) and contention[i][0] <= now + 1e-9:
        _, tre, delta = contention[i]
        i += 1
        if delta > 0:
            ok = provider.request(tre, delta, now)
            if not ok and strict:
                raise ServeInvariantError(
                    f"scripted contention rejected: {tre} +{delta} "
                    f"at t={now}")
        elif delta < 0:
            provider.release(tre, -delta, now)
    return i


class ServeDriver(Tenant):
    """Replay a workflow arrival stream through one MTC TRE at trace rate.
    The MTC serve species of the ``repro_torch.serve.tenant.Tenant`` contract:
    the protocol hooks alias the serve-specific phase methods below (see
    the ``Tenant protocol`` section), which subclasses like
    ``ColumnarServeDriver`` override *by name* — the aliases dispatch
    virtually, so the columnar driver inherits the protocol for free.

    stream: ``[(arrival_t, jobs), ...]`` from ``traces.request_stream``
        (globally unique jids, deps remapped, token-length marks).
    provider: the shared provision service — a multi-tenant
        ``ResourceProvider`` gives deferred grants + backpressure; a plain
        ``ProvisionService`` gives the paper's grant-or-reject.
    engine: an engine adapter (``EmulatedEngine`` / ``TorchEngineAdapter``).
    policy / fixed_nodes: exactly one — DSP elasticity vs a dedicated
        engine of a fixed slot count (the baseline).
    contention: ``[(t, tre, delta), ...]`` co-tenant load replayed against
        the provider (positive = request, negative = release) — the "grant
        sequence" a parity test scripts identically into the emulator.
    clock: share a ``TickClock`` across drivers (``ServeFleet`` runs N
        tenant drivers on one clock); default: the driver owns its own.
    phase: control-cycle stagger in ticks — scans fire at
        ``k % scan_every == phase % scan_every`` (releases likewise), so a
        fleet spreads its tenants' cycles out instead of colliding at
        identical instants. The single-tenant default (0) keeps every
        cycle on the global grid, bit-for-bit with the emulator parity.
    slot_width: node units ONE batching slot of this tenant costs — the
        heterogeneous-fleet weight (a big-model tenant's slot is w > 1
        units of the shared pool). Provider grants, ``env.owned``/``busy``
        and every task's ``nodes`` are denominated in units (each task
        must carry ``nodes == slot_width``); the engine adapter still
        counts *slots*, so every engine-vs-grant comparison multiplies by
        the width. The default (1) is bit-identical to the homogeneous
        serve path.
    """

    def __init__(self, stream: Sequence[tuple[float, list[Job]]], *,
                 provider: ProvisionService, engine,
                 policy: MgmtPolicy | None = None,
                 fixed_nodes: int | None = None,
                 name: str = "mtc-serve", scheduler=None,
                 lifecycle: LifecycleService | None = None,
                 tick_s: float = 1.0,
                 contention: Sequence[tuple[float, str, int]] = (),
                 max_ticks: int | None = None, strict: bool = True,
                 clock: TickClock | None = None, phase: int = 0,
                 slot_width: int = 1, event_skip: bool = False):
        if slot_width < 1:
            raise ValueError(f"slot_width must be >= 1, got {slot_width}")
        self.stream = sorted(stream, key=lambda e: e[0])
        self.provider = provider
        self.engine = engine
        self.slot_width = slot_width
        self.tick_s = tick_s
        self.strict = strict
        self.clock = clock if clock is not None else TickClock()
        self.stats = ServeStats(name=name, tick_s=tick_s,
                                slot_width=slot_width,
                                workflows_expected=len(self.stream))
        self._admit_buf: list[Job] = []
        self.tasks: dict[int, Job] = {}
        self._wf_left: dict[int, int] = {}     # wid -> unfinished tasks
        self._stream_i = 0
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
        # the env's node ceiling, in units: a slot-denominated engine of S
        # slots can serve S * width units; a fleet slice reports the
        # shared pool's unit capacity directly
        cap_units = getattr(engine, "capacity_units", None)
        if cap_units is None:
            cap_units = engine.capacity * slot_width
        self.env = MTCRuntimeEnv(
            name, provision=provider, clock=self.clock, launch=self._launch,
            policy=policy, fixed_nodes=fixed_nodes, scheduler=scheduler,
            lifecycle=lifecycle, max_nodes=cap_units)
        self.env.grant_listener = self._on_grant
        self.env.track(())            # an empty stream is already all_done
        if max_ticks is None:
            max_ticks = default_max_ticks(self.stream, engine, tick_s)
        self.max_ticks = max_ticks
        # event-skipping needs the engine to expose its finish horizon and
        # a closed-form quiet advance; an adapter without them (the live
        # jax engine decodes real tokens every tick) just runs dense
        self.event_skip = bool(event_skip) and callable(
            getattr(engine, "next_finish_in", None)) and callable(
            getattr(engine, "advance_quiet", None))

    # ------------------------------------------------------- env hooks
    def _launch(self, job: Job) -> None:
        # buffered: the tick flushes launches as ONE batched admit, and
        # the task starts decoding next tick — emulator-identical timing
        if job.nodes != self.slot_width:
            raise ServeInvariantError(
                f"1 MTC task = 1 batching slot (= {self.slot_width} node "
                f"unit(s) at this tenant's width); "
                f"got nodes={job.nodes} for {job.name!r}")
        self._admit_buf.append(job)

    def _on_grant(self, nodes: int, t: float, deferred: bool) -> None:
        if deferred:
            self.stats.deferred_grants += 1
            self.stats.deferred_nodes += nodes

    # ------------------------------------------------------- tick parts
    def _submit_arrivals(self, now: float) -> None:
        while (self._stream_i < len(self.stream)
               and self.stream[self._stream_i][0] <= now + 1e-9):
            _, jobs = self.stream[self._stream_i]
            self._stream_i += 1
            if not jobs:
                continue
            self.env.track(jobs, extend=True)
            for j in jobs:
                self._wf_left[j.wid] = self._wf_left.get(j.wid, 0) + 1
                self.tasks[j.jid] = j
                if not j.deps:
                    self.env.submit(j)

    def _replay_contention(self, now: float) -> None:
        self._cont_i = replay_contention(self.provider, self._contention,
                                         self._cont_i, now, self.strict)

    def _maybe_release(self, k: int) -> None:
        if (self._release_every and k > 0
                and k % self._release_every == self._phase
                % self._release_every):
            self.env.release_check()

    def _process_finishes(self, finished: Sequence[int]) -> None:
        """Report a step's finished jids to the env (releasing dependents
        into the queue) and roll up workflow completions."""
        for jid in finished:
            task = self.tasks[jid]
            self.env.finish(task)
            self.stats.tasks_completed += 1
            self._wf_left[task.wid] -= 1
            if self._wf_left[task.wid] == 0:
                self.stats.workflows_completed += 1

    def _maybe_scan(self, k: int) -> None:
        if (self._scan_every and k > 0
                and k % self._scan_every == self._phase % self._scan_every):
            self.env.scan()

    def _flush_admissions(self) -> None:
        if not self._admit_buf:
            return
        w = self.slot_width
        if (self.engine.active_count + len(self._admit_buf)) * w \
                > self.env.owned:
            self.stats.over_admissions += 1
            if self.strict:
                raise ServeInvariantError(
                    "over-admission: (%d active + %d buffered) slots x "
                    "width %d > %d granted units"
                    % (self.engine.active_count, len(self._admit_buf),
                       w, self.env.owned))
        admitted = self.engine.admit_many(self._admit_buf)
        if admitted is None or len(admitted) >= len(self._admit_buf):
            self._admit_buf.clear()
        else:
            # a non-strict pool admitted only what fit its free slots: the
            # remainder stays in the launch buffer and is retried next
            # tick (its env bookkeeping — busy, allocation — is already
            # committed, so dropping it would strand the workflow and
            # spin the run to max_ticks)
            admitted_ids = {id(j) for j in admitted}
            self._admit_buf = [j for j in self._admit_buf
                               if id(j) not in admitted_ids]

    def _check_invariants(self) -> None:
        """End-of-tick consistency: the engine serves exactly the env's
        busy node units, and nothing exceeds the granted unit count. The
        engine counts slots; everything env-side is units, so the
        comparison weights by the tenant's slot width. A task parked back
        in the launch buffer by a non-strict partial admit still counts
        as busy env-side — it has not reached the engine yet, so the
        buffered units are part of the served total."""
        active = self.engine.active_count * self.slot_width
        active += len(self._admit_buf) * self.slot_width
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
        self.stats.queue_peak = max(self.stats.queue_peak,
                                    len(self.env.queue))

    @property
    def _done(self) -> bool:
        return (self._stream_i == len(self.stream) and self.env.all_done
                and not self._admit_buf and self.engine.active_count == 0)

    # --------------------------------------------------- event-skipping
    def _queue_len(self) -> int:
        """Queued-task count for the scan-skippability test (a columnar
        env overrides with its ring-buffer fill)."""
        return len(self.env.queue)

    def _next_arrival_t(self) -> float | None:
        """Timestamp of the next un-submitted stream entry (``None`` when
        the stream is drained) — the arrival horizon for event-skipping."""
        if self._stream_i < len(self.stream):
            return self.stream[self._stream_i][0]
        return None

    def next_event_tick(self, k: int) -> int:
        """Earliest tick after ``k`` at which the tick body could act: an
        arrival or contention event coming due, a release boundary (never
        skippable — the idle window resets even on a zero release, and a
        later decision diverges if it doesn't), a scan boundary with
        anything to negotiate or load (queued tasks or a parked request;
        an idle scan is a pure no-op), a buffered admission retry, or an
        engine finish. Every tick strictly between is *quiet*: nothing but
        the decode countdown and the stats integrals, which
        :meth:`_skip_quiet` applies in closed form."""
        if self._admit_buf:
            return k + 1
        cands = []
        arr_t = self._next_arrival_t()
        if arr_t is not None:
            cands.append(due_tick_floor(arr_t, self.tick_s))
        if self._cont_i < len(self._contention):
            cands.append(due_tick_floor(self._contention[self._cont_i][0],
                                        self.tick_s))
        if self._release_every:
            cands.append(next_boundary(k, self._release_every, self._phase))
        if self._scan_every and (self._queue_len()
                                 or self.env._pending_req is not None):
            cands.append(next_boundary(k, self._scan_every, self._phase))
        fin = self.engine.next_finish_in()
        if fin is not None:
            cands.append(k + fin)
        if not cands:
            return self.max_ticks
        return max(min(cands), k + 1)

    def _skip_quiet(self, dq: int) -> None:
        """Advance ``dq`` provably-quiet ticks in closed form: the decode
        countdown, the busy/owned stats integrals, and the clock. Nothing
        else can change — the engine refuses to advance past a finish, so
        a wrong horizon is an invariant error, not silent drift. With the
        default integral ``tick_s`` the closed form is bit-identical to
        ``dq`` dense accumulations."""
        if self.engine.active_count:
            self.engine.advance_quiet(dq)
        self.stats.busy_node_ticks += self.env.busy * self.tick_s * dq
        self.stats.owned_node_ticks += self.env.owned * self.tick_s * dq
        self.clock.advance(self.tick_s * dq)

    def _tick(self, k: int) -> None:
        """One control tick — THE serve tick body. ``ServeFleet`` replays
        these same phases in the same order across N tenant drivers (with
        one globally-stepped engine between the release and scan phases);
        keep any phase-order change mirrored there or fleet(N=1) parity
        breaks."""
        now = self.clock.now()
        self._submit_arrivals(now)
        self._replay_contention(now)
        self._maybe_release(k)
        self._process_finishes(self.engine.step())
        self._maybe_scan(k)
        self._flush_admissions()
        self._check_invariants()
        self._accumulate()

    # ------------------------------------- Tenant protocol (serve species)
    # ``ServeFleet`` drives lanes through these hooks; they alias the
    # serve phase methods above, which subclasses override by name, so
    # the protocol costs one virtual dispatch and zero behavior change.
    @property
    def name(self) -> str:
        return self.env.name

    def begin_tick(self, now: float) -> None:
        self._submit_arrivals(now)

    def pre_step(self, k: int) -> None:
        self._maybe_release(k)

    def post_step(self, k: int) -> None:
        self._process_finishes(self.engine.step())

    def control(self, k: int) -> None:
        self._maybe_scan(k)

    def flush(self) -> None:
        self._flush_admissions()

    def check_invariants(self) -> None:
        self._check_invariants()

    def accumulate(self) -> None:
        self._accumulate()

    @property
    def retired(self) -> bool:
        return self._done

    def skip_quiet_stats(self, dq: int) -> None:
        """The stats half of :meth:`_skip_quiet` — the fleet advances
        the shared pool and clock itself."""
        self.stats.busy_node_ticks += self.env.busy * self.tick_s * dq
        self.stats.owned_node_ticks += self.env.owned * self.tick_s * dq

    def rollup(self, fleet_stats) -> None:
        ls = self.stats
        fleet_stats.workflows_completed += ls.workflows_completed
        fleet_stats.tasks_completed += ls.tasks_completed
        fleet_stats.busy_node_ticks += ls.busy_node_ticks
        fleet_stats.owned_node_ticks += ls.owned_node_ticks
        fleet_stats.node_hours += ls.node_hours
        fleet_stats.deferred_grants += ls.deferred_grants
        fleet_stats.deferred_nodes += ls.deferred_nodes
        fleet_stats.over_admissions += ls.over_admissions
        fleet_stats.tenants.append(ls.as_dict())

    # -------------------------------------------------------------- run
    def finalize(self, ticks: int) -> ServeStats:
        """Close out the run: derived rates, destroy the TRE (closing
        every lease) and settle the billed node-hours."""
        self.stats.ticks = ticks
        self.stats.makespan_s = self.clock.now()
        if self.stats.makespan_s > 0:
            self.stats.workflows_per_hour = (
                self.stats.workflows_completed
                / (self.stats.makespan_s / 3600.0))
        if self.stats.owned_node_ticks > 0:
            self.stats.slot_utilization = (self.stats.busy_node_ticks
                                           / self.stats.owned_node_ticks)
        if not self.env.destroyed:
            self.env.destroy()
        self.stats.node_hours = self.provider.node_hours(
            self.env.name, now=self.clock.now())
        return self.stats

    def run(self) -> ServeStats:
        """Replay the stream to completion (or the tick bound); destroy
        the TRE (closing every lease) and return the stats. With
        ``event_skip`` the loop jumps the clock over quiet ticks
        (:meth:`next_event_tick`) — landing early is harmless (a no-op
        tick), landing late is impossible, so the stats are bit-identical
        to the dense loop's."""
        k = 0
        self._tick(k)
        while not self._done and k < self.max_ticks:
            if self.event_skip:
                kn = min(self.next_event_tick(k), self.max_ticks)
                dq = kn - k - 1
                if dq > 0:
                    self._skip_quiet(dq)
                    k += dq
            k += 1
            self.clock.advance(self.tick_s)
            self._tick(k)
        return self.finalize(k)
