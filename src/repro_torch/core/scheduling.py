"""Job scheduling policies (paper §4.4(1) + beyond-paper backfill).

``first_fit``  — HTC: scan all queued jobs in arrival order and start every
                 job whose node demand fits the currently free nodes.
``fcfs``       — MTC: strict first-come-first-served over *ready* tasks
                 (dependencies satisfied); head-of-line blocks the queue.
``backfill``   — HTC, beyond-paper: FCFS with conservative backfill. Every
                 queued job gets a reservation against the projected
                 free-node profile; a job may jump a blocked head only when
                 starting it now cannot delay any earlier job's reserved
                 start. Needs the release times of running jobs — when the
                 caller cannot supply a complete profile it degrades to
                 plain ``fcfs`` (never optimistic).
``easy``       — HTC, beyond-paper: EASY (aggressive) backfill. Only the
                 *blocked head* gets a reservation; any later job may jump
                 it if starting now cannot delay that reservation — jobs
                 behind the head hold no reservation, so a fill may delay
                 *them* (the EASY trade-off: better utilization, weaker
                 fairness, head start-time guarantee kept). Same
                 degrade-to-FCFS rule on an incomplete release profile.

All schedulers share one signature: ``sched(queue, free, **context)`` and
return the list of jobs to start now; the caller removes them from the
queue and commits the nodes. The optional context keywords (``now``,
``running`` = sequence of ``(end_time, nodes)`` reservations, ``busy``) are
supplied by ``repro_torch.core.tre.RuntimeEnv`` and ignored by the paper's two
schedulers. New policies plug in via the ``SCHEDULERS`` registry.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.types import Job


def first_fit(queue: Sequence[Job], free: int, **_ctx) -> list[Job]:
    started: list[Job] = []
    for job in queue:
        if job.nodes <= free:
            started.append(job)
            free -= job.nodes
    return started


def fcfs(queue: Sequence[Job], free: int, **_ctx) -> list[Job]:
    started: list[Job] = []
    for job in queue:
        if job.nodes > free:
            break
        started.append(job)
        free -= job.nodes
    return started


# ------------------------------------------------------- conservative backfill
def _earliest_start(profile: list[list[float]], nodes: int,
                    runtime: float) -> float | None:
    """Earliest profile breakpoint where ``nodes`` stay available for
    ``runtime``. ``profile`` is a sorted list of ``[t, avail]`` steps; the
    last step extends to infinity. None = never fits (job wider than pool)."""
    for i, (t0, a0) in enumerate(profile):
        if a0 < nodes:
            continue
        end = t0 + runtime
        if all(a >= nodes for t, a in profile[i + 1:] if t < end):
            return t0
    return None


def _reserve(profile: list[list[float]], t0: float, runtime: float,
             nodes: int) -> None:
    """Subtract ``nodes`` from the profile over ``[t0, t0 + runtime)``."""
    end = t0 + runtime
    for t_cut in (t0, end):
        for i, (t, a) in enumerate(profile):
            if t == t_cut:
                break
            if t > t_cut:
                profile.insert(i, [t_cut, profile[i - 1][1]])
                break
        else:
            profile.append([t_cut, profile[-1][1]])
    for step in profile:
        if t0 <= step[0] < end:
            step[1] -= nodes


def _release_profile(free: int, now: float,
                     running: Sequence[tuple[float, int]], busy: int,
                     ) -> list[list[float]] | None:
    """Projected free-node profile ``[[t, avail], ...]`` from the running
    set's release times. Drops overdue reservations (a task running past
    its estimate has NOT freed its nodes); returns None when any release
    is unknown or stale — a missing release makes a head's reservation
    infinitely late and every fill "harmless", so backfill variants must
    refuse to guess and degrade to strict FCFS."""
    running = [(t, n) for t, n in running if n > 0 and t > now]
    if sum(n for _, n in running) < busy:
        return None
    profile: list[list[float]] = [[now, free]]
    for t_end, n in sorted(running):
        profile.append([t_end, profile[-1][1] + n])
    return profile


def backfill(queue: Sequence[Job], free: int, *, now: float = 0.0,
             running: Sequence[tuple[float, int]] = (), busy: int = 0,
             **_ctx) -> list[Job]:
    """FCFS with conservative backfill over the projected release profile."""
    if not queue:
        return []
    profile = _release_profile(free, now, running, busy)
    if profile is None:
        return fcfs(queue, free)
    started: list[Job] = []
    for job in queue:
        t_start = _earliest_start(profile, job.nodes, job.runtime)
        if t_start is None:
            # wider than the pool ever gets: in a DSP env the next scan's
            # DR2 will grow the pool for it, so give it FCFS-blocking
            # semantics — nothing behind it may start, else the fill would
            # delay it past the grant
            break
        if t_start <= now:
            started.append(job)
        _reserve(profile, t_start, job.runtime, job.nodes)
    return started


def easy_backfill(queue: Sequence[Job], free: int, *, now: float = 0.0,
                  running: Sequence[tuple[float, int]] = (), busy: int = 0,
                  **_ctx) -> list[Job]:
    """EASY backfill: FCFS until a job blocks; the blocked head reserves
    its earliest start against the release profile, and later jobs may
    start *now* only if they fit the profile including that reservation —
    the head's reserved start can never be delayed. Unlike conservative
    ``backfill``, jobs behind the head get no reservation of their own
    (a fill may push them back)."""
    if not queue:
        return []
    profile = _release_profile(free, now, running, busy)
    if profile is None:
        return fcfs(queue, free)          # incomplete profile: never guess
    started: list[Job] = []
    head_blocked = False
    for job in queue:
        t_start = _earliest_start(profile, job.nodes, job.runtime)
        if not head_blocked:
            if t_start is None:
                # wider than the pool ever gets: FCFS-blocking so a DSP
                # env's next DR2 grant is not delayed by fills (matches
                # conservative backfill)
                break
            if t_start <= now:
                started.append(job)
                _reserve(profile, now, job.runtime, job.nodes)
            else:
                head_blocked = True
                # the head's reservation — the only one EASY honors
                _reserve(profile, t_start, job.runtime, job.nodes)
        elif t_start is not None and t_start <= now:
            started.append(job)
            _reserve(profile, now, job.runtime, job.nodes)
    return started


SCHEDULERS = {"first_fit": first_fit, "fcfs": fcfs, "backfill": backfill,
              "easy": easy_backfill}


def scheduler_for(kind: str):
    """HTC -> first-fit; MTC -> FCFS (paper §4.4)."""
    return first_fit if kind == "htc" else fcfs


def resolve_scheduler(spec, kind: str):
    """Accept a scheduler callable, a ``SCHEDULERS`` registry key, or None
    (= the paper's default for the workload kind)."""
    if spec is None:
        return scheduler_for(kind)
    if callable(spec):
        return spec
    try:
        return SCHEDULERS[spec]
    except KeyError:
        raise ValueError(
            f"unknown scheduler {spec!r}; registered: {sorted(SCHEDULERS)}"
        ) from None
