"""Discrete-event simulation kernel.

The paper emulates its systems with a 100x wall-clock speedup (§4.1); a
discrete-event kernel is strictly faster and exact: the clock jumps between
events (job arrivals/finishes, policy scan ticks, hourly release checks).
Events at equal times fire in scheduling order (stable heap).
"""
from __future__ import annotations

import heapq
import math
from typing import Callable


class Sim:
    def __init__(self):
        self.t = 0.0
        self.last_event_t = 0.0   # time of the last event actually fired
        self._heap: list = []
        self._seq = 0

    @property
    def drained(self) -> bool:
        """True when every scheduled event has fired (the run ended on its
        own rather than being cut off at a ``run(until=...)`` bound)."""
        return not self._heap

    def at(self, t: float, fn: Callable, *args) -> None:
        # guarded raise, not assert: an event scheduled in the past would
        # silently fire out of order under ``python -O`` and desequence
        # the whole run (billing/idle integrals depend on event order)
        if t < self.t - 1e-9:
            raise RuntimeError(
                f"event scheduled in the past: t={t} < now={self.t}")
        heapq.heappush(self._heap, (t, self._seq, fn, args))
        self._seq += 1

    def after(self, dt: float, fn: Callable, *args) -> None:
        self.at(self.t + dt, fn, *args)

    def every(self, interval: float, fn: Callable[[], bool]) -> None:
        """Repeat ``fn`` every ``interval`` while it returns True."""
        def tick():
            if fn():
                self.after(interval, tick)
        self.after(interval, tick)

    def run(self, until: float = math.inf) -> float:
        while self._heap and self._heap[0][0] <= until:
            t, _, fn, args = heapq.heappop(self._heap)
            self.t = t
            self.last_event_t = t
            fn(*args)
        if math.isfinite(until):
            self.t = max(self.t, until)
        return self.t
