"""DSP resource-management & provision policies (paper §3.2.2).

``PolicyEngine`` is *pure decision logic*: given queue state it returns how
many nodes to request; given idle state it returns how many to release. The
same engine instance drives (a) the discrete-event emulator
(``repro_torch.sim.systems``) and (b) the live elastic JAX controller
(``repro_torch.core.controller``) — one implementation, two drivers, which is what
makes the reproduction a framework rather than a simulator.

Paper semantics implemented here:

HTC (§3.2.2.1): initial resources ``B`` are never released; the server scans
the queue every 60 s; with *ratio of obtaining resources* =
(accumulated demand of queued jobs) / (currently owned):
  - ratio > R           -> request DR1 = demand - owned
  - biggest job > owned -> request DR2 = biggest - owned   (when ratio <= R)
Each granted block registers an hourly idle-check; a block is released when
idle resources cover its size.

MTC (§3.2.2.2): identical, but the scan period is 3 s (tasks run in seconds)
and every queued workflow-constituent job counts toward the demand.

Provision policy (§3.2.2.3): grant if available else reject; releases are
passively reclaimed. Implemented by ``repro_torch.core.provision``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

HTC_SCAN_S = 60.0
MTC_SCAN_S = 3.0
RELEASE_CHECK_S = 3600.0


@dataclass(frozen=True)
class MgmtPolicy:
    """A service provider's resource-management policy (B, R)."""
    initial: int                 # B: initial resources (never reclaimed)
    ratio: float                 # R: threshold ratio of obtaining resources
    scan_interval: float         # 60 s (HTC) / 3 s (MTC)
    release_interval: float = RELEASE_CHECK_S

    @staticmethod
    def htc(B: int, R: float) -> "MgmtPolicy":
        return MgmtPolicy(B, R, HTC_SCAN_S)

    @staticmethod
    def mtc(B: int, R: float) -> "MgmtPolicy":
        return MgmtPolicy(B, R, MTC_SCAN_S)


class PolicyEngine:
    """Stateful wrapper tracking outstanding dynamic blocks (DR1/DR2)."""

    def __init__(self, policy: MgmtPolicy):
        self.policy = policy
        self.dynamic_blocks: list[int] = []

    # ------------------------------------------------------------- scan
    def scan_request_stats(self, total: int, biggest: int, smallest: int,
                           owned: int) -> tuple[int, int]:
        """(nodes to request, minimum useful grant) from queue *summary
        statistics* — total / biggest / smallest queued node demand. The
        decision only ever reads these three aggregates, so a columnar
        driver holding 10^5-10^6 queued tasks as arrays can negotiate
        without materializing a per-job demand list (``repro_torch.serve.
        columnar`` keeps them as ``queue_len * width``).

        A grant is *useful* only if it can put at least one queued job on
        nodes; anything smaller sits idle until the hourly release check
        reclaims it (thrash that bills a fresh lease-hour per cycle). For
        a DR1 backlog the floor is what the narrowest queued job would
        need even if everything owned were free (1 when it already fits
        inside owned — the grant then relieves genuine contention); DR2
        exists to fit one job wider than everything owned, so it is
        all-or-nothing.
        """
        if total <= 0:
            return 0, 0
        ratio = total / max(owned, 1)
        if ratio > self.policy.ratio and total > owned:
            floor = max(1, smallest - owned)
            return total - owned, floor      # DR1: divisible down to floor
        if biggest > owned:
            return biggest - owned, biggest - owned   # DR2: indivisible
        return 0, 0

    def scan_request(self, queued_demands: Sequence[int],
                     owned: int) -> tuple[int, int]:
        """Per-job-list form of :meth:`scan_request_stats` (the historical
        signature; both must stay decision-identical — pinned in tests)."""
        if not queued_demands:
            return 0, 0
        return self.scan_request_stats(sum(queued_demands),
                                       max(queued_demands),
                                       min(queued_demands), owned)

    def scan(self, queued_demands: Sequence[int], owned: int) -> int:
        """Nodes to request right now (0 = no action).

        queued_demands: per-job node demands of everything in the queue.
        """
        return self.scan_request(queued_demands, owned)[0]

    def urgency_stats(self, total: int, owned: int) -> float:
        """The §3.2.2.1 *ratio of obtaining resources* (queued demand over
        owned) as a cross-TRE arbitration priority: a coordinated provider
        (``repro_torch.core.provider.CoordinatedPolicy``) serves the most
        oversubscribed tenant first when simultaneous requests contend."""
        if total <= 0:
            return 0.0
        return total / max(owned, 1)

    def urgency(self, queued_demands: Sequence[int], owned: int) -> float:
        """Per-job-list form of :meth:`urgency_stats`."""
        return self.urgency_stats(sum(queued_demands), owned)

    def granted(self, n: int) -> None:
        if n > 0:
            self.dynamic_blocks.append(n)

    @property
    def dynamic_total(self) -> int:
        return sum(self.dynamic_blocks)

    # ---------------------------------------------------------- release
    def release_check(self, idle: int) -> int:
        """Hourly idle check: release every dynamic block covered by idle
        resources (biggest blocks first). Returns total nodes to release."""
        released = 0
        keep: list[int] = []
        for blk in sorted(self.dynamic_blocks, reverse=True):
            if idle - released >= blk:
                released += blk
            else:
                keep.append(blk)
        self.dynamic_blocks = keep
        return released

    def release_all(self) -> int:
        n = self.dynamic_total
        self.dynamic_blocks = []
        return n
