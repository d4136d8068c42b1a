"""TRE lifecycle management (paper §3.1.3, Fig 4).

The CSF's lifecycle management service owns the state machine
``inexistent -> planning -> created -> running -> inexistent`` and performs
the side effects of each transition: validating the request, deploying the
TRE package (modeled as a per-node setup cost), registering it with the
resource provision service, starting its components, and destroying it
(prompt-backup -> stop daemons -> offload -> withdraw resources).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.provision import ProvisionService


class TREState(Enum):
    INEXISTENT = "inexistent"
    PLANNING = "planning"
    CREATED = "created"
    RUNNING = "running"


_VALID = {
    (TREState.INEXISTENT, TREState.PLANNING),
    (TREState.PLANNING, TREState.CREATED),
    (TREState.CREATED, TREState.RUNNING),
    (TREState.RUNNING, TREState.INEXISTENT),
    # rejected requests fall back
    (TREState.PLANNING, TREState.INEXISTENT),
}


@dataclass
class TRERecord:
    name: str
    kind: str                    # "htc" | "mtc"
    policy: MgmtPolicy
    state: TREState = TREState.INEXISTENT
    created_t: float = -1.0
    destroyed_t: float = -1.0
    history: list = field(default_factory=list)

    def transition(self, to: TREState, t: float):
        if (self.state, to) not in _VALID:
            raise ValueError(f"invalid TRE transition {self.state} -> {to}")
        self.history.append((t, self.state.value, to.value))
        self.state = to


class LifecycleService:
    """Creates/destroys TREs on behalf of service providers."""

    def __init__(self, provision: ProvisionService):
        self.provision = provision
        self.tres: dict[str, TRERecord] = {}

    def apply(self, name: str, kind: str, policy: MgmtPolicy, t: float,
              *, count_adjust: bool = True) -> TRERecord | None:
        """Service provider applies for a new TRE (steps 1-5 of §3.1.3).

        Returns the record in RUNNING state, or None if the platform cannot
        provision the initial resources (request rejected). ``count_adjust``
        mirrors ``ProvisionService.request``: DCS REs own their configuration
        outright, so deploying one is not a node *adjustment* (§4.5.4).
        """
        if kind not in ("htc", "mtc"):
            raise ValueError(f"unknown workload kind {kind!r}")
        if name in self.tres and self.tres[name].state != TREState.INEXISTENT:
            raise ValueError(f"TRE {name!r} already exists")
        rec = TRERecord(name, kind, policy)
        self.tres[name] = rec
        rec.transition(TREState.PLANNING, t)          # validated
        if not self.provision.request(name, policy.initial, t,
                                      count_adjust=count_adjust):
            rec.transition(TREState.INEXISTENT, t)    # rejected
            return None
        rec.transition(TREState.CREATED, t)           # deployed
        rec.transition(TREState.RUNNING, t)           # components started
        rec.created_t = t
        return rec

    def destroy(self, name: str, t: float, *, count_adjust: bool = True) -> None:
        """Destroy a TRE (step 8): withdraw all resources. As with
        :meth:`apply`, withdrawing an owned (DCS) configuration is not a
        node adjustment (§4.5.4) — pass ``count_adjust=False`` there."""
        rec = self.tres[name]
        if rec.state != TREState.RUNNING:
            raise ValueError(f"cannot destroy TRE in state {rec.state}")
        self.provision.destroy(name, t, count_adjust=count_adjust)
        rec.transition(TREState.INEXISTENT, t)
        rec.destroyed_t = t
