"""Pluggable system registry: usage models as plugins, not ``elif``s.

The paper compares four usage models (DCS / SSP / DRP / DawningCloud); the
PhoenixCloud and scientific-communities follow-ups extend exactly this axis
with new coordinated policies and workload mixes. A ``System`` encapsulates
everything one usage model needs to run over consolidated workloads —
which runner to build per workload, and how its resource consumption is
billed — so a new scenario is a ``@register_system("name")`` class, not an
edit to ``run_system``.

This module is driver-agnostic: it defines only the registry mechanism and
the abstract ``System``. The emulated systems live in
``repro_torch.sim.systems``; a live-serving scenario could register here just as
well.
"""
from __future__ import annotations

from typing import Any


class System:
    """One usage model. Subclass and register::

        @register_system("myscenario")
        class MyScenario(System):
            def build(self, ctx, workload): ...
            def node_hours(self, ctx, runner, end): ...

    ``ctx`` is whatever context object the experiment runner passes (the
    emulator uses ``repro_torch.sim.systems.EmulationContext``: sim clock,
    provision + lifecycle services, per-workload policies and scheduler
    overrides).
    """

    name: str = ""
    #: route runs through a multi-tenant ``ResourceProvider`` with this
    #: coordination policy ("first-come" / "coordinated" / a
    #: ``CoordinationPolicy`` instance); None = the paper's plain
    #: grant-or-reject ``ProvisionService``
    coordination: Any = None

    def build(self, ctx: Any, workload: Any) -> Any:
        """Create and wire this system's runner for one workload."""
        raise NotImplementedError

    # ---- multi-tenant platform defaults (used when the caller does not
    # ---- pass capacity/quotas/reservations explicitly) ----
    def default_capacity(self, workloads: Any, policies: Any) -> int | None:
        """Shared platform size for these tenants (None = unbounded)."""
        return None

    def default_quotas(self, workloads: Any, policies: Any) -> dict | None:
        """Per-TRE hard allocation caps (None = uncapped)."""
        return None

    def default_reservations(self, workloads: Any) -> dict | None:
        """Per-TRE guaranteed minimum capacity (None = none)."""
        return None

    def finalize(self, ctx: Any, runner: Any, end: float) -> None:
        """Hook after the run completes (e.g. destroy surviving TREs)."""

    def node_hours(self, ctx: Any, runner: Any, end: float) -> float:
        """Billed node*hours for this runner's workload (paper §4.3)."""
        raise NotImplementedError


_REGISTRY: dict[str, System] = {}


def register_system(name: str, *, replace: bool = False):
    """Class decorator: instantiate and register a ``System`` under ``name``."""

    def deco(cls: type[System]) -> type[System]:
        if name in _REGISTRY and not replace:
            raise ValueError(f"system {name!r} already registered "
                             f"(pass replace=True to override)")
        inst = cls()
        inst.name = name
        _REGISTRY[name] = inst
        return cls

    return deco


def _ensure_builtin_systems() -> None:
    """The built-in usage models register as an import side effect of
    ``repro_torch.sim.systems`` (emulated) and ``repro_torch.serve.fleet`` (the
    tick-driven serving fleet); make the accessors self-sufficient so
    ``from repro_torch.core import available_systems`` works standalone."""
    import repro_torch.serve.fleet  # noqa: F401
    import repro_torch.sim.systems  # noqa: F401


def get_system(name: str) -> System:
    _ensure_builtin_systems()
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown system {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_systems() -> tuple[str, ...]:
    _ensure_builtin_systems()
    return tuple(sorted(_REGISTRY))
