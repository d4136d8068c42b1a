"""Shared workload types for the DSP model (paper §2).

A *Job* is the unit both the emulator and the live controllers schedule:
HTC jobs are independent (``deps=()``); MTC workflow tasks carry control-flow
dependencies (``deps`` = jids within the same workflow) and are released to
the queue by the trigger monitor only when every dependency has finished.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass
class Job:
    jid: int
    arrival: float          # seconds from trace start (MTC tasks: 0)
    runtime: float          # seconds
    nodes: int
    deps: tuple = ()        # jids this job waits on (same workload)
    wid: int = -1           # workflow id (-1 = independent HTC job)
    name: str = ""
    # ---- token-length marks (MTC serving: one task = one inference
    # request; repro_torch.sim.traces.mark_tokens stamps these from runtime) ----
    prompt_len: int = 0     # prompt tokens (0 = not an inference task)
    decode_len: int = 0     # decode tokens = service ticks at 1 tok/tick
    # ---- filled in by a run ----
    submit_time: float = -1.0   # entered the queue (deps satisfied)
    start: float = -1.0
    finish: float = -1.0

    @property
    def wait(self) -> float:
        return self.start - self.submit_time if self.start >= 0 else -1.0

    def fresh(self) -> "Job":
        return replace(self, submit_time=-1.0, start=-1.0, finish=-1.0)


@dataclass
class Workload:
    """One service provider's workload (= one TRE's job stream)."""
    name: str
    kind: str               # "htc" | "mtc"
    jobs: list[Job] = field(default_factory=list)
    trace_nodes: int = 0    # original platform size (DCS/SSP config size)
    period: float = 0.0     # trace window in seconds

    def fresh(self) -> "Workload":
        return Workload(self.name, self.kind, [j.fresh() for j in self.jobs],
                        self.trace_nodes, self.period)

    @property
    def total_work(self) -> float:
        """node*seconds of actual compute demand."""
        return sum(j.nodes * j.runtime for j in self.jobs)

    @property
    def max_job_nodes(self) -> int:
        return max(j.nodes for j in self.jobs)

    def utilization(self, nodes: int | None = None) -> float:
        n = nodes or self.trace_nodes
        return self.total_work / (n * self.period) if self.period else 0.0
