"""What one call of a kernel costs the card, from its shapes alone.

Each kernel module gives a ``cost`` beside its wrapper: the device
kernels one call runs, the bytes it must move (each input read once, each
output written once) and the operations it does, each at the peak rate of
its operands' type. One count serves three readers: ``kernels.ops``
reports it for every call it routes (the dry run, ``launch.dryrun``, sums
it per step), ``chip_smoke.py`` prices each kernel's bound from it, and
``launch.roofline`` reads the dry run's sums. The JAX package has no
counterpart: XLA's ``cost_analysis`` counts a Pallas call as opaque.

Rates are the H100 SXM data sheet's dense peaks (``PERF.md`` §3).
"""
from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = {"bf16": 989e12,   # dense bf16 tensor cores
              "tf32": 495e12,   # dense TF32 tensor cores
              "fp32": 67e12}    # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12            # HBM3


class Cost(NamedTuple):
    kernels: int          # device kernels one call runs (0: nothing runs)
    nbytes: int           # bytes it must move
    flops: tuple = ()     # ((operations, a key of PEAK_FLOPS), ...)

    @property
    def total_flops(self) -> int:
        return sum(n for n, _ in self.flops)

    def bound(self) -> tuple[float, str]:
        """(ms, by): the larger of the bytes over the memory rate and the
        operations, each part at its own rate."""
        t_ops = sum(n / PEAK_FLOPS[rate] for n, rate in self.flops)
        t_bytes = self.nbytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")


def rate_of(dtype) -> str:
    """The peak an operand dtype's products run at: the tensor cores for
    bf16, CUDA cores for fp32 (TF32 is off in the port)."""
    return "bf16" if str(dtype).endswith("bfloat16") else "fp32"
