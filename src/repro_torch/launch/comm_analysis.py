"""The collectives one step makes, and their wire cost: the port's
counterpart of ``repro.launch.hlo_analysis``.

The reference parses the compiled per-device HLO for its collective ops,
sizes each from its result type, rebuilds its replica groups and scales
it by the trip counts of the ``while`` loops around it. The port has no
HLO: its record is the collectives that one rank's step makes, each as
it is made (``parallel.collectives.observed``), with the group's global
ranks. A layer loop's collectives therefore appear once a layer and a
microbatch's once a microbatch, so no op carries a trip count (the
reference's ``trips``) and none a computation name.

``tpu_corrected_bytes`` has no counterpart. The reference halves the f32
reductions that XLA:CPU materializes where a TPU reduces in bf16; the
port reduces in the dtype it passes, so the recorded dtype is the wire's.

Wire-byte model (ring algorithms, n = group size), the reference's:
  all-gather          (n-1)/n * result_bytes      (result = gathered)
  reduce-scatter      (n-1)   * result_bytes      (operand = n * result)
  all-reduce          2 (n-1)/n * result_bytes
  all-to-all          (n-1)/n * result_bytes
  collective-permute  result_bytes
Beside the reference's pod boundary (256 ranks) each op records whether
its group spans H100 nodes of 8 cards (NVLink inside a node, the
inter-node fabric across), which ``launch.roofline`` prices.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.parallel import collectives

POD_SIZE = 256     # ranks of a pod: the reference's multi-pod boundary
NODE_SIZE = 8      # H100 cards of a node, joined all to all by NVLink

DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32",
               torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}


@dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    crosses_pod: bool
    dtype: str = ""
    ranks: tuple = ()
    crosses_node: bool = False

    @property
    def wire_bytes(self) -> float:
        n = max(self.group_size, 1)
        f = (n - 1) / n
        if self.kind == "all-gather":
            w = f * self.result_bytes
        elif self.kind == "reduce-scatter":
            w = (n - 1) * self.result_bytes
        elif self.kind == "all-reduce":
            w = 2 * f * self.result_bytes
        elif self.kind == "all-to-all":
            w = f * self.result_bytes
        else:  # collective-permute
            w = self.result_bytes
        return w

    def key(self) -> tuple:
        """What two records of one step must agree on: kind, dtype,
        result bytes and the group's global ranks."""
        return (self.kind, self.dtype, self.result_bytes, self.ranks)


class Recorder:
    """The ``CollectiveOp``s of the collectives this rank makes while it
    is installed (``record_collectives``), in the order made."""

    def __init__(self):
        self.ops: list[CollectiveOp] = []

    def __call__(self, kind: str, result, group) -> None:
        ranks = tuple(dist.get_process_group_ranks(group))
        self.ops.append(CollectiveOp(
            kind=kind, result_bytes=result.numel() * result.element_size(),
            group_size=len(ranks),
            crosses_pod=len({r // POD_SIZE for r in ranks}) > 1,
            dtype=DTYPE_NAMES.get(result.dtype, str(result.dtype)),
            ranks=ranks,
            crosses_node=len({r // NODE_SIZE for r in ranks}) > 1))


@contextlib.contextmanager
def record_collectives():
    """``with record_collectives() as rec:`` records into ``rec.ops``."""
    rec = Recorder()
    with collectives.observed(rec):
        yield rec


def collective_summary(ops) -> dict:
    """The reference's summary (without its ``_tpu`` estimates), with
    the wire bytes split at H100 nodes too."""
    out = {
        "n_ops": len(ops),
        "wire_bytes_intra_pod": 0.0,
        "wire_bytes_cross_pod": 0.0,
        "wire_bytes_intra_node": 0.0,
        "wire_bytes_cross_node": 0.0,
        "by_kind": {},
    }
    for op in ops:
        out["by_kind"].setdefault(op.kind, 0.0)
        out["by_kind"][op.kind] += op.wire_bytes
        pod = "cross" if op.crosses_pod else "intra"
        node = "cross" if op.crosses_node else "intra"
        out[f"wire_bytes_{pod}_pod"] += op.wire_bytes
        out[f"wire_bytes_{node}_node"] += op.wire_bytes
    return out
