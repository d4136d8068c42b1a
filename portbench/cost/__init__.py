"""The yardstick's kernel costs: what one call of a logical op must do,
from its shapes and the data that decides its work, and the peaks that
price it.

Frozen copies of the port's ``kernels/cost.py`` and of each kernel's
``cost`` (``flash_attention``, ``decode_attention``, ``moe_gmm``): each
input read once, each output written once, the operations at the peak
of their operands' type. Two counts follow the data where the port's
own count follows the shapes, as a roofline must: ``paged_decode``
reads the K/V of the positions each row attends and the page-table
entries that cover them, not the whole table; ``moe_gmm`` reads the
weights of the experts with a filled row and the filled rows of x, and
writes the filled rows of its output (the port's count writes the whole
padded (E, C, f) output, which dropless routing makes C = T rows an
expert: bytes the function does not need).

Peaks: NVIDIA's H100 SXM data sheet, dense: 989 TFLOP/s bf16, 67 TFLOP/s
fp32 outside the tensor cores, 3.35 TB/s HBM3, at the full 700 W.
"""
from __future__ import annotations

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12


def rate_of(dtype_bytes: int) -> str:
    """bf16 operands run on the tensor cores; fp32 off them (the port
    keeps TF32 off)."""
    return "bf16" if dtype_bytes == 2 else "fp32"


def bound_s(flops: float, nbytes: float, rate: str) -> float:
    """The least seconds a call can take: the larger of its operations at
    the peak and its bytes at the memory rate."""
    return max(flops / PEAK_FLOPS[rate], nbytes / PEAK_BYTES)


def flash(call) -> float:
    """Causal prefill attention on (BH, S, hd) q, k, v (top-left aligned):
    q, k, v read and o written once; QK^T and PV over the visible
    pairs."""
    (BH, S, hd), (_, Sk, _) = call["shapes"][0], call["shapes"][1]
    e = call["dtype_bytes"]
    if S <= Sk:
        pairs = S * (S + 1) // 2
    else:
        pairs = Sk * (Sk + 1) // 2 + (S - Sk) * Sk
    return bound_s(4 * BH * hd * pairs, 2 * BH * (S + Sk) * hd * e,
                   rate_of(e))


def paged_decode(call) -> float:
    """One-token attention of q (B, H, hd) through a page table over
    pages (P, ps, KVH, hd): the K/V of every attended position, q and o,
    the lengths and the table entries that cover them."""
    (B, H, hd), (_, ps, KVH, _) = call["shapes"][0], call["shapes"][1]
    e, pos = call["dtype_bytes"], call["positions"]
    pages = sum(-(-n // ps) for n in call["lengths_list"])
    return bound_s(4 * pos * H * hd,
                   2 * pos * KVH * hd * e + 2 * B * H * hd * e + 4 * B
                   + 4 * pages, rate_of(e))


def moe_gmm(call) -> float:
    """(E, C, d) @ (E, d, f): the live experts' weights and the filled
    rows of x read once, the filled rows of the output written once,
    2 d f operations a filled row."""
    (E, C, d), (_, _, f) = call["shapes"][0], call["shapes"][1]
    e = call["dtype_bytes"]
    live, rows = call.get("live", E), call.get("rows", E * C)
    return bound_s(2 * rows * d * f, e * (live * d * f + rows * d
                                          + rows * f), rate_of(e))


def roofline(rec, op: str, fn):
    """Sum of the calls' bounds over the device time of their kernels, in
    %, over the traced slice's calls of ``op``; None where none ran."""
    t, calls = rec.get("trace"), rec.get("calls", {}).get(op)
    if not t or not calls or op not in t["ops"]:
        return None
    dev = t["ops"][op]
    if len(dev) != len(calls) or not sum(dev):
        return None
    return 100.0 * sum(fn(c) for c in calls) / sum(dev)
