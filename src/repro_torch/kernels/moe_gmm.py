"""Grouped expert GEMM on the card: ``csrc/moe_gmm.cu``.

Replaces ``repro.kernels.moe_gmm.moe_gmm`` (the Pallas ``_gmm_kernel``).
The plain version is ``kernels.ref.moe_gmm_ref``; ``kernels.ops.gmm``
picks between the two by the tensor's device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost, rate_of
from repro_torch.kernels.flash_attention import DTYPES

BK = 64                # d per pipeline stage of the bf16 kernel
SPLIT_MAX_C = 10       # split over d only up to this C
SPLIT_MIN_STAGES = 16  # a d range streams at least this many stages


class Plan(NamedTuple):
    c_tile: int     # rows of C per tile (the mma N side in bf16)
    vec: bool       # 16-byte cp.async loads (bf16; d, f multiples of 8)
    splits: int     # d ranges whose fp32 partials a second pass sums


def d_splits(C: int, d: int) -> int:
    """How many d ranges each bf16 product splits into.

    Few work items stream when few experts hold a row, as at a decode
    step (arctic: ~16 of 128 experts); splitting over d gives the card
    more. The host cannot see the counts without a sync, so the rule goes
    by C. chip_smoke.py's phase-5 sweep (PERF.md) timed every C of
    arctic's path with the counts of the call that gives it: at C <= 10
    this split ran within about 3 % of the fastest one timed (at a decode
    step's counts 10-20 % faster than none); at C >= 15, where nearly all
    experts are filled, every split lost 2-13 % to none.
    """
    if C > SPLIT_MAX_C:
        return 1
    return max(1, -(-d // BK) // SPLIT_MIN_STAGES)


def plan(x, w) -> Plan:
    """The kernel instance that ``moe_gmm(x, w)`` launches: the one place
    that chooses it (the C side launches what it is given)."""
    E, C, d = x.shape
    f = w.shape[2]
    if x.dtype == torch.float32:   # exact fp32 FMAs on CUDA cores
        return Plan(next((bc for bc in (1, 2, 4, 8, 16) if C <= bc), 32),
                    False, 1)
    vec = (d % 8 == 0 and f % 8 == 0 and x.data_ptr() % 16 == 0
           and w.data_ptr() % 16 == 0)
    return Plan(8 if C <= 8 else 16 if C <= 16 else 32, vec,
                d_splits(C, d))


def moe_gmm(x, w, counts=None):
    """x: (E, C, d) dispatched tokens; w: (E, d, f) expert weights;
    counts: (E,) int32 filled slots per expert (a prefix of its C rows),
    or None for all C.

    Returns (E, C, f) in x's dtype, from fp32 accumulation; rows at or past
    ``counts[e]`` are exact zero, and an expert with no filled row reads no
    weight. CUDA tensors only: the kernel runs on the current stream, and a
    refused launch raises. No dim need be a tile multiple.
    """
    build.forbid_autograd("moe_gmm", x, w)
    for name, t in (("x", x), ("w", w)):
        if not t.is_cuda:
            raise ValueError(f"moe_gmm: {name} must be a CUDA tensor")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"moe_gmm: {name} must be a contiguous 3-d "
                             f"tensor, got {tuple(t.shape)}")
    if x.dtype not in DTYPES or w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"moe_gmm: x and w must share a device and a dtype "
                         f"in {list(DTYPES)}")
    E, C, d = x.shape
    if w.shape[:2] != (E, d):
        raise ValueError(f"moe_gmm: w {tuple(w.shape)} does not match x "
                         f"{tuple(x.shape)}; want (E, d, f)")
    if counts is not None and (
            counts.device != x.device or counts.dtype != torch.int32
            or counts.shape != (E,) or not counts.is_contiguous()):
        raise ValueError(f"moe_gmm: counts must be a contiguous ({E},) int32 "
                         f"tensor on {x.device}")
    if E > 65535 or -(-C // 32) > 65535:
        raise ValueError(f"moe_gmm: E={E} or C={C} exceeds the grid")
    return launch(x, w, counts, plan(x, w))


def launch(x, w, counts, p: Plan):
    """Launch instance ``p`` on checked arguments: ``moe_gmm`` passes
    ``plan(x, w)``; a timing sweep may pass another split of the same
    C tile and loads."""
    E, C, d = x.shape
    f = w.shape[2]
    out = x.new_empty((E, C, f))
    if out.numel() == 0:
        return out
    part = (torch.empty((p.splits, E, C, f), dtype=torch.float32,
                        device=x.device) if p.splits > 1 else None)
    lib = build.library("moe_gmm")
    build.check(lib.moe_gmm_fwd(
        build.ptr(x), build.ptr(w),
        None if counts is None else build.ptr(counts),
        None if part is None else build.ptr(part), build.ptr(out),
        E, C, d, f, p.c_tile, int(p.vec), p.splits, DTYPES[x.dtype],
        build.stream_of(x)), "moe_gmm")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0


def cost(E: int, C: int, d: int, f: int, dtype, live: int | None = None,
         rows: int | None = None):
    """``kernels.cost.Cost`` of one ``moe_gmm`` call: the ``live``
    experts' weights (those with a filled row; all E by default) and the
    ``rows`` filled rows of x (all E x C by default) read once, the whole
    (E, C, f) output written once; 2 d f operations a filled row. A
    split over d (``plan``; bf16 only) runs a second kernel that sums
    the partials."""
    if E * C * f == 0:
        return Cost(0, 0)
    live = E if live is None else live
    rows = E * C if rows is None else rows
    splits = d_splits(C, d) if dtype == torch.bfloat16 else 1
    elt = dtype.itemsize
    return Cost(1 + (splits > 1),
                elt * (live * d * f + rows * d + E * C * f),
                ((2 * rows * d * f, rate_of(dtype)),))


def meta(x, w):
    """The output of ``moe_gmm(x, w)`` as a meta tensor."""
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))
