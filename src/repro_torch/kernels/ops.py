"""Dispatch: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor, the kernel's shapes for a meta tensor, an error for anything
else.

The choice follows only from the device of the tensor passed in. A CUDA
tensor always goes to the hand-written kernel; if the kernel cannot be
built or launched, the error propagates (no fallback to the plain
version). A meta tensor (the dry run, ``launch.dryrun``) gets empty meta
outputs of the kernel's shapes and dtypes from the shape function beside
its wrapper, and computes nothing. Serving calls these five functions
and nothing else of ``kernels``; the training route calls none of them
(the kernels are forward-only, and their wrappers raise under autograd).

Every call, on any device, is reported to the observers that
``observed`` installs, as a call of its kernel with the kernel's
``cost`` at the call's shapes (``kernels.cost.Cost``): the dry run's
record, and the same record of a real run that the tests hold it to.
``launch_counts`` counts the card's launches only.
"""
from __future__ import annotations

import contextlib

from repro_torch.kernels import (
    decode_attention as da, flash_attention as fa, moe_gmm as mg,
    paged_decode_attention as pda, ssd_scan as ss)
from repro_torch.kernels.ref import (
    decode_attention_ref, flash_attention_ref, moe_gmm_ref,
    paged_decode_attention_ref, ssd_scan_ref,
)

KERNELS = (fa.flash_attention, da.decode_attention,
           pda.paged_decode_attention, mg.moe_gmm, ss.ssd_scan)

_observers: list = []


@contextlib.contextmanager
def observed(fn):
    """Within the block, call ``fn(op, kernel, cost)`` at every call of
    this module's functions: ``op`` the function's name, ``kernel`` the
    name of the kernel it stands for, ``cost`` that kernel's
    ``kernels.cost.Cost`` at the call's shapes."""
    _observers.append(fn)
    try:
        yield fn
    finally:
        _observers.remove(fn)


def _route(t, what: str, kernel, cost) -> str:
    """"cuda", "cpu" or "meta", by ``t``'s device; reports the call."""
    kind = t.device.type
    if kind not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{what}: no kernel or plain version for device "
                         f"{t.device}")
    if _observers:
        c = cost()
        for fn in _observers:
            fn(what, kernel.__name__, c)
    return kind


def attention(q, k, v, *, causal: bool = True):
    """(BH, S, hd) prefill attention, KV heads already repeated."""
    BH, S, hd = q.shape
    route = _route(q, "attention", fa.flash_attention, lambda: fa.cost(
        BH, S, k.shape[1], hd, q.dtype, causal))
    if route == "cuda":
        return fa.flash_attention(q, k, v, causal=causal)
    if route == "meta":
        return fa.meta(q)
    return flash_attention_ref(q, k, v, causal=causal)


def decode(q, k_cache, v_cache, lengths, *, block_s: int):
    """(B, H, hd) one-token attention over (B, S, KVH, hd) caches. The
    reported cost counts every cache position (the lengths are data)."""
    B, S, KVH, hd = k_cache.shape
    route = _route(q, "decode", da.decode_attention, lambda: da.cost(
        B, q.shape[1], KVH, hd, B * S, q.dtype))
    if route == "cuda":
        return da.decode_attention(q, k_cache, v_cache, lengths,
                                   block_s=block_s)
    if route == "meta":
        return da.meta(q)
    return decode_attention_ref(q, k_cache, v_cache, lengths)


def paged_decode(q, k_pages, v_pages, page_table, lengths):
    """(B, H, hd) one-token attention through a (B, n) page table. The
    reported cost counts every position the table addresses."""
    B, n = page_table.shape
    ps, KVH, hd = k_pages.shape[1:]
    route = _route(q, "paged_decode", pda.paged_decode_attention,
                   lambda: da.cost(B, q.shape[1], KVH, hd, B * n * ps,
                                   q.dtype, table=B * n))
    if route == "cuda":
        return pda.paged_decode_attention(q, k_pages, v_pages, page_table,
                                          lengths)
    if route == "meta":
        return pda.meta(q)
    return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                      lengths)


def gmm(x, w, counts=None):
    """(E, C, d) @ (E, d, f) -> (E, C, f) grouped expert GEMM; rows at or
    past ``counts[e]`` (an (E,) int32 tensor, or None: all filled) are
    zero. The reported cost counts every row filled (the counts are
    data)."""
    E, C, d = x.shape
    route = _route(x, "gmm", mg.moe_gmm, lambda: mg.cost(
        E, C, d, w.shape[2], x.dtype))
    if route == "cuda":
        return mg.moe_gmm(x, w, counts)
    if route == "meta":
        return mg.meta(x, w)
    return moe_gmm_ref(x, w, counts)


def ssd(x, dt, A, Bg, Cg, *, chunk: int):
    """Mamba2 chunked SSD scan from a zero state: (y fp32, state fp32)."""
    route = _route(x, "ssd", ss.ssd_scan, lambda: ss.cost(
        *x.shape, *Bg.shape[2:], chunk, x.dtype))
    if route == "cuda":
        return ss.ssd_scan(x, dt, A, Bg, Cg, chunk=chunk)
    if route == "meta":
        return ss.meta(x, Bg)
    return ssd_scan_ref(x, dt, A, Bg, Cg, chunk=chunk)


def launch_counts() -> dict[str, int]:
    """Kernel launches on the card since the last reset, by kernel
    name."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
