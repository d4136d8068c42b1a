"""Dispatch: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor, an error for anything else.

The choice follows only from the device of the tensor passed in. A CUDA
tensor always goes to the hand-written kernel; if the kernel cannot be
built or launched, the error propagates (no fallback to the plain
version). Serving calls these five functions and nothing else of
``kernels``; the training route calls none of them (the kernels are
forward-only, and their wrappers raise under autograd).
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.kernels.paged_decode_attention import paged_decode_attention
from repro_torch.kernels.ref import (
    decode_attention_ref, flash_attention_ref, moe_gmm_ref,
    paged_decode_attention_ref, ssd_scan_ref,
)
from repro_torch.kernels.ssd_scan import ssd_scan

KERNELS = (flash_attention, decode_attention, paged_decode_attention, moe_gmm,
           ssd_scan)


def _on_cuda(t, what: str) -> bool:
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no kernel or plain version for device "
                         f"{t.device}")
    return False


def attention(q, k, v, *, causal: bool = True):
    """(BH, S, hd) prefill attention, KV heads already repeated."""
    if _on_cuda(q, "attention"):
        return flash_attention(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def decode(q, k_cache, v_cache, lengths, *, block_s: int):
    """(B, H, hd) one-token attention over (B, S, KVH, hd) caches."""
    if _on_cuda(q, "decode"):
        return decode_attention(q, k_cache, v_cache, lengths, block_s=block_s)
    return decode_attention_ref(q, k_cache, v_cache, lengths)


def paged_decode(q, k_pages, v_pages, page_table, lengths):
    """(B, H, hd) one-token attention through a (B, n) page table."""
    if _on_cuda(q, "paged_decode"):
        return paged_decode_attention(q, k_pages, v_pages, page_table,
                                      lengths)
    return paged_decode_attention_ref(q, k_pages, v_pages, page_table,
                                      lengths)


def gmm(x, w, counts=None):
    """(E, C, d) @ (E, d, f) -> (E, C, f) grouped expert GEMM; rows at or
    past ``counts[e]`` (an (E,) int32 tensor, or None: all filled) are
    zero."""
    if _on_cuda(x, "gmm"):
        return moe_gmm(x, w, counts)
    return moe_gmm_ref(x, w, counts)


def ssd(x, dt, A, Bg, Cg, *, chunk: int):
    """Mamba2 chunked SSD scan from a zero state: (y fp32, state fp32)."""
    if _on_cuda(x, "ssd"):
        return ssd_scan(x, dt, A, Bg, Cg, chunk=chunk)
    return ssd_scan_ref(x, dt, A, Bg, Cg, chunk=chunk)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel name."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
