"""One-token decode attention over a contiguous KV cache, on the card.

Replaces ``repro.kernels.decode_attention.decode_attention`` (the Pallas
``_decode_kernel``) with ``csrc/decode_attention.cu``: one launch of split
blocks along the sequence, the last split of each (row, KV head) merging
the row's splits. The plain version is
``kernels.ref.decode_attention_ref``; ``kernels.ops.decode`` picks between
the two by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES, HEAD_DIMS

MAX_GROUP = 8   # query heads per KV head the kernel holds

# (device, stream) -> (counters, partials): see ``scratch``
_SCRATCH: dict = {}


def scratch_sizes(B: int, KVH: int, n_split: int, G: int,
                  hd: int) -> tuple[int, int]:
    """(counters, fp32 partial floats) one call needs: a counter per (row,
    KV head), and an (m, l, acc[hd]) partial per split and query head."""
    return B * KVH, B * KVH * n_split * G * (hd + 2)


def scratch(device, stream: int, n_count: int, n_part: int):
    """The persistent (counters int32, partials fp32) of one device and
    stream, at least ``n_count`` and ``n_part`` long.

    Allocated once and grown to the next power of two when a call needs
    more, on the stream that uses it. The kernel leaves every counter at
    zero (the merging block resets its own), so the next launch on the
    same stream, which runs after it, finds them zero; a partial is read
    only by a later block of the launch that wrote it. Each stream has its
    own pair, so launches that may overlap never share a counter.
    """
    key = (str(device), stream)
    have = _SCRATCH.get(key)
    if have is None or have[0].numel() < n_count or have[1].numel() < n_part:
        old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.zeros(_pow2(max(n_count, old[0])), dtype=torch.int32,
                            device=device),
                torch.empty(_pow2(max(n_part, old[1])), dtype=torch.float32,
                            device=device))
        _SCRATCH[key] = have
    return have


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def check_decode_args(q, k, v, lengths, what: str):
    """Validate the shared decode contract; returns (B, H, KVH, hd, G)."""
    for name, t in (("q", q), ("k", k), ("v", v), ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"{what}: {name} must be a CUDA tensor on "
                             f"q's device")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be (B, H, hd) and "
                         f"k, v one 4-d shape, got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, hd = q.shape
    KVH = k.shape[2]
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{what}: q, k, v must share a dtype in "
                         f"{list(DTYPES)}")
    if k.shape[3] != hd or hd not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {hd} (cache {k.shape[3]}) not "
                         f"in {HEAD_DIMS}")
    if KVH < 1 or H % KVH or H // KVH > MAX_GROUP:
        raise ValueError(f"{what}: H={H} must be a multiple of KVH={KVH} "
                         f"with at most {MAX_GROUP} query heads per KV head")
    if lengths.dtype != torch.int32 or lengths.shape != (B,):
        raise ValueError(f"{what}: lengths must be int32 of shape ({B},)")
    if B > 65535 or KVH > 65535:
        raise ValueError(f"{what}: B={B} or KVH={KVH} exceeds the grid")
    return B, H, KVH, hd, H // KVH


def decode_attention(q, k_cache, v_cache, lengths, *, block_s: int = 512):
    """q: (B, H, hd); caches: (B, S, KVH, hd); lengths: (B,) int32 fill.

    Returns (B, H, hd) in q's dtype. ``block_s`` is the number of cache
    positions each split block sweeps. Lengths are clamped to [0, S];
    rows with length 0 return exact zeros.
    """
    build.forbid_autograd("decode_attention", q, k_cache, v_cache)
    B, H, KVH, hd, G = check_decode_args(q, k_cache, v_cache, lengths,
                                         "decode_attention")
    S = k_cache.shape[1]
    if k_cache.shape[0] != B or S < 1 or block_s < 1:
        raise ValueError(f"decode_attention: cache {tuple(k_cache.shape)} "
                         f"must be (B={B}, S>=1, KVH, hd); block_s >= 1")
    o = torch.empty_like(q)
    if B == 0:
        return o
    stream = build.stream_of(q)
    count, part = scratch(q.device, stream.value,
                          *scratch_sizes(B, KVH, -(-S // block_s), G, hd))
    lib = build.library("decode_attention")
    build.check(lib.decode_attention_fwd(
        build.ptr(q), build.ptr(k_cache), build.ptr(v_cache),
        build.ptr(lengths), build.ptr(o), build.ptr(part), build.ptr(count),
        B, H, KVH, hd, S, block_s, DTYPES[q.dtype], stream),
        "decode_attention")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
