"""Prefill attention on the card: ``csrc/flash_attention.cu``.

Replaces ``repro.kernels.flash_attention.flash_attention`` (the Pallas
``_flash_kernel``). The plain version is ``kernels.ref.flash_attention_ref``;
``kernels.ops.attention`` picks between the two by the tensor's device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 112, 128)   # 112: kimi-k2's 7168 / 64


def flash_attention(q, k, v, *, causal: bool = True):
    """q: (BH, S, hd); k, v: (BH, Sk, hd), KV heads already repeated.

    Returns (BH, S, hd) in q's dtype. CUDA tensors only: the kernel runs
    on the current stream, and a refused launch raises.
    """
    build.forbid_autograd("flash_attention", q, k, v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} must be a CUDA tensor")
        if t.dim() != 3 or not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"(BH, S, hd) tensor, got {tuple(t.shape)}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention: q, k, v differ in dtype or "
                             "device")
    BH, S, hd = q.shape
    Sk = k.shape[1]
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention: dtype {q.dtype} not supported")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if k.shape != (BH, Sk, hd) or v.shape != k.shape or Sk < 1:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if BH > 65535:
        raise ValueError(f"flash_attention: BH {BH} exceeds the grid's 65535")
    o = torch.empty_like(q)
    if BH == 0 or S == 0:
        return o
    lib = build.library("flash_attention")
    build.check(lib.flash_attention_fwd(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o), BH, S, Sk,
        hd, int(causal), DTYPES[q.dtype], build.stream_of(q)),
        "flash_attention")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
