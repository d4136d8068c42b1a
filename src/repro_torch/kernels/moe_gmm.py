"""Grouped expert GEMM on the card: ``csrc/moe_gmm.cu``.

Replaces ``repro.kernels.moe_gmm.moe_gmm`` (the Pallas ``_gmm_kernel``).
The plain version is ``kernels.ref.moe_gmm_ref``; ``kernels.ops.gmm``
picks between the two by the tensor's device.
"""
from __future__ import annotations

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPES


def moe_gmm(x, w):
    """x: (E, C, d) dispatched tokens; w: (E, d, f) expert weights.

    Returns (E, C, f) in x's dtype, from fp32 accumulation. CUDA tensors
    only: the kernel runs on the current stream, and a refused launch
    raises. No dim need be a tile multiple.
    """
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
    f = w.shape[2]
    if E > 65535 or -(-C // 32) > 65535:
        raise ValueError(f"moe_gmm: E={E} or C={C} exceeds the grid")
    out = x.new_empty((E, C, f))
    if out.numel() == 0:
        return out
    lib = build.library("moe_gmm")
    build.check(lib.moe_gmm_fwd(
        build.ptr(x), build.ptr(w), build.ptr(out), E, C, d, f,
        DTYPES[x.dtype], build.stream_of(x)), "moe_gmm")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
