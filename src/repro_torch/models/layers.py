"""Shared layers: RMSNorm, RoPE, MLP variants (``repro.models.layers``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(scale, x, eps: float = 1e-5):
    """RMSNorm computed in fp32, cast back to x's dtype."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def rope_freqs(head_dim: int, theta: float, device):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """Split-halves RoPE. x: (..., S, H, hd); positions: (..., S) int."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    ang = positions[..., None].float() * freqs          # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mlp_apply(p, x, act: str):
    """The MLP of ``p``'s hidden units. Split by columns (``w_in``,
    ``w_gate``) and rows (``w_out``) over ranks, it returns this rank's
    row-parallel partial, which the caller sums over ``model``."""
    h = x @ p["w_in"]
    if act == "swiglu":
        g = x @ p["w_gate"]
        h = F.silu(g.float()).to(h.dtype) * h
    elif act == "sq_relu":
        h = torch.relu(h).square()
    else:
        raise ValueError(act)
    return h @ p["w_out"]
