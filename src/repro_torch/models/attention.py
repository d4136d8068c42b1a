"""GQA projections (``repro.models.attention``).

The attention itself is a kernel here: prefill goes through
``kernels.ops.attention`` (flash) and decode through ``kernels.ops.decode``
or ``kernels.ops.paged_decode``, so this module keeps only the projections
and the KV-head repeat that the prefill kernel's (BH, S, hd) layout needs.
The -1e30 mask value lives with the masking, in ``kernels.ref`` and the
CUDA sources.
"""
from __future__ import annotations

from repro_torch.models.layers import apply_rope, rmsnorm


def qkv_proj(p, cfg, x, positions):
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, KVH, hd), roped
    (and qk-normed where the config says so)."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def repeat_kv(k, n_heads: int):
    """(B, S, KVH, hd) -> (B, S, H, hd)."""
    B, S, KVH, hd = k.shape
    if KVH == n_heads:
        return k
    rep = n_heads // KVH
    return k[:, :, :, None, :].expand(B, S, KVH, rep, hd).reshape(
        B, S, n_heads, hd)
