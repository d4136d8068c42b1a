"""Block assembly: attention or Mamba2, then a dense MLP or an MoE layer
(``repro.models.blocks``).

Attention runs through the kernels: prefill through the flash kernel on
(B*H, S, hd) with KV heads repeated, decode through the contiguous or the
paged decode kernel, which read the cache where it lies. The new token's
K/V are written into the cache in place (``index_put_``), where the JAX
package returns an updated copy that jit donates. Mamba2 layers run
``models.ssm`` (the ``ssd_scan`` kernel at prefill) and MoE layers
``models.moe`` (the ``moe_gmm`` kernel).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import qkv_proj, repeat_kv
from repro_torch.models.layers import mlp_apply, rmsnorm
from repro_torch.models.moe import moe_apply, route
from repro_torch.models.ssm import mamba_apply

# Cache positions each split of the contiguous decode kernel sweeps. A
# paged engine whose page_size equals it decodes bit-identically to the
# contiguous engine.
DECODE_BLOCK_S = 128


def attn_block(p, cfg, x, positions, *, cache=None, lengths=None,
               page_table=None, full=None, block_s: int = DECODE_BLOCK_S):
    """Returns (out (B, S, d), cache).

    Prefill (``cache is None``) returns this layer's (k, v), each
    (B, S, KVH, hd). Decode (S == 1) takes the layer's cache (k, v) —
    (B, S_max, KVH, hd), or a page pool (n_pages, page_size, KVH, hd) with
    ``page_table`` (B, pages_per_row) int32 — writes the new token at
    ``lengths`` in place and attends over ``lengths + 1`` positions.
    ``lengths`` is int32 on the cache's device. ``full`` is None, or a
    (B,) bool tensor marking the rows whose length already equals their
    capacity (the cache depth, or their table's pages): such a row writes
    nothing and attends over its full cache, as the JAX contiguous path
    does when its scatter drops the out-of-range write. ``block_s`` is the
    cache positions each split of the contiguous decode kernel sweeps.
    """
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, cfg, x, positions)
    if cache is None:
        H, hd = cfg.n_heads, cfg.head_dim

        def heads_major(t):               # (B, S, H, hd) -> (B*H, S, hd)
            # contiguous: at B == 1 the reshape is a strided view, which
            # the kernel refuses
            return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()

        o = ops.attention(heads_major(q), heads_major(repeat_kv(k, H)),
                          heads_major(repeat_kv(v, H)), causal=True)
        o = o.reshape(B, H, S, hd).transpose(1, 2)
        new_cache = (k, v)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        k_cache, v_cache = cache
        rows = torch.arange(B, device=x.device)
        pos = at = lengths.long()
        if full is not None:
            # a full row (pos == capacity) rewrites the value its last
            # position holds: no out-of-range index is formed
            at = pos - full.long()
        if page_table is not None:
            ps = k_cache.shape[1]
            idx = (page_table.long()[rows, at // ps], at % ps)
        else:
            idx = (rows, at)
        for dst, new in ((k_cache, k[:, 0]), (v_cache, v[:, 0])):
            dst[idx] = (new if full is None
                        else torch.where(full[:, None, None], dst[idx], new))
        if page_table is not None:
            o = ops.paged_decode(q[:, 0], k_cache, v_cache, page_table,
                                 lengths + 1)
        else:
            o = ops.decode(q[:, 0], k_cache, v_cache, lengths + 1,
                           block_s=block_s)
        o = o[:, None]
        new_cache = cache
    out = o.reshape(B, S, cfg.q_dim) @ p["wo"]
    return out, new_cache


def block_apply(p, cfg, x, positions, i: int, *, cache=None, lengths=None,
                page_table=None, full=None, block_s: int = DECODE_BLOCK_S):
    """One pre-norm block at pattern position ``i``: attention or Mamba2,
    then the MoE layer (with the dense residual or shared MLP where the
    config has one) or the dense MLP. Returns (x, cache).

    ``cache`` is the layer's: (k, v) for attention, (conv tails, state)
    for Mamba2; ``lengths``, ``page_table``, ``full`` and ``block_s``
    concern attention only.
    """
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.block_kind(i) == "attn":
        out, new_cache = attn_block(p["attn"], cfg, h, positions, cache=cache,
                                    lengths=lengths, page_table=page_table,
                                    full=full, block_s=block_s)
    else:
        out, new_cache = mamba_apply(p["mamba"], cfg, h, cache=cache)
    x = x + out
    if cfg.is_moe_layer(i):
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        ids, wts, _ = route(p["moe"], cfg, h)
        y = moe_apply(p["moe"], cfg, h, ids, wts)
        if cfg.dense_residual and cfg.d_ff > 0:
            y = y + mlp_apply(p["dense_mlp"], h, cfg.mlp_act)
        if cfg.n_shared_experts > 0:
            y = y + mlp_apply(p["shared_mlp"], h, cfg.mlp_act)
        x = x + y
    elif cfg.d_ff > 0:
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_act)
    return x, new_cache
