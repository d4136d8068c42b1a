"""Block assembly: attention or Mamba2, then a dense MLP or an MoE layer
(``repro.models.blocks``).

Attention runs through the kernels: prefill through the flash kernel on
(B*H, S, hd) with KV heads repeated, decode through the contiguous or the
paged decode kernel, which read the cache where it lies. The new token's
K/V are written into the cache in place (``index_put_``), where the JAX
package returns an updated copy that jit donates. Mamba2 layers run
``models.ssm`` (the ``ssd_scan`` kernel at prefill) and MoE layers
``models.moe`` (the ``moe_gmm`` kernel).

Under a mesh (``Runtime.mesh``) the layers run tensor-parallel over
the mesh's ``model`` axis as ``Runtime.tensor`` splits them
(``parallel.tensor``). Where attention's leaves are cut by whole heads
(``attn``: the KV heads divide and the decode cache splits by heads) a
rank attends with its heads through the same kernels (flash on
(B*H/n, S, hd), decode over its KVH/n cache heads, the same G).
Elsewhere they are cut by columns, as the reference stores them, and a
rank's projections are gathered into whole q, k, v (the column path):
prefill splits by heads padded to a multiple of n, a rank's Hp/n
through the flash kernel (``padded_head_attention``), unless
``attn_seq_parallel`` runs the reference's ``ring_attention``; decode
attends whole over caches of every KV head, or with ``decode_kv_shard``
"seq" over each rank's slice of the positions
(``seq_sharded_decode_attention``). A rank runs its share of each MLP's
hidden units and of Mamba2's heads, and each row-parallel product
(``wo`` on the rank's heads or columns of the output, an MLP's
``w_out``, Mamba2's ``w_out``) is summed over ``model``. MoE layers
route on the logits of the rank's router columns, gathered whole, and
run expert-parallel (``moe_apply``); the dense residual's or the shared
experts' partial joins the experts' before their one reduction.
Every layer, the ring, the sequence-sharded decode and the MoE layer
included, takes and returns the rank's rows of the batch
(``models.lm.Runtime.rows``); only the MoE layer's capacity reads the
group that holds the other rows (``data``).

Training runs ``block_train``: the same blocks over the whole sequence
with no cache, through plain tensor ops only (``chunked_attention``,
``ssd_chunked``, ``moe_train``), since the kernels are forward-only, on
one rank or split over ``model`` as serving splits them.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.attention import (
    chunked_attention, prefill_attention, qkv_proj, repeat_kv)
from repro_torch.models.layers import mlp_apply, rmsnorm
from repro_torch.models.moe import moe_apply, moe_train, route
from repro_torch.models.ssm import mamba_apply
from repro_torch.parallel.collectives import (
    ring_attention, seq_sharded_decode_attention)
from repro_torch.parallel.tensor import WHOLE

# Cache positions each split of the contiguous decode kernel sweeps. A
# paged engine whose page_size equals it decodes bit-identically to the
# contiguous engine.
DECODE_BLOCK_S = 128


def attn_block(p, cfg, x, positions, *, rt=None, cache=None, lengths=None,
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

    ``rt`` (``models.lm.Runtime``, None for one rank): with a mesh and
    ``attn_seq_parallel``, prefill attends through ``ring_attention``;
    with ``rt.decode_kv_shard(cfg) == "seq"`` the cache is this rank's
    slice of the positions and decode runs
    ``seq_sharded_decode_attention``, whose insert rule leaves a full
    row's cache as it is (``full`` is not needed there). Where
    ``rt.tensor(cfg)`` splits attention by whole heads, q, k, v and the
    cache hold the rank's heads; on the column path they are whole, and
    prefill without the ring attends by padded heads
    (``padded_head_attention``). Where ``wo``'s rows are cut the output is
    the sum over ``model`` of the ranks' partials (``out_proj``).
    """
    B, S, _ = x.shape
    tp = rt.tensor(cfg) if rt is not None else WHOLE
    q, k, v = qkv_proj(p, cfg, x, positions,
                       (tp.heads(cfg), tp.kv_heads(cfg)),
                       join=tp.join_qkv if tp.columns else None)
    mesh = rt.mesh if rt is not None else None
    if cache is None:
        if mesh is not None and rt.parallel.attn_seq_parallel:
            o = ring_attention(q, k, v, mesh)
        elif tp.columns:
            o = padded_head_attention(q, k, v, cfg, tp, prefill_attention)
        else:
            o = prefill_attention(q, k, v)
        new_cache = (k, v)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        k_cache, v_cache = cache
        if (rt is not None and page_table is None
                and rt.decode_kv_shard(cfg) == "seq"):
            o, _, _ = seq_sharded_decode_attention(
                q[:, 0], k_cache, v_cache, lengths, k[:, 0], v[:, 0], mesh)
        else:
            o = _decode_attention(q[:, 0], k[:, 0], v[:, 0], k_cache,
                                  v_cache, lengths, page_table, full,
                                  block_s)
        o = o[:, None]
        new_cache = cache
    return out_proj(p, cfg, o.reshape(B, S, -1), tp), new_cache


def padded_head_attention(q, k, v, cfg, tp, attend):
    """Causal attention of whole q (B, S, H, hd) and k/v (B, S, KVH, hd),
    split over ``model`` by heads padded to a multiple of its n ranks, as
    the reference's prefill splits it (``padded_heads``, ``shard_heads``):
    k and v repeated to H heads, and this rank's Hp / n heads
    (``TensorParallel.padded_heads``) of q, k, v, zero past H, through
    ``attend(q, k, v)`` (each (B, S, Hp / n, hd)). A rank whose heads are
    all padding attends over zeros and joins the gather all the same. The
    ranks' outputs are joined by heads and the padding sliced off: (B, S,
    H, hd), whole on every rank (under autograd each rank's gradient is
    its heads' part of the sum over ``model``, ``TensorParallel.join``)."""
    H = cfg.n_heads
    lo, hi = tp.padded_heads(cfg)

    def mine(t):
        t = repeat_kv(t, H)[:, :, lo:hi]
        pad = hi - lo - t.shape[2]
        return F.pad(t, (0, 0, 0, pad)) if pad else t

    o = attend(mine(q), mine(k), mine(v))
    return tp.join(o, 2)[:, :, :H]


def out_proj(p, cfg, o, tp=WHOLE):
    """Attention's output o (B, S, heads x hd) through ``wo``. Where
    ``wo``'s rows are cut over ``model`` (``tp.attn_cut``) the ranks'
    products are summed: a rank multiplies its heads' o (``tp.attn``), or
    its q_dim / n columns of the whole o (the column path), by its rows."""
    if not tp.attn_cut:
        return o @ p["wo"]
    if not tp.attn:
        lo, hi = tp.part(cfg.q_dim)
        o = o[..., lo:hi]
    return tp.reduce(o @ p["wo"])


def _decode_attention(q, k, v, k_cache, v_cache, lengths, page_table, full,
                      block_s):
    """One rank's whole cache: write each row's k/v (B, KVH, hd) in place
    and attend q (B, H, hd) through the contiguous or the paged decode
    kernel."""
    B = q.shape[0]
    rows = torch.arange(B, device=q.device)
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
    for dst, new in ((k_cache, k), (v_cache, v)):
        dst[idx] = (new if full is None
                    else torch.where(full[:, None, None], dst[idx], new))
    if page_table is not None:
        return ops.paged_decode(q, k_cache, v_cache, page_table, lengths + 1)
    return ops.decode(q, k_cache, v_cache, lengths + 1, block_s=block_s)


def block_apply(p, cfg, x, positions, i: int, *, rt=None, cache=None,
                lengths=None, page_table=None, full=None, data=None,
                block_s: int = DECODE_BLOCK_S):
    """One pre-norm block at pattern position ``i``: attention or Mamba2,
    then the MoE layer (with the dense residual or shared MLP where the
    config has one) or the dense MLP. Returns (x, cache).

    ``cache`` is the layer's: (k, v) for attention, (conv tails, state)
    for Mamba2; ``lengths``, ``page_table``, ``full`` and ``block_s``
    concern attention only. ``rt``: the runtime (``attn_block``; its mesh
    also runs the MoE layer expert-parallel, and ``rt.tensor(cfg)`` splits
    the Mamba2 heads and the MLPs). ``data``: the group over the batch
    axes when x holds this rank's rows of a split batch, else None
    (``moe_apply``).
    """
    tp = rt.tensor(cfg) if rt is not None else WHOLE
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.block_kind(i) == "attn":
        out, new_cache = attn_block(p["attn"], cfg, h, positions, rt=rt,
                                    cache=cache, lengths=lengths,
                                    page_table=page_table, full=full,
                                    block_s=block_s)
    else:
        out, new_cache = mamba_apply(p["mamba"], cfg, h, cache=cache, tp=tp)
    mesh = rt.mesh if rt is not None else None
    x, _ = _ffn(p, cfg, x + out, i,
                lambda *a, **kw: moe_apply(*a, mesh=mesh, data=data, **kw),
                tp)
    return x, new_cache


def _ffn(p, cfg, x, i: int, moe_fn, tp=WHOLE, data=None):
    """The block's second half: the MoE layer through ``moe_fn`` (with
    the dense residual or shared MLP where the config has one), the dense
    MLP, or nothing. Returns (x, aux losses: the router's, or {}).

    An MLP that ``tp`` splits returns this rank's partial: the dense MLP's
    is summed over ``model`` here; on an MoE layer the dense residual's
    and the shared experts' go to ``moe_fn`` as ``partial``, which adds
    them to the rank's expert outputs before its one reduction. A whole
    MLP adds in after, in the order one rank adds them."""
    aux = {}
    if cfg.is_moe_layer(i):
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        ids, wts, aux = route(p["moe"], cfg, h, data, tp)
        widths = {}
        if cfg.dense_residual and cfg.d_ff > 0:
            widths["dense_mlp"] = cfg.d_ff
        if cfg.n_shared_experts > 0:
            widths["shared_mlp"] = cfg.n_shared_experts * cfg.d_ff_expert
        partial = None
        for key, width in widths.items():
            if tp.mlp(width):
                out = mlp_apply(p[key], tp.enter(h), cfg.mlp_act)
                partial = out if partial is None else partial + out
        y = (moe_fn(p["moe"], cfg, h, ids, wts) if partial is None
             else moe_fn(p["moe"], cfg, h, ids, wts, partial=partial))
        for key, width in widths.items():
            if not tp.mlp(width):
                y = y + mlp_apply(p[key], h, cfg.mlp_act)
        x = x + y
    elif cfg.d_ff > 0:
        h = rmsnorm(p["norm2"], x, cfg.norm_eps)
        if tp.mlp(cfg.d_ff):
            x = x + tp.reduce(mlp_apply(p["mlp"], tp.enter(h), cfg.mlp_act))
        else:
            x = x + mlp_apply(p["mlp"], h, cfg.mlp_act)
    return x, aux


def block_train(p, cfg, parallel, x, positions, i: int, data=None,
                tp=WHOLE):
    """The training route of block ``i`` over whole sequences, no cache:
    attention through ``chunked_attention`` with the KV heads repeated
    (chunks and ``impl`` from ``parallel``), Mamba2 through
    ``ssd_chunked``, MoE through ``moe_train``. Returns (x, aux losses).
    ``data``: the group of the ranks that hold the batch's other rows, or
    None (``models.lm.LM.loss``); only the MoE layer reads it.

    ``tp``: this rank's split over ``model`` (``parallel.tensor``), as
    ``block_apply`` splits a layer when serving: a rank attends with its
    heads, or on the column path with its padded heads of the joined q,
    k, v (``padded_head_attention``, with or without the ring, which
    training does not run), runs its MLP columns, Mamba2 heads and
    experts, routes on its router columns, and the row-parallel products
    sum over ``model``; what enters the split passes through
    ``TensorParallel.enter``, so every gradient is whole or the rank's
    slice."""
    h = rmsnorm(p["norm1"], x, cfg.norm_eps)
    if cfg.block_kind(i) == "attn":
        B, S, _ = h.shape
        pa, H = p["attn"], tp.heads(cfg)
        if tp.attn_cut:
            h = tp.enter(h)
            if cfg.qk_norm:   # whole scales, read by this rank's heads
                pa = dict(pa, q_norm=tp.enter(pa["q_norm"]),
                          k_norm=tp.enter(pa["k_norm"]))
        q, k, v = qkv_proj(pa, cfg, h, positions, (H, tp.kv_heads(cfg)),
                           join=tp.join_qkv if tp.columns else None)

        def attend(q, k, v):
            return chunked_attention(
                q, repeat_kv(k, q.shape[2]), repeat_kv(v, q.shape[2]),
                causal=True, q_chunk=parallel.attn_q_chunk,
                kv_chunk=parallel.attn_kv_chunk, impl=parallel.attn_impl)

        o = (padded_head_attention(q, k, v, cfg, tp, attend) if tp.columns
             else attend(q, k, v))
        out = out_proj(pa, cfg, o.reshape(B, S, -1), tp)
    else:
        out, _ = mamba_apply(p["mamba"], cfg, h, train=True, tp=tp)
    return _ffn(p, cfg, x + out, i,
                functools.partial(moe_train, data=data, tp=tp), tp, data)
