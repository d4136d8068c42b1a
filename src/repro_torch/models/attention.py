"""GQA projections and the training route's chunked attention
(``repro.models.attention``).

Serving attends through kernels: prefill through ``kernels.ops.attention``
(flash, by way of ``prefill_attention``) and decode through
``kernels.ops.decode`` or ``kernels.ops.paged_decode``. Those kernels are
forward-only, so training
attends through ``chunked_attention``, the reference's memory-efficient
softmax over (q chunk, kv chunk) blocks as plain tensor ops that autograd
differentiates: the same chunks, the same padding of ragged lengths, the
same -1e30 mask and fp32 accumulation.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, rmsnorm

NEG_INF = -1e30


def qkv_proj(p, cfg, x, positions, heads=None, join=None):
    """x: (B, S, d) -> q (B, S, H, hd), k/v (B, S, KVH, hd), roped
    (and qk-normed where the config says so). ``heads``: (H, KVH), the
    rank's head counts under tensor parallelism (``parallel.tensor``),
    whose weights hold those heads' columns; the config's by default. The
    norms are per ``head_dim`` and RoPE per head, so a rank applies them
    to its heads alone. ``join``: None, or ``(q, k, v) -> (q, k, v)``
    applied to the products (biases added) before the heads are formed:
    tensor parallelism's column path joins the ranks' column slices,
    which may end mid-head, into whole q, k, v
    (``TensorParallel.join_qkv``)."""
    B, S, _ = x.shape
    H, KVH = heads or (cfg.n_heads, cfg.n_kv_heads)
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    if join is not None:
        q, k, v = join(q, k, v)
    q = q.reshape(B, S, H, cfg.head_dim)
    k = k.reshape(B, S, KVH, cfg.head_dim)
    v = v.reshape(B, S, KVH, cfg.head_dim)
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


def prefill_attention(q, k, v):
    """Causal q (B, S, H, hd), k/v (B, S, KVH, hd) -> (B, S, H, hd)
    through ``kernels.ops.attention`` on heads-major (B*H, S, hd), KV
    heads repeated."""
    B, S, H, hd = q.shape

    def heads_major(t):               # (B, S, H, hd) -> (B*H, S, hd)
        # contiguous: at B == 1 the reshape is a strided view, which the
        # kernel refuses
        return t.transpose(1, 2).reshape(B * H, S, hd).contiguous()

    o = ops.attention(heads_major(q), heads_major(repeat_kv(k, H)),
                      heads_major(repeat_kv(v, H)), causal=True)
    return o.reshape(B, H, S, hd).transpose(1, 2)


def _block_attn(qb, kb, vb, mask, scale):
    """One (Bq x Bk) block of heads-major (B, H, n, hd) slices: returns
    (o_acc, m, l) in fp32. The scores are computed in the inputs' dtype
    and the probabilities rounded to v's dtype for the PV product, as the
    reference does. ``mask`` None: every pair of the block is visible."""
    s = torch.matmul(qb, kb.transpose(-1, -2)).float() * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)                                       # (B, H, Q)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)                                        # (B, H, Q)
    o = torch.matmul(p.to(vb.dtype), vb).float()             # (B, H, Q, hd)
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1[..., None] + o2 * a2[..., None]
    l = l1 * a1 + l2 * a2
    return o, m, l


def chunked_attention(q, k, v, *, causal=True, q_chunk=512, kv_chunk=1024,
                      impl="masked"):
    """q, k, v: (B, S, H, hd), KV heads already repeated -> (B, S, H, hd)
    in q's dtype. Never holds more than one (q_chunk x kv_chunk) block of
    scores per query chunk live in the forward.

    Each query chunk merges its key chunks in order into an online
    softmax. ``impl="masked"`` (the reference's full pair grid) and
    ``"triangular"`` (its lower-triangular pair list) compute the same
    values here, because a block whose every pair is masked is skipped:
    in the reference it enters the merge with weight exp(-1e30 - m) = 0
    and leaves (o, m, l) exactly as they were. Likewise the first block a
    chunk visits starts its accumulator (the merge with the empty one is
    exact), and a block without a masked pair skips the ``where``.
    """
    if impl not in ("masked", "triangular"):
        raise ValueError(f"attn_impl {impl!r}: 'masked' or 'triangular'")
    B, S, H, hd = q.shape
    Sk = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, Sk)
    # pad ragged sequences up to chunk multiples; pads are masked below
    S_real, Sk_real = S, Sk
    pad_q, pad_k = (-S) % q_chunk, (-Sk) % kv_chunk
    # heads-major once, so every block is a slice that matmul reads as is
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))      # (B, H, n, hd)
    if pad_q:
        qh = F.pad(qh, (0, 0, 0, pad_q))
    if pad_k:
        kh, vh = (F.pad(t, (0, 0, 0, pad_k)) for t in (kh, vh))
    qh, kh, vh = (t.contiguous() for t in (qh, kh, vh))
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    outs = []
    for q0 in range(0, S_real + pad_q, q_chunk):
        q1 = q0 + q_chunk
        acc = None
        for k0 in range(0, Sk_real, kv_chunk):
            k1 = k0 + kv_chunk
            if causal and k0 > q1 - 1:
                break          # this and later key chunks: every pair masked
            mask = None
            if (causal and k1 - 1 > q0) or k1 > Sk_real:
                kpos = torch.arange(k0, k1, device=dev)
                mask = (kpos < Sk_real)[None, :]
                if causal:
                    qpos = torch.arange(q0, q1, device=dev)
                    mask = mask & (qpos[:, None] >= kpos[None, :])
            blk = _block_attn(qh[:, :, q0:q1], kh[:, :, k0:k1],
                              vh[:, :, k0:k1], mask, scale)
            acc = blk if acc is None else _merge(*acc, *blk)
        o, _, l = acc
        outs.append((o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=2).transpose(1, 2)             # (B, S, H, hd)
    return out[:, :S_real] if pad_q else out
