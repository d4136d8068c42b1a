"""Plain PyTorch versions of the port's attention kernels.

Each function computes what its hand-written Hopper kernel computes, with
fp32 arithmetic inside and the result cast to the query's dtype, on any
device. ``kernels/ops.py`` sends CPU tensors here; ``chip_smoke.py`` holds
each CUDA kernel against these on the card. They materialize the full
score matrix (and, for paged decode, a gathered copy of each row's pages):
they are references, never the card's path.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True):
    """q: (BH, S, hd); k, v: (BH, Sk, hd), KV heads already repeated.

    Causal masking is top-left aligned (query i sees keys 0..i), as in
    ``repro.kernels.flash_attention``.
    """
    f32 = torch.float32
    S, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(f32), k.to(f32))
    s = s / (q.shape[-1] ** 0.5)
    if causal:
        mask = (torch.arange(S, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.to(f32)).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths):
    """q: (B, H, hd); caches: (B, S, KVH, hd); lengths: (B,) valid fill.

    One-token GQA attention: query head ``h`` reads KV head ``h // G``.
    Rows with ``lengths == 0`` return exact zeros (never a softmax over an
    all-masked row), the contract of ``repro.kernels.ref``.
    """
    B, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    f32 = torch.float32
    qg = q.reshape(B, KVH, G, hd).to(f32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.to(f32)) / (hd ** 0.5)
    lengths = lengths.to(q.device)
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(f32))
    o = torch.where((lengths > 0)[:, None, None, None], o,
                    torch.zeros_like(o))
    return o.reshape(B, H, hd).to(q.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, page_table, lengths):
    """q: (B, H, hd); pages: (P, page_size, KVH, hd); page_table:
    (B, pages_per_row) physical page ids; lengths: (B,) valid fill.

    A row's logical cache is its table's pages in order. This version
    gathers that view and runs ``decode_attention_ref`` over it, so on the
    same tokens it equals the contiguous version bit for bit.
    """
    B = q.shape[0]
    n_pt = page_table.shape[1]
    ps = k_pages.shape[1]
    idx = page_table.long()
    k_view = k_pages[idx].reshape(B, n_pt * ps, *k_pages.shape[2:])
    v_view = v_pages[idx].reshape(B, n_pt * ps, *v_pages.shape[2:])
    return decode_attention_ref(q, k_view, v_view, lengths)
