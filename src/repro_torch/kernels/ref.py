"""Plain PyTorch versions of the port's kernels.

Each function computes what its hand-written Hopper kernel computes, with
fp32 arithmetic inside, on any device: the attention versions and
``moe_gmm_ref`` cast the result to the input's dtype, ``ssd_scan_ref``
returns fp32 as the kernel does. ``kernels/ops.py`` sends CPU tensors
here; ``chip_smoke.py`` holds each CUDA kernel against these on the card.
They materialize whole intermediates (the full score matrix, a gathered
copy of each row's pages, fp32 copies of the expert weights): they are
references, never the card's path.
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


def moe_gmm_ref(x, w, counts=None):
    """Grouped expert GEMM. x: (E, C, d); w: (E, d, f) -> (E, C, f) in
    x's dtype, from an fp32 product (``repro.kernels.ref.moe_gmm_ref``).

    counts: optional (E,) filled slots per expert, a prefix of its C rows;
    output rows at or past ``counts[e]`` are exact zero, whatever x holds
    there. None means every row is filled.
    """
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    if counts is not None:
        C = x.shape[1]
        filled = (torch.arange(C, device=x.device)[None, :]
                  < counts.to(x.device)[:, None])
        out = torch.where(filled[..., None], out, 0.0)
    return out.to(x.dtype)


def ssd_scan_ref(x, dt, A, Bg, Cg, *, chunk: int):
    """Mamba2 SSD forward from a zero state, in the chunked dual form of
    ``repro.models.ssm.ssd_chunked``.

    x: (B, S, nh, hp); dt: (B, S, nh) f32; A: (nh,) f32; Bg/Cg: (B, S, ng,
    ds), head h reading group h // (nh / ng). S must be a multiple of
    ``chunk``. Returns (y (B, S, nh, hp) fp32, final state (B, nh, hp, ds)
    fp32), like the Pallas kernel.
    """
    B, S, nh, hp = x.shape
    ng, ds = Bg.shape[-2:]
    if chunk < 1 or S % chunk or nh % ng:
        raise ValueError(f"ssd_scan_ref: S={S} must be a multiple of chunk="
                         f"{chunk} and ng={ng} must divide nh={nh}")
    nc, f32 = S // chunk, torch.float32
    Bh = Bg.to(f32).repeat_interleave(nh // ng, dim=2).reshape(
        B, nc, chunk, nh, ds)
    Ch = Cg.to(f32).repeat_interleave(nh // ng, dim=2).reshape(
        B, nc, chunk, nh, ds)
    xc = x.to(f32).reshape(B, nc, chunk, nh, hp)
    dtc = dt.to(f32).reshape(B, nc, chunk, nh)
    A = A.to(f32)
    causal = (torch.arange(chunk, device=x.device)[:, None]
              >= torch.arange(chunk, device=x.device)[None, :])
    state = torch.zeros(B, nh, hp, ds, dtype=f32, device=x.device)
    ys = []
    for c in range(nc):
        xb, dtb, Bb, Cb = xc[:, c], dtc[:, c], Bh[:, c], Ch[:, c]
        cs = torch.cumsum(dtb * A, dim=1)                     # (B, Q, nh)
        # exp only under the mask's where: above the diagonal cs_i - cs_j
        # > 0 and may overflow, and is then discarded (as in JAX)
        L = torch.where(causal[None, :, :, None],
                        torch.exp(cs[:, :, None, :] - cs[:, None, :, :]), 0.0)
        scores = torch.einsum("bihs,bjhs->bijh", Cb, Bb) * L
        xdt = xb * dtb[..., None]
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        y = y + torch.einsum("bihs,bhps->bihp", Cb, state) * torch.exp(
            cs)[..., None]
        decay_out = torch.exp(cs[:, -1:, :] - cs)
        state = state * torch.exp(cs[:, -1])[:, :, None, None] + torch.einsum(
            "bjhs,bjhp->bhps", Bb * decay_out[..., None], xdt)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, nh, hp), state
