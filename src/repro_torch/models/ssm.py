"""Mamba2 (state-space duality) blocks (``repro.models.ssm``).

Prefill runs the chunked SSD scan through ``kernels.ops.ssd`` (the
``ssd_scan`` kernel on the card), from a zero state. Decode runs the
one-token recurrence ``ssd_decode_step`` as plain tensor ops: the JAX
package has no kernel for it either. Training runs ``ssd_chunked``, the
same chunked dual form as plain tensor ops that autograd differentiates
(the kernel is forward-only). The projections and the depthwise causal
conv stay plain ops, as JAX leaves them to XLA.

Caches per layer: ``({"x", "B", "C"} conv tails (B, k-1, ch) in the
model's dtype, SSM state (B, nh, hp, ds) fp32)``. Decode writes the new
conv tails and state into the cache tensors in place.

Under tensor parallelism (``parallel.tensor``) a rank runs its nh / n
heads: its columns of ``w_z``, ``w_x``, ``conv_x`` and ``w_dt``, its
``a_log``, ``d_skip`` and ``dt_bias``, the whole B/C projections (of
which it reads the groups its heads use), and its rows of ``w_out``,
whose partials are summed over ``model``. The gated norm is one RMSNorm
over all of ``d_inner``, so the ranks' fp32 sums of squares are summed
over ``model`` before the rsqrt: a norm over the rank's channels alone
would be another function. Training runs the same split under autograd:
the input, ``w_B``, ``w_C``, their convs, ``norm`` and the summed squares
enter it through ``TensorParallel.enter`` (``parallel.tensor``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import rmsnorm
from repro_torch.parallel.tensor import WHOLE, ssm_group_range


def causal_conv(x, w, prev=None):
    """Depthwise causal conv + SiLU. x: (B, S, ch); w: (k, ch); prev:
    (B, k-1, ch) or None (zeros). Returns (out (B, S, ch), new tail
    (B, k-1, ch)). The conv's sum is rounded to x's dtype before the fp32
    SiLU, as the JAX conv returns it."""
    k = w.shape[0]
    if prev is None:
        prev = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([prev, x], dim=1)
    S = x.shape[1]
    wf = w.float()
    acc = xp[:, 0:S].float() * wf[0]
    for i in range(1, k):
        acc = acc + xp[:, i:i + S].float() * wf[i]
    out = F.silu(acc.to(x.dtype).float()).to(x.dtype)
    return out, xp[:, S:]


def _expand_groups(t, nh: int):
    """(..., ng, ds) -> (..., nh, ds), head h reading group h // (nh / ng).
    A broadcast and a copy, not an index: autograd sums the copies back
    in a fixed order, where an index's backward adds with atomics."""
    ng, ds = t.shape[-2:]
    if ng == nh:
        return t
    return t[..., None, :].expand(*t.shape[:-1], nh // ng, ds).reshape(
        *t.shape[:-2], nh, ds)


def ssd_chunked(xh, dt, A, Bg, Cg, chunk: int, state0=None):
    """Chunked SSD (``repro.models.ssm.ssd_chunked``), differentiable.

    xh: (B, S, nh, hp); dt: (B, S, nh) f32; A: (nh,) f32; Bg/Cg: (B, S,
    ng, ds); state0: (B, nh, hp, ds) fp32 or None (zeros). Returns (y (B,
    S, nh, hp) in xh's dtype, final state fp32). S must be below ``chunk``
    or a multiple of it, else ``ValueError``.
    """
    B, S, nh, hp = xh.shape
    ng, ds = Bg.shape[-2:]
    chunk = min(chunk, S)
    if S % chunk or nh % ng:
        raise ValueError(f"ssd_chunked: S={S} must be below or a multiple "
                         f"of chunk={chunk} and ng={ng} must divide nh={nh}")
    nc, f32 = S // chunk, torch.float32
    Bh = _expand_groups(Bg.to(f32), nh).reshape(B, nc, chunk, nh, ds)
    Ch = _expand_groups(Cg.to(f32), nh).reshape(B, nc, chunk, nh, ds)
    xc = xh.to(f32).reshape(B, nc, chunk, nh, hp)
    dtc = dt.to(f32).reshape(B, nc, chunk, nh)
    A = A.to(f32)
    causal = (torch.arange(chunk, device=xh.device)[:, None]
              >= torch.arange(chunk, device=xh.device)[None, :])
    state = (torch.zeros(B, nh, hp, ds, dtype=f32, device=xh.device)
             if state0 is None else state0)
    ys = []
    for c in range(nc):
        xb, dtb, Bb, Cb = xc[:, c], dtc[:, c], Bh[:, c], Ch[:, c]
        cs = torch.cumsum(dtb * A, dim=1)                     # (B, Q, nh)
        # above the diagonal cs_i - cs_j > 0 may overflow; the reference
        # discards it after the exp, here it is -inf before: the same
        # values where the mask holds, exact zeros (and zero gradients,
        # never inf * 0) where it does not
        L = torch.exp(torch.where(causal[None, :, :, None],
                                  cs[:, :, None, :] - cs[:, None, :, :],
                                  -torch.inf))
        scores = torch.einsum("bihs,bjhs->bijh", Cb, Bb) * L
        xdt = xb * dtb[..., None]
        y = torch.einsum("bijh,bjhp->bihp", scores, xdt)
        y = y + torch.einsum("bihs,bhps->bihp", Cb, state) * torch.exp(
            cs)[..., None]
        decay_out = torch.exp(cs[:, -1:, :] - cs)
        state = state * torch.exp(cs[:, -1])[:, :, None, None] + torch.einsum(
            "bjhs,bjhp->bhps", Bb * decay_out[..., None], xdt)
        ys.append(y)
    y = torch.stack(ys, dim=1).reshape(B, S, nh, hp)
    return y.to(xh.dtype), state


def ssd_decode_step(xh, dt, A, Bg, Cg, state):
    """One token. xh: (B, nh, hp); dt: (B, nh); Bg/Cg: (B, ng, ds);
    state: (B, nh, hp, ds) fp32 -> (y (B, nh, hp) in xh's dtype, new
    state fp32)."""
    nh = xh.shape[1]
    Bh = _expand_groups(Bg, nh).float()
    Ch = _expand_groups(Cg, nh).float()
    dA = torch.exp(dt * A)
    xdt = xh.float() * dt[..., None]
    new_state = state * dA[..., None, None] + torch.einsum(
        "bhs,bhp->bhps", Bh, xdt)
    y = torch.einsum("bhs,bhps->bhp", Ch, new_state)
    return y.to(xh.dtype), new_state


def split_rmsnorm(scale, x, eps: float, width: int, tp):
    """RMSNorm over a ``width``-wide dim of which this rank holds the
    slice x (and ``scale``'s matching slice): the fp32 sums of squares are
    summed over ``tp``'s ``model`` group, then divided by ``width``."""
    dt = x.dtype
    x = x.float()
    # the whole sum flows back into this rank's channels: entered
    var = tp.enter(tp.reduce(x.square().sum(dim=-1, keepdim=True))) / width
    x = x * torch.rsqrt(var + eps)
    return (x * scale.float()).to(dt)


def mamba_apply(p, cfg, x, *, cache=None, train=False, tp=WHOLE):
    """x: (B, S, d) -> (out (B, S, d), cache).

    Prefill (``cache is None``) scans the whole prompt and returns the
    layer's new cache; S must be below ``cfg.ssm_chunk`` or a multiple of
    it (``ssd_chunked``'s rule), else ``ValueError``. Decode (S == 1)
    takes the layer's cache, advances it one token in place and returns it.
    ``train``: the whole sequence from a zero state through
    ``ssd_chunked``, never a kernel; the returned cache is None. ``tp``:
    this rank's split (``parallel.tensor``); where it splits the Mamba2
    heads, ``p`` and the cache hold the rank's heads and the output is
    the sum over ``model`` of the ranks' partials.
    """
    B, S, _ = x.shape
    hp, ds, ng = cfg.ssm_head_dim, cfg.d_state, cfg.ssm_groups
    h0, h1 = tp.ssm_heads(cfg)
    if tp.ssm and train:
        # whole tensors a rank reads for its heads only: their gradients
        # sum over ``model``
        x = tp.enter(x)
        p = dict(p, **{k: tp.enter(p[k]) for k in (
            "w_B", "w_C", "conv_B", "conv_C", "norm")})
    nh = h1 - h0
    g0, g1 = ssm_group_range(cfg, tp)
    z = x @ p["w_z"]
    xs = x @ p["w_x"]
    Bm = x @ p["w_B"]
    Cm = x @ p["w_C"]
    dt = x.float() @ p["w_dt"].float()
    conv = cache[0] if cache is not None else {}
    xs, cx = causal_conv(xs, p["conv_x"], conv.get("x"))
    Bm, cb = causal_conv(Bm, p["conv_B"], conv.get("B"))
    Cm, cc = causal_conv(Cm, p["conv_C"], conv.get("C"))
    dt = F.softplus(dt + p["dt_bias"])                    # (B, S, nh)
    A = -torch.exp(p["a_log"])
    xh = xs.reshape(B, S, nh, hp)
    # the groups this rank's heads read (all of them on one rank)
    Bg = Bm.reshape(B, S, ng, ds)[:, :, g0:g1].contiguous()
    Cg = Cm.reshape(B, S, ng, ds)[:, :, g0:g1].contiguous()
    if train:
        y, _ = ssd_chunked(xh, dt, A, Bg, Cg, cfg.ssm_chunk)
        new_cache = None
    elif cache is None:
        chunk = min(cfg.ssm_chunk, S)
        if S % chunk:
            raise ValueError(
                f"{cfg.name}: a prompt of {S} tokens is neither shorter "
                f"than the SSD chunk ({cfg.ssm_chunk}) nor a multiple of it")
        y, state = ops.ssd(xh, dt, A, Bg, Cg, chunk=chunk)
        y = y.to(xh.dtype)
        new_cache = ({"x": cx, "B": cb, "C": cc}, state)
    else:
        if S != 1:
            raise ValueError(f"decode takes one token per row, got {S}")
        y, state = ssd_decode_step(xh[:, 0], dt[:, 0], A, Bg[:, 0],
                                   Cg[:, 0], cache[1])
        y = y[:, None]
        for key, tail in (("x", cx), ("B", cb), ("C", cc)):
            conv[key].copy_(tail)
        cache[1].copy_(state)
        new_cache = cache
    y = y + (xh.float() * p["d_skip"][:, None]).to(y.dtype)
    y = y.reshape(B, S, nh * hp)
    if tp.ssm:
        y = split_rmsnorm(p["norm"][h0 * hp:h1 * hp], y, cfg.norm_eps,
                          cfg.d_inner, tp)
    else:
        y = rmsnorm(p["norm"], y, cfg.norm_eps)
    y = y * F.silu(z.float()).to(y.dtype)
    out = y @ p["w_out"]
    return (tp.reduce(out) if tp.ssm else out), new_cache
