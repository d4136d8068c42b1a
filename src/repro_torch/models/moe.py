"""Mixture-of-Experts routing and capacity dispatch (``repro.models.moe``).

The port runs on one card, so the MoE layer is the JAX package's no-mesh
path, ``_moe_local`` with every expert local: route each token to its
top-k experts, fill each expert's ``C`` capacity slots in token-major,
k-minor order, drop what overflows, run the three expert products through
the grouped-GEMM kernel (``kernels.ops.gmm``) and add the gated outputs
back into their tokens in a fixed order.

The capacity ``C = ceil(T * k / E * capacity_factor)`` counts all ``T =
B * S`` rows of the call, as the reference does: whether one request's
token reaches its expert depends on its batch mates (the rows a chunked
prefill pads in, the inactive slots a decode step still runs). The port
keeps that semantics exactly; it is the reference's, not a fault to fix.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def route(p, cfg, x):
    """x: (B, S, d) -> ids (B, S, K) int64, weights (B, S, K) f32, aux.

    fp32 router, softmax, top-k and renormalisation. Ties go to the lower
    expert index, as ``jax.lax.top_k`` orders them: a stable descending
    sort keeps equal probabilities in index order.
    """
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[..., :cfg.top_k], ids[..., :cfg.top_k]
    wts = wts / torch.clamp(wts.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balance loss (Switch): E * sum_e mean_prob_e * frac_assign_e
    counts = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts).float()
    frac = counts / torch.clamp(counts.sum(), min=1.0)
    lb_loss = cfg.n_experts * torch.sum(probs.mean(dim=(0, 1)) * frac)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1).square())
    return ids, wts, {"moe_lb_loss": lb_loss, "moe_z_loss": z_loss}


def capacity(tokens: int, cfg) -> int:
    """Slots per expert for a call of ``tokens`` rows."""
    return max(1, math.ceil(tokens * cfg.top_k / cfg.n_experts
                            * cfg.capacity_factor))


def dispatch(ids, cfg):
    """Capacity tables of a call: ids (B, S, K) -> (tok (E, C) int64,
    slot (T*K,) int64, kept (T*K,) bool).

    ``slot`` is each assignment's position in its expert, counted in
    token-major, k-minor order; an assignment is kept when its slot is
    below C. ``tok[e, c]`` is the token in slot c of expert e, or T for an
    empty slot.
    """
    T = ids.shape[0] * ids.shape[1]
    K, E = cfg.top_k, cfg.n_experts
    C = capacity(T, cfg)
    idf = ids.reshape(T * K)
    onehot = F.one_hot(idf, E)                              # (T*K, E)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=1)
    kept = slot < C
    tok = torch.full((E * C,), T, dtype=torch.int64, device=ids.device)
    flat = idf * C + slot
    tok[flat[kept]] = torch.arange(T * K, device=ids.device)[kept] // K
    return tok.reshape(E, C), slot, kept


def moe_apply(p, cfg, x, ids, wts):
    """x: (B, S, d); ids, wts: (B, S, K) from ``route``. Returns (B, S, d)
    in x's dtype: the gated sum of each token's kept experts."""
    B, S, d = x.shape
    T, K, E = B * S, cfg.top_k, cfg.n_experts
    tok, slot, kept = dispatch(ids, cfg)
    C = tok.shape[1]
    gate = torch.zeros(E * C, dtype=torch.float32, device=x.device)
    gate[(ids.reshape(T * K) * C + slot)[kept]] = wts.reshape(
        T * K).float()[kept]
    xf = x.reshape(T, d)
    valid = tok < T
    xe = torch.where(valid[..., None], xf[tok.clamp(max=T - 1)], 0)
    # an expert's kept slots are a prefix of its C rows: the count says
    # which rows the products need (the rest are zero: silu(0) * 0 and
    # relu(0)^2 keep h's zero too), so an empty expert reads no weight
    counts = valid.sum(dim=1, dtype=torch.int32)           # (E,), no sync
    h = ops.gmm(xe, p["w_in"], counts)
    if cfg.mlp_act == "swiglu":
        g = ops.gmm(xe, p["w_gate"], counts)
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = torch.relu(h).square()
    ye = ops.gmm(h, p["w_out"], counts)
    ye = (ye.float() * gate.reshape(E, C, 1)).to(x.dtype)
    # Combine: each token's kept outputs, added one at a time in x's dtype
    # in table order (experts ascending), the order in which the
    # reference's scatter-add applies them. A fixed order: index_add_ on
    # the card adds in whatever order its atomics land, which changes the
    # bf16 sum of three or more outputs (top-8) from run to run.
    order = torch.argsort(ids.reshape(T, K), dim=1)
    at = torch.gather((ids.reshape(T * K) * C + slot).reshape(T, K), 1, order)
    keep = torch.gather(kept.reshape(T, K), 1, order)
    at = torch.where(keep, at, 0)       # a dropped slot may lie past E * C
    parts = torch.where(keep[..., None], ye.reshape(E * C, d)[at], 0)
    y = torch.zeros(T, d, dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + parts[:, k]
    return y.reshape(B, S, d)
