"""Mixture-of-Experts routing and capacity dispatch (``repro.models.moe``).

``moe_apply`` is the reference's ``_moe_local``: route each token to
its top-k experts, fill each expert's ``C`` capacity slots in
token-major, k-minor order, drop what overflows, run the three expert
products through the grouped-GEMM kernel (``kernels.ops.gmm``) and add
the gated outputs back into their tokens in a fixed order. On one rank
every expert is local. Under a mesh whose ``model`` axis divides the
experts, each rank holds the E / n experts that ``resolve_spec`` gives it
(``"experts": "model"``), takes its range of the same dispatch, and the
ranks' partial outputs add up in one all-reduce over ``model``: the
reference's expert parallelism with tokens replicated and a ``psum``
combine. When the batch divides over the batch axes, each rank
dispatches only its rows, and C counts them, as the reference's
per-shard capacity does; the rows then all-gather.

Training runs ``moe_train``: the same routing, capacity and drops, with
the three expert products as plain batched products (the kernel is
forward-only) and every gather laid out so that its gradient adds each
row once or sums in a fixed order: no row's gradient depends on the
order in which additions land. Under data parallelism (``route`` and
``slots`` with a ``data`` group) each rank routes its rows, and the aux
losses, C and the slots are those of the global batch. Under the
``model`` axis (``moe_train(tp=)``) a rank runs its experts, and C and
the slots count its data shard's rows, as the reference's per-shard
``_moe_local`` does; the aux losses stay global.

The capacity ``C = ceil(T * k / E * capacity_factor)`` counts all ``T =
B * S`` rows of the call, as the reference does: whether one request's
token reaches its expert depends on its batch mates (the rows a chunked
prefill pads in, the inactive slots a decode step still runs). The port
keeps that semantics exactly; it is the reference's, not a fault to fix.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.parallel.collectives import all_gather, all_reduce, batch_rows
from repro_torch.parallel.sharding import AXIS_MODEL, mesh_axis_size
from repro_torch.parallel.tensor import WHOLE


def route(p, cfg, x, data=None):
    """x: (B, S, d) -> ids (B, S, K) int64, weights (B, S, K) f32, aux.

    fp32 router, softmax, top-k and renormalisation. Ties go to the lower
    expert index, as ``jax.lax.top_k`` orders them: a stable descending
    sort keeps equal probabilities in index order.

    ``data``: the process group of the ranks that hold the other rows of
    the batch (``models.lm.LM.loss``), or None when x is the whole batch.
    Under a group the aux losses are this rank's share of the whole
    batch's: ``frac`` comes from the all-reduced (E,) counts, and the
    mean probability and the router z loss divide the rank's sums by the
    global ``T``, so the shares add up to the reference's losses over the
    global batch.
    """
    logits = x.float() @ p["router"]
    probs = torch.softmax(logits, dim=-1)
    wts, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    wts, ids = wts[..., :cfg.top_k], ids[..., :cfg.top_k]
    wts = wts / torch.clamp(wts.sum(dim=-1, keepdim=True), min=1e-9)
    # load-balance loss (Switch): E * sum_e mean_prob_e * frac_assign_e;
    # the counts as a scatter of ones, which a meta tensor (the dry run)
    # can run and ``bincount`` cannot: the same integers
    flat = ids.reshape(-1)
    counts = torch.zeros(cfg.n_experts, dtype=torch.int64,
                         device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat)).float()
    lse2 = torch.logsumexp(logits, dim=-1).square()
    if data is None:
        frac = counts / torch.clamp(counts.sum(), min=1.0)
        lb_loss = cfg.n_experts * torch.sum(probs.mean(dim=(0, 1)) * frac)
        z_loss = torch.mean(lse2)
    else:
        counts = all_reduce(counts, data)
        frac = counts / torch.clamp(counts.sum(), min=1.0)
        T = x.shape[0] * x.shape[1] * dist.get_world_size(data)
        lb_loss = cfg.n_experts * torch.sum(probs.sum(dim=(0, 1)) / T * frac)
        z_loss = lse2.sum() / T
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

    Every shape here follows from the call's shapes alone: a dropped
    assignment writes into a spare slot past the table, which is cut
    off, where a boolean index would give a shape that depends on the
    data (a host sync on the card, no shape at all on a meta tensor).
    A kept slot has one writer, so the table is the same.
    """
    T = ids.shape[0] * ids.shape[1]
    K, E = cfg.top_k, cfg.n_experts
    slot, kept, C = slots(ids, cfg)
    tok = torch.full((E * C + 1,), T, dtype=torch.int64, device=ids.device)
    tok[_kept_at(ids.reshape(T * K) * C + slot, kept, E * C)] = (
        torch.arange(T * K, device=ids.device) // K)
    return tok[:E * C].reshape(E, C), slot, kept


def _kept_at(flat, kept, spare: int):
    """Each assignment's slot id ``flat`` where it is kept, else the
    spare id past the table."""
    return torch.where(kept, flat, spare)


def _experts(p, cfg, xe, gate, product):
    """The expert MLP of the dispatched rows xe (E, C, d), gated by gate
    (E, C, 1) f32: ``product(a, w)`` computes each of the three expert
    products (the kernel when serving, a plain product when training).
    Returns (E, C, d) in xe's dtype."""
    h = product(xe, p["w_in"])
    if cfg.mlp_act == "swiglu":
        g = product(xe, p["w_gate"])
        h = F.silu(g.float()).to(h.dtype) * h
    else:
        h = torch.relu(h).square()
    ye = product(h, p["w_out"])
    return (ye.float() * gate).to(xe.dtype)


def moe_apply(p, cfg, x, ids, wts, mesh=None, partial=None):
    """x: (B, S, d); ids, wts: (B, S, K) from ``route``. Returns (B, S, d)
    in x's dtype: the gated sum of each token's kept experts.

    With ``mesh`` (``launch.mesh.Mesh``) whose ``model`` axis of n ranks
    divides E, ``p``'s expert weights are this rank's E / n experts (as
    ``bridge`` shards them) and the result is the all-reduce over
    ``model`` of every rank's share; otherwise every expert is local.
    ``partial`` (B, S, d): this rank's row-parallel partial of the dense
    residual or shared MLP (``blocks._ffn``), added to the rank's share
    before that one reduction, or summed over ``model`` on its own and
    added when every expert is local."""
    E = cfg.n_experts
    n = mesh_axis_size(mesh, AXIS_MODEL) if mesh is not None else 1
    if n == 1 or E % n:
        y = _moe_local(p, cfg, x, ids, wts, 0, E)
        if partial is not None:
            y = y + all_reduce(partial, mesh.group(AXIS_MODEL))
        return y
    n_local = E // n
    rows = batch_rows(mesh, x.shape[0])
    b = rows[0] if rows else slice(None)
    y = _moe_local(p, cfg, x[b], ids[b], wts[b],
                   mesh.coords[AXIS_MODEL] * n_local, n_local)
    if partial is not None:
        y = y + partial[b]
    y = all_reduce(y, mesh.group(AXIS_MODEL))
    return all_gather(y, 0, rows[1]) if rows else y


def _moe_local(p, cfg, x, ids, wts, lo: int, n_local: int):
    """The experts [lo, lo + n_local) of the call's dispatch, whose
    weights ``p`` holds: their gated outputs added into each token, in x's
    dtype. C counts this call's B * S rows."""
    B, S, d = x.shape
    T, K, E = B * S, cfg.top_k, cfg.n_experts
    if p["w_in"].shape[0] != n_local:
        raise ValueError(f"moe: {n_local} local experts, but the weights "
                         f"hold {p['w_in'].shape[0]}")
    tok, slot, kept = dispatch(ids, cfg)
    C = tok.shape[1]
    idf = ids.reshape(T * K)
    flat = idf * C + slot
    gate = torch.zeros(E * C + 1, dtype=torch.float32, device=x.device)
    gate[_kept_at(flat, kept, E * C)] = wts.reshape(T * K).float()
    gate = gate[:E * C].reshape(E, C, 1)
    if n_local < E:
        # this rank's range of the table; another rank's slots drop here
        tok, gate = tok[lo:lo + n_local], gate[lo:lo + n_local]
        kept = kept & (idf >= lo) & (idf < lo + n_local)
        flat = flat - lo * C
    xf = x.reshape(T, d)
    valid = tok < T
    xe = torch.where(valid[..., None], xf[tok.clamp(max=T - 1)], 0)
    # an expert's kept slots are a prefix of its C rows: the count says
    # which rows the products need (the rest are zero: silu(0) * 0 and
    # relu(0)^2 keep h's zero too), so an empty expert reads no weight
    counts = valid.sum(dim=1, dtype=torch.int32)      # (n_local,), no sync
    ye = _experts(p, cfg, xe, gate, lambda a, w: ops.gmm(a, w, counts))
    # Combine: each token's kept outputs, added one at a time in x's dtype
    # in table order (experts ascending), the order in which the
    # reference's scatter-add applies them. A fixed order: index_add_ on
    # the card adds in whatever order its atomics land, which changes the
    # bf16 sum of three or more outputs (top-8) from run to run.
    order = torch.argsort(ids.reshape(T, K), dim=1)
    at = torch.gather(flat.reshape(T, K), 1, order)
    keep = torch.gather(kept.reshape(T, K), 1, order)
    at = torch.where(keep, at, 0)       # a dropped slot may lie past the table
    parts = torch.where(keep[..., None], ye.reshape(n_local * C, d)[at], 0)
    y = torch.zeros(T, d, dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + parts[:, k]
    return y.reshape(B, S, d)


def slots(ids, cfg, data=None):
    """(slot (T*K,) int64, kept (T*K,) bool, C) of the training route:
    each assignment's position in its expert in token-major, k-minor
    order, kept below the capacity C.

    Under ``data`` (the group of the ranks that hold the batch's other
    rows, each a contiguous block in group-rank order) C counts the
    global ``T``, and each slot adds the count of the same expert among
    the lower ranks' assignments (an exclusive scan over one all-gather
    of (E,) counts): the reference's global fill order, drops included.
    """
    T = ids.shape[0] * ids.shape[1]
    E = cfg.n_experts
    idf = ids.reshape(T * cfg.top_k)
    onehot = F.one_hot(idf, E)                              # (T*K, E)
    slot = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=1)
    if data is None:
        C = capacity(T, cfg)
    else:
        C = capacity(T * dist.get_world_size(data), cfg)
        every = all_gather(onehot.sum(dim=0)[None], 0, data)   # (n, E)
        below = every[:dist.get_rank(data)].sum(dim=0)
        slot = slot + below[idf]
    return slot, slot < C, C


def moe_train(p, cfg, x, ids, wts, data=None, tp=WHOLE, partial=None):
    """The training route of ``moe_apply``: the same function of x, the
    weights and the gates ``wts``, differentiable in all three.

    Each token is copied once per choice (a broadcast, whose gradient sums
    the k copies), each expert slot gathers its assignment's copy (an
    empty slot, the spare zero row past the end), and each token gathers
    its kept outputs (a dropped one, the spare zero row) and adds them in
    expert order. Every gathered row but the spare one has one reader, so
    the gradients of the gathers add each row once.

    ``data``: as in ``slots``. A rank then runs its rows through its
    slots of the global table; the slots that other ranks fill stay
    empty here, so the ranks' outputs are the rows of the reference's.

    ``tp`` (``parallel.tensor.TensorParallel``): where its ``model`` axis
    of n ranks divides E, ``p`` holds this rank's E / n experts, x and the
    gates enter the split (``TensorParallel.enter``), and the result is
    the sum over ``model`` of the ranks' outputs, ``partial`` (this rank's
    row-parallel part of the dense residual or shared MLP) added before
    that one reduction. C and the fill then count this rank's rows alone,
    its data shard's, as the reference's ``shard_map`` over the batch
    axes makes them; ``data`` is not read (``route``'s aux losses stay
    global). Otherwise every expert is local and ``partial`` is summed on
    its own.
    """
    E = cfg.n_experts
    if tp.n == 1 or E % tp.n:
        y = _moe_train_local(p, cfg, x, ids, wts, slots(ids, cfg, data),
                             0, E)
        return y if partial is None else y + tp.reduce(partial)
    n_local = E // tp.n
    y = _moe_train_local(p, cfg, tp.enter(x), ids, tp.enter(wts),
                         slots(ids, cfg), tp.index * n_local, n_local)
    if partial is not None:
        y = y + partial
    return tp.reduce(y)


def _moe_train_local(p, cfg, x, ids, wts, table, lo: int, n_local: int):
    """The experts [lo, lo + n_local) of the training route, whose weights
    ``p`` holds, over the slots ``table`` = (slot, kept, C) of ``slots``:
    their gated outputs added into each token, in x's dtype."""
    B, S, d = x.shape
    T, K = B * S, cfg.top_k
    slot, kept, C = table
    idf = ids.reshape(T * K)
    mine = kept & (idf >= lo) & (idf < lo + n_local)
    flat = (idf - lo) * C + slot                          # (T*K,) slot ids
    spare = torch.full_like(flat, n_local * C)
    at = torch.where(mine, flat, spare)                   # dropped -> spare
    src = torch.full((n_local * C + 1,), T * K, dtype=torch.int64,
                     device=x.device)
    src[at] = torch.arange(T * K, device=x.device)        # spare row: junk
    src = src[:n_local * C]                               # slot -> choice
    xk = x.reshape(T, 1, d).expand(T, K, d).reshape(T * K, d)
    xe = torch.cat([xk, xk.new_zeros(1, d)])[src].reshape(n_local, C, d)
    wk = wts.reshape(T * K).float()
    gate = torch.cat([wk, wk.new_zeros(1)])[src].reshape(n_local, C, 1)
    ye = _experts(p, cfg, xe, gate, torch.bmm).reshape(n_local * C, d)
    ye = torch.cat([ye, ye.new_zeros(1, d)])
    # each token's kept outputs in table order (experts ascending)
    order = torch.argsort(ids.reshape(T, K), dim=1)
    at = torch.gather(at.reshape(T, K), 1, order)
    y = torch.zeros(T, d, dtype=x.dtype, device=x.device)
    for k in range(K):
        y = y + ye[at[:, k]]
    return y.reshape(B, S, d)
