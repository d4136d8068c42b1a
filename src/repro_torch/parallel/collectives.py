"""Explicit collectives of the serving path (``repro.parallel.collectives``).

``seq_sharded_decode_attention`` decodes over a KV cache sharded along
the sequence over the mesh's ``model`` axis: each rank inserts the new
token if it lands in its slice, attends over its slice, and the partial
softmaxes merge with an all-reduce MAX of the row maxima and one SUM of
the rescaled outputs and denominators (flash-decoding across ranks).

``ring_attention`` is sequence-parallel prefill attention: each rank
takes its block of the sequence, attends its queries to the KV block it
holds, and passes that block on around the ring, so the unrepeated GQA
K/V (not the H x hd activations) go on the wire. Online-softmax
accumulators merge the blocks exactly, as in the reference.

The port keeps activations replicated on every rank, where the
reference's ``shard_map`` leaves them sharded for GSPMD: these functions
take and return whole tensors. A rank computes its share, as the
reference's ``in_specs`` give it (its sequence block, and its rows when
the batch divides over the batch axes, ``batch_axes``), and all-gathers
the result. The per-rank partials are plain PyTorch, as the reference
computes them with ``einsum`` outside any Pallas kernel; the ring's
fallback when S does not divide runs the flash kernel, as the port's
prefill does.

Both run over the mesh's ``model`` axis, as every caller in the
reference passes it, and the ring is causal, as prefill is.

Training under the ``model`` axis differentiates through the splits
with three ``torch.autograd.Function``s, the transposes that GSPMD
applies to the reference's ``psum`` and ``all_gather``: ``row_sum`` (SUM
forward, identity backward), ``enter`` (identity forward, SUM of the
gradient backward, at the entry of every split region) and ``gather``
(all-gather forward, this rank's slice of the gradient backward). FSDP
storage (``fsdp_gather``) all-gathers a stored slice over batch axes,
where every rank computes with the whole leaf on its own rows: its
backward sums the gradient over the group, then keeps this rank's slice
(``reduce_scatter``). Without autograd (the serving passes run under
``no_grad``) each is the plain collective, bit for bit.

Transport: under NCCL, device tensors go on the wire. Under gloo, whose
send, recv and all_gather take host tensors, every collective here moves
a CUDA tensor through a host copy in pinned memory: ``gloo_transport``,
``_wire``; an all-gather copies each rank's part straight into its
place on the device. Gloo's all_reduce would take a CUDA tensor, but it
too copies it to host memory and back, so the reductions stage through
the same copy as the rest and the transport has one rule. That is how
the ranks of a one-card world (NCCL refuses two ranks on one card)
exchange data; the compute stays on the card.

Under the dry run (``launch.dryrun``) the process group is ``"fake"``
and the tensors are meta: a collective moves nothing, and a fake group
takes the transport of the backend it stands for (``fake_backend``).
Every collective that goes on the wire is reported, as it is made, to
the observers that ``observed`` installs (``launch.comm_analysis``
records them): its kind, its result and its group.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch.models.attention import prefill_attention
from repro_torch.parallel.sharding import (
    AXIS_MODEL, batch_axes, mesh_axis_size)

NEG_INF = -1e30


# ---------------------------------------------------------------- observers
_observers: list = []
_fake = ["nccl"]       # the backend a "fake" process group stands for


@contextlib.contextmanager
def observed(fn):
    """Within the block, call ``fn(kind, result, group)`` at every
    collective that goes on the wire, as it is made: ``kind`` one of
    "all-reduce", "all-gather", "reduce-scatter", "collective-permute"
    (the reference's HLO names), ``result`` the tensor it delivers to
    this rank (the gathered one, the reduced one, this rank's slice, the
    received one)."""
    _observers.append(fn)
    try:
        yield fn
    finally:
        _observers.remove(fn)


@contextlib.contextmanager
def fake_backend(name: str):
    """Within the block, a ``"fake"`` process group takes the
    transport of backend ``name`` ("nccl" or "gloo"): which of two ways
    ``reduce_scatter`` and ``reduce_grads`` go."""
    if name not in ("nccl", "gloo"):
        raise ValueError(f"fake_backend: {name!r}, not 'nccl' or 'gloo'")
    _fake.append(name)
    try:
        yield
    finally:
        _fake.pop()


def _seen(kind: str, result, group) -> None:
    for fn in _observers:
        fn(kind, result, group)


# ---------------------------------------------------------------- transport
def gloo_transport(group) -> bool:
    """Whether ``group``'s collectives stage CUDA tensors through host
    memory: true under gloo, and under a fake group standing for it."""
    backend = dist.get_backend(group)
    return (_fake[-1] if backend == "fake" else backend) == "gloo"


def _wire(t, group):
    """The tensor that goes on the wire: a copy of a CUDA tensor in pinned
    host memory under gloo, else ``t`` itself (contiguous)."""
    if t.is_cuda and gloo_transport(group):
        return torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
    return t.contiguous()


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """The reduction of ``t`` over ``group``, on ``t``'s device. May reduce
    ``t`` in place: pass a tensor nothing else reads."""
    if dist.get_world_size(group) == 1:
        return t
    w = _wire(t, group)
    dist.all_reduce(w, op=op, group=group)
    _seen("all-reduce", w, group)
    return w.to(t.device)


def all_gather(t, dim: int, group, device=None):
    """``group``'s tensors concatenated along ``dim`` in group-rank order,
    on ``device`` (None: ``t``'s)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t if device is None else t.to(device)
    w = _wire(t, group)
    # on the wire tensor's own device: the card's under NCCL, pinned host
    # memory under gloo staging a CUDA tensor, plain host memory else
    parts = [torch.empty(w.shape, dtype=w.dtype, device=w.device,
                         pin_memory=w.is_pinned()) for _ in range(n)]
    dist.all_gather(parts, w, group=group)
    device = t.device if device is None else torch.device(device)
    if parts[0].device == device:
        out = torch.cat(parts, dim=dim)
    else:
        # staged through host memory: each part straight into its place
        shape = list(w.shape)
        shape[dim] *= n
        out = torch.empty(shape, dtype=w.dtype, device=device)
        for i, part in enumerate(parts):
            out.narrow(dim, i * w.shape[dim], w.shape[dim]).copy_(part)
    _seen("all-gather", out, group)
    return out


def reduce_scatter(t, dim: int, group):
    """This rank's slice along ``dim`` of the SUM of ``t`` over ``group``
    (``t`` itself over one rank): a reduce-scatter under NCCL; under
    gloo, which has none, an all-reduce, then a copy of the slice."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    size, i = t.shape[dim] // n, dist.get_rank(group)
    if gloo_transport(group):
        return _fresh_sum(t, group).narrow(dim, i * size, size).clone()
    src = t.movedim(dim, 0).contiguous()
    out = torch.empty((size,) + src.shape[1:], dtype=t.dtype,
                      device=t.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    _seen("reduce-scatter", out, group)
    return out.movedim(0, dim)


# ------------------------------------------------ differentiable collectives
# The transposes of ``jax.lax.psum`` and ``all_gather`` that GSPMD applies
# when it differentiates through a split: training under the ``model``
# axis (``parallel.tensor.TensorParallel``) runs them under autograd.
def _fresh_sum(t, group):
    """The SUM of ``t`` over ``group`` as a new tensor (``all_reduce`` may
    reduce in place, and autograd may still read ``t``)."""
    if not (t.is_cuda and gloo_transport(group)):
        t = t.clone()
    return all_reduce(t, group)


class _RowSum(torch.autograd.Function):
    """The row-parallel sum: SUM forward; the gradient of the sum, whole
    on every rank, is each partial's."""

    @staticmethod
    def forward(ctx, t, group):
        return _fresh_sum(t, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Enter(torch.autograd.Function):
    """The entry of a split region: identity forward; each rank's
    gradient covers its part of the region only, so the gradients are
    summed over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return _fresh_sum(grad, ctx.group), None


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` forward; this rank's slice of the
    gradient backward."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.size = dim, t.shape[dim]
        ctx.index = dist.get_rank(group)
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.index * ctx.size, ctx.size), None, None


class _FsdpGather(torch.autograd.Function):
    """All-gather of stored slices along ``dim`` forward; the gradient of
    the whole leaf, summed over ``group`` (each rank's covers its own
    rows), narrowed to this rank's slice backward."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather(t, dim, group)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.dim, ctx.group), None, None


def _tracked(t) -> bool:
    """Whether autograd records an operation on ``t``."""
    return torch.is_grad_enabled() and t.requires_grad


def row_sum(t, group):
    """The SUM over ``group`` of a row-parallel product's partials, whose
    gradient passes through to each partial. Without autograd, the
    serving path's ``all_reduce``."""
    return _RowSum.apply(t, group) if _tracked(t) else all_reduce(t, group)


def enter(t, group):
    """``t`` itself, whose gradient is summed over ``group``: where a
    tensor every rank holds whole flows into compute that each rank does
    only its part of."""
    return _Enter.apply(t, group) if _tracked(t) else t


def gather(t, dim: int, group):
    """``all_gather`` along ``dim``, whose gradient is this rank's slice."""
    return _Gather.apply(t, dim, group) if _tracked(t) else all_gather(
        t, dim, group)


def fsdp_gather(t, dim: int, group):
    """``all_gather`` of stored slices along ``dim``, whose gradient is
    summed over ``group`` and narrowed to this rank's slice."""
    return _FsdpGather.apply(t, dim, group) if _tracked(t) else all_gather(
        t, dim, group)


def reduce_metrics(loss, metrics, group):
    """(loss, metrics) summed over ``group`` in one all-reduce of fp32."""
    names = sorted(metrics)
    vals = all_reduce(torch.stack([loss.float()] + [
        metrics[k].float() for k in names]), group)
    return vals[0], dict(zip(names, vals[1:]))


def _rotate(tensors, group):
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's, in one ``batch_isend_irecv``."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    sends = [_wire(t, group) for t in tensors]
    recvs = [torch.empty_like(s) for s in sends]
    # a meta tensor (the dry run) has nothing to send, and a fake group
    # has no point-to-point transport for it
    if not any(s.is_meta for s in sends):
        p2p = ([dist.P2POp(dist.isend, s, nxt, group) for s in sends]
               + [dist.P2POp(dist.irecv, r, prv, group) for r in recvs])
        for work in dist.batch_isend_irecv(p2p):
            work.wait()
    for r in recvs:
        _seen("collective-permute", r, group)
    return [r.to(t.device) for r, t in zip(recvs, tensors)]


def batch_rows(mesh, B: int):
    """(rows, group): this rank's rows of a batch of B and the group over
    the batch axes, when B divides over them as the reference's specs
    shard it; None when the batch stays whole (it does not divide, or the
    batch axes hold one rank)."""
    bax = batch_axes(mesh)
    total = mesh.size(*bax) if bax else 1
    if total == 1 or B % total:
        return None
    Bl = B // total
    i = mesh.index(*bax)
    return slice(i * Bl, (i + 1) * Bl), mesh.group(*bax)


# ------------------------------------------------------------- ring prefill
def _ring_body(q, k, v, mesh):
    """One rank's block of causal attention. q: (B, S_loc, H, hd); k/v:
    (B, S_loc, KVH, hd), the unrepeated GQA shards that rotate around the
    ring."""
    group = mesh.group(AXIS_MODEL)
    n, idx = mesh.shape[AXIS_MODEL], mesh.coords[AXIS_MODEL]
    B, Sl, H, hd = q.shape
    KVH = k.shape[2]
    G = H // KVH
    scale = 1.0 / (hd ** 0.5)
    dev = q.device
    qg = q.float().reshape(B, Sl, KVH, G, hd)
    o = torch.zeros((B, KVH, G, Sl, hd), dtype=torch.float32, device=dev)
    m = torch.full((B, KVH, G, Sl), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KVH, G, Sl), dtype=torch.float32, device=dev)
    qpos = idx * Sl + torch.arange(Sl, device=dev)
    for i in range(n):
        src = (idx - i) % n                    # whose KV block this rank holds
        # a block after the rank's own is masked whole: in the reference
        # it merges with weight exp(-1e30 - m) = 0, leaving (o, m, l) as
        # they are, so skipping it changes no value
        if src <= idx:
            s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
            if src == idx:
                kpos = src * Sl + torch.arange(Sl, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            mn = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            o = o * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype), v).float()
            l = l * alpha + p.sum(dim=-1)
            m = mn
        if i < n - 1:
            k, v = _rotate([k, v], group)
    out = o / torch.clamp(l, min=1e-30)[..., None]          # (B,KVH,G,Sl,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sl, H, hd).to(q.dtype)


def ring_attention(q, k, v, mesh):
    """Sequence-parallel causal attention. q: (B, S, H, hd); k/v: (B, S,
    KVH, hd) unrepeated, whole on every rank. Returns (B, S, H, hd),
    whole. S shards over the ``model`` axis; without a mesh, with one rank
    on that axis or when S does not divide, every rank attends over the
    whole sequence."""
    B, S = q.shape[:2]
    n = mesh_axis_size(mesh, AXIS_MODEL) if mesh is not None else 1
    if n == 1 or S % n:
        return prefill_attention(q, k, v)
    Sl = S // n
    i = mesh.coords[AXIS_MODEL]
    rows = batch_rows(mesh, B)
    b = rows[0] if rows else slice(None)
    seq = slice(i * Sl, (i + 1) * Sl)
    out = _ring_body(q[b, seq], k[b, seq], v[b, seq], mesh)
    out = all_gather(out, 1, mesh.group(AXIS_MODEL))
    return all_gather(out, 0, rows[1]) if rows else out


# -------------------------------------------------------- seq-sharded decode
def _insert(k, v, lengths, new_k, new_v, offset: int):
    """Write each row's new K/V at position ``lengths`` if it lands in this
    slice [offset, offset + S_loc), in place; a row whose position lies
    outside writes back the value it holds (the reference's ``in_range``
    rule), so a row at the cache's end writes nothing anywhere."""
    B, S_loc = k.shape[:2]
    local = lengths.long() - offset
    in_range = (local >= 0) & (local < S_loc)
    idx = (torch.arange(B, device=k.device), local.clamp(0, S_loc - 1))
    for dst, new in ((k, new_k), (v, new_v)):
        dst[idx] = torch.where(in_range[:, None, None], new.to(dst.dtype),
                               dst[idx])


def _partial(q, k, v, lengths, offset: int):
    """Attention of q (B, H, hd) over the local slice k/v (B, S_loc, KVH,
    hd) at positions <= lengths: (o, m, l) fp32, unnormalised."""
    B, S_loc, KVH, hd = k.shape
    G = q.shape[1] // KVH
    qg = q.reshape(B, KVH, G, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).float() / (hd ** 0.5)
    pos = offset + torch.arange(S_loc, device=k.device)
    valid = pos[None, :] <= lengths.long()[:, None]   # includes the new token
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)                                        # (B, KVH, G)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v.dtype), v).float()
    return o, m, l


def seq_sharded_decode_attention(q, k_cache, v_cache, lengths, new_k, new_v,
                                 mesh):
    """Decode attention with the cache sharded on the sequence over the
    ``model`` axis.

    q: (B, H, hd); k_cache/v_cache: this rank's slice (B, S_loc, KVH, hd)
    of the (B, S_loc * n, KVH, hd) cache, rank i holding positions
    [i * S_loc, (i + 1) * S_loc); lengths: (B,); new_k/new_v: (B, KVH, hd),
    the token to insert at ``lengths``. Writes the slice in place and
    returns (out (B, H, hd) whole, k_cache, v_cache). Without a mesh, or
    with one rank on the axis, the slice is the whole cache.
    """
    n = mesh_axis_size(mesh, AXIS_MODEL) if mesh is not None else 1
    offset = mesh.coords[AXIS_MODEL] * k_cache.shape[1] if n > 1 else 0
    _insert(k_cache, v_cache, lengths, new_k, new_v, offset)
    B, H, hd = q.shape
    rows = batch_rows(mesh, B) if n > 1 else None
    b = rows[0] if rows else slice(None)
    o, m, l = _partial(q[b], k_cache[b], v_cache[b], lengths[b], offset)
    if n > 1:
        group = mesh.group(AXIS_MODEL)
        mx = all_reduce(m.clone(), group, dist.ReduceOp.MAX)
        alpha = torch.exp(m - mx)
        # one SUM for both: o * alpha and l * alpha side by side
        ol = all_reduce(torch.cat([o * alpha[..., None],
                                   (l * alpha)[..., None]], dim=-1), group)
        o, l = ol[..., :hd], ol[..., hd]
    out = (o / torch.clamp(l, min=1e-30)[..., None]).reshape(
        o.shape[0], H, hd).to(q.dtype)
    if rows:
        out = all_gather(out, 0, rows[1])
    return out, k_cache, v_cache
