"""Weights for the port: carried over from the JAX package, or drawn anew.

``params_from_jax`` converts the JAX package's param tree, handed over as
numpy arrays, into the port's nested dict of tensors, leaf for leaf, and
``state_from_jax`` a JAX ``TrainState`` into the port's; the tests use
them to run both packages on the same weights and optimizer state.
``init_params`` draws weights with a ``torch.Generator`` under the same
shapes, laws, scales and dtypes as ``repro.models.module.Scope.param``; it
cannot reproduce ``jax.random``'s draws, so parity runs use
``params_from_jax``.

``param_axes`` is the port's copy of the logical axes that ``Scope.param``
records for every leaf (``parallel.sharding`` places them). Given a mesh
(and the ``ParallelConfig`` the model will serve under), both
``params_from_jax`` and ``init_params`` keep only this rank's slice of
each leaf that the reference's ``resolve_spec`` cuts over the ``model``
axis (``shard_leaf``): the MoE experts and the router's columns,
attention's flattened heads (mid-head where the columns fall so), the
MLP, the vocab, and the Mamba2 leaves that ``parallel.tensor.
tensor_plan`` splits. ``init_params`` still draws the
whole stream, so a sharded model's weights are exactly the slices of the
single-rank model's. Training under the ``model`` axis holds the same
slices: ``ModelSplit`` takes a rank's slices of whole leaves (a
checkpoint's, the moments) and joins them back into whole arrays.

Under ``ParallelConfig(strategy="fsdp_tp")`` on a mesh with batch axes,
a rank stores less: its ``model`` slice of each leaf, cut again along
the dim that the ``fsdp_tp`` rules place on the batch axes
(``parallel.fsdp.fsdp_plan``, ZeRO-1's cut): every leaf with an
``embed`` dim that divides. ``storage_cuts`` gives both cuts; the
forward passes gather the rest while a layer runs (``models.lm``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.models.lm import DTYPES, resolve_device, tree_leaves
from repro_torch.parallel.collectives import all_gather
from repro_torch.parallel.fsdp import fsdp_plan, unflatten
from repro_torch.parallel.sharding import AXIS_MODEL, leaf_axes, resolve_spec
from repro_torch.parallel.tensor import TensorParallel, tensor_plan
from repro_torch.train.optimizer import TrainState

# A leaf whose fp32 draw would exceed this is drawn in slices along its
# leading (layer, expert) axes, straight into the leaf: arctic's stacked
# expert weights would otherwise need a 36 GB fp32 draw beside the rest.
DRAW_LIMIT_BYTES = 4 * 2**30


def _to_tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":        # ml_dtypes: numpy has no bf16
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _map_with_path(fn, tree, path=""):
    """``fn(path, leaf)`` over the leaves of nested dicts and tuples,
    '/'-joined paths (a tuple's items by index)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_with_path(fn, v, f"{path}/{i}")
                     for i, v in enumerate(tree))
    return fn(path, tree)


def params_from_jax(tree, device=None, *, mesh=None, cfg=None,
                    parallel=None):
    """A nested dict (or tuple) of arrays (JAX leaves through
    ``np.asarray``) -> the same tree of tensors on ``device``. bf16 leaves
    cross as an int16 view of their bits, so they arrive bit for bit. With
    ``mesh`` (``launch.mesh.Mesh``), the model's ``cfg`` and the
    ``ParallelConfig`` it will serve under (the default if None), a leaf
    keeps the slice this rank stores (``storage_cuts``)."""
    device = resolve_device(device)
    if mesh is not None and cfg is None:
        raise ValueError("params_from_jax(mesh=...) needs the model's cfg: "
                         "which leaves split depends on its head counts")
    cuts = storage_cuts(cfg, mesh, parallel)

    def convert(path, a):
        a = np.asarray(a)
        for dim, lo, hi in cuts(path, a.shape):
            a = a[(slice(None),) * dim + (slice(lo, hi),)]
        return _to_tensor(a, device)

    return _map_with_path(convert, tree)


def param_axes(cfg):
    """Nested dict of each leaf's logical axes: the reference's
    ``LM(cfg).init(None, abstract=True)[1]``."""
    return _build(cfg, lambda full, spec, path: leaf_axes(path))


def shard_leaf(path: str, shape, mesh, tp: TensorParallel):
    """(dim, start, stop) of the slice of leaf ``path`` (of ``shape``)
    that this rank of ``mesh`` holds, or None when it holds it whole: the
    one place that cuts a leaf over ``model``.

    A leaf is cut along the dim where ``resolve_spec`` places the
    ``model`` axis, into equal parts, when ``tp`` (``parallel.tensor.
    tensor_plan``, whose fields the compute reads too) cuts its family:
    the experts (the expert weights' leading ``experts`` dim and the
    router's columns, ``tp.experts``), attention's flattened ``q_dim``
    (``wq``, ``bq``, ``wo``'s rows) and ``kv_dim`` (``wk``, ``wv``,
    ``bk``, ``bv``; ``tp.attn_cut``), mid-head where the columns fall so,
    an MLP's hidden units, the vocab, and Mamba2's inner channels
    and heads. Attention and the experts are cut wherever
    ``resolve_spec`` cuts them; a Mamba2 whose heads would split its B/C
    groups is kept whole (``tp.ssm``)."""
    if mesh.shape.get(AXIS_MODEL, 1) == 1:
        return None
    axes = leaf_axes(path)
    spec = resolve_spec(axes, tuple(shape), mesh)
    on_model = [d for d, at in enumerate(spec)
                if AXIS_MODEL in ((at,) if isinstance(at, str) else
                                  (at or ()))]
    if not on_model:
        return None
    dim = on_model[0]
    name = axes[dim]
    split = {"experts": tp.experts, "heads": tp.attn_cut,
             "kv_heads": tp.attn_cut, "mlp": tp.mlp(shape[dim]),
             "vocab": tp.vocab, "ssm_inner": tp.ssm}.get(name, False)
    if not split:
        return None
    return (dim,) + tp.part(shape[dim])


def storage_cuts(cfg, mesh, parallel=None):
    """``cuts(path, full shape)``: the (dim, start, stop) cuts, in dim
    order, of the slice of a leaf that this rank of ``mesh`` stores under
    ``parallel`` (the default if None): its ``model`` slice
    (``shard_leaf``), and under ``fsdp_tp`` ZeRO-1's cut over the batch
    axes (``fsdp_plan``), which lies on another dim. No cut: whole."""
    if mesh is None:
        return lambda path, full: ()
    tp = tensor_plan(cfg, mesh, parallel)
    fsdp = fsdp_plan(cfg, mesh, parallel)

    def cuts(path, full):
        out = [shard_leaf(path, full, mesh, tp),
               fsdp.part(path, full) if fsdp is not None else None]
        return tuple(sorted(c for c in out if c is not None))

    return cuts


class ModelSplit:
    """This rank's slices of a model's param leaves under ``mesh``'s
    ``model`` axis, for training: the leaves and cuts ``shard_leaf`` gives
    under ``tensor_plan(cfg, mesh, parallel)``, as serving splits them.

    ``cuts[path]`` is (dim, start, stop) of the rank's slice, or None for
    a leaf every rank holds whole; ``split`` the paths of the cut leaves;
    ``tp`` the rank's ``TensorParallel``. ``slice_tree`` takes the rank's
    slices of whole leaves (the optimizer's moments and params share the
    layout), and ``gather_tree`` joins the ranks' slices into whole
    leaves over ``model`` (a collective: every rank calls it, in the same
    order), so the JAX package's whole arrays go in and come back out."""

    def __init__(self, cfg, mesh, parallel=None):
        self.tp = tensor_plan(cfg, mesh, parallel)
        self.cuts = {path: shard_leaf(path, t.shape, mesh, self.tp)
                     for path, t in tree_leaves(meta_params(cfg))}
        self.split = frozenset(p for p, cut in self.cuts.items() if cut)

    def local(self, path: str, t):
        """This rank's slice of the whole leaf ``t`` at ``path`` (a view),
        or ``t`` itself."""
        cut = self.cuts[path]
        return t if cut is None else t.narrow(cut[0], cut[1], cut[2] - cut[1])

    def slice_tree(self, tree):
        """Each whole leaf's slice, as its own tensor."""
        paths, leaves = zip(*tree_leaves(tree))
        return unflatten(paths, [t if self.cuts[p] is None
                                 else self.local(p, t).clone()
                                 for p, t in zip(paths, leaves)])

    def gather_tree(self, tree, device=None):
        """The whole leaves of a tree of this rank's slices, on ``device``
        (None: each slice's; a checkpoint gathers to the host)."""
        paths, leaves = zip(*tree_leaves(tree))
        return unflatten(paths, [
            (t if device is None else t.to(device)) if self.cuts[p] is None
            else all_gather(t.detach(), self.cuts[p][0], self.tp.group,
                            device)
            for p, t in zip(paths, leaves)])


def _spec(shape, law="fan_in", scale=1.0, dtype=None):
    """(per-layer shape, law, scale, dtype); dtype None is the model's."""
    return (tuple(shape), law, scale, dtype)


def _mlp_specs(cfg, d_ff):
    d = cfg.d_model
    mlp = {"w_in": _spec((d, d_ff))}
    if cfg.mlp_act == "swiglu":
        mlp["w_gate"] = _spec((d, d_ff))
    mlp["w_out"] = _spec((d_ff, d))
    return mlp


def _attn_specs(cfg):
    d = cfg.d_model
    attn = {"wq": _spec((d, cfg.q_dim)), "wk": _spec((d, cfg.kv_dim)),
            "wv": _spec((d, cfg.kv_dim)), "wo": _spec((cfg.q_dim, d))}
    if cfg.qkv_bias:
        attn.update(bq=_spec((cfg.q_dim,), "zeros"),
                    bk=_spec((cfg.kv_dim,), "zeros"),
                    bv=_spec((cfg.kv_dim,), "zeros"))
    if cfg.qk_norm:
        attn.update(q_norm=_spec((cfg.head_dim,), "ones"),
                    k_norm=_spec((cfg.head_dim,), "ones"))
    return attn


def _mamba_specs(cfg):
    """``repro.models.ssm.mamba_init``."""
    d, di, nh, k = cfg.d_model, cfg.d_inner, cfg.n_ssm_heads, cfg.conv_dim
    bc = cfg.ssm_groups * cfg.d_state
    f32 = torch.float32
    return {"w_z": _spec((d, di)), "w_x": _spec((d, di)),
            "w_B": _spec((d, bc)), "w_C": _spec((d, bc)),
            "w_dt": _spec((d, nh)),
            "conv_x": _spec((k, di)), "conv_B": _spec((k, bc)),
            "conv_C": _spec((k, bc)),
            "a_log": _spec((nh,), "normal", 0.5, f32),
            "d_skip": _spec((nh,), "ones", dtype=f32),
            "dt_bias": _spec((nh,), "zeros", dtype=f32),
            "norm": _spec((di,), "ones"),
            "w_out": _spec((di, d))}


def _moe_specs(cfg):
    """``repro.models.moe.moe_init``."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    moe = {"router": _spec((d, e), dtype=torch.float32),
           "w_in": _spec((e, d, f)), "w_out": _spec((e, f, d))}
    if cfg.mlp_act == "swiglu":
        moe["w_gate"] = _spec((e, d, f))
    return moe


def _block_specs(cfg, i):
    """``repro.models.blocks.block_init`` at pattern position i."""
    d = cfg.d_model
    block = {"norm1": _spec((d,), "ones")}
    if cfg.block_kind(i) == "attn":
        block["attn"] = _attn_specs(cfg)
    else:
        block["mamba"] = _mamba_specs(cfg)
    if cfg.d_ff > 0 or cfg.is_moe_layer(i):
        block["norm2"] = _spec((d,), "ones")
    if cfg.is_moe_layer(i):
        block["moe"] = _moe_specs(cfg)
        if cfg.dense_residual and cfg.d_ff > 0:
            block["dense_mlp"] = _mlp_specs(cfg, cfg.d_ff)
        if cfg.n_shared_experts > 0:
            block["shared_mlp"] = _mlp_specs(
                cfg, cfg.n_shared_experts * cfg.d_ff_expert)
    elif cfg.d_ff > 0:
        block["mlp"] = _mlp_specs(cfg, cfg.d_ff)
    return block


def param_specs(cfg):
    """Nested dict of (per-layer shape, law, scale, dtype) with the JAX
    names, for every layer kind (``repro.models.module.Scope.param``).

    Laws: ``fan_in`` normal with std scale/sqrt(fan), the fan being
    shape[-2] (shape[0] for a vector); ``normal`` with std scale;
    ``ones`` and ``zeros``. dtype None is the model's ``cfg.dtype``; the
    router, ``a_log``, ``d_skip`` and ``dt_bias`` are fp32.
    """
    d, ncb, vp = cfg.d_model, max(1, cfg.n_codebooks), cfg.vocab_padded
    return {"embed": _spec((ncb, vp, d), "normal", 0.02),
            "head": _spec((ncb, d, vp)),
            "final_norm": _spec((d,), "ones"),
            "blocks": {f"pos{i}": _block_specs(cfg, i)
                       for i in range(cfg.pattern_period)}}


def _fill_normal(out, std, generator, shape=None, keep=()):
    """Draw a leaf of ``shape`` (``out``'s by default) from N(0, std^2)
    in fp32, in slices along the leading axes while a slice's fp32 draw
    exceeds DRAW_LIMIT_BYTES, into ``out``.

    ``keep``: cuts (dim, start, stop), one a dim: ``out`` holds only that
    slice of the leaf. Every slice of the whole leaf is still drawn, in
    the same order, so the generator moves as for the whole leaf; what
    lies outside is dropped. ``out`` None: draw and drop everything."""
    shape = tuple(out.shape) if shape is None else tuple(shape)
    if len(shape) > 1 and math.prod(shape) * 4 > DRAW_LIMIT_BYTES:
        lo, hi = next(((a, b) for d, a, b in keep if d == 0),
                      (0, shape[0]))
        sub = tuple((d - 1, a, b) for d, a, b in keep if d > 0)
        for j in range(shape[0]):
            part = (out[j - lo] if out is not None and lo <= j < hi
                    else None)
            _fill_normal(part, std, generator, shape[1:], sub)
        return
    draw = torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).mul_(std)
    if out is not None:
        for dim, lo, hi in keep:
            draw = draw.narrow(dim, lo, hi - lo)
        out.copy_(draw)


def _build(cfg, make):
    """The param tree of ``cfg``, each leaf ``make(full shape, spec,
    path)``: block leaves carry the stacked leading ``R`` axis."""
    repeats = cfg.n_layers // cfg.pattern_period

    def build(spec, stack, prefix):
        return {k: build(v, stack, f"{prefix}{k}/") if isinstance(v, dict)
                else make(((stack,) if stack else ()) + v[0], v, prefix + k)
                for k, v in spec.items()}

    specs = param_specs(cfg)
    blocks = specs.pop("blocks")
    params = build(specs, None, "")
    params["blocks"] = build(blocks, repeats, "blocks/")
    return params


def _local(full, cuts):
    """The shape of a rank's slice ``cuts`` (none: whole) of ``full``."""
    local = list(full)
    for dim, lo, hi in cuts:
        local[dim] = hi - lo
    return local


def meta_params(cfg, *, mesh=None, parallel=None):
    """The param tree of ``cfg`` as meta tensors: shapes and dtypes only;
    with ``mesh`` (and ``parallel``), the shapes this rank stores."""
    cuts = storage_cuts(cfg, mesh, parallel)
    return _build(cfg, lambda full, spec, path: torch.empty(
        _local(full, cuts(path, full)),
        dtype=spec[3] or DTYPES[cfg.dtype], device="meta"))


def init_params(cfg, generator: torch.Generator, device=None, *, mesh=None,
                parallel=None):
    """Fresh weights on ``device`` (the card by default) from ``generator``,
    which must live on the same device. Block leaves carry the stacked
    leading ``R`` axis; the fan of a stacked weight is its per-layer
    ``shape[-2]``. Draws are fp32, then cast to the leaf's dtype. With
    ``mesh`` and the ``ParallelConfig`` the model will serve under (the
    default if None), a leaf keeps the slice of the same draws that this
    rank stores (``storage_cuts``)."""
    device = resolve_device(device)
    cuts = storage_cuts(cfg, mesh, parallel)

    def make(full, spec, path):
        shape, law, scale, dtype = spec
        dtype = dtype or DTYPES[cfg.dtype]
        cut = cuts(path, full)
        local = _local(full, cut)
        if law == "zeros":
            return torch.zeros(local, dtype=dtype, device=device)
        if law == "ones":
            return torch.ones(local, dtype=dtype, device=device)
        fan = shape[-2] if len(shape) >= 2 else shape[0]
        std = scale if law == "normal" else scale / fan ** 0.5
        out = torch.empty(local, dtype=dtype, device=device)
        _fill_normal(out, std, generator, full, cut)
        return out

    return _build(cfg, make)


def state_from_jax(state, device=None):
    """A JAX ``TrainState`` (step, params, m, v; leaves through
    ``np.asarray``) -> the port's ``TrainState`` on ``device`` (the card
    by default), leaf for leaf and bit for bit."""
    device = resolve_device(device)
    return TrainState(step=int(np.asarray(state.step)),
                      params=params_from_jax(state.params, device),
                      m=params_from_jax(state.m, device),
                      v=params_from_jax(state.v, device))
