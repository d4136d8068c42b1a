"""Weights for the port: carried over from the JAX package, or drawn anew.

``params_from_jax`` converts the JAX package's param tree, handed over as
numpy arrays, into the port's nested dict of tensors, leaf for leaf, and
``state_from_jax`` a JAX ``TrainState`` into the port's; the tests use
them to run both packages on the same weights and optimizer state.
``init_params`` draws weights with a ``torch.Generator`` under the same
shapes, laws, scales and dtypes as ``repro.models.module.Scope.param``; it
cannot reproduce ``jax.random``'s draws, so parity runs use
``params_from_jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import DTYPES, resolve_device, tree_map
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


def params_from_jax(tree, device=None):
    """A nested dict of arrays (JAX leaves through ``np.asarray``) -> the
    same nested dict of tensors on ``device``. bf16 leaves cross as an
    int16 view of their bits, so they arrive bit for bit."""
    device = resolve_device(device)
    return tree_map(lambda a: _to_tensor(a, device), tree)


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


def _fill_normal(out, std, generator):
    """Draw ``out`` in place from N(0, std^2) in fp32, in slices along
    the leading axes while a slice's fp32 draw exceeds DRAW_LIMIT_BYTES."""
    if out.dim() > 1 and out.numel() * 4 > DRAW_LIMIT_BYTES:
        for part in out:
            _fill_normal(part, std, generator)
        return
    out.copy_(torch.randn(out.shape, generator=generator,
                          dtype=torch.float32, device=out.device).mul_(std))


def _build(cfg, make):
    """The param tree of ``cfg``, each leaf ``make(full shape, spec)``:
    block leaves carry the stacked leading ``R`` axis."""
    repeats = cfg.n_layers // cfg.pattern_period

    def build(spec, stack):
        return {k: build(v, stack) if isinstance(v, dict)
                else make(((stack,) if stack else ()) + v[0], v)
                for k, v in spec.items()}

    specs = param_specs(cfg)
    blocks = specs.pop("blocks")
    params = build(specs, None)
    params["blocks"] = build(blocks, repeats)
    return params


def meta_params(cfg):
    """The param tree of ``cfg`` as meta tensors: shapes and dtypes only."""
    return _build(cfg, lambda full, spec: torch.empty(
        full, dtype=spec[3] or DTYPES[cfg.dtype], device="meta"))


def init_params(cfg, generator: torch.Generator, device=None):
    """Fresh weights on ``device`` (the card by default) from ``generator``,
    which must live on the same device. Block leaves carry the stacked
    leading ``R`` axis; the fan of a stacked weight is its per-layer
    ``shape[-2]``. Draws are fp32, then cast to the leaf's dtype."""
    device = resolve_device(device)

    def make(full, spec):
        shape, law, scale, dtype = spec
        dtype = dtype or DTYPES[cfg.dtype]
        if law == "zeros":
            return torch.zeros(full, dtype=dtype, device=device)
        if law == "ones":
            return torch.ones(full, dtype=dtype, device=device)
        fan = shape[-2] if len(shape) >= 2 else shape[0]
        std = scale if law == "normal" else scale / fan ** 0.5
        out = torch.empty(full, dtype=dtype, device=device)
        _fill_normal(out, std, generator)
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
