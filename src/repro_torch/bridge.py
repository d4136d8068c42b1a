"""Weights for the port: carried over from the JAX package, or drawn anew.

``params_from_jax`` converts the JAX package's param tree, handed over as
numpy arrays, into the port's nested dict of tensors, leaf for leaf; the
tests use it to run both packages on the same weights. ``init_params``
draws weights with a ``torch.Generator`` under the same shapes and laws as
``repro.models.module.Scope.param``; it cannot reproduce ``jax.random``'s
draws, so parity runs use ``params_from_jax``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.blocks import check_supported
from repro_torch.models.lm import DTYPES, resolve_device, tree_map


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


def param_specs(cfg):
    """Nested dict of (per-layer shape, init law) with the JAX names.

    Laws: ``fan_in`` normal with std 1/sqrt(shape[-2]), ``normal`` with
    std 0.02, ``ones`` and ``zeros`` (``repro.models.module``).
    """
    check_supported(cfg)
    d, ncb, vp = cfg.d_model, max(1, cfg.n_codebooks), cfg.vocab_padded
    attn = {"wq": ((d, cfg.q_dim), "fan_in"),
            "wk": ((d, cfg.kv_dim), "fan_in"),
            "wv": ((d, cfg.kv_dim), "fan_in"),
            "wo": ((cfg.q_dim, d), "fan_in")}
    if cfg.qkv_bias:
        attn.update(bq=((cfg.q_dim,), "zeros"), bk=((cfg.kv_dim,), "zeros"),
                    bv=((cfg.kv_dim,), "zeros"))
    if cfg.qk_norm:
        attn.update(q_norm=((cfg.head_dim,), "ones"),
                    k_norm=((cfg.head_dim,), "ones"))
    block = {"norm1": ((d,), "ones"), "attn": attn}
    if cfg.d_ff > 0:
        mlp = {"w_in": ((d, cfg.d_ff), "fan_in")}
        if cfg.mlp_act == "swiglu":
            mlp["w_gate"] = ((d, cfg.d_ff), "fan_in")
        mlp["w_out"] = ((cfg.d_ff, d), "fan_in")
        block.update(norm2=((d,), "ones"), mlp=mlp)
    return {"embed": ((ncb, vp, d), "normal"),
            "head": ((ncb, d, vp), "fan_in"),
            "final_norm": ((d,), "ones"),
            "blocks": {f"pos{i}": block for i in range(cfg.pattern_period)}}


def init_params(cfg, generator: torch.Generator, device=None):
    """Fresh weights on ``device`` (the card by default) from ``generator``,
    which must live on the same device. Block leaves carry the stacked
    leading ``R`` axis; the fan of a stacked weight is its per-layer
    ``shape[-2]``. Draws are fp32, then cast to ``cfg.dtype``."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.dtype]
    repeats = cfg.n_layers // cfg.pattern_period

    def make(shape, law, stack):
        full = ((stack,) if stack else ()) + shape
        if law == "zeros":
            return torch.zeros(full, dtype=dtype, device=device)
        if law == "ones":
            return torch.ones(full, dtype=dtype, device=device)
        std = 0.02 if law == "normal" else shape[-2] ** -0.5
        draw = torch.randn(full, generator=generator, dtype=torch.float32,
                           device=device)
        return draw.mul_(std).to(dtype)

    def build(spec, stack):
        return {k: build(v, stack) if isinstance(v, dict) else make(*v, stack)
                for k, v in spec.items()}

    specs = param_specs(cfg)
    blocks = specs.pop("blocks")
    params = build(specs, None)
    params["blocks"] = build(blocks, repeats)
    return params
