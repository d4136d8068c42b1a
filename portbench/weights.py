"""The cell's weights, drawn from the seed on the device.

The benchmark makes the weights itself and hands the same tensors to the
program (``repro_torch.models.lm.LM`` takes the nested dict as is) and to
the plain reference, which reads them only to upcast its own copies.
Every leaf is one ``torch.randn`` call in the served dtype on a generator
that lives on the device, so an arctic cut's 27.7 B parameters cost a
few large calls and no host traffic. The layout is the port's nested
dict (``embed``, ``head``, ``final_norm`` and ``blocks/pos{i}`` with the
stacked layer axis); the draw laws are its ``bridge.param_specs``:
normal(0, 0.02) for the embedding, normal(0, 1/fan_in) for every
matrix, ones for the norms.
"""
from __future__ import annotations

import math

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def vocab_padded(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def specs(m: dict) -> dict:
    """Nested dict of (shape, law, dtype name or None) for a model section
    of a configuration file (attention blocks; dense MLP or MoE with a
    dense residual)."""
    d, hd = m["d_model"], m["head_dim"]
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    ncb, vp = max(1, m.get("n_codebooks", 1)), vocab_padded(m)
    R = m["n_layers"]

    def mlp(f):
        return {"w_in": ((R, d, f), "fan_in", None),
                "w_gate": ((R, d, f), "fan_in", None),
                "w_out": ((R, f, d), "fan_in", None)}

    block = {"norm1": ((R, d), "ones", None),
             "attn": {"wq": ((R, d, q), "fan_in", None),
                      "wk": ((R, d, kv), "fan_in", None),
                      "wv": ((R, d, kv), "fan_in", None),
                      "wo": ((R, q, d), "fan_in", None)},
             "norm2": ((R, d), "ones", None)}
    if m.get("n_experts", 0):
        E, f = m["n_experts"], m["d_ff_expert"]
        block["moe"] = {"router": ((R, d, E), "fan_in", "float32"),
                        "w_in": ((R, E, d, f), "fan_in", None),
                        "w_out": ((R, E, f, d), "fan_in", None),
                        "w_gate": ((R, E, d, f), "fan_in", None)}
        if m.get("dense_residual"):
            block["dense_mlp"] = mlp(m["d_ff"])
    else:
        block["mlp"] = mlp(m["d_ff"])
    return {"embed": ((ncb, vp, d), "embed", None),
            "head": ((ncb, d, vp), "fan_in", None),
            "final_norm": ((d,), "ones", None),
            "blocks": {"pos0": block}}


def make(m: dict, seed: int, device) -> dict:
    """The weights of model section ``m`` from ``seed``, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dtype = DTYPES[m["dtype"]]

    def leaf(spec):
        shape, law, dt = spec
        dt = DTYPES[dt] if dt else dtype
        if law == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        t = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return t.mul_(0.02 if law == "embed" else 1 / math.sqrt(shape[-2]))

    def build(tree):
        return {k: build(v) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}

    return build(specs(m))

