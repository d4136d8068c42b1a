"""Model FLOPs, frozen: the port's ``launch/flops.py`` headline
(``MODEL_FLOPS``: 2 x the active parameters a token served, 6 x the
parameters a token trained), over the parameter count of its
``ModelConfig.param_count`` for the block kinds the benchmark's
configurations have (attention; dense MLP, or MoE with a dense
residual), read from a configuration file's model section."""
from __future__ import annotations


def param_count(m: dict, active: bool = False) -> int:
    d, hd, V = m["d_model"], m["head_dim"], m["vocab_size"]
    ncb = m.get("n_codebooks", 1)
    q, kv = m["n_heads"] * hd, m["n_kv_heads"] * hd
    total = V * d * (2 if ncb <= 1 else 1 + ncb)
    if ncb > 1:
        total += (ncb - 1) * V * d
    n_mlp = 3
    per_layer = d * (q + 2 * kv) + q * d + 2 * d
    if m.get("n_experts", 0):
        e = m["top_k"] if active else m["n_experts"]
        per_layer += e * n_mlp * d * m["d_ff_expert"] + d * m["n_experts"]
        if m.get("dense_residual"):
            per_layer += n_mlp * d * m["d_ff"]
    else:
        per_layer += n_mlp * d * m["d_ff"]
    return total + m["n_layers"] * per_layer


def serve_flops(m: dict, tokens: int) -> float:
    return 2.0 * param_count(m, active=True) * tokens


def train_flops(m: dict, tokens: int) -> float:
    return 6.0 * param_count(m) * tokens
