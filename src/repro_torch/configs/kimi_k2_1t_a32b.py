"""Kimi K2: trillion-parameter MoE, 32B active.

[arXiv:2501.kimi2; unverified] 61L d_model=7168 64H (GQA kv=8) d_ff=2048
(expert width) vocab=163840, MoE 384e top-8.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=0,               # no dense MLP path; experts only
    vocab_size=163840,
    moe=True,
    n_experts=384,
    top_k=8,
    d_ff_expert=2048,
    moe_layer_period=1,
    n_shared_experts=1,   # always-on shared expert (K2-style)
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
