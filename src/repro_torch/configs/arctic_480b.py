"""Snowflake Arctic 480B: 128-expert top-2 MoE with parallel dense residual.

[hf:Snowflake/snowflake-arctic-base; hf] 35L d_model=7168 56H (GQA kv=8)
d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual MLP on every layer.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,            # dense residual MLP width
    vocab_size=32000,
    moe=True,
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    moe_layer_period=1,
    dense_residual=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
