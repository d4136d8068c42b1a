"""Jamba 1.5 Large: hybrid Mamba+attention (1:7 interleave) with 16e MoE.

[arXiv:2403.19887; hf] 72L d_model=8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16e top-2; attention on 1 of every 8 layers, MoE on
alternate layers.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=True,
    n_experts=16,
    top_k=2,
    d_ff_expert=24576,
    moe_layer_period=2,
    ssm=True,
    attn_layer_period=8,
    attn_layer_offset=3,   # 1 attn per 8 layers (jamba placement)
    d_state=16,            # jamba uses mamba-1-style small state
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_groups=1,
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
