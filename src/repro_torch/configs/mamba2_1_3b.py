"""Mamba2 1.3B: attention-free SSD (state-space duality) stack.

[arXiv:2405.21060; unverified] 48L d_model=2048 (attn-free) d_ff=0
vocab=50280, ssm_state=128; d_inner=2*d_model, head_dim=64.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm=True,
    attn_layer_period=0,   # no attention layers at all
    d_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    ssm_groups=1,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
