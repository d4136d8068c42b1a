"""Qwen3 14B: dense GQA decoder with QK-norm.

[hf:Qwen/Qwen3-8B; hf] 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
