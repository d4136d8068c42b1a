"""Nemotron-4 15B: dense GQA decoder with squared-ReLU MLP.

[arXiv:2402.16819; unverified] 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000. Plain (ungated) MLP with squared-ReLU activation.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp_act="sq_relu",
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
