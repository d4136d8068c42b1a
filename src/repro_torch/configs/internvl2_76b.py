"""InternVL2 76B: InternViT (stub frontend) + LLaMA3-70B-class backbone.

[arXiv:2404.16821; unverified] 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256. The vision tower is a STUB: input_specs() provides
precomputed patch embeddings at d_model.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    vision_stub=True,
    n_patches=1024,
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
