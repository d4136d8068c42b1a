"""MusicGen Large: decoder-only over EnCodec tokens (4 codebooks).

[arXiv:2306.05284; hf] 48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048 per codebook. EnCodec itself is a stub; the backbone consumes
4 parallel token streams (summed embeddings) and emits 4 heads; the delay
pattern is applied by the data/serving layer.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    n_codebooks=4,
    rope_theta=1e4,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
