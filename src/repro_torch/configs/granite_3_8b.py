"""IBM Granite 3 8B: dense GQA decoder.

[hf:ibm-granite/granite-3.0-2b-base; hf] 40L d_model=4096 32H (GQA kv=8)
d_ff=12800 vocab=49155.
"""
from repro_torch.configs.base import ModelConfig, smoke_reduce

CONFIG = ModelConfig(
    name="granite-3-8b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=12800,
    vocab_size=49155,
    rope_theta=1e6,
)

SMOKE_CONFIG = smoke_reduce(CONFIG)
