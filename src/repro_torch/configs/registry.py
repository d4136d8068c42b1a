"""Registry of the architectures the port serves: ``--arch <id>``.

Every arch of ``repro.configs.registry``: dense attention, MoE (arctic,
kimi-k2), SSM (mamba2) and hybrid (jamba).
"""
from __future__ import annotations

import importlib

# arch id -> module name
ARCHS = {
    "arctic-480b": "arctic_480b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "granite-3-8b": "granite_3_8b",
    "qwen2-7b": "qwen2_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-14b": "qwen3_14b",
    "mamba2-1.3b": "mamba2_1_3b",
    "internvl2-76b": "internvl2_76b",
    "musicgen-large": "musicgen_large",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str):
    return _module(arch).CONFIG


def get_smoke_config(arch: str):
    return _module(arch).SMOKE_CONFIG
