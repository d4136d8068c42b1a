"""Registry of the architectures the port serves: ``--arch <id>``.

Dense-attention archs only; the MoE (arctic, kimi-k2) and SSM/hybrid
(mamba2, jamba) archs join with their kernels in later slices.
"""
from __future__ import annotations

import importlib

# arch id -> module name
ARCHS = {
    "granite-3-8b": "granite_3_8b",
    "qwen2-7b": "qwen2_7b",
    "nemotron-4-15b": "nemotron_4_15b",
    "qwen3-14b": "qwen3_14b",
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
