"""Deterministic synthetic token pipeline (``repro.data.synthetic``).

The same numpy draws as the JAX package's, so a step's batch is equal bit
for bit in both packages; the arrays then become tensors on the device.
Each row is an arithmetic token sequence (stride 1-4, random phase), so
the cross entropy demonstrably falls; MusicGen's codebook streams get the
delay pattern, and the vision stub's rows get standard-normal patch
embeddings in the model's dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import DTYPES, resolve_device


def _token_shape(cfg, B: int, S: int) -> tuple:
    if cfg.n_codebooks > 1:
        return (B, S, cfg.n_codebooks)
    return (B, S)


def apply_delay_pattern(tokens: np.ndarray, pad: int = 0) -> np.ndarray:
    """MusicGen delay pattern: codebook c shifted right by c steps."""
    B, S, C = tokens.shape
    out = np.full_like(tokens, pad)
    for c in range(C):
        out[:, c:, c] = tokens[:, : S - c, c]
    return out


def synthetic_batches(rcfg, device=None, mesh=None):
    """Returns batch_fn(step) -> {"tokens", "targets" (B, S[, ncb]) int32,
    "mask" (B, S) fp32[, "patches" (B, Np, d)]} on ``device`` (the card by
    default; under ``mesh``, its rank's device), S the text length
    (``seq_len - n_patches`` with the vision stub). The batch is the
    global one on every rank, as the reference's is: a data-parallel step
    takes its rows (``train.train_step``)."""
    if device is None and mesh is not None:
        device = mesh.device
    device = resolve_device(device)
    cfg = rcfg.model
    shape = rcfg.shape

    def batch_fn(step: int):
        rng = np.random.default_rng(rcfg.seed * 100003 + step)
        B, S = shape.global_batch, shape.seq_len
        S_txt = S - cfg.n_patches if cfg.vision_stub else S
        tshape = _token_shape(cfg, B, S_txt + 1)
        phase = rng.integers(0, cfg.vocab_size, (B,) + (1,) * (len(tshape) - 1))
        stride = rng.integers(1, 5, (B,) + (1,) * (len(tshape) - 1))
        t = np.arange(S_txt + 1).reshape(1, S_txt + 1,
                                         *([1] * (len(tshape) - 2)))
        toks = ((phase + stride * t) % cfg.vocab_size).astype(np.int32)
        toks = np.broadcast_to(toks, tshape).copy()
        if cfg.n_codebooks > 1:
            toks = apply_delay_pattern(toks)
        batch = {
            "tokens": torch.from_numpy(toks[:, :-1].copy()).to(device),
            "targets": torch.from_numpy(toks[:, 1:].copy()).to(device),
            "mask": torch.ones((B, S_txt), dtype=torch.float32,
                               device=device),
        }
        if cfg.vision_stub:
            patches = rng.standard_normal((B, cfg.n_patches, cfg.d_model),
                                          dtype=np.float32)
            batch["patches"] = torch.from_numpy(patches).to(
                device, DTYPES[cfg.dtype])
        return batch

    return batch_fn
