"""Deterministic synthetic token pipeline (``repro.data.synthetic``).

The same numpy draws as the JAX package's, so a step's batch is equal bit
for bit in both packages; the arrays then become tensors on the device.
Each row is an arithmetic token sequence (stride 1-4, random phase), so
the cross entropy demonstrably falls; MusicGen's codebook streams get the
delay pattern, and the vision stub's rows get standard-normal patch
embeddings in the model's dtype.

``input_specs`` gives what a step consumes as meta tensors (the
reference's ``ShapeDtypeStruct`` specs): the dry run (``launch.cells``)
runs the port's steps on them.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.lm import DTYPES, resolve_device
from repro_torch.parallel.collectives import batch_rows


def _token_shape(cfg, B: int, S: int) -> tuple:
    if cfg.n_codebooks > 1:
        return (B, S, cfg.n_codebooks)
    return (B, S)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _text_len(cfg, S: int) -> int:
    return S - cfg.n_patches if cfg.vision_stub else S


def _rows(shape, mesh) -> int:
    """The batch rows of a spec: the global batch, or under ``mesh``
    this rank's rows where the batch divides over its batch axes
    (``parallel.collectives.batch_rows``)."""
    B = shape.global_batch
    rows = batch_rows(mesh, B) if mesh is not None else None
    return B if rows is None else rows[0].stop - rows[0].start


def train_input_specs(cfg, shape, mesh=None) -> dict:
    """tokens, targets (B, S_txt[, ncb]) int32, mask (B, S_txt) fp32
    and, with the vision stub, patches (B, Np, d) in the model's dtype."""
    B, S_txt = _rows(shape, mesh), _text_len(cfg, shape.seq_len)
    specs = {"tokens": _meta(_token_shape(cfg, B, S_txt), torch.int32),
             "targets": _meta(_token_shape(cfg, B, S_txt), torch.int32),
             "mask": _meta((B, S_txt), torch.float32)}
    if cfg.vision_stub:
        specs["patches"] = _meta((B, cfg.n_patches, cfg.d_model),
                                 DTYPES[cfg.dtype])
    return specs


def prefill_input_specs(cfg, shape, mesh=None) -> dict:
    B, S_txt = _rows(shape, mesh), _text_len(cfg, shape.seq_len)
    specs = {"tokens": _meta(_token_shape(cfg, B, S_txt), torch.int32)}
    if cfg.vision_stub:
        specs["patches"] = _meta((B, cfg.n_patches, cfg.d_model),
                                 DTYPES[cfg.dtype])
    return specs


def decode_input_specs(cfg, shape, mesh=None) -> dict:
    """One new token a row against a cache of capacity seq_len."""
    B = _rows(shape, mesh)
    return {"tokens": _meta(_token_shape(cfg, B, 1), torch.int32),
            "lengths": _meta((B,), torch.int32)}


def input_specs(cfg, shape, mesh=None) -> dict:
    """The batch of a ``shape.kind`` step as meta tensors: the global
    batch, which the port's steps take on every rank (a data-parallel
    train step takes its rows itself, serving keeps the batch whole), or
    with ``mesh`` this rank's rows of it, as the reference's specs shard
    them."""
    if shape.kind == "train":
        return train_input_specs(cfg, shape, mesh)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape, mesh)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape, mesh)
    raise ValueError(shape.kind)


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
