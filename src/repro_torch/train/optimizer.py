"""AdamW built from scratch (``repro.train.optimizer``).

Moments are stored in ``moment_dtype`` (bf16 by default: optimizer state
of 3x the bf16 params, not 12x); the update math runs in fp32 whatever the
storage dtype. The global-norm clip and the schedule are computed in fp32,
as the JAX package computes them. The update writes params and moments in
place under ``torch.no_grad``, a leaf whose fp32 temporaries would exceed
``SLICE_LIMIT_BYTES`` slice by slice along its leading axis (elementwise
math: the same values as one pass).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.lm import DTYPES, sorted_tree_leaves, tree_map

# A leaf whose fp32 copy exceeds this is clipped and updated in slices
# along its leading axis: musicgen-large's stacked MLP leaves (48, 2048,
# 8192) would otherwise take 3.2 GB per fp32 temporary.
SLICE_LIMIT_BYTES = 2**30


@dataclass
class TrainState:
    """``step`` counts applied updates; ``params``, ``m`` and ``v`` are
    nested dicts of tensors with one layout."""
    step: int
    params: dict
    m: dict
    v: dict


def _slices(t):
    """``t`` itself, or its slices along axis 0 while one fp32 copy of a
    slice exceeds SLICE_LIMIT_BYTES."""
    if t.dim() > 1 and t.numel() * 4 > SLICE_LIMIT_BYTES:
        for part in t:
            yield from _slices(part)
    else:
        yield t


def _leaves(tree):
    return [t for _, t in sorted_tree_leaves(tree)]


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    min_lr_frac: float = 0.1
    moment_dtype: str = "bfloat16"

    def init(self, params) -> TrainState:
        mdt = DTYPES[self.moment_dtype]

        def zeros(t):
            return torch.zeros(t.shape, dtype=mdt, device=t.device)

        return TrainState(step=0, params=params, m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def schedule(self, step) -> torch.Tensor:
        """Linear warmup then cosine decay to min_lr_frac: an fp32 scalar
        tensor on the CPU."""
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = torch.clamp(step / max(self.warmup_steps, 1), max=1.0)
        t = torch.clamp((step - self.warmup_steps)
                        / max(self.total_steps - self.warmup_steps, 1),
                        0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        frac = self.min_lr_frac + (1 - self.min_lr_frac) * cos
        return self.lr * warm * frac

    @torch.no_grad()
    def apply(self, state: TrainState, grads) -> tuple[TrainState, dict]:
        """One update from ``grads`` (a nested dict laid out as the params,
        any float dtype: each slice is cast to fp32 here), in place, leaves
        in the reference's order. Returns (state, {"grad_norm", "lr"}),
        fp32 scalar tensors, grad_norm on the params' device."""
        leaves = list(zip(_leaves(state.params), _leaves(grads),
                          _leaves(state.m), _leaves(state.v)))
        sq = sum(part.float().square().sum()
                 for _, g, _, _ in leaves for part in _slices(g))
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(self.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
        step = state.step + 1
        lr = self.schedule(step)
        stepf = torch.tensor(step, dtype=torch.float32)
        bc1 = 1 - self.b1 ** stepf
        bc2 = 1 - self.b2 ** stepf
        b1, b2, eps, wd = self.b1, self.b2, self.eps, self.weight_decay
        dev_lr, bc1_d, bc2_d = (t.to(gnorm.device) for t in (lr, bc1, bc2))
        for p, g, m, v in leaves:
            for ps, gs, ms, vs in zip(_slices(p), _slices(g), _slices(m),
                                      _slices(v)):
                gf = gs.float() * scale
                mf = b1 * ms.float() + (1 - b1) * gf
                vf = b2 * vs.float() + (1 - b2) * gf.square()
                u = (mf / bc1_d) / (torch.sqrt(vf / bc2_d) + eps)
                u = u + wd * ps.float()
                ps.copy_(ps.float() - dev_lr * u)
                ms.copy_(mf)
                vs.copy_(vf)
        state.step = step
        return state, {"grad_norm": gnorm, "lr": lr}
