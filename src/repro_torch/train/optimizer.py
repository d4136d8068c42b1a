"""AdamW built from scratch, with ZeRO-1 moments (``repro.train.optimizer``).

Moments are stored in ``moment_dtype`` (bf16 by default: optimizer state
of 3x the bf16 params, not 12x); the update math runs in fp32 whatever the
storage dtype. The global-norm clip and the schedule are computed in fp32,
as the JAX package computes them. The update writes params and moments in
place under ``torch.no_grad``, a leaf whose fp32 temporaries would exceed
``SLICE_LIMIT_BYTES`` slice by slice along its leading axis (elementwise
math: the same values as one pass).

ZeRO-1: under a data mesh with ``ParallelConfig.zero1`` a rank keeps only
its slice of ``m`` and ``v``: the one that the ``fsdp_tp`` rules give it
over the batch axes (``parallel.fsdp.BatchCuts``), as the reference's
``state_specs`` shard its moment storage. A leaf with no such dim keeps
whole moments. The update runs on the matching slice of a whole
parameter, which is then all-gathered along that dim. The reference
leaves this dataflow (reduce-scatter, update, all-gather) to GSPMD; the
port writes it out. ``AdamW.apply`` is elementwise, so the slices'
updates are the whole update's bits.

Under a ``model`` axis of more than one rank the params are the rank's
slices (``bridge.ModelSplit``), and ZeRO-1 cuts the moments of each slice
along its ``embed`` dim over (``pod``, ``data``): the reference's
``opt_strategy = "fsdp_tp"`` for moments. The global norm sums the
slices' squares over ``model`` too (``AdamW.apply(split=)``).

Under FSDP storage (``strategy="fsdp_tp"``) the params are stored at the
moments' cuts, and a stored slice's gradient comes out of the forward's
gather already summed over the cut's batch axes (``models.lm``). The
update reads which is which from the shapes: a parameter of its moments'
shape is updated in place, with no all-gather; a gradient of that shape
is a slice, whose squares the global norm sums over the cut's axes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.models.lm import (
    DTYPES, sorted_tree_leaves, tree_leaves, tree_map)
from repro_torch.parallel.collectives import all_gather, all_reduce
from repro_torch.parallel.fsdp import BatchCuts

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
    """``t`` itself, or its blocks of rows along axis 0, each as many rows
    as keep one fp32 copy within SLICE_LIMIT_BYTES; a row that alone
    exceeds it is sliced the same way along its own axis 0. (A row at a
    time would be one set of kernels a row: qwen3-14b's embedding has
    151,936 rows.)"""
    if t.dim() > 1 and t.numel() * 4 > SLICE_LIMIT_BYTES:
        rows = max(1, SLICE_LIMIT_BYTES // (t[0].numel() * 4))
        for part in t.split(rows):
            yield from (_slices(part[0]) if rows == 1 else (part,))
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

    def init(self, params, zero: BatchCuts | None = None) -> TrainState:
        """Zero moments; under ``zero``, this rank's slices of them (a
        stored slice's moments take its shape)."""
        mdt = DTYPES[self.moment_dtype]
        device = next(tree_leaves(params))[1].device
        like = params if zero is None else zero.slice_tree(
            tree_map(lambda t: torch.empty(t.shape, device="meta"), params))

        def zeros(t):
            return torch.zeros(t.shape, dtype=mdt, device=device)

        return TrainState(step=0, params=params,
                          m=tree_map(zeros, like), v=tree_map(zeros, like))

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
    def apply(self, state: TrainState, grads, zero: BatchCuts | None = None,
              split=None) -> tuple[TrainState, dict]:
        """One update from ``grads`` (a nested dict laid out as the params,
        any float dtype: each slice is cast to fp32 here), in place, leaves
        in the reference's order. Returns (state, {"grad_norm", "lr"}),
        fp32 scalar tensors, grad_norm on the params' device.

        Under ``zero`` the moments are this rank's slices. A whole
        parameter's slice is updated and then all-gathered; a stored
        slice (FSDP storage) is updated in place. A gradient is the whole
        leaf's (every rank holds the reduced gradient) or this rank's
        slice (a reduce-scatter, or a stored slice's); the global norm
        sums the whole leaves in leaf order on every rank, and the
        slices' squares over their cut's batch axes, so each leaf counts
        once and every rank clips by the same scale.

        ``split`` (``bridge.ModelSplit``, under a ``model`` axis of more
        than one rank): the params of its ``split`` paths are this rank's
        slices over ``model``, and their squares are summed over
        ``model`` as well; a leaf every ``model`` rank holds whole counts
        once."""
        paths = [p for p, _ in sorted_tree_leaves(state.params)]
        leaves = list(zip(paths, _leaves(state.params), _leaves(grads),
                          _leaves(state.m), _leaves(state.v)))
        cut = split.split if split is not None else frozenset()
        # squares by (the batch axes a gradient slice is cut over, or ()
        # for a whole one; leaf split over model), each summed in leaf
        # order
        sums = {}
        for path, p, g, _, _ in leaves:
            sliced = zero is not None and zero.sliced(path, g.shape)
            key = (zero.cuts[path][1] if sliced else (), path in cut)
            for part in _slices(g):
                sums[key] = sums.get(key, 0) + part.float().square().sum()

        def total(*key):
            return torch.as_tensor(sums.get(key, 0), dtype=torch.float32,
                                   device=leaves[0][1].device)

        sq, sliced = total((), False), total((), True)
        for on in sorted({on for on, _ in sums if on}):
            # a slice's squares are summed over its cut's axes first
            both = all_reduce(torch.stack([total(on, False),
                                           total(on, True)]),
                              zero.mesh.group(*on))
            sq, sliced = sq + both[0], sliced + both[1]
        if cut:
            sq = sq + all_reduce(sliced, split.tp.group)
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
        for path, p, g, m, v in leaves:
            sharded = (zero is not None and zero.cuts[path] is not None
                       and not zero.sliced(path, p.shape))
            if sharded:
                p_all, p = p, zero.local(path, p)
                if not zero.sliced(path, g.shape):
                    g = zero.local(path, g)
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
            if sharded:
                p_all.copy_(all_gather(p, zero.cuts[path][0],
                                       zero.group(path)))
        state.step = step
        return state, {"grad_norm": gnorm, "lr": lr}
