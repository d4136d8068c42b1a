"""Train-step builder: loss and gradients, microbatch accumulation, AdamW
(``repro.train.train_step``), on one card.

With ``microbatches > 1`` the batch splits along its rows; each
microbatch's gradients are added into a bf16 buffer (bf16 whatever the
params' dtype, as the reference's scan carries them), which is divided by
the count before the update. The loss is the mean over microbatches and
the other metrics are the last microbatch's. ``torch.autograd.grad``
returns each microbatch's gradients without touching ``.grad``, whose
accumulation would run in the params' dtype.
"""
from __future__ import annotations

import torch

from repro_torch.models.lm import LM, tree_leaves
from repro_torch.train.optimizer import AdamW, TrainState


def make_optimizer(rcfg) -> AdamW:
    return AdamW(
        lr=rcfg.learning_rate, b1=rcfg.adam_b1, b2=rcfg.adam_b2,
        eps=rcfg.adam_eps, weight_decay=rcfg.weight_decay,
        grad_clip=rcfg.grad_clip, warmup_steps=rcfg.warmup_steps,
        total_steps=rcfg.total_steps, moment_dtype=rcfg.moment_dtype)


def _unflatten(paths, values):
    out = {}
    for path, val in zip(paths, values):
        node = out
        *dirs, last = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = val
    return out


def build_train_step(lm: LM, rcfg):
    """Returns (train_step, opt); train_step(state, batch) -> (state,
    metrics) updates ``state`` (whose params must be ``lm.params``) in
    place, on the LM's device.

    Sets ``requires_grad`` on every param leaf; the serving passes run
    under ``torch.no_grad`` and are unaffected.
    """
    if rcfg.parallel.grad_compress_pod:
        raise ValueError("grad_compress_pod compresses a cross-pod gradient "
                         "all-reduce; the port trains on one card")
    opt = make_optimizer(rcfg)
    parallel = rcfg.parallel
    n_micro = parallel.microbatches
    paths, leaves = zip(*tree_leaves(lm.params))
    for t in leaves:
        t.requires_grad_(True)

    def grad_fn(batch):
        loss, metrics = lm.loss(batch, parallel)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), metrics, grads

    def train_step(state: TrainState, batch):
        if state.params is not lm.params:
            raise ValueError("the state's params are not the LM's")
        if n_micro <= 1:
            loss, metrics, grads = grad_fn(batch)
        else:
            rows = next(iter(batch.values())).shape[0]
            if rows % n_micro:
                raise ValueError(f"batch of {rows} rows does not split into "
                                 f"{n_micro} microbatches")
            size = rows // n_micro
            grads = [torch.zeros(t.shape, dtype=torch.bfloat16,
                                 device=t.device) for t in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=lm.device)
            for i in range(n_micro):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                mloss, metrics, g = grad_fn(mb)
                for acc, gi in zip(grads, g):
                    acc += gi.to(torch.bfloat16)
                del g
                loss = loss + mloss
            for acc in grads:      # apply casts each slice to fp32
                acc.div_(n_micro)
            loss = loss / n_micro
        state, opt_metrics = opt.apply(state, _unflatten(paths, grads))
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step, opt
