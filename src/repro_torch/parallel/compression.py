"""Cross-pod int8 gradient compression (``repro.parallel.compression``).

A multi-pod mesh reduces gradients twice: within a pod over its ``data``
ranks, and across pods over the slow inter-pod links (``pod`` axis).
The pod reduction exchanges int8-quantized tensors, 4x fewer bytes than
an fp32 all-reduce. Quantization is per-tensor symmetric
round-to-nearest (half to even, as ``jnp.round`` and ``torch.round``
both round). Two pods exchange each one's ``q`` and scale and add the
two dequantized tensors, which cannot saturate int8; more pods quantize
against the largest scale over pods and sum the int8 payloads as int32.
Either way the result is the mean over pods.

The reference wraps its ``value_and_grad`` in a ``shard_map`` over
``pod``, so its loss, gradients and MoE statistics are each pod's; its
loss and metrics are then ``pmean``ed. ``build_pod_compressed_grad_fn``
wraps the port's per-rank gradient function the same way: the function
it wraps must already return its pod's loss, metrics and gradients,
reduced over the pod's ``data`` ranks (``train.train_step``). Under FSDP
storage a gradient may be a slice of its leaf; its scale is then the
whole leaf's, the largest |x| over the ranks that hold the other slices
(``wholes``), so the int8 grid is the reference's.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.parallel.collectives import (
    all_gather, all_reduce, reduce_metrics)
from repro_torch.parallel.sharding import AXIS_POD, mesh_axis_size


def _quantize(x, whole=None):
    """(q int8, scale fp32 scalar) of x: ``scale = max|x| / 127 + 1e-12``,
    q = round(x / scale) clipped to [-127, 127]. ``whole``: the process
    group whose ranks' x tile the tensor that is quantized (x a slice of
    it), whose largest |x| the scale takes; None: x is that tensor."""
    xf = x.float()
    top = xf.abs().max()
    if whole is not None:
        top = all_reduce(top, whole, dist.ReduceOp.MAX)
    scale = top / 127.0 + 1e-12
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _pod_sum_compressed(x, n_pods: int, group, whole=None):
    """The mean over ``group``'s pods of x, exchanged as int8, in x's
    dtype; ``whole`` as in ``_quantize``."""
    q, scale = _quantize(x, whole)
    if n_pods == 2:
        qs = all_gather(q[None], 0, group)
        ss = all_gather(scale[None], 0, group)
        other = 1 - dist.get_rank(group)
        out = (q.float() * scale
               + qs[other].float() * ss[other])
    else:
        s = all_reduce(scale.clone(), group, dist.ReduceOp.MAX)
        q = torch.clamp(torch.round(x.float() / s), -127, 127)
        out = all_reduce(q.to(torch.int32), group).float() * s
    return (out / n_pods).to(x.dtype)


def build_pod_compressed_grad_fn(grad_fn, mesh, wholes=None):
    """Wrap ``grad_fn(batch) -> (loss, metrics, grads)``, which returns
    this rank's pod's loss, metrics and gradients (a sequence of tensors),
    so that the gradients are averaged over pods through int8 and the loss
    and metrics are averaged over pods. ``wholes``: for each gradient,
    None, or the group whose ranks' gradients tile the leaf it is a slice
    of (``_quantize``: the leaf is quantized whole, as the reference's
    is). Without a ``pod`` axis of more than one rank, ``grad_fn``
    itself."""
    n_pods = mesh_axis_size(mesh, AXIS_POD) if mesh is not None else 1
    if n_pods == 1:
        return grad_fn
    group = mesh.group(AXIS_POD)

    def wrapped(batch):
        loss, metrics, grads = grad_fn(batch)
        grads = [_pod_sum_compressed(g, n_pods, group, whole)
                 for g, whole in zip(grads, wholes or [None] * len(grads))]
        loss, metrics = reduce_metrics(loss, metrics, group)
        return (loss / n_pods,
                {k: v / n_pods for k, v in metrics.items()}, grads)

    return wrapped
