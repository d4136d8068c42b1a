"""Train-step builder: loss and gradients, microbatch accumulation, AdamW
(``repro.train.train_step``), on one device or as one rank of a data
mesh.

With ``microbatches > 1`` the batch splits along its rows; each
microbatch's gradients are added into a bf16 buffer (bf16 whatever the
params' dtype, as the reference's scan carries them), which is divided by
the count before the update. The loss is the mean over microbatches and
the other metrics are the last microbatch's. ``torch.autograd.grad``
returns each microbatch's gradients without touching ``.grad``, whose
accumulation would run in the params' dtype.

Under a mesh (``launch.mesh.Mesh``) whose ``model`` axis holds one rank,
the step is data-parallel over the batch axes (``pod``, ``data``), and
computes the reference's global-batch step: the same loss, gradients and
update as one device, up to the order of the sums.

- Every rank is given the global batch. Microbatch i is the global rows
  ``[i * size, (i + 1) * size)``, and a rank takes its block of those
  rows, in the order of its index over the batch axes: where rows couple
  (the MoE capacity), the slots fill as on one device.
- A rank's loss is its share of the global loss (``LM.loss`` under the
  batch group); the shares' gradients accumulate locally and are summed
  over the batch group once, after the microbatches, as the reference
  defers its cross-``data`` reduction: a reduce-scatter onto the ZeRO-1
  slices where the backend has one (NCCL), else an all-reduce (gloo).
  The loss and metrics are summed once too.
- With ``zero1`` (the default) each rank keeps its slices of the moments
  (``parallel.fsdp.BatchCuts``).
- With ``grad_compress_pod`` on a mesh of two or more pods, the loss
  context is the pod's data ranks, as the reference's ``shard_map`` over
  ``pod`` makes it; each microbatch's gradients are summed over those
  ranks and averaged over pods through int8 (``parallel.compression``),
  as the reference's wrapped ``grad_fn`` does per microbatch. Without a
  pod axis the flag changes nothing, as in the reference.

Under a mesh whose ``model`` axis holds n > 1 ranks (``(model n)``,
``(data d, model n)`` or ``(pod, data, model)``, the ``tp`` strategy),
each rank holds and trains its slices of the leaves that serving splits
(``bridge.ModelSplit``: attention's columns, MLP columns, vocab rows,
Mamba2 heads, experts and router columns) and computes the loss with its
``model`` peers under autograd
(``LM.loss(rt=)``); the rows are its batch index's, as above. A split
leaf's gradient is the rank's slice, a whole leaf's is whole on every
``model`` rank, and each is summed over the batch axes of its own
``model`` index only (``reduce_grads``: the mesh's batch group), never
over ``model``. The clip norm sums the slices' squares over ``model``
(``AdamW.apply(split=)``) and ZeRO-1 cuts the moments of each slice. The
step is the reference's on the same mesh: one device's math, with the
MoE capacity per data shard where the experts split
(``models.moe.moe_train``).

With ``strategy="fsdp_tp"`` (FSDP storage, ``parallel.fsdp``) a
rank stores only its slice of every leaf that the ``fsdp_tp`` rules cut
over the batch axes, on top of its ``model`` slice, and the moments of
that slice; the math is the ``tp`` math. The loss gathers each layer's
slices while the layer runs (``models.lm``), and the gather's backward
sums a stored slice's gradient over the cut's batch axes, so
``reduce_grads`` sums such a leaf only over the batch axes its cut
leaves out (``pod``, where the size guard drops it). With microbatches
each microbatch's summed slice is added into a bf16 accumulator of the
slice's shape, as the reference accumulates in the storage sharding.
The update writes the stored slices in place, with no all-gather.

With pod compression under ``fsdp_tp`` each pod's loss reads its
chunks (``parallel.fsdp.PodChunks``), as the reference's ``shard_map``
over ``pod`` hands each pod its leaves whole over ``pod``: a layer's
gather then runs over the pod's ``data`` ranks, whose gradients its
backward sums, and each pod's gradient of a leaf is quantized against
the whole stacked leaf's scale (``parallel.compression``) before this
rank keeps its stored slice of the mean over pods. Pod compression
raises under a ``model`` axis of more than one rank, which the
reference's ``shard_map`` over ``pod`` does not run.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.bridge import ModelSplit, meta_params
from repro_torch.models.lm import LM, Runtime, tree_leaves
from repro_torch.parallel.collectives import (
    all_reduce, gloo_transport, reduce_metrics, reduce_scatter)
from repro_torch.parallel.compression import build_pod_compressed_grad_fn
from repro_torch.parallel.fsdp import (
    BatchCuts, PodChunks, fsdp_plan, unflatten)
from repro_torch.parallel.sharding import (
    AXIS_DATA, AXIS_MODEL, AXIS_POD, batch_axes, mesh_axis_size)
from repro_torch.train.optimizer import AdamW, TrainState

# An all-reduce of many gradient leaves goes in flat buckets of at most
# this many bytes: one collective a bucket, not one a leaf.
BUCKET_BYTES = 256 * 2**20


def make_optimizer(rcfg) -> AdamW:
    return AdamW(
        lr=rcfg.learning_rate, b1=rcfg.adam_b1, b2=rcfg.adam_b2,
        eps=rcfg.adam_eps, weight_decay=rcfg.weight_decay,
        grad_clip=rcfg.grad_clip, warmup_steps=rcfg.warmup_steps,
        total_steps=rcfg.total_steps, moment_dtype=rcfg.moment_dtype)


def check_data_mesh(mesh, parallel) -> None:
    """Raise for what the port does not train under yet, or what the
    reference does not run."""
    if mesh is None:
        return
    if (mesh_axis_size(mesh, AXIS_MODEL) > 1 and parallel.grad_compress_pod
            and mesh_axis_size(mesh, AXIS_POD) > 1):
        raise ValueError(
            f"grad_compress_pod with {mesh.shape[AXIS_MODEL]} ranks on the "
            "model axis: the reference's shard_map over pod does not run "
            "with model > 1 (its inner shardings name the manual pod "
            "axis), so there is no step to copy (ROADMAP queue 1)")


def model_split(rcfg, mesh) -> ModelSplit | None:
    """This rank's slices under ``mesh``'s ``model`` axis
    (``bridge.ModelSplit``), or None when that axis holds one rank."""
    if mesh is None or mesh_axis_size(mesh, AXIS_MODEL) == 1:
        return None
    return ModelSplit(rcfg.model, mesh, rcfg.parallel)


def zero_for(rcfg, mesh) -> BatchCuts | None:
    """The cuts over the batch axes that a run on ``mesh`` stores its
    moments by (``parallel.fsdp.BatchCuts``): with ``zero1``, and under
    ``fsdp_tp`` whatever ``zero1`` says, as the reference's
    ``state_specs`` place them; else None, as on one rank."""
    if mesh is None or not (rcfg.parallel.zero1
                            or rcfg.parallel.strategy == "fsdp_tp"):
        return None
    if math.prod(mesh.shape[a] for a in batch_axes(mesh)) == 1:
        return None
    return BatchCuts(rcfg.model, mesh)


def all_reduce_flat(tensors, group) -> list:
    """The sums over ``group`` of ``tensors``, in flat buckets of one
    dtype and at most ``BUCKET_BYTES``; new tensors, on each input's
    device."""
    out = [None] * len(tensors)
    i = 0
    while i < len(tensors):
        dtype, j, nbytes = tensors[i].dtype, i, 0
        while (j < len(tensors) and tensors[j].dtype == dtype
               and (j == i or nbytes + tensors[j].numel()
                    * tensors[j].element_size() <= BUCKET_BYTES)):
            nbytes += tensors[j].numel() * tensors[j].element_size()
            j += 1
        flat = all_reduce(torch.cat([t.reshape(-1) for t in tensors[i:j]]),
                          group)
        for k, part in zip(range(i, j), flat.split(
                [t.numel() for t in tensors[i:j]])):
            out[k] = part.view(tensors[k].shape)
        i = j
    return out


def summed_over(path: str, shape, mesh,
                zero: BatchCuts | None) -> tuple[str, ...]:
    """The batch axes that ``reduce_grads`` sums the gradient of leaf
    ``path``, of ``shape``, over: all of them, but for a stored slice
    (FSDP storage) only those that its cut leaves out (its gather's
    backward summed over the rest)."""
    bax = batch_axes(mesh)
    if zero is None or not zero.sliced(path, shape):
        return bax
    return tuple(a for a in bax if a not in zero.cuts[path][1])


def reduce_grads(grads, paths, mesh, zero: BatchCuts | None):
    """The gradients summed over the mesh's batch axes: each whole leaf's
    whole on every rank, or, under ZeRO-1 on a backend with a
    reduce-scatter (NCCL), this rank's slice of one that is cut over
    every batch axis. A stored slice's is summed only over the axes of
    ``summed_over`` (none, where its cut covers every batch axis)."""
    bax = batch_axes(mesh)
    group = mesh.group(*bax)
    scatter = (zero is not None and not gloo_transport(group)
               and dist.get_world_size(group) > 1)
    out = list(grads)
    rest = {}
    for k, (path, g) in enumerate(zip(paths, grads)):
        cut = (zero.cuts[path] if scatter and not zero.sliced(path, g.shape)
               else None)
        if cut is not None and cut[1] == bax:
            out[k] = reduce_scatter(g, cut[0], group)
            continue
        axes = summed_over(path, g.shape, mesh, zero)
        if axes:
            rest.setdefault(axes, []).append(k)
    for axes, ks in rest.items():
        for k, g in zip(ks, all_reduce_flat([grads[k] for k in ks],
                                            mesh.group(*axes))):
            out[k] = g
    return out


class _PodRuntime(Runtime):
    """The runtime of one pod's loss under pod compression with FSDP
    storage: the params it reads are ``PodChunks``' chunks."""

    def fsdp(self, cfg) -> PodChunks:
        return PodChunks(cfg, self.mesh)


def build_train_step(lm: LM, rcfg, mesh=None):
    """Returns (train_step, opt); train_step(state, batch) -> (state,
    metrics) updates ``state`` (whose params must be ``lm.params``) in
    place, on the LM's device. Under ``mesh`` every rank calls it with
    the global batch and gets the global metrics; build the state with
    ``opt.init(lm.params, zero)``, ``zero`` being ``train_step.zero``
    (None without ZeRO-1). Under a ``model`` axis of more than one rank,
    ``lm.params`` must be this rank's slices (``bridge.init_params`` or
    ``params_from_jax`` with the mesh and ``rcfg.parallel``), which
    ``train_step.split`` (``bridge.ModelSplit``, else None) names; so
    must they under ``fsdp_tp``, whose cuts over the batch axes
    ``train_step.zero`` names (``parallel.fsdp.BatchCuts``).

    Sets ``requires_grad`` on every param leaf; the serving passes run
    under ``torch.no_grad`` and are unaffected.
    """
    parallel = rcfg.parallel
    check_data_mesh(mesh, parallel)
    opt = make_optimizer(rcfg)
    n_micro = max(parallel.microbatches, 1)
    paths, leaves = zip(*tree_leaves(lm.params))
    split = model_split(rcfg, mesh)
    zero = zero_for(rcfg, mesh)
    fsdp = fsdp_plan(rcfg.model, mesh, parallel) is not None
    if split is not None or fsdp:
        want = dict(tree_leaves(meta_params(rcfg.model, mesh=mesh,
                                            parallel=parallel)))
        for path, t in zip(paths, leaves):
            if t.shape != want[path].shape:
                raise ValueError(f"param {path} of shape {tuple(t.shape)}: "
                                 f"this rank of {dict(mesh.shape)} holds "
                                 f"{tuple(want[path].shape)}")
    rt = Runtime(parallel, mesh) if split is not None or fsdp else None
    for t in leaves:
        t.requires_grad_(True)
    bax = batch_axes(mesh) if mesh is not None else ()
    n = mesh.size(*bax) if bax else 1
    rank = mesh.index(*bax) if bax else 0
    compress = (n > 1 and parallel.grad_compress_pod
                and mesh_axis_size(mesh, AXIS_POD) > 1)
    if compress:
        # the reference's shard_map over pod: each pod's own batch
        loss_axes = (AXIS_DATA,) if AXIS_DATA in mesh.axis_names else ()
    else:
        loss_axes = bax
    loss_group = (mesh.group(*loss_axes)
                  if loss_axes and mesh.size(*loss_axes) > 1 else None)
    # the leaves whose gradients reduce_grads sums: in fp32 after bf16
    # microbatches; a stored slice summed by its gather stays bf16, as
    # the reference's accumulator in the storage sharding
    summed = [n > 1 and not compress
              and bool(summed_over(p, t.shape, mesh, zero))
              for p, t in zip(paths, leaves)]

    # pod compression under FSDP storage: each pod's loss reads chunks
    pods = PodChunks(rcfg.model, mesh) if compress and fsdp else None
    gathered = [pods is not None and pods.cuts[p] is not None for p in paths]

    def grad_fn(batch):
        if pods is None:
            loss, metrics = lm.loss(batch, parallel, data=loss_group, rt=rt)
            return loss.detach(), metrics, torch.autograd.grad(loss, leaves)
        chunks = [pods.chunk(p, t.detach()).requires_grad_(True)
                  for p, t in zip(paths, leaves)]
        loss, metrics = LM(rcfg.model, unflatten(paths, chunks),
                           device=lm.device).loss(
            batch, parallel, data=loss_group, rt=_PodRuntime(parallel, mesh))
        return loss.detach(), metrics, torch.autograd.grad(loss, chunks)

    if compress:
        def pod_grad_fn(batch):
            loss, metrics, grads = grad_fn(batch)
            if loss_group is None:
                return loss, metrics, grads
            # a gathered leaf's gradient is summed over the pod's data
            # ranks by its gather's backward already
            grads = list(grads)
            rest = [k for k, g in enumerate(gathered) if not g]
            for k, g in zip(rest, all_reduce_flat([grads[k] for k in rest],
                                                  loss_group)):
                grads[k] = g
            return (*reduce_metrics(loss, metrics, loss_group), grads)

        compressed = build_pod_compressed_grad_fn(pod_grad_fn, mesh, [
            mesh.group(AXIS_DATA) if g else None for g in gathered])

        def step_grad_fn(batch):
            loss, metrics, grads = compressed(batch)
            if pods is not None:
                grads = [pods.own(p, g) for p, g in zip(paths, grads)]
            return loss, metrics, grads
    else:
        step_grad_fn = grad_fn

    def train_step(state: TrainState, batch):
        if state.params is not lm.params:
            raise ValueError("the state's params are not the LM's")
        rows = next(iter(batch.values())).shape[0]
        if rows % (n_micro * n):
            raise ValueError(f"batch of {rows} rows does not split into "
                             f"{n_micro} microbatches over {n} ranks")
        size = rows // n_micro
        part = size // n

        def micro(i):
            lo = i * size + rank * part
            return {k: v[lo:lo + part] for k, v in batch.items()}

        if n_micro == 1:
            loss, metrics, grads = step_grad_fn(micro(0))
        else:
            grads = [torch.zeros(t.shape, dtype=torch.bfloat16,
                                 device=t.device) for t in leaves]
            loss = torch.zeros((), dtype=torch.float32, device=lm.device)
            for i in range(n_micro):
                mloss, metrics, g = step_grad_fn(micro(i))
                for acc, gi in zip(grads, g):
                    acc += gi.to(torch.bfloat16)
                del g
                loss = loss + mloss
            # summed over ranks in fp32, then averaged
            grads = [acc.float() if s else acc
                     for acc, s in zip(grads, summed)]
        if n > 1 and not compress:
            grads = reduce_grads(grads, paths, mesh, zero)
            loss, metrics = reduce_metrics(loss, metrics, mesh.group(*bax))
        if n_micro > 1:
            for acc in grads:      # apply casts each slice to fp32
                acc.div_(n_micro)
            loss = loss / n_micro
        state, opt_metrics = opt.apply(state, unflatten(paths, grads), zero,
                                       split)
        return state, dict(metrics, loss=loss, **opt_metrics)

    train_step.zero = zero
    train_step.split = split
    return train_step, opt
