"""Decoder LM assembly: embeddings -> layer loop -> head(s) + losses
(``repro.models.lm``).

Params are the JAX package's nested dict, leaf for leaf: ``embed``
(ncb, Vp, d), ``head`` (ncb, d, Vp), ``final_norm`` (d,) and
``blocks/pos{i}/...`` with the stacked leading ``R = n_layers / period``
axis. Caches keep the JAX layouts, by the kind of layer at pattern
position i: attention ``(k, v)`` with k, v of (R, B, S, KVH, hd), or
(R, n_pages, page_size, KVH, hd) when paged; Mamba2 ``({"x", "B", "C"}
conv tails (R, B, k-1, ch) in the model's dtype, state (R, B, nh, hp, ds)
fp32)``, slot-indexed in both modes. Where JAX scans over R, this module
loops over per-layer views.

Serving (``prefill``, ``decode``) runs under ``torch.no_grad`` through the
kernels, on one rank or, with a ``Runtime`` whose mesh spans several, as
one rank of that mesh (``models.blocks``): the rank's params hold its
share of attention's columns, MLP units, vocab rows, Mamba2 heads,
experts and router columns (``Runtime.tensor``), its caches its KV heads
where attention splits by whole heads (else every KV head) and its
Mamba2 heads, and all of it its share of the batch's rows where the
batch divides over the batch axes (``Runtime.rows``). Training
(``loss``) runs the blocks' plain training route under autograd, each
pattern repeat under ``torch.utils.checkpoint`` unless ``remat ==
"none"``: the counterpart of the reference's ``jax.checkpoint`` with
``nothing_saveable`` around its scan body; with a ``Runtime`` it
trains as one rank of its mesh under the same split.

Under FSDP storage (``Runtime.fsdp``) the params are the rank's stored
slices: each pass gathers a layer's leaves back to the ``tp`` layout
just before the layer runs (inside the checkpointed repeat in training,
so the backward gathers again), as the reference's ``_maybe_gather``
does, and the ``head`` table where it is read; training gathers the
``embed`` table too, and serving looks up the rank's columns instead
(``embed``'s ``shared_rows``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ParallelConfig
from repro_torch.models.blocks import DECODE_BLOCK_S, block_apply, block_train
from repro_torch.models.layers import rmsnorm
from repro_torch.parallel.collectives import (
    all_gather, all_reduce, all_to_all, batch_rows)
from repro_torch.parallel.fsdp import BatchCuts, fsdp_plan
from repro_torch.parallel.sharding import AXIS_MODEL
from repro_torch.parallel.tensor import (
    WHOLE, TensorParallel, decode_kv_shard, tensor_plan)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Without one, raise: the CPU runs only when
    the caller asks for it with ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on the card by default; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" and "cuda:0" name one card; tensors report the index
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def tree_leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict, depth first, '/'-joined."""
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from tree_leaves(val, path)
        else:
            yield path, val


def sorted_tree_leaves(tree, prefix=""):
    """(path, tensor) pairs of a nested dict in the order ``jax.tree``
    flattens it: the keys of each dict sorted. Checkpoints and the
    optimizer walk this order, so a leaf's index is the reference's (the
    insertion order puts wq, wk, wv, wo; sorted, wk comes first)."""
    for key in sorted(tree):
        val = tree[key]
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from sorted_tree_leaves(val, path)
        else:
            yield path, val


def tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v) for v in tree)
    return fn(tree)


def _unbind(tree):
    """A nested dict of stacked (R, ...) leaves -> R nested dicts of their
    slices, in layer order, from one ``unbind`` per leaf: autograd then
    stacks the R slices' gradients into the leaf's in one node, where R
    separate index views would each add a leaf-sized zero-padded copy."""
    if isinstance(tree, dict):
        per_key = {k: _unbind(v) for k, v in tree.items()}
        R = len(next(iter(per_key.values())))
        return [{k: v[r] for k, v in per_key.items()} for r in range(R)]
    return list(tree.unbind(0))


def _stack(trees):
    """Stack a list of same-structure cache trees leaf by leaf (axis 0)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack([t[j] for t in trees]) for j in range(len(first)))
    return torch.stack(trees)


@dataclass
class Runtime:
    """The serving passes' execution context (``repro.models.lm.Runtime``):
    a ``ParallelConfig`` and the mesh (``launch.mesh.Mesh``; None for one
    rank, where the passes are the single-card path, bit for bit).

    On a mesh whose ``model`` axis holds n ranks, each rank holds and
    computes its share of the dense leaves (``tensor``: the rank's columns
    of attention, its Mamba2 heads and vocab rows, ``parallel.tensor``),
    and of the experts and the router's columns (``models.moe``). Where
    attention's columns are not whole heads the rank attends with, prefill
    splits by heads padded to a multiple of n, as the reference's
    ``padded_heads`` and ``shard_heads`` ask of GSPMD
    (``models.blocks.padded_head_attention``). Every rank computes under
    the "tp" rules.

    The batch's rows split over the batch axes (``pod``, ``data``) where
    the reference's specs shard them (``shard_activations``, the cache's
    ``P(None, baxes, ...)``, the MoE ``shard_map``'s ``bspec``): when the
    batch divides over all of them, rank i of the batch axes holds and
    computes rows [i B / n, (i + 1) B / n) of every serving pass, its
    activations and its caches (``rows``); otherwise the batch stays whole
    on every rank, as the reference replicates it. A batch that divides
    over ``data`` but not over (``pod``, ``data``) stays whole: the
    reference's data-only fallback for it (``_guard_batch_axes``) places
    its inputs and nothing else, and its MoE layer replicates the batch
    (``moe.py``'s ``bspec``). The residual stream of a rank's rows stays
    whole over ``model``. Under ``strategy="fsdp_tp"`` the params are
    stored cut over the batch axes as well (``fsdp``), and ``LM`` gathers
    each layer back to the "tp" layout while it runs: the reference's
    ``_maybe_gather`` over its ``block_axes``.
    """
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    mesh: Any = None

    def rows(self, B: int):
        """(rows, group) of a serving batch of B rows: this rank's rows
        and the group over the batch axes that holds the others, in rank
        order (``parallel.collectives.batch_rows``); None when every rank
        holds the batch whole."""
        return batch_rows(self.mesh, B) if self.mesh is not None else None

    def row_group(self, B: int, rows=None):
        """The group over the batch axes that holds the other rows of a
        serving pass over B rows, or None when the pass holds the whole
        batch. ``rows``: what ``rows`` returned for the batch these B rows
        were cut from, or None for a whole batch. A whole batch that
        divides over the batch axes is refused, as are rows that are not
        the pair's: the reference shards such a batch, so a pass over it
        whole would count the MoE capacity over other rows."""
        if rows is None:
            if self.rows(B) is not None:
                raise ValueError(
                    f"a batch of {B} rows divides over the batch axes: pass "
                    f"this rank's rows and Runtime.rows({B})'s pair")
            return None
        mine, group = rows
        if B != mine.stop - mine.start:
            raise ValueError(f"{B} rows, but the pair holds rows "
                             f"[{mine.start}, {mine.stop})")
        return group

    def fsdp(self, cfg) -> BatchCuts | None:
        """The cuts over the batch axes that ``cfg``'s params are stored
        by on this mesh (``parallel.fsdp.fsdp_plan``), or None when they
        are stored in the "tp" layout."""
        return fsdp_plan(cfg, self.mesh, self.parallel)

    def decode_kv_shard(self, cfg) -> str:
        """"heads" (every rank holds every position) or "seq" (each rank
        a slice of the positions). "auto" shards the sequence when the
        model axis outnumbers the KV heads."""
        return decode_kv_shard(cfg, self.mesh, self.parallel)

    def tensor(self, cfg) -> TensorParallel:
        """This rank's split of ``cfg``'s dense leaves
        (``parallel.tensor.tensor_plan``)."""
        return tensor_plan(cfg, self.mesh, self.parallel)

    def seq_window(self, cfg, max_len: int) -> tuple[int, int] | None:
        """The positions [start, stop) of a ``max_len`` cache that this
        rank holds under "seq", or None when it holds them all."""
        if self.decode_kv_shard(cfg) != "seq" or self.mesh is None:
            return None
        n = self.mesh.shape.get(AXIS_MODEL, 1)
        if max_len % n:
            raise ValueError(f"max_len ({max_len}) must divide over the "
                             f"{n} ranks of the model axis under "
                             "decode_kv_shard='seq'")
        i = self.mesh.coords.get(AXIS_MODEL, 0)
        return i * (max_len // n), (i + 1) * (max_len // n)


class LM(nn.Module):
    """Serving forward passes and the training loss of one decoder over a
    nested param dict.

    ``params`` must already live on ``device`` (``bridge.init_params`` or
    ``bridge.params_from_jax`` put them there). They stay the plain nested
    dict of the JAX layout, so the bridge is a leaf-wise copy; the module
    is not moved with ``.to()``. The serving passes read per-layer views
    made here; training updates the leaves in place, which the views see.
    """

    def __init__(self, cfg, params, *, device=None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = DTYPES[cfg.dtype]
        for path, t in tree_leaves(params):
            if t.device != self.device:
                raise ValueError(f"param {path} lives on {t.device}, "
                                 f"not {self.device}")
        self.params = params
        self.period = cfg.pattern_period
        self.repeats = cfg.n_layers // self.period
        # per-layer views of the stacked (R, ...) leaves, in layer order
        self._layers = [
            [tree_map(lambda t, r=r: t[r], params["blocks"][f"pos{i}"])
             for i in range(self.period)]
            for r in range(self.repeats)]

    def _gathered(self, tree, prefix: str, fsdp, lead: int = 0):
        """``tree`` (the leaves at ``prefix``) in the ``tp`` layout: each
        stored slice that ``fsdp`` cuts is gathered (``BatchCuts.gather``;
        ``lead`` 1 for a layer's views of stacked leaves)."""
        if fsdp is None:
            return tree
        return {k: self._gathered(v, f"{prefix}/{k}", fsdp, lead)
                if isinstance(v, dict) else fsdp.gather(f"{prefix}/{k}", v,
                                                        lead)
                for k, v in tree.items()}

    def _table(self, name: str, rt: Runtime | None):
        """The ``embed`` or ``head`` table in the ``tp`` layout."""
        t = self.params[name]
        fsdp = rt.fsdp(self.cfg) if rt is not None else None
        return t if fsdp is None else fsdp.gather(name, t)

    # ------------------------------------------------------------ embed
    def embed(self, batch, rt: Runtime | None = None, *,
              shared_rows: bool = False, data=None):
        """batch: tokens (B, S[, ncb]) int; optional patches (B, Np, d).

        Under ``rt``'s vocab split each rank holds rows [lo, hi) of every
        codebook's table: a token outside them reads 0, and each
        codebook's lookup is summed over ``model`` on its own (x + 0 is
        exact) before the codebooks add in order, as on one rank, so the
        result equals the one-rank embedding bit for bit.

        Under FSDP storage the table's ``d`` columns are cut over batch
        axes. Training gathers the table. With ``shared_rows`` (the
        serving passes, under ``no_grad``) each rank looks up its own
        columns and the table never crosses: where every rank embeds the
        same tokens (``data`` None) the columns are gathered; where each
        holds its own rows (``data``, the group over the batch axes of
        ``Runtime.rows``) the token ids of the rows of the ranks that cut
        the table are gathered, each rank looks up its columns of all of
        them, and an ``all_to_all`` hands each rank its rows' columns.
        Every output column is its table column's entries (summed over
        the codebooks in order), so either is the whole table's lookup
        bit for bit."""
        cfg = self.cfg
        fsdp = rt.fsdp(cfg) if rt is not None else None
        by_column = (shared_rows and fsdp is not None
                     and fsdp.cuts["embed"] is not None)
        emb = (self.params["embed"] if by_column
               else self._table("embed", rt))          # (ncb, Vp, d[/n])
        tokens = batch["tokens"].to(self.device).long()
        own = tokens.shape[0]
        if by_column and data is not None:
            # the cut's ranks hold distinct rows: its axes are batch axes
            tokens = all_gather(tokens, 0, fsdp.group("embed"))
        tp = rt.tensor(cfg) if rt is not None else WHOLE
        ncb = cfg.n_codebooks
        per_cb = tokens[..., None] if ncb <= 1 else tokens
        # F.embedding: its gradient on the card sums each row's uses in a
        # fixed order, which the bitwise preempt/resume check rests on
        if tp.vocab:
            lo, hi = tp.vocab_rows(cfg)
            if emb.shape[1] != hi - lo:
                raise ValueError(f"embed holds {emb.shape[1]} vocab rows, "
                                 f"the runtime's split {hi - lo}")
            local = per_cb - lo
            inside = (local >= 0) & (local < hi - lo)
            local = torch.where(inside, local, 0)
            parts = tp.reduce(torch.stack([
                torch.where(inside[..., c, None],
                            F.embedding(local[..., c], emb[c]), 0)
                for c in range(emb.shape[0])]))
        else:
            parts = [F.embedding(per_cb[..., c], emb[c])
                     for c in range(emb.shape[0])]
        if ncb > 1:
            x = torch.zeros(tokens.shape[:2] + (emb.shape[-1],),
                            dtype=emb.dtype, device=self.device)
            for c in range(ncb):
                x = x + parts[c]
        else:
            x = parts[0]
        if by_column and data is not None:
            # (n ranks' rows, S, d / n) -> this rank's rows from each rank,
            # its columns in rank order -> (rows, S, d)
            x = all_to_all(x, fsdp.group("embed"))
            n = x.shape[0] // own
            x = x.reshape(n, own, *x.shape[1:]).movedim(0, -2).flatten(-2)
        elif by_column:
            x = all_gather(x, -1, fsdp.group("embed"))
        if cfg.vision_stub and "patches" in batch:
            patches = batch["patches"].to(self.device, x.dtype)
            x = torch.cat([patches, x], dim=1)
        return x

    def logits(self, x, rt: Runtime | None = None, *, join: bool = True):
        """Over ``vocab_padded``: greedy argmax sees the padded columns too,
        as in the JAX engine. Under ``rt``'s vocab split each rank's
        columns are gathered over ``model`` in column order (``join``;
        else the rank's own columns)."""
        head = self._table("head", rt)                 # (ncb, d, Vp[/n])
        if self.cfg.n_codebooks > 1:
            out = torch.einsum("bsd,cdv->bscv", x, head)
        else:
            out = x @ head[0]
        tp = rt.tensor(self.cfg) if rt is not None else WHOLE
        return tp.gather(out, -1) if tp.vocab and join else out

    # ------------------------------------------------------------- train
    def backbone(self, x, positions, parallel: ParallelConfig, data=None,
                 tp: TensorParallel = WHOLE, fsdp=None):
        """Training forward of (B, S, d) through every layer: returns (x,
        {"moe_lb_loss", "moe_z_loss"} fp32 sums over the layers). The
        stacked leaves are sliced inside the graph on every call.
        ``data`` and ``tp``: as in ``loss``; ``fsdp``: the storage plan
        (``Runtime.fsdp``), whose slices each repeat gathers inside its
        checkpoint, so the backward gathers them again."""
        cfg = self.cfg

        def repeat(x, lb, z, layer):
            for i in range(self.period):
                p = self._gathered(layer[i], f"blocks/pos{i}", fsdp, 1)
                x, aux = block_train(p, cfg, parallel, x, positions,
                                     i, data, tp)
                if aux:
                    lb = lb + aux["moe_lb_loss"]
                    z = z + aux["moe_z_loss"]
            return x, lb, z

        run = (repeat if parallel.remat == "none"
               else functools.partial(checkpoint, repeat, use_reentrant=False))
        per_pos = [_unbind(self.params["blocks"][f"pos{i}"])
                   for i in range(self.period)]
        lb = z = torch.zeros((), dtype=torch.float32, device=self.device)
        for r in range(self.repeats):
            x, lb, z = run(x, lb, z, [per_pos[i][r]
                                      for i in range(self.period)])
        return x, {"moe_lb_loss": lb, "moe_z_loss": z}

    def loss(self, batch, parallel: ParallelConfig | None = None,
             data=None, *, rt: Runtime | None = None):
        """batch: tokens, targets (B, S[, ncb]) int, mask (B, S) f32,
        optional patches (B, Np, d), on the LM's device. Returns (loss,
        metrics): loss = CE + 0.01 * load-balance + 1e-3 * router z loss,
        differentiable; metrics ``ce``, ``moe_lb_loss``, ``moe_z_loss`` and
        ``z`` (the mean squared log-normaliser), detached. The CE is the
        masked mean over text positions (the patches' positions dropped),
        averaged over codebooks for multi-codebook models.

        ``data``: the data context, the process group of the ranks that
        hold the other rows of the batch (in group-rank order), or None
        when ``batch`` is the whole batch. Under a group the loss and
        every metric are this rank's share of the whole batch's, computed
        over its own rows only: the CE and ``z`` are the local masked sums
        over the global denominator (the all-reduced ``mask.sum()``), and
        each MoE layer's aux losses and capacity are the global batch's
        (``models.moe``). Summed over the group, the shares are the
        reference's loss and metrics over the global batch, and their
        gradients, summed, its gradients. Under remat the MoE layers'
        collectives run again in the backward, on every rank in the same
        order, and give the same counts.

        ``rt``: the runtime whose mesh this rank trains on; where its
        ``model`` axis holds n > 1 ranks, the params are this rank's
        slices (``Runtime.tensor``: attention's columns, MLP columns, vocab
        rows, Mamba2 heads, experts and router columns, as serving splits
        them) and the loss is
        computed across the ``model`` ranks under autograd
        (``parallel.tensor``): each rank returns the same loss, and the
        gradients of its slices are theirs of that loss, the whole
        leaves' whole. Under a vocab split the cross entropy is the
        reference's full-vocab ``logsumexp`` and target logit from
        per-rank statistics: the row maxima (all-reduced MAX), then the
        sums of exponentials and the target logits in one SUM, so no rank
        holds the (tokens, vocab) logits. ``data`` then groups the ranks
        of this rank's ``model`` index. Under remat the ``model``
        collectives of each pattern repeat also run again in the
        backward, on every rank in the same order."""
        cfg = self.cfg
        tp = rt.tensor(cfg) if rt is not None else WHOLE
        x = self.embed(batch, rt)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        x, aux = self.backbone(x, positions, parallel or ParallelConfig(),
                               data, tp,
                               rt.fsdp(cfg) if rt is not None else None)
        x = rmsnorm(self.params["final_norm"], x, cfg.norm_eps)
        if cfg.vision_stub and "patches" in batch:
            x = x[:, batch["patches"].shape[1]:]  # loss on text positions
        targets = batch["targets"].to(self.device).long()
        mask = batch["mask"].to(self.device, torch.float32)
        if tp.vocab:
            lse, tgt = self._split_vocab_ce(tp.enter(x), targets, rt)
        else:
            logits = self.logits(x, rt).float()
            lse = torch.logsumexp(logits, dim=-1)
            tgt = torch.gather(logits, -1, targets[..., None])[..., 0]
        ce = lse - tgt                                    # (B, S[, ncb])
        if cfg.n_codebooks > 1:
            ce = ce.mean(dim=-1)
            lse = lse.mean(dim=-1)
        denom = mask.sum()
        if data is not None:
            denom = all_reduce(denom.clone(), data)
        denom = torch.clamp(denom, min=1.0)
        ce_loss = (ce * mask).sum() / denom
        loss = (ce_loss + 0.01 * aux["moe_lb_loss"]
                + 1e-3 * aux["moe_z_loss"])
        metrics = {"ce": ce_loss, **aux,
                   "z": (lse.square() * mask).sum() / denom}
        return loss, {k: v.detach() for k, v in metrics.items()}

    def _split_vocab_ce(self, x, targets, rt: Runtime):
        """(lse, target logit), each (B, S[, ncb]) fp32, over the whole
        vocab, from this rank's ``vocab_padded`` columns of the head: the
        max is a constant shift (its gradient cancels), so it is taken
        detached."""
        tp = rt.tensor(self.cfg)
        logits = self.logits(x, rt, join=False).float()  # (..., V / n)
        lo, hi = tp.vocab_rows(self.cfg)
        m = all_reduce(logits.detach().amax(dim=-1), tp.group,
                       dist.ReduceOp.MAX)
        local = targets - lo
        inside = (local >= 0) & (local < hi - lo)
        t_loc = torch.gather(logits, -1, torch.where(
            inside, local, 0)[..., None])[..., 0]
        sums = tp.reduce(torch.stack([
            torch.exp(logits - m[..., None]).sum(dim=-1),
            torch.where(inside, t_loc, 0)]))
        return torch.log(sums[0]) + m, sums[1]

    # ------------------------------------------------------------- serve
    @torch.no_grad()
    def prefill(self, batch, rt: Runtime | None = None, *, rows=None):
        """Full-sequence forward; returns (last_logits (B, [ncb,] Vp),
        caches {"pos{i}": ...} in the module's layouts with B rows and, for
        attention, S positions), on every rank of ``rt``'s mesh: its caches
        hold the rank's KV heads where attention splits by whole heads
        (else every KV head) and its Mamba2 heads (``Runtime.tensor``).

        ``rows``: ``rt.rows``'s pair for the batch when ``batch`` holds
        this rank's rows of it (B is then the rank's rows), or None when
        it is the whole batch (``Runtime.row_group``). The pair's group
        reaches the MoE layers, where their capacity counts the whole
        batch (``models.moe.moe_apply``), and the FSDP embedding
        (``embed``)."""
        data = (rt if rt is not None else Runtime()).row_group(
            batch["tokens"].shape[0], rows)
        x = self.embed(batch, rt, shared_rows=True, data=data)
        B, S = x.shape[:2]
        positions = torch.arange(S, device=self.device).expand(B, S)
        fsdp = rt.fsdp(self.cfg) if rt is not None else None
        per_pos = [[] for _ in range(self.period)]
        for layer in self._layers:
            for i, p in enumerate(layer):
                p = self._gathered(p, f"blocks/pos{i}", fsdp, 1)
                x, cache = block_apply(p, self.cfg, x, positions, i, rt=rt,
                                       data=data)
                per_pos[i].append(cache)
        x = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        logits = self.logits(x[:, -1:], rt)
        caches = {f"pos{i}": _stack(per_pos[i]) for i in range(self.period)}
        return logits[:, 0], caches

    @torch.no_grad()
    def decode(self, tokens, lengths, caches, page_table=None, *,
               rt: Runtime | None = None, full=None, rows=None,
               block_s: int = DECODE_BLOCK_S):
        """tokens: (B, 1[, ncb]); lengths: (B,) int32 current cache fill on
        the device; page_table: (B, pages_per_row) int32 for paged caches.
        ``full``: None when no row's length equals its capacity, else a
        (B,) bool tensor on the device marking those rows, which then
        write nothing (``attn_block``). ``block_s``: the contiguous decode
        kernel's split. ``rt``: the runtime; under its "seq" mode each
        contiguous attention cache is this rank's slice of the positions
        (``Runtime.seq_window``). A page pool is never sliced: the
        ``Engine`` refuses paged KV under "seq", and this pass trusts its
        callers to have done so. ``rows``: as in ``prefill``; every
        per-row argument and ``caches`` then hold this rank's rows.

        Writes each row's new K/V, conv tails and SSM state into ``caches``
        in place and returns (logits (B, [ncb,] Vp), caches).
        """
        data = (rt if rt is not None else Runtime()).row_group(
            tokens.shape[0], rows)
        x = self.embed({"tokens": tokens}, rt, shared_rows=True, data=data)
        positions = lengths.long()[:, None]
        fsdp = rt.fsdp(self.cfg) if rt is not None else None
        for r, layer in enumerate(self._layers):
            for i, p in enumerate(layer):
                p = self._gathered(p, f"blocks/pos{i}", fsdp, 1)
                cache = tree_map(lambda t, r=r: t[r], caches[f"pos{i}"])
                x, _ = block_apply(p, self.cfg, x, positions, i, rt=rt,
                                   cache=cache, lengths=lengths,
                                   page_table=page_table, full=full,
                                   data=data, block_s=block_s)
        x = rmsnorm(self.params["final_norm"], x, self.cfg.norm_eps)
        return self.logits(x, rt)[:, 0], caches

    # ------------------------------------------------------------ caches
    def cache_kind(self, key: str) -> str:
        """"attn" or "ssm": the kind of layer whose cache ``key`` ("pos{i}")
        holds."""
        return self.cfg.block_kind(int(key.removeprefix("pos")))

    def splice(self, caches, pre, slot: int, row: int, *, pages=None,
               page_size: int | None = None,
               window: tuple[int, int] | None = None) -> None:
        """Copy row ``row`` of prefill caches ``pre`` into ``slot`` of
        ``caches``, in place: attention K/V (P positions) into the slot's
        first P rows, or with ``pages`` (the slot's page ids, in order)
        into its pages, or with ``window`` (start, stop), a rank's slice of
        the positions under "seq", the prefill's positions in it into the
        slot's first rows; Mamba2 conv tails and state into ``[:, slot]``
        in every mode."""
        for key, cache in caches.items():
            if self.cache_kind(key) != "attn":
                conv, state = cache
                src_conv, src_state = pre[key]
                for name, dst in conv.items():
                    dst[:, slot].copy_(src_conv[name][:, row])
                state[:, slot].copy_(src_state[:, row])
                continue
            for dst, src in zip(cache, pre[key]):
                src = src[:, row]                     # (R, P, KVH, hd)
                if window is not None:
                    src = src[:, window[0]:window[1]]
                P = src.shape[1]
                if pages is None:
                    dst[:, slot, :P].copy_(src)
                    continue
                ps = page_size
                for j0 in range(0, P, ps):
                    cs = min(ps, P - j0)
                    dst[:, int(pages[j0 // ps]), :cs].copy_(src[:, j0:j0 + cs])

    # ------------------------------------------------- cache construction
    def _ssm_cache(self, batch_size: int, tp: TensorParallel):
        """A Mamba2 position's cache as meta tensors (shape and dtype), at
        the rank's heads."""
        cfg, R = self.cfg, self.repeats
        h0, h1 = tp.ssm_heads(cfg)
        k1, ch_bc = cfg.conv_dim - 1, cfg.ssm_groups * cfg.d_state
        conv = {"x": (R, batch_size, k1, (h1 - h0) * cfg.ssm_head_dim),
                "B": (R, batch_size, k1, ch_bc),
                "C": (R, batch_size, k1, ch_bc)}
        state = (R, batch_size, h1 - h0, cfg.ssm_head_dim, cfg.d_state)
        return ({k: torch.empty(s, dtype=self.dtype, device="meta")
                 for k, s in conv.items()},
                torch.empty(state, dtype=torch.float32, device="meta"))

    def _shapes(self, batch_size: int, kv_shape, tp: TensorParallel):
        kv = torch.empty(kv_shape, dtype=self.dtype, device="meta")
        return {f"pos{i}": (kv, kv) if self.cfg.block_kind(i) == "attn"
                else self._ssm_cache(batch_size, tp)
                for i in range(self.period)}

    def cache_shapes(self, batch_size: int, max_len: int,
                     rt: Runtime | None = None):
        """{"pos{i}": cache} as meta tensors: attention (k, v) each (R, B,
        S, KVH, hd); Mamba2 (conv tails, fp32 state); KVH and the Mamba2
        heads are ``rt``'s rank's (``Runtime.tensor``)."""
        cfg = self.cfg
        tp = rt.tensor(cfg) if rt is not None else WHOLE
        return self._shapes(batch_size, (self.repeats, batch_size, max_len,
                                         tp.kv_heads(cfg), cfg.head_dim), tp)

    def paged_cache_shapes(self, batch_size: int, n_pages: int,
                           page_size: int, rt: Runtime | None = None):
        """Attention KV in a shared page pool, each (R, n_pages, page_size,
        KVH, hd), addressed through a per-row page table; Mamba2 caches
        hold no sequence axis and stay slot-indexed. A page holds the
        rank's KV heads."""
        cfg = self.cfg
        tp = rt.tensor(cfg) if rt is not None else WHOLE
        return self._shapes(batch_size, (self.repeats, n_pages, page_size,
                                         tp.kv_heads(cfg), cfg.head_dim), tp)

    def _zeros(self, shapes):
        return tree_map(lambda m: torch.zeros(m.shape, dtype=m.dtype,
                                              device=self.device), shapes)

    def init_cache(self, batch_size: int, max_len: int,
                   rt: Runtime | None = None):
        return self._zeros(self.cache_shapes(batch_size, max_len, rt))

    def init_paged_cache(self, batch_size: int, n_pages: int,
                         page_size: int, rt: Runtime | None = None):
        return self._zeros(self.paged_cache_shapes(batch_size, n_pages,
                                                   page_size, rt))
