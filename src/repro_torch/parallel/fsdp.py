"""The cut of each param leaf over the batch axes: ZeRO-1's and FSDP's
(``repro.parallel.sharding``'s ``fsdp_tp`` rules).

The ``fsdp_tp`` rules place every leaf's ``embed`` dim over (``pod``,
``data``), dropping ``pod`` first where d_model does not divide
(``resolve_spec``'s size guard); every other logical axis keeps its
``tp`` placement, and no other one goes on a batch axis. ``BatchCuts``
is that cut, for one rank: ZeRO-1 cuts the optimizer's moments by it
(``train.optimizer``, as the reference's ``state_specs`` place them),
and under ``strategy="fsdp_tp"`` (``fsdp_plan``) the params are stored
at the same cuts, on top of a rank's ``model`` slice
(``bridge.storage_cuts``), and gathered back a layer at a time while the
layer runs (``models.lm``).

A leaf's cut dim is its ``embed`` dim, which holds d_model in a whole
leaf and d_model / n in a slice, so a tensor's shape tells which it is
(``sliced``): the optimizer and the checkpoints read that, and never the
strategy. The plan reads only the mesh's ``axis_names``, ``shape`` and
``coords``, so a shape-only stand-in of a large mesh serves; the
collectives need the port's ``launch.mesh.Mesh``.
"""
from __future__ import annotations

import math

from repro_torch.parallel.collectives import all_gather, fsdp_gather
from repro_torch.parallel.sharding import (
    AXIS_DATA, AXIS_POD, batch_axes, leaf_axes, resolve_spec)


def unflatten(paths, values):
    """A nested dict from '/'-joined paths and their values."""
    out = {}
    for path, val in zip(paths, values):
        node = out
        *dirs, last = path.split("/")
        for d in dirs:
            node = node.setdefault(d, {})
        node[last] = val
    return out


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from _leaves(v, path + "/")
        else:
            yield path, v


class _Cuts(dict):
    """path -> (dim, batch axes) of the leaf's cut, or None for a leaf
    stored whole; each computed from the leaf's logical axes on first
    use."""

    def __init__(self, axes: tuple[str, ...]):
        super().__init__()
        self.axes = axes

    def __missing__(self, path):
        names = leaf_axes(path)
        cut = ((names.index("embed"), self.axes)
               if self.axes and "embed" in names else None)
        self[path] = cut
        return cut


class BatchCuts:
    """This rank's cut over the batch axes of every param leaf of a model
    (``cfg``) on ``mesh``.

    ``cuts[path]`` is (dim, axes) for a leaf whose ``fsdp_tp`` placement
    puts batch axes (``axes``, a tuple of them) on ``dim``, else None. A
    rank holds the part of ``dim`` at its row-major index over ``axes``;
    the ranks of the other batch axes hold the same part."""

    def __init__(self, cfg, mesh):
        self.mesh, self.d_model = mesh, cfg.d_model
        spec = resolve_spec(("embed",), (cfg.d_model,), mesh, "fsdp_tp")
        at = spec[0] if spec else None
        self.axes = tuple(a for a in ((at,) if isinstance(at, str)
                                      else tuple(at or ()))
                          if a in batch_axes(mesh))
        self.n = math.prod(mesh.shape[a] for a in self.axes)
        self.cuts = _Cuts(self.axes)

    def sliced(self, path: str, shape) -> bool:
        """Whether a tensor of ``shape`` at ``path`` is a rank's slice
        (its cut dim holds d_model / n), not the whole leaf."""
        cut = self.cuts[path]
        return cut is not None and shape[cut[0]] != self.d_model

    def part(self, path: str, shape) -> tuple[int, int, int] | None:
        """(dim, start, stop) of this rank's slice of the whole leaf
        ``path`` of ``shape``, or None when it holds the leaf whole."""
        cut = self.cuts[path]
        if cut is None:
            return None
        dim, on = cut
        i = 0
        for a in on:
            i = i * self.mesh.shape[a] + self.mesh.coords[a]
        size = shape[dim] // self.n
        return dim, i * size, (i + 1) * size

    def group(self, path: str):
        return self.mesh.group(*self.cuts[path][1])

    def gather(self, path: str, t, lead: int = 0):
        """The leaf at ``path`` from this rank's stored slice ``t``, all-
        gathered along its cut dim (``lead`` dims fewer: a per-layer view
        of a stacked leaf has lost its ``layers`` dim), differentiably
        (``collectives.fsdp_gather``); ``t`` itself for a leaf stored
        whole."""
        cut = self.cuts[path]
        if cut is None:
            return t
        return fsdp_gather(t, cut[0] - lead, self.group(path))

    def local(self, path: str, t):
        """This rank's slice of the whole leaf ``t`` (a view), or ``t``."""
        part = self.part(path, t.shape)
        if part is None:
            return t
        dim, lo, hi = part
        return t.narrow(dim, lo, hi - lo)

    def slice_tree(self, tree):
        """Each whole leaf's slice, as its own tensor; a leaf stored
        whole, or already a slice, as it is."""
        paths, leaves = zip(*_leaves(tree))
        return unflatten(paths, [
            self.local(p, t).clone() if self.cuts[p] is not None
            and not self.sliced(p, t.shape) else t
            for p, t in zip(paths, leaves)])

    def gather_tree(self, tree, device=None):
        """The whole leaves of a tree in which some are this rank's
        slices, on ``device`` (None: each slice's). A collective: every
        rank calls it, in the same order."""
        paths, leaves = zip(*_leaves(tree))
        return unflatten(paths, [
            all_gather(t.detach(), self.cuts[p][0], self.group(p), device)
            if self.sliced(p, t.shape)
            else (t if device is None else t.to(device))
            for p, t in zip(paths, leaves)])


class PodChunks(BatchCuts):
    """The cuts as one pod's loss sees them under pod compression
    (``train.train_step``): the reference's ``shard_map`` over ``pod``
    hands each pod the params whole over ``pod`` and cut over ``data``.

    A leaf cut over (``pod``, ``data``) enters the loss as its chunk
    (``chunk``): the stored slices of the ranks at this rank's ``data``
    index, one from each pod, in pod order. A layer gathers the chunks
    over ``data`` and puts the slices in leaf order (``gather``), so
    the gather's backward sums the gradient over the pod's ``data``
    ranks only and hands each its chunk's, which the pods then exchange
    compressed (``parallel.compression``); ``own`` takes this rank's
    stored slice of it. A leaf cut over ``data`` alone enters as
    stored."""

    def chunk(self, path: str, t):
        """The chunk of leaf ``path`` from this rank's stored slice ``t``
        (a collective over ``pod``), or ``t`` itself."""
        cut = self.cuts[path]
        if cut is None or AXIS_POD not in cut[1]:
            return t
        return all_gather(t, cut[0], self.mesh.group(AXIS_POD))

    def own(self, path: str, g):
        """This rank's stored slice of a chunk-shaped ``g``, or ``g``."""
        cut = self.cuts[path]
        if cut is None or AXIS_POD not in cut[1]:
            return g
        size = g.shape[cut[0]] // self.mesh.shape[AXIS_POD]
        return g.narrow(cut[0], self.mesh.coords[AXIS_POD] * size, size)

    def gather(self, path: str, t, lead: int = 0):
        """The leaf at ``path`` from this rank's chunk ``t`` (or stored
        slice, for a leaf cut over ``data`` alone), differentiably."""
        cut = self.cuts[path]
        if cut is None:
            return t
        dim = cut[0] - lead
        x = fsdp_gather(t, dim, self.mesh.group(AXIS_DATA))
        if AXIS_POD not in cut[1]:
            return x
        # (data, pod, slice) order along dim -> (pod, data, slice)
        pods, data = self.mesh.shape[AXIS_POD], self.mesh.shape[AXIS_DATA]
        split = x.shape[:dim] + (data, pods, -1) + x.shape[dim + 1:]
        return x.reshape(split).transpose(dim, dim + 1).reshape(x.shape)


def fsdp_plan(cfg, mesh, parallel) -> BatchCuts | None:
    """The plan the params of ``cfg`` are stored by on ``mesh`` under
    ``parallel``: the batch cuts under ``strategy="fsdp_tp"`` on a mesh
    whose batch axes hold more than one rank; else None (the ``tp``
    layout)."""
    if (mesh is None or parallel is None or parallel.strategy != "fsdp_tp"
            or math.prod(mesh.shape[a] for a in batch_axes(mesh)) == 1):
        return None
    return BatchCuts(cfg, mesh)
