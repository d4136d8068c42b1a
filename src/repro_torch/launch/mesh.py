"""Meshes of ranks (``repro.launch.mesh``).

The reference's mesh is a grid of devices with named axes; GSPMD and
``shard_map`` derive the collectives from it. The port's ``Mesh`` is the
grid of the ranks of the default ``torch.distributed`` process group,
row-major in the reference's axis order (``pod``, ``data``, ``model``),
with what the explicit collectives need: a process group per axis and one
over the batch axes together, this rank's coordinate on each axis, and
its ``torch.device``. ``torch.distributed.device_mesh.DeviceMesh`` does
not serve: the batch axes need one group over (``pod``, ``data``), which
``DeviceMesh`` forms only through a private method, and nothing of this
slice uses DTensor.

The caller starts the process group (``torch.distributed.
init_process_group``, gloo or NCCL) before building a mesh; building one
creates subgroups, a collective call that every rank of the world makes
in the same order. A mesh may hold some of the world's ranks (``ranks=``,
the first ones by default), as the reference's mesh over ``devs[:k]``
does: a rank outside it still builds it, in the same order, and gets a
``Mesh`` whose ``member`` is False, with no coordinates and no groups
(``train.loop``'s resizes build such meshes). The device comes from the
caller, as everywhere in the port: the card by default
(``cuda:LOCAL_RANK`` under torchrun, else the rank modulo the cards),
``"cpu"`` when asked, or ``"meta"`` for the dry run
(``launch.dryrun``), whose ranks hold shapes only under a fake process
group: the mesh's groups and coordinates are the real ones, and every
tensor built on its device is a meta tensor, so the dry run needs no
second device rule.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.lm import resolve_device
from repro_torch.parallel.sharding import (
    AXIS_DATA, AXIS_MODEL, AXIS_POD, batch_axes)


def _device(device):
    """The rank's device: ``device``, or its card by default."""
    if device is None and torch.cuda.is_available():
        rank = dist.get_rank() if dist.is_initialized() else 0
        local = int(os.environ.get("LOCAL_RANK", rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return device


class Mesh:
    """``ranks`` of the default process group, increasing (the first
    ``prod(sizes)`` by default), as a grid of ``sizes`` along
    ``axis_names``: ``ranks[i]`` sits at ``np.unravel_index(i, sizes)``.

    ``axis_names`` and ``shape`` (name -> size) read like a JAX mesh's, so
    ``parallel.sharding`` takes either. ``coords`` is this rank's index on
    each axis; ``group(*axes)`` the process group of the ranks that share
    this rank's coordinates on every other axis, ranked by their index
    over ``axes`` (row-major), which ``index(*axes)`` gives;
    ``group(*axis_names)`` holds the whole mesh. On a rank outside
    ``ranks``, ``member`` is False and ``coords`` None.
    """

    def __init__(self, sizes, axis_names, device=None, ranks=None):
        self.device = _device(device)
        if not dist.is_initialized():
            raise RuntimeError("a mesh needs torch.distributed."
                               "init_process_group to have run on every rank")
        world, rank = dist.get_world_size(), dist.get_rank()
        n = math.prod(sizes)
        if n > world:
            raise ValueError(f"mesh {tuple(sizes)} needs {n} ranks, the "
                             f"world has {world}")
        ranks = tuple(range(n)) if ranks is None else tuple(
            int(r) for r in ranks)
        # increasing: a process group ranks its members in that order, and
        # the collectives need it to be the coordinates' order
        if len(ranks) != n or list(ranks) != sorted(set(ranks)) or not all(
                0 <= r < world for r in ranks):
            raise ValueError(f"mesh {tuple(sizes)} needs {n} increasing ranks"
                             f" of the world's {world}, given {ranks}")
        self.ranks, self.member = ranks, rank in ranks
        self.world_group = dist.group.WORLD
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, sizes))
        self.coords = dict(zip(self.axis_names, (
            int(c) for c in np.unravel_index(ranks.index(rank), tuple(
                sizes))))) if self.member else None
        grid = np.array(ranks).reshape(tuple(sizes))
        self._groups = {}
        for axes in ([(a,) for a in self.axis_names]
                     + [batch_axes(self), self.axis_names]):
            if axes and axes not in self._groups:
                self._groups[axes] = self._subgroup(grid, axes)
                # the collectives gather in group-rank order: it must be
                # the coordinates' order
                if self.member and (dist.get_rank(self._groups[axes])
                                    != self.index(*axes)):
                    raise RuntimeError(f"group over {axes} ranks this rank "
                                       f"{dist.get_rank(self._groups[axes])}"
                                       f", not {self.index(*axes)}")

    def _subgroup(self, grid, axes):
        keep = [self.axis_names.index(a) for a in axes]
        other = [i for i in range(grid.ndim) if i not in keep]
        # the kept axes last and flattened: one row of ranks per group
        rows = np.transpose(grid, other + keep).reshape(
            -1, math.prod(grid.shape[i] for i in keep))
        group, _ = dist.new_subgroups_by_enumeration(rows.tolist())
        return group

    def group(self, *axes):
        if not self.member:
            raise ValueError(f"rank {dist.get_rank()} is outside the mesh "
                             f"over ranks {self.ranks}: it has no groups")
        return self._groups[tuple(axes)]

    def size(self, *axes) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, *axes) -> int:
        """This rank's row-major index over ``axes`` (absent axes: 0)."""
        i = 0
        for a in axes:
            i = i * self.shape.get(a, 1) + self.coords.get(a, 0)
        return i


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The reference's production meshes: one pod of 16x16 ranks, or two
    of them."""
    if multi_pod:
        return Mesh((2, 16, 16), (AXIS_POD, AXIS_DATA, AXIS_MODEL), device)
    return Mesh((16, 16), (AXIS_DATA, AXIS_MODEL), device)


def make_mesh(data: int, model: int, pod: int = 1, *, device=None,
              ranks=None) -> Mesh:
    """Any (pod?, data, model) mesh over ``ranks`` of the world (the
    first ``pod * data * model`` by default)."""
    if pod > 1:
        return Mesh((pod, data, model), (AXIS_POD, AXIS_DATA, AXIS_MODEL),
                    device, ranks)
    return Mesh((data, model), (AXIS_DATA, AXIS_MODEL), device, ranks)
