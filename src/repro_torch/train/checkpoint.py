"""Atomic checkpoints in ``repro.train.checkpoint``'s format.

Layout: ``<dir>/step_<n>/`` holding one ``leaf_<i>.npy`` per leaf (bf16
stored as a uint16 view, with the dtype tag in the manifest) and a msgpack
``manifest.msgpack`` with the step, the leaf count, the dtypes and a
description of the tree. Writes go to ``step_<n>.tmp`` and are
``os.replace``d into place, so a crash mid-write never corrupts the newest
checkpoint; ``keep`` bounds how many stay. Leaves are numbered in the
order ``jax.tree`` flattens a ``TrainState`` (step, params, m, v; dict
keys sorted), so a directory written by either package restores in the
other.

The manifest is packed and read by this module's own msgpack subset (a
map of str keys to int, str and list of str): the card's environment is
not known to carry the ``msgpack`` package.

Checkpoints stay sharding-agnostic, as the reference's are: a leaf is
always saved whole. Under a mesh (``mesh=``) every rank calls ``save``,
which joins one leaf at a time, a stacked leaf one layer at a time:
the slices over the batch axes (``zero=``: the moments, and the params
too under FSDP storage) first, then those over ``model`` (``split=``),
the last join landing on the host. Rank 0 writes each leaf as it comes
and makes the one atomic rename, and every rank waits on a barrier. On
restore every rank reads the whole leaves and keeps its slices, cut on
the host, so a directory written by a world restores on one device, in
the JAX package or in a world of another shape or strategy, and the
other way round.
"""
from __future__ import annotations

import os
import re
import shutil
import struct

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.lm import sorted_tree_leaves
from repro_torch.parallel.collectives import all_gather
from repro_torch.train.optimizer import TrainState

_BF16 = "bfloat16"
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "int32": torch.int32}


# ------------------------------------------------------------ msgpack
def _pack_str(s: str) -> bytes:
    b = s.encode()
    n = len(b)
    if n < 32:
        return bytes([0xa0 | n]) + b
    for tag, fmt, top in ((0xd9, ">B", 0xff), (0xda, ">H", 0xffff),
                          (0xdb, ">I", 0xffffffff)):
        if n <= top:
            return bytes([tag]) + struct.pack(fmt, n) + b
    raise ValueError("string too long for msgpack")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        table = ((0xcc, ">B", 0xff), (0xcd, ">H", 0xffff),
                 (0xce, ">I", 0xffffffff), (0xcf, ">Q", 2**64 - 1))
        for tag, fmt, top in table:
            if v <= top:
                return bytes([tag]) + struct.pack(fmt, v)
    else:
        table = ((0xd0, ">b", 2**7), (0xd1, ">h", 2**15),
                 (0xd2, ">i", 2**31), (0xd3, ">q", 2**63))
        for tag, fmt, lim in table:
            if v >= -lim:
                return bytes([tag]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} out of msgpack's range")


def _pack_len(n: int, fix: int, tag16: int, tag32: int) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n <= 0xffff:
        return bytes([tag16]) + struct.pack(">H", n)
    return bytes([tag32]) + struct.pack(">I", n)


def _pack(v) -> bytes:
    if isinstance(v, bool) or v is None:
        raise TypeError(f"manifest value {v!r} is outside the packed subset")
    if isinstance(v, int):
        return _pack_int(v)
    if isinstance(v, str):
        return _pack_str(v)
    if isinstance(v, (list, tuple)):
        return _pack_len(len(v), 0x90, 0xdc, 0xdd) + b"".join(
            _pack(x) for x in v)
    if isinstance(v, dict):
        return _pack_len(len(v), 0x80, 0xde, 0xdf) + b"".join(
            _pack_str(k) + _pack(x) for k, x in v.items())
    raise TypeError(f"manifest value of type {type(v).__name__} is outside "
                    "the packed subset")


def packb(obj) -> bytes:
    """``msgpack.packb`` for a map of str keys to int, str and lists of
    str or int: the same bytes."""
    if not isinstance(obj, dict):
        raise TypeError("the manifest is a map")
    return _pack(obj)


def unpackb(data: bytes):
    """``msgpack.unpackb`` for what ``packb`` writes (maps, arrays, str,
    int); anything else raises ``ValueError``."""
    pos = 0

    def take(n):
        nonlocal pos
        if pos + n > len(data):
            raise ValueError("truncated msgpack data")
        out = data[pos:pos + n]
        pos += n
        return out

    def num(fmt):
        return struct.unpack(fmt, take(struct.calcsize(fmt)))[0]

    def read():
        b = take(1)[0]
        if b < 0x80:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0xa0 <= b <= 0xbf:
            return take(b & 0x1f).decode()
        if 0x90 <= b <= 0x9f:
            return [read() for _ in range(b & 0x0f)]
        if 0x80 <= b <= 0x8f:
            return read_map(b & 0x0f)
        ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
                0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
        if b in ints:
            return num(ints[b])
        strs = {0xd9: ">B", 0xda: ">H", 0xdb: ">I"}
        if b in strs:
            return take(num(strs[b])).decode()
        if b in (0xdc, 0xdd):
            return [read() for _ in range(num(">H" if b == 0xdc else ">I"))]
        if b in (0xde, 0xdf):
            return read_map(num(">H" if b == 0xde else ">I"))
        raise ValueError(f"msgpack type byte {b:#04x} is outside the subset")

    def read_map(n):
        out = {}
        for _ in range(n):
            k = read()
            out[k] = read()
        return out

    obj = read()
    if pos != len(data):
        raise ValueError("trailing bytes after the msgpack object")
    return obj


# ------------------------------------------------------------- leaves
def state_leaves(state: TrainState):
    """(name, tensor or int) in ``jax.tree``'s order of a TrainState:
    the step, then params, m and v, each dict's keys sorted."""
    out = [("step", state.step)]
    for part in ("params", "m", "v"):
        out += [(f"{part}/{p}", t)
                for p, t in sorted_tree_leaves(getattr(state, part))]
    return out


def _describe(leaves) -> str:
    return "TrainState(" + ", ".join(name for name, _ in leaves) + ")"


def _leaf_path(d: str, i: int) -> str:
    return os.path.join(d, f"leaf_{i:05d}.npy")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _dtype_name(leaf) -> str:
    if isinstance(leaf, int):
        return "int32"
    return {v: k for k, v in _DTYPES.items()}[leaf.dtype]


def save(path: str, step: int, state: TrainState, keep: int = 3, *,
         mesh=None, zero=None, split=None) -> str:
    """Save ``state`` at ``path/step_<step>``; returns the final dir.
    Under ``mesh`` every rank calls it (with ``zero``, the
    ``parallel.fsdp.BatchCuts`` its moments, and stored params, are cut
    by, and ``split``, the ``bridge.ModelSplit`` its params and moments
    are sliced by over ``model``, each None where it does not apply) and
    rank 0 writes, a leaf at a time: a cut leaf is joined on the host
    (``_joined``), a stacked one a layer at a time."""
    writer = mesh is None or dist.get_rank() == 0
    leaves = state_leaves(state)
    final = os.path.join(path, f"step_{step}")
    tmp = final + ".tmp"
    if writer:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    for i, (name, leaf) in enumerate(leaves):
        joins = [] if isinstance(leaf, int) else _joins(
            name.split("/", 1)[1], leaf.shape, zero, split)
        if not joins or name.split("/")[1] != "blocks":
            arr = _to_numpy(_joined(leaf.detach(), joins) if joins else leaf)
            if writer:
                np.save(_leaf_path(tmp, i), arr)
            continue
        out = None
        for r in range(leaf.shape[0]):
            arr = _to_numpy(_joined(leaf[r].detach(), joins, lead=1))
            if writer:
                if out is None:
                    out = np.lib.format.open_memmap(
                        _leaf_path(tmp, i), mode="w+", dtype=arr.dtype,
                        shape=(leaf.shape[0],) + arr.shape)
                out[r] = arr
        if out is not None:
            out.flush()
            del out
    if writer:
        manifest = {"step": step, "n_leaves": len(leaves),
                    "dtypes": [_dtype_name(leaf) for _, leaf in leaves],
                    "treedef": _describe(leaves)}
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _gc(path, keep)
    if mesh is not None:
        dist.barrier()
    return final


def _joins(path: str, shape, zero, split) -> list:
    """(dim, process group) of each all-gather that makes this rank's
    leaf ``path`` of ``shape`` whole: over the batch axes where it is a
    slice of ``zero``'s cut, then over ``model`` where ``split`` cuts
    it."""
    out = []
    if zero is not None and zero.sliced(path, shape):
        out.append((zero.cuts[path][0], zero.group(path)))
    if split is not None and split.cuts[path] is not None:
        out.append((split.cuts[path][0], split.tp.group))
    return out


def _joined(t, joins, lead: int = 0):
    """``t`` all-gathered along each of ``joins`` in turn (dims ``lead``
    fewer: one layer of a stacked leaf), on the host. A collective: every
    rank calls it, in the same order."""
    for k, (dim, group) in enumerate(joins):
        t = all_gather(t, dim - lead, group,
                       "cpu" if k == len(joins) - 1 else None)
    return t


def _steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(path, name, "manifest.msgpack")):
            out.append(int(m.group(1)))
    return sorted(out)


def _gc(path: str, keep: int):
    steps = _steps(path)
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(os.path.join(path, f"step_{s}"), ignore_errors=True)


def latest_step(path: str) -> int | None:
    steps = _steps(path)
    return steps[-1] if steps else None


def restore(path: str, like: TrainState, step: int | None = None,
            device=None, *, zero=None, split=None):
    """Restore into the layout of ``like`` (tensors of the shapes this
    rank stores, meta tensors will do: their values are not read) and
    return (state, step), the leaves on ``device`` (None: each on its
    ``like`` leaf's device). The leaf count and every shape must match,
    else ValueError; each leaf takes the dtype the manifest names. With
    ``split`` (``bridge.ModelSplit``) the params and moments are this
    rank's slices over ``model``, and with ``zero``
    (``parallel.fsdp.BatchCuts``) a leaf that ``like`` holds as a slice
    of its cut (the moments; the params too under FSDP storage) is this
    rank's slice of that; all cut on the host."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        manifest = unpackb(f.read())
    leaves = state_leaves(like)
    if manifest["n_leaves"] != len(leaves):
        raise ValueError(f"checkpoint has {manifest['n_leaves']} leaves, "
                         f"expected {len(leaves)}")
    out = {}
    for i, (name, lk) in enumerate(leaves):
        arr = np.load(_leaf_path(d, i))
        dt = manifest["dtypes"][i]
        want = () if isinstance(lk, int) else tuple(lk.shape)
        if not isinstance(lk, int):
            path = name.split("/", 1)[1]
            if split is not None:
                arr = _cut(arr, split.cuts[path])
            if zero is not None and zero.sliced(path, want):
                arr = _cut(arr, zero.part(path, arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(f"leaf {i} ({name}): shape {arr.shape}, "
                             f"expected {want}")
        if isinstance(lk, int):
            out[name] = int(arr)
            continue
        if dt == _BF16:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr)).to(_DTYPES[dt])
        out[name] = t.to(lk.device if device is None else device)
    return _state_from_names(like, out), step


def _cut(arr: np.ndarray, cut) -> np.ndarray:
    """The slice ``cut`` = (dim, start, stop) of ``arr``, or ``arr``."""
    if cut is None:
        return arr
    dim, lo, hi = cut
    return arr[(slice(None),) * dim + (slice(lo, hi),)]


def _rebuild(tree, prefix, flat):
    # module level, not a closure: a recursive closure over ``flat`` is a
    # reference cycle, which would keep every restored tensor alive until
    # the garbage collector runs
    return {k: _rebuild(v, f"{prefix}/{k}", flat) if isinstance(v, dict)
            else flat[f"{prefix}/{k}"] for k, v in tree.items()}


def _state_from_names(like: TrainState, flat: dict) -> TrainState:
    return TrainState(step=flat["step"],
                      params=_rebuild(like.params, "params", flat),
                      m=_rebuild(like.m, "m", flat),
                      v=_rebuild(like.v, "v", flat))
