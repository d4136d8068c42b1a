"""What one rank's step holds and computes, counted op by op: the dry
run's memory record (the counterpart of the reference's
``compiled.memory_analysis()``) and its count of torch's FLOPs.

``StepCounter`` is one ``TorchDispatchMode`` for both, so each operation
pays for one Python dispatch, not two. It works on meta tensors, which
carry their sizes, as on the CPU or the card.

- Memory: every storage that an operation creates inside the mode is
  counted from its creation until Python frees it (a finalizer on the
  storage), so the count follows the step's live bytes and keeps their
  peak. An output that views an input's storage (an in-place op, a view)
  creates nothing. ``torch.distributed._tools.mem_tracker.MemTracker``
  was not used: it attributes bytes to ``nn.Module``s and an optimizer
  that it hooks, and the port's steps are functions over nested dicts.
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode``'s formulas (its
  ``flop_registry``), with its rule for an op that has none (count its
  decomposition); ``tests/test_torch_dryrun.py`` holds the count to
  ``FlopCounterMode``'s on the smoke cells.

What the memory record cannot see: the caching allocator's rounding
(512 B blocks, 2 MiB segments) and the free blocks it keeps; cuBLAS's
workspace; ``decode_attention.scratch`` (the persistent partials and
counters that the CUDA wrapper allocates, never on meta) and
``moe_gmm``'s split partials; gloo's pinned host staging and NCCL's
buffers; the CUDA context. Storages created outside the mode (the
step's arguments) are counted by ``storage_bytes``.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# ops FlopCounterMode passes over (metadata queries)
_SKIP = {torch.ops.aten.sym_is_contiguous.default,
         torch.ops.aten.is_contiguous.default,
         torch.ops.aten.is_contiguous.memory_format,
         torch.ops.aten.is_strides_like_format.default,
         torch.ops.aten.is_non_overlapping_and_dense.default,
         torch.ops.aten.size.default, torch.ops.aten.sym_size.default,
         torch.ops.aten.stride.default, torch.ops.aten.sym_stride.default,
         torch.ops.aten.storage_offset.default,
         torch.ops.aten.sym_storage_offset.default,
         torch.ops.aten.numel.default, torch.ops.aten.sym_numel.default,
         torch.ops.aten.dim.default, torch.ops.prim.layout.default}


def _tensors(tree):
    """The tensors of nested dicts, tuples and lists."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages that the tensors of ``trees`` view
    (a storage two views share counts once)."""
    seen = {}
    for tree in trees:
        for t in _tensors(tree):
            st = t.untyped_storage()
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _flat(xs):
    """The tensors among an op's arguments or outputs (tensors, and lists
    or tuples of them)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _flat(x)


class StepCounter(TorchDispatchMode):
    """``with StepCounter() as c:``: ``c.now`` the bytes of the storages
    created inside the block that are still alive, ``c.peak`` their most
    at any point, ``c.flops`` the FLOPs of torch's operations and
    ``c.by_op`` the same by operation ("mm", "bmm", ...)."""

    def __init__(self):
        super().__init__()
        self.now = self.peak = self.flops = 0
        self.by_op: dict[str, int] = {}
        self._live: dict[int, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _SKIP:
            return NotImplemented
        packet = func._overloadpacket
        if (packet not in flop_registry
                and func is not torch.ops.prim.device.default):
            with self:
                out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
        out = func(*args, **kwargs)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += n
            name = packet.__name__
            self.by_op[name] = self.by_op.get(name, 0) + n
        inputs = {t.untyped_storage()._cdata
                  for t in _flat((*args, *kwargs.values()))}
        outs = out if isinstance(out, (list, tuple)) else (out,)
        for t in _flat(outs):
            st = t.untyped_storage()
            if st._cdata not in inputs:
                self._track(st)
        return out

    def _track(self, st) -> None:
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.now += n
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.now -= self._live.pop(key, 0)
