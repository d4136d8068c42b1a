"""Serving across ranks held against one rank on the same inputs.

``collectives_against_kernels`` runs ``seq_sharded_decode_attention`` on
this rank's slice of a whole cache and ``ring_attention`` on whole
prefill inputs, and beside them the kernels that one rank runs on the
whole tensors (the decode kernel, and flash through
``prefill_attention``). ``row_parallel_against_whole`` does the same for
tensor parallelism's row-parallel product. ``join_heads`` puts the
ranks' KV slices back together by heads, and ``bytes_held`` counts what
a rank holds against the whole model. The card tests run them at small
shapes and ``chip_smoke.py``'s parallel phase at the serving path's.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models.attention import prefill_attention
from repro_torch.models.blocks import DECODE_BLOCK_S
from repro_torch.parallel.collectives import (
    all_gather, ring_attention, seq_sharded_decode_attention)
from repro_torch.parallel.sharding import AXIS_MODEL


def collectives_against_kernels(mesh, q, k, v, lengths, new_k, new_v,
                                rq, rk, rv):
    """Every rank passes the same tensors, on its device.

    One decode step: q (B, H, hd), the whole caches k/v (B, S, KVH, hd)
    with S dividing over the ``model`` axis, lengths (B,) int32 (a row at
    S writes nothing), the new token's new_k/new_v (B, KVH, hd). One
    prefill: rq (B', S', H, hd), rk/rv (B', S', KVH, hd). The inputs are
    left as they are.

    Returns a dict: "decode" from the sequence-sharded decode on this
    rank's slice of k/v and "decode_want" from the decode kernel over the
    whole cache with the same writes, at ``lengths + 1`` positions;
    "caches_equal", whether the slices the ranks wrote, gathered, equal
    that whole cache; "ring" and "ring_want", the ring and flash.
    """
    n, i = mesh.shape[AXIS_MODEL], mesh.coords[AXIS_MODEL]
    S = k.shape[1]
    Sl = S // n
    kl, vl = (t[:, i * Sl:(i + 1) * Sl].clone() for t in (k, v))
    o, kl, vl = seq_sharded_decode_attention(q, kl, vl, lengths, new_k,
                                             new_v, mesh)
    k, v = k.clone(), v.clone()
    rows = torch.nonzero(lengths < S)[:, 0]
    k[rows, lengths[rows].long()] = new_k[rows]
    v[rows, lengths[rows].long()] = new_v[rows]
    group = mesh.group(AXIS_MODEL)
    return {
        "decode": o,
        "decode_want": ops.decode(q, k, v, torch.clamp(lengths + 1, max=S),
                                  block_s=DECODE_BLOCK_S),
        "caches_equal": bool(torch.equal(all_gather(kl, 1, group), k)
                             and torch.equal(all_gather(vl, 1, group), v)),
        "ring": ring_attention(rq, rk, rv, mesh),
        "ring_want": prefill_attention(rq, rk, rv)}


def row_parallel_against_whole(tp, x, w):
    """(the row-parallel product, the whole product) of x (..., K) and w
    (K, N), every rank passing the same tensors: this rank multiplies its
    K / n columns of x by its rows of w, and ``tp`` (``parallel.tensor``)
    sums the partials over ``model``, as ``wo`` and the ``w_out``s do."""
    lo, hi = tp.part(w.shape[0])
    return tp.reduce(x[..., lo:hi] @ w[lo:hi]), x @ w


def join_heads(parts):
    """The ranks' KV cache slices (..., KVH / n, hd), in rank order,
    joined by heads into (..., KVH, hd)."""
    return torch.cat(list(parts), dim=-2)


def bytes_held(params) -> int:
    """Bytes of a nested dict of tensors (meta tensors count their
    shapes): what a rank holds, or with ``bridge.meta_params`` and no
    mesh, the whole model."""
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, dict):
            stack.extend(node.values())
        else:
            total += node.numel() * node.element_size()
    return total
