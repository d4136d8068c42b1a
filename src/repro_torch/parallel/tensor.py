"""Tensor parallelism: which dense leaves a rank splits over ``model``,
and how the compute follows.

A rank stores each leaf as the reference's rules place it
(``sharding._TP_RULES``: every ``heads``, ``kv_heads``, ``mlp``,
``vocab``, ``experts`` and ``ssm_inner`` dim on the ``model`` axis where
``resolve_spec``'s size guard lets it), one exception aside (Mamba2,
below). ``tensor_plan`` decides, once for each family, whether its dim
is cut; ``bridge.shard_leaf`` cuts the stored leaves by those fields and
the blocks compute by the same fields, so storage and compute cannot
disagree:

- **attention** (``attn_cut``): ``wq``, ``bq`` and ``wo``'s rows are
  cut along the flattened ``q_dim``, ``wk``, ``wv``, ``bk``, ``bv`` along
  ``kv_dim``, where they divide, even where a rank's columns end
  mid-head. Where ``n_kv_heads % n == 0`` and the decode cache is
  split by heads (``decode_kv_shard`` "heads", no ring), those columns
  are whole heads and a rank attends with them (``attn``): every rank
  holds the same G = H / KVH query heads per KV head, and its caches its
  KV heads. Elsewhere (the ``column`` path) a rank projects its columns
  and the ranks' q, k and v are gathered whole; the QK-norm and RoPE run
  on whole heads. Prefill then splits by heads padded to a multiple of
  n, as the reference's ``padded_heads`` and ``shard_heads`` ask of
  GSPMD (``padded_heads``: rank r attends with heads [r Hp / n, (r + 1)
  Hp / n), the padding zero), and the heads' outputs are gathered back;
  the ring and decode attend whole on every rank over caches of every KV
  head (of a slice of the positions under "seq"), as the reference
  keeps them. Either way a rank multiplies its ``q_dim / n`` columns of
  the output by its rows of ``wo``;
- **an MLP** (the dense MLP, the dense residual, the shared experts) when
  its hidden width divides over the ``n`` ranks: ``w_in`` and ``w_gate``
  by columns, ``w_out`` by rows;
- **the vocab** (``embed`` and ``head`` along ``vocab_padded``) when it
  divides;
- **the experts** (``experts``) when E divides: a rank holds E / n
  experts (``models.moe.moe_apply``) and E / n columns of the router,
  whose logits are gathered whole before the softmax, top-k and the aux
  losses, which every rank computes whole;
- **Mamba2** (``w_z``, ``w_x``, ``conv_x``, ``w_dt`` by columns, ``a_log``,
  ``d_skip``, ``dt_bias`` by heads, ``w_out`` by rows) when its heads divide
  and each rank's heads lie in whole B/C groups, or all in one group
  (where the reference cuts ``ssm_inner`` in any case).
  ``w_B``, ``w_C`` and their convs (``ssm_state``) stay whole, and a rank
  reads the groups its heads use; ``norm`` (axis ``norm``) stays whole and
  a rank reads its slice at use.

Row-parallel products (``wo``, an MLP's ``w_out``, Mamba2's ``w_out``)
leave a partial sum on each rank, which ``reduce`` sums over ``model``;
the vocab-split logits and the router's logits are joined by ``gather``,
attention's column-cut q, k, v and its heads' outputs by ``join``.

Training differentiates through the same split (``parallel.collectives``:
``reduce``'s gradient passes through; ``gather``'s is the rank's slice,
right where every rank uses the whole result alike; ``join``'s is summed
over ``model`` and then the rank's slice, where each rank uses only its
part of the result: the q, k, v whose padded heads it attends with, the
output whose columns it multiplies). Activations are whole on every
rank, so every whole tensor that flows into compute a rank does only its
part of passes through ``enter``, whose gradient is summed over
``model``: the normed residual entering attention, an MLP, Mamba2, the
experts, the router or the head; the router's gates; a whole leaf a rank
reads in part (the QK-norm scales, Mamba2's ``norm``, ``w_B``, ``w_C``
and their convs); and a sum
that split compute reads back (Mamba2's gated norm). Without it, that
tensor's gradient, and everything upstream of it, would be this rank's
part only. What is computed whole from whole inputs (the router's aux
losses, the norms) has a whole gradient on every rank and is not summed
again.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.configs.base import ParallelConfig
from repro_torch.parallel.collectives import (
    enter, fsdp_gather, gather, row_sum)
from repro_torch.parallel.sharding import (
    AXIS_MODEL, mesh_axis_size, resolve_spec)


def decode_kv_shard(cfg, mesh, parallel: ParallelConfig) -> str:
    """"heads" (every rank holds every position of its heads) or "seq"
    (each rank a slice of the positions of every head), as the
    reference's ``Runtime.decode_kv_shard``: "auto" shards the sequence
    when the model axis outnumbers the KV heads."""
    mode = parallel.decode_kv_shard
    if mode != "auto":
        return mode
    if mesh is None or AXIS_MODEL not in mesh.axis_names:
        return "heads"
    return "heads" if cfg.n_kv_heads >= mesh.shape[AXIS_MODEL] else "seq"


@dataclass(frozen=True)
class TensorParallel:
    """One rank's split of the dense leaves: ``n`` ranks on ``model``,
    this rank's ``index`` among them, the ``model`` axis' process group,
    and which families split. The default is one rank holding everything.

    ``attn_cut``: attention's leaves are stored cut over ``model``
    (``bridge.shard_leaf``); ``attn``: that cut is by whole heads and a
    rank attends with its own; ``experts``: the experts and the router's
    columns are cut.
    """
    n: int = 1
    index: int = 0
    group: Any = None
    attn: bool = False
    attn_cut: bool = False
    experts: bool = False
    vocab: bool = False
    ssm: bool = False

    def mlp(self, width: int) -> bool:
        """Whether an MLP of hidden ``width`` splits by columns."""
        return self.n > 1 and width >= self.n and width % self.n == 0

    def part(self, size: int) -> tuple[int, int]:
        """[lo, hi) of a dim of ``size`` that this rank holds."""
        step = size // self.n
        return self.index * step, (self.index + 1) * step

    @property
    def columns(self) -> bool:
        """Whether attention takes the column path: its leaves are cut,
        but not by whole heads this rank attends with."""
        return self.attn_cut and not self.attn

    def heads(self, cfg) -> int:
        return cfg.n_heads // self.n if self.attn else cfg.n_heads

    def kv_heads(self, cfg) -> int:
        return cfg.n_kv_heads // self.n if self.attn else cfg.n_kv_heads

    def padded_heads(self, cfg) -> tuple[int, int]:
        """[lo, hi) of the heads this rank attends with when prefill
        splits by heads padded to Hp = ceil(H / n) * n (the reference's
        ``Runtime.padded_heads``): Hp / n of them, those past H padding."""
        per = -(-cfg.n_heads // self.n)
        return self.index * per, (self.index + 1) * per

    def ssm_heads(self, cfg) -> tuple[int, int]:
        """[lo, hi) of the Mamba2 heads this rank holds."""
        return (self.part(cfg.n_ssm_heads) if self.ssm
                else (0, cfg.n_ssm_heads))

    def vocab_rows(self, cfg) -> tuple[int, int]:
        """[lo, hi) of the ``vocab_padded`` rows this rank holds."""
        return (self.part(cfg.vocab_padded) if self.vocab
                else (0, cfg.vocab_padded))

    def reduce(self, t):
        """The sum over ``model`` of a row-parallel product's partials;
        under autograd its gradient passes through to each partial."""
        return row_sum(t, self.group) if self.n > 1 else t

    def gather(self, t, dim: int):
        """The ranks' column slices joined along ``dim``, in rank order;
        under autograd each rank's gradient is its slice's: right where
        every rank then uses the whole result alike."""
        return gather(t, dim, self.group) if self.n > 1 else t

    def join(self, t, dim: int):
        """The ranks' slices joined along ``dim``, in rank order, for
        compute that each rank does only its part of: under autograd the
        gradient is summed over ``model``, then this rank's slice (a
        reduce-scatter)."""
        return fsdp_gather(t, dim, self.group) if self.n > 1 else t

    def join_qkv(self, q, k, v):
        """The column path's projections (B, S, this rank's columns of
        ``q_dim``, ``kv_dim``, ``kv_dim``) joined whole (``join``), in one
        all-gather of the rank's q | k | v columns."""
        widths = [q.shape[-1], k.shape[-1], v.shape[-1]]
        t = self.join(torch.cat([q, k, v], dim=-1), -1)
        parts = t.unflatten(-1, (self.n, sum(widths))).split(widths, dim=-1)
        return tuple(x.flatten(-2) for x in parts)

    def enter(self, t):
        """``t``, a tensor every rank holds whole, at the entry of compute
        that each rank does only its part of: under autograd its gradient
        is summed over ``model``. Without autograd, ``t`` itself."""
        return enter(t, self.group) if self.n > 1 else t


WHOLE = TensorParallel()


def ssm_groups_whole(cfg, n: int) -> bool:
    """Whether each rank's n_ssm_heads / n heads lie in whole B/C groups,
    or all in one."""
    local, per_group = cfg.n_ssm_heads // n, cfg.n_ssm_heads // cfg.ssm_groups
    return local % per_group == 0 or per_group % local == 0


def _on_model(axes, shape, mesh) -> bool:
    """Whether ``resolve_spec`` places ``model`` on the last of ``axes``
    (a leaf's dims of ``shape``)."""
    spec = resolve_spec(axes, shape, mesh)
    return len(spec) == len(axes) and spec[-1] == AXIS_MODEL


def tensor_plan(cfg, mesh, parallel: ParallelConfig | None = None
                ) -> TensorParallel:
    """This rank's split of ``cfg``'s dense leaves on ``mesh`` (None: one
    rank) under ``parallel`` (the default ``ParallelConfig`` if None).
    Attention's and the experts' cuts are where ``resolve_spec`` places
    them, whatever the mode: the decode cache's split and the ring decide
    only whether a rank attends with its own whole heads (``attn``)."""
    n = mesh_axis_size(mesh, AXIS_MODEL) if mesh is not None else 1
    if n == 1:
        return WHOLE
    parallel = parallel or ParallelConfig()
    has_attn = any(cfg.block_kind(i) == "attn"
                   for i in range(cfg.pattern_period))
    d = cfg.d_model
    q_cut = has_attn and _on_model(("embed", "heads"), (d, cfg.q_dim), mesh)
    attn_cut = q_cut and _on_model(("embed", "kv_heads"), (d, cfg.kv_dim),
                                   mesh)
    if q_cut != attn_cut:
        raise ValueError(
            f"{cfg.name} over {n} model ranks: q_dim {cfg.q_dim} divides, "
            f"kv_dim {cfg.kv_dim} does not; the port cuts attention's "
            "leaves together")
    attn = (attn_cut and cfg.n_kv_heads % n == 0
            and decode_kv_shard(cfg, mesh, parallel) == "heads"
            and not parallel.attn_seq_parallel)
    experts = cfg.moe and _on_model(("embed", "experts"),
                                    (d, cfg.n_experts), mesh)
    ssm = (cfg.ssm and cfg.n_ssm_heads % n == 0
           and ssm_groups_whole(cfg, n))
    group = mesh.group(AXIS_MODEL) if hasattr(mesh, "group") else None
    return TensorParallel(
        n=n, index=mesh.coords[AXIS_MODEL], group=group, attn=attn,
        attn_cut=attn_cut, experts=experts,
        vocab=cfg.vocab_padded % n == 0, ssm=ssm)


def ssm_group_range(cfg, tp: TensorParallel) -> tuple[int, int]:
    """[lo, hi) of the B/C groups this rank's Mamba2 heads read."""
    h0, h1 = tp.ssm_heads(cfg)
    per_group = cfg.n_ssm_heads // cfg.ssm_groups
    return h0 // per_group, -(-h1 // per_group)
