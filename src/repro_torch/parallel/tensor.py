"""Tensor parallelism: which dense leaves a rank splits over ``model``.

The counterpart of the reference's rules (``sharding._TP_RULES``: every
``heads``, ``kv_heads``, ``mlp``, ``vocab`` and ``ssm_inner`` leaf on the
``model`` axis) together with what GSPMD then does to the compute. The
reference leaves the split of the activations to GSPMD, which may pad and
reshape a split head (``Runtime.padded_heads``, ``shard_heads``); the
port splits the compute itself, so a rank always holds whole heads:

- **attention** (``wq``, ``wk``, ``wv``, ``wo`` and the QKV biases, by
  heads) only when ``n_kv_heads % n == 0``: every rank then holds the
  same G = H / KVH query heads per KV head. Under ``decode_kv_shard``
  "seq" or ``attn_seq_parallel`` each rank holds a slice of the positions
  for every head instead, and attention stays whole;
- **an MLP** (the dense MLP, the dense residual, the shared experts) when
  its hidden width divides over the ``n`` ranks: ``w_in`` and ``w_gate``
  by columns, ``w_out`` by rows;
- **the vocab** (``embed`` and ``head`` along ``vocab_padded``) when it
  divides;
- **Mamba2** (``w_z``, ``w_x``, ``conv_x``, ``w_dt`` by columns, ``a_log``,
  ``d_skip``, ``dt_bias`` by heads, ``w_out`` by rows) when its heads divide
  and each rank's heads lie in whole B/C groups, or all in one group.
  ``w_B``, ``w_C`` and their convs (``ssm_state``) stay whole, and a rank
  reads the groups its heads use; ``norm`` (axis ``norm``) stays whole and
  a rank reads its slice at use.

Experts split as ``models.moe.moe_apply`` decides (``E % n == 0``); the
router stays whole. Row-parallel products (``wo``, an MLP's ``w_out``,
Mamba2's ``w_out``) leave a partial sum on each rank, which ``reduce``
sums over ``model``; the vocab-split logits are joined by ``gather``.

Training differentiates through the same split (``parallel.collectives``:
``reduce``'s gradient passes through, ``gather``'s is the rank's slice).
Activations are whole on every rank, so every whole tensor that flows
into compute a rank does only its part of passes through ``enter``, whose
gradient is summed over ``model``: the normed residual entering
attention, an MLP, Mamba2, the experts or the head; the router's gates;
a whole leaf a rank reads in part (the QK-norm scales, Mamba2's ``norm``,
``w_B``, ``w_C`` and their convs); and a sum that split compute reads
back (Mamba2's gated norm). Without it, that tensor's gradient, and
everything upstream of it, would be this rank's part only. What is
computed whole from whole inputs (the router's aux losses, the norms)
has a whole gradient on every rank and is not summed again.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.configs.base import ParallelConfig
from repro_torch.parallel.collectives import enter, gather, row_sum
from repro_torch.parallel.sharding import AXIS_MODEL, mesh_axis_size


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
    """
    n: int = 1
    index: int = 0
    group: Any = None
    attn: bool = False
    vocab: bool = False
    ssm: bool = False

    def mlp(self, width: int) -> bool:
        """Whether an MLP of hidden ``width`` splits by columns."""
        return self.n > 1 and width >= self.n and width % self.n == 0

    def part(self, size: int) -> tuple[int, int]:
        """[lo, hi) of a dim of ``size`` that this rank holds."""
        step = size // self.n
        return self.index * step, (self.index + 1) * step

    def heads(self, cfg) -> int:
        return cfg.n_heads // self.n if self.attn else cfg.n_heads

    def kv_heads(self, cfg) -> int:
        return cfg.n_kv_heads // self.n if self.attn else cfg.n_kv_heads

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
        under autograd each rank's gradient is its slice's."""
        return gather(t, dim, self.group) if self.n > 1 else t

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


def tensor_plan(cfg, mesh, parallel: ParallelConfig | None = None
                ) -> TensorParallel:
    """This rank's split of ``cfg``'s dense leaves on ``mesh`` (None: one
    rank) under ``parallel`` (the default ``ParallelConfig`` if None)."""
    n = mesh_axis_size(mesh, AXIS_MODEL) if mesh is not None else 1
    if n == 1:
        return WHOLE
    parallel = parallel or ParallelConfig()
    has_attn = any(cfg.block_kind(i) == "attn"
                   for i in range(cfg.pattern_period))
    attn = (has_attn and cfg.n_kv_heads % n == 0
            and decode_kv_shard(cfg, mesh, parallel) == "heads"
            and not parallel.attn_seq_parallel)
    ssm = (cfg.ssm and cfg.n_ssm_heads % n == 0
           and ssm_groups_whole(cfg, n))
    group = mesh.group(AXIS_MODEL) if hasattr(mesh, "group") else None
    return TensorParallel(
        n=n, index=mesh.coords[AXIS_MODEL], group=group, attn=attn,
        vocab=cfg.vocab_padded % n == 0, ssm=ssm)


def ssm_group_range(cfg, tp: TensorParallel) -> tuple[int, int]:
    """[lo, hi) of the B/C groups this rank's Mamba2 heads read."""
    h0, h1 = tp.ssm_heads(cfg)
    per_group = cfg.n_ssm_heads // cfg.ssm_groups
    return h0 // per_group, -(-h1 // per_group)
