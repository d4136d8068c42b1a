"""Model configuration: the port's own copy of ``repro.configs.base``.

``ModelConfig``, ``ShapeConfig``, ``SHAPES``, ``ParallelConfig``,
``RunConfig`` and ``smoke_reduce`` are field-for-field copies of the JAX
package's (a test pins the equality), so a config names the same model and
run in both packages. Of ``ParallelConfig``, serving across ranks
(``models.lm.Runtime``) reads ``decode_kv_shard`` and
``attn_seq_parallel``; training reads ``remat``, ``microbatches``, the
attention chunks and ``attn_impl``, and under a data mesh ``zero1``,
``grad_compress_pod`` and ``strategy`` (``train.train_step``; serving
reads ``strategy`` too: ``fsdp_tp`` stores the params cut over the batch
axes, ``Runtime.fsdp``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_layer_period: int = 1   # MoE on layers where (i % period) == period-1
    dense_residual: bool = False  # arctic-style dense MLP in parallel with MoE
    n_shared_experts: int = 0     # kimi-style always-on shared expert(s)
    capacity_factor: float = 1.25

    # --- attention details ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6

    # --- MLP ---
    mlp_act: str = "swiglu"  # swiglu | sq_relu

    # --- SSM / hybrid ---
    ssm: bool = False              # True: layers default to Mamba2 blocks
    attn_layer_period: int = 0     # hybrid: attention where (i % p) == offset
    attn_layer_offset: int = 3
    d_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    ssm_groups: int = 1    # B/C groups (MQA-like; mamba2 default 1)
    conv_dim: int = 4

    # --- modality ---
    n_codebooks: int = 1   # musicgen: EnCodec codebooks (summed in, multi-head out)
    vision_stub: bool = False
    n_patches: int = 256   # patch embeddings prepended when vision_stub

    # --- numerics ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---- derived sizes ----
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded to a multiple of 256 so it TP-shards cleanly."""
        return ((self.vocab_size + 255) // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def block_kind(self, i: int) -> str:
        """Block kind for layer i: 'attn' or 'ssm'."""
        if not self.ssm:
            return "attn"
        if self.attn_layer_period and i % self.attn_layer_period == self.attn_layer_offset:
            return "attn"
        return "ssm"

    def is_moe_layer(self, i: int) -> bool:
        return self.moe and (i % self.moe_layer_period == self.moe_layer_period - 1)

    @property
    def pattern_period(self) -> int:
        """Length of the repeating layer pattern (scan unit)."""
        p = 1
        if self.ssm and self.attn_layer_period:
            p = self.attn_layer_period
        if self.moe:
            import math
            p = math.lcm(p, self.moe_layer_period)
        if self.n_layers % p:
            raise ValueError(f"{self.name}: {self.n_layers} layers do not "
                             f"divide into pattern period {p}")
        return p

    # ---- parameter counts (for roofline 6ND) ----
    def param_count(self, active: bool = False) -> int:
        d, hd = self.d_model, self.head_dim
        total = self.vocab_size * d * (2 if self.n_codebooks <= 1 else 1 + self.n_codebooks)
        if self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * self.vocab_size * d  # extra in-embeds
        for i in range(self.n_layers):
            if self.block_kind(i) == "attn":
                total += d * (self.q_dim + 2 * self.kv_dim) + self.q_dim * d
                if self.qkv_bias:
                    total += self.q_dim + 2 * self.kv_dim
            else:  # mamba2 block
                di, ds, nh = self.d_inner, self.d_state, self.n_ssm_heads
                ng = self.ssm_groups
                total += d * (2 * di + 2 * ng * ds + nh) + di * d
                total += self.conv_dim * (di + 2 * ng * ds) + 2 * nh + nh + di
            if self.is_moe_layer(i):
                n_mlp = 3 if self.mlp_act == "swiglu" else 2
                e = self.top_k if active else self.n_experts
                total += e * n_mlp * d * self.d_ff_expert
                total += self.n_shared_experts * n_mlp * d * self.d_ff_expert
                total += d * self.n_experts  # router
                if self.dense_residual:
                    total += n_mlp * d * self.d_ff
            elif self.d_ff > 0:
                n_mlp = 3 if self.mlp_act == "swiglu" else 2
                total += n_mlp * d * self.d_ff
            total += 2 * d  # norms
        return total


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell. kind: train | prefill | decode."""
    name: str
    kind: str
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


# The four assigned LM shape cells.
SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class ParallelConfig:
    """How a step is sharded on the mesh. Axes: (pod?, data, model)."""
    strategy: str = "tp"          # tp | fsdp_tp  (param placement)
    zero1: bool = True            # shard optimizer state over data axis
    remat: str = "block"          # none | block | full
    microbatches: int = 1
    moe_dispatch: str = "local"   # local (token-replicated) | a2a
    decode_kv_shard: str = "auto"  # auto | heads | seq
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024
    attn_impl: str = "masked"     # masked (full pairs) | triangular (skip upper)
    attn_seq_parallel: bool = False  # ring attention over the model axis
    grad_compress_pod: bool = False  # int8 cross-pod gradient all-reduce
    pp_over_pod: bool = False        # pipeline the pod axis instead of DP


@dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    shape: ShapeConfig
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    seed: int = 0
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    moment_dtype: str = "bfloat16"   # bf16 moments: fits 1T-param opt state
    master_dtype: str = "float32"    # master params fp32 unless fsdp'd big model


def smoke_reduce(cfg: ModelConfig, **over) -> ModelConfig:
    """Shrink a full config to a CPU-runnable config of the same family."""
    repl = dict(
        n_layers=cfg.pattern_period * 2 if (cfg.ssm or cfg.moe) else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        n_experts=8 if cfg.moe else 0,
        top_k=min(cfg.top_k, 2) if cfg.moe else 0,
        d_ff_expert=64 if cfg.moe else 0,
        d_state=16,
        ssm_head_dim=16,
        ssm_chunk=16,
        n_patches=8 if cfg.vision_stub else cfg.n_patches,
        name=cfg.name + "-smoke",
    )
    repl.update(over)
    return dataclasses.replace(cfg, **repl)
