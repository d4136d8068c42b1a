"""Analytic FLOP/byte models per (arch x shape x parallel) cell: the
port's copy of ``benchmarks/flops.py``, over ``repro_torch.configs.base``.

The dry run (``launch.dryrun``) counts what the port executes, one rank at
a time; this model gives the reference's global headline and schedule
terms beside it, and ``launch.roofline`` reads both:

  MODEL_FLOPS   the classic 6*N*D (train) / 2*N_active*D (decode) headline,
  EXEC_FLOPS    what the reference's schedule spends: + attention pair
                grids (masked impl computes the full S x Sk grid — 2x causal
                waste; triangular computes the true lower triangle),
                + MoE capacity-factor padding, + remat recomputation,
  HBM_BYTES     parameter + activation + cache traffic.

All totals are *global*; callers divide by chip count. The formulas are
the reference's, term for term (``tests/test_torch_dryrun.py`` holds
``cell_model`` to it field for field).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig, ParallelConfig, ShapeConfig


def matmul_params(cfg: ModelConfig, active: bool = False) -> int:
    """Parameters that participate in per-token matmuls (excludes the input
    embedding gather, includes the logits head)."""
    d = cfg.d_model
    ncb = max(1, cfg.n_codebooks)
    total = ncb * cfg.vocab_padded * d            # output head(s)
    for i in range(cfg.n_layers):
        if cfg.block_kind(i) == "attn":
            total += d * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * d
        else:
            di, ds, nh, ng = (cfg.d_inner, cfg.d_state, cfg.n_ssm_heads,
                              cfg.ssm_groups)
            total += d * (2 * di + 2 * ng * ds + nh) + di * d
        n_mlp = 3 if cfg.mlp_act == "swiglu" else 2
        if cfg.is_moe_layer(i):
            e = cfg.top_k if active else cfg.n_experts
            mult = cfg.capacity_factor if active else 1.0
            total += int(e * mult) * n_mlp * d * cfg.d_ff_expert if active \
                else e * n_mlp * d * cfg.d_ff_expert
            total += cfg.n_shared_experts * n_mlp * d * cfg.d_ff_expert
            if cfg.dense_residual and cfg.d_ff > 0:
                total += n_mlp * d * cfg.d_ff
        elif cfg.d_ff > 0:
            total += n_mlp * d * cfg.d_ff
    return total


def _attn_layers(cfg: ModelConfig) -> int:
    return sum(1 for i in range(cfg.n_layers) if cfg.block_kind(i) == "attn")


def _ssm_layers(cfg: ModelConfig) -> int:
    return cfg.n_layers - _attn_layers(cfg)


def attention_pair_flops(cfg: ModelConfig, S: int, Sk: int, B: int,
                         impl: str) -> float:
    """Score+PV matmul flops for one full forward over all attn layers."""
    L = _attn_layers(cfg)
    if impl == "triangular" and S == Sk:
        pairs = S * (S + 1) / 2
    else:
        pairs = float(S) * Sk          # masked impl: full grid
    return 4.0 * B * L * cfg.n_heads * cfg.head_dim * pairs  # QK^T + PV


def ssd_flops(cfg: ModelConfig, S: int, B: int) -> float:
    """Chunked SSD dual-form flops for one forward over all ssm layers."""
    L = _ssm_layers(cfg)
    if L == 0:
        return 0.0
    Q = min(cfg.ssm_chunk, S)
    nh, hp, ds = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.d_state
    per_tok = 2 * Q * ds + 2 * Q * hp + 4 * ds * hp   # scores, y, state io
    return float(B) * S * L * nh * per_tok


@dataclass
class CellModel:
    model_flops: float       # 6ND-style headline
    exec_flops: float        # what the schedule really executes
    hbm_bytes: float         # per-step global HBM traffic
    tokens: int


def cell_model(cfg: ModelConfig, shape: ShapeConfig,
               parallel: ParallelConfig) -> CellModel:
    B, S = shape.global_batch, shape.seq_len
    P_mm = matmul_params(cfg)
    P_act = matmul_params(cfg, active=True) if cfg.moe else P_mm
    N_all = cfg.param_count()
    N_act = cfg.param_count(active=True)
    impl = parallel.attn_impl
    if shape.kind == "train":
        tokens = B * S
        model = 6.0 * N_act * tokens
        # fwd + bwd(2x) + remat re-fwd
        mult = 4.0 if parallel.remat != "none" else 3.0
        cap = cfg.capacity_factor if cfg.moe else 1.0
        exec_ = 2.0 * P_act * cap * tokens * mult
        # attention/ssd are matmuls too: same fwd/remat/bwd multiplier
        # (attention_pair_flops is one forward; mult = fwd + remat + 2 bwd)
        exec_ += attention_pair_flops(cfg, S, S, B, impl) * mult
        exec_ += ssd_flops(cfg, S, B) * mult
        # params read fwd+bwd+remat + grads written/reduced + opt state
        hbm = (3 * 2.0 * N_all) + (2.0 * N_all * 2) + (2.0 * 2 * N_all * 2)
        hbm += tokens * cfg.d_model * 2.0 * cfg.n_layers * 4  # act streams
    elif shape.kind == "prefill":
        tokens = B * S
        model = 2.0 * N_act * tokens
        cap = cfg.capacity_factor if cfg.moe else 1.0
        exec_ = 2.0 * P_act * cap * tokens
        exec_ += attention_pair_flops(cfg, S, S, B, impl)
        exec_ += ssd_flops(cfg, S, B)
        kv_bytes = (2 * _attn_layers(cfg) * B * S * cfg.kv_dim * 2.0)
        hbm = 2.0 * N_all + tokens * cfg.d_model * 2.0 * cfg.n_layers * 2 \
            + kv_bytes
    else:  # decode: one token against an S-deep cache
        tokens = B
        model = 2.0 * N_act * tokens
        cap = cfg.capacity_factor if cfg.moe else 1.0
        exec_ = 2.0 * P_act * cap * tokens
        exec_ += 4.0 * B * _attn_layers(cfg) * cfg.n_kv_heads * cfg.head_dim * S
        L_ssm = _ssm_layers(cfg)
        exec_ += 4.0 * B * L_ssm * cfg.n_ssm_heads * cfg.ssm_head_dim * cfg.d_state
        kv_read = 2.0 * _attn_layers(cfg) * B * S * cfg.kv_dim * 2.0
        ssm_read = (L_ssm * B * cfg.n_ssm_heads * cfg.ssm_head_dim
                    * cfg.d_state * 4.0 * 2)
        hbm = 2.0 * N_act + kv_read + ssm_read
    return CellModel(model_flops=model, exec_flops=exec_, hbm_bytes=hbm,
                     tokens=tokens)
