"""Logical-axis placement rules (``repro.parallel.sharding``).

Every param leaf carries a tuple of *logical* axis names (``leaf_axes``,
the port's copy of the axes that the reference's ``Scope.param``
records; ``bridge.param_axes`` lays them out as the param tree). A rule
table per strategy maps logical names to mesh axes, and ``resolve_spec``
applies it with the reference's size guards, so one model runs on a
1-rank mesh, the 16x16 production pod and the 2x16x16 multi-pod mesh.

Strategies
----------
``tp``       params placed over ``model`` only (Megatron TP).
``fsdp_tp``  also places the ``embed`` logical axis over (``pod``,
             ``data``) for storage (ZeRO-3 / FSDP).

A placement is a tuple with one entry per dim, trailing replicated dims
dropped as ``PartitionSpec`` drops them: a mesh-axis name, a tuple of
names, or ``None`` (replicated). The functions read only a mesh's
``axis_names`` and ``shape`` (name -> size), so the port's
``launch.mesh.Mesh`` and a shape-only stand-in for a mesh too large to
build both serve. ``sharding_tree`` and ``constrain`` only shape an XLA
program (``NamedSharding``, ``with_sharding_constraint``): the port places
tensors itself and has no counterpart.
"""
from __future__ import annotations

from typing import Any

AXIS_POD = "pod"
AXIS_DATA = "data"
AXIS_MODEL = "model"

# logical axis -> mesh axis / tuple of mesh axes (None = replicated)
_TP_RULES: dict[str, object] = {
    "layers": None,        # stacked layer dim
    "stage": None,
    "embed": None,         # d_model
    "heads": "model",      # flattened q_dim / head dim products
    "kv_heads": "model",
    "mlp": "model",        # ffn hidden
    "vocab": "model",
    "experts": "model",    # expert parallelism over model axis
    "expert_mlp": None,
    "ssm_inner": "model",  # mamba d_inner / heads
    "ssm_state": None,
    "conv": None,
    "codebooks": None,
    "norm": None,
}

_FSDP_EXTRA: dict[str, object] = {
    # storage only; on the multi-pod mesh the pod axis joins the shard
    "embed": ("pod", "data"),
}


# logical axes by (parent, leaf name), as the reference's init functions
# record them; the dense, shared and dense-residual MLPs share ``mlp``'s
_AXES = {
    "embed": ("codebooks", "vocab", "embed"),
    "head": ("codebooks", "embed", "vocab"),
    "attn/wq": ("embed", "heads"), "attn/wk": ("embed", "kv_heads"),
    "attn/wv": ("embed", "kv_heads"), "attn/wo": ("heads", "embed"),
    "attn/bq": ("heads",), "attn/bk": ("kv_heads",), "attn/bv": ("kv_heads",),
    "mlp/w_in": ("embed", "mlp"), "mlp/w_gate": ("embed", "mlp"),
    "mlp/w_out": ("mlp", "embed"),
    "mamba/w_z": ("embed", "ssm_inner"), "mamba/w_x": ("embed", "ssm_inner"),
    "mamba/w_B": ("embed", "ssm_state"), "mamba/w_C": ("embed", "ssm_state"),
    "mamba/w_dt": ("embed", "ssm_inner"),
    "mamba/conv_x": ("conv", "ssm_inner"),
    "mamba/conv_B": ("conv", "ssm_state"),
    "mamba/conv_C": ("conv", "ssm_state"),
    "mamba/a_log": ("ssm_inner",), "mamba/d_skip": ("ssm_inner",),
    "mamba/dt_bias": ("ssm_inner",), "mamba/w_out": ("ssm_inner", "embed"),
    "moe/router": ("embed", "experts"),
    "moe/w_in": ("experts", "embed", "expert_mlp"),
    "moe/w_gate": ("experts", "embed", "expert_mlp"),
    "moe/w_out": ("experts", "expert_mlp", "embed"),
}


def leaf_axes(path: str) -> tuple[str, ...]:
    """The logical axes of the param leaf at ``path`` ('/'-joined), with
    the leading ``layers`` axis of a stacked block leaf."""
    parts = path.split("/")
    name = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    if parent in ("dense_mlp", "shared_mlp"):
        parent = "mlp"
    if name.startswith("norm") or name.endswith("_norm"):
        axes = ("norm",)                  # every rmsnorm scale
    else:
        axes = _AXES[f"{parent}/{name}" if parent else name]
    return ("layers",) + axes if parts[0] == "blocks" else axes


def logical_rules(strategy: str) -> dict[str, object]:
    if strategy == "tp":
        return dict(_TP_RULES)
    if strategy == "fsdp_tp":
        rules = dict(_TP_RULES)
        rules.update(_FSDP_EXTRA)
        return rules
    raise ValueError(f"unknown strategy: {strategy}")


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the batch dim is sharded over (pod folds into data)."""
    return tuple(a for a in (AXIS_POD, AXIS_DATA) if a in mesh.axis_names)


def resolve_spec(axes: tuple[str | None, ...], shape: tuple[int, ...], mesh,
                 strategy: str = "tp") -> tuple:
    """Logical axes + concrete shape -> placement, with size guards.

    A mesh axis is dropped (replicated) when the dim is smaller than the
    axis size or does not divide by it: sub-axis-size dims (8 kv-heads
    over a 16-way model axis) would waste more than half of each shard.
    """
    rules = logical_rules(strategy)
    out: list[Any] = []
    used: set[str] = set()
    for dim, name in zip(shape, axes, strict=True):
        rule = rules.get(name) if name is not None else None
        cand = (rule,) if isinstance(rule, str) else (rule or ())
        mesh_axes = [a for a in cand
                     if a in mesh.axis_names and a not in used]
        # drop axes (outermost first) until the dim shards cleanly
        while mesh_axes:
            total = 1
            for a in mesh_axes:
                total *= mesh.shape[a]
            if dim >= total and dim % total == 0:
                break
            mesh_axes.pop(0)
        if not mesh_axes:
            out.append(None)
            continue
        used.update(mesh_axes)
        out.append(tuple(mesh_axes) if len(mesh_axes) > 1 else mesh_axes[0])
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_tree(axes_tree, shape_tree, mesh, strategy: str = "tp"):
    """Nested dicts of logical-axes tuples and matching shapes ->
    the same nested dict of placements."""
    if isinstance(axes_tree, dict):
        return {k: spec_tree(v, shape_tree[k], mesh, strategy)
                for k, v in axes_tree.items()}
    return resolve_spec(tuple(axes_tree), tuple(shape_tree), mesh, strategy)
