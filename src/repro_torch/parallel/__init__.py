"""Serving and training across ranks on ``torch.distributed``
(``repro.parallel``).

``sharding`` holds the logical-axis placement rules, ``tensor`` which
dense leaves a rank splits over ``model`` under them (heads, MLPs, vocab,
Mamba2 heads: tensor parallelism), and ``collectives`` the explicit
collectives of the serving path: the sums and gathers that join a
split, sequence-sharded decode attention and ring prefill attention;
expert parallelism lives in ``models.moe.moe_apply``. ``check`` holds
those beside one rank's results for the card tests and the smoke. The
mesh comes from ``launch.mesh``.

``compression`` is the int8 cross-pod gradient exchange of
data-parallel training (``train.train_step``), and ``fsdp`` the cut of
each param leaf over the batch axes: ZeRO-1's moments and, under
``strategy="fsdp_tp"``, the stored params. The reference's
``compat.py`` only bridges JAX API versions (and
``tpu_compiler_params``), so it has no counterpart.
"""
from repro_torch.parallel.sharding import (  # noqa: F401
    AXIS_DATA,
    AXIS_MODEL,
    AXIS_POD,
    batch_axes,
    logical_rules,
    mesh_axis_size,
    resolve_spec,
    spec_tree,
)
