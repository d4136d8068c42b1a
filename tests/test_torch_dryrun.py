"""The port's dry run (``repro_torch.launch.{cells,dryrun,comm_analysis,
flops,memory,roofline}``) against the JAX package's policy, FLOP model and
wire model, and against real runs of the same cells over gloo.

(a) ``default_parallel`` and ``cell_applicable`` equal the reference's for
    every arch, shape and production mesh (a shape-only mesh stands in
    for 512 devices);
(b) ``launch.flops.cell_model`` equals ``benchmarks/flops.py``'s field for
    field;
(c) the wire-byte model and the summary equal ``repro.launch.hlo_analysis``
    on the same op lists;
(d) dry run = real run: a smoke cell's meta step under a fake group of the
    same world and rank records the collectives (kind, dtype, bytes,
    group), the bytes held and the kernel calls of the real step on gloo
    CPU ranks, at meshes (1, 2), (2, 1) and (2, 2);
(e) the param bytes a rank of (16, 16) holds under ``default_parallel``,
    leaf by leaf, equal those of the reference's ``resolve_spec``, but for
    the leaves listed in ``KEPT_WHOLE``;
(f) one full-size cell per family runs on meta at (16, 16).
"""
from __future__ import annotations

import dataclasses
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import meta_params  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.synthetic import input_specs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import comm_analysis as ca  # noqa: E402
from repro_torch.launch import flops as tflops  # noqa: E402
from repro_torch.launch.cells import (  # noqa: E402
    build_cell, cell_applicable, default_parallel)
from repro_torch.launch.dryrun import (  # noqa: E402
    fake_world, main, record, run_cell)
from repro_torch.launch.counter import StepCounter, storage_bytes  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_mesh, make_production_mesh)
from repro_torch.launch.roofline import roofline_row  # noqa: E402
from repro_torch.launch.world import spawn_world  # noqa: E402
from repro_torch.models.lm import tree_leaves  # noqa: E402
from repro_torch.parallel.check import bytes_held  # noqa: E402

ARCHS = sorted(tconfigs.ARCHS)
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _shape_mesh(name):
    sizes, names = MESHES[name]
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)),
                           coords={n: 0 for n in names})


# ----------------------------------------------------------- (a) policy
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_policy_equals_reference(arch, mesh_name):
    from repro.configs import SHAPES as JSHAPES, get_config as jget
    from repro.launch import cells as jcells
    mesh = _shape_mesh(mesh_name)
    for shape in tconfigs.SHAPES:
        cfg, jcfg = tconfigs.get_config(arch), jget(arch)
        got = default_parallel(cfg, tconfigs.SHAPES[shape], mesh)
        want = jcells.default_parallel(jcfg, JSHAPES[shape], mesh)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), shape
        assert (cell_applicable(cfg, tconfigs.SHAPES[shape])
                == jcells.cell_applicable(jcfg, JSHAPES[shape]))
    # no mesh: one microbatch, as the reference gives
    assert dataclasses.asdict(default_parallel(
        cfg, tconfigs.SHAPES["train_4k"])) == dataclasses.asdict(
        jcells.default_parallel(jcfg, JSHAPES["train_4k"]))


# ------------------------------------------------------ (b) FLOP model
@pytest.mark.parametrize("arch", ARCHS)
def test_flop_model_equals_reference(arch):
    from benchmarks import flops as jflops
    from repro.configs import SHAPES as JSHAPES, get_config as jget
    from repro.configs.base import ParallelConfig as JParallel
    cfg, jcfg = tconfigs.get_config(arch), jget(arch)
    assert tflops.matmul_params(cfg) == jflops.matmul_params(jcfg)
    assert (tflops.matmul_params(cfg, active=True)
            == jflops.matmul_params(jcfg, active=True))
    for mesh_name in MESHES:
        for shape in tconfigs.SHAPES:
            for over in ({}, {"attn_impl": "triangular", "remat": "none"}):
                par = dataclasses.replace(default_parallel(
                    cfg, tconfigs.SHAPES[shape], _shape_mesh(mesh_name)),
                    **over)
                got = tflops.cell_model(cfg, tconfigs.SHAPES[shape], par)
                want = jflops.cell_model(jcfg, JSHAPES[shape],
                                         JParallel(**dataclasses.asdict(par)))
                assert dataclasses.asdict(got) == dataclasses.asdict(want)


# ----------------------------------------------------- (c) wire model
@pytest.mark.parametrize("seed", range(3))
def test_wire_model_and_summary_equal_reference(seed):
    from repro.launch import hlo_analysis as jh
    rng = np.random.default_rng(seed)
    kinds = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute")
    ops_, jops = [], []
    for _ in range(200):
        kw = dict(kind=str(rng.choice(kinds)),
                  result_bytes=int(rng.integers(1, 1 << 30)),
                  group_size=int(rng.choice([1, 2, 8, 16, 32, 512])),
                  crosses_pod=bool(rng.integers(2)))
        ops_.append(ca.CollectiveOp(**kw))
        jops.append(jh.CollectiveOp(computation="main", **kw))
    assert [o.wire_bytes for o in ops_] == [o.wire_bytes for o in jops]
    got, want = ca.collective_summary(ops_), jh.collective_summary(jops)
    for key in ("n_ops", "wire_bytes_intra_pod", "wire_bytes_cross_pod",
                "by_kind"):
        assert got[key] == want[key], key
    # the node split covers the same bytes as the pod split
    assert math.isclose(
        got["wire_bytes_intra_node"] + got["wire_bytes_cross_node"],
        got["wire_bytes_intra_pod"] + got["wire_bytes_cross_pod"])


# --------------------------------------------- (d) dry run = real run
SMOKE_ARCHS = ("qwen3-14b", "arctic-480b", "jamba-1.5-large-398b")
SMOKE_SHAPES = {"train": ShapeConfig("smoke_train", "train", 32, 2),
                "prefill": ShapeConfig("smoke_prefill", "prefill", 32, 2),
                "decode": ShapeConfig("smoke_decode", "decode", 32, 4)}


def _smoke_cell(arch, kind, mesh, device):
    """A smoke config's cell; jamba's cut to one pattern of 8 layers
    (Mamba2, attention and MoE), the others at their smoke depth."""
    cfg = tconfigs.get_smoke_config(arch)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    return build_cell(arch, None, mesh, cfg=cfg, shape=SMOKE_SHAPES[kind],
                      device=device)


def _held(cell):
    """What the rank holds, counted leaf by leaf (``bytes_held``)."""
    state = cell.args.get("state")
    return {"params": bytes_held(cell.args["params"]),
            "state": (bytes_held(state.m) + bytes_held(state.v)
                      if state else 0),
            "caches": bytes_held(cell.args.get("caches", {})),
            "batch": bytes_held(cell.args["batch"])}


def _summary(cell, transport="gloo"):
    held = _held(cell)
    rec, out, coll = record(cell.step, cell.args, transport)
    return {"coll": [op.key() for op in coll], "held": held,
            "held_storage": rec["memory"]["held"], "ops": rec["ops"],
            "kernels": rec["kernels"]}


def _real_rank(rank, mesh):
    """Every smoke cell's real step on this gloo CPU rank."""
    torch.manual_seed(0)
    out = {}
    for arch in SMOKE_ARCHS:
        for kind in SMOKE_SHAPES:
            out[arch, kind] = _summary(_smoke_cell(arch, kind, mesh, "cpu"))
    return out


@pytest.mark.parametrize("data,model", [(1, 2), (2, 1), (2, 2)])
def test_dry_run_records_what_the_real_run_does(data, model):
    """Each rank of a gloo world of data x model CPU ranks runs the smoke
    cells (dense, MoE, hybrid; train, prefill, decode) with the recorders
    on; the meta dry run of the same rank under a fake group of the same
    world records the same collectives in the same order (kind, dtype,
    bytes, the group's global ranks), holds the same params, optimizer
    state, caches and batch, and makes the same kernel calls."""
    n = data * model
    real = spawn_world(n, _real_rank, devices=["cpu"] * n, model=model)
    for rank in range(n):
        with fake_world(n, rank):
            mesh = make_mesh(data, model, device="meta")
            for arch in SMOKE_ARCHS:
                for kind in SMOKE_SHAPES:
                    got = _summary(_smoke_cell(arch, kind, mesh, "meta"))
                    want = real[rank][arch, kind]
                    what = f"{arch} {kind} rank {rank} of ({data}, {model})"
                    assert got["coll"] == want["coll"], what
                    assert got["held"] == want["held"], what
                    assert got["held_storage"] == want["held"], what
                    assert got["ops"] == want["ops"], what
                    assert got["kernels"] == want["kernels"], what
                    if model > 1 or kind == "train":
                        assert got["coll"], what


def test_meta_kernels_count_the_card_launches():
    """On meta, ``ops`` returns the kernels' shapes and counts nothing as
    launched; the record gives one launch a call, and moe_gmm two device
    kernels at arctic's decode C 1 (its split over d)."""
    ops.reset_launch_counts()
    cell = build_cell("arctic-480b", None, None, cfg=dataclasses.replace(
        tconfigs.get_config("arctic-480b"), n_layers=1),
        shape=ShapeConfig("d", "decode", 256, 8))
    rec, out, _ = record(cell.step, cell.args)
    assert sum(ops.launch_counts().values()) == 0
    assert out[0].is_meta and out[0].shape == (8,)
    k = rec["kernels"]
    assert k["moe_gmm"]["calls"] == k["moe_gmm"]["launches"] == 3
    assert k["moe_gmm"]["device_kernels"] == 6
    assert k["decode_attention"]["launches"] == 1
    assert rec["ops"] == {"decode": 1, "gmm": 3}


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_counter_flops_equal_flop_counter_mode(arch):
    """``StepCounter`` counts torch's FLOPs as ``FlopCounterMode`` does,
    on the smoke cells' meta steps (jamba's train step, the slowest, on
    one layer pattern)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = tconfigs.get_smoke_config(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    for kind, shape in SMOKE_SHAPES.items():
        counted = []
        for mode in (StepCounter, lambda: FlopCounterMode(display=False)):
            cell = build_cell(arch, None, None, cfg=cfg, shape=shape)
            with mode() as m:
                cell.step()
            counted.append(m.flops if isinstance(m, StepCounter)
                           else m.get_total_flops())
        assert counted[0] == counted[1] > 0, kind


def test_counter_counts_live_storages():
    with StepCounter() as live:
        a = torch.empty(1024, device="meta")            # 4 KiB
        b = a.view(32, 32)                              # no new storage
        a.add_(1)                                       # in place
        c = torch.empty(2048, dtype=torch.bfloat16, device="meta")
        del c                                           # 4 KiB, freed
        d = b + 1                                       # 4 KiB
    assert live.peak == 8192 and live.now == 8192
    with StepCounter() as live:
        e = torch.cat([a, d.view(-1)])                  # 8 KiB
        del e
    assert live.peak == 8192 and live.now == 0
    assert storage_bytes({"x": (a, b)}, [d]) == 8192


def test_input_specs_take_a_ranks_rows():
    cfg = tconfigs.get_config("internvl2-76b")
    whole = input_specs(cfg, tconfigs.SHAPES["train_4k"])
    assert whole["tokens"].shape == (256, 4096 - cfg.n_patches)
    with fake_world(512, 300):
        mesh = make_production_mesh(multi_pod=True, device="meta")
        rows = input_specs(cfg, tconfigs.SHAPES["train_4k"], mesh)
        dec = input_specs(cfg, tconfigs.SHAPES["long_500k"], mesh)
    assert rows["tokens"].shape == (8, 4096 - cfg.n_patches)
    assert rows["patches"].shape == (8, cfg.n_patches, cfg.d_model)
    assert all(t.is_meta for t in rows.values())
    assert dec["tokens"].shape == (1, 1) and dec["lengths"].dtype == torch.int32


# ------------------------------------------- (e) param bytes a rank
# Leaves the port keeps whole over ``model`` at (16, 16) where the
# reference cuts them 16 ways, with the bytes a rank stores in the port:
# none. Attention is stored by columns and the MoE router by its expert
# columns, as ``resolve_spec`` places them.
KEPT_WHOLE = {arch: {} for arch in ARCHS}


def _reference_leaf_bytes(arch, mesh, strategy):
    """Bytes a rank stores of each leaf under the reference's
    ``resolve_spec`` (abstract init: no arrays)."""
    from repro.configs import get_config as jget
    from repro.models.lm import LM as JLM
    from repro.parallel.sharding import resolve_spec
    params, axes = JLM(jget(arch)).init(None, abstract=True)
    out = {}

    def walk(p, a, prefix):
        for k in p:
            path = f"{prefix}/{k}" if prefix else k
            if isinstance(p[k], dict):
                walk(p[k], a[k], path)
                continue
            spec = resolve_spec(tuple(a[k]), p[k].shape, mesh, strategy)
            local = list(p[k].shape)
            for d, at in enumerate(spec):
                for name in ((at,) if isinstance(at, str) else at or ()):
                    local[d] //= mesh.shape[name]
            out[path] = math.prod(local) * np.dtype(p[k].dtype).itemsize

    walk(params, axes, "")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_bytes_a_rank_equal_reference(arch):
    """At (16, 16) under ``default_parallel`` of train_4k and of
    decode_32k, every leaf a rank stores equals the reference's, exactly,
    but the leaves of ``KEPT_WHOLE`` (none), which the port would store
    16x larger."""
    mesh = _shape_mesh("pod")
    cfg = tconfigs.get_config(arch)
    for shape in ("train_4k", "decode_32k"):
        par = default_parallel(cfg, tconfigs.SHAPES[shape], mesh)
        port = {p: t.numel() * t.element_size() for p, t in tree_leaves(
            meta_params(cfg, mesh=mesh, parallel=par))}
        ref = _reference_leaf_bytes(arch, mesh, par.strategy)
        assert set(port) == set(ref)
        differ = {p: port[p] for p in port if port[p] != ref[p]}
        assert differ == KEPT_WHOLE[arch], shape
        for p, n in differ.items():
            assert n == 16 * ref[p], p


# ----------------------------------------- (f) full size, one a family
FULL_CELLS = (("qwen3-14b", "decode_32k"), ("arctic-480b", "prefill_32k"),
              ("mamba2-1.3b", "long_500k"))


@pytest.mark.parametrize("arch,shape", FULL_CELLS)
def test_full_size_cell_runs_on_meta(arch, shape, capsys):
    """One rank of (16, 16) at published widths and depth: the step runs
    on meta, its record is whole, and its params are those of (e)."""
    t0 = time.perf_counter()
    art = run_cell(arch, shape, "pod", rank=17)
    secs = time.perf_counter() - t0
    assert art["status"] == "ok" and art["n_devices"] == 256
    cfg = tconfigs.get_config(arch)
    par = default_parallel(cfg, tconfigs.SHAPES[shape], _shape_mesh("pod"))
    assert art["memory"]["held"]["params"] == bytes_held(meta_params(
        cfg, mesh=_shape_mesh("pod"), parallel=par))
    assert art["memory"]["peak_bytes"] >= art["memory"]["argument_bytes"] > 0
    assert art["cost"]["flops"] > 0 and art["collectives"]["n_ops"] > 0
    row = roofline_row(art)
    assert row["dominant"] in ("compute", "memory", "collective")
    with capsys.disabled():
        print(f"\n[dryrun] {arch} {shape} at (16, 16): {secs:.2f} s")


def test_cli_lists_and_refuses_a_live_group(tmp_path, capsys):
    assert main(["--list", "--arch", "qwen3-14b"]) == 0
    assert len(capsys.readouterr().out.splitlines()) == 8
    with fake_world(2):
        with pytest.raises(RuntimeError, match="already initialized"):
            run_cell("mamba2-1.3b", "decode_32k", "pod")
