"""The port stands alone and never falls back.

- No module of ``src/repro_torch``, not ``chip_smoke.py``, not
  ``benchmarks/torch_{serve_fleet,elastic,dryrun_compare}.py`` and no
  ``examples/*_torch.py`` imports jax or anything of ``repro``;
  importing every port module loads neither. Nor do they
  import ``msgpack``, which the card is not known to have: the
  checkpoints pack their manifest themselves.
- Entry points run on the card unless the caller passes ``device="cpu"``:
  without a card they raise instead of quietly using the CPU. So does the
  mesh factory (``launch.mesh``).
- The kernel builder raises without nvcc; the kernel wrappers raise on
  CPU tensors; on CPU tensors no launch is ever counted.
- The copied configs and shape cells equal the JAX package's, field for
  field.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import init_params, params_from_jax  # noqa: E402
from repro_torch.core.controller import ElasticController  # noqa: E402
from repro_torch.core.policy import MgmtPolicy  # noqa: E402
from repro_torch.core.provision import ProvisionService  # noqa: E402
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.train_step import build_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "benchmarks" / "torch_serve_fleet.py",
    ROOT / "benchmarks" / "torch_elastic.py",
    ROOT / "benchmarks" / "torch_dryrun_compare.py"] + sorted(
    (ROOT / "examples").glob("*_torch.py"))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
    .removesuffix(".__init__") for p in PORT.rglob("*.py"))
ARCHS = sorted(tconfigs.ARCHS)


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), \
            f"{path}: {name}"


def test_every_port_module_imports_without_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        "sys.modules['jax'] = None\n"
        f"for m in {MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(n for n, m in sys.modules.items()\n"
        "    if m is not None and (n == 'repro'\n"
        "                          or n.startswith(('repro.', 'jax'))))))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []
    assert len(MODULES) >= 20


# ------------------------------------------------------------ no fallback
def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.get_smoke_config("musicgen-large")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        params_from_jax({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM(cfg, params)
    lm = LM(cfg, params, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Engine(lm, max_batch=2, max_len=16)
    Engine(lm, max_batch=2, max_len=16, device="cpu")
    rcfg = tconfigs.RunConfig(model=cfg, shape=tconfigs.ShapeConfig(
        "smoke", "train", 16, 2))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_batches(rcfg)
    synthetic_batches(rcfg, "cpu")
    # the train step runs where its LM lives: the CPU only when asked above
    build_train_step(lm, rcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_loop(rcfg, ckpt_dir="unused", num_steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen2-7b", "--steps", "1"])
    # the controller's default pool is the card; a CPU pool runs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ElasticController(policy=MgmtPolicy.htc(1, 1.0),
                          provision=ProvisionService())
    ElasticController(policy=MgmtPolicy.htc(1, 1.0),
                      provision=ProvisionService(), devices=["cpu"] * 2)


def test_mesh_factory_runs_on_the_card_by_default(monkeypatch):
    """``make_mesh`` and ``make_production_mesh`` take the card unless
    asked for the CPU, and raise without one, before they touch the
    process group; on the CPU a world of one rank serves with no launch
    counted, and the production meshes refuse a world of another size."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh, make_production_mesh
    from repro_torch.models.lm import Runtime
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(1, 1, device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh(1, 1, device="cpu")
        assert (mesh.axis_names, mesh.shape, mesh.coords, mesh.device) == (
            ("data", "model"), {"data": 1, "model": 1},
            {"data": 0, "model": 0}, torch.device("cpu"))
        with pytest.raises(ValueError, match="needs 256 ranks"):
            make_production_mesh(device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1, 1)
        ops.reset_launch_counts()
        cfg = tconfigs.get_smoke_config("arctic-480b")
        lm = LM(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu", mesh=mesh), device="cpu")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Engine(lm, rt=Runtime(mesh=mesh), max_batch=2, max_len=16)
        eng = Engine(lm, rt=Runtime(mesh=mesh), max_batch=2, max_len=16,
                     device="cpu")
        done = eng.run([Request(rid=0, tokens=np.arange(1, 6, dtype=np.int32),
                                max_new_tokens=3)])
        assert len(done[0].out_tokens) == 3
        assert sum(ops.launch_counts().values()) == 0
    finally:
        dist.destroy_process_group()


def test_builder_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.find_nvcc()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
    assert not (tmp_path / "build").exists()


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 4, 16)
    kv = torch.zeros(2, 8, 2, 16)
    lengths = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, kv, kv, lengths)
    with pytest.raises(ValueError, match="CUDA"):
        paged_decode_attention(q, kv, kv, torch.ones(2, 1, dtype=torch.int32),
                               lengths)
    with pytest.raises(ValueError, match="CUDA"):
        moe_gmm(torch.zeros(2, 3, 16), torch.zeros(2, 16, 8))
    x, bc = torch.zeros(1, 16, 2, 16), torch.zeros(1, 16, 1, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(x, torch.zeros(1, 16, 2), torch.zeros(2), bc, bc, chunk=16)
    # ops routes cuda, cpu and meta (the dry run's shapes) and refuses
    # any other device: a stand-in that only reports one
    other = SimpleNamespace(device=torch.device("xla", 0), shape=q.shape,
                            dtype=q.dtype)
    with pytest.raises(ValueError, match="device xla:0"):
        ops.attention(other, other, other)
    assert ops.attention(q.to("meta"), q.to("meta"), q.to("meta")).is_meta


def test_cpu_serving_counts_no_launches():
    """A full CPU serve (prefill + contiguous and paged decode) of an
    attention, an MoE and an SSM arch goes to the plain versions only:
    every launch counter stays 0."""
    ops.reset_launch_counts()
    r = np.random.default_rng(0)
    for arch in ("musicgen-large", "arctic-480b", "mamba2-1.3b"):
        cfg = tconfigs.get_smoke_config(arch)
        lm = LM(cfg, init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu"), device="cpu")
        shape = (5, cfg.n_codebooks) if cfg.n_codebooks > 1 else (5,)
        for page_size in (None, 8):
            eng = Engine(lm, max_batch=2, max_len=32, page_size=page_size,
                         device="cpu")
            done = eng.run([Request(rid=i, tokens=r.integers(
                1, 256, shape).astype(np.int32), max_new_tokens=3)
                for i in range(3)])
            assert len(done) == 3 and eng.steps > 0 and eng.prefills > 0
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "decode_attention": 0,
                                   "paged_decode_attention": 0,
                                   "moe_gmm": 0,
                                   "ssd_scan": 0}


# ---------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ARCHS)
def test_copied_configs_equal_jax_configs(arch):
    for full in (True, False):
        get_t = tconfigs.get_config if full else tconfigs.get_smoke_config
        get_j = jconfigs.get_config if full else jconfigs.get_smoke_config
        t, j = get_t(arch), get_j(arch)
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert (t.vocab_padded, t.q_dim, t.kv_dim, t.pattern_period,
                t.param_count()) == (j.vocab_padded, j.q_dim, j.kv_dim,
                                     j.pattern_period, j.param_count())
    assert dataclasses.asdict(tconfigs.ParallelConfig()) == \
        dataclasses.asdict(jconfigs.ParallelConfig())


def test_copied_shapes_and_run_config_equal_jax():
    """``ShapeConfig``, ``SHAPES`` and ``RunConfig`` field for field:
    names, types, defaults and the four assigned cells."""
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    for name in ("ShapeConfig", "RunConfig", "ParallelConfig"):
        t, j = getattr(tbase, name), getattr(jbase, name)
        tf = [(f.name, str(f.type), f.default, f.default_factory)
              for f in dataclasses.fields(t)]
        jf = [(f.name, str(f.type), f.default, f.default_factory)
              for f in dataclasses.fields(j)]
        # default factories are the package's own ParallelConfig
        norm = [[(n, ty, d, None if fac is dataclasses.MISSING
                  else fac.__name__) for n, ty, d, fac in fs]
                for fs in (tf, jf)]
        assert norm[0] == norm[1], name
    for arch in ARCHS:
        t = tconfigs.RunConfig(model=tconfigs.get_config(arch),
                               shape=tconfigs.SHAPES["train_4k"])
        j = jconfigs.RunConfig(model=jconfigs.get_config(arch),
                               shape=jconfigs.SHAPES["train_4k"])
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.shape.tokens == j.shape.tokens
