"""The port stands alone and never falls back.

- No module of ``src/repro_torch``, not ``chip_smoke.py`` and not
  ``benchmarks/torch_serve_fleet.py`` imports jax or anything of
  ``repro``; importing every port module loads neither.
- Entry points run on the card unless the caller passes ``device="cpu"``:
  without a card they raise instead of quietly using the CPU.
- The kernel builder raises without nvcc; the kernel wrappers raise on
  CPU tensors; on CPU tensors no launch is ever counted.
- The copied configs equal the JAX package's, field for field.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import init_params, params_from_jax  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention)
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "benchmarks" / "torch_serve_fleet.py"]
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
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


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
    with pytest.raises(ValueError, match="device meta"):
        ops.attention(q.to("meta"), q.to("meta"), q.to("meta"))


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
