"""Tensor-parallel serving (``repro_torch.parallel.tensor``, the split
``LM`` and ``Engine``) against the JAX package under a mesh, on the CPU,
in fp32.

- Placement, with no processes: every leaf's per-rank shape for all ten
  archs at published widths on meshes (1, 2), (1, 4), (16, 16) and
  (2, 16, 16) is ``resolve_spec``'s placement on ``model``, except the
  cases listed in ``WHOLE`` (a rank holds whole heads; the router stays
  whole), each with its reason.
- ``LM.prefill`` and 4 ``LM.decode`` steps under the default
  ``ParallelConfig`` at meshes (1, 2), (1, 4) and (2, 2) within 1e-4 on
  logits of the reference's, equal on every rank, for the smoke configs
  of qwen3-14b (QK-norm, GQA), qwen2-7b (QKV biases), musicgen-large
  (codebooks), mamba2-1.3b (``ssm_inner``), jamba (hybrid, MoE) and
  arctic (dense residual beside the experts). Their KV heads (2) at
  n = 4 keep attention whole ("seq"); musicgen's 4 split one a rank. The
  vocab-split embedding equals the one-rank port's bit for bit. At (2, 2)
  each rank passes its rows of the batch and the harness gathers them.
- The port's ``Engine`` on qwen3's smoke config serves the single-rank
  port's and the JAX engine's tokens in the same finish order,
  contiguous and paged, at every mesh (paged only where attention splits
  by heads: "seq" refuses it).

The reference runs in a subprocess per mesh with 4 forced host devices;
each world size is one gloo world of CPU processes, (1, 2) in the world
of 2, (1, 4) and (2, 2) in the world of 4; all start together, from
inputs this process writes with numpy and weights from one JAX init.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.configs.base import smoke_reduce as jsmoke_reduce  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ParallelConfig, smoke_reduce  # noqa: E402
from repro_torch.models.lm import LM, Runtime, tree_leaves  # noqa: E402
from repro_torch.parallel.check import bytes_held, join_heads  # noqa: E402
from repro_torch.parallel.sharding import resolve_spec  # noqa: E402
from repro_torch.parallel.tensor import tensor_plan  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
ARCHS = ("qwen3-14b", "qwen2-7b", "musicgen-large", "mamba2-1.3b",
         "jamba-1.5-large-398b", "arctic-480b")
ENGINE_ARCH = "qwen3-14b"
# padding that is real: qwen2-7b reduced with n_heads=6 (H 6, KVH 2, hd
# 16, QKV biases), at (1, 4) only: Hp 8, each rank's wq columns span 1.5
# heads and wk's half a head, and rank 3 attends with padding alone.
# Each run's ParallelConfig overrides: the decode cache split by heads
# (contiguous and paged), by sequence, and by sequence with ring prefill.
H6 = "qwen2-h6"
H6_RUNS = {"heads": {"decode_kv_shard": "heads"},
           "seq": {"decode_kv_shard": "seq"},
           "ring": {"decode_kv_shard": "seq", "attn_seq_parallel": True}}
PROMPT, STEPS, LM_MAX_LEN = 8, 4, 16
ENG_MAX_BATCH, ENG_MAX_LEN, PAGE = 3, 32, 8
# what each smoke arch splits at each mesh's model axis: (attention by
# heads, Mamba2 by heads); the vocab (256) and every MLP always split
SPLITS = {
    (arch, n): (attn, arch in ("mamba2-1.3b", "jamba-1.5-large-398b"))
    for arch in ARCHS for n, attn in (
        # KVH 2 at n = 4: "auto" shards the decode cache by sequence, and
        # attention stays whole; musicgen's 4 KV heads split one a rank
        (2, arch != "mamba2-1.3b"),
        (4, arch == "musicgen-large"))}


def _jax_smoke(arch):
    if arch == H6:
        return jsmoke_reduce(jconfigs.get_config("qwen2-7b"), n_heads=6)
    return jconfigs.get_smoke_config(arch)


def _fp32(arch):
    return dataclasses.replace(_jax_smoke(arch), dtype="float32")


def _runs_of(mesh):
    """[key, arch, ParallelConfig overrides] of each LM run at ``mesh``:
    every arch under the default, and at (1, 4) the H6 runs."""
    runs = [[arch, arch, {}] for arch in ARCHS]
    if mesh == (1, 4):
        runs += [[f"{H6}/{mode}", H6, over] for mode, over in H6_RUNS.items()]
    return runs


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _free_ports(n: int) -> list[int]:
    """n distinct free ports: every socket stays bound until all are
    chosen."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _requests(cls, vocab):
    r = np.random.default_rng(43)
    plens, budgets = (8, 5, 12, 8, 3, 16, 20), (4, 6, 3, 5, 2, 8, 6)
    return [cls(rid=i, tokens=r.integers(1, vocab, (p,)).astype(np.int32),
                max_new_tokens=b)
            for i, (p, b) in enumerate(zip(plens, budgets))]


# ------------------------------------------------------ the three processes
_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ParallelConfig, smoke_reduce
from repro.models.lm import LM

work, which = sys.argv[1], int(sys.argv[2])
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
out = {}
for data, model in spec["meshes"][which:which + 1]:
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    tag = f"{data}x{model}"
    for key, arch, over in spec["runs"][tag]:
        cfg = dataclasses.replace(
            smoke_reduce(configs.get_config("qwen2-7b"), n_heads=6)
            if arch == spec["h6"] else configs.get_smoke_config(arch),
            dtype="float32")
        lm = LM(cfg)
        params = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(inp[f"{arch}/params/" + "/".join(
                str(k.key) for k in p)]), lm.init(None, abstract=True)[0])
        rt = lm.runtime(ParallelConfig(**over), mesh)
        toks = jnp.asarray(inp[f"{arch}/prompt"])
        B = toks.shape[0]
        logits, pre, _ = jax.jit(lambda p, b: lm.prefill(p, rt, b))(
            params, {"tokens": toks})
        out[f"{tag}/{key}/prefill"] = logits
        caches = jax.tree.map(
            lambda d, s: jax.lax.dynamic_update_slice(d, s, (0,) * d.ndim),
            lm.init_cache(B, spec["lm_max_len"]), pre)
        step = jax.jit(lambda p, t, l, c: lm.decode(p, rt, t, l, c))
        nxt = inp[f"{arch}/next"]
        for i in range(spec["steps"]):
            lengths = jnp.full((B,), toks.shape[1] + i, jnp.int32)
            logits, caches = step(params, jnp.asarray(nxt[:, i:i + 1]),
                                  lengths, caches)
            out[f"{tag}/{key}/decode{i}"] = logits
np.savez(f"{work}/jax_{which}.npz",
         **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""

_WORKER = r"""
import dataclasses, json, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ParallelConfig, smoke_reduce
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import LM, Runtime
from repro_torch.parallel.collectives import gather_rows
from repro_torch.serve.engine import Engine, Request

rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
t = lambda a: torch.from_numpy(np.array(a))
out, meta = {}, {}


def nested(prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


for data, model in spec["worlds"][str(world)]:
    mesh = make_mesh(data, model, device="cpu")
    tag = f"{data}x{model}"
    for key, arch, over in spec["runs"][tag]:
        rt = Runtime(ParallelConfig(**over), mesh)
        cfg = dataclasses.replace(
            smoke_reduce(configs.get_config("qwen2-7b"), n_heads=6)
            if arch == spec["h6"] else configs.get_smoke_config(arch),
            dtype="float32")
        lm = LM(cfg, params_from_jax(nested(arch + "/params/"), "cpu",
                                     mesh=mesh, cfg=cfg, parallel=rt.parallel),
                device="cpu")
        tp = rt.tensor(cfg)
        meta[f"{tag}/{key}"] = [tp.attn, tp.ssm, tp.vocab,
                                tp.mlp(cfg.d_ff), tp.columns, tp.experts,
                                list(tp.padded_heads(cfg))]
        toks = t(inp[f"{arch}/prompt"])
        out[f"{tag}/{key}/embed"] = lm.embed({"tokens": toks}, rt)
        # the serving passes take the rank's rows where the batch divides
        # over the batch axes; the harness gathers them
        rows = rt.rows(toks.shape[0])
        b, group = rows or (slice(None), None)
        toks = toks[b]
        B, S = toks.shape[:2]
        logits, pre = lm.prefill({"tokens": toks}, rt=rt, rows=rows)
        out[f"{tag}/{key}/prefill"] = gather_rows(logits, group)
        if tp.attn and cfg.block_kind(0) == "attn":
            # this rank's heads
            out[f"{tag}/{key}/k0"] = gather_rows(pre["pos0"][0][0], group)
        window = rt.seq_window(cfg, spec["lm_max_len"])
        caches = lm.init_cache(B, spec["lm_max_len"] if window is None
                               else window[1] - window[0], rt)
        for r in range(B):
            lm.splice(caches, pre, r, r, window=window)
        nxt = inp[f"{arch}/next"]
        for s in range(spec["steps"]):
            lengths = torch.full((B,), S + s, dtype=torch.int32)
            logits, caches = lm.decode(t(nxt[:, s:s + 1])[b], lengths,
                                       caches, rt=rt, rows=rows)
            out[f"{tag}/{key}/decode{s}"] = gather_rows(logits, group)
        if over.get("decode_kv_shard") == "heads":
            # the same steps over a page pool, each row's pages out of order
            ps = spec["page"]
            per_row = spec["lm_max_len"] // ps
            table = torch.arange(B * per_row, dtype=torch.int32).flip(
                0).reshape(B, per_row)
            pool = lm.init_paged_cache(B, B * per_row, ps, rt)
            for r in range(B):
                lm.splice(pool, pre, r, r, pages=table[r].tolist(),
                          page_size=ps)
            for s in range(spec["steps"]):
                lengths = torch.full((B,), S + s, dtype=torch.int32)
                logits, pool = lm.decode(t(nxt[:, s:s + 1])[b], lengths,
                                         pool, table, rt=rt, rows=rows)
                out[f"{tag}/{key}/paged{s}"] = gather_rows(logits, group)
    cfg = dataclasses.replace(configs.get_smoke_config(spec["engine_arch"]),
                              dtype="float32")
    lm = LM(cfg, params_from_jax(nested(spec["engine_arch"] + "/params/"),
                                 "cpu", mesh=mesh, cfg=cfg), device="cpu")
    rt = Runtime(ParallelConfig(), mesh)
    pages = [None] if rt.decode_kv_shard(cfg) == "seq" else [None,
                                                             spec["page"]]
    for ps in pages:
        eng = Engine(lm, rt=rt, max_batch=spec["eng_max_batch"],
                     max_len=spec["eng_max_len"], page_size=ps, device="cpu")
        reqs = [Request(rid=r["rid"], tokens=np.asarray(r["tokens"], np.int32),
                        max_new_tokens=r["budget"]) for r in spec["requests"]]
        meta[f"{tag}/engine/{ps}"] = [[r.rid, [int(x) for x in r.out_tokens]]
                                      for r in eng.run(reqs)]
np.savez(f"{work}/port_{world}_{rank}.npz",
         **{k: v.numpy() for k, v in out.items()})
json.dump(meta, open(f"{work}/meta_{world}_{rank}.json", "w"))
dist.destroy_process_group()
"""


def _inputs(jparams_by_arch):
    rng = np.random.default_rng(11)
    inp = {}
    for arch, jparams in jparams_by_arch.items():
        cfg = _jax_smoke(arch)
        ncb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        inp[f"{arch}/prompt"] = rng.integers(
            1, cfg.vocab_size, (2, PROMPT) + ncb).astype(np.int32)
        inp[f"{arch}/next"] = rng.integers(
            1, cfg.vocab_size, (2, STEPS) + ncb).astype(np.int32)
        for path, leaf in _flat(jparams):
            inp[f"{arch}/params/{path}"] = np.asarray(leaf)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, then run the JAX subprocess and both gloo worlds
    together; returns (inputs, JAX results, port results by world and
    rank, per-rank meta (splits, engine runs) by world and rank)."""
    work = tmp_path_factory.mktemp("tensor_parallel")
    jparams = {arch: jax.tree.map(np.asarray, JaxLM(_fp32(arch)).init(
        jax.random.key(1))[0]) for arch in ARCHS + (H6,)}
    inp = _inputs(jparams)
    np.savez(work / "inputs.npz", **inp)
    reqs = _requests(JaxRequest, jconfigs.get_smoke_config(
        ENGINE_ARCH).vocab_size)
    spec = {"meshes": MESHES, "worlds": {str(k): v for k, v in WORLDS.items()},
            "runs": {_tag(m): _runs_of(m) for m in MESHES}, "h6": H6,
            "lm_max_len": LM_MAX_LEN, "steps": STEPS,
            "engine_arch": ENGINE_ARCH, "eng_max_batch": ENG_MAX_BATCH,
            "eng_max_len": ENG_MAX_LEN, "page": PAGE,
            "requests": [{"rid": r.rid, "tokens": r.tokens.tolist(),
                          "budget": r.max_new_tokens} for r in reqs]}
    (work / "spec.json").write_text(json.dumps(spec))
    base = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(work), str(i)],
                              env=base, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(len(MESHES))]
    for world, port in zip(WORLDS, _free_ports(len(WORLDS))):
        procs += [subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(r), str(world), str(port),
             str(work)], env=base, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-4000:]
    finally:
        for p in procs:
            p.kill()
    port = {(w, r): dict(np.load(work / f"port_{w}_{r}.npz"))
            for w in WORLDS for r in range(w)}
    meta = {(w, r): json.loads((work / f"meta_{w}_{r}.json").read_text())
            for w in WORLDS for r in range(w)}
    want = {}
    for i in range(len(MESHES)):
        want.update(np.load(work / f"jax_{i}.npz"))
    return inp, want, port, meta


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _world(mesh):
    return mesh[0] * mesh[1]


def _params(inp, arch):
    prefix = f"{arch}/params/"
    return _nest({k[len(prefix):]: v for k, v in inp.items()
                  if k.startswith(prefix)})


# ---------------------------------------------------------------- placement
PLACEMENT_MESHES = [((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
                    ((16, 16), ("data", "model")),
                    ((2, 16, 16), ("pod", "data", "model"))]
ATTN = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
# Where ``resolve_spec`` places a leaf on ``model`` and the port keeps it
# whole: (arch, model-axis size) -> {family: reason}. None: attention and
# the router are stored as the reference stores them, by columns, and
# every published Mamba2 keeps its B/C groups whole.
WHOLE = {}
# Where attention's column-cut leaves are not whole heads a rank attends
# with, so it takes the column path (padded heads at prefill, whole
# attention at decode): (arch, model-axis size) -> reason.
_SEQ = "KVH {} < 16: 'auto' shards the decode cache by sequence"
COLUMN_PATH = {
    **{(arch, 16): _SEQ.format(8) for arch in (
        "arctic-480b", "granite-3-8b", "internvl2-76b",
        "jamba-1.5-large-398b", "kimi-k2-1t-a32b", "nemotron-4-15b",
        "qwen3-14b")},
    ("qwen2-7b", 16): _SEQ.format(4) + " (and H 28 pads to 32)",
}


def _shape_mesh(sizes, names, index=0):
    """A mesh's shape and this rank's coordinates (index on ``model``):
    what the placement reads."""
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)),
                           coords={n: (index if n == "model" else 0)
                                   for n in names})


@pytest.mark.parametrize("placement", PLACEMENT_MESHES,
                         ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_per_rank_shapes_follow_resolve_spec_but_whole_heads(arch,
                                                             placement):
    """Published widths: each leaf a rank holds is ``resolve_spec``'s
    slice on ``model`` (attention's and the router's columns included),
    or whole in exactly the cases of ``WHOLE`` (none)."""
    sizes, names = placement
    cfg = tconfigs.get_config(arch)
    mesh = _shape_mesh(sizes, names, index=1)
    n = mesh.shape["model"]
    whole = dict(tree_leaves(bridge.meta_params(cfg)))
    local = dict(tree_leaves(bridge.meta_params(cfg, mesh=mesh)))
    kept_whole = set()
    for path, t in whole.items():
        axes = bridge.leaf_axes(path)
        spec = resolve_spec(axes, tuple(t.shape), mesh)
        want = list(t.shape)
        for d, at in enumerate(spec):
            if at == "model":
                want[d] //= n
        got = list(local[path].shape)
        if got == want:
            continue
        assert got == list(t.shape), path       # else whole
        name = path.split("/")[-1]
        kept_whole.add("router" if name == "router" else
                       "attention" if name in ATTN else path)
    assert kept_whole == set(WHOLE.get((arch, n), {})), (arch, sizes)


def test_whole_cases_are_the_guards_of_tensor_plan():
    """``tensor_plan`` cuts attention's columns and the router's wherever
    ``resolve_spec`` does, for every published arch at n 2, 4 and 16; a
    rank attends with its own whole heads (``attn``) except in the
    ``COLUMN_PATH`` cases, and under "seq" or the ring, where the leaves
    stay column-cut; arctic's experts and its dense residual split where
    they divide."""
    for arch in sorted(tconfigs.ARCHS):
        cfg = tconfigs.get_config(arch)
        for n in (2, 4, 16):
            tp = tensor_plan(cfg, _shape_mesh((1, n), ("data", "model")))
            if cfg.n_heads:
                assert tp.attn_cut, (arch, n)
                assert tp.columns == ((arch, n) in COLUMN_PATH), (arch, n)
                assert tp.attn != tp.columns
                assert tp.padded_heads(cfg) == (0, -(-cfg.n_heads // n))
            else:
                assert not (tp.attn_cut or tp.attn)
            assert tp.experts == cfg.moe, (arch, n)
            assert tp.vocab and tp.n == n
            assert tp.ssm == cfg.ssm, (arch, n)
    qwen3 = tconfigs.get_config("qwen3-14b")
    for over in ({"decode_kv_shard": "seq"}, {"attn_seq_parallel": True}):
        tp = tensor_plan(qwen3, _shape_mesh((1, 2), ("data", "model"),
                                            index=1), ParallelConfig(**over))
        assert not tp.attn and tp.columns and tp.vocab and tp.mlp(17408)
        assert tp.part(qwen3.q_dim) == (2560, 5120)
        assert tp.padded_heads(qwen3) == (20, 40)
    # qwen2-7b at 8 ranks: 28 heads pad to 32, the last rank's all padding
    tp = tensor_plan(tconfigs.get_config("qwen2-7b"),
                     _shape_mesh((1, 8), ("data", "model"), index=7))
    assert tp.columns and tp.padded_heads(tconfigs.get_config(
        "qwen2-7b")) == (28, 32)


def test_qwen3_14b_halves_on_two_ranks():
    """qwen3-14b at published widths over (1, 2): every leaf but the
    norms halves, 27.51 GiB whole against 13.76 GiB a rank."""
    cfg = tconfigs.get_config("qwen3-14b")
    whole = bytes_held(bridge.meta_params(cfg))
    parts = [bytes_held(bridge.meta_params(
        cfg, mesh=_shape_mesh((1, 2), ("data", "model"), index=i)))
        for i in range(2)]
    assert round(whole / 2**30, 2) == 27.51
    assert parts[0] == parts[1]
    norms = sum(t.numel() * t.element_size() for path, t in tree_leaves(
        bridge.meta_params(cfg)) if "norm" in path.split("/")[-1])
    assert parts[0] == (whole - norms) // 2 + norms
    assert round(parts[0] / 2**30, 2) == 13.76


# ---------------------------------------------------------- LM against JAX
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_prefill_and_decode_match_jax(runs, mesh, arch):
    """The prefill's and 4 decode steps' logits within 1e-4 of the
    reference under the same mesh, equal on every rank; the splits are
    the ones ``SPLITS`` names."""
    _, want, port, meta = runs
    world = _world(mesh)
    got = port[(world, 0)]
    attn, ssm = SPLITS[(arch, mesh[1])]
    cfg = tconfigs.get_smoke_config(arch)
    assert meta[(world, 0)][f"{_tag(mesh)}/{arch}"][:6] == [
        attn, ssm, True, cfg.d_ff > 0,
        not attn and any(cfg.block_kind(j) == "attn"
                         for j in range(cfg.pattern_period)), cfg.moe]
    for step in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
        key = f"{_tag(mesh)}/{arch}/{step}"
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
        for r in range(1, world):
            np.testing.assert_array_equal(port[(world, r)][key], got[key])


@pytest.mark.parametrize("run", list(H6_RUNS))
def test_padded_heads_prefill_and_decode_match_jax(runs, run):
    """The H6 config (``smoke_reduce(qwen2-7b, n_heads=6)`` in each
    package) at (1, 4), attention on the column path: prefill split by 8
    padded heads, 2 a rank, rank 3's all padding (or the ring), and 4
    decode steps over caches of every KV head (contiguous, and paged with
    the rows' pages out of order, under "heads"; each rank's slice of the
    positions under "seq"). Logits within 1e-4 of the reference's mesh,
    equal on every rank."""
    _, want, port, meta = runs
    assert dataclasses.replace(tconfigs.get_smoke_config("qwen2-7b"),
                               n_heads=6) == smoke_reduce(
        tconfigs.get_config("qwen2-7b"), n_heads=6)
    cfg = _fp32(H6)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.qkv_bias) == (
        6, 2, 16, True)
    key = f"1x4/{H6}/{run}"
    for r in range(4):
        assert meta[(4, r)][key] == [False, False, True, True, True, False,
                                     [2 * r, 2 * r + 2]], r
    steps = ["prefill"] + [f"decode{i}" for i in range(STEPS)]
    if run == "heads":        # the reference's paged decode equals its
        steps += [f"paged{i}" for i in range(STEPS)]   # contiguous one
    got = port[(4, 0)]
    for step in steps:
        ref = f"{key}/{step.replace('paged', 'decode')}"
        np.testing.assert_allclose(got[f"{key}/{step}"], want[ref],
                                   rtol=1e-4, atol=1e-4, err_msg=step)
        for r in range(1, 4):
            np.testing.assert_array_equal(port[(4, r)][f"{key}/{step}"],
                                          got[f"{key}/{step}"])


@pytest.fixture(scope="module")
def single_rank(runs):
    """The one-rank port on the same weights: each arch's embedding and
    layer 0's K of the prompt (a later layer's follows the MoE capacity,
    which counts a rank's rows when the batch splits over ``data``)."""
    inp = runs[0]
    out = {}
    for arch in ARCHS:
        cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                                  dtype="float32")
        lm = LM(cfg, bridge.params_from_jax(_params(inp, arch), "cpu"),
                device="cpu")
        batch = {"tokens": torch.from_numpy(inp[f"{arch}/prompt"])}
        out[f"{arch}/embed"] = lm.embed(batch).numpy()
        if cfg.block_kind(0) == "attn":
            out[f"{arch}/k0"] = lm.prefill(batch)[1]["pos0"][0][0].numpy()
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", ARCHS)
def test_vocab_split_embedding_equals_one_rank_bitwise(runs, single_rank,
                                                       mesh, arch):
    """Rows outside a rank's range read 0 and each codebook's lookup is
    summed over ``model`` on its own: x + 0 is exact. Where attention
    splits, layer 0's K, the ranks' slices joined by heads, is the
    one-rank K."""
    port, world, n = runs[2], _world(mesh), mesh[1]
    for r in range(world):
        np.testing.assert_array_equal(
            port[(world, r)][f"{_tag(mesh)}/{arch}/embed"],
            single_rank[f"{arch}/embed"])
    key = f"{_tag(mesh)}/{arch}/k0"
    split = SPLITS[(arch, n)][0] and f"{arch}/k0" in single_rank
    assert (key in port[(world, 0)]) == split
    if split:              # ranks 0..n-1 hold data 0, model 0..n-1
        k0 = join_heads(torch.from_numpy(port[(world, r)][key])
                        for r in range(n))
        np.testing.assert_allclose(k0.numpy(), single_rank[f"{arch}/k0"],
                                   rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def single_rank_served(runs):
    """The JAX engine and the port's single-rank engine, contiguous and
    paged, on the same weights and requests."""
    tree = _params(runs[0], ENGINE_ARCH)
    jcfg = _fp32(ENGINE_ARCH)
    jlm = JaxLM(jcfg)
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    lm = LM(dataclasses.replace(tconfigs.get_smoke_config(ENGINE_ARCH),
                                dtype="float32"),
            bridge.params_from_jax(tree, "cpu"), device="cpu")
    as_list = lambda rs: [[r.rid, [int(x) for x in r.out_tokens]]  # noqa: E731
                          for r in rs]
    out = {}
    for ps in (None, PAGE):
        out[("jax", ps)] = as_list(JaxEngine(
            jlm, jparams, jlm.runtime(JaxParallelConfig()),
            max_batch=ENG_MAX_BATCH, max_len=ENG_MAX_LEN,
            page_size=ps).run(_requests(JaxRequest, jcfg.vocab_size)))
        out[("port", ps)] = as_list(Engine(
            lm, max_batch=ENG_MAX_BATCH, max_len=ENG_MAX_LEN, page_size=ps,
            device="cpu").run(_requests(Request, jcfg.vocab_size)))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
def test_tp_engine_serves_the_single_rank_and_jax_tokens(
        runs, single_rank_served, mesh):
    want = single_rank_served[("jax", None)]
    assert sorted(r[0] for r in want) == list(range(7))
    for key, served in single_rank_served.items():
        assert served == want, key
    world = _world(mesh)
    pages = [None] + ([PAGE] if SPLITS[(ENGINE_ARCH, mesh[1])][0] else [])
    for r in range(world):
        meta = runs[3][(world, r)]
        assert sorted(k for k in meta if k.startswith(
            f"{_tag(mesh)}/engine/")) == sorted(
            f"{_tag(mesh)}/engine/{ps}" for ps in pages)
        for ps in pages:
            assert meta[f"{_tag(mesh)}/engine/{ps}"] == want, (r, ps)


# ------------------------------------------------------------------ guards
def test_engine_refuses_weights_of_another_split():
    """Weights split for one mesh (1, 2) under a runtime of another (1, 4)
    raise, naming the leaf; the decode cache's mode does not change what a
    rank stores ("heads" and "seq" cut attention's columns alike).
    ``params_from_jax`` with a mesh needs the config."""
    cfg = tconfigs.get_smoke_config("qwen3-14b")
    mesh = SimpleNamespace(**vars(_shape_mesh((1, 2), ("data", "model"))),
                           device=torch.device("cpu"))
    lm = LM(cfg, bridge.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu", mesh=mesh), device="cpu")
    assert lm.params["blocks"]["pos0"]["attn"]["wq"].shape[-1] \
        == cfg.q_dim // 2
    seq = ParallelConfig(decode_kv_shard="seq")
    assert {p: t.shape for p, t in tree_leaves(bridge.meta_params(
        cfg, mesh=mesh, parallel=seq))} == {
        p: t.shape for p, t in tree_leaves(lm.params)}
    four = SimpleNamespace(**vars(_shape_mesh((1, 4), ("data", "model"))),
                           device=torch.device("cpu"))
    with pytest.raises(ValueError, match="param embed holds"):
        Engine(lm, rt=Runtime(seq, four), max_batch=2, max_len=16,
               device="cpu")
    with pytest.raises(ValueError, match="needs the model's cfg"):
        bridge.params_from_jax({"embed": np.zeros((1, 256, 64), np.float32)},
                               "cpu", mesh=mesh)
