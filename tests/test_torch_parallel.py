"""Serving across ranks (``repro_torch.parallel``, ``launch.mesh``, the
sharded ``LM`` and ``Engine``) against the JAX package under a mesh, on
the CPU, in fp32.

- Placements: ``resolve_spec``/``spec_tree`` equal the reference's for
  every leaf of all ten archs, on the production meshes and the small
  ones, both strategies; ``bridge.param_axes`` equals the reference's
  init axes.
- Collectives and expert-parallel MoE within 1e-5 of the reference's
  ``shard_map`` versions at meshes (1, 2), (1, 4) and (2, 2): GQA, a row
  at ``max_len``, a batch that does not divide over ``data``, a ring whose
  sequence does not divide, drops at capacity factor 1.0. Where a batch
  divides over ``data``, each rank passes its rows and the harness
  gathers them (``tests/test_torch_batch_serve.py`` holds the rows
  themselves).
- ``LM.prefill`` and 4 ``LM.decode`` steps under each mesh (ring
  prefill, sequence-sharded decode, experts split; the MLPs, vocab and
  Mamba2 heads split too, attention stays whole) within 1e-4 on logits
  of the reference's, for arctic's and jamba's smoke configs.
  ``tests/test_torch_tensor_parallel.py`` holds the default ("heads")
  runtime, attention split by heads.
- The port's ``Engine`` under (1, 2) and (1, 4) serves the same greedy
  tokens in the same finish order as its single-rank ``Engine`` and the
  JAX ``Engine``, on every rank.

The reference runs in one subprocess with 4 forced host devices
(``XLA_FLAGS`` must precede jax's import); each world size is one gloo
world of CPU processes, (1, 2) in the world of 2, (1, 4) and (2, 2) in
the world of 4. All three start together from inputs this process writes
with numpy, and weights from one JAX init.
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
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.parallel.sharding import spec_tree as jax_spec_tree  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.models.lm import LM, Runtime, tree_leaves  # noqa: E402
from repro_torch.parallel.sharding import (  # noqa: E402
    batch_axes, mesh_axis_size, resolve_spec, spec_tree)
from repro_torch.parallel.tensor import tensor_plan  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLDS = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
LM_ARCHS = ("arctic-480b", "jamba-1.5-large-398b")
ENGINE_ARCH = "arctic-480b"
PROMPT, STEPS, LM_MAX_LEN = 8, 4, 16
ENG_MAX_BATCH, ENG_MAX_LEN = 3, 32
SEQ = dict(decode_kv_shard="seq", attn_seq_parallel=True)
# (B, H, KVH, hd, S, lengths): a row at max_len (S) writes nothing
DECODE = {"dec_gqa": (4, 8, 2, 16, 32, [3, 16, 31, 32]),
          "dec_b3": (3, 4, 4, 8, 16, [0, 9, 15])}
# (B, S, H, KVH, hd): S 30 does not divide over 4 ranks
RING = {"ring_gqa": (2, 32, 8, 2, 16), "ring_s30": (2, 30, 4, 2, 8),
        "ring_b3": (3, 16, 4, 1, 8)}
# (B, S): B 3 does not divide over data 2
MOE = {"moe_b4": (4, 6), "moe_b3": (3, 5)}
MOE_CFG = dict(n_experts=8, top_k=2, d_model=16, d_ff_expert=32,
               capacity_factor=1.0, mlp_act="swiglu")


def _fp32(arch, **over):
    return dataclasses.replace(jconfigs.get_smoke_config(arch),
                               dtype="float32", **over)


def _engine_cfg(cls_cfg):
    """fp32 and C = T: nothing drops, so the engines' inactive rows, which
    differ (the port resets a finished slot's length), cannot change a
    token (tests/test_torch_engine_moe_ssm.py)."""
    return dataclasses.replace(cls_cfg, dtype="float32",
                               capacity_factor=cls_cfg.n_experts
                               / cls_cfg.top_k)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _requests(cls, vocab):
    """Prompts that divide over 1, 2 and 4 ranks (the ring) and some that
    do not (its fallback); the last fills ``max_len`` with no budget, so
    it decodes once from a full row."""
    r = np.random.default_rng(41)
    plens, budgets = (8, 5, 12, 8, 3, 16, 32), (4, 6, 3, 5, 2, 2, 0)
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
from repro.configs.base import ParallelConfig
from repro.models import moe as jmoe
from repro.models.lm import LM
from repro.parallel.collectives import ring_attention, seq_sharded_decode_attention

work = sys.argv[1]
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
out = {}
for data, model in spec["meshes"]:
    mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(data, model),
                ("data", "model"))
    tag = f"{data}x{model}"
    for name in spec["decode"]:
        a = [jnp.asarray(inp[f"{name}/{k}"]) for k in
             ("q", "k", "v", "lengths", "new_k", "new_v")]
        o, k, v = jax.jit(lambda *a: seq_sharded_decode_attention(
            *a, mesh))(*a)
        out[f"{tag}/{name}/out"], out[f"{tag}/{name}/k"], \
            out[f"{tag}/{name}/v"] = o, k, v
    for name in spec["ring"]:
        a = [jnp.asarray(inp[f"{name}/{k}"]) for k in ("q", "k", "v")]
        out[f"{tag}/{name}/out"] = jax.jit(
            lambda q, k, v: ring_attention(q, k, v, mesh))(*a)
    mcfg = dataclasses.replace(configs.get_smoke_config("arctic-480b"),
                               dtype="float32", **spec["moe_cfg"])
    for name in spec["moe"]:
        p = {w: jnp.asarray(inp[f"{name}/{w}"])
             for w in ("w_in", "w_gate", "w_out")}
        a = [jnp.asarray(inp[f"{name}/{k}"]) for k in ("x", "ids", "wts")]
        out[f"{tag}/{name}/out"] = jax.jit(
            lambda x, i, w: jmoe.moe_apply(p, mcfg, x, i, w, mesh=mesh))(*a)
    for arch in spec["lm_archs"]:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32")
        lm = LM(cfg)
        params = jax.tree_util.tree_map_with_path(
            lambda p, _: jnp.asarray(inp[f"{arch}/params/" + "/".join(
                str(k.key) for k in p)]), lm.init(None, abstract=True)[0])
        rt = lm.runtime(ParallelConfig(**spec["seq"]), mesh)
        toks = jnp.asarray(inp[f"{arch}/prompt"])
        B, S = toks.shape
        logits, pre, _ = jax.jit(lambda p, b: lm.prefill(p, rt, b))(
            params, {"tokens": toks})
        out[f"{tag}/{arch}/prefill"] = logits
        caches = jax.tree.map(
            lambda d, s: jax.lax.dynamic_update_slice(d, s, (0,) * d.ndim),
            lm.init_cache(B, spec["lm_max_len"]), pre)
        step = jax.jit(lambda p, t, l, c: lm.decode(p, rt, t, l, c))
        for i in range(spec["steps"]):
            lengths = jnp.full((B,), S + i, jnp.int32)
            logits, caches = step(params, jnp.asarray(inp[f"{arch}/next"][:, i:i + 1]),
                                  lengths, caches)
            out[f"{tag}/{arch}/decode{i}"] = logits
np.savez(f"{work}/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
print("OK")
"""

_WORKER = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import configs
from repro_torch.bridge import params_from_jax
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import LM, Runtime
from repro_torch.models.moe import moe_apply
from repro_torch.parallel.collectives import (
    all_gather, batch_rows, gather_rows, ring_attention,
    seq_sharded_decode_attention)
from repro_torch.serve.engine import Engine, Request

rank, world, port, work = (int(sys.argv[1]), int(sys.argv[2]),
                           int(sys.argv[3]), sys.argv[4])
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=world)
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
t = lambda a: torch.from_numpy(np.array(a))
out, served = {}, {}


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


def split(B):
    # (this rank's rows, the batch group or None) of a batch of B: the
    # collectives and the serving passes take the rank's rows where B
    # divides over the batch axes, and the whole batch gathers here
    return batch_rows(mesh, B) or (slice(None), None)


for data, model in spec["worlds"][str(world)]:
    mesh = make_mesh(data, model, device="cpu")
    tag = f"{data}x{model}"
    n, i = mesh.shape["model"], mesh.coords["model"]
    for name in spec["decode"]:
        q, k, v, lengths, nk, nv = (t(inp[f"{name}/{x}"]) for x in
                                    ("q", "k", "v", "lengths", "new_k", "new_v"))
        b, group = split(q.shape[0])
        q, k, v, lengths, nk, nv = (x[b] for x in (q, k, v, lengths, nk, nv))
        Sl = k.shape[1] // n
        kl, vl = (c[:, i * Sl:(i + 1) * Sl].clone() for c in (k, v))
        o, kl, vl = seq_sharded_decode_attention(q, kl, vl, lengths, nk, nv, mesh)
        out[f"{tag}/{name}/out"] = gather_rows(o, group)
        out[f"{tag}/{name}/k"] = gather_rows(
            all_gather(kl, 1, mesh.group("model")), group)
        out[f"{tag}/{name}/v"] = gather_rows(
            all_gather(vl, 1, mesh.group("model")), group)
    for name in spec["ring"]:
        q, k, v = (t(inp[f"{name}/{x}"]) for x in ("q", "k", "v"))
        b, group = split(q.shape[0])
        out[f"{tag}/{name}/out"] = gather_rows(
            ring_attention(q[b], k[b], v[b], mesh), group)
    mcfg = dataclasses.replace(configs.get_smoke_config("arctic-480b"),
                               dtype="float32", **spec["moe_cfg"])
    E = mcfg.n_experts
    lo, hi = (i * E // n, (i + 1) * E // n) if E % n == 0 else (0, E)
    for name in spec["moe"]:
        p = {w: t(inp[f"{name}/{w}"][lo:hi]) for w in ("w_in", "w_gate", "w_out")}
        x, ids, wts = (t(inp[f"{name}/{x}"]) for x in ("x", "ids", "wts"))
        b, group = split(x.shape[0])
        out[f"{tag}/{name}/out"] = gather_rows(moe_apply(
            p, mcfg, x[b], ids.long()[b], wts[b], mesh=mesh, data=group),
            group)
    for arch in spec["lm_archs"]:
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32")
        rt = Runtime(ParallelConfig(**spec["seq"]), mesh)
        lm = LM(cfg, params_from_jax(nested(arch + "/params/"), "cpu",
                                     mesh=mesh, cfg=cfg,
                                     parallel=rt.parallel), device="cpu")
        pair = rt.rows(inp[f"{arch}/prompt"].shape[0])
        b, group = pair or (slice(None), None)
        toks = t(inp[f"{arch}/prompt"])[b]
        B, S = toks.shape
        logits, pre = lm.prefill({"tokens": toks}, rt=rt, rows=pair)
        out[f"{tag}/{arch}/prefill"] = gather_rows(logits, group)
        window = rt.seq_window(cfg, spec["lm_max_len"])
        caches = lm.init_cache(B, window[1] - window[0], rt)
        for r in range(B):
            lm.splice(caches, pre, r, r, window=window)
        for s in range(spec["steps"]):
            lengths = torch.full((B,), S + s, dtype=torch.int32)
            logits, caches = lm.decode(t(inp[f"{arch}/next"][:, s:s + 1])[b],
                                       lengths, caches, rt=rt, rows=pair)
            out[f"{tag}/{arch}/decode{s}"] = gather_rows(logits, group)
    if data == 1:
        arch = spec["engine_arch"]
        cfg = configs.get_smoke_config(arch)
        cfg = dataclasses.replace(cfg, dtype="float32",
                                  capacity_factor=cfg.n_experts / cfg.top_k)
        seq = ParallelConfig(**spec["seq"])
        lm = LM(cfg, params_from_jax(nested(arch + "/params/"), "cpu",
                                     mesh=mesh, cfg=cfg, parallel=seq),
                device="cpu")
        eng = Engine(lm, rt=Runtime(seq, mesh),
                     max_batch=spec["eng_max_batch"],
                     max_len=spec["eng_max_len"], device="cpu")
        reqs = [Request(rid=r["rid"], tokens=np.asarray(r["tokens"], np.int32),
                        max_new_tokens=r["budget"]) for r in spec["requests"]]
        served[tag] = [[r.rid, [int(x) for x in r.out_tokens]]
                       for r in eng.run(reqs)]
np.savez(f"{work}/port_{world}_{rank}.npz",
         **{k: v.numpy() for k, v in out.items()})
json.dump(served, open(f"{work}/served_{world}_{rank}.json", "w"))
dist.destroy_process_group()
"""


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


def _inputs(jparams_by_arch):
    """Every case's arrays from numpy seeds: {"case/array": array}."""
    rng = np.random.default_rng(7)
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    inp = {}
    for name, (B, H, KVH, hd, S, lengths) in DECODE.items():
        inp.update({f"{name}/q": f32(B, H, hd), f"{name}/k": f32(B, S, KVH, hd),
                    f"{name}/v": f32(B, S, KVH, hd),
                    f"{name}/lengths": np.array(lengths, np.int32),
                    f"{name}/new_k": f32(B, KVH, hd),
                    f"{name}/new_v": f32(B, KVH, hd)})
    for name, (B, S, H, KVH, hd) in RING.items():
        inp.update({f"{name}/q": f32(B, S, H, hd), f"{name}/k": f32(B, S, KVH, hd),
                    f"{name}/v": f32(B, S, KVH, hd)})
    E, K, d, f = (MOE_CFG[k] for k in ("n_experts", "top_k", "d_model",
                                        "d_ff_expert"))
    for name, (B, S) in MOE.items():
        # skewed choices: the low experts overflow C at capacity 1.0
        pref = np.linspace(3.0, 0.5, E)
        scores = rng.gumbel(size=(B, S, E)) + pref
        ids = np.argsort(-scores, axis=-1)[..., :K].astype(np.int32)
        wts = rng.random((B, S, K)).astype(np.float32)
        inp.update({f"{name}/x": f32(B, S, d), f"{name}/ids": ids,
                    f"{name}/wts": wts / wts.sum(-1, keepdims=True),
                    f"{name}/w_in": f32(E, d, f) / 4,
                    f"{name}/w_gate": f32(E, d, f) / 4,
                    f"{name}/w_out": f32(E, f, d) / 6})
    for arch, jparams in jparams_by_arch.items():
        vocab = jconfigs.get_smoke_config(arch).vocab_size
        inp[f"{arch}/prompt"] = rng.integers(1, vocab, (2, PROMPT)).astype(
            np.int32)
        inp[f"{arch}/next"] = rng.integers(1, vocab, (2, STEPS)).astype(
            np.int32)
        for path, leaf in _flat(jparams):
            inp[f"{arch}/params/{path}"] = np.asarray(leaf)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Write the inputs, then run the JAX subprocess and both gloo worlds
    together; returns (inputs, JAX results, port results by world and
    rank, engine runs by world and rank)."""
    work = tmp_path_factory.mktemp("parallel")
    jparams = {arch: jax.tree.map(np.asarray, JaxLM(_fp32(arch)).init(
        jax.random.key(0))[0]) for arch in LM_ARCHS}
    inp = _inputs(jparams)
    np.savez(work / "inputs.npz", **inp)
    reqs = _requests(JaxRequest, jconfigs.get_smoke_config(
        ENGINE_ARCH).vocab_size)
    spec = {"meshes": MESHES, "worlds": {str(k): v for k, v in WORLDS.items()},
            "decode": list(DECODE), "ring": list(RING), "moe": list(MOE),
            "moe_cfg": MOE_CFG, "lm_archs": list(LM_ARCHS), "seq": SEQ,
            "lm_max_len": LM_MAX_LEN, "steps": STEPS,
            "engine_arch": ENGINE_ARCH, "eng_max_batch": ENG_MAX_BATCH,
            "eng_max_len": ENG_MAX_LEN,
            "requests": [{"rid": r.rid, "tokens": r.tokens.tolist(),
                          "budget": r.max_new_tokens} for r in reqs]}
    (work / "spec.json").write_text(json.dumps(spec))
    base = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}",
                JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _JAX, str(work)],
                              env=base, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)]
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
    served = {(w, r): json.loads((work / f"served_{w}_{r}.json").read_text())
              for w in WORLDS for r in range(w)}
    return inp, dict(np.load(work / "jax.npz")), port, served


def _tag(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _world(mesh):
    return mesh[0] * mesh[1]


# ---------------------------------------------------------------- placements
PLACEMENT_MESHES = [((16, 16), ("data", "model")),
                    ((2, 16, 16), ("pod", "data", "model")),
                    ((1, 2), ("data", "model")), ((1, 4), ("data", "model")),
                    ((2, 2), ("data", "model"))]


def _shape_mesh(sizes, names):
    """A mesh's shape alone: what the placement rules read."""
    return SimpleNamespace(axis_names=names, shape=dict(zip(names, sizes)))


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_param_axes_equal_the_reference_init_axes(arch):
    _, jaxes = JaxLM(jconfigs.get_config(arch)).init(None, abstract=True)
    want = {k: tuple(v) for k, v in _flat(jaxes)}
    got = dict(_flat(bridge.param_axes(tconfigs.get_config(arch))))
    assert got == want


@pytest.mark.parametrize("strategy", ["tp", "fsdp_tp"])
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_placements_equal_the_reference_for_every_leaf(arch, strategy):
    """Published widths, every leaf, the production pod and multi-pod
    meshes and the small test meshes."""
    jparams, jaxes = JaxLM(jconfigs.get_config(arch)).init(None,
                                                           abstract=True)
    jshapes = jax.tree.map(lambda s: s.shape, jparams)
    cfg = tconfigs.get_config(arch)
    axes = bridge.param_axes(cfg)
    shapes = {}
    for path, t in tree_leaves(bridge.meta_params(cfg)):
        node = shapes
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = tuple(t.shape)
    for sizes, names in PLACEMENT_MESHES:
        mesh = _shape_mesh(sizes, names)
        want = jax.tree.map(
            tuple, jax_spec_tree(jaxes, jshapes, mesh, strategy),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got = spec_tree(axes, shapes, mesh, strategy)
        assert dict(_flat(got)) == dict(_flat(want)), (sizes, strategy)


def test_resolve_spec_guards_and_batch_axes():
    pod = _shape_mesh((16, 16), ("data", "model"))
    multi = _shape_mesh((2, 16, 16), ("pod", "data", "model"))
    assert resolve_spec(("embed", "mlp"), (4096, 12800), pod) == (None, "model")
    assert resolve_spec(("kv_heads",), (8,), pod) == ()      # 8 < 16: whole
    assert resolve_spec(("embed",), (48,), multi, "fsdp_tp") == ("data",)
    assert resolve_spec(("embed", "mlp"), (8192, 24576), multi,
                        "fsdp_tp") == (("pod", "data"), "model")
    assert batch_axes(multi) == ("pod", "data")
    assert mesh_axis_size(pod, "pod") == 1
    with pytest.raises(ValueError, match="unknown strategy"):
        resolve_spec(("embed",), (64,), pod, "zeRO9")


@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b",
                                  "jamba-1.5-large-398b", "qwen2-7b",
                                  "musicgen-large", "mamba2-1.3b"])
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_init_is_the_slices_of_the_whole_init(arch, n, monkeypatch):
    """Each rank's leaves are the slices of the single-rank draw, drawn
    whole or slice by slice, and ``params_from_jax`` keeps the same
    slices: the experts and the router's columns, and the dense leaves
    that tensor parallelism splits (attention's columns, every MLP, the
    vocab, the Mamba2 heads); the norms and the B/C projections stay
    whole."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch),
                              dtype="float32")
    experts = (["moe", "w_in"], ["moe", "w_gate"], ["moe", "w_out"],
               ["moe", "router"])
    for limit in (bridge.DRAW_LIMIT_BYTES, 4096):
        monkeypatch.setattr(bridge, "DRAW_LIMIT_BYTES", limit)
        whole = dict(tree_leaves(bridge.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu")))
        for i in range(n):
            mesh = SimpleNamespace(
                **vars(_shape_mesh((1, n), ("data", "model"))),
                coords={"data": 0, "model": i})
            tp = tensor_plan(cfg, mesh)
            part = dict(tree_leaves(bridge.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu", mesh=mesh)))
            carried = dict(tree_leaves(bridge.params_from_jax(
                _nest({k: v.numpy() for k, v in whole.items()}), "cpu",
                mesh=mesh, cfg=cfg)))
            assert part.keys() == whole.keys() == carried.keys()
            cut_paths = set()
            for path, t in part.items():
                cut = bridge.shard_leaf(path, whole[path].shape, mesh, tp)
                want = whole[path]
                if cut is not None:
                    cut_paths.add(path)
                    want = want.narrow(cut[0], cut[1], cut[2] - cut[1])
                    assert t.shape[cut[0]] == whole[path].shape[cut[0]] // n
                assert torch.equal(t, want), path
                assert torch.equal(carried[path], want), path
            families = {"vocab", "mlp"} | (
                {"heads", "kv_heads"} if tp.attn_cut else set()) | (
                {"ssm_inner"} if tp.ssm else set())
            split = {p for p in whole if p.split("/")[-2:] in experts
                     or families & set(bridge.leaf_axes(p))}
            assert cut_paths == split, sorted(cut_paths ^ split)
            assert tp.vocab and (not tp.attn_cut or any(
                p.endswith("/attn/wq") for p in cut_paths))
            assert tp.attn_cut == (cfg.n_heads > 0 and any(
                cfg.block_kind(j) == "attn"
                for j in range(cfg.pattern_period)))
            assert tp.experts == cfg.moe


def _nest(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# -------------------------------------------------------------- collectives
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("case", list(DECODE) + list(RING) + list(MOE))
def test_collectives_and_moe_match_jax(runs, mesh, case):
    _, want, port, _ = runs
    got = port[(_world(mesh), 0)]
    keys = [k for k in want if k.startswith(f"{_tag(mesh)}/{case}/")]
    assert keys
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)
        for r in range(1, _world(mesh)):         # whole on every rank
            np.testing.assert_array_equal(port[(_world(mesh), r)][key],
                                          got[key], err_msg=f"{key} rank {r}")


def test_moe_cases_drop_and_split_the_batch():
    """The MoE cases exercise what they claim: overflow at capacity 1.0,
    and one batch that does not divide over data 2."""
    inp = _inputs({})
    E, K = MOE_CFG["n_experts"], MOE_CFG["top_k"]
    for name, (B, S) in MOE.items():
        ids = inp[f"{name}/ids"].reshape(-1)
        for T in {B * S, B * S // 2} - {0}:
            C = int(np.ceil(T * K / E * MOE_CFG["capacity_factor"]))
            assert np.bincount(ids[:T * K], minlength=E).max() > C, name
    assert MOE["moe_b3"][0] % 2 == 1 and MOE["moe_b4"][0] % 2 == 0
    assert RING["ring_s30"][1] % 4 and DECODE["dec_gqa"][5][-1] == \
        DECODE["dec_gqa"][4]


@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_prefill_and_decode_match_jax_under_the_mesh(runs, mesh, arch):
    """Ring prefill, sequence-sharded decode and split experts together:
    the prefill's and 4 decode steps' logits within 1e-4."""
    _, want, port, _ = runs
    got = port[(_world(mesh), 0)]
    for step in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
        key = f"{_tag(mesh)}/{arch}/{step}"
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
        for r in range(1, _world(mesh)):
            np.testing.assert_array_equal(port[(_world(mesh), r)][key],
                                          got[key])


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def single_rank_runs(runs):
    """The port's single-rank engine and the JAX engine (one device, this
    process) on the same weights and requests."""
    inp = runs[0]
    prefix = f"{ENGINE_ARCH}/params/"
    tree = _nest({k[len(prefix):]: v for k, v in inp.items()
                  if k.startswith(prefix)})
    jcfg = _engine_cfg(jconfigs.get_smoke_config(ENGINE_ARCH))
    jlm = JaxLM(jcfg)
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    jeng = JaxEngine(jlm, jparams, jlm.runtime(JaxParallelConfig()),
                     max_batch=ENG_MAX_BATCH, max_len=ENG_MAX_LEN)
    jdone = jeng.run(_requests(JaxRequest, jcfg.vocab_size))
    lm = LM(_engine_cfg(tconfigs.get_smoke_config(ENGINE_ARCH)),
            bridge.params_from_jax(tree, "cpu"), device="cpu")
    eng = Engine(lm, max_batch=ENG_MAX_BATCH, max_len=ENG_MAX_LEN,
                 device="cpu")
    done = eng.run(_requests(Request, jcfg.vocab_size))
    as_list = lambda rs: [[r.rid, [int(x) for x in r.out_tokens]]  # noqa: E731
                          for r in rs]
    return as_list(jdone), as_list(done)


@pytest.mark.parametrize("mesh", [(1, 2), (1, 4)], ids=_tag)
def test_sharded_engine_serves_the_single_rank_tokens(runs, single_rank_runs,
                                                      mesh):
    jax_served, port_served = single_rank_runs
    assert jax_served == port_served
    assert sorted(r[0] for r in port_served) == list(range(7))
    world = _world(mesh)
    for r in range(world):
        assert runs[3][(world, r)][_tag(mesh)] == port_served, r


# ------------------------------------------------------------------ refusals
def test_paged_kv_under_seq_raises():
    cfg = tconfigs.get_smoke_config("qwen2-7b")
    lm = LM(cfg, bridge.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu"), device="cpu")
    seq = Runtime(ParallelConfig(decode_kv_shard="seq"))
    with pytest.raises(ValueError, match="incompatible with decode_kv_shard"):
        Engine(lm, rt=seq, max_batch=2, max_len=16, page_size=8,
               device="cpu")
    Engine(lm, rt=seq, max_batch=2, max_len=16, device="cpu")


def test_runtime_decode_kv_shard_follows_the_reference_auto_rule():
    cfg = tconfigs.get_smoke_config("qwen2-7b")            # 2 KV heads
    for model, mode in ((2, "heads"), (4, "seq")):
        mesh = SimpleNamespace(**vars(_shape_mesh((1, model),
                                                  ("data", "model"))),
                               coords={"data": 0, "model": model - 1})
        rt = Runtime(ParallelConfig(), mesh)
        assert rt.decode_kv_shard(cfg) == mode
        jrt = JaxLM(jconfigs.get_smoke_config("qwen2-7b")).runtime()
        jrt.mesh = _shape_mesh((1, model), ("data", "model"))
        assert jrt.decode_kv_shard(jconfigs.get_smoke_config("qwen2-7b")) \
            == mode
    assert Runtime().decode_kv_shard(cfg) == "heads"
    rt = Runtime(ParallelConfig(decode_kv_shard="seq"), mesh)
    assert rt.seq_window(cfg, 32) == (24, 32)
    with pytest.raises(ValueError, match="must divide"):
        rt.seq_window(cfg, 30)


def test_parallel_example_serves_on_cpu_ranks():
    """``examples/serve_parallel_torch.py`` over 2 gloo CPU ranks: every
    request served, experts split."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" /
                                               "serve_parallel_torch.py"),
                          "--device", "cpu", "--world", "2"], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "over 2 ranks (gloo, 4 of 8 experts a rank)" in out.stdout
    assert sum(line.startswith("  request ") for line in
               out.stdout.splitlines()) == 6

