"""Serving with the batch split over the batch axes (``Runtime.rows``,
``LM.prefill``/``LM.decode(data=)``, the ``Engine``'s slots, the serving
cells) against the JAX package under the same mesh, on the CPU, in fp32.

(a) ``LM.prefill`` and 4 ``LM.decode`` steps at (data 2), (data 2, model
    2) and (pod 2, data 2), each rank on its rows of a batch of 4: arctic's
    smoke config at capacity factor 1.0, where assignments drop (C and the
    fill over the whole batch where the reference's MoE takes no
    ``shard_map``, at model 1; per shard at (2, 2)), jamba's smoke config
    cut to one pattern of 8 layers (Mamba2, attention and MoE), musicgen's
    smoke config (4 codebooks) and qwen3's under ``fsdp_tp`` (the
    embedding's ``all_to_all``): each rank's logits within 1e-4 of its
    rows of the reference's, its caches holding B / n rows.
(b) The ``Engine`` at (2, 1) and (2, 2), contiguous, paged, and paged
    with ``prefill_chunk`` 2, arctic at capacity E / k (nothing drops):
    every rank serves the one-rank engine's and the JAX engine's tokens in
    the same finish order; prefill rows move to the rank of their slot; a
    rank holds half the slots: at (2, 1) its contiguous caches are half of
    one rank's bytes, and its page pool ``1 + (max_batch / 2) *
    pages_per_slot`` pages.
(c) A group whose rows do not divide over the batch axes runs whole on
    every rank; one that divides runs split.
(d) On meta at (16, 16) and (2, 16, 16), the decode_32k and prefill_32k
    cells hold the rank's rows and its caches; long_500k's one row stays
    whole.
(e) ``examples/serve_parallel_torch.py --data 2`` splits the slots.

The reference runs in one subprocess with 4 forced host devices; the
port in gloo worlds of 2 and 4 CPU processes. All start
together, from inputs this process writes with numpy and weights from
one JAX init.
"""
from __future__ import annotations

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.configs.base import ParallelConfig as JaxParallelConfig  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.configs.base import ParallelConfig  # noqa: E402
from repro_torch.launch.cells import build_cell  # noqa: E402
from repro_torch.launch.counter import storage_bytes  # noqa: E402
from repro_torch.launch.dryrun import fake_world  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models.lm import LM, Runtime  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# (pod, data, model) meshes by world size
WORLDS = {2: [(1, 2, 1)], 4: [(1, 2, 2), (2, 2, 1)]}
MESHES = [m for ms in WORLDS.values() for m in ms]
ARCTIC, JAMBA = "arctic-480b", "jamba-1.5-large-398b"
LM_ARCHS = {ARCTIC: dict(over={"capacity_factor": 1.0}, strategy="tp"),
            JAMBA: dict(over={}, strategy="tp"),
            "musicgen-large": dict(over={}, strategy="tp"),
            "qwen3-14b": dict(over={}, strategy="fsdp_tp")}
B, PROMPT, STEPS, LM_MAX_LEN = 4, 8, 4, 16
ENG_ARCH = ARCTIC
ENG_MESHES = [(1, 2, 1), (1, 2, 2)]
ENG_MAX_BATCH, ENG_MAX_LEN, PAGE = 4, 32, 8
# (page_size, prefill_chunk) of each engine run
ENG_MODES = [(None, None), (PAGE, None), (PAGE, 2)]


def _tag(mesh):
    return "x".join(map(str, mesh))


def _cfg(pkg, arch):
    cfg = dataclasses.replace(pkg.get_smoke_config(arch), dtype="float32",
                              **LM_ARCHS[arch]["over"])
    if arch == JAMBA:
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    return cfg


def _engine_cfg(pkg):
    """fp32 and C = T: nothing drops, so the engines' inactive rows, which
    differ (the port resets a finished slot's length), cannot change a
    token (tests/test_torch_engine_moe_ssm.py)."""
    cfg = pkg.get_smoke_config(ENG_ARCH)
    return dataclasses.replace(cfg, dtype="float32",
                               capacity_factor=cfg.n_experts / cfg.top_k)


def _requests(cls, vocab):
    """The first window's two 8-token prompts form a group that splits
    over data 2 (slots 3 and 2, both on rank 1: one row moves); single
    prompts and the group of three 5-token ones run whole."""
    r = np.random.default_rng(17)
    plens, budgets = (8, 8, 5, 12, 5, 5, 8, 12, 8), (4, 6, 3, 5, 2, 4, 3,
                                                    2, 5)
    return [cls(rid=i, tokens=r.integers(1, vocab, (p,)).astype(np.int32),
                max_new_tokens=b)
            for i, (p, b) in enumerate(zip(plens, budgets))]


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


# ------------------------------------------------------ the processes
_JAX = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ParallelConfig
from repro.models.lm import LM

work = sys.argv[1]
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
out = {}
for (pod, data, model), (arch, case) in (
        (m, a) for m in spec["meshes"] for a in spec["lm_archs"].items()):
    devs = np.array(jax.devices()[:pod * data * model])
    mesh = Mesh(devs.reshape(pod, data, model), ("pod", "data", "model"))
    tag = f"{pod}x{data}x{model}"
    cfg = dataclasses.replace(configs.get_smoke_config(arch),
                              dtype="float32", **case["over"])
    if arch == spec["cut"]:
        cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
    lm = LM(cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, _: jnp.asarray(inp[f"{arch}/params/" + "/".join(
            str(k.key) for k in p)]), lm.init(None, abstract=True)[0])
    rt = lm.runtime(ParallelConfig(strategy=case["strategy"]), mesh)
    toks = jnp.asarray(inp[f"{arch}/prompt"])
    Bn, S = toks.shape[:2]
    logits, pre, _ = jax.jit(lambda p, b: lm.prefill(p, rt, b))(
        params, {"tokens": toks})
    out[f"{tag}/{arch}/prefill"] = logits
    caches = jax.tree.map(
        lambda d, s: jax.lax.dynamic_update_slice(d, s, (0,) * d.ndim),
        lm.init_cache(Bn, spec["lm_max_len"]), pre)
    step = jax.jit(lambda p, t, l, c: lm.decode(p, rt, t, l, c))
    for i in range(spec["steps"]):
        lengths = jnp.full((Bn,), S + i, jnp.int32)
        logits, caches = step(params, jnp.asarray(
            inp[f"{arch}/next"][:, i:i + 1]), lengths, caches)
        out[f"{tag}/{arch}/decode{i}"] = logits
np.savez(f"{work}/jax.npz", **{k: np.asarray(v) for k, v in out.items()})
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
from repro_torch.configs.base import ParallelConfig
from repro_torch.launch.counter import storage_bytes
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import moe
from repro_torch.models.lm import LM, Runtime
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


drops = []
dispatch = moe.dispatch


def counted(ids, cfg, data=None):
    tok, slot, kept = dispatch(ids, cfg, data)
    drops.append(int((~kept).sum()))
    return tok, slot, kept


moe.dispatch = counted
for pod, data, model in spec["worlds"][str(world)]:
    mesh = make_mesh(data, model, pod, device="cpu")
    tag = f"{pod}x{data}x{model}"
    for arch, case in spec["lm_archs"].items():
        cfg = dataclasses.replace(configs.get_smoke_config(arch),
                                  dtype="float32", **case["over"])
        if arch == spec["cut"]:
            cfg = dataclasses.replace(cfg, n_layers=cfg.pattern_period)
        rt = Runtime(ParallelConfig(strategy=case["strategy"]), mesh)
        lm = LM(cfg, params_from_jax(nested(arch + "/params/"), "cpu",
                                     mesh=mesh, cfg=cfg,
                                     parallel=rt.parallel), device="cpu")
        pair = rt.rows(spec["batch"])
        rows = pair[0]
        toks = t(inp[f"{arch}/prompt"])[rows]
        drops.clear()
        logits, pre = lm.prefill({"tokens": toks}, rt=rt, rows=pair)
        out[f"{tag}/{arch}/prefill"] = logits
        Bl, S = toks.shape[:2]
        caches = lm.init_cache(Bl, spec["lm_max_len"], rt)
        for b in range(Bl):
            lm.splice(caches, pre, b, b)
        for s in range(spec["steps"]):
            lengths = torch.full((Bl,), S + s, dtype=torch.int32)
            logits, caches = lm.decode(
                t(inp[f"{arch}/next"][:, s:s + 1])[rows], lengths, caches,
                rt=rt, rows=pair)
            out[f"{tag}/{arch}/decode{s}"] = logits
        meta[f"{tag}/{arch}"] = {
            "rows": [rows.start, rows.stop], "drops": sum(drops),
            "cache_rows": sorted({c.shape[1] for c in
                                  torch.utils._pytree.tree_leaves(caches)})}
    if (pod, data, model) not in map(tuple, spec["eng_meshes"]):
        continue
    cfg = dataclasses.replace(configs.get_smoke_config(spec["eng_arch"]),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    rt = Runtime(ParallelConfig(), mesh)
    lm = LM(cfg, params_from_jax(nested(spec["eng_arch"] + "/params/"),
                                 "cpu", mesh=mesh, cfg=cfg), device="cpu")
    prefill = lm.prefill
    for ps, chunk in spec["eng_modes"]:
        calls = []

        def seen(batch, rt=None, rows=None):
            calls.append([int(batch["tokens"].shape[0]), rows is not None])
            return prefill(batch, rt, rows=rows)

        lm.prefill = seen
        eng = Engine(lm, rt=rt, max_batch=spec["eng_max_batch"],
                     max_len=spec["eng_max_len"], page_size=ps,
                     prefill_chunk=chunk, device="cpu")
        reqs = [Request(rid=r["rid"], tokens=np.asarray(r["tokens"], np.int32),
                        max_new_tokens=r["budget"]) for r in spec["requests"]]
        meta[f"{tag}/engine/{ps}/{chunk}"] = {
            "served": [[r.rid, [int(x) for x in r.out_tokens]]
                       for r in eng.run(reqs)],
            "moved": eng.moved_rows, "calls": calls,
            "own": [eng.own.start, eng.own.stop],
            "cache_bytes": storage_bytes(eng.caches),
            "pages": None if eng.pager is None else eng.pager.n_pages}
        del lm.prefill
np.savez(f"{work}/port_{world}_{rank}.npz",
         **{k: v.numpy() for k, v in out.items()})
json.dump(meta, open(f"{work}/meta_{world}_{rank}.json", "w"))
dist.destroy_process_group()
"""


def _free_ports(n: int) -> list[int]:
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _inputs():
    rng = np.random.default_rng(23)
    inp = {}
    for arch in LM_ARCHS:
        cfg = _cfg(jconfigs, arch)
        ncb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
        inp[f"{arch}/prompt"] = rng.integers(
            1, cfg.vocab_size, (B, PROMPT) + ncb).astype(np.int32)
        inp[f"{arch}/next"] = rng.integers(
            1, cfg.vocab_size, (B, STEPS) + ncb).astype(np.int32)
        params = JaxLM(cfg).init(jax.random.key(0))[0]
        for path, leaf in _flat(jax.tree.map(np.asarray, params)):
            inp[f"{arch}/params/{path}"] = leaf
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX subprocess and both gloo worlds, started together;
    returns (inputs, JAX results, port results and records by
    (world, rank))."""
    work = tmp_path_factory.mktemp("batch_serve")
    inp = _inputs()
    np.savez(work / "inputs.npz", **inp)
    reqs = _requests(JaxRequest, _engine_cfg(jconfigs).vocab_size)
    spec = {"meshes": MESHES,
            "worlds": {str(k): v for k, v in WORLDS.items()},
            "lm_archs": LM_ARCHS, "cut": JAMBA, "batch": B,
            "lm_max_len": LM_MAX_LEN, "steps": STEPS,
            "eng_arch": ENG_ARCH, "eng_meshes": ENG_MESHES,
            "eng_modes": ENG_MODES, "eng_max_batch": ENG_MAX_BATCH,
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
    want = dict(np.load(work / "jax.npz"))
    port = {(w, r): dict(np.load(work / f"port_{w}_{r}.npz"))
            for w in WORLDS for r in range(w)}
    meta = {(w, r): json.loads((work / f"meta_{w}_{r}.json").read_text())
            for w in WORLDS for r in range(w)}
    return inp, want, port, meta


def _world(mesh):
    return mesh[0] * mesh[1] * mesh[2]


# ----------------------------------------------------------- (a) the LM
@pytest.mark.parametrize("mesh", MESHES, ids=_tag)
@pytest.mark.parametrize("arch", list(LM_ARCHS))
def test_lm_rows_match_jax_under_the_mesh(runs, mesh, arch):
    """Each rank's rows of the prefill's and 4 decode steps' logits
    within 1e-4 of the reference's, its caches holding B / n rows."""
    _, want, port, meta = runs
    n = mesh[0] * mesh[1]
    for r in range(_world(mesh)):
        got, rec = port[(_world(mesh), r)], meta[(_world(mesh), r)]
        lo, hi = rec[f"{_tag(mesh)}/{arch}"]["rows"]
        assert hi - lo == B // n
        assert rec[f"{_tag(mesh)}/{arch}"]["cache_rows"] == [B // n]
        for step in ["prefill"] + [f"decode{i}" for i in range(STEPS)]:
            key = f"{_tag(mesh)}/{arch}/{step}"
            assert got[key].shape[0] == B // n
            np.testing.assert_allclose(got[key], want[key][lo:hi],
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{key} rank {r}")


def test_arctic_cases_drop_assignments(runs):
    """At capacity factor 1.0 the arctic cases drop assignments at every
    mesh: C and the fill decide which tokens reach their experts."""
    meta = runs[3]
    for mesh in MESHES:
        total = sum(meta[(_world(mesh), r)][f"{_tag(mesh)}/{ARCTIC}"]["drops"]
                    for r in range(_world(mesh)))
        assert total > 0, mesh


# ------------------------------------------------------- (b) the engine
@pytest.fixture(scope="module")
def one_rank_runs():
    """The port's one-rank engine and the JAX engine (one device) on the
    same weights and requests, each mode; the one-rank caches' bytes."""
    jcfg = _engine_cfg(jconfigs)
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(0))[0]
    tree = _nest({k: np.asarray(v) for k, v in _flat(
        jax.tree.map(np.asarray, jparams))})
    lm = LM(_engine_cfg(tconfigs), bridge.params_from_jax(tree, "cpu"),
            device="cpu")
    out = {}
    as_list = lambda rs: [[r.rid, [int(x) for x in r.out_tokens]]  # noqa: E731
                          for r in rs]
    for ps, chunk in ENG_MODES:
        jeng = JaxEngine(jlm, jparams, jlm.runtime(JaxParallelConfig()),
                         max_batch=ENG_MAX_BATCH, max_len=ENG_MAX_LEN,
                         page_size=ps, prefill_chunk=chunk)
        eng = Engine(lm, max_batch=ENG_MAX_BATCH, max_len=ENG_MAX_LEN,
                     page_size=ps, prefill_chunk=chunk, device="cpu")
        out[ps, chunk] = (as_list(jeng.run(_requests(JaxRequest,
                                                     jcfg.vocab_size))),
                          as_list(eng.run(_requests(Request,
                                                    jcfg.vocab_size))),
                          storage_bytes(eng.caches))
    return out


@pytest.mark.parametrize("mode", ENG_MODES, ids=str)
@pytest.mark.parametrize("mesh", ENG_MESHES, ids=_tag)
def test_engine_serves_the_one_rank_tokens(runs, one_rank_runs, mesh, mode):
    """Every rank serves the one-rank engine's and the JAX engine's tokens
    in the same finish order; rows moved; a rank holds half the slots."""
    jax_served, port_served, one_bytes = one_rank_runs[mode]
    assert jax_served == port_served
    assert sorted(r[0] for r in port_served) == list(range(9))
    ps, chunk = mode
    half = ENG_MAX_BATCH // 2
    for r in range(_world(mesh)):
        rec = runs[3][(_world(mesh), r)][f"{_tag(mesh)}/engine/{ps}/{chunk}"]
        assert rec["served"] == port_served, r
        assert rec["moved"] > 0
        lo = (r // mesh[2]) * half
        assert rec["own"] == [lo, lo + half]
        if ps is None and mesh[2] == 1:     # the KV heads whole
            assert 2 * rec["cache_bytes"] == one_bytes
        elif ps is not None:
            assert rec["pages"] == 1 + half * ENG_MAX_LEN // PAGE


@pytest.mark.parametrize("mesh", ENG_MESHES, ids=_tag)
def test_groups_that_do_not_divide_run_whole(runs, mesh):
    """(c): a prefill group of odd rows reaches ``LM.prefill`` whole, with
    no batch group; an even one as the rank's half of it."""
    for ps, chunk in ENG_MODES:
        calls = runs[3][(_world(mesh), 0)][
            f"{_tag(mesh)}/engine/{ps}/{chunk}"]["calls"]
        whole = [rows for rows, split in calls if not split]
        split = [rows for rows, split in calls if split]
        assert split and all(rows == (chunk or 2) // 2 for rows in split)
        if chunk is None:
            assert whole and all(rows % 2 for rows in whole)


# -------------------------------------------------- (d) cells on meta
@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "multipod"])
def test_serving_cells_hold_the_ranks_rows(multi_pod):
    """decode_32k's 128 rows and prefill_32k's 32 split 16 or 32 ways, the
    caches with them; long_500k's one row stays whole."""
    n = 32 if multi_pod else 16
    with fake_world(n * 16, 37):
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        dec = build_cell("qwen2-7b", "decode_32k", mesh)
        pre = build_cell("qwen2-7b", "prefill_32k", mesh)
        long = build_cell("mamba2-1.3b", "long_500k", mesh)
    assert dec.args["batch"]["tokens"].shape[0] == 128 // n
    assert dec.args["batch"]["lengths"].shape == (128 // n,)
    for leaf in torch.utils._pytree.tree_leaves(dec.args["caches"]):
        assert leaf.shape[1] == 128 // n
    assert pre.args["batch"]["tokens"].shape[0] == 32 // n
    assert long.args["batch"]["tokens"].shape[0] == 1
    for leaf in torch.utils._pytree.tree_leaves(long.args["caches"]):
        assert leaf.shape[1] == 1


@pytest.mark.parametrize("mesh", [(1, 2, 2), (2, 2, 1)], ids=_tag)
@pytest.mark.parametrize("pass_", ["prefill", "decode"])
def test_a_whole_batch_that_divides_is_refused(mesh, pass_):
    """A serving pass over a whole batch that divides over the batch axes
    raises, as do rows that are not the pair's: the capacity would count
    other rows than the reference's (a shard's under the MoE
    ``shard_map``, every rank's without it)."""
    pod, data, model = mesh
    cfg = tconfigs.get_smoke_config(ARCTIC)
    with fake_world(pod * data * model, 0):
        m = make_mesh(data, model, pod, device="meta")
        rt = Runtime(ParallelConfig(), m)
        lm = LM(cfg, bridge.meta_params(cfg, mesh=m), device="meta")
        toks = torch.zeros((B, PROMPT), dtype=torch.long, device="meta")

        def run(tokens, rows):
            if pass_ == "prefill":
                return lm.prefill({"tokens": tokens}, rt, rows=rows)
            lengths = torch.zeros((tokens.shape[0],), dtype=torch.int32,
                                  device="meta")
            return lm.decode(tokens[:, :1], lengths,
                             lm.init_cache(tokens.shape[0], LM_MAX_LEN, rt),
                             rt=rt, rows=rows)

        pair = rt.rows(B)
        with pytest.raises(ValueError, match="divides over the batch axes"):
            run(toks, None)
        with pytest.raises(ValueError, match="the pair holds rows"):
            run(toks, pair)
        logits, _ = run(toks[pair[0]], pair)
    assert logits.shape[0] == B // (pod * data)


def test_parallel_example_splits_the_slots_over_data():
    """``examples/serve_parallel_torch.py --data 2``: the slots split over
    the data axis, prefill rows move, and every request is served."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(ROOT / "examples" /
                                               "serve_parallel_torch.py"),
                          "--device", "cpu", "--world", "2", "--data", "2"],
                         env=env, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "over 2 ranks (gloo, 8 of 8 experts a rank)" in out.stdout
    assert "slots 0-1 of 4, 2 prefill rows moved" in out.stdout
    assert sum(line.startswith("  request ") for line in
               out.stdout.splitlines()) == 6
