"""FSDP parameter storage (``ParallelConfig(strategy="fsdp_tp")``) on
``torch.distributed``, training and serving, against the JAX package on
the CPU, in fp32.

- Placement, with no processes: for every leaf of all ten archs at
  published widths, at (data 2), (data 16, model 16) and (pod 2, data
  16, model 16), the slice a rank stores cuts the dim and batch axes of
  the reference's ``state_specs(...).params`` under ``fsdp_tp``, on top
  of the rank's ``model`` slice; and the bytes a rank stores at (data
  16, model 16) for the four models the reference's cell builder puts
  under ``fsdp_tp``.
- Training: five smoke archs (qwen3-14b: QK-norm, GQA; arctic-480b:
  experts beside a dense residual; mamba2-1.3b; jamba: attention, Mamba2
  and experts in one stack; musicgen-large: codebooks) take 2 steps at
  (data 2), (data 2, model 2) and (pod 2, data 2) from the same weights
  and batches as the reference's ``fsdp_tp`` step on the same mesh. Step
  0's loss within rtol 1e-6, the other metrics within 1e-5; step 0's
  gradients within ``tests/test_torch_train_tp.py``'s bound; params
  after 2 steps within atol 1e-5 (jamba's: that file's 2 x lr rule), the
  moments within 1e-4. The port's ``fsdp_tp`` step equals its own ``tp``
  + ZeRO-1 step within 1e-6 (jamba's twin left out for time), and a leaf
  no rank cuts has the same gradient bits on every rank. Jamba runs at
  (data 2) and (data 2, model 2) only (``_cases``).
- The reference's known faults at (data 2, model 2), as ROADMAP queue 1
  records them: its Mamba2 conv gradients read 2.0x one device's
  (mamba2 and jamba are held to one device there, jamba at capacity
  factor E / k), and its experts fill per data shard (arctic at 1.25,
  held to the mesh).
- ``microbatches=2`` at (data 2): the bf16 accumulator of a stored slice
  holds each microbatch's summed gradient, as the reference's.
- Pod compression at (pod 2, data 2) for qwen3 and musicgen: each pod's
  gradient of a leaf quantized against the whole leaf's scale, as the
  reference's ``shard_map`` over ``pod`` quantizes it; held to the
  reference's compressed gradients.
- Checkpoints: an ``fsdp_tp`` world at (data 2) starts from a JAX
  checkpoint and replays a preemption bit for bit; its checkpoint
  restores on one rank and in JAX with the same bits; a ``tp`` world's
  checkpoint at (data 2, model 2) resumes under ``fsdp_tp``, and the
  (data 2) world's under ``fsdp_tp`` at (pod 2, data 2), as one rank
  steps on from it.
- Serving: ``Engine`` under ``fsdp_tp`` at (data 2) and (data 2, model
  2) for the qwen3, arctic and mamba2 smoke configs, contiguous and
  paged: the JAX engine's tokens; every gathered layer and table
  bit-equal to the ``tp`` layout's leaf, and the serving embedding (each
  rank's columns looked up, then gathered) to the whole table's.
- ``fsdp_gather``'s forward and backward on a world of 2,
  ``all_gather``'s receive buffers on the device of the tensor it sends,
  and the refusals.

The reference runs in a subprocess a mesh with 4 forced host devices,
the port in gloo worlds of 2 and 4 CPU processes (``launch.world.
spawn_world``), all together, from weights of one JAX init that this
process writes with numpy.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    meta_params, params_from_jax, storage_cuts)
from repro_torch.configs.base import (  # noqa: E402
    ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.world import spawn_world  # noqa: E402
from repro_torch.models.lm import LM, Runtime, tree_leaves  # noqa: E402
from repro_torch.parallel.check import bytes_held  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.parallel.fsdp import fsdp_plan  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QWEN, ARCTIC, MAMBA, JAMBA = ("qwen3-14b", "arctic-480b", "mamba2-1.3b",
                              "jamba-1.5-large-398b")
ARCHS = (QWEN, ARCTIC, MAMBA, JAMBA, "musicgen-large")
# name -> (pod, data, model); the world of 2 holds d2, the world of 4 the
# rest
MESHES = {"d2": (1, 2, 1), "d2m2": (1, 2, 2), "p2d2": (2, 2, 1)}
WORLD_OF = {"d2": 2, "d2m2": 4, "p2d2": 4}
SHAPE = dict(name="fsdp", kind="train", seq_len=32, global_batch=4)
CHUNKS = dict(attn_q_chunk=16, attn_kv_chunk=16)
FSDP = dict(strategy="fsdp_tp")
STEPS = 2
MOE_CF = 0.5            # arctic drops assignments at (data 2), (pod 2, ..)
PARAM_ATOL, MICRO_ATOL = 1e-5, 1e-3
# arctic under (data 2, model 2), at the per-shard capacity: one entry of
# wq reads 2.04e-5 from the reference after 2 steps, where the port's
# ``tp`` step lands on the same bits (AdamW's second update of an entry
# whose gradients are near 0 and of either sign); held to
# tests/test_torch_train_tp.py's 1e-4 for that case
CASE_PARAM_ATOL = {f"d2m2/{ARCTIC}": 1e-4}
CONVS = ("conv_x", "conv_B", "conv_C")
# (data 2, model 2) cases held to JAX on one device: the reference's mesh
# doubles their conv gradients
ONE_DEVICE = ("d2m2/" + MAMBA, "d2m2/" + JAMBA)
SERVE_ARCHS, SERVE_MESHES = (QWEN, ARCTIC, MAMBA), ("d2", "d2m2")
# arctic serves at capacity factor E / k, where no assignment drops: at
# the default a decode step's inactive slots take capacity, and the two
# engines' inactive rows differ (tests/test_torch_engine_moe_ssm.py)
_ARCTIC = tconfigs.get_smoke_config(ARCTIC)
SERVE_OVER = {ARCTIC: {"capacity_factor": _ARCTIC.n_experts
                       / _ARCTIC.top_k}}
ENG_MAX_BATCH, ENG_MAX_LEN, PAGE = 3, 32, 8


def _cases():
    """name -> {arch, mesh, over (ModelConfig), parallel}. Jamba's
    16-layer stack (39 s of JAX compile a case) runs at (data 2) and
    (data 2, model 2) only; (pod 2, data 2) cuts the ``embed`` dims of
    the other four archs."""
    cases = {}
    for mesh in MESHES:
        for arch in ARCHS:
            if arch == JAMBA and mesh == "p2d2":
                continue
            over = {}
            if arch == ARCTIC and mesh != "d2m2":
                over = {"capacity_factor": MOE_CF}
            if arch == JAMBA and mesh == "d2m2":
                cfg = tconfigs.get_smoke_config(arch)
                over = {"capacity_factor": cfg.n_experts / cfg.top_k}
            cases[f"{mesh}/{arch}"] = dict(arch=arch, mesh=mesh, over=over,
                                           parallel=dict(FSDP))
    cases["d2/micro"] = dict(arch=QWEN, mesh="d2", over={},
                             parallel=dict(FSDP, microbatches=2))
    # attention's column path under FSDP storage: "seq" keeps qwen3's
    # 2 KV heads from splitting by whole heads, so a layer gathers its
    # stored slices over data, then its q, k, v columns over model
    cases["d2m2/seq"] = dict(arch=QWEN, mesh="d2m2", over={},
                             parallel=dict(FSDP, decode_kv_shard="seq"))
    return cases


CASES = _cases()
# pod compression under ``fsdp_tp`` at (pod 2, data 2): held to the
# reference's compressed gradients (``test_fsdp_pod_compression_...``)
COMPRESS = {f"p2d2/compress/{arch}": dict(
    arch=arch, mesh="p2d2", over={},
    parallel=dict(FSDP, grad_compress_pod=True))
    for arch in (QWEN, "musicgen-large")}
# the reference's subprocesses, each one group of cases of about 40-55 s
# alone (the cases held to one device prefixed "one/"; the engine)
_SHORT = [c for c in CASES if CASES[c]["arch"] != JAMBA]
JAX_GROUPS = {
    "d2": [c for c in _SHORT if c.startswith("d2/")],
    "d2m2+p2d2": [c for c in _SHORT if not c.startswith("d2/")],
    "jamba-d2": [f"d2/{JAMBA}", f"one/d2m2/{MAMBA}", "engine"],
    "jamba-d2m2": [f"d2m2/{JAMBA}"],
    "jamba-one": [f"one/d2m2/{JAMBA}"],
    "compress": list(COMPRESS),
}
# the cases whose ``tp`` + ZeRO-1 twin the port also runs
TWINS = [c for c in _SHORT if "micro" not in c]


def _model_cfg(arch, over):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32", **over)


def _run(case: dict, **parallel) -> RunConfig:
    return RunConfig(model=_model_cfg(case["arch"], case["over"]),
                     shape=ShapeConfig(**SHAPE),
                     parallel=ParallelConfig(**CHUNKS, **dict(
                         case["parallel"], **parallel)),
                     warmup_steps=2, moment_dtype="float32")


def _requests(cls, vocab):
    """7 requests; every prompt shorter than the Mamba2 smoke's SSD chunk
    (16) or a multiple of it, as its prefill takes them."""
    r = np.random.default_rng(43)
    plens, budgets = (8, 5, 12, 8, 3, 16, 14), (4, 6, 3, 5, 2, 8, 6)
    return [cls(rid=i, tokens=r.integers(1, vocab, (p,)).astype(np.int32),
                max_new_tokens=b)
            for i, (p, b) in enumerate(zip(plens, budgets))]


def _served(reqs):
    return [[r.rid, [int(x) for x in r.out_tokens]] for r in reqs]


_JAX = r"""
import json, sys
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ParallelConfig, RunConfig, ShapeConfig
from repro.data.synthetic import synthetic_batches
from repro.models.lm import LM
from repro.parallel.compression import build_pod_compressed_grad_fn
from repro.serve.engine import Engine, Request
from repro.train.train_step import build_train_step

work, group = sys.argv[1], sys.argv[2]
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
assert len(jax.devices()) == 4, jax.devices()
out, served = {}, {}


def nested(prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
    return tree


def flat(tree, prefix):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in k)] = np.asarray(v)


def fp32(arch, **over):
    return dataclasses.replace(configs.get_smoke_config(arch),
                               dtype="float32", **over)


for name in spec["groups"][group]:
    if name == "engine":
        for arch in spec["serve_archs"]:
            lm = LM(fp32(arch, **spec["serve_over"].get(arch, {})))
            params = nested(arch + "/params/")
            for ps in (None, spec["page"]):
                reqs = [Request(rid=r["rid"], tokens=np.asarray(
                    r["tokens"], np.int32), max_new_tokens=r["budget"])
                    for r in spec["requests"]]
                eng = Engine(lm, params, lm.runtime(ParallelConfig()),
                             max_batch=spec["eng_max_batch"],
                             max_len=spec["eng_max_len"], page_size=ps)
                served[f"{arch}/{ps}"] = [
                    [r.rid, [int(x) for x in r.out_tokens]]
                    for r in eng.run(reqs)]
        continue
    c = spec["cases"][name.removeprefix("one/")]
    mesh = None
    if not name.startswith("one/"):
        pod, data, model = spec["meshes"][c["mesh"]]
        devs = np.array(jax.devices()[:pod * data * model])
        mesh = (Mesh(devs.reshape(pod, data, model), ("pod", "data", "model"))
                if pod > 1 else
                Mesh(devs.reshape(data, model), ("data", "model")))
    cfg = fp32(c["arch"], **c["over"])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(**spec["shape"]),
                     parallel=ParallelConfig(**spec["chunks"],
                                             **c["parallel"]),
                     warmup_steps=2, moment_dtype="float32")
    lm = LM(cfg)
    params = nested(c["arch"] + "/params/")
    draw = synthetic_batches(rcfg)
    step_fn, rt, opt = build_train_step(lm, rcfg, mesh)
    if rcfg.parallel.microbatches > 1:
        step = jax.jit(lambda st, b: step_fn(st, b) + ({},))
    else:
        # build_train_step's step without microbatches, its gradients
        # returned too: one compile a case
        grad_fn = jax.value_and_grad(lambda p, b: lm.loss(p, rt, b),
                                     has_aux=True)
        if rcfg.parallel.grad_compress_pod:
            grad_fn = build_pod_compressed_grad_fn(grad_fn, mesh)

        def with_grads(st, b):
            (loss, met), g = grad_fn(st.params, b)
            st, om = opt.apply(st, g)
            return st, dict(met, loss=loss, **om), g

        step = jax.jit(with_grads)
    state = opt.init(params)
    for s in range(spec["steps"]):
        state, met, g = step(state, draw(s))
        if s == 0:
            flat(g, f"{name}/grads/")
        for k, v in met.items():
            out[f"{name}/metrics/{s}/{k}"] = np.asarray(v)
    for part in ("params", "m", "v"):
        flat(getattr(state, part), f"{name}/{part}/")
np.savez(f"{work}/jax_{group}.npz", **out)
json.dump(served, open(f"{work}/served_{group}.json", "w"))
print("OK")
"""


# ------------------------------------------------------------ the worlds
def _nested(inp, prefix):
    tree = {}
    for k, v in inp.items():
        if k.startswith(prefix):
            *parents, leaf = k[len(prefix):].split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = v
    return tree


def _whole(tree, step_fn):
    """The whole leaves of a tree of this rank's slices: joined over the
    batch axes where they are slices of the ZeRO-1 plan's cuts (the
    moments, and under FSDP storage the params and gradients too), then
    over ``model``."""
    zero = step_fn.zero
    if zero is not None:
        tree = zero.gather_tree(tree)
    if step_fn.split is not None:
        tree = step_fn.split.gather_tree(tree)
    return tree


def _step_case(name, case, mesh, inp, out, **parallel):
    """2 steps of ``case`` on this rank of ``mesh`` from the JAX init:
    metrics; step 0's gradients joined whole, and the local ones of the
    leaves no rank cuts; params, m and v joined whole; the elements this
    rank stores; the assignments the MoE layers dropped."""
    from repro_torch.models import moe
    from repro_torch.train import optimizer
    from repro_torch.parallel.fsdp import unflatten
    from repro_torch.train.train_step import build_train_step
    rcfg = _run(case, **parallel)
    lm = LM(rcfg.model, params_from_jax(
        _nested(inp, case["arch"] + "/params/"), "cpu", mesh=mesh,
        cfg=rcfg.model, parallel=rcfg.parallel), device="cpu")
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
    out[f"{name}/stored"] = sum(t.numel() for _, t in tree_leaves(lm.params))
    draw = synthetic_batches(rcfg, "cpu")
    seen = {"drops": 0}
    slots, apply = moe.slots, optimizer.AdamW.apply

    def counted(ids, cfg, data=None):
        slot, kept, C = slots(ids, cfg, data)
        seen["drops"] += int((~kept).sum())
        return slot, kept, C

    def captured(self, st, grads, zero=None, split=None):
        seen.setdefault("grads", {p: g.detach().clone()
                                  for p, g in tree_leaves(grads)})
        return apply(self, st, grads, zero, split)

    moe.slots, optimizer.AdamW.apply = counted, captured
    try:
        for s in range(STEPS):
            state, met = step_fn(state, draw(s))
            for k, v in met.items():
                out[f"{name}/metrics/{s}/{k}"] = float(v)
    finally:
        moe.slots, optimizer.AdamW.apply = slots, apply
    out[f"{name}/drops"] = seen["drops"]
    cuts = storage_cuts(rcfg.model, mesh, rcfg.parallel)
    shapes = dict(tree_leaves(meta_params(rcfg.model)))
    grads = seen["grads"]
    for p, g in grads.items():
        if not cuts(p, shapes[p].shape):
            out[f"{name}/local/{p}"] = g.numpy()
    whole = _whole(unflatten(list(grads), list(grads.values())), step_fn)
    for part, tree in (("grads", whole),
                       ("params", _whole(state.params, step_fn)),
                       ("m", _whole(state.m, step_fn)),
                       ("v", _whole(state.v, step_fn))):
        for p, t in tree_leaves(tree):
            out[f"{name}/{part}/{p}"] = t.detach().float().numpy().copy()


def _serve_case(mesh_name, mesh, inp, out):
    """The ``fsdp_tp`` engine on this rank of ``mesh`` for each serving
    arch, contiguous and paged; whether every gathered layer and table is
    the ``tp`` layout's leaf, and the serving embedding the whole table's
    lookup, bit for bit; the bytes stored."""
    par = ParallelConfig(**FSDP)
    rt = Runtime(par, mesh)
    for arch in SERVE_ARCHS:
        cfg = _model_cfg(arch, SERVE_OVER.get(arch, {}))
        tree = _nested(inp, arch + "/params/")
        lm = LM(cfg, params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg,
                                     parallel=par), device="cpu")
        tp = LM(cfg, params_from_jax(tree, "cpu", mesh=mesh, cfg=cfg),
                device="cpu")
        fsdp = rt.fsdp(cfg)
        equal = [torch.equal(lm._table(n, rt), tp.params[n])
                 for n in ("embed", "head")]
        toks = {"tokens": torch.from_numpy(_requests(
            Request, cfg.vocab_size)[5].tokens)[None]}
        with torch.no_grad():
            equal.append(torch.equal(lm.embed(toks, rt, shared_rows=True),
                                     tp.embed(toks, Runtime(mesh=mesh))))
        for r in range(lm.repeats):
            for i in range(lm.period):
                got = dict(tree_leaves(lm._gathered(
                    lm._layers[r][i], f"blocks/pos{i}", fsdp, 1)))
                want = dict(tree_leaves(tp._layers[r][i]))
                equal += [torch.equal(got[p], want[p]) for p in want]
        tag = f"serve/{mesh_name}/{arch}"
        out[f"{tag}/gathered_equal"] = all(equal)
        out[f"{tag}/stored"] = (bytes_held(lm.params), bytes_held(tp.params))
        for ps in (None, PAGE):
            eng = Engine(lm, rt=rt, max_batch=ENG_MAX_BATCH,
                         max_len=ENG_MAX_LEN, page_size=ps, device="cpu")
            out[f"{tag}/{ps}"] = _served(eng.run(_requests(
                Request, cfg.vocab_size)))


def _checkpoint_cases(world, meshes, work, out):
    """Worlds of 2: qwen3 under ``fsdp_tp`` at (data 2) from the JAX
    checkpoint, 4 steps uninterrupted and with a preemption before step
    3, checkpoints every 2. Worlds of 4: ``tp`` at (data 2, model 2) from
    the JAX checkpoint for 2 steps, then on to 4 under ``tp`` and, from
    the same step-2 checkpoint, under ``fsdp_tp``; and one step under
    ``fsdp_tp`` at (pod 2, data 2) from the (data 2) world's step 4."""
    from repro_torch.train.loop import train_loop
    case = CASES[f"d2/{QWEN}"]
    if world == 2:
        rcfg = _run(case)
        ref = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_ref", num_steps=4,
                         ckpt_every=2, mesh=meshes["d2"])
        pre = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_pre", num_steps=4,
                         ckpt_every=2, fail_at={3: True}, mesh=meshes["d2"])
        out["ckpt/ref"], out["ckpt/pre"] = ref.losses, pre.losses
        out["ckpt/restarts"] = pre.restarts
        return
    tp = _run(case, strategy="tp")
    train_loop(tp, ckpt_dir=f"{work}/ckpt_tp", num_steps=2, ckpt_every=2,
               mesh=meshes["d2m2"])
    if dist_rank() == 0:
        shutil.copytree(f"{work}/ckpt_tp", f"{work}/ckpt_tp_fsdp")
        shutil.copytree(f"{work}/ckpt_ref", f"{work}/ckpt_p2d2")
    torch.distributed.barrier()
    out["ckpt/tp"] = train_loop(tp, ckpt_dir=f"{work}/ckpt_tp", num_steps=4,
                                ckpt_every=2, mesh=meshes["d2m2"]).losses
    out["ckpt/tp_fsdp"] = train_loop(
        _run(case), ckpt_dir=f"{work}/ckpt_tp_fsdp", num_steps=4,
        ckpt_every=2, mesh=meshes["d2m2"]).losses
    out["ckpt/p2d2"] = train_loop(
        _run(case), ckpt_dir=f"{work}/ckpt_p2d2", num_steps=5,
        ckpt_every=0, mesh=meshes["p2d2"]).losses


def dist_rank():
    return torch.distributed.get_rank()


def _world(rank, mesh, work, world):
    """One rank of the world of ``world`` ranks: every case of its
    meshes, in one order on every rank; the ``tp`` twin of each."""
    torch.set_num_threads(1)
    inp = dict(np.load(f"{work}/inputs.npz"))
    meshes = {"d2": mesh} if world == 2 else {
        "d2m2": mesh, "p2d2": make_mesh(2, 1, 2, device="cpu")}
    out = {}
    for name, case in {**CASES, **COMPRESS}.items():
        if case["mesh"] in meshes:
            _step_case(name, case, meshes[case["mesh"]], inp, out)
            if name in TWINS:
                _step_case(f"tp/{name}", case, meshes[case["mesh"]], inp,
                           out, strategy="tp")
    for m in SERVE_MESHES:
        if m in meshes:
            _serve_case(m, meshes[m], inp, out)
    _checkpoint_cases(world, meshes, work, out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the JAX engine's tokens, the port's results by world
    size: [rank 0's, ...], the work dir)."""
    import jax
    from repro import configs as jconfigs
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW

    work = tmp_path_factory.mktemp("fsdp")
    inputs = {}
    for i, arch in enumerate(ARCHS):
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                  dtype="float32")
        params, _ = JaxLM(cfg).init(jax.random.key(i))
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            inputs[f"{arch}/params/" + "/".join(p.key for p in path)] = \
                np.asarray(v)
        if arch == QWEN:
            # the JAX checkpoint the worlds start from
            jckpt.save(str(work / "ckpt_jax"), 0, JAdamW(
                moment_dtype="float32").init(params))
    np.savez(work / "inputs.npz", **inputs)
    reqs = _requests(Request, 256)
    (work / "spec.json").write_text(json.dumps({
        "cases": {**CASES, **COMPRESS}, "groups": JAX_GROUPS,
        "meshes": MESHES,
        "shape": SHAPE, "chunks": CHUNKS, "steps": STEPS,
        "serve_archs": list(SERVE_ARCHS), "serve_over": SERVE_OVER,
        "page": PAGE,
        "eng_max_batch": ENG_MAX_BATCH, "eng_max_len": ENG_MAX_LEN,
        "requests": [{"rid": r.rid, "tokens": r.tokens.tolist(),
                      "budget": r.max_new_tokens} for r in reqs]}))
    for name in ("ckpt_ref", "ckpt_pre", "ckpt_tp"):
        shutil.copytree(work / "ckpt_jax", work / name)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    procs = {g: subprocess.Popen(
        [sys.executable, "-c", _JAX, str(work), g], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in JAX_GROUPS}
    try:
        # in turn: the world of 4 resumes the world of 2's checkpoint
        port = {n: spawn_world(n, _world, str(work), n, devices=["cpu"] * n,
                               model=2 if n == 4 else 1) for n in (2, 4)}
    finally:
        outs = {g: p.communicate(timeout=600) for g, p in procs.items()}
    want, served = {}, {}
    for g, p in procs.items():
        assert p.returncode == 0, outs[g][1][-4000:]
        want.update(dict(np.load(work / f"jax_{g}.npz")))
        served.update(json.loads((work / f"served_{g}.json").read_text()))
    return want, served, port, work


def _ranks(port, name):
    return port[WORLD_OF[CASES[name]["mesh"]]]


def _reference(name):
    """The JAX results a case is held to: one device's, or the mesh's."""
    return f"one/{name}" if name in ONE_DEVICE else name


def _bound(arch, ref):
    """``tests/test_torch_train_tp.py``'s gradient bound: atol 1e-6 (1e-4
    for jamba's 16-layer stack) x max(1, the leaf's largest |gradient|)."""
    return (1e-4 if arch == JAMBA else 1e-6) * max(1.0, np.abs(ref).max())


def _param_atol(want, ref, arch, atol):
    """``atol``, or for jamba 2 x the sum of the steps' learning rates
    (``tests/test_torch_train_tp.py``: an entry whose gradient lies within
    the bound of 0 has no fixed sign, and AdamW's first update of it, of
    size lr, takes that sign)."""
    if arch != JAMBA:
        return atol
    lr = sum(float(want[f"{ref}/metrics/{s}/lr"]) for s in range(STEPS))
    return max(atol, 2 * lr)


@pytest.mark.parametrize("name", list(CASES))
def test_fsdp_steps_match_jax(runs, name):
    """On every rank step 0's loss within rtol 1e-6 of the reference's
    ``fsdp_tp`` step, the other metrics within 1e-5 (1e-4 with
    microbatches); step 0's gradients within the bound; params after 2
    steps within atol 1e-5 (MICRO_ATOL with microbatches, jamba's
    ``_param_atol``), moments within 1e-4."""
    want, _, port, _ = runs
    ranks = _ranks(port, name)
    got = ranks[0]
    ref = _reference(name)
    arch = CASES[name]["arch"]
    micro = CASES[name]["parallel"].get("microbatches")
    keys = [k for k in want if k.startswith(f"{ref}/")]
    assert any("/params/" in k for k in keys)
    assert micro or any("/grads/" in k for k in keys)
    for key in keys:
        mine = name + key[len(ref):]
        if "/metrics/" in key:
            rtol = (1e-6 if key.endswith("/metrics/0/loss")
                    else 1e-4 if micro else 1e-5)
            for r in ranks:
                np.testing.assert_allclose(r[mine], want[key], rtol=rtol,
                                           atol=0 if rtol == 1e-6 else 1e-7,
                                           err_msg=key)
        elif "/grads/" in key:
            np.testing.assert_allclose(got[mine], want[key], rtol=1e-4,
                                       atol=_bound(arch, want[key]),
                                       err_msg=key)
        elif "/params/" in key:
            atol = _param_atol(want, ref, arch, MICRO_ATOL if micro
                               else CASE_PARAM_ATOL.get(name, PARAM_ATOL))
            np.testing.assert_allclose(got[mine], want[key], rtol=0,
                                       atol=atol, err_msg=key)
        else:
            np.testing.assert_allclose(got[mine], want[key], rtol=0,
                                       atol=MICRO_ATOL if micro else 1e-4,
                                       err_msg=key)


@pytest.mark.parametrize("name", list(COMPRESS))
def test_fsdp_pod_compression_matches_jax(runs, name):
    """Pod compression under ``fsdp_tp`` at (pod 2, data 2), which the
    reference runs through its ``shard_map`` over ``pod``: each pod's
    gradient of a leaf, quantized against the whole stacked leaf's scale
    and averaged over the pods through int8. On every rank step 0's loss
    within rtol 1e-6 of the reference's and its compressed gradients
    within ``tests/test_torch_train_dp.py``'s bound of 4 x scale (the
    leaf's largest |gradient| / 127), all but 0.1 % of each leaf's
    entries within 1e-6 (both quantize the same sums on the same grid; an
    entry near a rounding tie may land one step over); the ranks' params
    equal bit for bit after 2 steps."""
    want, _, port, _ = runs
    ranks = port[4]
    for got in ranks:
        np.testing.assert_allclose(got[f"{name}/metrics/0/loss"],
                                   want[f"{name}/metrics/0/loss"],
                                   rtol=1e-6)
        keys = [k for k in want if k.startswith(f"{name}/grads/")]
        assert len(keys) == len([k for k in got if k.startswith(
            f"{name}/grads/")]) > 0
        for key in keys:
            diff = np.abs(got[key] - want[key])
            scale = np.abs(want[key]).max() / 127
            assert diff.max() <= 4 * scale + 1e-6, key
            assert (diff > 1e-6).mean() <= 1e-3, (key, (diff > 1e-6).mean())
        for key in (k for k in got if k.startswith(f"{name}/params/")):
            assert np.array_equal(got[key], ranks[0][key]), key


@pytest.mark.parametrize("mesh", list(MESHES))
def test_fsdp_step_equals_tp_zero1_step_and_stores_less(runs, mesh):
    """The port's ``fsdp_tp`` step is its ``tp`` + ZeRO-1 step: metrics
    within rtol 1e-6, gradients, params and moments within atol 1e-6; a
    rank stores at most 0.6x the ``tp`` rank's elements; every leaf no
    rank cuts has the same gradient bits on every rank."""
    _, _, port, _ = runs
    ranks = port[WORLD_OF[mesh]]
    for name in [c for c in TWINS if CASES[c]["mesh"] == mesh]:
        for r in ranks:
            assert r[f"{name}/stored"] <= 0.6 * r[f"tp/{name}/stored"], name
            for key in [k for k in r if k.startswith(f"{name}/")
                        and "/local/" not in k and k.count("/") > 2]:
                np.testing.assert_allclose(
                    r[key], r[f"tp/{key}"], rtol=1e-6 if "/metrics/" in key
                    else 0, atol=0 if "/metrics/" in key else 1e-6,
                    err_msg=key)
    for name in [c for c in CASES if CASES[c]["mesh"] == mesh]:
        local = [k for k in ranks[0] if k.startswith(f"{name}/local/")]
        assert local, name
        for r in ranks[1:]:
            for key in local:
                assert np.array_equal(r[key], ranks[0][key]), key


def test_moe_capacity_and_drops(runs):
    """Arctic drops assignments at every mesh; under (data 2, model 2)
    its experts fill per data shard, as the reference's mesh fills them:
    the JAX mesh's loss (to which the port's is held) departs from one
    device's."""
    want, _, port, _ = runs
    for mesh in MESHES:
        name = f"{mesh}/{ARCTIC}"
        assert sum(r[f"{name}/drops"] for r in _ranks(port, name)) > 0
    assert all(r[f"d2/{QWEN}/drops"] == 0 for r in port[2])
    name = f"d2m2/{ARCTIC}"
    base = dataclasses.replace(tconfigs.get_smoke_config(ARCTIC),
                               dtype="float32")
    assert base.capacity_factor == 1.25
    ours = port[4][0][f"{name}/metrics/0/loss"]
    mesh_loss = float(want[f"{name}/metrics/0/loss"])
    assert abs(ours - mesh_loss) <= 1e-6 * abs(mesh_loss)


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_reference_mesh_doubles_conv_gradients_under_fsdp(runs, arch):
    """JAX's ``fsdp_tp`` step under (data 2, model 2) gives the Mamba2
    ``conv_B`` and ``conv_C`` leaves 2.0x one device's gradient, and
    ``conv_x`` (2.0x under ``tp``, ``tests/test_torch_train_tp.py``) and
    every other leaf one device's; the port's convs are one device's."""
    want, _, port, _ = runs
    name = f"d2m2/{arch}"
    ratios = {}
    for key in [k for k in want if k.startswith(f"{name}/grads/")]:
        one = want[f"one/{key}"]
        leaf = key.rsplit("/", 1)[1]
        factor = 2 if leaf in ("conv_B", "conv_C") else 1
        if leaf in CONVS:
            ratios.setdefault(leaf, []).append(
                np.abs(want[key]).max() / np.abs(one).max())
            got = port[4][0][key]
            assert np.abs(got - one).max() <= _bound(arch, one), key
        np.testing.assert_allclose(want[key], factor * one, rtol=1e-4,
                                   atol=factor * _bound(arch, one),
                                   err_msg=key)
    assert sorted(ratios) == sorted(CONVS)
    for leaf, got in ratios.items():
        assert np.allclose(got, 1.0 if leaf == "conv_x" else 2.0,
                           rtol=1e-4), (leaf, got)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("mesh", SERVE_MESHES)
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_fsdp_engine_serves_the_jax_tokens(runs, arch, mesh):
    """Every rank's ``fsdp_tp`` engine serves the JAX engine's tokens in
    its finish order, contiguous and paged; each gathered layer and table
    is the ``tp`` layout's leaf bit for bit; a rank stores under 0.6x the
    ``tp`` rank's bytes."""
    _, served, port, _ = runs
    tag = f"serve/{mesh}/{arch}"
    for r in port[WORLD_OF[mesh]]:
        assert r[f"{tag}/gathered_equal"], tag
        stored, tp = r[f"{tag}/stored"]
        assert stored < 0.6 * tp, (tag, stored, tp)
        for ps in (None, PAGE):
            want = served[f"{arch}/{ps}"]
            assert sorted(x[0] for x in want) == list(range(7))
            assert r[f"{tag}/{ps}"] == want, (tag, ps)


# ------------------------------------------------------------ checkpoints
def test_fsdp_world_resumes_a_jax_checkpoint_through_a_preemption(runs):
    """The (data 2) world under ``fsdp_tp`` starts from JAX's step-0
    checkpoint: its losses are the JAX mesh's (rtol 1e-6), and a
    preemption before step 3 replays step 2 bit for bit."""
    want, _, port, _ = runs
    got = port[2][0]
    ref, pre = got["ckpt/ref"], got["ckpt/pre"]
    assert got["ckpt/restarts"] == 1 and len(ref) == 4
    assert pre == ref[:3] + ref[2:]
    for r in port[2]:
        assert r["ckpt/ref"] == ref and r["ckpt/pre"] == pre
    np.testing.assert_allclose(
        ref[:STEPS], [want[f"d2/{QWEN}/metrics/{s}/loss"]
                      for s in range(STEPS)], rtol=1e-6)


def test_checkpoints_move_between_strategies_and_data_extents(runs):
    """A ``tp`` world's step-2 checkpoint at (data 2, model 2) resumes
    under ``fsdp_tp`` with the ``tp`` world's losses (rtol 1e-6); the
    (data 2) ``fsdp_tp`` world's step-4 checkpoint resumes at (pod 2,
    data 2) with one rank's step-4 loss from it (rtol 1e-6)."""
    from repro_torch.train.loop import _start
    _, _, port, work = runs
    got = port[4][0]
    assert len(got["ckpt/tp"]) == len(got["ckpt/tp_fsdp"]) == 2
    np.testing.assert_allclose(got["ckpt/tp_fsdp"], got["ckpt/tp"],
                               rtol=1e-6)
    rcfg = _run(CASES[f"d2/{QWEN}"])
    state, start, step_fn = _start(rcfg, str(work / "ckpt_ref"), "cpu")
    _, met = step_fn(state, synthetic_batches(rcfg, "cpu")(start))
    assert start == 4 and len(got["ckpt/p2d2"]) == 1
    np.testing.assert_allclose(got["ckpt/p2d2"][0], float(met["loss"]),
                               rtol=1e-6)


def test_fsdp_world_checkpoint_restores_in_jax_and_on_one_rank(runs):
    """The (data 2) ``fsdp_tp`` world's step-4 checkpoint (the stored
    slices joined, written by rank 0) restores in ``repro.train.
    checkpoint`` and on one port rank with the same bits."""
    import jax
    from repro import configs as jconfigs
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW
    from repro_torch.train.loop import _like
    _, _, _, work = runs
    rcfg = _run(CASES[f"d2/{QWEN}"])
    d = str(work / "ckpt_pre")
    assert ckpt.latest_step(d) == 4
    state, step = ckpt.restore(d, _like(rcfg), device="cpu")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(QWEN),
                               dtype="float32")
    jparams, _ = JaxLM(jcfg).init(None, abstract=True)
    jstate, jstep = jckpt.restore(d, JAdamW(
        moment_dtype="float32").init_abstract(jparams))
    assert step == jstep == 4 == state.step == int(jstate.step)
    for part in ("params", "m", "v"):
        mine = dict(tree_leaves(getattr(state, part)))
        theirs = {"/".join(p.key for p in k): np.asarray(v) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      getattr(jstate, part))[0]}
        assert mine.keys() == theirs.keys()
        for p, t in mine.items():
            assert np.array_equal(t.numpy(), theirs[p]), (part, p)


# -------------------------------------------------------------- placement
def _shape_mesh(sizes, names, coords=None):
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, sizes)),
                           coords=coords or {n: 0 for n in names},
                           device=torch.device("cpu"))


PLACEMENT = {"d2": ((2,), ("data",)), "d16m16": ((16, 16), ("data", "model")),
             "p2d16m16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("placement", list(PLACEMENT))
@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_stored_slices_follow_the_reference_fsdp_state_specs(arch,
                                                             placement):
    """Published widths: the batch axes and dim of every leaf's stored cut
    are those of the reference's ``state_specs(...).params`` under
    ``fsdp_tp``, and the stored shape is the rank's ``tp`` slice with
    that dim divided by the axes' ranks."""
    import jax
    from repro import configs as jconfigs
    from repro.configs.base import ParallelConfig as JParallel
    from repro.models.lm import LM as JaxLM
    from repro.train.train_step import state_specs
    sizes, names = PLACEMENT[placement]
    mesh = _shape_mesh(sizes, names)
    jlm = JaxLM(jconfigs.get_config(arch))
    _, jaxes = jlm.init(None, abstract=True)
    specs = state_specs(jlm, jaxes, mesh, JParallel(strategy="fsdp_tp"))
    cfg = tconfigs.get_config(arch)
    par = ParallelConfig(**FSDP)
    plan = fsdp_plan(cfg, mesh, par)
    tp = dict(tree_leaves(meta_params(cfg, mesh=mesh)))
    stored = dict(tree_leaves(meta_params(cfg, mesh=mesh, parallel=par)))
    leaves = jax.tree_util.tree_flatten_with_path(
        specs.params, is_leaf=lambda x: isinstance(
            x, jax.sharding.PartitionSpec))[0]
    assert len(leaves) == len(stored)
    for k, spec in leaves:
        path = "/".join(p.key for p in k)
        want = None
        for dim, at in enumerate(spec):
            at = (at,) if isinstance(at, str) else tuple(at or ())
            on = tuple(a for a in at if a in ("pod", "data"))
            if on:
                want = (dim, on)
        assert plan.cuts[path] == want, (arch, path)
        shape = list(tp[path].shape)
        if want is not None:
            shape[want[0]] //= int(np.prod([mesh.shape[a] for a in want[1]]))
        assert list(stored[path].shape) == shape, (arch, path)


# GiB a rank stores at (data 16, model 16) under fsdp_tp and under tp,
# attention and the router cut over model as the reference cuts them
# (whole attention and routers gave 3.93/62.81, 8.4/134.44, 3.05/48.71
# and 1.83/29.31)
FSDP_GIB = {"arctic-480b": (3.47, 55.52), "kimi-k2-1t-a32b": (7.6, 121.54),
            "jamba-1.5-large-398b": (2.9, 46.32),
            "internvl2-76b": (0.52, 8.22)}


@pytest.mark.parametrize("arch", sorted(FSDP_GIB))
def test_bytes_a_rank_stores_at_full_size(arch):
    """The four models whose bf16 params pass 100 GB (the reference's
    cell builder gives them ``fsdp_tp``): the GiB a rank of (data 16,
    model 16) stores under ``fsdp_tp`` and under ``tp``, equal on every
    rank of the data axis."""
    cfg = tconfigs.get_config(arch)
    mesh = _shape_mesh((16, 16), ("data", "model"))
    got = []
    for par in (ParallelConfig(**FSDP), ParallelConfig()):
        got.append(round(bytes_held(meta_params(
            cfg, mesh=mesh, parallel=par)) / 2**30, 2))
    assert tuple(got) == FSDP_GIB[arch]
    other = _shape_mesh((16, 16), ("data", "model"), {"data": 7, "model": 3})
    assert bytes_held(meta_params(cfg, mesh=other, parallel=ParallelConfig(
        **FSDP))) == bytes_held(meta_params(cfg, mesh=mesh,
                                            parallel=ParallelConfig(**FSDP)))


# ------------------------------------------------------------ collectives
def _gathers(rank, mesh):
    """``fsdp_gather`` on this rank of (data 2): its forward, the gradient
    it hands back, and the serving form under ``no_grad``."""
    from repro_torch.parallel.collectives import all_gather, fsdp_gather
    group = mesh.group("data")
    x = torch.arange(6.0).reshape(2, 3) * (rank + 1)
    w = torch.arange(12.0).reshape(3, 4) / 7
    t = x.clone().requires_grad_(True)
    y = fsdp_gather(t, 1, group)            # (2, 6): rank 0's cols first
    (y * (rank + 1) @ torch.cat([w, w])).sum().backward()
    with torch.no_grad():
        plain = (fsdp_gather(x, 1, group), all_gather(x, 1, group))
    return {"y": y.detach(), "grad": t.grad, "plain": plain}


def test_fsdp_gather_sums_the_gradient_then_narrows():
    """On a gloo world of 2 CPU ranks: ``fsdp_gather`` joins the ranks'
    slices in rank order; its backward sums the ranks' gradients of the
    whole leaf and hands each rank its slice; without autograd it is
    ``all_gather``, bit for bit."""
    ranks = spawn_world(2, _gathers, devices=["cpu"] * 2)
    x = [torch.arange(6.0).reshape(2, 3) * (r + 1) for r in range(2)]
    w = torch.arange(12.0).reshape(3, 4) / 7
    # d/dy of sum(y * s @ [w; w]) is s * rowsum([w; w]) for every row
    whole = sum((r + 1) * torch.cat([w, w]).sum(dim=1).expand(2, 6)
                for r in range(2))
    for r, got in enumerate(ranks):
        assert torch.equal(got["y"], torch.cat(x, dim=1))
        assert torch.allclose(got["grad"], whole[:, 3 * r:3 * r + 3],
                              rtol=1e-6, atol=0)
        assert torch.equal(*got["plain"])


def test_all_gather_receives_on_the_wire_tensors_device(monkeypatch):
    """``all_gather`` receives into buffers on the device of the tensor
    it sends, as NCCL requires of a CUDA tensor: a tensor on the meta
    device stands in for one here, with no card, under a stand-in
    backend of 2 ranks that is not gloo; the parts join on that device."""
    from repro_torch.parallel import collectives
    seen = []
    monkeypatch.setattr(collectives.dist, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(collectives.dist, "all_gather",
                        lambda parts, w, group=None: seen.append(
                            (w.device, [p.device for p in parts])))
    monkeypatch.setattr(collectives, "gloo_transport", lambda group: False)
    meta = torch.device("meta")
    out = collectives.all_gather(torch.empty(2, 3, device=meta), 1, None)
    assert seen == [(meta, [meta, meta])]
    assert out.device == meta and tuple(out.shape) == (2, 6)


# -------------------------------------------------------------- refusals
def test_fsdp_refusals_and_meshes_that_pass():
    """``check_data_mesh`` accepts ``fsdp_tp`` at (data 2), (data 2,
    model 2) and (pod 2, data 2, model 2), and with pod compression at
    (pod 2, data 2), and refuses pod compression with 2 ranks on
    ``model``; weights stored for another layout raise in
    ``build_train_step`` and ``Engine``, naming the leaf."""
    from repro_torch.bridge import init_params
    from repro_torch.train.train_step import build_train_step, check_data_mesh
    for sizes, names in (((2, 1), ("data", "model")),
                         ((2, 2), ("data", "model")),
                         ((2, 2, 2), ("pod", "data", "model"))):
        check_data_mesh(_shape_mesh(sizes, names), ParallelConfig(**FSDP))
    for sizes in ((2, 1), (2, 2, 1)):
        names = ("pod", "data", "model")[-len(sizes):]
        check_data_mesh(_shape_mesh(sizes, names), ParallelConfig(
            grad_compress_pod=True, **FSDP))
    with pytest.raises(ValueError, match="model > 1"):
        check_data_mesh(_shape_mesh((2, 1, 2), ("pod", "data", "model")),
                        ParallelConfig(grad_compress_pod=True, **FSDP))
    cfg = tconfigs.get_smoke_config(QWEN)
    mesh = _shape_mesh((2, 1), ("data", "model"))
    lm = LM(cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu",
                             mesh=mesh), device="cpu")
    with pytest.raises(ValueError, match="param embed of shape"):
        build_train_step(lm, RunConfig(model=cfg, shape=ShapeConfig(
            **SHAPE), parallel=ParallelConfig(**FSDP)), mesh)
    with pytest.raises(ValueError, match="param embed holds"):
        Engine(lm, rt=Runtime(ParallelConfig(**FSDP), mesh), max_batch=2,
               max_len=16, device="cpu")

