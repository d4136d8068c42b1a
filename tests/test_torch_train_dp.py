"""Data-parallel training on ``torch.distributed`` (``train.train_step``
under a mesh, ZeRO-1 moments, ``parallel.compression``, checkpoints
across worlds) against the JAX package under a mesh, on the CPU, in fp32.

- Five smoke archs (qwen2-7b dense; arctic-480b MoE at capacity factor
  0.5, so experts drop tokens; mamba2-1.3b; musicgen-large's codebooks;
  internvl2-76b's patches) take 2 steps at meshes (data 2), (data 4) and
  (pod 2, data 2) from the same weights and batches: loss and metrics
  within rtol 1e-5 of the reference's on every step (measured at most
  4.6e-7), updated params and moments (fp32 moments) within atol 1e-4
  (measured at most 9.9e-6 and 3.9e-8). The MoE case asserts that
  assignments were dropped.
- A mask whose rows hold different token counts (custom ``batch_fn``)
  at (data 2) and (pod 2, data 2); ``microbatches=2`` at (data 2), where
  the bf16 accumulator rounds, within MICRO_ATOL.
- ZeRO-1 on and off give equal bits in the port, and a rank holds half
  the moments of every leaf but the norms.
- Compression: ``_quantize`` bit-equal to JAX's; the compressed
  gradients of ``tests/test_compression.py``'s toy model and of
  qwen2-7b's smoke LM at (pod 2, data 2) and at 4 pods within 4 x scale
  of JAX's ``build_pod_compressed_grad_fn`` (that file's bound; measured
  at most 1 x scale: one quantum).
- Checkpoints: a world of 2 starts from a JAX checkpoint, trains through
  a preemption with losses equal to an uninterrupted world's bit for
  bit (that one re-enters once on its own mesh, ``resize_at``), and its
  checkpoint restores in JAX and on one rank of the port.
- Placement: the ZeRO-1 slices equal the reference's ``state_specs`` for
  every leaf of all ten archs, at (data 2), (data 16, model 16) and (pod
  2, data 16, model 16), shape only.
- ``fsdp_tp`` passes ``check_data_mesh`` under a data mesh (its pod
  compression is refused); and ``--data 2`` trains (training under the ``model`` axis: ``tests/test_torch_train_
  tp.py``).

The reference runs in subprocesses with 4 forced host devices
(``XLA_FLAGS`` must precede jax's import), the port in gloo worlds of 2
and 4 CPU processes (``launch.world.spawn_world``), all together, from
weights of one JAX init that this process writes with numpy. This module
imports jax only inside its tests: the world's ranks import it.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import meta_params, params_from_jax  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.world import backend_for, spawn_world  # noqa: E402
from repro_torch.models.lm import LM, tree_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.parallel.fsdp import BatchCuts  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen2-7b", "arctic-480b", "mamba2-1.3b", "musicgen-large",
         "internvl2-76b")
MOE_ARCH, MOE_CF = "arctic-480b", 0.5
# name -> (pod, data); the world of 2 holds d2, the world of 4 the rest
MESHES = {"d2": (1, 2), "d4": (1, 4), "p2d2": (2, 2), "p4": (4, 1)}
WORLD_OF = {"d2": 2, "d4": 4, "p2d2": 4, "p4": 4}
SHAPE = dict(name="dp", kind="train", seq_len=32, global_batch=4)
CHUNKS = dict(attn_q_chunk=16, attn_kv_chunk=16)
STEPS = 2
# microbatches=2: each microbatch's gradients are added into a bf16
# buffer, on one device after the reduction and in the port before it
# (then summed over ranks in fp32), so the two round differently; the
# updated params measured 3.0e-4 from the reference's (every other
# case: at most 9.9e-6), and tests/test_torch_train.py's microbatch test
# allows 5e-2
MICRO_ATOL = 1e-3


def _cases():
    """name -> {arch, mesh, over (ModelConfig), parallel, batch}."""
    cases = {}
    for mesh in ("d2", "d4", "p2d2"):
        for arch in ARCHS:
            over = {"capacity_factor": MOE_CF} if arch == MOE_ARCH else {}
            cases[f"{mesh}/{arch}"] = dict(arch=arch, mesh=mesh, over=over,
                                           parallel={}, batch="synthetic")
    for mesh in ("d2", "p2d2"):
        cases[f"{mesh}/uneven"] = dict(arch="qwen2-7b", mesh=mesh, over={},
                                       parallel={}, batch="uneven")
    cases["d2/micro"] = dict(arch="qwen2-7b", mesh="d2", over={},
                             parallel={"microbatches": 2}, batch="synthetic")
    for mesh in ("p2d2", "p4"):
        cases[f"{mesh}/compress"] = dict(
            arch="qwen2-7b", mesh=mesh, over={},
            parallel={"grad_compress_pod": True}, batch="synthetic",
            grads=True)
    return cases


CASES = _cases()
# the reference's subprocesses, each one group of cases
JAX_GROUPS = {
    "d2": [c for c in CASES if c.startswith("d2/")],
    "d4": [c for c in CASES if c.startswith("d4/")],
    "p2d2": [c for c in CASES if c.startswith("p2d2/")
             and not c.endswith("/compress")] + ["toy"],
    "compress": [c for c in CASES if c.endswith("/compress")],
}


def _model_cfg(arch, over):
    return dataclasses.replace(tconfigs.get_smoke_config(arch),
                               dtype="float32", n_patches=8, **over)


def _run(case: dict) -> RunConfig:
    return RunConfig(model=_model_cfg(case["arch"], case["over"]),
                     shape=ShapeConfig(**SHAPE),
                     parallel=ParallelConfig(**CHUNKS, **case["parallel"]),
                     warmup_steps=2, moment_dtype="float32")


def uneven(mask: np.ndarray) -> np.ndarray:
    """Row r keeps its first S (r + 1) / (B + 1) positions: every rank's
    rows hold another token count."""
    B, S = mask.shape
    keep = np.array([S * (r + 1) // (B + 1) for r in range(B)])
    return (np.arange(S)[None, :] < keep[:, None]).astype(np.float32)


def _toy_inputs():
    """tests/test_compression.py's toy regression: w (8, 4), x (16, 8),
    y (16, 4)."""
    rng = np.random.default_rng(0)
    return (rng.standard_normal((8, 4)).astype(np.float32),
            rng.standard_normal((16, 8)).astype(np.float32),
            rng.standard_normal((16, 4)).astype(np.float32))


_JAX = r"""
import json, os, sys
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ParallelConfig, RunConfig, ShapeConfig
from repro.data.synthetic import synthetic_batches
from repro.models.lm import LM
from repro.parallel.compression import build_pod_compressed_grad_fn
from repro.train.train_step import build_train_step

work, group = sys.argv[1], sys.argv[2]
spec = json.load(open(f"{work}/spec.json"))
inp = dict(np.load(f"{work}/inputs.npz"))
assert len(jax.devices()) == 4, jax.devices()
out = {}


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


def mesh_of(name):
    pod, data = spec["meshes"][name]
    devs = np.array(jax.devices()[:pod * data])
    if pod > 1:
        return Mesh(devs.reshape(pod, data, 1), ("pod", "data", "model"))
    return Mesh(devs.reshape(data, 1), ("data", "model"))


def flat(tree, prefix):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in k)] = np.asarray(v)


for name in spec["groups"][group]:
    if name == "toy":
        w, x, y = inp["toy/w"], inp["toy/x"], inp["toy/y"]

        def loss_fn(params, batch):
            l = jnp.mean((batch["x"] @ params["w"] - batch["y"]) ** 2)
            return l, {"l": l}

        for mname in ("p2d2", "p4"):
            fn = jax.jit(build_pod_compressed_grad_fn(
                jax.value_and_grad(loss_fn, has_aux=True), mesh_of(mname)))
            (loss, _), g = fn({"w": jnp.asarray(w)},
                              {"x": jnp.asarray(x), "y": jnp.asarray(y)})
            out[f"toy/{mname}/loss"] = np.asarray(loss)
            out[f"toy/{mname}/w"] = np.asarray(g["w"])
        continue
    c = spec["cases"][name]
    cfg = dataclasses.replace(configs.get_smoke_config(c["arch"]),
                              dtype="float32", n_patches=8, **c["over"])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(**spec["shape"]),
                     parallel=ParallelConfig(**spec["chunks"], **c["parallel"]),
                     warmup_steps=2, moment_dtype="float32")
    mesh = mesh_of(c["mesh"])
    lm = LM(cfg)
    params = nested(c["arch"] + "/params/")
    draw = synthetic_batches(rcfg)

    def batch(step):
        b = draw(step)
        if c["batch"] == "uneven":
            b["mask"] = jnp.asarray(inp[f"uneven/{step}"])
        return b

    if c.get("grads"):
        rt = lm.runtime(rcfg.parallel, mesh)
        grad_fn = jax.value_and_grad(lambda p, b: lm.loss(p, rt, b),
                                     has_aux=True)
        fn = jax.jit(build_pod_compressed_grad_fn(grad_fn, mesh))
        (loss, _), g = fn(params, batch(0))
        out[f"{name}/loss"] = np.asarray(loss)
        flat(g, f"{name}/grads/")
        continue
    step_fn, rt, opt = build_train_step(lm, rcfg, mesh)
    step = jax.jit(step_fn)
    state = opt.init(params)
    for s in range(spec["steps"]):
        state, met = step(state, batch(s))
        for k, v in met.items():
            out[f"{name}/metrics/{s}/{k}"] = np.asarray(v)
    for part in ("params", "m", "v"):
        flat(getattr(state, part), f"{name}/{part}/")
np.savez(f"{work}/jax_{group}.npz", **out)
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


def _step_case(name, case, mesh, inp, out):
    """2 steps of ``case`` on this rank of ``mesh`` from the JAX init:
    metrics, and (gathered) params, m and v; under compression, the
    gradients apply was given; drops counted for the MoE arch."""
    from repro_torch.models import moe
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import build_train_step
    rcfg = _run(case)
    lm = LM(rcfg.model, params_from_jax(
        _nested(inp, case["arch"] + "/params/"), "cpu"), device="cpu")
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
    draw = synthetic_batches(rcfg, "cpu")
    seen = {"drops": 0}
    slots, apply = moe.slots, optimizer.AdamW.apply

    def counted(ids, cfg, data=None):
        slot, kept, C = slots(ids, cfg, data)
        seen["drops"] += int((~kept).sum())
        return slot, kept, C

    def captured(self, st, grads, *rest):
        seen["grads"] = {p: g.detach().clone() for p, g in tree_leaves(grads)}
        return apply(self, st, grads, *rest)

    moe.slots, optimizer.AdamW.apply = counted, captured
    try:
        for s in range(1 if case.get("grads") else STEPS):
            batch = draw(s)
            if case["batch"] == "uneven":
                batch["mask"] = torch.from_numpy(inp[f"uneven/{s}"])
            state, met = step_fn(state, batch)
            for k, v in met.items():
                out[f"{name}/metrics/{s}/{k}"] = float(v)
    finally:
        moe.slots, optimizer.AdamW.apply = slots, apply
    out[f"{name}/drops"] = seen["drops"]
    if case.get("grads"):
        for p, g in seen["grads"].items():
            out[f"{name}/grads/{p}"] = g.numpy()
        return
    zero = step_fn.zero
    m, v = ((zero.gather_tree(t) if zero else t) for t in (state.m, state.v))
    for part, tree in (("params", state.params), ("m", m), ("v", v)):
        for p, t in tree_leaves(tree):
            out[f"{name}/{part}/{p}"] = t.detach().numpy().copy()
    out[f"{name}/moment_numel"] = sum(t.numel()
                                      for _, t in tree_leaves(state.m))


def _toy_case(mesh, inp, out, mname):
    """tests/test_compression.py's toy regression on this rank's rows of
    ``mesh``: each pod's mean-square loss, summed over its data ranks,
    then averaged over pods through int8."""
    import torch.distributed as dist
    from repro_torch.parallel.collectives import all_reduce
    from repro_torch.parallel.compression import build_pod_compressed_grad_fn
    from repro_torch.parallel.sharding import batch_axes
    w = torch.from_numpy(inp["toy/w"]).requires_grad_(True)
    x, y = torch.from_numpy(inp["toy/x"]), torch.from_numpy(inp["toy/y"])
    n, i = mesh.size(*batch_axes(mesh)), mesh.index(*batch_axes(mesh))
    rows = x.shape[0] // n
    data = mesh.group("data")
    pod_rows = rows * mesh.shape["data"]

    def pod_grad_fn(_):
        xs, ys = x[i * rows:(i + 1) * rows], y[i * rows:(i + 1) * rows]
        share = ((xs @ w - ys) ** 2).sum() / (pod_rows * y.shape[1])
        (g,) = torch.autograd.grad(share, [w])
        loss = share.detach()
        if dist.get_world_size(data) > 1:
            g, loss = all_reduce(g, data), all_reduce(loss, data)
        return loss, {}, [g]

    loss, _, (g,) = build_pod_compressed_grad_fn(pod_grad_fn, mesh)(None)
    out[f"toy/{mname}/loss"] = float(loss)
    out[f"toy/{mname}/w"] = g.numpy()


def _checkpoint_case(mesh, work, out):
    """From the JAX checkpoint at step 0: 4 steps uninterrupted but for a
    resize to the loop's own mesh before step 1, and with a preemption
    before step 3, checkpoints every 2 (ZeRO-1 on)."""
    from repro_torch.train.loop import train_loop
    rcfg = _run(CASES["d2/qwen2-7b"])
    ref = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_ref", num_steps=4,
                     ckpt_every=2, resize_at={1: mesh}, mesh=mesh)
    out["ckpt/resizes"] = ref.resizes
    pre = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_pre", num_steps=4,
                     ckpt_every=2, fail_at={3: True}, mesh=mesh)
    out["ckpt/ref"], out["ckpt/pre"] = ref.losses, pre.losses
    out["ckpt/restarts"] = pre.restarts


def _world(rank, mesh, work, world):
    """One rank of the world of ``world`` ranks: every case of its
    meshes, in one order on every rank."""
    torch.set_num_threads(1)
    inp = dict(np.load(f"{work}/inputs.npz"))
    meshes = {"d2": mesh} if world == 2 else {
        "d4": mesh, "p2d2": make_mesh(2, 1, 2, device="cpu"),
        "p4": make_mesh(1, 1, 4, device="cpu")}
    out = {"backend": backend_for(["cpu"] * world)}
    for name, case in CASES.items():
        if case["mesh"] in meshes:
            _step_case(name, case, meshes[case["mesh"]], inp, out)
    if world == 2:
        case = dict(CASES["d2/qwen2-7b"], parallel={"zero1": False})
        _step_case("d2/zero_off", case, mesh, inp, out)
        _checkpoint_case(mesh, work, out)
    else:
        for mname in ("p2d2", "p4"):
            _toy_case(meshes[mname], inp, out, mname)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the port's results by world size: [rank 0's, ...],
    the work dir, the JAX init params)."""
    import jax
    from repro import configs as jconfigs
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW

    work = tmp_path_factory.mktemp("dp")
    inputs = {}
    for i, arch in enumerate(ARCHS):
        cfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                  dtype="float32", n_patches=8)
        params, _ = JaxLM(cfg).init(jax.random.key(i))
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            inputs[f"{arch}/params/" + "/".join(p.key for p in path)] = \
                np.asarray(v)
        if arch == "qwen2-7b":
            # the JAX checkpoint the world starts from
            jckpt.save(str(work / "ckpt_jax"), 0, JAdamW(
                moment_dtype="float32").init(params))
    rcfg = _run(CASES["d2/uneven"])
    for s in range(STEPS):
        inputs[f"uneven/{s}"] = uneven(
            synthetic_batches(rcfg, "cpu")(s)["mask"].numpy())
    inputs["toy/w"], inputs["toy/x"], inputs["toy/y"] = _toy_inputs()
    np.savez(work / "inputs.npz", **inputs)
    (work / "spec.json").write_text(json.dumps({
        "cases": CASES, "groups": JAX_GROUPS, "meshes": MESHES,
        "shape": SHAPE, "chunks": CHUNKS, "steps": STEPS}))
    for name in ("ckpt_ref", "ckpt_pre"):
        shutil.copytree(work / "ckpt_jax", work / name)
    # one thread a process: the JAX groups and the ranks run side by side
    # beside the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    procs = {g: subprocess.Popen(
        [sys.executable, "-c", _JAX, str(work), g], env=env, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for g in JAX_GROUPS}
    try:
        port = {n: spawn_world(n, _world, str(work), n, devices=["cpu"] * n)
                for n in (2, 4)}
    finally:
        outs = {g: p.communicate(timeout=600) for g, p in procs.items()}
    want = {}
    for g, p in procs.items():
        assert p.returncode == 0, outs[g][1][-4000:]
        want.update(dict(np.load(work / f"jax_{g}.npz")))
    return want, port, work, inputs


def _ours(port, case_name):
    return port[WORLD_OF[CASES[case_name]["mesh"]]]


@pytest.mark.parametrize("name", [c for c in CASES
                                  if not CASES[c].get("grads")])
def test_steps_match_jax(runs, name):
    """Loss and metrics on both steps within rtol 1e-5 on every rank;
    params and moments after 2 steps within atol 1e-4 (MICRO_ATOL with
    microbatches)."""
    want, port, _, _ = runs
    ranks = _ours(port, name)
    got = ranks[0]
    keys = [k for k in want if k.startswith(f"{name}/")]
    assert any("/metrics/" in k for k in keys) and any("/m/" in k
                                                       for k in keys)
    atol = MICRO_ATOL if CASES[name]["parallel"].get("microbatches") \
        else 1e-4
    for key in keys:
        if "/metrics/" in key:
            for r in ranks:
                np.testing.assert_allclose(r[key], want[key], rtol=1e-5,
                                           err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=atol, err_msg=key)


def test_moe_case_drops_tokens(runs):
    """At capacity factor 0.5 every MoE mesh case drops assignments (the
    global fill order decides which: held by its params and losses)."""
    _, port, _, _ = runs
    for mesh in ("d2", "d4", "p2d2"):
        name = f"{mesh}/{MOE_ARCH}"
        drops = sum(r[f"{name}/drops"] for r in _ours(port, name))
        assert drops > 0, name
    assert all(r["d2/qwen2-7b/drops"] == 0 for r in port[2])


def test_zero1_on_and_off_give_equal_bits(runs):
    """ZeRO-1 changes where the moments live, not one bit of the params
    or moments; a rank holds half the moments but the norms'."""
    _, port, _, _ = runs
    got = port[2][0]
    keys = [k for k in got if k.startswith("d2/qwen2-7b/")
            and k.split("/")[2] in ("params", "m", "v")]
    assert keys
    for key in keys:
        assert np.array_equal(got[key], got[key.replace(
            "d2/qwen2-7b/", "d2/zero_off/")]), key
    whole = got["d2/zero_off/moment_numel"]
    for r in port[2]:
        assert whole / 2 < r["d2/qwen2-7b/moment_numel"] < 0.51 * whole
        for key in keys:
            assert np.array_equal(r[key], got[key]), key


# ------------------------------------------------------------ compression
def test_quantize_bit_equal_to_jax():
    import jax.numpy as jnp
    from repro.parallel.compression import _quantize as jax_quantize
    from repro_torch.parallel.compression import _quantize
    rng = np.random.default_rng(3)
    ties = np.array([127.0, 0.5, 1.5, -2.5, 3.5, -0.5, 0.0], np.float32)
    for x in (rng.standard_normal((64, 33)).astype(np.float32) * 7,
              ties, np.zeros(5, np.float32),
              rng.standard_normal(1000).astype(np.float32) * 1e-20):
        q, s = _quantize(torch.from_numpy(x))
        jq, js = jax_quantize(jnp.asarray(x))
        assert q.dtype == torch.int8
        assert np.array_equal(q.numpy(), np.asarray(jq))
        assert np.asarray(s, np.float32).tobytes() == \
            np.asarray(js, np.float32).tobytes()


@pytest.mark.parametrize("mesh", ["p2d2", "p4"])
def test_compressed_grads_match_jax(runs, mesh):
    """The toy model's and qwen2-7b smoke's compressed gradients within
    4 x scale of JAX's (``tests/test_compression.py``'s bound), scale the
    leaf's largest |gradient| / 127; the loss within rtol 1e-5."""
    want, port, _, _ = runs
    got = port[4][0]
    for key in (f"toy/{mesh}/w",):
        scale = np.abs(want[key]).max() / 127
        assert np.abs(got[key] - want[key]).max() < 4 * scale + 1e-6, key
    np.testing.assert_allclose(got[f"toy/{mesh}/loss"],
                               want[f"toy/{mesh}/loss"], rtol=1e-5)
    name = f"{mesh}/compress"
    keys = [k for k in want if k.startswith(f"{name}/grads/")]
    assert len(keys) == len([k for k in got
                             if k.startswith(f"{name}/grads/")]) > 0
    for key in keys:
        scale = np.abs(want[key]).max() / 127
        assert np.abs(got[key] - want[key]).max() <= 4 * scale + 1e-6, key
    np.testing.assert_allclose(got[f"{name}/metrics/0/loss"],
                               want[f"{name}/loss"], rtol=1e-5)


# ------------------------------------------------------------ checkpoints
def test_world_resumes_a_jax_checkpoint_through_a_preemption(runs):
    """The world of 2 starts from JAX's step-0 checkpoint: its losses are
    the JAX run's from the same weights (rtol 1e-5), and a preemption
    before step 3 replays step 2 with every loss equal bit for bit to a
    run that re-entered once on its own mesh."""
    want, port, _, _ = runs
    got = port[2][0]
    ref, pre = got["ckpt/ref"], got["ckpt/pre"]
    assert got["ckpt/restarts"] == 1 and got["ckpt/resizes"] == 1
    assert len(ref) == 4
    assert pre == ref[:3] + ref[2:]
    np.testing.assert_allclose(
        ref[:STEPS], [want[f"d2/qwen2-7b/metrics/{s}/loss"]
                      for s in range(STEPS)], rtol=1e-5)


def test_world_checkpoint_restores_in_jax_and_on_one_rank(runs):
    """The world's step-4 checkpoint (ZeRO-1 moments gathered, written by
    rank 0) restores in ``repro.train.checkpoint`` and on one port rank
    with the same bits, and that rank steps on from it."""
    import jax
    from repro import configs as jconfigs
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW
    from repro_torch.train.loop import _like, _start
    _, _, work, _ = runs
    rcfg = _run(CASES["d2/qwen2-7b"])
    d = str(work / "ckpt_ref")
    assert ckpt.latest_step(d) == 4
    state, step = ckpt.restore(d, _like(rcfg), device="cpu")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2-7b"),
                               dtype="float32", n_patches=8)
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
    state, start, step_fn = _start(rcfg, d, "cpu")
    _, met = step_fn(state, synthetic_batches(rcfg, "cpu")(start))
    assert start == 4 and np.isfinite(float(met["loss"]))


# -------------------------------------------------------------- placement
def _shape_mesh(sizes, names, coords=None):
    from types import SimpleNamespace
    return SimpleNamespace(axis_names=tuple(names),
                           shape=dict(zip(names, sizes)),
                           coords=coords or {n: 0 for n in names})


@pytest.mark.parametrize("arch", sorted(tconfigs.ARCHS))
def test_zero1_slices_equal_the_reference_state_specs(arch):
    """For every leaf, the dim and batch axes a rank's moment slice cuts
    are those of the reference's ``state_specs`` (``fsdp_tp`` over the
    batch axes), and the slices of the ranks along those axes tile the
    dim."""
    import itertools

    import jax
    from repro import configs as jconfigs
    from repro.configs.base import ParallelConfig as JParallel
    from repro.models.lm import LM as JaxLM
    from repro.train.train_step import state_specs
    jlm = JaxLM(jconfigs.get_config(arch))
    _, jaxes = jlm.init(None, abstract=True)
    cfg = tconfigs.get_config(arch)
    shapes = {p: tuple(t.shape) for p, t in tree_leaves(meta_params(cfg))}
    for sizes, names in (((2,), ("data",)), ((16, 16), ("data", "model")),
                         ((2, 16, 16), ("pod", "data", "model"))):
        mesh = _shape_mesh(sizes, names)
        specs = state_specs(jlm, jaxes, mesh, JParallel())
        want = {}
        for k, spec in jax.tree_util.tree_flatten_with_path(
                specs.m, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))[0]:
            path = "/".join(p.key for p in k)
            want[path] = None
            for dim, at in enumerate(spec):
                at = (at,) if isinstance(at, str) else tuple(at or ())
                on = tuple(a for a in at if a in ("pod", "data"))
                if on:
                    want[path] = (dim, on)
        cuts = BatchCuts(cfg, mesh).cuts
        assert {p: cuts[p] for p in shapes} == want, (arch, sizes)
        bax = [a for a in names if a != "model"]
        parts = {p: set() for p in shapes}
        for at in itertools.product(*(range(mesh.shape[a]) for a in bax)):
            zero = BatchCuts(cfg, _shape_mesh(sizes, names, dict(
                zip(names, at + (0,) * (len(names) - len(at))))))
            for p, shape in shapes.items():
                parts[p].add(zero.part(p, shape))
        for p, cut in want.items():
            if cut is None:
                assert parts[p] == {None}, p
                continue
            dim, on = cut
            n = int(np.prod([mesh.shape[a] for a in on]))
            size = shapes[p][dim] // n
            assert sorted(parts[p]) == [(dim, j * size, (j + 1) * size)
                                        for j in range(n)], p


# -------------------------------------------------------------- refusals
def test_fsdp_tp_raises_naming_the_roadmap():
    """``check_data_mesh`` accepts ``fsdp_tp`` under a data mesh (FSDP
    storage, ``tests/test_torch_fsdp.py``), with pod compression on two
    pods too; what it still refuses under ``fsdp_tp``, pod compression
    with a ``model`` axis of two ranks, names the ROADMAP."""
    from repro_torch.train.train_step import check_data_mesh
    check_data_mesh(_shape_mesh((2, 1), ("data", "model")),
                    ParallelConfig(strategy="fsdp_tp"))
    check_data_mesh(_shape_mesh((2, 2, 1), ("pod", "data", "model")),
                    ParallelConfig(strategy="fsdp_tp",
                                   grad_compress_pod=True))
    with pytest.raises(ValueError, match="ROADMAP"):
        check_data_mesh(_shape_mesh((2, 1, 2), ("pod", "data", "model")),
                        ParallelConfig(strategy="fsdp_tp",
                                       grad_compress_pod=True))
    check_data_mesh(_shape_mesh((2, 1), ("data", "model")), ParallelConfig())
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:0"]) == "gloo"
    assert backend_for(["cuda:0", "cuda:1"]) == "nccl"


def test_launch_train_data_2_on_the_cpu(tmp_path, capsys):
    """``--data 2`` trains qwen2-7b smoke on a world of 2 CPU ranks and
    its loss falls."""
    from repro_torch.launch import train as launch_train
    report = launch_train.main(["--arch", "qwen2-7b", "--device", "cpu",
                                "--data", "2", "--ckpt-dir", str(tmp_path)])
    assert report.steps_run == 50 and report.restarts == 0
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5]) - 0.1
    assert ckpt.latest_step(str(tmp_path)) == 50
    assert "data=2" in capsys.readouterr().out


def test_quickstart_example_on_two_cpu_ranks(tmp_path):
    """``examples/quickstart_torch.py --device cpu --data 2``: the
    reduced granite decoder trains on a world of 2 CPU ranks, its loss
    falls (the example asserts it) and the last checkpoint lands."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--data", "2", "--steps", "20", "--seq", "64",
         "--ckpt-dir", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "2 rank(s) on cpu" in out.stdout
    assert "ran 20 steps" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 20
