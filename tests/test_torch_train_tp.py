"""Training under the ``model`` axis on ``torch.distributed`` (tensor- and
expert-parallel backward: ``train.train_step`` on a mesh whose ``model``
axis holds 2 or 4 ranks) against the JAX package, on the CPU, in fp32.

- Six smoke archs (qwen3-14b: QK-norm, GQA; granite-3-8b; musicgen-large:
  codebooks and the vocab split; mamba2-1.3b: Mamba2 heads; arctic-480b:
  experts beside a dense residual; jamba: attention, Mamba2 heads and
  experts in one stack) take 2 steps at meshes (model 2), (model 4) and
  (data 2, model 2) from the same weights and batches. Step 0's loss
  within rtol 1e-6 of the reference's on every rank, the other metrics
  within 1e-5; every gradient leaf of step 0, joined over ``model``
  (``bridge.ModelSplit``), within rtol 1e-4 and atol 1e-6 x max(1, the
  leaf's largest |gradient|) (``tests/test_torch_train_parity.py``'s
  bound; 1e-4 x for jamba's 16-layer stack); params and moments after 2
  steps within atol 1e-4 (PR 21's bound, MICRO_ATOL with microbatches).
  jamba's params are held to 2 x the steps' learning rates: an entry
  whose gradient lies within jamba's gradient bound of 0 has no fixed
  sign, and AdamW's first update of it (of size lr) takes that sign.
- The gradients of the leaves every ``model`` rank holds whole are equal
  bit for bit on every rank.
- MoE capacity: under (data 2, model 2) the reference fills each expert
  per data shard (its ``shard_map`` over the batch axes), so arctic at
  capacity factor 1.25 matches the reference's mesh, whose loss differs
  from one device's; the port's ranks drop assignments.
- The reference's Mamba2 conv gradients: under (data 2, model 2) JAX's
  ``conv_x``, ``conv_B`` and ``conv_C`` gradients read 2.0x one
  device's, every other leaf agreeing. The port follows one device:
  mamba2 and jamba (at capacity factor E / k, where no assignment drops,
  so one device's capacity is the mesh's) are held to JAX on one device
  there, and the test asserts the 2.0 ratio.
- Checkpoints: a world at (data 2, model 2) starts from a JAX checkpoint,
  trains through a preemption with losses equal to an uninterrupted
  world's bit for bit, and its checkpoint restores in JAX and on one rank
  of the port, which steps on.
- ``microbatches=2`` at (data 2, model 2); the launcher's and the
  quickstart example's ``--model-axis 2``; pod compression under
  ``model > 1`` raises (the reference does not run it).

The reference runs in subprocesses with 4 forced host devices, the port
in gloo worlds of 2 and 4 CPU processes (``launch.world.spawn_world``),
all together, from weights of one JAX init that this process writes with
numpy. This module imports jax only inside its tests.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ParallelConfig, RunConfig, ShapeConfig, smoke_reduce)
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.world import spawn_world  # noqa: E402
from repro_torch.models.lm import LM, tree_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-14b", "granite-3-8b", "musicgen-large", "mamba2-1.3b",
         "arctic-480b", "jamba-1.5-large-398b")
JAMBA, MAMBA, ARCTIC = "jamba-1.5-large-398b", "mamba2-1.3b", "arctic-480b"
# padding that is real (``smoke_reduce(qwen2-7b, n_heads=6)`` in each
# package: H 6, KVH 2, hd 16, QKV biases), at (model 4) only: attention
# on the column path, its leaves cut mid-head, prefill by 8 padded heads
H6 = "qwen2-h6"
DEEP_SSM = {JAMBA}
# name -> (data, model); the world of 2 holds m2, the world of 4 the rest
MESHES = {"m2": (1, 2), "m4": (1, 4), "d2m2": (2, 2)}
WORLD_OF = {"m2": 2, "m4": 4, "d2m2": 4}
SHAPE = dict(name="tp", kind="train", seq_len=32, global_batch=4)
CHUNKS = dict(attn_q_chunk=16, attn_kv_chunk=16)
STEPS = 2
# microbatches=2: the bf16 accumulator rounds on one device after the
# reduction and in the port before it (tests/test_torch_train_dp.py)
MICRO_ATOL = 1e-3
CONVS = ("conv_x", "conv_B", "conv_C")
# (data 2, model 2) cases held to JAX on one device (the reference's
# mesh doubles their conv gradients); jamba at capacity factor E / k
ONE_DEVICE = ("d2m2/" + MAMBA, "d2m2/" + JAMBA)


def _cases():
    """name -> {arch, mesh, over (ModelConfig), parallel}."""
    cases = {}
    for mesh in MESHES:
        for arch in ARCHS:
            over = {}
            if mesh == "d2m2" and arch == JAMBA:
                cfg = tconfigs.get_smoke_config(arch)
                over = {"capacity_factor": cfg.n_experts / cfg.top_k}
            cases[f"{mesh}/{arch}"] = dict(arch=arch, mesh=mesh, over=over,
                                           parallel={})
    cases["d2m2/micro"] = dict(arch="qwen3-14b", mesh="d2m2", over={},
                               parallel={"microbatches": 2})
    cases[f"m4/{H6}"] = dict(arch=H6, mesh="m4", over={}, parallel={})
    return cases


CASES = _cases()
# the reference's subprocesses: three a mesh (jamba's 16 layers alone),
# and one device for the cases whose one-device results the test reads
# (prefixed "one/")
PART = {JAMBA: "c", MAMBA: "b", ARCTIC: "b"}
JAX_GROUPS = {
    **{f"{m}/{part}": [c for c in CASES if c.startswith(m + "/")
                       and PART.get(CASES[c]["arch"], "a") == part]
       for m in MESHES for part in "abc"},
    "one": [f"one/{c}" for c in ONE_DEVICE + ("d2m2/" + ARCTIC,)],
}


def _smoke(arch):
    if arch == H6:
        return smoke_reduce(tconfigs.get_config("qwen2-7b"), n_heads=6)
    return tconfigs.get_smoke_config(arch)


def _model_cfg(arch, over):
    return dataclasses.replace(_smoke(arch), dtype="float32", **over)


def _run(case: dict) -> RunConfig:
    return RunConfig(model=_model_cfg(case["arch"], case["over"]),
                     shape=ShapeConfig(**SHAPE),
                     parallel=ParallelConfig(**CHUNKS, **case["parallel"]),
                     warmup_steps=2, moment_dtype="float32")


def _bound(arch, ref):
    """The gradient bound's atol for a leaf of ``arch`` whose reference
    is ``ref``."""
    return (1e-4 if arch in DEEP_SSM else 1e-6) * max(1.0,
                                                      np.abs(ref).max())


_JAX = r"""
import json, sys
import dataclasses
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import (
    ParallelConfig, RunConfig, ShapeConfig, smoke_reduce)
from repro.data.synthetic import synthetic_batches
from repro.models.lm import LM
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


def flat(tree, prefix):
    for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(p.key for p in k)] = np.asarray(v)


for name in spec["groups"][group]:
    c = spec["cases"][name.removeprefix("one/")]
    mesh = None
    if not name.startswith("one/"):
        data, model = spec["meshes"][c["mesh"]]
        mesh = Mesh(np.array(jax.devices()[:data * model]).reshape(
            data, model), ("data", "model"))
    cfg = dataclasses.replace(
        smoke_reduce(configs.get_config("qwen2-7b"), n_heads=6)
        if c["arch"] == spec["h6"] else configs.get_smoke_config(c["arch"]),
        dtype="float32", **c["over"])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(**spec["shape"]),
                     parallel=ParallelConfig(**spec["chunks"], **c["parallel"]),
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
np.savez(f"{work}/jax_{group.replace('/', '_')}.npz", **out)
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
    metrics; step 0's gradients (joined over ``model``) and the local
    ones of the leaves this rank holds whole; params, m and v joined
    whole; the assignments the MoE layers dropped."""
    from repro_torch.models import moe
    from repro_torch.train import optimizer
    from repro_torch.train.train_step import build_train_step
    rcfg = _run(case)
    lm = LM(rcfg.model, params_from_jax(
        _nested(inp, case["arch"] + "/params/"), "cpu", mesh=mesh,
        cfg=rcfg.model, parallel=rcfg.parallel), device="cpu")
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
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
    split, zero = step_fn.split, step_fn.zero
    out[f"{name}/split"] = sorted(split.split)
    for p, g in seen["grads"].items():
        if p not in split.split:
            out[f"{name}/local/{p}"] = g.numpy()
    from repro_torch.parallel.fsdp import unflatten
    grads = split.gather_tree(unflatten(list(seen["grads"]),
                                        list(seen["grads"].values())))
    m, v = ((zero.gather_tree(t) if zero else t) for t in (state.m, state.v))
    for part, tree in (("grads", grads), ("params", state.params), ("m", m),
                       ("v", v)):
        for p, t in tree_leaves(split.gather_tree(tree)
                                if part != "grads" else tree):
            out[f"{name}/{part}/{p}"] = t.detach().numpy().copy()


def _checkpoint_case(mesh, work, out):
    """From the JAX checkpoint at step 0, qwen3 at (data 2, model 2): 4
    steps uninterrupted, and with a preemption before step 3,
    checkpoints every 2 (ZeRO-1 on)."""
    from repro_torch.train.loop import train_loop
    rcfg = _run(CASES["d2m2/qwen3-14b"])
    ref = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_ref", num_steps=4,
                     ckpt_every=2, mesh=mesh)
    pre = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_pre", num_steps=4,
                     ckpt_every=2, fail_at={3: True}, mesh=mesh)
    out["ckpt/ref"], out["ckpt/pre"] = ref.losses, pre.losses
    out["ckpt/restarts"] = pre.restarts


def _checkpoint_h6(mesh, work, out):
    """From the JAX checkpoint of H6's weights at step 0, the world at
    (model 4) trains ``STEPS`` steps and checkpoints at the end: its
    slices, cut mid-head, joined whole."""
    from repro_torch.train.loop import train_loop
    rcfg = _run(CASES[f"m4/{H6}"])
    done = train_loop(rcfg, ckpt_dir=f"{work}/ckpt_h6", num_steps=STEPS,
                      ckpt_every=STEPS, mesh=mesh)
    out["ckpt_h6/losses"] = done.losses


def _world(rank, mesh, work, world):
    """One rank of the world of ``world`` ranks (its mesh: model
    ``world``): every case of its meshes, in one order on every rank."""
    torch.set_num_threads(1)
    inp = dict(np.load(f"{work}/inputs.npz"))
    meshes = {"m2": mesh} if world == 2 else {
        "m4": mesh, "d2m2": make_mesh(2, 2, device="cpu")}
    out = {"coords": dict(meshes[next(iter(meshes))].coords)}
    for name, case in CASES.items():
        if case["mesh"] in meshes:
            _step_case(name, case, meshes[case["mesh"]], inp, out)
    if world == 4:
        _checkpoint_case(meshes["d2m2"], work, out)
        _checkpoint_h6(meshes["m4"], work, out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX results, the port's results by world size: [rank 0's, ...],
    the work dir)."""
    import jax
    from repro import configs as jconfigs
    from repro.configs.base import smoke_reduce as jsmoke_reduce
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW

    work = tmp_path_factory.mktemp("tp")
    inputs = {}
    for i, arch in enumerate(ARCHS + (H6,)):
        cfg = dataclasses.replace(
            jsmoke_reduce(jconfigs.get_config("qwen2-7b"), n_heads=6)
            if arch == H6 else jconfigs.get_smoke_config(arch),
            dtype="float32")
        params, _ = JaxLM(cfg).init(jax.random.key(i))
        for path, v in jax.tree_util.tree_flatten_with_path(params)[0]:
            inputs[f"{arch}/params/" + "/".join(p.key for p in path)] = \
                np.asarray(v)
        if arch == "qwen3-14b":
            # the JAX checkpoint the world starts from
            jckpt.save(str(work / "ckpt_jax"), 0, JAdamW(
                moment_dtype="float32").init(params))
        if arch == H6:
            jckpt.save(str(work / "ckpt_h6"), 0, JAdamW(
                moment_dtype="float32").init(params))
    np.savez(work / "inputs.npz", **inputs)
    (work / "spec.json").write_text(json.dumps({
        "cases": CASES, "groups": JAX_GROUPS, "meshes": MESHES,
        "shape": SHAPE, "chunks": CHUNKS, "steps": STEPS, "h6": H6}))
    for name in ("ckpt_ref", "ckpt_pre"):
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
        with ThreadPoolExecutor(2) as pool:
            worlds = {n: pool.submit(spawn_world, n, _world, str(work), n,
                                     devices=["cpu"] * n, model=n)
                      for n in (2, 4)}
            port = {n: w.result() for n, w in worlds.items()}
    finally:
        outs = {g: p.communicate(timeout=600) for g, p in procs.items()}
    want = {}
    for g, p in procs.items():
        assert p.returncode == 0, outs[g][1][-4000:]
        want.update(dict(np.load(work / f"jax_{g.replace('/', '_')}.npz")))
    return want, port, work


def _ranks(port, name):
    return port[WORLD_OF[CASES[name]["mesh"]]]


def _reference(name):
    """The JAX results a case is held to: one device's, or the mesh's."""
    return f"one/{name}" if name in ONE_DEVICE else name


def _param_atol(want, ref, arch, atol):
    """The bound of an updated param of ``arch``: ``atol``, or for
    jamba's deep stack 2 x the sum of the steps' learning rates. Its
    gradients are held to 1e-4 x scale, and an entry within that of 0 has
    no fixed sign; AdamW's first update of an entry (of size lr, on the
    step that first gives it a gradient) takes that sign."""
    if arch not in DEEP_SSM:
        return atol
    lr = sum(float(want[f"{ref}/metrics/{s}/lr"]) for s in range(STEPS))
    return max(atol, 2 * lr)


@pytest.mark.parametrize("name", list(CASES))
def test_steps_match_jax(runs, name):
    """On every rank the loss of step 0 (the same weights) within rtol
    1e-6, the other metrics within 1e-5 (rtol 1e-4 with microbatches,
    whose gradient norm is that of bf16 sums, rounded in another order);
    step 0's gradients within the parity file's bound; params and moments
    after 2 steps within atol 1e-4 (MICRO_ATOL with microbatches;
    jamba's params ``_param_atol``)."""
    want, port, _ = runs
    ranks = _ranks(port, name)
    got = ranks[0]
    ref = _reference(name)
    arch = CASES[name]["arch"]
    micro = CASES[name]["parallel"].get("microbatches")
    keys = [k for k in want if k.startswith(f"{ref}/")]
    assert any("/m/" in k for k in keys)
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
        else:
            atol = MICRO_ATOL if micro else 1e-4
            if "/params/" in key:
                atol = _param_atol(want, ref, arch, atol)
            np.testing.assert_allclose(got[mine], want[key], rtol=0,
                                       atol=atol, err_msg=key)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_whole_leaves_have_equal_gradients_on_every_rank(runs, mesh):
    """Every leaf the ``model`` ranks hold whole (norms, the router,
    Mamba2's ``w_B``/``w_C``/convs/``norm``, attention where its KV heads
    do not divide) has the same gradient bits on every rank; each arch
    splits something."""
    _, port, _ = runs
    ranks = port[WORLD_OF[mesh]]
    for arch in ARCHS + ((H6,) if mesh == "m4" else ()):
        name = f"{mesh}/{arch}"
        r0 = ranks[0]
        assert r0[f"{name}/split"], name
        local = [k for k in r0 if k.startswith(f"{name}/local/")]
        assert local, name
        for r in ranks[1:]:
            assert r[f"{name}/split"] == r0[f"{name}/split"]
            for key in local:
                assert np.array_equal(r[key], r0[key]), key


def test_moe_capacity_is_per_data_shard_under_model(runs):
    """Under (data 2, model 2) the reference's experts fill per data
    shard: arctic at capacity factor 1.25 drops assignments, the JAX
    mesh's loss departs from one device's, and the port's (held to the
    mesh by ``test_steps_match_jax``) is the mesh's, not one device's."""
    want, port, _ = runs
    name = "d2m2/" + ARCTIC
    mesh_loss = float(want[f"{name}/metrics/0/loss"])
    one_loss = float(want[f"one/{name}/metrics/0/loss"])
    assert abs(mesh_loss - one_loss) > 1e-4 * abs(one_loss)
    ours = port[4][0][f"{name}/metrics/0/loss"]
    assert abs(ours - mesh_loss) <= 1e-6 * abs(mesh_loss)
    assert sum(r[f"{name}/drops"] for r in port[4]) > 0


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_reference_mesh_doubles_conv_gradients(runs, arch):
    """JAX under (data 2, model 2) gives every Mamba2 conv leaf 2.0x one
    device's gradient, and every other leaf one device's (within the
    gradient bound); the port's convs are one device's."""
    want, port, _ = runs
    name = f"d2m2/{arch}"
    ratios = []
    for key in [k for k in want if k.startswith(f"{name}/grads/")]:
        one = want[f"one/{key}"]
        if key.rsplit("/", 1)[1] in CONVS:
            ratios.append(np.abs(want[key]).max() / np.abs(one).max())
            np.testing.assert_allclose(want[key], 2 * one, rtol=1e-4,
                                       atol=2 * _bound(arch, one),
                                       err_msg=key)
            got = port[4][0][key]
            assert np.abs(got - one).max() <= _bound(arch, one), key
        else:
            np.testing.assert_allclose(want[key], one, rtol=1e-4,
                                       atol=_bound(arch, one), err_msg=key)
    assert ratios and np.allclose(ratios, 2.0, rtol=1e-4), ratios


# ------------------------------------------------------------ checkpoints
def test_world_resumes_a_jax_checkpoint_through_a_preemption(runs):
    """The world at (data 2, model 2) starts from JAX's step-0
    checkpoint: its losses are the JAX mesh's from the same weights
    (rtol 1e-6), and a preemption before step 3 replays step 2 with every
    loss equal bit for bit to the uninterrupted world's."""
    want, port, _ = runs
    got = port[4][0]
    ref, pre = got["ckpt/ref"], got["ckpt/pre"]
    assert got["ckpt/restarts"] == 1 and len(ref) == 4
    assert pre == ref[:3] + ref[2:]
    for r in port[4]:
        assert r["ckpt/ref"] == ref and r["ckpt/pre"] == pre
    np.testing.assert_allclose(
        ref[:STEPS], [want[f"d2m2/qwen3-14b/metrics/{s}/loss"]
                      for s in range(STEPS)], rtol=1e-6)


def test_world_checkpoint_restores_in_jax_and_on_one_rank(runs):
    """The world's step-4 checkpoint (the ZeRO-1 and ``model`` slices
    joined, written by rank 0) restores in ``repro.train.checkpoint`` and
    on one port rank with the same bits, and that rank steps on."""
    import jax
    from repro import configs as jconfigs
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW
    from repro_torch.train.loop import _like, _start
    _, _, work = runs
    rcfg = _run(CASES["d2m2/qwen3-14b"])
    d = str(work / "ckpt_ref")
    assert ckpt.latest_step(d) == 4
    state, step = ckpt.restore(d, _like(rcfg), device="cpu")
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen3-14b"),
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
    state, start, step_fn = _start(rcfg, d, "cpu")
    _, met = step_fn(state, synthetic_batches(rcfg, "cpu")(start))
    assert start == 4 and np.isfinite(float(met["loss"]))


def test_padded_heads_checkpoint_restores_in_jax_and_on_one_rank(runs):
    """The H6 world at (model 4), its attention leaves stored cut
    mid-head, starts from JAX's step-0 checkpoint of the same weights: its
    losses are the JAX mesh's (rtol 1e-6), and its step-2 checkpoint (the
    slices joined, written by rank 0) restores in ``repro.train.
    checkpoint`` and on one port rank with the same bits, its params and
    moments within 1e-4 of the JAX mesh's after the same steps; that rank
    steps on."""
    import jax
    from repro.configs.base import smoke_reduce as jsmoke_reduce
    from repro import configs as jconfigs
    from repro.models.lm import LM as JaxLM
    from repro.train import checkpoint as jckpt
    from repro.train.optimizer import AdamW as JAdamW
    from repro_torch.train.loop import _like, _start
    want, port, work = runs
    name = f"m4/{H6}"
    assert {f"blocks/pos0/attn/{k}" for k in ("wq", "wk", "wv", "wo", "bq",
                                              "bk", "bv")} <= set(
        port[4][0][f"{name}/split"])
    for r in port[4]:
        np.testing.assert_allclose(r["ckpt_h6/losses"], [
            want[f"{name}/metrics/{s}/loss"] for s in range(STEPS)],
            rtol=1e-6)
    rcfg = _run(CASES[name])
    d = str(work / "ckpt_h6")
    assert ckpt.latest_step(d) == STEPS
    state, step = ckpt.restore(d, _like(rcfg), device="cpu")
    jcfg = dataclasses.replace(jsmoke_reduce(
        jconfigs.get_config("qwen2-7b"), n_heads=6), dtype="float32")
    jparams, _ = JaxLM(jcfg).init(None, abstract=True)
    jstate, jstep = jckpt.restore(d, JAdamW(
        moment_dtype="float32").init_abstract(jparams))
    assert step == jstep == STEPS == state.step == int(jstate.step)
    for part in ("params", "m", "v"):
        mine = dict(tree_leaves(getattr(state, part)))
        theirs = {"/".join(p.key for p in k): np.asarray(v) for k, v in
                  jax.tree_util.tree_flatten_with_path(
                      getattr(jstate, part))[0]}
        assert mine.keys() == theirs.keys()
        for p, t in mine.items():
            assert np.array_equal(t.numpy(), theirs[p]), (part, p)
            np.testing.assert_allclose(t.numpy(),
                                       want[f"{name}/{part}/{p}"], rtol=0,
                                       atol=1e-4, err_msg=f"{part}/{p}")
    state, start, step_fn = _start(rcfg, d, "cpu")
    _, met = step_fn(state, synthetic_batches(rcfg, "cpu")(start))
    assert start == STEPS and np.isfinite(float(met["loss"]))


# ------------------------------------------------------------ collectives
def _transposes(rank, mesh):
    """The three differentiable collectives on this rank of (model 2):
    each one's forward and the gradient it hands back, and the serving
    form under ``no_grad``."""
    from repro_torch.parallel.collectives import (
        all_gather, all_reduce, enter, gather, row_sum)
    group = mesh.group("model")
    x = torch.arange(6.0).reshape(2, 3) * (rank + 1)
    w = torch.arange(12.0).reshape(4, 3) / 7
    out = {}
    for name, fn in (("row_sum", lambda t: row_sum(t, group) * (rank + 1)),
                     ("enter", lambda t: enter(t, group) * (rank + 1)),
                     ("gather", lambda t: gather(t, 0, group) * w)):
        t = x.clone().requires_grad_(True)
        y = fn(t)
        y.sum().backward()
        out[name] = (y.detach(), t.grad)
    with torch.no_grad():       # all_reduce may sum in place: copies
        out["serving"] = (row_sum(x.clone(), group),
                          all_reduce(x.clone(), group),
                          gather(x, 0, group), all_gather(x, 0, group))
    return out


def test_collectives_are_the_transposes_of_sum_and_gather():
    """On a gloo world of 2 CPU ranks: ``row_sum`` sums forward and passes
    each rank's gradient through; ``enter`` is the identity forward and
    sums the ranks' gradients; ``gather`` joins the rows forward and
    hands each rank its rows of the gradient; without autograd they are
    the serving collectives, bit for bit."""
    ranks = spawn_world(2, _transposes, devices=["cpu"] * 2, model=2)
    x = [torch.arange(6.0).reshape(2, 3) * (r + 1) for r in range(2)]
    w = torch.arange(12.0).reshape(4, 3) / 7
    for r, got in enumerate(ranks):
        y, g = got["row_sum"]
        assert torch.equal(y, (x[0] + x[1]) * (r + 1))
        assert torch.equal(g, torch.full((2, 3), float(r + 1)))
        y, g = got["enter"]
        assert torch.equal(y, x[r] * (r + 1))
        assert torch.equal(g, torch.full((2, 3), 3.0))      # 1 + 2
        y, g = got["gather"]
        assert torch.equal(y, torch.cat(x) * w)
        assert torch.equal(g, w[2 * r:2 * r + 2])
        fwd, plain, joined, plain_joined = got["serving"]
        assert torch.equal(fwd, plain) and torch.equal(joined, plain_joined)


# ------------------------------------------------- refusals and launchers
def test_pod_compression_under_model_raises_and_model_meshes_pass():
    from types import SimpleNamespace
    from repro_torch.train.train_step import check_data_mesh

    def mesh(sizes, names):
        return SimpleNamespace(axis_names=names, shape=dict(zip(names,
                                                                sizes)))

    with pytest.raises(ValueError, match="model > 1"):
        check_data_mesh(mesh((2, 1, 2), ("pod", "data", "model")),
                        ParallelConfig(grad_compress_pod=True))
    for sizes, names in (((1, 2), ("data", "model")),
                         ((2, 4), ("data", "model")),
                         ((2, 1, 2), ("pod", "data", "model"))):
        check_data_mesh(mesh(sizes, names), ParallelConfig())


def test_launch_train_model_axis_2_on_the_cpu(tmp_path, capsys):
    """``--model-axis 2`` trains qwen3-14b smoke on a world of 2 CPU
    ranks, the model split over them, and its loss falls."""
    from repro_torch.launch import train as launch_train
    report = launch_train.main(["--arch", "qwen3-14b", "--device", "cpu",
                                "--model-axis", "2", "--ckpt-dir",
                                str(tmp_path)])
    assert report.steps_run == 50 and report.restarts == 0
    assert np.mean(report.losses[-5:]) < np.mean(report.losses[:5]) - 0.1
    assert ckpt.latest_step(str(tmp_path)) == 50
    assert "data=1 model=2" in capsys.readouterr().out


def test_quickstart_example_model_axis_2(tmp_path):
    """``examples/quickstart_torch.py --device cpu --model-axis 2``: the
    reduced granite decoder trains split over 2 CPU ranks, its loss falls
    (the example asserts it) and the last checkpoint lands."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--model-axis", "2", "--steps", "20", "--seq",
         "64", "--ckpt-dir", str(tmp_path)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "2 rank(s) on cpu (data 1, model 2)" in out.stdout
    assert "ran 20 steps" in out.stdout
    assert ckpt.latest_step(str(tmp_path)) == 20
