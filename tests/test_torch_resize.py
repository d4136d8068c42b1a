"""The training loop's elastic re-mesh (``train_loop(resize_at=)`` inside
one world) against the reference's loop, on the CPU, in fp32.

- Four jobs, each 6 steps from one step-0 checkpoint in the reference's
  format, ``ckpt_every=0``, global batch 4 at seq 32:
  (a) qwen2-7b smoke, (data 2) -> (data 1) at step 2 -> (data 2) at 4;
  (b) qwen2-7b, (data 4) -> (data 2, model 2) at 3;
  (c) arctic-480b smoke at capacity factor 0.5, (data 2, model 2) ->
  (data 4) at 2: the capacity counts a data shard's rows before the
  resize and the whole batch after it, as the reference's does, so the
  job is held to the reference's resized run, and it drops assignments;
  (d) qwen2-7b under ``fsdp_tp``, (data 2) -> None (one rank) at 2, with
  a preemption before step 4: the retry starts on the first mesh from
  the resize's checkpoint, so steps 2 and 3 run twice (8 losses, 1
  resize, 1 restart).
  Rank 0's losses within rtol 1e-5 of the reference's step by step, its
  ``resizes``, ``restarts`` and ``steps_run`` equal to the reference's,
  every other rank's report holding the steps it ran, and the final
  checkpoint's leaves within atol 1e-4 of the reference's.
- A mesh over some of the world's ranks: its coordinates and groups, the
  ranks outside it, the refusals; a checkpoint saved under it by its
  first rank, with the barrier over its ranks only, restores whole on a
  rank outside it and cut on its own ranks.
- The loop's refusals before step 0: a mesh of another world and one the
  run cannot take, each naming the step.

The reference runs in one subprocess with 4 forced host devices, on
``jax.sharding.Mesh`` meshes over its first devices (whose axes are
Auto, as the reference's step needs); the port in one gloo world of 4
CPU processes (``launch.world.spawn_world``), both at once, from step-0
checkpoints that the port writes; jax runs only in the subprocess.
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
from repro_torch.configs.base import (  # noqa: E402
    ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.launch.world import spawn_world  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(name="resize", kind="train", seq_len=32, global_batch=4)
# one attention chunk and no remat: the same numbers, a smaller step for
# the reference to compile, and its 20 compiles (two an attempt) are
# most of this file's time
CHUNKS = dict(attn_q_chunk=32, attn_kv_chunk=32, remat="none")
STEPS = 6
MOE_CF = 0.5
# name -> the job: meshes are (data, model) or None (one rank)
CASES = {
    "a": dict(arch="qwen2-7b", over={}, parallel={}, mesh=(2, 1),
              resize={2: (1, 1), 4: (2, 1)}, fail=[]),
    "b": dict(arch="qwen2-7b", over={}, parallel={}, mesh=(4, 1),
              resize={3: (2, 2)}, fail=[]),
    "c": dict(arch="arctic-480b", over={"capacity_factor": MOE_CF},
              parallel={}, mesh=(2, 2), resize={2: (4, 1)}, fail=[]),
    "d": dict(arch="qwen2-7b", over={}, parallel={"strategy": "fsdp_tp"},
              mesh=(2, 1), resize={2: None}, fail=[4]),
}
# the steps each rank of the world runs, by the meshes of its job
RANK_STEPS = {"a": [6, 4, 0, 0], "b": [6, 6, 6, 6], "c": [6, 6, 6, 6],
              "d": [8, 6, 0, 0]}


def _run(case) -> RunConfig:
    cfg = dataclasses.replace(tconfigs.get_smoke_config(case["arch"]),
                              dtype="float32", n_patches=8, **case["over"])
    return RunConfig(model=cfg, shape=ShapeConfig(**SHAPE),
                     parallel=ParallelConfig(**CHUNKS, **case["parallel"]),
                     warmup_steps=2, moment_dtype="float32")


_JAX = r"""
import dataclasses, json, sys
from concurrent.futures import ThreadPoolExecutor
import jax, numpy as np
from jax.sharding import Mesh
from repro import configs
from repro.configs.base import ParallelConfig, RunConfig, ShapeConfig
from repro.train.loop import train_loop

work = sys.argv[1]
spec = json.load(open(f"{work}/spec.json"))
assert len(jax.devices()) == 4, jax.devices()


def mesh_of(m):
    if m is None:
        return None
    data, model = m
    devs = np.array(jax.devices()[:data * model])
    return Mesh(devs.reshape(data, model), ("data", "model"))


def job(name):
    c = spec["cases"][name]
    cfg = dataclasses.replace(configs.get_smoke_config(c["arch"]),
                              dtype="float32", n_patches=8, **c["over"])
    rcfg = RunConfig(model=cfg, shape=ShapeConfig(**spec["shape"]),
                     parallel=ParallelConfig(**spec["chunks"], **c["parallel"]),
                     warmup_steps=2, moment_dtype="float32")
    rep = train_loop(rcfg, ckpt_dir=f"{work}/jax_{name}",
                     num_steps=spec["steps"], ckpt_every=0,
                     mesh=mesh_of(c["mesh"]),
                     fail_at={s: True for s in c["fail"]},
                     resize_at={int(s): mesh_of(m)
                                for s, m in c["resize"].items()})
    return dict(losses=[float(x) for x in rep.losses], resizes=rep.resizes,
                restarts=rep.restarts, steps_run=rep.steps_run)


# a job a thread: the jobs share nothing, and their XLA compiles, the
# most of their time, run side by side
with ThreadPoolExecutor(len(spec["cases"])) as pool:
    out = dict(zip(spec["cases"], pool.map(job, spec["cases"])))
json.dump(out, open(f"{work}/jax.json", "w"))
print("OK")
"""


# ------------------------------------------------------------- the world
def _meshes():
    """The (data, model) meshes of every job, built on every rank in one
    order: {(data, model): Mesh}."""
    from repro_torch.launch.mesh import make_mesh
    sizes = []
    for case in CASES.values():
        for m in [case["mesh"], *case["resize"].values()]:
            if m is not None and m not in sizes:
                sizes.append(m)
    return {m: make_mesh(*m, device="cpu") for m in sizes}


def _jobs(meshes, work, out):
    """Every job of CASES from its copy of the JAX checkpoint; arctic's
    dropped assignments counted."""
    from repro_torch.models import moe
    from repro_torch.train.loop import train_loop
    seen = {"drops": 0}
    slots = moe.slots

    def counted(ids, cfg, data=None):
        slot, kept, C = slots(ids, cfg, data)
        seen["drops"] += int((~kept).sum())
        return slot, kept, C

    moe.slots = counted
    try:
        for name, case in CASES.items():
            seen["drops"] = 0
            rep = train_loop(
                _run(case), ckpt_dir=f"{work}/port_{name}", num_steps=STEPS,
                ckpt_every=0, mesh=meshes[case["mesh"]],
                fail_at={s: True for s in case["fail"]},
                resize_at={s: None if m is None else meshes[m]
                           for s, m in case["resize"].items()})
            out[name] = dict(losses=rep.losses, resizes=rep.resizes,
                             restarts=rep.restarts, steps_run=rep.steps_run,
                             final_loss=rep.final_loss, drops=seen["drops"])
    finally:
        moe.slots = slots


def _subset_mesh(work, out):
    """A (data 2) mesh over ranks 1 and 3 of the world of 4: coordinates
    and groups; a checkpoint of a fresh ``fsdp_tp`` state saved under it,
    its writes counted on each rank, and restored cut on its ranks."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import _like, _start
    rank = dist.get_rank()
    mesh = make_mesh(2, 1, device="cpu", ranks=[1, 3])
    got = out["subset"] = {"member": mesh.member, "coords": mesh.coords,
                           "ranks": mesh.ranks}
    try:
        mesh.group("data")
    except ValueError as e:
        got["group_error"] = str(e)
    for what, make in (("wide", lambda: make_mesh(8, 1, device="cpu")),
                       ("order", lambda: make_mesh(2, 1, device="cpu",
                                                   ranks=[3, 1]))):
        try:
            make()
        except ValueError as e:
            got[f"{what}_error"] = str(e)
    rcfg = _run(CASES["d"])
    d = f"{work}/subset"
    writes = {"n": 0}
    if mesh.member:
        group = mesh.group("data")
        t = torch.tensor([float(rank)])
        dist.all_reduce(t, group=group)
        got.update(sum=float(t), group_rank=dist.get_rank(group),
                   group_size=dist.get_world_size(group),
                   whole_size=dist.get_world_size(mesh.group("data",
                                                             "model")))
        state, _, step_fn = _start(rcfg, d, "cpu", mesh)
        save = np.save

        def counted(*a, **kw):
            writes["n"] += 1
            return save(*a, **kw)

        ckpt.np.save = counted
        try:
            ckpt.save(d, 1, state, mesh=mesh, zero=step_fn.zero,
                      split=step_fn.split)
        finally:
            ckpt.np.save = save
        back, step = ckpt.restore(d, _like(rcfg, mesh), device="cpu",
                                  zero=step_fn.zero, split=step_fn.split)
        got["restored_equal"] = step == 1 and all(
            torch.equal(a, b) for a, b in zip(
                _leaves(back), _leaves(state)))
    got["writes"] = writes["n"]
    dist.barrier()
    if rank == 0:
        # whole on a rank outside the mesh, equal to a one-rank init
        back, _ = ckpt.restore(d, _like(rcfg), device="cpu")
        fresh, _, _ = _start(rcfg, f"{work}/subset_fresh", "cpu")
        got["whole_equal"] = all(torch.equal(a, b) for a, b in zip(
            _leaves(back), _leaves(fresh)))


def _leaves(state):
    return [t for _, t in ckpt.state_leaves(state)[1:]]


def _refusals(meshes, work, out):
    """The loop's refusals, raised before step 0 on every rank."""
    from repro_torch.train.loop import train_loop
    rcfg = _run(CASES["a"])
    shaped = SimpleNamespace(axis_names=("data", "model"),
                             shape={"data": 2, "model": 1})
    compress = dataclasses.replace(rcfg, parallel=dataclasses.replace(
        rcfg.parallel, grad_compress_pod=True))
    pods = meshes["pods"]
    errors = out["refusals"] = {}
    for what, r, resize in (("other", rcfg, {3: shaped}),
                            ("cannot", compress, {5: pods})):
        try:
            train_loop(r, ckpt_dir=f"{work}/refused", num_steps=STEPS,
                       mesh=meshes[(2, 1)], resize_at=resize)
        except ValueError as e:
            errors[what] = str(e)
    errors["dir"] = os.path.exists(f"{work}/refused")


def _world(rank, mesh, work):
    """One rank of the world of 4: every job, then the port-only cases,
    in one order on every rank."""
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    meshes = _meshes()
    out = {}
    _jobs(meshes, work, out)
    _subset_mesh(work, out)
    meshes["pods"] = make_mesh(1, 2, 2, device="cpu")
    _refusals(meshes, work, out)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's reports by job, the port's results by rank, the
    work dir)."""
    from repro_torch.train.loop import _start
    work = tmp_path_factory.mktemp("resize")
    # the step-0 checkpoint of each arch, written in the reference's
    # format by the port (no JAX compile on the way to the runs)
    for arch in sorted({c["arch"] for c in CASES.values()}):
        case = next(c for c in CASES.values() if c["arch"] == arch)
        state, _, _ = _start(_run(case), str(work / "none"), "cpu")
        ckpt.save(str(work / f"init_{arch}"), 0, state)
    for name, case in CASES.items():
        for side in ("jax", "port"):
            shutil.copytree(work / f"init_{case['arch']}",
                            work / f"{side}_{name}")
    (work / "spec.json").write_text(json.dumps({
        "cases": CASES, "shape": SHAPE, "chunks": CHUNKS, "steps": STEPS}))
    # one thread a process: the reference and the ranks run side by side
    # beside the other test workers
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_cpu_multi_thread_eigen=false "
               "intra_op_parallelism_threads=1")
    proc = subprocess.Popen([sys.executable, "-c", _JAX, str(work)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        port = spawn_world(4, _world, str(work), devices=["cpu"] * 4)
    finally:
        _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-4000:]
    want = json.loads((work / "jax.json").read_text())
    return want, port, work


@pytest.mark.parametrize("name", list(CASES))
def test_resized_job_matches_the_reference_loop(runs, name):
    """Rank 0's losses within rtol 1e-5 of the reference's, step by step;
    resizes, restarts and steps run equal; each rank's report holds the
    steps it ran."""
    want, port, _ = runs
    ref, got = want[name], port[0][name]
    assert len(got["losses"]) == len(ref["losses"]) == ref["steps_run"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    for key in ("resizes", "restarts", "steps_run"):
        assert got[key] == ref[key], key
    assert got["final_loss"] == got["losses"][-1]
    for r, steps in enumerate(RANK_STEPS[name]):
        mine = port[r][name]
        assert mine["steps_run"] == len(mine["losses"]) == steps, r
        assert (mine["resizes"], mine["restarts"]) == (
            ref["resizes"], ref["restarts"]), r
    if name == "d":
        assert (ref["steps_run"], ref["resizes"], ref["restarts"]) == (
            8, 1, 1)
        # the retry replays steps 2 and 3 on the first mesh
        assert got["losses"][4:6] == pytest.approx(got["losses"][2:4],
                                                   rel=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_final_checkpoint_matches_the_reference(runs, name):
    """The job's checkpoint at its last step, written by the last mesh's
    first rank, within atol 1e-4 of the reference's, leaf by leaf."""
    _, _, work = runs
    mine, theirs = work / f"port_{name}", work / f"jax_{name}"
    assert ckpt.latest_step(str(mine)) == ckpt.latest_step(str(theirs)) \
        == STEPS
    files = sorted(p.name for p in (theirs / f"step_{STEPS}").glob("*.npy"))
    assert files and files == sorted(
        p.name for p in (mine / f"step_{STEPS}").glob("*.npy"))
    for f in files:
        a = np.load(mine / f"step_{STEPS}" / f)
        b = np.load(theirs / f"step_{STEPS}" / f)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=f)


def test_moe_job_drops_assignments_on_both_meshes(runs):
    """At capacity factor 0.5 the arctic job drops assignments; the ranks
    of both meshes count them."""
    _, port, _ = runs
    assert all(r["c"]["drops"] > 0 for r in port)
    assert all(r["a"]["drops"] == 0 for r in port)


def test_mesh_over_some_ranks(runs):
    """``make_mesh(2, 1, ranks=[1, 3])``: ranks 1 and 3 sit at data 0 and
    1 of its groups (an all-reduce over them sums 1 + 3), ranks 0 and 2
    are outside it with no coordinates and no groups; a mesh wider than
    the world and ranks out of order raise on every rank."""
    _, port, _ = runs
    for rank, r in enumerate(port):
        got = r["subset"]
        assert got["ranks"] == (1, 3)
        assert "needs 8 ranks, the world has 4" in got["wide_error"]
        assert "increasing" in got["order_error"]
        if rank in (1, 3):
            i = (1, 3).index(rank)
            assert got["member"] and got["coords"] == {"data": i, "model": 0}
            assert (got["sum"], got["group_rank"], got["group_size"],
                    got["whole_size"]) == (4.0, i, 2, 2)
        else:
            assert not got["member"] and got["coords"] is None
            assert "outside the mesh" in got["group_error"]


def test_checkpoint_under_a_mesh_over_some_ranks(runs):
    """Saved under the mesh over ranks 1 and 3: rank 1, its first rank,
    writes every file, rank 3 none, and no rank outside it takes part;
    rank 0 restores it whole, equal bit for bit to a one-rank init of the
    same seed, and each of the mesh's ranks restores its own
    ``fsdp_tp`` slices bit for bit."""
    _, port, _ = runs
    writes = [r["subset"]["writes"] for r in port]
    assert writes[1] > 0 and writes[0] == writes[2] == writes[3] == 0
    assert port[0]["subset"]["whole_equal"]
    assert port[1]["subset"]["restored_equal"]
    assert port[3]["subset"]["restored_equal"]


def test_loop_refuses_a_mesh_before_step_0(runs):
    """A resize to a mesh that is not this world's, or to one the run
    cannot take (pod compression with two ``model`` ranks), raises
    ValueError naming its step before anything runs, on every rank."""
    _, port, _ = runs
    for r in port:
        errors = r["refusals"]
        assert "resize_at step 3:" in errors["other"]
        assert "another world" in errors["other"]
        assert "resize_at step 5:" in errors["cannot"]
        assert "grad_compress_pod" in errors["cannot"]
        assert not errors["dir"]


def test_loop_refuses_a_mesh_of_a_world_that_ended(tmp_path):
    """A mesh built in a world that has been destroyed is a mesh of
    another world to the next one, though it has the same shape."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.loop import train_loop
    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s{i}",
                                rank=0, world_size=1)
        try:
            meshes.append(make_mesh(1, 1, device="cpu"))
            if i == 1:
                with pytest.raises(ValueError,
                                   match="step 2: mesh .* another world"):
                    train_loop(_run(CASES["a"]), ckpt_dir=str(tmp_path / "c"),
                               num_steps=STEPS, mesh=meshes[1],
                               resize_at={2: meshes[0]})
        finally:
            dist.destroy_process_group()
    assert not (tmp_path / "c").exists()
