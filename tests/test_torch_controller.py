"""The port's live ``ElasticController`` (``repro_torch.core.controller``)
against ``repro.core.controller``, on the CPU.

- decisions: the controller tests of ``tests/test_tre.py`` and
  ``tests/test_invariant_guards.py`` that stub the training segment, on
  both packages, each package's trace equal to the reference's; mix D
  (``benchmarks/torch_elastic.py``) on a stub segment, both packages;
- the port's own guards: a job across distinct devices runs on their
  world, one card named n times stays in this process, and "cuda" and
  "cuda:0" are one card;
- live parity: mix D on qwen2-7b's smoke config in fp32, the port in this
  process on 4 CPU slots and the JAX controller in a subprocess with 4
  forced host devices (a grown job needs a real 2-device data mesh), both
  from one step-0 checkpoint that JAX writes: equal decisions, and every
  loss within rtol 1e-4 (the tolerance of
  ``test_torch_train_parity.py::test_port_resumes_a_jax_checkpoint``);
  the same mix on ``cpu:0``...``cpu:3``, whose grown segments run as
  worlds of 2 gloo ranks, against the same JAX run;
- bitwise: the port's mix D losses equal a straight ``train_loop`` run's,
  ``train-0``'s step 3 twice;
- the two examples, ``examples/{elastic_train,serve_workflow}_torch.py``,
  run on the CPU.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
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

from benchmarks import torch_elastic as te  # noqa: E402
from repro.train.loop import train_loop as jax_train_loop  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ModelConfig, ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.core.controller import ElasticController  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from tests.conftest import smoke_runconfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PKGS = ("repro", "repro_torch")      # the reference, then the port
CPU = torch.device("cpu")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def _core(pkg: str) -> SimpleNamespace:
    """The classes ``torch_elastic.run_mix`` takes, of one package."""
    ctl = _mod(pkg, "core.controller")
    return SimpleNamespace(
        ElasticController=ctl.ElasticController, TrainTask=ctl.TrainTask,
        MgmtPolicy=_mod(pkg, "core.policy").MgmtPolicy,
        ProvisionService=_mod(pkg, "core.provision").ProvisionService)


def _stub(pkg: str, **kw):
    """One package's controller on a stub segment over CPU slots."""
    core = _core(pkg)
    n = kw.pop("slots")
    return te.stub_controller(core.ElasticController)(
        devices=[CPU] * n, **kw), core


def _same_as_reference(pkg, fn):
    """``fn(pkg)``, asserted equal to ``fn("repro")`` for the port."""
    got = fn(pkg)
    if pkg != "repro":
        assert got == fn("repro")
    return got


# ------------------------------------------------ tests/test_tre.py:86-124
PARITY_JOBS = [
    ("a", 4, 80.0, 2, 30.0, 1),
    ("b", 3, 140.0, 3, 30.0, 1),
    ("c", 2, 200.0, 4, 30.0, 1),
    ("d", 12, 50.0, 1, 330.0, 6),
]


def _parity_policy(pkg):
    return _mod(pkg, "core.policy").MgmtPolicy(
        initial=2, ratio=1.2, scan_interval=60.0, release_interval=300.0)


def _parity_server(pkg, prov):
    """(sim, REServer, jobs) of the parity stream in the emulator."""
    types, systems = _mod(pkg, "core.types"), _mod(pkg, "sim.systems")
    jobs = [types.Job(jid=i, arrival=arr, runtime=rt, nodes=n, name=name)
            for i, (name, n, rt, _steps, arr, _tick) in enumerate(PARITY_JOBS)]
    wl = types.Workload("parity", "htc", jobs, trace_nodes=16, period=900.0)
    sim = _mod(pkg, "sim.engine").Sim()
    srv = systems.REServer(sim, wl, prov, mode="dsp",
                           policy=_parity_policy(pkg), hold_until=900.0)
    return sim, srv, jobs


def _parity_live(pkg, ticks):
    prov = _mod(pkg, "core.provision").ProvisionService()
    ctl, core = _stub(pkg, policy=_parity_policy(pkg), provision=prov,
                      tre_name="parity", slots=16, steps_per_tick=1,
                      ticks_per_release=5, elastic_grow=False)
    for k in range(1, ticks + 1):
        for name, n, _rt, steps, _arr, tick in PARITY_JOBS:
            if tick == k:
                ctl.submit(core.TrainTask(name, rcfg=None, nodes=n,
                                          num_steps=steps, ckpt_dir=""))
        ctl.tick()
    return ctl, prov


def _deltas(prov, name):
    return [e.delta for e in prov.adjust_events if e.tre == name]


@pytest.mark.parametrize("pkg", PKGS)
def test_emulator_live_parity_decisions(pkg):
    """The same HTCRuntimeEnv under the sim clock and under the live
    controller make identical request/release decisions, on each package,
    and the port's equal the reference's."""
    def trace(p):
        prov_s = _mod(p, "core.provision").ProvisionService()
        sim, _, jobs = _parity_server(p, prov_s)
        sim.run()
        ctl, prov_l = _parity_live(p, 12)
        assert len(ctl.finished) == len(PARITY_JOBS)
        ctl.destroy()
        return ((_deltas(prov_s, "parity"),
                 [j.name for j in sorted(jobs, key=lambda j: j.finish)]),
                (_deltas(prov_l, "parity"), [t.name for t in ctl.finished]))

    sim, live = _same_as_reference(pkg, trace)
    assert sim == live
    assert [d for d in sim[0] if d > 0] == [2, 7, 3]
    assert [d for d in sim[0] if d < 0] == [-7, -5]


@pytest.mark.parametrize("pkg", PKGS)
def test_parity_dynamic_blocks_agree(pkg):
    def trace(p):
        prov_s = _mod(p, "core.provision").ProvisionService()
        sim, srv, _ = _parity_server(p, prov_s)
        sim.run(until=700.0)   # after the release window, before destruction
        ctl, _ = _parity_live(p, 11)
        return ((srv.env.engine.dynamic_blocks, srv.env.owned),
                (ctl.env.engine.dynamic_blocks, ctl.env.owned))

    sim, live = _same_as_reference(pkg, trace)
    assert sim == live


# ----------------------------------------------- tests/test_tre.py:124-185
@pytest.mark.parametrize("pkg", PKGS)
def test_run_max_ticks_flushes_final_tick_completions(pkg):
    def trace(p):
        ctl, core = _stub(p, policy=_mod(p, "core.policy").MgmtPolicy.htc(
            2, 1.0), provision=_mod(p, "core.provision").ProvisionService(),
            tre_name="flush", slots=4, steps_per_tick=1, ticks_per_release=0,
            elastic_grow=False)
        task = core.TrainTask("t", rcfg=None, nodes=1, num_steps=3,
                              ckpt_dir="")
        ctl.submit(task)
        ctl.run(max_ticks=3)          # done in tick 3 == the cutoff
        assert ctl.finished == [task] and task.done
        return (ctl.env.busy, len(ctl._done_last_tick), ctl._tick)

    assert _same_as_reference(pkg, trace) == (0, 0, 3)


@pytest.mark.parametrize("pkg", PKGS)
def test_run_max_ticks_leaves_backlog_queued_not_running(pkg):
    def trace(p):
        ctl, core = _stub(p, policy=_mod(p, "core.policy").MgmtPolicy.htc(
            1, 1.0), provision=_mod(p, "core.provision").ProvisionService(),
            tre_name="cutoff", slots=1, steps_per_tick=1,
            ticks_per_release=0, elastic_grow=False)
        a = core.TrainTask("a", rcfg=None, nodes=1, num_steps=3, ckpt_dir="")
        b = core.TrainTask("b", rcfg=None, nodes=1, num_steps=2, ckpt_dir="")
        ctl.submit(a)
        ctl.submit(b)
        ctl.run(max_ticks=3)          # a finishes on the cutoff, b queued
        assert ctl.finished == [a] and ctl.env.queue == [b]
        out = [(not ctl.running, ctl.env.busy, b.steps_done)]
        ctl.run()                     # resumable: b trains to completion
        assert ctl.finished == [a, b] and b.done
        return out + [(ctl.env.busy, ctl._tick)]

    assert _same_as_reference(pkg, trace) == [(True, 0, 0), (0, 6)]


@pytest.mark.parametrize("pkg", PKGS)
def test_live_backfill_gets_release_profile_from_estimates(pkg):
    """The controller stamps tick-domain runtime estimates at submit, so
    a live TRE with scheduler="backfill" really backfills."""
    def trace(p):
        ctl, core = _stub(p, policy=_mod(p, "core.policy").MgmtPolicy.htc(
            4, 100.0), provision=_mod(p, "core.provision").ProvisionService(),
            tre_name="bf-live", slots=4, steps_per_tick=1,
            ticks_per_release=0, elastic_grow=False, scheduler="backfill")
        tasks = [core.TrainTask(name, rcfg=None, nodes=n, num_steps=s,
                                ckpt_dir="")
                 for name, n, s in (("long", 3, 5), ("wide", 4, 1),
                                    ("fill", 1, 1))]
        for t in tasks:
            ctl.submit(t)
        ctl.tick()
        first = ([t.name for t in ctl.running],
                 [t.name for t in ctl._done_last_tick],
                 [t.name for t in ctl.env.queue])
        ctl.run()
        return first, [t.name for t in ctl.finished], ctl.env.busy

    first, finished, busy = _same_as_reference(pkg, trace)
    # fill (1 node, 1 tick) slips in front of the blocked 4-node head
    assert first == (["long"], ["fill"], ["wide"])
    assert set(finished) == {"long", "wide", "fill"} and busy == 0


# ------------------------------------ tests/test_invariant_guards.py:64
@pytest.mark.parametrize("pkg", PKGS)
def test_mesh_wider_than_device_pool_raises(pkg):
    class _Stub:
        devices = [CPU, CPU]

    ctl = _mod(pkg, "core.controller").ElasticController
    with pytest.raises(RuntimeError, match="mesh wider than device pool"):
        ctl._mesh_for(_Stub(), 3)


# ------------------------------------------------------- the port's own
def _port(devices):
    return ElasticController(
        policy=_mod("repro_torch", "core.policy").MgmtPolicy.htc(1, 1.0),
        provision=_mod("repro_torch", "core.provision").ProvisionService(),
        devices=devices)


def test_job_across_distinct_devices_raises():
    """A job across distinct devices no longer raises: it runs on their
    world, one rank a device (``_mesh_for`` gives the list); one card
    named n times stays one device, in this process; a CPU device of any
    index runs on the CPU."""
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    ctl = _port(cards)
    assert ctl._mesh_for(1) == torch.device("cuda", 0)
    assert ctl._mesh_for(2) == cards
    mixed = _port([CPU, torch.device("meta")])
    assert mixed._mesh_for(2) == [CPU, torch.device("meta")]
    cpus = _port([torch.device("cpu", i) for i in range(4)])
    assert cpus._mesh_for(1) == CPU
    assert cpus._mesh_for(3) == [torch.device("cpu", i) for i in range(3)]
    assert _port([torch.device("cuda", 0)] * 2)._mesh_for(2) == \
        torch.device("cuda", 0)


def test_pool_names_one_card_however_spelled(monkeypatch):
    """"cuda" and "cuda:0" are one card: the pool is normalised to
    indexed devices, so a 2-slot job runs on it."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    ctl = _port([torch.device("cuda"), "cuda:0", torch.device("cuda", 0)])
    assert ctl.env.max_nodes == 3
    assert ctl._mesh_for(3) == torch.device("cuda", 0)
    assert _port([CPU] * 4)._mesh_for(0) == CPU


def _count_resizes(monkeypatch, pkg):
    """{"grow": n, "shrink": n}: calls of the package's env hooks."""
    env = _mod(pkg, "core.tre").HTCRuntimeEnv
    counts = {"grow": 0, "shrink": 0}
    for name in counts:
        def hook(self, *a, _orig=getattr(env, name), _name=name, **kw):
            counts[_name] += 1
            return _orig(self, *a, **kw)
        monkeypatch.setattr(env, name, hook)
    return counts


@pytest.mark.parametrize("pkg", PKGS)
def test_mix_d_decisions_on_a_stub_segment(pkg, monkeypatch):
    """Mix D's decisions, equal across the packages: the initial grant, a
    DR grant and the destroy; train-0 grown 3 times and shrunk twice,
    restarted once; train-1 never resized; 9 ticks, 0 nodes left."""
    def trace(p):
        counts = _count_resizes(monkeypatch, p)
        core = _core(p)
        got = te.decisions(*te.run_mix(
            core, None, "", [CPU] * te.POOL,
            te.stub_controller(core.ElasticController)))
        return got, dict(counts)

    got, counts = _same_as_reference(pkg, trace)
    assert got == {"deltas": [1, 1, -2], "order": ["train-0", "train-1"],
                   "jobs": {"train-0": [12, 5, 1], "train-1": [9, 0, 0]},
                   "ticks": 9, "allocated": 0}
    assert counts == {"grow": 3, "shrink": 2}


# ------------------------------------------------------------ live runs
def _runs():
    """(JAX RunConfig, port RunConfig): qwen2-7b smoke, fp32."""
    jrun = smoke_runconfig("qwen2-7b")
    jrun = dataclasses.replace(jrun, model=dataclasses.replace(
        jrun.model, dtype="float32"))
    trun = RunConfig(
        model=ModelConfig(**dataclasses.asdict(jrun.model)),
        shape=ShapeConfig(**dataclasses.asdict(jrun.shape)),
        parallel=ParallelConfig(**dataclasses.asdict(jrun.parallel)),
        **{f.name: getattr(jrun, f.name) for f in dataclasses.fields(jrun)
           if f.name not in ("model", "shape", "parallel")})
    return jrun, trun


_JAX_MIX = r"""
import dataclasses, json, sys
from types import SimpleNamespace
import jax
from benchmarks import torch_elastic as te
from repro.core import controller
from repro.core.policy import MgmtPolicy
from repro.core.provision import ProvisionService
from tests.conftest import smoke_runconfig

assert len(jax.devices()) == 4, jax.devices()
rcfg = smoke_runconfig("qwen2-7b")
rcfg = dataclasses.replace(rcfg, model=dataclasses.replace(
    rcfg.model, dtype="float32"))
core = SimpleNamespace(ElasticController=controller.ElasticController,
                       TrainTask=controller.TrainTask,
                       MgmtPolicy=MgmtPolicy, ProvisionService=ProvisionService)
ctl, prov = te.run_mix(core, rcfg, sys.argv[1], jax.devices())
print(json.dumps({"decisions": te.decisions(ctl, prov),
                  "losses": {t.name: t.losses for t in ctl.finished}}))
"""


@pytest.fixture(scope="module")
def jax_mix(tmp_path_factory):
    """(the JAX controller's mix D: decisions and losses, the step-0
    checkpoint of JAX's init that both packages' jobs start from). JAX's
    grown segments and every segment of train-1 run on a 2-device data
    mesh."""
    jrun, _ = _runs()
    work = tmp_path_factory.mktemp("mix")
    jax_train_loop(jrun, ckpt_dir=str(work / "init"), num_steps=0,
                   ckpt_every=0)
    for name, *_ in te.JOBS:
        shutil.copytree(work / "init", work / "jax" / name)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", _JAX_MIX,
                          str(work / "jax")], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.splitlines()[-1]), work / "init"


def _port_mix_matches(want, init, root, devices, monkeypatch):
    """Mix D on the port's controller over ``devices`` from ``init``:
    decisions equal to ``want``'s, losses within rtol 1e-4."""
    for name, *_ in te.JOBS:
        shutil.copytree(init, root / name)
    counts = _count_resizes(monkeypatch, "repro_torch")
    _, trun = _runs()
    ctl, prov = te.run_mix(te.PORT, trun, str(root), devices)
    assert te.decisions(ctl, prov) == want["decisions"]
    assert want["decisions"]["deltas"] == [1, 1, -2]   # grant, DR, destroy
    assert counts == {"grow": 3, "shrink": 2}
    assert want["decisions"]["jobs"]["train-0"][2] == 1        # a restart
    for task in ctl.finished:
        ref = want["losses"][task.name]
        assert len(task.losses) == len(ref)
        np.testing.assert_allclose(task.losses, ref, rtol=1e-4,
                                   err_msg=task.name)


def test_live_mix_d_matches_jax_controller(jax_mix, tmp_path, monkeypatch):
    """Mix D live on both packages from one step-0 checkpoint (JAX's
    init): equal decisions, losses within rtol 1e-4. The port's pool is
    4 slots of the CPU, so its grown segments run in this process."""
    want, init = jax_mix
    _port_mix_matches(want, init, tmp_path, [CPU] * te.POOL, monkeypatch)


def test_live_mix_d_on_distinct_devices_runs_worlds(jax_mix, tmp_path,
                                                    monkeypatch):
    """The port's pool is ``cpu:0``...``cpu:3``: a segment over 2 slots
    runs on a world of 2 gloo ranks (``launch.world.spawn_world``), data-
    parallel over the batch, as JAX's runs on its 2-device data mesh. Its
    decisions equal the JAX controller's and its losses lie within rtol
    1e-4 of them; 6 of the 8 segments run as worlds."""
    from repro_torch.launch import world
    want, init = jax_mix
    worlds = []
    spawn = world.spawn_world

    def counted(n, *a, **kw):
        worlds.append((n, kw["devices"]))
        return spawn(n, *a, **kw)

    monkeypatch.setattr(_mod("repro_torch", "core.controller"),
                        "spawn_world", counted)
    devices = [torch.device("cpu", i) for i in range(te.POOL)]
    _port_mix_matches(want, init, tmp_path, devices, monkeypatch)
    assert worlds == [(2, devices[:2])] * 6


def test_live_mix_d_losses_equal_a_straight_run_bitwise(tmp_path):
    """Segments, checkpoint round trips, grows, shrinks and the restart
    leave the math alone: the port's mix D losses are a straight
    ``train_loop`` run's, bit for bit, with train-0's step 3 twice."""
    _, trun = _runs()
    row = te.elastic_row(trun, "cpu", str(tmp_path))
    assert row["decisions"] == row["stub"]
    assert row["decisions"]["allocated"] == 0
    straight = row["straight"]
    assert len(straight) == 12
    assert row["jobs"]["train-0"]["losses"] == straight[:4] + straight[3:] \
        == row["expected"]["train-0"]
    assert row["jobs"]["train-1"]["losses"] == straight[:9] \
        == row["expected"]["train-1"]
    segs = row["segments"]
    assert [(s["job"], s["first"], s["steps"], s["alloc"]) for s in segs] \
        == [("train-0", 0, 3, 1), ("train-0", 3, 1, 1), ("train-0", 3, 3, 2),
            ("train-0", 6, 3, 2), ("train-0", 9, 3, 2), ("train-1", 0, 3, 2),
            ("train-1", 3, 3, 2), ("train-1", 6, 3, 2)]
    # the preempted segment saves nothing; every other one saves once
    assert [s["save_s"] is None for s in segs] == [
        False, True, False, False, False, False, False, False]
    for job in row["jobs"].values():
        assert 0 < job["io_share"] < 1 and job["tokens_per_s"] > 0


def test_segments_leave_no_tensor_behind(tmp_path):
    """A segment's state, LM and step are freed when it returns, without
    the garbage collector: no reference cycle holds a tensor (the
    checkpoint restore once held every restored leaf in one), so two
    jobs' states never share the card."""
    import gc
    _, trun = _runs()
    # a first step of any run imports what torch loads lazily
    train_loop(trun, ckpt_dir=str(tmp_path / "warm"), num_steps=1,
               ckpt_every=0, device="cpu")
    gc.collect()
    gc.disable()
    try:
        te.run_mix(te.PORT, trun, str(tmp_path / "mix"), [CPU] * te.POOL)
        left = [o for o in gc.get_objects() if isinstance(o, torch.Tensor)]
    finally:
        gc.enable()
    assert left == []


# -------------------------------------------------------------- examples
def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_elastic_train_example_on_the_cpu(capsys):
    _example("elastic_train_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "train-0: steps=25" in out and "train-1: steps=25" in out
    assert "elastic DSP training OK" in out


def test_serve_workflow_example_on_the_cpu(capsys):
    _example("serve_workflow_torch").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 52 workflow tasks" in out
    assert "trigger-monitor order OK" in out
