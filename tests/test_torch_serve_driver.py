"""The port's DSP control plane driving a real engine, on the CPU: the
port's ``Engine`` through ``TorchEngineAdapter`` against the JAX engine
through ``JaxEngineAdapter``, on musicgen's smoke config with the same
weights (``bridge.params_from_jax``), fp32, in one process on the same
seeds. Schedules (every task's start and finish tick), ``ServeStats``
and ``FleetStats`` must be equal field for field; the synthesized
prompts too.
"""
from __future__ import annotations

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import serve_fleet as jax_fleet  # noqa: E402
from benchmarks import torch_serve_fleet as tsf  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import ParallelConfig  # noqa: E402
from repro.core.policy import MgmtPolicy as JaxPolicy  # noqa: E402
from repro.core.provider import ResourceProvider as JaxProvider  # noqa: E402
from repro.core.types import Job as JaxJob  # noqa: E402
from repro.core.types import Workload as JaxWorkload  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.driver import JaxEngineAdapter  # noqa: E402
from repro.serve.driver import ServeDriver as JaxServeDriver  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.sim.traces import request_stream as jax_request_stream  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.core.policy import MgmtPolicy  # noqa: E402
from repro_torch.core.provider import ResourceProvider  # noqa: E402
from repro_torch.core.provision import ProvisionService  # noqa: E402
from repro_torch.core.types import Job, Workload  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.driver import (  # noqa: E402
    EmulatedEngine, ServeDriver, TorchEngineAdapter)
from repro_torch.serve.engine import Engine  # noqa: E402
from repro_torch.sim.traces import request_stream  # noqa: E402
from tests.test_serve_driver import montage_mini  # noqa: E402

ARCH = "musicgen-large"
MAX_BATCH, MAX_LEN = 4, 48


@functools.cache
def _models():
    """(JAX LM, its runtime, JAX params, port LM on the same weights),
    musicgen smoke, fp32, on the CPU."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32")
    jlm = JaxLM(jcfg)
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    jparams = jlm.init(jax.random.key(0))[0]
    cfg = dataclasses.replace(port_smoke(ARCH), dtype="float32")
    lm = LM(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            device="cpu")
    return jlm, rt, jparams, lm


def _engines(max_batch=MAX_BATCH, page_size=None):
    """(JAX engine, port engine), fresh, over the same weights."""
    jlm, rt, jparams, lm = _models()
    return (JaxEngine(jlm, jparams, rt, max_batch=max_batch,
                      max_len=MAX_LEN, page_size=page_size),
            Engine(lm, max_batch=max_batch, max_len=MAX_LEN,
                   page_size=page_size, device="cpu"))


def _dag_run(pkg, engine):
    """tests/test_serve_driver.py:415 on one package: a Montage DAG through
    ``ServeDriver`` under a first-come provider of 4 slots."""
    JobT, WorkloadT, stream_fn, Provider, Policy, Driver = pkg
    jobs = [JobT(**{f.name: getattr(j, f.name)
                    for f in dataclasses.fields(j)}) for j in montage_mini()]
    wl = WorkloadT("mini", "mtc", jobs, trace_nodes=3, period=600.0)
    stream = stream_fn([wl], period=600.0, seed=0, seconds_per_token=2.0,
                       prompt_lens=(4, 6))
    drv = Driver(stream, provider=Provider(4, coordination="first-come"),
                 engine=engine,
                 policy=Policy(initial=2, ratio=1.0, scan_interval=3.0,
                               release_interval=60.0))
    stats = drv.run()
    times = {j.name: (j.start, j.finish) for _, js in stream for j in js}
    order = [j.jid for j in drv.env.completed]
    return stats.as_dict(), times, order


JAX_PKG = (JaxJob, JaxWorkload, jax_request_stream, JaxProvider, JaxPolicy,
           JaxServeDriver)
PORT_PKG = (Job, Workload, request_stream, ResourceProvider, MgmtPolicy,
            ServeDriver)


@pytest.mark.parametrize("page_size", [None, 8])
def test_serve_driver_on_port_engine_matches_jax_engine(page_size):
    """The same Montage DAG on both real engines: every task's (start,
    finish), the completion order and the ``ServeStats`` are identical,
    every task completes in dependency order, and every slot is freed."""
    jeng, eng = _engines(page_size=page_size)
    want = _dag_run(JAX_PKG, JaxEngineAdapter(jeng, seed=0))
    got = _dag_run(PORT_PKG, TorchEngineAdapter(eng, seed=0))
    assert got == want
    stats, _, order = got
    assert stats["tasks_completed"] == len(montage_mini())
    assert stats["over_admissions"] == 0
    assert len(eng.free) == MAX_BATCH and not eng.active
    deps = {j.jid: j.deps for j in montage_mini()}
    pos = {jid: i for i, jid in enumerate(order)}
    assert all(pos[d] < pos[jid] for jid in order for d in deps[jid])


def test_long_decode_parity_emulator_matches_port():
    """tests/test_serve_driver.py:442 on the port: decode marks beyond the
    cache room finish at the same ticks on ``TorchEngineAdapter`` and on a
    cache-aware ``EmulatedEngine``."""
    def long_jobs():
        return [Job(jid=0, arrival=0.0, runtime=1.0, nodes=1, wid=0,
                    prompt_len=4, decode_len=60, name="long-root"),
                Job(jid=1, arrival=0.0, runtime=1.0, nodes=1, wid=0,
                    deps=(0,), prompt_len=6, decode_len=50, name="long-mid"),
                Job(jid=2, arrival=0.0, runtime=1.0, nodes=1, wid=0,
                    deps=(1,), prompt_len=4, decode_len=7, name="short")]

    _, eng = _engines()
    assert 60 > eng.max_len - 4     # the cap really binds

    def run(engine):
        jobs = long_jobs()
        drv = ServeDriver([(0.0, jobs)], provider=ProvisionService(),
                          engine=engine, fixed_nodes=4)
        stats = drv.run()
        assert stats.tasks_completed == 3 and stats.over_admissions == 0
        return {j.name: (j.start, j.finish) for j in jobs}

    assert run(TorchEngineAdapter(eng, seed=0)) == run(
        EmulatedEngine(4, max_len=eng.max_len))


def test_adapter_prompts_equal_jax_adapters():
    """Same seed, same jobs (prompts shorter than, at and above the cache
    depth, zero and long decode marks): ``TorchEngineAdapter`` draws the
    prompt tokens and sizes the budgets ``JaxEngineAdapter`` does, and
    prices the same service ticks."""
    jeng, eng = _engines()
    marks = [(1, 5), (4, 0), (47, 3), (48, 2), (90, 60), (6, 50), (0, 1)]
    jobs = [Job(jid=i, arrival=0.0, runtime=1.0, nodes=1, prompt_len=p,
                decode_len=d) for i, (p, d) in enumerate(marks)]
    jjobs = [JaxJob(jid=i, arrival=0.0, runtime=1.0, nodes=1, prompt_len=p,
                    decode_len=d) for i, (p, d) in enumerate(marks)]
    port, ref = TorchEngineAdapter(eng, seed=7), JaxEngineAdapter(jeng, seed=7)
    assert (port.capacity, port.max_len, port.pager) == (
        ref.capacity, ref.max_len, ref.pager)
    for job, jjob in zip(jobs, jjobs):
        got, want = port._request(job), ref._request(jjob)
        assert (got.rid, got.max_new_tokens) == (want.rid, want.max_new_tokens)
        np.testing.assert_array_equal(got.tokens, want.tokens)
        assert got.tokens.shape[0] <= MAX_LEN - 1
        assert port.service_ticks(job) == ref.service_ticks(jjob)


def test_short_admit_raises():
    """An admit beyond the engine's free slots is a ``ServeInvariantError``,
    as on the JAX adapter."""
    from repro_torch.serve.driver import ServeInvariantError
    _, eng = _engines(max_batch=2)
    adapter = TorchEngineAdapter(eng, seed=0)
    jobs = [Job(jid=i, arrival=0.0, runtime=1.0, nodes=1, prompt_len=4,
                decode_len=3) for i in range(3)]
    with pytest.raises(ServeInvariantError, match="engine took 2 of 3"):
        adapter.admit_many(jobs)


def test_fleet_on_port_engines_matches_twin_and_jax_engine():
    """The mix-1/2/4 fleet, one workflow per tenant, as
    ``benchmarks/serve_fleet.py --real`` runs it: on the port's paged and
    contiguous engines and the ``EmulatedEngine`` twin (0 mismatches,
    ``fleet_row`` raises on any; every request's tokens equal paged and
    contiguous), and equal to the JAX engine's paged fleet, every
    ``FleetStats`` field (through the twin, which the port's paged run
    equals)."""
    row = tsf.fleet_row(_models()[3], "1/2/4", **tsf.DEFAULTS)
    assert row["parity_mismatches"] == row["paged_vs_contiguous_mismatches"]
    assert row["parity_mismatches"] == 0
    assert row["token_mismatches"] == 0
    assert row["requests"] == row["tasks"] == 156
    assert row["decode_steps"] == row["twin_decode_steps"] == 1283
    assert round(row["billed_vs_dedicated"], 3) == 0.114
    args = SimpleNamespace(workflows=1, jobs_scale=0.05, period=3600.0)
    want, _ = jax_fleet._real_fleet_run(args, "1/2/4",
                                        page_size=tsf.PAGE_SIZE, seed=0)
    twin, _ = tsf.twin_fleet_run("1/2/4", **tsf.DEFAULTS)
    assert twin == want
