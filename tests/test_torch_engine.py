"""The port's continuous-batching ``Engine`` on the CPU: the JAX engine's
admission contract (tests/test_serve_driver.py:477-600,
tests/test_paged.py:250-309) held by the port, and the slice as a whole —
in fp32 the port serves the JAX engine's greedy tokens in its finish
order, contiguous and paged.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import ParallelConfig  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.serve.engine import Engine as JaxEngine  # noqa: E402
from repro.serve.engine import Request as JaxRequest  # noqa: E402
from repro_torch.bridge import init_params, params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.paged import pages_for  # noqa: E402

ARCH = "musicgen-large"


@functools.cache
def _models(dtype):
    """(JAX LM, JAX params, port LM on the same weights) for ``dtype``."""
    jcfg = dataclasses.replace(get_smoke_config(ARCH), dtype=dtype)
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(0))[0]
    cfg = dataclasses.replace(port_smoke(ARCH), dtype=dtype)
    lm = LM(cfg, params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            device="cpu")
    return jlm, jparams, lm


@pytest.fixture(scope="module")
def musicgen_lm():
    """The smoke musicgen of the JAX engine tests, bf16, seeded weights."""
    cfg = port_smoke(ARCH)
    return LM(cfg, init_params(cfg, torch.Generator().manual_seed(0), "cpu"),
              device="cpu")


def _engine(lm, **kw):
    return Engine(lm, max_batch=4, max_len=48, device="cpu", **kw)


def _req(cls, rid, plen, budget, r, ncb=4, vocab=256):
    return cls(rid=rid, tokens=r.integers(1, vocab, (plen, ncb)).astype(
        np.int32), max_new_tokens=budget)


def _reqs(seed, plens, budget=3, cls=Request):
    r = np.random.default_rng(seed)
    return [_req(cls, i, p, budget, r) for i, p in enumerate(plens)]


def _drain(eng):
    done = []
    while eng.active:
        done.extend(eng.step())
    return done


# ------------------------------------------ the JAX engine's contract
def test_batched_admit_matches_single_admit(musicgen_lm):
    eng = _engine(musicgen_lm)
    solo = []
    for req in _reqs(11, (4, 4, 4)):
        assert eng.admit(req)
        _drain(eng)
        solo.append(np.asarray(req.out_tokens))
    batch = _reqs(11, (4, 4, 4))
    assert len(eng.admit_many(batch)) == 3
    assert eng.prefills == 4          # three solo passes, one grouped
    assert len(_drain(eng)) == 3
    for req, ref in zip(batch, solo):
        np.testing.assert_array_equal(np.asarray(req.out_tokens), ref)


def test_admit_many_finishes_in_call_order_across_shape_groups(musicgen_lm):
    eng = _engine(musicgen_lm)
    assert len(eng.admit_many(_reqs(3, (4, 6, 4, 6)))) == 4
    assert eng.prefills == 2          # one pass per prompt shape
    assert [r.rid for r in _drain(eng)] == [0, 1, 2, 3]


def test_chunked_prefill_matches_unchunked(musicgen_lm):
    ref = _engine(musicgen_lm)
    ref_batch = _reqs(21, (4, 4, 4))
    ref.admit_many(ref_batch)
    _drain(ref)
    eng = _engine(musicgen_lm, prefill_chunk=2)
    batch = _reqs(21, (4, 4, 4))
    assert len(eng.admit_many(batch)) == 3
    assert eng.prefills == 2          # one full chunk + one padded chunk
    _drain(eng)
    for got, want in zip(batch, ref_batch):
        np.testing.assert_array_equal(np.asarray(got.out_tokens),
                                      np.asarray(want.out_tokens))
    assert [r.rid for r in batch] == [0, 1, 2]
    assert len(eng.free) == 4 and not eng.active


def test_admit_many_oversize_rejected_individually(musicgen_lm):
    eng = _engine(musicgen_lm)
    r = np.random.default_rng(5)
    ok, oversize, ok2 = (_req(Request, 0, 4, 3, r), _req(Request, 1, 40, 40, r),
                         _req(Request, 2, 6, 2, r))
    admitted = eng.admit_many([ok, oversize, ok2])
    assert [q.rid for q in admitted] == [0, 2]
    assert oversize.rejected and oversize.done and not oversize.out_tokens
    assert not ok.rejected and not ok2.rejected
    assert len(eng.free) == 2
    assert sorted(q.rid for q in eng.run([])) == [0, 2]
    assert len(eng.free) == 4 and not eng.active
    done = eng.run([_req(Request, 3, 4, 3, r), _req(Request, 4, 40, 40, r)])
    assert sorted(q.rid for q in done) == [3, 4]
    assert next(q for q in done if q.rid == 4).rejected


def test_paged_engine_bitwise_matches_contiguous_engine(musicgen_lm):
    """Across admission waves that reuse pages, the paged engine serves
    the contiguous engine's tokens bit for bit, in its finish order."""
    contiguous = _engine(musicgen_lm)
    paged = _engine(musicgen_lm, page_size=8)
    assert paged.pager.capacity_pages == 4 * 6

    def serve(eng):
        reqs = _reqs(23, (5,) * 9, budget=6)     # > 2 full batches
        order, pending = [], list(reqs)
        while pending or eng.active:
            admitted = eng.admit_many(pending[:len(eng.free)])
            pending = pending[len(admitted):]
            order.extend(r.rid for r in eng.step())
        return reqs, order

    ref_reqs, ref_order = serve(contiguous)
    pg_reqs, pg_order = serve(paged)
    assert pg_order == ref_order
    for a, b in zip(pg_reqs, ref_reqs):
        np.testing.assert_array_equal(np.asarray(a.out_tokens),
                                      np.asarray(b.out_tokens))
    assert paged.pager.used_pages == 0
    paged.pager.check_conservation()


def test_oversize_rejects_leak_neither_slots_nor_pages(musicgen_lm):
    eng = _engine(musicgen_lm, page_size=8)
    r = np.random.default_rng(5)
    batch = [_req(Request, 0, 5, 4, r), _req(Request, 1, 40, 40, r),
             _req(Request, 2, 6, 3, r), _req(Request, 3, 47, 2, r)]
    assert [q.rid for q in eng.admit_many(batch)] == [0, 2]
    assert batch[1].rejected and batch[3].rejected
    assert len(eng.free) == 2
    assert eng.pager.used_pages == pages_for(5 + 4, 8) + pages_for(6 + 3, 8)
    _drain(eng)
    assert eng.pager.used_pages == 0
    eng.pager.check_conservation()


@pytest.mark.parametrize("page_size", [None, 8])
def test_prompt_at_max_len_minus_one_stays_in_range(musicgen_lm, page_size):
    """A prompt of max_len - 1 with a budget of 1 fills its slot to the
    last position. Its row then sits inactive while others decode: the
    engine must keep its length inside the cache (torch raises on an
    out-of-range write where JAX's scatter drops it)."""
    eng = _engine(musicgen_lm, page_size=page_size)
    r = np.random.default_rng(9)
    full, other = _req(Request, 0, 47, 1, r), _req(Request, 1, 5, 6, r)
    assert len(eng.admit_many([full, other])) == 2
    done = []
    while eng.active:
        done.extend(eng.step())
        assert eng.lengths.max() <= eng.max_len - 1
    assert [q.rid for q in done] == [0, 1]
    assert len(full.out_tokens) == 2 and len(other.out_tokens) == 6


@pytest.mark.parametrize("page_size", [None, 8])
def test_zero_budget_prompt_at_max_len_matches_jax_contiguous(page_size):
    """A prompt of exactly max_len with a budget of 0 is admitted and
    decoded once with its write at position max_len. The row writes
    nothing and attends over its full cache: its tokens equal the JAX
    contiguous engine's (whose scatter drops the write), paged and
    contiguous alike, in fp32 on qwen2-7b's smoke config."""
    arch, max_len = "qwen2-7b", 32
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(0))[0]
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    lm = LM(dataclasses.replace(port_smoke(arch), dtype="float32"),
            params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            device="cpu")

    def requests(cls):
        r = np.random.default_rng(5)
        return [cls(rid=0, tokens=r.integers(1, 256, (max_len,)).astype(
                    np.int32), max_new_tokens=0),
                cls(rid=1, tokens=r.integers(1, 256, (6,)).astype(np.int32),
                    max_new_tokens=3)]

    want = JaxEngine(jlm, jparams, rt, max_batch=2,
                     max_len=max_len).run(requests(JaxRequest))
    got = Engine(lm, max_batch=2, max_len=max_len, page_size=page_size,
                 device="cpu").run(requests(Request))
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1]
    assert len(got[0].out_tokens) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.out_tokens),
                                      np.asarray(w.out_tokens))


# ----------------------------------------------------- the slice
@pytest.mark.parametrize("page_size", [None, 8])
def test_engine_matches_jax_engine_fp32(page_size):
    """fp32, same weights and requests: the port's greedy tokens and
    finish order equal the JAX engine's, over several admission waves
    with two prompt shapes and mixed budgets."""
    jlm, jparams, lm = _models("float32")
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    plens = (4, 6, 4, 6, 6, 4, 4)
    budgets = (3, 5, 6, 2, 4, 3, 5)

    def requests(cls):
        r = np.random.default_rng(31)
        return [_req(cls, i, p, b, r)
                for i, (p, b) in enumerate(zip(plens, budgets))]

    jeng = JaxEngine(jlm, jparams, rt, max_batch=4, max_len=48,
                     page_size=page_size)
    want = jeng.run(requests(JaxRequest))
    got = _engine(lm, page_size=page_size).run(requests(Request))
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.out_tokens),
                                      np.asarray(w.out_tokens))


def test_launch_serve_cli_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "3",
                       "--page-size", "8"])
    out = capsys.readouterr().out
    assert "served 3 requests" in out and "cpu" in out
