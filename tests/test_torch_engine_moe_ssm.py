"""The port's ``Engine`` serving the MoE, SSM and hybrid archs on the CPU:
in fp32 it gives the JAX engine's greedy tokens in its finish order,
contiguous and paged, over several admission waves.

The MoE archs (arctic, kimi-k2, jamba) run at ``capacity_factor =
n_experts / top_k``, where the capacity C equals the call's T rows and
nothing drops. At the default capacity the reference couples the rows of
a call (tests/test_torch_moe_ssm.py): a decode step's inactive slots take
capacity too, and the port returns a finished slot's length to 0 where
the JAX engine keeps it, so the two engines' inactive rows differ and so
could their drops. At C = T the rows are independent and the engines must
agree exactly.
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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_smoke_config as port_smoke  # noqa: E402
from repro_torch.models.lm import LM  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ARCHS = ["jamba-1.5-large-398b", "mamba2-1.3b", "arctic-480b",
         "kimi-k2-1t-a32b"]


def _no_drop(cfg):
    """fp32, and C = T for an MoE arch (see the module docstring)."""
    over = dict(dtype="float32")
    if cfg.moe:
        over["capacity_factor"] = cfg.n_experts / cfg.top_k
    return dataclasses.replace(cfg, **over)


@functools.cache
def _models(arch):
    jcfg = _no_drop(get_smoke_config(arch))
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(0))[0]
    lm = LM(_no_drop(port_smoke(arch)),
            params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
            device="cpu")
    return jlm, jparams, lm


def _requests(cls, vocab):
    # prompts below the smoke SSD chunk (16), as the chunk rule requires
    r = np.random.default_rng(31)
    plens, budgets = (4, 6, 4, 6, 6, 4), (3, 5, 2, 4, 3, 5)
    return [cls(rid=i, tokens=r.integers(1, vocab, (p,)).astype(np.int32),
                max_new_tokens=b)
            for i, (p, b) in enumerate(zip(plens, budgets))]


@pytest.mark.parametrize("page_size", [None, 8])
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine_fp32(arch, page_size):
    jlm, jparams, lm = _models(arch)
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    jeng = JaxEngine(jlm, jparams, rt, max_batch=3, max_len=32,
                     page_size=page_size)
    want = jeng.run(_requests(JaxRequest, lm.cfg.vocab_size))
    eng = Engine(lm, max_batch=3, max_len=32, page_size=page_size,
                 device="cpu")
    got = eng.run(_requests(Request, lm.cfg.vocab_size))
    assert len(got) == 6
    assert [r.rid for r in got] == [r.rid for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g.out_tokens),
                                      np.asarray(w.out_tokens))
    if page_size is not None:
        assert eng.pager.used_pages == 0
        eng.pager.check_conservation()
