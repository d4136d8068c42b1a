"""The port's layers, projections and LM vs the JAX package's, on the same
weights (carried over by ``repro_torch.bridge.params_from_jax``) and the
same numpy inputs, on the CPU.

fp32 pins the arithmetic: logits within 1e-4 (both sides sum in fp32 in
different orders; observed ~2e-6). bf16 pins the same model at its
serving dtype: within 5e-2, since the JAX model rounds scores and
probabilities to bf16 inside attention where the port's kernels keep fp32
(observed <= 4.1e-2 at logits of magnitude ~3).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import ParallelConfig  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    init_params, param_specs, params_from_jax)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models.lm import LM, tree_leaves  # noqa: E402

ARCHS = ["musicgen-large",   # MHA, 4 codebooks
         "qwen2-7b",         # GQA, qkv bias
         "qwen3-14b",        # qk-norm
         "nemotron-4-15b",   # sq_relu MLP
         "internvl2-76b"]    # vision patches prepended
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}


@functools.cache
def _pair(arch, dtype):
    """(jax cfg, jax LM, jax params, port LM) on the same weights; shared
    by the tests of one worker (neither side's params are ever written)."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype)
    jlm = JaxLM(jcfg)
    jparams = jlm.init(jax.random.key(0))[0]
    tcfg = dataclasses.replace(tconfigs.get_smoke_config(arch), dtype=dtype)
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, jlm, jparams, LM(tcfg, tparams, device="cpu")


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _batch(cfg, B, S, seed):
    r = np.random.default_rng(seed)
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks > 1 else (B, S)
    batch = {"tokens": r.integers(1, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.vision_stub:
        batch["patches"] = r.standard_normal(
            (B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return batch


# ------------------------------------------------------------- layers
def test_layers_match_jax():
    r = np.random.default_rng(0)
    x = r.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = r.standard_normal(16).astype(np.float32)
    pos = r.integers(0, 40, (2, 5)).astype(np.int32)
    t = torch.from_numpy
    np.testing.assert_allclose(
        tlayers.rmsnorm(t(scale), t(x), 1e-5).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(scale), jnp.asarray(x))),
        rtol=1e-5, atol=1e-6)
    for theta in (1e4, 1e6):
        np.testing.assert_allclose(
            tlayers.apply_rope(t(x), t(pos), theta).numpy(),
            np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                          theta)),
            rtol=1e-5, atol=1e-5)
    h = r.standard_normal((2, 5, 16)).astype(np.float32)
    p = {k: r.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("w_in", (16, 32)), ("w_gate", (16, 32)),
                      ("w_out", (32, 16)))}
    for act in ("swiglu", "sq_relu"):
        np.testing.assert_allclose(
            tlayers.mlp_apply({k: t(v) for k, v in p.items()}, t(h),
                              act).numpy(),
            np.asarray(jlayers.mlp_apply(
                {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(h),
                act)),
            rtol=1e-5, atol=1e-5)
    k = r.standard_normal((2, 5, 2, 16)).astype(np.float32)
    np.testing.assert_array_equal(
        tattn.repeat_kv(t(k), 6).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(k), 6)))


@pytest.mark.parametrize("arch", ARCHS)
def test_qkv_proj_matches_jax(arch):
    jcfg, _, jparams, lm = _pair(arch, "float32")
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 7, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["attn"])
    want = jattn.qkv_proj(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tattn.qkv_proj(lm._layers[0][0]["attn"], lm.cfg,
                         torch.from_numpy(x), torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


# ----------------------------------------------------------------- LM
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch, dtype):
    """prefill logits and caches, then one decode step over a contiguous
    cache and over a shuffled page pool, against ``repro.models.lm.LM``."""
    jcfg, jlm, jparams, lm = _pair(arch, dtype)
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    B, S, ps = 2, 12, 8
    batch = _batch(jcfg, B, S, seed=2)
    jlog, jcache, _ = jlm.prefill(
        jparams, rt, {k: jnp.asarray(v) for k, v in batch.items()})
    tlog, tcache = lm.prefill({k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL[dtype])
    for got, want in zip(tcache["pos0"], jcache["pos0"]):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])

    n_img = jcfg.n_patches if jcfg.vision_stub else 0
    P, max_len = S + n_img, 32
    r = np.random.default_rng(3)
    shape = (B, 1, jcfg.n_codebooks) if jcfg.n_codebooks > 1 else (B, 1)
    nxt = r.integers(1, jcfg.vocab_size, shape).astype(np.int32)
    lens = np.array([P, P - 5], np.int32)

    # contiguous: both caches hold the JAX prefill's K/V
    jc = jlm.init_cache(B, max_len)
    jc = jax.tree.map(lambda d, s: jax.lax.dynamic_update_slice(
        d, s.astype(d.dtype), (0,) * d.ndim), jc, jcache)
    tc = {key: tuple(torch.from_numpy(np.array(_f32(a))).to(lm.dtype)
                     for a in pair) for key, pair in jc.items()}
    jlog, jnew = jlm.decode(jparams, rt, jnp.asarray(nxt), jnp.asarray(lens),
                            jc)
    tlog, tc = lm.decode(torch.from_numpy(nxt), torch.from_numpy(lens), tc)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL[dtype])
    # the in-place cache write equals JAX's functional update
    for got, want in zip(tc["pos0"], jnew["pos0"]):
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])

    # paged: the same caches laid out in shuffled pages of 8 tokens
    n_pt = max_len // ps
    perm = 1 + np.random.default_rng(4).permutation(B * n_pt)
    table = perm.reshape(B, n_pt).astype(np.int32)
    jpaged = {}
    for key, pair in jc.items():
        pools = []
        for a in pair:
            a = np.asarray(a)           # (R, B, max_len, KVH, hd)
            pool = np.zeros((a.shape[0], 1 + B * n_pt, ps) + a.shape[3:],
                            a.dtype)
            pool[:, table.reshape(-1)] = a.reshape(
                a.shape[0], B * n_pt, ps, *a.shape[3:])
            pools.append(pool)
        jpaged[key] = tuple(pools)
    tpaged = {key: tuple(torch.from_numpy(np.array(_f32(a))).to(lm.dtype)
                         for a in pair) for key, pair in jpaged.items()}
    jlog_p, _ = jlm.decode(jparams, rt, jnp.asarray(nxt), jnp.asarray(lens),
                           jax.tree.map(jnp.asarray, jpaged),
                           page_table=jnp.asarray(table))
    tlog_p, tpaged = lm.decode(torch.from_numpy(nxt), torch.from_numpy(lens),
                               tpaged, page_table=torch.from_numpy(table))
    np.testing.assert_allclose(_f32(tlog_p), _f32(jlog_p), **TOL[dtype])
    # paged and contiguous decode agree bit for bit inside the port
    assert torch.equal(tlog_p, tlog)
    # the decode step wrote row b's new K at its length, through the table
    for b in range(B):
        page, off = table[b, lens[b] // ps], lens[b] % ps
        assert torch.equal(tpaged["pos0"][0][:, page, off],
                           tc["pos0"][0][:, b, lens[b]])


# ------------------------------------------------------------- bridge
def test_bridge_carries_bf16_bits_and_names():
    _, _, jparams, lm = _pair("qwen2-7b", "bfloat16")
    jleaves = {"/".join(str(k.key) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    tleaves = dict(tree_leaves(lm.params))
    assert set(tleaves) == set(jleaves)
    for path, a in jleaves.items():
        t = tleaves[path]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))


@pytest.mark.parametrize("arch", ["qwen2-7b", "qwen3-14b", "nemotron-4-15b",
                                  "arctic-480b", "mamba2-1.3b"])
def test_init_params_shapes_and_laws_match_jax(arch):
    """Same tree, shapes and dtypes as the JAX init (bf16, with the MoE
    router and the Mamba2 a_log, d_skip and dt_bias in fp32); the port's
    draws and the JAX init's follow the laws and scales of
    ``param_specs`` (normal 0.02 embed, normal 0.5 a_log, fan_in normal,
    ones, zeros)."""
    jcfg = get_smoke_config(arch)
    jparams = JaxLM(jcfg).init(jax.random.key(0))[0]
    tcfg = tconfigs.get_smoke_config(arch)
    tparams = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jleaves = {"/".join(str(k.key) for k in path): leaf for path, leaf
               in jax.tree_util.tree_leaves_with_path(jparams)}
    tleaves = dict(tree_leaves(tparams))
    assert set(tleaves) == set(jleaves)
    for path, t in tleaves.items():
        assert tuple(t.shape) == jleaves[path].shape, path
        assert str(t.dtype).removeprefix("torch.") == \
            jleaves[path].dtype.name, path
    laws = dict(tree_leaves(param_specs(tcfg)))
    for path, t in tleaves.items():
        shape, law, scale, _ = laws[path]
        x = t.float()
        if law == "ones":
            assert torch.equal(x, torch.ones_like(x)), path
        elif law == "zeros":
            assert torch.equal(x, torch.zeros_like(x)), path
        else:
            fan = shape[-2] if len(shape) >= 2 else shape[0]
            std = scale if law == "normal" else scale / fan ** 0.5
            jstd = float(np.asarray(jleaves[path].astype(jnp.float32)).std())
            if x.numel() >= 512:   # enough draws to estimate the std
                assert abs(x.std().item() / std - 1) < 0.1, path
                assert abs(jstd / std - 1) < 0.1, path
                assert abs(x.mean().item()) < 0.1 * std, path
            else:
                # a_log's 16 draws at smoke size: a loose band, which
                # still tells its 0.5 from the 0.02 of most normal leaves,
                # for both the port's draw and the JAX init's
                assert 0.5 < x.std().item() / std < 2, path
                assert 0.5 < jstd / std < 2, path
