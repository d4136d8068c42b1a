"""The port's MoE and Mamba2 layers, and the LMs built of them, vs the JAX
package's, on the same weights (``params_from_jax``) and the same numpy
inputs, on the CPU.

MoE keeps the reference's capacity semantics: the capacity spans all
rows of the call and overflow is dropped in token-major, k-minor order.
The module test runs with drops present and requires the same routing,
the same drops and the same outputs. fp32 tolerances: 1e-5 for one
layer, 1e-4 for logits (sums reorder across frameworks; observed ~1e-6).
bf16 logits within 5e-2, as for the dense archs (tests/test_torch_model.py).
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
from repro.models import blocks as jblocks  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.lm import LM, tree_leaves  # noqa: E402

ARCHS = ["arctic-480b",           # MoE + dense residual MLP
         "kimi-k2-1t-a32b",       # MoE + shared expert
         "jamba-1.5-large-398b",  # hybrid: attention, Mamba2, MoE
         "mamba2-1.3b"]           # pure SSM
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
# The 16-layer jamba stack is held to the bf16 tolerance block by block,
# not through its logits. Two effects compound over its depth, and
# neither is a fault of either side (measured on these inputs, logits of
# magnitude ~3): XLA's compiled bf16 skips roundings between fused
# elementwise ops that eager code keeps (a 16-layer mamba2 stack drifts
# 0.58 from compiled JAX but 0.039 from eager JAX), and top-2 choices at
# near ties (probability gaps below 1e-3) flip when the router's bf16
# input differs in its last bit (a drift of 0.7).
BF16_LM_ARCHS = ["arctic-480b", "kimi-k2-1t-a32b", "mamba2-1.3b"]


@functools.cache
def _pair(arch, dtype):
    """(jax cfg, jax LM, jax params, port LM) on the same weights."""
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


def _np_tree(tree):
    """A JAX pytree -> the same nested dicts/tuples of numpy arrays."""
    return jax.tree.map(np.asarray, tree)


def _assert_trees_close(got, want, **tol):
    want_leaves = jax.tree.leaves(want)
    got_leaves = jax.tree.leaves(jax.tree.map(
        _f32, got, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, _f32(w), **tol)


# ----------------------------------------------------------------- MoE
def test_route_and_moe_apply_match_jax_with_drops():
    """fp32, one arctic-smoke MoE layer, 2 x 24 tokens: the capacity (15
    slots per expert) drops some assignments. Routing, the losses, the
    drops and the combined output all equal the reference's."""
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"),
                              dtype="float32")
    jparams = JaxLM(cfg).init(jax.random.key(1))[0]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["moe"])
    tp = params_from_jax(_np_tree(jp), "cpu")
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    jids, jwts, jaux = jmoe.route(jp, cfg, jnp.asarray(x))
    tids, twts, taux = tmoe.route(tp, cfg, torch.from_numpy(x))
    # top-k order on ties is the lower index in both; the inputs have none
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ jp["router"], axis=-1)), axis=-1)
    assert np.all(np.diff(probs, axis=-1) > 0)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(twts.numpy(), np.asarray(jwts), rtol=1e-6,
                               atol=1e-6)
    for key in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(taux[key].item(), float(jaux[key]),
                                   rtol=1e-6)
    _, _, kept = tmoe.dispatch(tids, cfg)
    assert tmoe.capacity(48, cfg) == 15
    assert 0 < int((~kept).sum()) < kept.numel()      # overflow present
    want = jmoe.moe_apply(jp, cfg, jnp.asarray(x), jids, jwts)
    got = tmoe.moe_apply(tp, cfg, torch.from_numpy(x), tids, twts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # the drop order: a token's assignment survives iff fewer than C
    # earlier assignments (token-major, k-minor) went to its expert
    flat = tids.reshape(-1).numpy()
    seen = np.zeros(cfg.n_experts, int)
    for n, e in enumerate(flat):
        assert bool(kept[n]) == (seen[e] < 15)
        seen[e] += 1


def _arctic_moe_layer(seed=1):
    """fp32 arctic-smoke MoE layer: (cfg, jax params, port params)."""
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"),
                              dtype="float32")
    jparams = JaxLM(cfg).init(jax.random.key(seed))[0]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["pos0"]["moe"])
    return cfg, jp, params_from_jax(_np_tree(jp), "cpu")


def test_dispatch_kept_slots_form_a_prefix():
    """Each expert's kept slots are its rows 0..n_e - 1, n_e = min(its
    assignments, C), with drops present: routed ids of a real layer, and
    skewed random ids where a few experts overflow."""
    cfg, _, tp = _arctic_moe_layer()
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    routed, _, _ = tmoe.route(tp, cfg, torch.from_numpy(x))
    r = np.random.default_rng(8)
    skewed = torch.from_numpy(np.minimum(
        r.geometric(0.35, (3, 16, cfg.top_k)) - 1,
        cfg.n_experts - 1)).long()
    for ids in (routed, skewed):
        tok, _, kept = tmoe.dispatch(ids, cfg)
        T, C = ids.shape[0] * ids.shape[1], tok.shape[1]
        assert 0 < int((~kept).sum()) < kept.numel()      # drops present
        filled = tok < T
        counts = filled.sum(dim=1)
        assert torch.equal(filled, torch.arange(C)[None, :]
                           < counts[:, None])
        assigned = torch.bincount(ids.reshape(-1), minlength=cfg.n_experts)
        assert torch.equal(counts, assigned.clamp(max=C))


def test_moe_apply_with_counts_matches_jax_local(monkeypatch):
    """moe_apply hands every expert product the filled counts, (tok < T)
    per expert, and still equals the reference's ``_moe_local`` (no mesh,
    every expert local) in fp32 with drops present."""
    cfg, jp, tp = _arctic_moe_layer()
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    seen = []
    gmm = tmoe.ops.gmm

    def spy(xe, w, counts=None):
        seen.append(counts)
        return gmm(xe, w, counts)

    monkeypatch.setattr(tmoe.ops, "gmm", spy)
    tids, twts, _ = tmoe.route(tp, cfg, torch.from_numpy(x))
    got = tmoe.moe_apply(tp, cfg, torch.from_numpy(x), tids, twts)
    tok, _, kept = tmoe.dispatch(tids, cfg)
    assert 0 < int((~kept).sum()) < kept.numel()
    want_counts = (tok < 48).sum(dim=1).to(torch.int32)
    assert len(seen) == 3 and all(torch.equal(c, want_counts) for c in seen)
    assert int(want_counts.max()) == 15                # a full expert
    jids, jwts, _ = jmoe.route(jp, cfg, jnp.asarray(x))
    want = jmoe._moe_local(jnp.asarray(x), jids, jwts, jp["w_in"],
                           jp["w_gate"], jp["w_out"], cfg=cfg,
                           n_local=cfg.n_experts, axis=None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_moe_capacity_couples_the_rows_of_a_call():
    """The reference's capacity spans the call: a row's output can change
    when batch mates are added, and at capacity_factor = E / k (C = T)
    nothing drops and each row equals its solo call."""
    base = dataclasses.replace(get_smoke_config("arctic-480b"),
                              dtype="float32")
    jparams = JaxLM(base).init(jax.random.key(1))[0]
    tp = params_from_jax(_np_tree(jax.tree.map(
        lambda a: a[0], jparams["blocks"]["pos0"]["moe"])), "cpu")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 16, base.d_model)).astype(np.float32))

    def run(cfg, rows):
        ids, wts, _ = tmoe.route(tp, cfg, rows)
        return tmoe.moe_apply(tp, cfg, rows, ids, wts)

    solo = run(base, x[:1])
    assert not torch.allclose(run(base, x)[:1], solo, atol=1e-6)
    roomy = dataclasses.replace(base,
                                capacity_factor=base.n_experts / base.top_k)
    np.testing.assert_allclose(run(roomy, x)[:1].numpy(),
                               run(roomy, x[:1]).numpy(), rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------------- Mamba2
@pytest.mark.parametrize("arch", ["mamba2-1.3b", "jamba-1.5-large-398b"])
def test_mamba_apply_prefill_and_decode_match_jax(arch):
    """fp32: a 32-token prefill (two SSD chunks) returns the reference's
    output, conv tails and state; three decode steps from them, carrying
    both states, return its outputs and states."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    i = next(i for i in range(cfg.pattern_period)
             if cfg.block_kind(i) == "ssm")
    jparams = JaxLM(cfg).init(jax.random.key(2))[0]
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"][f"pos{i}"]["mamba"])
    tp = params_from_jax(_np_tree(jp), "cpu")
    r = np.random.default_rng(7)
    x = r.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want, (jconv, jstate) = jssm.mamba_apply(jp, cfg, jnp.asarray(x))
    got, cache = tssm.mamba_apply(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _assert_trees_close(cache, (jconv, jstate), rtol=1e-5, atol=1e-5)
    assert cache[1].dtype == torch.float32
    for _ in range(3):
        tok = r.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, (jconv, jstate) = jssm.mamba_apply(
            jp, cfg, jnp.asarray(tok), conv_state=jconv, ssm_state=jstate,
            decode=True)
        got, cache = tssm.mamba_apply(tp, cfg, torch.from_numpy(tok),
                                      cache=cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        _assert_trees_close(cache, (jconv, jstate), rtol=1e-5, atol=1e-5)


def test_ssm_prompt_breaking_the_chunk_rule_raises():
    """ssd_chunked asserts S % min(chunk, S) == 0; the port raises rather
    than pad, which would change the state."""
    _, _, _, lm = _pair("mamba2-1.3b", "float32")
    assert lm.cfg.ssm_chunk == 16
    tokens = torch.ones((1, 20), dtype=torch.int32)
    with pytest.raises(ValueError, match="SSD chunk"):
        lm.prefill({"tokens": tokens})
    lm.prefill({"tokens": tokens[:, :12]})
    lm.prefill({"tokens": torch.ones((1, 32), dtype=torch.int32)})


# ------------------------------------------------------------------ LM
def _paged(tree, lm, table, ps):
    """Lay every attention leaf (R, B, S, KVH, hd) of a contiguous cache
    out as a page pool; Mamba2 leaves stay slot-indexed."""
    out = {}
    for key, pair in tree.items():
        if lm.cache_kind(key) != "attn":
            out[key] = pair
            continue
        pools = []
        for a in pair:
            R, B, S = a.shape[:3]
            pool = np.zeros((R, 1 + table.size, ps) + a.shape[3:], a.dtype)
            pool[:, table.reshape(-1)] = a.reshape(R, B * (S // ps), ps,
                                                   *a.shape[3:])
            pools.append(pool)
        out[key] = tuple(pools)
    return out


@pytest.mark.parametrize("arch,dtype",
                         [(a, "float32") for a in ARCHS]
                         + [(a, "bfloat16") for a in BF16_LM_ARCHS])
def test_prefill_and_decode_match_jax(arch, dtype):
    """prefill logits and caches, then one decode step over contiguous
    caches and over shuffled attention pages, against
    ``repro.models.lm.LM``; in the port paged == contiguous bit for bit."""
    jcfg, jlm, jparams, lm = _pair(arch, dtype)
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    B, S, ps, max_len = 2, 12, 8, 32
    r = np.random.default_rng(2)
    toks = r.integers(1, jcfg.vocab_size, (B, S)).astype(np.int32)
    jlog, jcache, _ = jlm.prefill(jparams, rt, {"tokens": jnp.asarray(toks)})
    tlog, tcache = lm.prefill({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL[dtype])
    _assert_trees_close(tcache, jcache, **TOL[dtype])

    nxt = r.integers(1, jcfg.vocab_size, (B, 1)).astype(np.int32)
    lens = np.array([S, S - 5], np.int32)
    jc = jax.tree.map(lambda d, s: jax.lax.dynamic_update_slice(
        d, s.astype(d.dtype), (0,) * d.ndim), jlm.init_cache(B, max_len),
        jcache)
    jlog, jnew = jlm.decode(jparams, rt, jnp.asarray(nxt), jnp.asarray(lens),
                            jc)
    tc = params_from_jax(_np_tree(jc), "cpu")
    tlog, tc = lm.decode(torch.from_numpy(nxt), torch.from_numpy(lens), tc)
    np.testing.assert_allclose(_f32(tlog), _f32(jlog), **TOL[dtype])
    _assert_trees_close(tc, jnew, **TOL[dtype])

    table = (1 + np.random.default_rng(4).permutation(
        B * max_len // ps)).reshape(B, -1).astype(np.int32)
    jpaged = _paged(_np_tree(jc), lm, table, ps)
    jlog_p, _ = jlm.decode(jparams, rt, jnp.asarray(nxt), jnp.asarray(lens),
                           jax.tree.map(jnp.asarray, jpaged),
                           page_table=jnp.asarray(table))
    tlog_p, _ = lm.decode(torch.from_numpy(nxt), torch.from_numpy(lens),
                          params_from_jax(jpaged, "cpu"),
                          page_table=torch.from_numpy(table))
    np.testing.assert_allclose(_f32(tlog_p), _f32(jlog_p), **TOL[dtype])
    assert torch.equal(tlog_p, tlog)


def test_jamba_blocks_match_jax_bf16():
    """bf16, each of jamba's 8 pattern positions (attention or Mamba2,
    then MoE or dense MLP) on the same input: output and cache within the
    bf16 tolerance of ``repro.models.blocks.block_apply``."""
    jcfg, jlm, jparams, lm = _pair("jamba-1.5-large-398b", "bfloat16")
    rt = jlm.runtime(ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16))
    r = np.random.default_rng(8)
    x = r.standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    kinds = set()
    for i in range(jcfg.pattern_period):
        jp = jax.tree.map(lambda a: a[0], jparams["blocks"][f"pos{i}"])
        want, jcache, _ = jblocks.block_apply(jp, jcfg, rt, jx,
                                              jnp.asarray(pos), i)
        got, tcache = tblocks.block_apply(lm._layers[0][i], lm.cfg, tx,
                                          torch.from_numpy(pos.copy()), i)
        np.testing.assert_allclose(_f32(got), _f32(want), **TOL["bfloat16"])
        _assert_trees_close(tcache, jcache, **TOL["bfloat16"])
        kinds.add((jcfg.block_kind(i), jcfg.is_moe_layer(i)))
    assert kinds == {("attn", True), ("ssm", True), ("ssm", False)}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_carries_every_leaf(arch):
    """Every JAX leaf arrives with its name, shape, dtype and bits: the
    router, a_log, d_skip and dt_bias in fp32, the rest in bf16."""
    _, _, jparams, lm = _pair(arch, "bfloat16")
    jleaves = {"/".join(str(k.key) for k in path): np.asarray(leaf)
               for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    tleaves = dict(tree_leaves(lm.params))
    assert set(tleaves) == set(jleaves)
    for path, a in jleaves.items():
        t = tleaves[path]
        fp32 = path.rsplit("/", 1)[-1] in ("router", "a_log", "d_skip",
                                           "dt_bias")
        assert t.dtype == (torch.float32 if fp32 else torch.bfloat16), path
        assert tuple(t.shape) == a.shape
        bits = np.int32 if fp32 else np.int16
        np.testing.assert_array_equal(t.view(getattr(torch, bits.__name__))
                                      .numpy(), a.view(bits))


def test_init_params_draws_large_leaves_in_slices(monkeypatch):
    """A leaf over the draw limit is drawn slice by slice along its
    leading axes, straight into the leaf: same shapes, dtypes and law,
    every expert its own draw."""
    from repro_torch import bridge
    cfg = tconfigs.get_smoke_config("arctic-480b")
    whole = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(bridge, "DRAW_LIMIT_BYTES", 4096)
    sliced = bridge.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (path, a), (_, b) in zip(tree_leaves(whole), tree_leaves(sliced)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    w = sliced["blocks"]["pos0"]["moe"]["w_in"]          # (R, E, d, f)
    assert w.numel() * 4 > 4096
    assert not torch.equal(w[0, 0], w[0, 1])
    std = cfg.d_model ** -0.5
    assert abs(w.float().std().item() / std - 1) < 0.1
