"""The port's training job against the JAX package's, on the CPU: the same
synthetic batches, the same loss and gradients from the same weights
(carried over by ``repro_torch.bridge``), the same AdamW update, and
checkpoints that each package resumes from the other's directory.

Tolerances, each with the worst this file measured beside it:

- batches: bit for bit.
- fp32 loss and metrics within 1e-5 relative (measured <= 8.1e-8).
- fp32 gradients: every leaf within rtol 1e-4 and atol 1e-6 x max(1,
  the leaf's largest |gradient|) (measured: worst excess over rtol 8.9e-7
  of the leaf's largest |gradient|). The atol is 1e-6 for leaves whose
  gradients stay below 1 and grows with the larger ones, whose entries
  reach 1-17: the fp32 rounding of a sum grows with its terms, so an
  absolute 1e-6 fails on entries that cancel (qwen2's embedding: 1.3e-6
  off at |g| 6e-4, where the leaf's entries reach ~1.4). jamba's smoke
  stack is 16 layers, 14 of them Mamba2, and the stack amplifies fp32
  rounding with depth: its atol is 1e-4 x max(1, scale) (measured: worst
  |difference| 4.4e-5 of scale, 0.31 of this bound, 11 of the dense
  one). ``benchmarks/torch_train_tolerance.py`` measures the port against
  itself with only its sum order changed: 3.2e-6, 1.2e-5 and 3.2e-5 of
  scale at 8, 16 and 32 layers of jamba's smoke stack (0.03-0.24 of this
  bound), while a planted fault lands above it: one leaf's gradient
  scaled by 1.001 at 5.0, the SSD scan's inputs rounded to bf16 at 1512
  or more.
- AdamW: params within 1e-6 relative (measured <= 9.7e-8: 2 of 69
  entries differ in the last bit), moments within one bf16 ulp
  (measured: equal).
- cross-resume losses within 1e-4 relative (measured <= 1.7e-7).
"""
from __future__ import annotations

import dataclasses
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.configs.base import (  # noqa: E402
    ParallelConfig as JParallel, RunConfig as JRun, ShapeConfig as JShape)
from repro.data.synthetic import synthetic_batches as jax_batches  # noqa: E402
from repro.models.lm import LM as JaxLM  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.loop import train_loop as jax_train_loop  # noqa: E402
from repro.train.optimizer import AdamW as JAdamW  # noqa: E402
from repro_torch.bridge import params_from_jax, state_from_jax  # noqa: E402
from repro_torch.configs.base import (  # noqa: E402
    ModelConfig, ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.models.lm import LM, sorted_tree_leaves, tree_leaves  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import train_loop  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

SHAPE = dict(name="smoke", kind="train", seq_len=32, global_batch=2)
CHUNKS = dict(attn_q_chunk=16, attn_kv_chunk=16)
GRAD_ARCHS = ["qwen2-7b", "granite-3-8b", "musicgen-large", "mamba2-1.3b",
              "internvl2-76b", "arctic-480b", "jamba-1.5-large-398b"]
DEEP_SSM = {"jamba-1.5-large-398b"}


def _runs(arch, dtype="float32", **over):
    """(JAX RunConfig, port RunConfig) of one smoke run; MoE archs at
    capacity_factor E / k, where no assignment drops."""
    jcfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                               n_patches=8)
    if jcfg.moe:
        jcfg = dataclasses.replace(
            jcfg, capacity_factor=jcfg.n_experts / jcfg.top_k)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jrun = JRun(model=jcfg, shape=JShape(**SHAPE),
                parallel=JParallel(**CHUNKS), warmup_steps=2, **over)
    trun = RunConfig(model=tcfg, shape=ShapeConfig(**SHAPE),
                     parallel=ParallelConfig(**CHUNKS), warmup_steps=2,
                     **over)
    return jrun, trun


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    return np.asarray(x, np.float32) if x.dtype == jnp.bfloat16 \
        else np.asarray(x)


# ----------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen2-7b", "musicgen-large",
                                  "internvl2-76b"])
def test_synthetic_batches_bit_equal_to_jax(arch):
    """Tokens, targets, mask and (bf16) patches, for two steps and two
    seeds: the same numpy draws, the same bits."""
    for seed in (0, 5):
        jrun, trun = _runs(arch, dtype="bfloat16", seed=seed)
        jb, tb = jax_batches(jrun), synthetic_batches(trun, "cpu")
        for step in (0, 3):
            a, b = jb(step), tb(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert b[k].dtype == {"tokens": torch.int32,
                                      "targets": torch.int32,
                                      "mask": torch.float32,
                                      "patches": torch.bfloat16}[k]
                assert tuple(b[k].shape) == a[k].shape
                if k == "patches":
                    assert np.array_equal(
                        b[k].view(torch.int16).numpy(),
                        np.asarray(a[k]).view(np.int16))
                else:
                    assert np.array_equal(b[k].numpy(), np.asarray(a[k]))


# ------------------------------------------------------------ attention
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("S,Sk,qc,kc,causal,impl", [
    (32, 32, 16, 16, True, "masked"), (32, 32, 8, 16, True, "masked"),
    (32, 32, 8, 8, True, "triangular"), (37, 37, 16, 8, True, "masked"),
    (20, 29, 8, 16, False, "masked"), (12, 12, 64, 64, True, "masked")])
def test_chunked_attention_matches_jax(S, Sk, qc, kc, causal, impl, dtype,
                                       tol):
    """Ragged lengths (padded and masked), chunks that do not divide S,
    both impls, causal or not, against ``repro.models.attention``; the
    backward too, in fp32 (measured: forward <= 4.8e-7 and gradients <=
    9.6e-7 in fp32; bf16 forward bit-equal)."""
    from repro.models.attention import chunked_attention as jax_attn
    from repro_torch.models.attention import chunked_attention
    r = np.random.default_rng(S + Sk + qc)
    q, k, v = (r.standard_normal((2, n, 3, 16)).astype(np.float32)
               for n in (S, Sk, Sk))
    jdt = jnp.dtype(dtype)
    kw = dict(causal=causal, q_chunk=qc, kv_chunk=kc, impl=impl)
    want = jax_attn(*(jnp.asarray(t, jdt) for t in (q, k, v)), **kw)
    tq, tk, tv = (torch.tensor(t).to(getattr(torch, dtype)).requires_grad_()
                  for t in (q, k, v))
    got = chunked_attention(tq, tk, tv, **kw)
    assert got.dtype == tq.dtype and got.shape == (2, S, 3, 16)
    np.testing.assert_allclose(_np(got.detach()), _np(want), rtol=tol,
                               atol=tol)
    if dtype == "float32":
        w = r.standard_normal(got.shape).astype(np.float32)
        jg = jax.grad(lambda a, b, c: jnp.sum(jax_attn(a, b, c, **kw) * w),
                      argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
        (got * torch.tensor(w)).sum().backward()
        for t, g in zip((tq, tk, tv), jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------------ SSD
@pytest.mark.parametrize("S,chunk,ng", [(32, 8, 1), (24, 8, 2), (6, 16, 1)])
def test_ssd_chunked_matches_jax_from_a_state(S, chunk, ng):
    """``ssd_chunked`` from a nonzero state0, grouped B/C, a sequence
    shorter than the chunk: y, the final state and the gradients in every
    input against ``repro.models.ssm.ssd_chunked``, fp32 (measured: values
    <= 7.7e-6 off, gradients <= 3.9e-5, on values up to tens)."""
    from repro.models.ssm import ssd_chunked as jax_ssd
    from repro_torch.models.ssm import ssd_chunked
    r = np.random.default_rng(S + ng)
    B, nh, hp, ds = 2, 4, 8, 16
    xh = r.standard_normal((B, S, nh, hp)).astype(np.float32)
    dt = (0.1 + r.random((B, S, nh))).astype(np.float32)
    A = -(0.5 + r.random(nh)).astype(np.float32)
    Bg, Cg = (r.standard_normal((B, S, ng, ds)).astype(np.float32)
              for _ in range(2))
    s0 = r.standard_normal((B, nh, hp, ds)).astype(np.float32)
    wy = r.standard_normal(xh.shape).astype(np.float32)
    ws = r.standard_normal(s0.shape).astype(np.float32)
    args = (xh, dt, A, Bg, Cg, s0)

    def jloss(x, d, a, b, c, s):
        y, st = jax_ssd(x, d, a, b, c, chunk, s)
        return jnp.sum(y * wy) + jnp.sum(st * ws), (y, st)

    (_, (jy, js)), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in args))
    targs = [torch.tensor(a).requires_grad_() for a in args]
    y, st = ssd_chunked(*targs[:5], chunk, targs[5])
    ((y * torch.tensor(wy)).sum() + (st * torch.tensor(ws)).sum()).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.detach().numpy(), np.asarray(js),
                               rtol=1e-5, atol=1e-5)
    for t, g in zip(targs, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------------------ MoE
@pytest.mark.parametrize("arch", ["arctic-480b", "kimi-k2-1t-a32b"])
def test_moe_train_matches_jax_with_drops(arch):
    """The MoE training route of an arctic and a kimi-k2 smoke layer at
    the default capacity, where assignments drop, fp32: the output equals
    the serving route's bit for bit, and the output and its gradients in
    x, the gates and the three expert weights match the reference's
    (measured: output <= 2.4e-7 off, gradients <= 1.9e-6)."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax.tree.map(lambda a: a[0], JaxLM(cfg).init(
        jax.random.key(1))[0]["blocks"][f"pos{cfg.pattern_period - 1}"]["moe"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    ids, wts, _ = jmoe.route(jp, cfg, jnp.asarray(x))
    tids = torch.tensor(np.asarray(ids)).long()
    _, _, kept = tmoe.dispatch(tids, cfg)
    assert 0 < int((~kept).sum()) < kept.numel()      # overflow present
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    names = ("w_in", "w_gate", "w_out")

    def jax_loss(xx, ww, wi, wg, wo):
        p = dict(jp, w_in=wi, w_gate=wg, w_out=wo)
        return jnp.sum(jmoe.moe_apply(p, cfg, xx, ids, ww) * w)

    jargs = (jnp.asarray(x), wts) + tuple(jp[n] for n in names)
    want = jmoe.moe_apply(jp, cfg, jnp.asarray(x), ids, wts)
    jgrads = jax.grad(jax_loss, argnums=tuple(range(5)))(*jargs)
    targs = [torch.tensor(np.asarray(a)).requires_grad_() for a in jargs]
    got = tmoe.moe_train(dict(tp, **dict(zip(names, targs[2:]))), cfg,
                         targs[0], tids, targs[1])
    with torch.no_grad():
        served = tmoe.moe_apply(tp, cfg, targs[0], tids, targs[1])
    assert torch.equal(got.detach(), served)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    (got * torch.from_numpy(w)).sum().backward()
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4,
                                   atol=1e-5)


# --------------------------------------------------------- loss + grads
@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_jax_fp32(arch):
    jrun, trun = _runs(arch)
    jlm = JaxLM(jrun.model)
    jparams = jlm.init(jax.random.key(0))[0]
    rt = jlm.runtime(jrun.parallel)
    batch = jax_batches(jrun)(0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.loss(p, rt, b), has_aux=True))(jparams, batch)

    params = params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    for _, t in tree_leaves(params):
        t.requires_grad_(True)
    lm = LM(trun.model, params, device="cpu")
    loss, met = lm.loss(synthetic_batches(trun, "cpu")(0), trun.parallel)
    loss.backward()

    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    for k in ("ce", "moe_lb_loss", "moe_z_loss", "z"):
        assert float(met[k]) == pytest.approx(float(jmet[k]), rel=1e-5,
                                              abs=1e-6), k
    ref = dict(tree_leaves(jax.tree.map(np.asarray, jgrads)))
    assert sorted(ref) == sorted(p for p, _ in tree_leaves(params))
    for path, t in tree_leaves(params):
        r = ref[path]
        atol = (1e-4 if arch in DEEP_SSM else 1e-6) * max(1.0,
                                                          np.abs(r).max())
        np.testing.assert_allclose(t.grad.numpy(), r, rtol=1e-4, atol=atol,
                                   err_msg=path)


# ---------------------------------------------------------------- AdamW
def test_adamw_apply_matches_jax_on_identical_grads():
    """Three updates of fp32 and bf16 leaves with bf16 moments, from one
    state and the same grads on both sides, past the clip (grad norm
    above 1) and through warmup."""
    r = np.random.default_rng(0)
    shapes = {"a": (3, 5), "b": {"c": (7,), "w": (2, 4, 6)}}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict)
                else (r.standard_normal(v) * scale).astype(np.float32)
                for k, v in tree.items()}

    p32 = draw(shapes, 1.0)
    jparams = {"a": jnp.asarray(p32["a"]),
               "b": {"c": jnp.asarray(p32["b"]["c"], jnp.bfloat16),
                     "w": jnp.asarray(p32["b"]["w"])}}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, weight_decay=0.1,
              grad_clip=1.0)
    jopt, topt = JAdamW(**kw), AdamW(**kw)
    jstate = jopt.init(jparams)
    tstate = state_from_jax(jax.tree.map(np.asarray, jstate), "cpu")
    for i in range(3):
        g = draw(shapes, 0.5 + i)
        jg = jax.tree.map(jnp.asarray, g)
        jstate, jm = jopt.apply(jstate, jg)
        tstate, tm = topt.apply(tstate, params_from_jax(g, "cpu"))
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert tstate.step == int(jstate.step) == 3
    for part in ("params", "m", "v"):
        ref = dict(tree_leaves(jax.tree.map(np.asarray,
                                            getattr(jstate, part))))
        for path, t in tree_leaves(getattr(tstate, part)):
            a, b = _np(t), np.asarray(ref[path], np.float32)
            assert t.dtype == {"float32": torch.float32,
                               "bfloat16": torch.bfloat16}[str(
                                   ref[path].dtype)], path
            if part == "params":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=0,
                                           err_msg=path)
            else:  # one bf16 ulp: 2^-7 of the value's binade
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(b), 1e-30))) - 7)
                assert (np.abs(a - b) <= ulp).all(), (part, path)


# --------------------------------------------------------- checkpoints
@pytest.mark.parametrize("arch", ["qwen2-7b", "mamba2-1.3b"])
def test_port_resumes_a_jax_checkpoint(arch, tmp_path):
    """JAX's loop writes a step-4 checkpoint; the port's loop resumes from
    that directory and its losses for steps 4-11 follow JAX's
    uninterrupted run."""
    jrun, trun = _runs(arch, total_steps=12)
    ref = jax_train_loop(jrun, ckpt_dir=str(tmp_path / "jax"), num_steps=12,
                         ckpt_every=4)
    resume = tmp_path / "resume"
    resume.mkdir()
    shutil.copytree(tmp_path / "jax" / "step_4", resume / "step_4")
    rep = train_loop(trun, ckpt_dir=str(resume), num_steps=12, ckpt_every=4,
                     device="cpu")
    assert rep.steps_run == 8 and rep.restarts == 0
    np.testing.assert_allclose(rep.losses, ref.losses[4:], rtol=1e-4)


def test_jax_restores_a_port_checkpoint(tmp_path):
    """The port's loop writes a checkpoint; ``repro.train.checkpoint``
    reads it into a JAX TrainState leaf for leaf and bit for bit (wk and
    wv share a shape: only the sorted leaf order tells them apart)."""
    jrun, trun = _runs("qwen2-7b", dtype="bfloat16", total_steps=3)
    train_loop(trun, ckpt_dir=str(tmp_path), num_steps=3, ckpt_every=0,
               device="cpu")
    jlm = JaxLM(jrun.model)
    params_abs, _ = jlm.init(None, abstract=True)
    state_abs = JAdamW(moment_dtype=jrun.moment_dtype).init_abstract(
        params_abs)
    jstate, step = jckpt.restore(str(tmp_path), state_abs)
    assert step == 3 and int(jstate.step) == 3
    tstate, _ = ckpt.restore(str(tmp_path), state_from_jax(
        jax.tree.map(np.asarray, jstate), "cpu"))
    for part in ("params", "m", "v"):
        ref = dict(tree_leaves(jax.tree.map(np.asarray,
                                            getattr(jstate, part))))
        for path, t in sorted_tree_leaves(getattr(tstate, part)):
            r = ref[path]
            assert str(r.dtype) == str(t.dtype).removeprefix("torch.")
            assert np.array_equal(_np(t).view(np.uint32)
                                  if t.dtype == torch.float32
                                  else t.view(torch.int16).numpy(),
                                  r.view(np.uint32) if r.dtype == np.float32
                                  else r.view(np.int16)), (part, path)
