"""The port's training job on its own, on the CPU: AdamW, checkpoints and
their msgpack manifest, the training route (no kernel, a gradient for
every leaf, remat), microbatching and the preemptible loop.

The counterparts of ``tests/test_train.py``, with the same thresholds;
``tests/test_torch_train_parity.py`` holds the same pieces against the JAX
package.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bridge import init_params  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ParallelConfig, RunConfig, ShapeConfig)
from repro_torch.data.synthetic import synthetic_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.lm import LM, tree_leaves, tree_map  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loop import Preemption, train_loop  # noqa: E402
from repro_torch.train.optimizer import AdamW, TrainState  # noqa: E402
from repro_torch.train.train_step import build_train_step  # noqa: E402

SMOKE_SHAPE = ShapeConfig("smoke", "train", 32, 2)
SMOKE_PARALLEL = ParallelConfig(attn_q_chunk=16, attn_kv_chunk=16)


def smoke_run(arch, **over) -> RunConfig:
    """The port's ``tests/conftest.py::smoke_runconfig``."""
    cfg = dataclasses.replace(tconfigs.get_smoke_config(arch), n_patches=8)
    parallel = over.pop("parallel", SMOKE_PARALLEL)
    return RunConfig(model=cfg, shape=over.pop("shape", SMOKE_SHAPE),
                     parallel=parallel,
                     total_steps=over.pop("total_steps", 20),
                     warmup_steps=2, **over)


def _lm(rcfg, seed=0):
    params = init_params(rcfg.model, torch.Generator().manual_seed(seed),
                         "cpu")
    return LM(rcfg.model, params, device="cpu")


# --------------------------------------------------------------- optimizer
def test_adamw_matches_reference_step():
    opt = AdamW(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                grad_clip=1e9, warmup_steps=0, total_steps=10**9,
                min_lr_frac=1.0, moment_dtype="float32")
    p0 = np.asarray([1.0, -2.0, 3.0], np.float32)
    state = opt.init({"w": torch.tensor(p0)})
    state, metrics = opt.apply(state, {"w": torch.tensor([0.1, -0.2, 0.3])})
    # bias-corrected adam, step 1
    m = 0.1 * np.asarray([0.1, -0.2, 0.3])
    v = 0.05 * np.asarray([0.1, -0.2, 0.3]) ** 2
    u = (m / (1 - 0.9)) / (np.sqrt(v / (1 - 0.95)) + 1e-8)
    np.testing.assert_allclose(state.params["w"].numpy(), p0 - 1e-2 * u,
                               rtol=1e-5)
    assert state.step == 1
    assert float(metrics["lr"]) == pytest.approx(1e-2)


def test_adamw_updates_in_place_with_weight_decay_and_bf16_moments():
    """The params dict keeps its tensors (the LM's views see the update);
    moments are stored in bf16; decoupled weight decay moves a zero-grad
    weight toward 0."""
    opt = AdamW(lr=0.5, weight_decay=0.1, warmup_steps=0)
    w = torch.ones(4, dtype=torch.bfloat16)
    state = opt.init({"w": w})
    assert state.m["w"].dtype == state.v["w"].dtype == torch.bfloat16
    state, _ = opt.apply(state, {"w": torch.zeros(4)})
    assert state.params["w"] is w
    assert (w < 1).all() and (w > 0.9).all()


def test_adamw_updates_large_leaves_slice_by_slice(monkeypatch):
    """A leaf past SLICE_LIMIT_BYTES is updated along its leading axis:
    the same values as one pass."""
    from repro_torch.train import optimizer
    r = np.random.default_rng(0)
    p, g = (r.standard_normal((3, 4, 5)).astype(np.float32)
            for _ in range(2))
    outs = []
    for limit in (2**30, 16):
        monkeypatch.setattr(optimizer, "SLICE_LIMIT_BYTES", limit)
        state = AdamW(warmup_steps=0).init({"w": torch.tensor(p)})
        for _ in range(2):
            state, met = AdamW(warmup_steps=0).apply(
                state, {"w": torch.tensor(g)})
        outs.append((state.params["w"], state.m["w"], met["grad_norm"]))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_grad_clip_caps_global_norm():
    opt = AdamW(grad_clip=1.0, warmup_steps=0, moment_dtype="float32")
    state = opt.init({"w": torch.zeros(3)})
    _, metrics = opt.apply(state, {"w": torch.tensor([30.0, 40.0, 0.0])})
    assert float(metrics["grad_norm"]) == pytest.approx(50.0, rel=1e-5)


def test_schedule_warmup_and_decay():
    opt = AdamW(lr=1.0, warmup_steps=10, total_steps=110, min_lr_frac=0.1)
    assert float(opt.schedule(0)) == 0.0
    assert float(opt.schedule(5)) == pytest.approx(0.5)
    assert float(opt.schedule(10)) == pytest.approx(1.0)
    assert float(opt.schedule(60)) == pytest.approx(0.55)
    assert float(opt.schedule(110)) == pytest.approx(0.1)
    assert opt.schedule(3).dtype == torch.float32


# -------------------------------------------------------------- checkpoint
def _state(step=3):
    params = {"a": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
              "b": {"c": torch.tensor([1.5]), "d": torch.zeros(2, 2)}}
    state = AdamW().init(params)
    state.step = step
    state.m["b"]["c"].fill_(0.25)
    return state


def test_checkpoint_roundtrip_and_gc(tmp_path):
    d = str(tmp_path)
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, _state(step), keep=2)
    assert ckpt.latest_step(d) == 40
    restored, step = ckpt.restore(d, _state(0))
    assert step == 40 and restored.step == 40
    want = _state(40)
    for part in ("params", "m", "v"):
        got = dict(tree_leaves(getattr(restored, part)))
        for path, t in tree_leaves(getattr(want, part)):
            assert got[path].dtype == t.dtype and torch.equal(got[path], t)
    # gc kept only 2
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_30",
                                                          "step_40"]


def test_checkpoint_leaves_follow_jax_flatten_order(tmp_path):
    """Leaf i is the i-th of jax.tree's flattening: the step, then params,
    m and v with each dict's keys sorted (wk before wq before wv)."""
    params = {"wq": torch.full((2,), 1.0), "wk": torch.full((2,), 2.0),
              "wv": torch.full((2,), 3.0)}
    state = AdamW(moment_dtype="float32").init(params)
    state.step = 1
    d = ckpt.save(str(tmp_path), 1, state)
    leaves = [np.load(f"{d}/leaf_{i:05d}.npy") for i in range(10)]
    assert int(leaves[0]) == 1 and leaves[0].dtype == np.int32
    assert [float(x[0]) for x in leaves[1:4]] == [2.0, 1.0, 3.0]
    with open(f"{d}/manifest.msgpack", "rb") as f:
        manifest = msgpack.unpackb(f.read())
    assert manifest["n_leaves"] == 10 and manifest["step"] == 1
    assert manifest["dtypes"] == ["int32"] + ["float32"] * 9


def test_checkpoint_wrong_structure_rejected(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, _state())
    extra = _state()
    extra.params["e"] = torch.zeros(1)
    extra.m["e"] = extra.v["e"] = torch.zeros(1)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(d, extra)
    shape = _state()
    shape.params["b"]["d"] = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(d, shape)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), _state())


def test_manifest_bytes_equal_msgpack(tmp_path):
    """The port's packer writes msgpack.packb's bytes for a real manifest
    and for each size class of the subset (fix, 8/16-bit lengths, ints of
    every width and sign), and reads what msgpack.packb wrote."""
    d = ckpt.save(str(tmp_path), 7, _state())
    with open(f"{d}/manifest.msgpack", "rb") as f:
        data = f.read()
    manifest = msgpack.unpackb(data)
    assert manifest["n_leaves"] == 10
    assert ckpt.packb(manifest) == data == msgpack.packb(manifest)
    cases = [
        manifest,
        {"s": "x" * 31, "t": "y" * 32, "u": "z" * 300, "e": ""},
        {"l": [f"leaf{i}" for i in range(16)], "m": ["a"] * 70000},
        {str(i): i for i in range(20)},
        {"ints": [0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
                  2**64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                  -2**31, -2**31 - 1, -2**63]},
    ]
    for obj in cases:
        b = msgpack.packb(obj)
        assert ckpt.packb(obj) == b
        assert ckpt.unpackb(b) == obj
    for bad in ({"f": 1.5}, {"b": True}, {"n": None}, {"x": b"raw"}):
        with pytest.raises(TypeError):
            ckpt.packb(bad)
    with pytest.raises(ValueError):
        ckpt.unpackb(msgpack.packb({"f": 1.5}))


# ----------------------------------------------------------- the route
TRAIN_ARCHS = ["qwen2-7b", "mamba2-1.3b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_training_route_reaches_no_kernel(arch, monkeypatch):
    """loss and backward of a dense, an SSM and a hybrid MoE smoke config
    with every ops function replaced by one that raises, and with grad
    mode on, the kernel wrappers raise rather than run."""
    def refuse(*args, **kwargs):
        raise AssertionError("the training route reached kernels.ops")

    for name in ("attention", "decode", "paged_decode", "gmm", "ssd"):
        monkeypatch.setattr(ops, name, refuse)
    rcfg = smoke_run(arch)
    lm = _lm(rcfg)
    for _, t in tree_leaves(lm.params):
        t.requires_grad_(True)
    loss, _ = lm.loss(synthetic_batches(rcfg, "cpu")(0), rcfg.parallel)
    loss.backward()
    assert torch.isfinite(loss)


def test_kernel_wrappers_refuse_autograd():
    """Forward-only kernels raise when autograd would record them; no
    fallback to the plain version."""
    q = torch.zeros(2, 4, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        flash_attention(q, q, q)
    with pytest.raises(RuntimeError, match="forward-only"):
        moe_gmm(torch.zeros(2, 3, 16), torch.zeros(2, 16, 8,
                                                  requires_grad=True))
    x, bc = torch.zeros(1, 16, 2, 16), torch.zeros(1, 16, 1, 16)
    with pytest.raises(RuntimeError, match="forward-only"):
        ssd_scan(x, torch.zeros(1, 16, 2), torch.zeros(2, requires_grad=True),
                 bc, bc, chunk=16)
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, q, q)


@pytest.mark.parametrize("arch", ["qwen2-7b", "musicgen-large",
                                  "internvl2-76b", "jamba-1.5-large-398b"])
def test_every_leaf_gets_a_gradient(arch):
    """Two or more pattern repeats: every leaf, every layer slice of a
    stacked leaf, gets a gradient that is not None and not all zero."""
    rcfg = smoke_run(arch)
    assert rcfg.model.n_layers // rcfg.model.pattern_period >= 2
    lm = _lm(rcfg)
    for _, t in tree_leaves(lm.params):
        t.requires_grad_(True)
    loss, _ = lm.loss(synthetic_batches(rcfg, "cpu")(0), rcfg.parallel)
    loss.backward()
    for path, t in tree_leaves(lm.params):
        assert t.grad is not None, path
        assert torch.isfinite(t.grad).all(), path
        slices = t.grad if path.startswith("blocks/") else t.grad[None]
        for r, g in enumerate(slices):
            assert g.abs().sum() > 0, (path, r)


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-1.5-large-398b"])
def test_remat_does_not_change_loss_or_grads(arch):
    """remat "block" (each pattern repeat recomputed in the backward) and
    "none" give the same loss and gradients, bit for bit."""
    outs = []
    for remat in ("block", "none"):
        rcfg = smoke_run(arch, parallel=dataclasses.replace(
            SMOKE_PARALLEL, remat=remat))
        lm = _lm(rcfg)
        for _, t in tree_leaves(lm.params):
            t.requires_grad_(True)
        loss, _ = lm.loss(synthetic_batches(rcfg, "cpu")(0), rcfg.parallel)
        loss.backward()
        outs.append((loss.detach(), [t.grad for _, t in
                                     tree_leaves(lm.params)]))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)


def test_serving_sees_the_trained_weights():
    """A train step updates the leaves in place: the LM's serving views
    see it, so its prefill equals a fresh LM's on the updated weights."""
    rcfg = smoke_run("qwen2-7b")
    lm = _lm(rcfg)
    step_fn, opt = build_train_step(lm, rcfg)
    toks = {"tokens": torch.arange(1, 9, dtype=torch.int32)[None]}
    before, _ = lm.prefill(toks)
    state, _ = step_fn(opt.init(lm.params), synthetic_batches(rcfg,
                                                              "cpu")(0))
    after, _ = lm.prefill(toks)
    fresh = LM(rcfg.model, tree_map(lambda t: t.detach().clone(),
                                    lm.params), device="cpu")
    assert not torch.equal(before, after)
    assert torch.equal(after, fresh.prefill(toks)[0])


def test_train_step_refuses_pod_compression_and_foreign_state():
    """Pod compression without a pod axis is the identity, as in the
    reference (which wraps only a mesh whose pod axis holds 2 or more):
    the same loss and params bit for bit. A state over other params is
    refused."""
    from repro_torch.parallel.compression import build_pod_compressed_grad_fn

    def fn(batch):
        return batch
    assert build_pod_compressed_grad_fn(fn, None) is fn
    outs = []
    for compress in (False, True):
        rcfg = smoke_run("qwen2-7b", parallel=dataclasses.replace(
            SMOKE_PARALLEL, grad_compress_pod=compress))
        lm = _lm(rcfg)
        step_fn, opt = build_train_step(lm, rcfg)
        state, met = step_fn(opt.init(lm.params),
                             synthetic_batches(rcfg, "cpu")(0))
        outs.append((float(met["loss"]), dict(tree_leaves(state.params))))
    assert outs[0][0] == outs[1][0]
    for path, t in outs[0][1].items():
        assert torch.equal(t, outs[1][1][path]), path
    rcfg = smoke_run("qwen2-7b")
    step_fn, opt = build_train_step(lm, rcfg)
    other = tree_map(lambda t: t.detach().clone(), lm.params)
    with pytest.raises(ValueError, match="not the LM's"):
        step_fn(opt.init(other), synthetic_batches(rcfg, "cpu")(0))


def test_microbatch_accumulation_matches_full_batch():
    """grads(microbatched) == grads(full batch) up to accumulation dtype
    (``tests/test_train.py``'s thresholds)."""
    shape = ShapeConfig("mb", "train", 32, 8)
    rcfg1 = smoke_run("granite-3-8b", shape=shape)
    rcfg2 = dataclasses.replace(rcfg1, parallel=dataclasses.replace(
        rcfg1.parallel, microbatches=4))
    batch = synthetic_batches(rcfg1, "cpu")(0)
    outs = []
    for rcfg in (rcfg1, rcfg2):
        lm = _lm(rcfg)
        step_fn, opt = build_train_step(lm, rcfg)
        state, metrics = step_fn(opt.init(lm.params), batch)
        outs.append((float(metrics["loss"]), state.params))
    assert outs[0][0] == pytest.approx(outs[1][0], rel=2e-2)
    flat1, flat2 = (torch.cat([t.detach().float().ravel()
                               for _, t in tree_leaves(p)])
                    for _, p in outs)
    # parameter updates should be nearly identical
    assert float((flat1 - flat2).abs().max()) < 5e-2


# ---------------------------------------------------------------- the loop
def test_preempt_resume_losses_bit_identical(tmp_path):
    """A run interrupted by ``Preemption`` and resumed from ``latest_step``
    gives step-for-step bit-identical losses to an uninterrupted run."""
    rcfg = smoke_run("qwen2-7b", total_steps=12)
    ref = train_loop(rcfg, ckpt_dir=str(tmp_path / "ref"), num_steps=12,
                     ckpt_every=4, device="cpu")
    rep = train_loop(rcfg, ckpt_dir=str(tmp_path / "pre"), num_steps=12,
                     ckpt_every=4, fail_at={6: True}, device="cpu")
    assert rep.restarts == 1
    # attempt 1 ran steps 0..5 and died before step 6; the resume
    # restored the step-4 checkpoint and replayed 4..11
    assert len(rep.losses) == 6 + 8
    assert rep.losses[:6] == ref.losses[:6]
    assert rep.losses[6:] == ref.losses[4:]
    assert rep.final_loss == ref.final_loss


def test_resize_checkpoints_and_reenters(tmp_path):
    """resize_at {step: None} checkpoints and re-enters on the same card,
    bit-identical to an uninterrupted run; a mesh given to a loop with no
    world raises before step 0. The loop resizes to other meshes of its
    world in ``tests/test_torch_resize.py``."""
    rcfg = smoke_run("qwen2-7b", total_steps=6)
    ref = train_loop(rcfg, ckpt_dir=str(tmp_path / "ref"), num_steps=6,
                     ckpt_every=0, device="cpu")
    rep = train_loop(rcfg, ckpt_dir=str(tmp_path / "rs"), num_steps=6,
                     ckpt_every=0, resize_at={3: None}, device="cpu")
    assert rep.resizes == 1 and rep.losses == ref.losses
    other = SimpleNamespace(axis_names=("data", "model"),
                            shape={"data": 2, "model": 1})
    with pytest.raises(ValueError, match="step 3: a mesh given to a loop "
                       "with no world"):
        train_loop(rcfg, ckpt_dir=str(tmp_path / "x"), num_steps=6,
                   resize_at={3: other}, device="cpu")
    assert not (tmp_path / "x").exists()


def test_loop_gives_up_after_max_restarts(tmp_path):
    rcfg = smoke_run("qwen2-7b", total_steps=4)
    with pytest.raises(Preemption):
        train_loop(rcfg, ckpt_dir=str(tmp_path), num_steps=4,
                   ckpt_every=100, fail_at={1: True}, max_restarts=0,
                   device="cpu")


def test_loss_decreases_over_training(tmp_path):
    rcfg = smoke_run("mamba2-1.3b", total_steps=40, learning_rate=3e-3)
    rep = train_loop(rcfg, ckpt_dir=str(tmp_path), num_steps=40,
                     ckpt_every=0, device="cpu")
    first = np.mean(rep.losses[:5])
    last = np.mean(rep.losses[-5:])
    assert last < first - 0.1, (first, last)


def test_launch_train_on_the_cpu(tmp_path, capsys):
    report = launch_train.main(["--arch", "musicgen-large", "--device", "cpu",
                                "--steps", "3", "--ckpt-every", "2",
                                "--ckpt-dir", str(tmp_path)])
    assert report.steps_run == 3 and len(report.losses) == 3
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert "steps=3 restarts=0" in capsys.readouterr().out


def test_train_state_is_a_dataclass_of_step_and_trees():
    state = AdamW().init({"w": torch.zeros(2)})
    assert isinstance(state, TrainState) and state.step == 0
    assert set(dataclasses.asdict(state)) == {"step", "params", "m", "v"}
