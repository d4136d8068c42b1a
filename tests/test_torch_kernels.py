"""The port's plain kernel versions vs the JAX package's Pallas kernels
(interpret mode, as tests/test_kernels.py runs them) and its jnp oracles:
the three attention kernels, ``moe_gmm`` and ``ssd_scan``.

On the CPU, ``repro_torch.kernels.ops`` sends every call to the plain
PyTorch version; these sweeps pin that version to the reference on the
shapes the JAX package's own kernel tests use. The CUDA kernels are held
against the same plain versions on the card (tests/test_torch_cuda.py and
chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as pallas_decode)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as pallas_flash)
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm  # noqa: E402
from repro.kernels.paged_decode_attention import (  # noqa: E402
    paged_decode_attention as pallas_paged)
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref, paged_decode_attention_ref)

# fp32: both sides sum in fp32 in another order (tests/test_kernels.py:24);
# bf16: the outputs round to bf16, ~1e-2 per ulp at |x| ~ 2
# (tests/test_kernels.py:25)
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=5e-2, atol=5e-2)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype):
    """The same numpy values as a jax array and a CPU tensor of ``dtype``
    (both round fp32 -> bf16 to nearest even, so the bits agree)."""
    jdt, tdt = DT[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "BH,S,Sk,hd,bq,bk,causal",
    [(2, 128, 128, 64, 32, 32, True),
     (3, 96, 96, 32, 32, 64, True),
     (2, 64, 192, 64, 64, 64, False),    # cross-attention shape
     (1, 200, 200, 16, 64, 64, True),    # ragged (padding path)
     (4, 32, 32, 128, 32, 32, True)])
def test_flash_plain_matches_pallas(BH, S, Sk, hd, bq, bk, causal, dtype):
    r = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(r.standard_normal(s).astype(np.float32), dtype)
        for s in ((BH, S, hd), (BH, Sk, hd), (BH, Sk, hd)))
    out = ops.attention(tq, tk, tv, causal=causal)
    assert out.dtype == tq.dtype and out.shape == (BH, S, hd)
    pallas = pallas_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                          interpret=True)
    oracle = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(oracle), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,H,KVH,hd,S,bs",
    [(2, 8, 2, 64, 256, 64),
     (3, 4, 4, 32, 100, 32),     # MHA + ragged
     (1, 16, 2, 16, 512, 128),
     (2, 32, 8, 64, 64, 64)])
def test_decode_plain_matches_pallas(B, H, KVH, hd, S, bs, dtype):
    r = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _both(r.standard_normal(s).astype(np.float32), dtype)
        for s in ((B, H, hd), (B, S, KVH, hd), (B, S, KVH, hd)))
    lens = r.integers(1, S + 1, (B,)).astype(np.int32)
    out = ops.decode(tq, tk, tv, torch.from_numpy(lens), block_s=bs)
    pallas = pallas_decode(jq, jk, jv, jnp.asarray(lens), block_s=bs,
                           interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    np.testing.assert_allclose(_f32(out), _f32(pallas), **TOL[dtype])
    np.testing.assert_allclose(_f32(out), _f32(oracle), **TOL[dtype])


def _paged_views(cache: np.ndarray, page_size: int, shuffle_seed=None):
    """Lay a contiguous (B, S, KVH, hd) cache out as a page pool + table,
    page 0 a NaN-poisoned null page (tests/test_paged.py:_paged_views)."""
    B, S, KVH, hd = cache.shape
    n_pt = S // page_size
    perm = np.arange(B * n_pt)
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(perm)
    pool = np.full((1 + B * n_pt, page_size, KVH, hd), np.nan, cache.dtype)
    table = np.zeros((B, n_pt), np.int32)
    for b in range(B):
        for j in range(n_pt):
            p = 1 + int(perm[b * n_pt + j])
            pool[p] = cache[b, j * page_size:(j + 1) * page_size]
            table[b, j] = p
    return pool, table


@pytest.mark.parametrize("B,H,KVH,hd,S,ps",
                         [(4, 4, 2, 16, 64, 16),
                          (3, 8, 8, 32, 96, 32),
                          (2, 4, 1, 64, 64, 16)])
def test_paged_plain_bitwise_matches_contiguous(B, H, KVH, hd, S, ps):
    """Paged == contiguous bit for bit for any physical page placement,
    and both agree with the Pallas paged kernel (tests/test_paged.py:161)."""
    r = np.random.default_rng(7)
    q = r.standard_normal((B, H, hd)).astype(np.float32)
    k = r.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = r.standard_normal((B, S, KVH, hd)).astype(np.float32)
    lens = r.integers(1, S + 1, (B,)).astype(np.int32)
    k_pool, table = _paged_views(k, ps, shuffle_seed=3)
    v_pool, _ = _paged_views(v, ps, shuffle_seed=3)
    t = torch.from_numpy
    contiguous = ops.decode(t(q), t(k), t(v), t(lens), block_s=ps)
    paged = ops.paged_decode(t(q), t(k_pool), t(v_pool), t(table), t(lens))
    assert torch.equal(paged, contiguous)
    pallas = pallas_paged(jnp.asarray(q), jnp.asarray(k_pool),
                          jnp.asarray(v_pool), jnp.asarray(table),
                          jnp.asarray(lens), interpret=True)
    np.testing.assert_allclose(paged.numpy(), np.asarray(pallas),
                               **TOL["float32"])


def test_zero_length_rows_are_exact_zero():
    """A ``length == 0`` row gives exact zeros in both plain versions and
    in the Pallas kernels; live rows beside it are unperturbed
    (tests/test_paged.py:189)."""
    B, H, KVH, hd, S, ps = 4, 4, 2, 16, 64, 16
    r = np.random.default_rng(11)
    q = r.standard_normal((B, H, hd)).astype(np.float32)
    k = r.standard_normal((B, S, KVH, hd)).astype(np.float32)
    v = r.standard_normal((B, S, KVH, hd)).astype(np.float32)
    lens = np.array([0, 17, 0, S], np.int32)
    k_pool, table = _paged_views(k, ps)
    v_pool, _ = _paged_views(v, ps)
    t = torch.from_numpy
    contiguous = decode_attention_ref(t(q), t(k), t(v), t(lens)).numpy()
    paged = paged_decode_attention_ref(t(q), t(k_pool), t(v_pool), t(table),
                                       t(lens)).numpy()
    pallas = np.asarray(pallas_paged(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool),
        jnp.asarray(table), jnp.asarray(lens), interpret=True))
    for out in (contiguous, paged, pallas):
        assert np.all(out[[0, 2]] == 0.0)
        assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(paged, contiguous)
    np.testing.assert_allclose(paged[[1, 3]], pallas[[1, 3]],
                               **TOL["float32"])


# tests/test_kernels.py:81-82: the SSD sums reorder in fp32 (2e-4); in
# bf16 the inputs round before the fp32 arithmetic (8e-2)
SSD_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),
           "bfloat16": dict(rtol=8e-2, atol=8e-2)}
# tests/test_kernels.py:98-99: fp32 sums reorder (1e-4); bf16 outputs
# round to bf16 at |out| up to ~10 (atol 4e-1)
GMM_TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
           "bfloat16": dict(rtol=8e-2, atol=4e-1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "B,S,nh,hp,ng,ds,chunk",
    [(2, 64, 4, 16, 1, 32, 16),
     (1, 128, 8, 32, 2, 64, 32),
     (2, 96, 2, 8, 2, 16, 48),
     (1, 64, 4, 64, 4, 128, 64)])
def test_ssd_plain_matches_pallas(B, S, nh, hp, ng, ds, chunk, dtype):
    """The chunked plain version against the Pallas kernel and the JAX
    package's token-by-token oracle: y and the final state."""
    r = np.random.default_rng(12)
    jx, tx = _both((r.standard_normal((B, S, nh, hp)) * 0.5).astype(
        np.float32), dtype)
    dt = r.uniform(0.01, 0.3, (B, S, nh)).astype(np.float32)
    A = -r.uniform(0.5, 2.0, (nh,)).astype(np.float32)
    (jB, tB), (jC, tC) = (
        _both((r.standard_normal((B, S, ng, ds)) * 0.3).astype(np.float32),
              dtype) for _ in range(2))
    y, state = ops.ssd(tx, torch.from_numpy(dt), torch.from_numpy(A), tB, tC,
                       chunk=chunk)
    assert y.dtype == state.dtype == torch.float32
    assert y.shape == (B, S, nh, hp) and state.shape == (B, nh, hp, ds)
    pallas = pallas_ssd(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                        chunk=chunk, interpret=True)
    oracle = jref.ssd_scan_ref(jx, jnp.asarray(dt), jnp.asarray(A), jB, jC,
                               chunk=chunk)
    for want in (pallas, oracle):
        np.testing.assert_allclose(y.numpy(), np.asarray(want[0]),
                                   **SSD_TOL[dtype])
        np.testing.assert_allclose(state.numpy(), np.asarray(want[1]),
                                   **SSD_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "E,C,d,f,bc,bf,bd",
    [(4, 32, 64, 128, 16, 64, 32),
     (2, 16, 32, 32, 16, 32, 32),
     (8, 64, 128, 64, 32, 32, 64),
     (1, 128, 256, 128, 128, 128, 128)])
def test_gmm_plain_matches_pallas(E, C, d, f, bc, bf, bd, dtype):
    r = np.random.default_rng(13)
    jx, tx = _both(r.standard_normal((E, C, d)).astype(np.float32), dtype)
    jw, tw = _both((r.standard_normal((E, d, f)) * 0.1).astype(np.float32),
                   dtype)
    out = ops.gmm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == (E, C, f)
    pallas = pallas_gmm(jx, jw, block_c=bc, block_f=bf, block_d=bd,
                        interpret=True)
    for want in (pallas, jref.moe_gmm_ref(jx, jw)):
        np.testing.assert_allclose(_f32(out), _f32(want), **GMM_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("counts", [[0, 0, 0, 0], [3, 0, 16, 9],
                                    [16, 16, 16, 16], [0, 16, 0, 0]],
                         ids=["empty", "partial", "full", "one-full"])
def test_gmm_plain_with_counts_matches_pallas(counts, dtype):
    """The counts contract against the Pallas kernel on an x whose rows at
    or past the counts are zeroed (what the MoE layer hands it): the port
    gets the raw x, non-zero past the counts, and must give the same
    output, with those rows exact zero."""
    E, C, d, f = 4, 16, 32, 64
    r = np.random.default_rng(17)
    x = r.standard_normal((E, C, d)).astype(np.float32)
    filled = np.arange(C)[None, :] < np.asarray(counts)[:, None]
    jx, _ = _both(np.where(filled[..., None], x, 0).astype(np.float32), dtype)
    _, tx = _both(x, dtype)
    jw, tw = _both((r.standard_normal((E, d, f)) * 0.1).astype(np.float32),
                   dtype)
    cnt = torch.tensor(counts, dtype=torch.int32)
    out = ops.gmm(tx, tw, cnt)
    assert out.dtype == tx.dtype and out.shape == (E, C, f)
    assert bool((out[torch.from_numpy(~filled)] == 0).all())
    pallas = pallas_gmm(jx, jw, block_c=16, block_f=32, block_d=32,
                        interpret=True)
    for want in (pallas, jref.moe_gmm_ref(jx, jw)):
        np.testing.assert_allclose(_f32(out), _f32(want), **GMM_TOL[dtype])


def test_gmm_plan_splits_only_small_c():
    """The bf16 kernel splits d at C <= 10 (arctic's decode step and its
    smaller prefill groups: 7 ranges of d 7168, 4 of d 4864, each of at
    least 16 stages of 64), not at C 15 and up, and never in fp32; the C
    tile pads C to 8, 16 or 32 rows in bf16."""
    from repro_torch.kernels.moe_gmm import d_splits, plan
    assert [d_splits(1, 7168), d_splits(1, 4864)] == [7, 4]
    assert [d_splits(30, 7168), d_splits(30, 4864), d_splits(3, 64)] == [1] * 3
    assert d_splits(10, 7168) == 7 and d_splits(15, 7168) == 1
    for C, tile in ((1, 8), (9, 16), (30, 32), (100, 32)):
        p = plan(torch.zeros(2, C, 64, dtype=torch.bfloat16),
                 torch.zeros(2, 64, 72, dtype=torch.bfloat16))
        assert (p.c_tile, p.vec) == (tile, True)
    p = plan(torch.zeros(2, 3, 37, dtype=torch.bfloat16),
             torch.zeros(2, 37, 53, dtype=torch.bfloat16))
    assert not p.vec
    p = plan(torch.zeros(2, 1, 7168), torch.zeros(2, 7168, 8))
    assert (p.c_tile, p.vec, p.splits) == (1, False, 1)


def test_decode_scratch_sizes():
    """A counter per (row, KV head); an (m, l, acc[hd]) partial per split
    and query head: musicgen's decode step (8 rows, 32 KV heads, 8 splits
    of 128 over a 1024 cache) and arctic's (8 KV heads of 7 queries)."""
    from repro_torch.kernels.decode_attention import scratch_sizes
    assert scratch_sizes(8, 32, 8, 1, 64) == (256, 8 * 32 * 8 * 66)
    assert scratch_sizes(8, 8, 8, 7, 128) == (64, 8 * 8 * 8 * 7 * 130)
    assert scratch_sizes(1, 1, 1, 1, 16) == (1, 18)


def test_decode_scratch_is_kept_per_device_and_stream():
    """One (counters, partials) pair per device and stream: zeroed int32
    counters and fp32 partials, rounded up to a power of two, reused while
    big enough, replaced by a larger pair when a call needs more, and never
    shared between streams."""
    from repro_torch.kernels.decode_attention import _SCRATCH, scratch
    keys = [("cpu", -1), ("cpu", -2)]
    try:
        count, part = scratch("cpu", -1, 10, 100)
        assert (count.numel(), part.numel()) == (16, 128)
        assert count.dtype == torch.int32 and part.dtype == torch.float32
        assert int(count.abs().sum()) == 0
        again = scratch("cpu", -1, 16, 50)
        assert again[0] is count and again[1] is part
        grown = scratch("cpu", -1, 17, 100)
        assert (grown[0].numel(), grown[1].numel()) == (32, 128)
        assert int(grown[0].abs().sum()) == 0
        other = scratch("cpu", -2, 1, 1)
        assert other[0] is not grown[0] and other[0].numel() == 1
        assert scratch("cpu", -1, 1, 1)[0] is grown[0]
    finally:
        for key in keys:
            _SCRATCH.pop(key, None)


def test_ssd_hp_tile_plan():
    """The bf16 grid takes the narrowest hp tile whose (hp / tile, nh, B)
    grid fits in one wave of resident blocks, else the widest: with an
    H100's 132 SMs holding 3, 2 and 2 blocks of tiles 16, 32 and 64 at ds
    128, mamba2's prefill groups (nh 64, hp 64) of 1, 2 and 3 prompts take
    16, 32 and 64 (chip_smoke.py's phase-5 sweep). hp 16 is one tile; fp32
    takes all of hp."""
    from repro_torch.kernels.ssd_scan import HEAD_DIMS, HP_TILES, hp_tile
    wave = {16: 3 * 132, 32: 2 * 132, 64: 2 * 132}.get
    bf16 = torch.bfloat16
    assert [hp_tile(B, 64, 64, bf16, wave) for B in (1, 2, 3, 8)] == [
        16, 32, 64, 64]
    assert hp_tile(1, 4, 64, bf16, wave) == 16
    assert hp_tile(3, 64, 16, bf16, wave) == 16
    assert [hp_tile(3, 64, hp, torch.float32, wave) for hp in HEAD_DIMS] == [
        16, 64]
    for B in range(1, 9):
        for hp in HEAD_DIMS:
            tile = hp_tile(B, 64, hp, bf16, wave)
            assert tile in HP_TILES and hp % tile == 0


def test_ssd_plain_rejects_a_broken_chunk():
    x = torch.zeros(1, 20, 2, 4)
    bc = torch.zeros(1, 20, 1, 4)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ops.ssd(x, torch.zeros(1, 20, 2), torch.zeros(2), bc, bc, chunk=16)
