"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false (this file imports no jax, so it also runs on a machine without it):

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

chip_smoke.py runs the same comparisons at full model widths.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    decode_attention_ref, flash_attention_ref, moe_gmm_ref,
    paged_decode_attention_ref, ssd_scan_ref)

pytestmark = pytest.mark.cuda

# fp32: sums in another order (tests/test_kernels.py:24); bf16: outputs
# round to bf16 (tests/test_kernels.py:25)
TOL = {torch.float32: 2e-5, torch.bfloat16: 5e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(out, ref, dtype):
    tol = TOL[dtype]
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BH,S,Sk,hd,causal",
                         [(2, 128, 128, 64, True), (3, 96, 96, 32, True),
                          (2, 64, 192, 64, False), (1, 200, 200, 16, True),
                          (4, 32, 32, 128, True),
                          # every hd at an S that is no tile multiple
                          (2, 77, 77, 16, True), (2, 130, 130, 32, True),
                          (2, 200, 200, 64, True), (2, 333, 333, 128, True),
                          # Sk != S without the causal mask, both ways
                          (3, 100, 37, 32, False), (2, 40, 300, 128, False),
                          # arctic's prefill heads: 2 prompts x 56, S 512
                          (112, 512, 512, 128, True),
                          # kimi-k2's hd 112: a lone token, a ragged tile,
                          # a 512-token prompt of its 64 heads
                          (64, 1, 1, 112, True), (128, 40, 40, 112, True),
                          (64, 512, 512, 112, True)])
def test_flash_kernel_matches_plain(card, BH, S, Sk, hd, causal, dtype):
    q, k, v = (torch.randn(s, generator=card, device="cuda").to(dtype)
               for s in ((BH, S, hd), (BH, Sk, hd), (BH, Sk, hd)))
    before = ops.launch_counts()["flash_attention"]
    out = ops.attention(q, k, v, causal=causal)
    assert ops.launch_counts()["flash_attention"] == before + 1
    _close(out, flash_attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,hd,S,ps",
                         [(4, 4, 2, 16, 64, 16), (3, 8, 8, 32, 96, 32),
                          (2, 28, 4, 128, 256, 64),
                          # hd 112: 14 (bf16) or 28 (fp32) lanes a row
                          (2, 64, 8, 112, 256, 64), (3, 7, 1, 112, 128, 32),
                          # G 5 at hd 128: qwen3-14b whole and its 20/4
                          # heads a rank under tensor parallelism
                          (2, 40, 8, 128, 256, 64), (8, 20, 4, 128, 256, 64)])
def test_decode_kernels_match_plain_and_each_other(card, B, H, KVH, hd, S,
                                                   ps, dtype):
    """Contiguous and paged decode against the plain version; zero-length
    rows exact zero; paged == contiguous bitwise at page_size == block_s,
    with shuffled physical pages."""
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, KVH, hd, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    lengths = torch.randint(1, S + 1, (B,), generator=card, device="cuda",
                            dtype=torch.int32)
    lengths[0] = 0
    out = ops.decode(q, k, v, lengths, block_s=ps)
    _close(out, decode_attention_ref(q, k, v, lengths), dtype)
    assert bool((out[0] == 0).all())
    n_pt = S // ps
    table = (1 + torch.randperm(B * n_pt, generator=card, device="cuda")
             ).reshape(B, n_pt).to(torch.int32)
    pools = []
    for t in (k, v):
        pool = torch.full((1 + B * n_pt, ps, KVH, hd), float("nan"),
                          dtype=dtype, device="cuda")
        pool[table.reshape(-1).long()] = t.reshape(B * n_pt, ps, KVH, hd)
        pools.append(pool)
    paged = ops.paged_decode(q, *pools, table, lengths)
    assert torch.equal(paged, out)
    _close(paged, paged_decode_attention_ref(q, *pools, table, lengths),
           dtype)


def _pools(card, k, v, ps):
    """Pages of ``ps`` positions holding k and v at shuffled places, page 0
    NaN; returns (k pool, v pool, (B, S / ps) int32 table)."""
    B, S, KVH, hd = k.shape
    n_pt = S // ps
    table = (1 + torch.randperm(B * n_pt, generator=card, device="cuda")
             ).reshape(B, n_pt).to(torch.int32)
    pools = []
    for t in (k, v):
        pool = torch.full((1 + B * n_pt, ps, KVH, hd), float("nan"),
                          dtype=t.dtype, device="cuda")
        pool[table.reshape(-1).long()] = t.reshape(B * n_pt, ps, KVH, hd)
        pools.append(pool)
    return pools[0], pools[1], table


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KVH,hd", [(32, 32, 64), (56, 8, 128),
                                      (16, 8, 16), (28, 4, 32),
                                      (8, 1, 128), (12, 3, 64),
                                      (8, 8, 112), (28, 4, 112),
                                      (64, 8, 112)])
def test_decode_edges_repeat_bitwise(card, H, KVH, hd, dtype):
    """G of 1, 7, 2, 7, 8 and 4 over every hd, and 1, 7 and 8 at kimi-k2's
    hd 112: rows of length 0, 1, at
    cap, at a split's end and ending mid-split, with splits of 128 as the
    engine runs them. Two calls give equal bits, paged == contiguous."""
    B, S, ps = 6, 384, 128
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, KVH, hd, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    lengths = torch.tensor([0, 1, S, 128, 200, 383], dtype=torch.int32,
                           device="cuda")
    out = ops.decode(q, k, v, lengths, block_s=ps)
    _close(out, decode_attention_ref(q, k, v, lengths), dtype)
    assert bool((out[0] == 0).all())
    assert torch.equal(ops.decode(q, k, v, lengths, block_s=ps), out)
    kp, vp, table = _pools(card, k, v, ps)
    before = ops.launch_counts()["paged_decode_attention"]
    paged = ops.paged_decode(q, kp, vp, table, lengths)
    assert ops.launch_counts()["paged_decode_attention"] == before + 1
    assert torch.equal(paged, out)
    assert torch.equal(ops.paged_decode(q, kp, vp, table, lengths), paged)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_at_the_fleet_shape(card, dtype):
    """The serve fleet's engine: musicgen's heads, a 48-position cache in
    pages of 8, each row's table past its last page on the NaN null page
    as the engine leaves it; lengths 0, 1, a page, mid-page, the cap and
    the cap + 1 a full row passes. Paged and contiguous at block_s 8
    against the plain version, equal bit for bit, each repeatable."""
    B, H, hd, S, ps = 8, 32, 64, 48, 8
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, H, hd, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    lens = [0, 1, 8, 13, 33, 47, 48, 49]
    lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kp, vp, table = _pools(card, k, v, ps)
    for b, n in enumerate(lens):
        table[b, -(-min(n, S) // ps):] = 0
    ref = decode_attention_ref(q, k, v, lengths)
    out = ops.decode(q, k, v, lengths, block_s=ps)
    paged = ops.paged_decode(q, kp, vp, table, lengths)
    _close(out, ref, dtype)
    _close(paged, ref, dtype)
    assert bool((paged[0] == 0).all())
    assert torch.equal(paged, out)
    assert torch.equal(ops.decode(q, k, v, lengths, block_s=ps), out)
    assert torch.equal(ops.paged_decode(q, kp, vp, table, lengths), paged)


def test_decode_scratch_is_per_stream_and_left_zero(card):
    """Each stream gets its own counters, and a launch leaves them zero
    (the merging block resets its own), so a later launch is right."""
    from repro_torch.kernels.decode_attention import _SCRATCH
    B, H, KVH, hd, S = 4, 8, 2, 64, 512
    q = torch.randn(B, H, hd, generator=card, device="cuda")
    k, v = (torch.randn(B, S, KVH, hd, generator=card, device="cuda")
            for _ in range(2))
    lengths = torch.tensor([512, 300, 129, 77], dtype=torch.int32,
                           device="cuda")
    want = decode_attention_ref(q, k, v, lengths)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        out_side = ops.decode(q, k, v, lengths, block_s=128)
    out = ops.decode(q, k, v, lengths, block_s=128)
    torch.cuda.synchronize()
    _close(out, want, torch.float32)
    assert torch.equal(out_side, out)
    keys = [key for key in _SCRATCH if key[0] == str(q.device)]
    assert len(keys) >= 2
    for key in keys:
        assert int(_SCRATCH[key][0].abs().sum()) == 0


def _offset(t):
    """A contiguous copy of ``t`` one element past a 16-byte boundary, so
    the kernels take their element-wise loads."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_unaligned_inputs(card, dtype):
    """q, k and v off 16-byte alignment: the same bits as aligned copies,
    contiguous and paged."""
    _unaligned_case(card, dtype, 64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_unaligned_inputs_hd112(card, dtype):
    """The same at kimi-k2's hd 112, whose rows fill 14 or 28 of a lane
    group's 16 or 32 lanes."""
    _unaligned_case(card, dtype, 112)


def _unaligned_case(card, dtype, hd):
    B, H, KVH, S, ps = 3, 16, 4, 256, 128
    q = torch.randn(B, H, hd, generator=card, device="cuda").to(dtype)
    k, v = (torch.randn(B, S, KVH, hd, generator=card,
                        device="cuda").to(dtype) for _ in range(2))
    lengths = torch.tensor([256, 0, 150], dtype=torch.int32, device="cuda")
    out = ops.decode(q, k, v, lengths, block_s=ps)
    assert torch.equal(ops.decode(_offset(q), _offset(k), _offset(v),
                                  lengths, block_s=ps), out)
    kp, vp, table = _pools(card, k, v, ps)
    assert torch.equal(ops.paged_decode(_offset(q), _offset(kp),
                                        _offset(vp), table, lengths), out)


# tests/test_kernels.py:98-99 (gmm) and :81-82 (ssd): fp32 sums reorder;
# bf16 outputs round (gmm), bf16 inputs round before fp32 math (ssd)
GMM_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (8e-2, 4e-1)}
SSD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (8e-2, 8e-2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f", [(4, 32, 64, 128), (3, 5, 37, 53),
                                     (2, 70, 33, 31), (8, 1, 512, 384),
                                     (8, 2, 64, 64), (8, 3, 64, 64),
                                     (4, 10, 96, 160), (4, 15, 96, 160),
                                     (4, 30, 256, 136), (3, 64, 200, 96),
                                     (2, 100, 72, 264), (3, 100, 40, 37)])
def test_gmm_kernel_matches_plain(card, E, C, d, f, dtype):
    """Ragged C, d and f, C = 1 (a decode step), C over one tile, a C for
    each C-tile instance (1, 2, 4, 8, 16, 32 rows in fp32; 8, 16, 32 in
    bf16), and C of 30, 64 and 100 (several C tiles)."""
    x = torch.randn(E, C, d, generator=card, device="cuda").to(dtype)
    w = (0.1 * torch.randn(E, d, f, generator=card, device="cuda")).to(dtype)
    before = ops.launch_counts()["moe_gmm"]
    out = ops.gmm(x, w)
    assert ops.launch_counts()["moe_gmm"] == before + 1
    rtol, atol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), moe_gmm_ref(x, w).float(),
                               rtol=rtol, atol=atol)


def _gmm_counts_case(card, E, C, d, f, counts, dtype):
    """x with non-zero values in every row, also past the counts."""
    x = torch.randn(E, C, d, generator=card, device="cuda").to(dtype)
    w = (0.1 * torch.randn(E, d, f, generator=card, device="cuda")).to(dtype)
    cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
    before = ops.launch_counts()["moe_gmm"]
    out = ops.gmm(x, w, cnt)
    assert ops.launch_counts()["moe_gmm"] == before + 1
    rtol, atol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), moe_gmm_ref(x, w, cnt).float(),
                               rtol=rtol, atol=atol)
    past = torch.arange(C, device="cuda")[None, :] >= cnt[:, None]
    assert bool((out[past] == 0).all())
    return x, w, cnt, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("E,C,d,f,counts",
                         [(4, 1, 256, 128, [0, 0, 0, 0]),      # all empty
                          (6, 1, 512, 384, [0, 1, 0, 0, 1, 0]),
                          (4, 5, 96, 160, [0, 2, 5, 1]),       # ragged
                          (3, 40, 64, 72, [40, 0, 33]),        # count = C
                          (3, 7, 37, 53, [3, 7, 0]),           # ragged d, f
                          (4, 30, 256, 136, [30, 30, 30, 30])])
def test_gmm_counts_kernel_matches_plain(card, E, C, d, f, counts, dtype):
    """Rows at or past an expert's count come out exact zero although x
    holds non-zero values there; filled rows match the plain version."""
    _gmm_counts_case(card, E, C, d, f, counts, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gmm_split_over_d_matches_plain_and_repeats(card, dtype):
    """A decode-step shape where the bf16 kernel splits d into ranges
    whose fp32 partials a second pass sums in order: equal to the plain
    version, and bit for bit equal between two calls."""
    from repro_torch.kernels.moe_gmm import plan
    E, C, d, f = 16, 1, 3072, 256
    counts = [1 if e % 3 == 0 else 0 for e in range(E)]
    x, w, cnt, out = _gmm_counts_case(card, E, C, d, f, counts, dtype)
    want = 3 if dtype == torch.bfloat16 else 1
    assert plan(x, w).splits == want
    assert torch.equal(ops.gmm(x, w, cnt), out)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,nh,hp,ng,ds,chunk",
                         [(2, 64, 4, 16, 1, 16, 16),
                          (1, 96, 4, 16, 2, 128, 48),
                          (2, 48, 8, 64, 1, 16, 12),
                          (2, 512, 8, 64, 2, 128, 256),
                          (3, 128, 8, 64, 1, 128, 128),
                          # S < 64; chunk 12 and 48 at ds 128; ng 2
                          (2, 40, 8, 64, 1, 128, 40),
                          (1, 48, 4, 64, 2, 128, 12),
                          (2, 96, 8, 64, 2, 128, 48),
                          # mamba2's 32 of 64 heads a rank, TP 2
                          (3, 256, 32, 64, 1, 128, 256)])
def test_ssd_kernel_matches_plain(card, B, S, nh, hp, ng, ds, chunk, dtype):
    """y and the final state, over several chunks and ragged query
    tiles, with grouped B/C."""
    x = (0.5 * torch.randn(B, S, nh, hp, generator=card,
                           device="cuda")).to(dtype)
    dt = 0.01 + 0.29 * torch.rand(B, S, nh, generator=card, device="cuda")
    A = -(0.5 + 1.5 * torch.rand(nh, generator=card, device="cuda"))
    Bg, Cg = ((0.3 * torch.randn(B, S, ng, ds, generator=card,
                                 device="cuda")).to(dtype) for _ in range(2))
    before = ops.launch_counts()["ssd_scan"]
    y, state = ops.ssd(x, dt, A, Bg, Cg, chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == before + 1
    y_ref, state_ref = ssd_scan_ref(x, dt, A, Bg, Cg, chunk=chunk)
    rtol, atol = SSD_TOL[dtype]
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(state, state_ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tile", [16, 32, 64])
def test_ssd_every_hp_tile_matches_plain_and_repeats(card, tile, dtype):
    """Each hp tile the bf16 grid may take (the fp32 kernel ignores it)
    at mamba2's widths, two chunks: within tolerance, and two calls give
    equal bits."""
    from repro_torch.kernels.ssd_scan import launch
    B, S, nh, hp, ng, ds, chunk = 2, 512, 8, 64, 1, 128, 256
    x = (0.5 * torch.randn(B, S, nh, hp, generator=card,
                           device="cuda")).to(dtype)
    dt = 0.01 + 0.29 * torch.rand(B, S, nh, generator=card, device="cuda")
    A = -(0.5 + 1.5 * torch.rand(nh, generator=card, device="cuda"))
    Bg, Cg = ((0.3 * torch.randn(B, S, ng, ds, generator=card,
                                 device="cuda")).to(dtype) for _ in range(2))

    def run():
        y = torch.empty(B, S, nh, hp, device="cuda")
        st = torch.empty(B, nh, hp, ds, device="cuda")
        return launch(x, dt, A, Bg, Cg, y, st, chunk, tile)

    y, state = run()
    y_ref, state_ref = ssd_scan_ref(x, dt, A, Bg, Cg, chunk=chunk)
    rtol, atol = SSD_TOL[dtype]
    torch.testing.assert_close(y, y_ref, rtol=rtol, atol=atol)
    torch.testing.assert_close(state, state_ref, rtol=rtol, atol=atol)
    y2, state2 = run()
    assert torch.equal(y2, y) and torch.equal(state2, state)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_unaligned_inputs(card, dtype):
    """x, B and C off 16-byte alignment: the same bits as aligned copies."""
    B, S, nh, hp, ng, ds, chunk = 2, 128, 8, 64, 1, 128, 64
    x = (0.5 * torch.randn(B, S, nh, hp, generator=card,
                           device="cuda")).to(dtype)
    dt = 0.01 + 0.29 * torch.rand(B, S, nh, generator=card, device="cuda")
    A = -(0.5 + 1.5 * torch.rand(nh, generator=card, device="cuda"))
    Bg, Cg = ((0.3 * torch.randn(B, S, ng, ds, generator=card,
                                 device="cuda")).to(dtype) for _ in range(2))
    y, state = ops.ssd(x, dt, A, Bg, Cg, chunk=chunk)
    y2, state2 = ops.ssd(_offset(x), dt, A, _offset(Bg), _offset(Cg),
                         chunk=chunk)
    assert torch.equal(y2, y) and torch.equal(state2, state)


def test_ssd_hp_tile_fits_one_wave(card):
    """The occupancy the bf16 grid is sized by: each tile holds at least a
    block per SM, and the tile ``ssd_scan`` takes at mamba2's prefill
    groups (nh 64, hp 64, ds 128) of 1 to 3 prompts fits in one wave."""
    from repro_torch.kernels.ssd_scan import HP_TILES, _wave, hp_tile
    idx = torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(idx).multi_processor_count
    for tile in HP_TILES:
        assert _wave(idx, tile, 128) >= sms
    for B in (1, 2, 3):
        tile = hp_tile(B, 64, 64, torch.bfloat16,
                       lambda t: _wave(idx, t, 128))
        assert B * 64 * (64 // tile) <= _wave(idx, tile, 128)


@pytest.mark.parametrize("arch", ["qwen2-7b", "arctic-480b"])
def test_prefill_of_one_request_matches_cpu(card, arch):
    """A prefill group of one request (B = 1), as a lone admit makes: the
    kernels take the attention heads contiguous, and the card's logits
    match the CPU's plain path in fp32."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LM, tree_map
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(1, cfg.vocab_size, (1, 40),
                         generator=torch.Generator().manual_seed(1))
    want, _ = LM(cfg, params, device="cpu").prefill({"tokens": toks})
    before = ops.launch_counts()["flash_attention"]
    got, _ = LM(cfg, tree_map(lambda t: t.cuda(), params),
                device="cuda").prefill({"tokens": toks})
    assert ops.launch_counts()["flash_attention"] > before
    torch.testing.assert_close(got.cpu(), want, rtol=1e-3, atol=1e-3)


# ------------------------------------------------------ engine and driver
@pytest.mark.parametrize("page_size", [None, 8])
def test_zero_budget_prompt_at_max_len_on_the_card(card, page_size):
    """A prompt of exactly max_len with a budget of 0 decodes once with its
    write at position max_len: on the card the row writes nothing (no
    device assert) and serves the CPU's tokens, in fp32 on qwen2-7b's
    smoke config."""
    import dataclasses

    import numpy as np

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LM, tree_map
    from repro_torch.serve.engine import Engine, Request
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), dtype="float32")
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    max_len = 32

    def run(device, p):
        r = np.random.default_rng(5)
        reqs = [Request(rid=0, tokens=r.integers(1, 256, (max_len,)).astype(
                    np.int32), max_new_tokens=0),
                Request(rid=1, tokens=r.integers(1, 256, (6,)).astype(
                    np.int32), max_new_tokens=3)]
        eng = Engine(LM(cfg, p, device=device), max_batch=2, max_len=max_len,
                     page_size=page_size, device=device)
        done = eng.run(reqs)
        if device == "cuda":
            torch.cuda.synchronize()
        return [(q.rid, np.asarray(q.out_tokens).tolist()) for q in done]

    got = run("cuda", tree_map(lambda t: t.cuda(), params))
    assert got == run("cpu", params)
    assert [rid for rid, _ in got] == [0, 1] and len(got[0][1]) == 2


def test_serve_driver_on_a_two_layer_musicgen_matches_emulated_twin(card):
    """A ServeDriver over one Montage DAG on the card, through
    TorchEngineAdapter, on musicgen-large at published widths cut to 2
    layers (bf16, paged): every task completes in dependency order, every
    slot and page comes back, and the ServeStats, every task's (start,
    finish) and the completion order equal the EmulatedEngine twin's."""
    import dataclasses

    from benchmarks import torch_serve_fleet as tsf
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    from repro_torch.serve.driver import EmulatedEngine
    from repro_torch.serve.engine import Engine
    cfg = dataclasses.replace(get_config("musicgen-large"), n_layers=2)
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    eng = Engine(lm, max_batch=4, max_len=48, page_size=8, device="cuda")
    before = ops.launch_counts()["paged_decode_attention"]
    got = tsf.dag_run(eng)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_attention"] == \
        before + 2 * eng.steps
    assert not eng.active and len(eng.free) == 4
    assert eng.pager.used_pages == 0
    assert got == tsf.dag_run(EmulatedEngine(4, max_len=48))


def test_fleet_tokens_paged_equal_contiguous_on_a_two_layer_musicgen(card):
    """The one-tenant fleet of ``benchmarks/torch_serve_fleet.py`` on the
    card over musicgen-large at published widths cut to 2 layers (bf16):
    the paged engine (page size 8) and the contiguous one (block_s 8)
    serve every request the same tokens, bit for bit, and both equal the
    EmulatedEngine twin's stats (``fleet_row`` raises otherwise)."""
    import dataclasses

    from benchmarks import torch_serve_fleet as tsf
    from repro_torch.bridge import init_params
    from repro_torch.configs import get_config
    from repro_torch.models.lm import LM
    cfg = dataclasses.replace(get_config("musicgen-large"), n_layers=2)
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    row = tsf.fleet_row(lm, "1", **tsf.DEFAULTS)
    assert row["token_mismatches"] == 0
    assert row["requests"] == row["tasks"] == 52
    assert row["decode_steps"] == row["twin_decode_steps"] == 215
    assert row["launches"]["paged_decode_attention"] == 2 * 215
    assert row["contiguous_launches"]["decode_attention"] == 2 * 215


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_top8_repeats_bitwise(card, dtype):
    """kimi-k2's top-8: a token's eight gated outputs are added in a fixed
    order, so two calls on the card give equal bits (atomic adds did not:
    kimi's contiguous and paged runs then served different tokens), and
    the card matches the CPU's plain path on the same routing."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import tree_map
    from repro_torch.models.moe import moe_apply, route
    cfg = dataclasses.replace(get_smoke_config("kimi-k2-1t-a32b"),
                              n_experts=16, top_k=8, dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p = tree_map(lambda t: t[0], params["blocks"]["pos0"])["moe"]
    x = torch.randn(4, 24, cfg.d_model,
                    generator=torch.Generator().manual_seed(1)).to(
                        getattr(torch, dtype))
    pc = tree_map(lambda t: t.cuda(), p)
    ids, wts, _ = route(pc, cfg, x.cuda())
    out = moe_apply(pc, cfg, x.cuda(), ids, wts)
    assert torch.equal(moe_apply(pc, cfg, x.cuda(), ids, wts), out)
    want = moe_apply(p, cfg, x, ids.cpu(), wts.cpu())
    tol = {"float32": 1e-4, "bfloat16": 5e-2}[dtype]
    torch.testing.assert_close(out.cpu().float(), want.float(), rtol=tol,
                               atol=tol)


# ------------------------------------------------------------- training
def _grads(lm, batch, parallel):
    from repro_torch.models.lm import tree_leaves
    paths, leaves = zip(*tree_leaves(lm.params))
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = lm.loss(batch, parallel)
    return loss.item(), dict(zip(paths, torch.autograd.grad(loss, leaves)))


def test_training_loss_and_grads_on_the_card_match_cpu(card):
    """chip_smoke.py's train (a) on a smaller batch: a 2-layer cut of
    musicgen-large at published widths, fp32, seq 128: loss within 1e-5
    relative and every gradient leaf within rtol 1e-4, atol 1e-6 x max(1,
    the leaf's largest |gradient|) of the CPU's, and no kernel runs."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_map
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(get_config("musicgen-large"), n_layers=2,
                              dtype="float32")
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 128, 2))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(3),
                         "cuda")
    batch = synthetic_batches(rcfg, "cuda")(0)
    before = ops.launch_counts()
    lg, gg = _grads(LM(cfg, params, device="cuda"), batch, rcfg.parallel)
    assert ops.launch_counts() == before
    lc, gc = _grads(LM(cfg, tree_map(lambda t: t.cpu(), params),
                       device="cpu"),
                    {k: v.cpu() for k, v in batch.items()}, rcfg.parallel)
    assert lg == pytest.approx(lc, rel=1e-5)
    for path, ref in gc.items():
        atol = 1e-6 * max(1.0, ref.abs().max().item())
        torch.testing.assert_close(gg[path].cpu(), ref, rtol=1e-4, atol=atol,
                                   msg=path)


def test_preempt_resume_is_bitwise_on_the_card(card, tmp_path):
    """The preemptible loop on the card (qwen2-7b smoke, bf16): a run
    preempted before step 6 and resumed from its step-4 checkpoint gives
    the uninterrupted run's losses bit for bit, without
    torch.use_deterministic_algorithms."""
    import dataclasses

    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_smoke_config)
    from repro_torch.train.loop import train_loop
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), n_patches=8)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("smoke", "train", 32, 2),
                     parallel=ParallelConfig(attn_q_chunk=16,
                                             attn_kv_chunk=16),
                     warmup_steps=2, total_steps=12)
    assert not torch.are_deterministic_algorithms_enabled()
    ref = train_loop(rcfg, ckpt_dir=str(tmp_path / "ref"), num_steps=12,
                     ckpt_every=4, device="cuda")
    rep = train_loop(rcfg, ckpt_dir=str(tmp_path / "pre"), num_steps=12,
                     ckpt_every=4, fail_at={6: True}, device="cuda")
    assert rep.restarts == 1 and len(rep.losses) == 14
    assert rep.losses[:6] == ref.losses[:6]
    assert rep.losses[6:] == ref.losses[4:]


def test_kernel_wrappers_refuse_autograd_on_cuda_tensors(card):
    """Each of the five wrappers raises when grad mode is on and an input
    requires grad: a forward-only kernel would leave it without a
    gradient. Under no_grad the same call launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.moe_gmm import moe_gmm
    from repro_torch.kernels.paged_decode_attention import (
        paged_decode_attention)
    from repro_torch.kernels.ssd_scan import ssd_scan
    q = torch.randn(2, 4, 16, generator=card, device="cuda",
                    requires_grad=True)
    kv = torch.randn(2, 8, 2, 16, generator=card, device="cuda",
                     requires_grad=True)
    lengths = torch.full((2,), 5, dtype=torch.int32, device="cuda")
    table = torch.arange(2, dtype=torch.int32, device="cuda")[:, None]
    x, bc = (torch.randn(s, generator=card, device="cuda")
             for s in ((1, 16, 2, 16), (1, 16, 1, 16)))
    dt = torch.rand(1, 16, 2, generator=card, device="cuda")
    A = -torch.rand(2, generator=card, device="cuda").requires_grad_()
    w = torch.randn(2, 16, 8, generator=card, device="cuda",
                    requires_grad=True)
    calls = [lambda: flash_attention(q, q, q),
             lambda: decode_attention(q, kv, kv, lengths, block_s=8),
             lambda: paged_decode_attention(q, kv, kv, table, lengths),
             lambda: moe_gmm(torch.randn(2, 3, 16, device="cuda"), w),
             lambda: ssd_scan(x, dt, A, bc, bc, chunk=16)]
    for call in calls:
        with pytest.raises(RuntimeError, match="forward-only"):
            call()
    before = ops.launch_counts()
    with torch.no_grad():
        for call in calls:
            call()
    torch.cuda.synchronize()
    assert all(v == before[k] + 1 for k, v in ops.launch_counts().items())


def test_one_bf16_train_step_of_a_two_layer_musicgen(card):
    """One train step (2 microbatches, remat per layer) of musicgen-large
    at published widths cut to 2 layers, bf16, seq 512: finite loss,
    grad norm and updated params, and no kernel runs."""
    import dataclasses
    import math

    from repro_torch.bridge import init_params
    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_config)
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_leaves
    from repro_torch.train.train_step import build_train_step
    cfg = dataclasses.replace(get_config("musicgen-large"), n_layers=2)
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("t", "train", 512, 4),
                     parallel=ParallelConfig(microbatches=2))
    lm = LM(cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(
        0), "cuda"), device="cuda")
    step_fn, opt = build_train_step(lm, rcfg)
    before = ops.launch_counts()
    state, met = step_fn(opt.init(lm.params),
                         synthetic_batches(rcfg, "cuda")(0))
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    assert state.step == 1
    for k in ("loss", "ce", "z", "grad_norm", "lr"):
        assert math.isfinite(met[k].item()), k
    assert met["grad_norm"].item() > 0
    for path, t in tree_leaves(state.params):
        assert torch.isfinite(t).all(), path


# ------------------------------------------------- serving across ranks
# One world of 2 processes per backend, started once: gloo with both
# ranks on the one card (NCCL refuses two ranks on one card), and NCCL
# with a card a rank. Each rank runs the cases on its share and writes
# its results: the collectives beside the single-rank kernels on the same
# inputs (``parallel.check``), expert-parallel MoE, which the test holds
# against the single-rank ``moe_apply`` here, and a tensor-parallel
# prefill and decode step, held against one rank's logits here.
_RANKS = r"""
import json, sys
import torch
import torch.distributed as dist
from repro_torch.configs import get_smoke_config
import dataclasses
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.moe import moe_apply
from repro_torch.parallel.check import collectives_against_kernels

rank, world, port, backend, work = (int(sys.argv[1]), int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4], sys.argv[5])
dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                        rank=rank, world_size=world)
dev = torch.device("cuda", 0 if backend == "gloo" else rank)
mesh = make_mesh(1, world, device=dev)
c = {k: v.to(dev) for k, v in torch.load(f"{work}/case.pt").items()}
cfg = dataclasses.replace(get_smoke_config("arctic-480b"), dtype="bfloat16")
n, i = world, mesh.coords["model"]
E = cfg.n_experts
p = {w: c[w][i * E // n:(i + 1) * E // n].contiguous()
     for w in ("w_in", "w_gate", "w_out")}
ops.reset_launch_counts()
out = {"moe": moe_apply(p, cfg, c["x"], c["ids"], c["wts"], mesh=mesh)}
gmm = ops.launch_counts()["moe_gmm"]
out.update(collectives_against_kernels(
    mesh, *(c[w] for w in ("q", "k", "v", "lengths", "new_k", "new_v",
                           "rq", "rk", "rv"))))
caches_equal = out.pop("caches_equal")
# tensor parallelism: qwen3's smoke config in fp32, heads, MLP and vocab
# split over the 2 ranks, each rank drawing the whole stream on the CPU
from repro_torch.bridge import init_params
from repro_torch.models.lm import LM, Runtime, tree_map
tcfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
rt = Runtime(mesh=mesh)
lm = LM(tcfg, tree_map(lambda t: t.to(dev), init_params(
    tcfg, torch.Generator().manual_seed(0), "cpu", mesh=mesh)), device=dev)
ops.reset_launch_counts()
logits, pre = lm.prefill({"tokens": c["tp_tokens"]}, rt=rt)
caches = lm.init_cache(2, 32, rt)
for b in range(2):
    lm.splice(caches, pre, b, b)
dec, _ = lm.decode(c["tp_next"], torch.full((2,), 16, dtype=torch.int32,
                                             device=dev), caches, rt=rt)
tp_launches = ops.launch_counts()
out.update(tp_prefill=logits, tp_decode=dec)
torch.save({k: v.cpu() for k, v in out.items()}, f"{work}/out{rank}.pt")
json.dump({"moe_gmm": gmm, "local_experts": p["w_in"].shape[0],
           "caches_equal": caches_equal, "tp_launches": tp_launches,
           "tp_heads": lm.params["blocks"]["pos0"]["attn"]["wq"].shape[-1]
           // tcfg.head_dim,
           "backend": dist.get_backend(), "device": str(mesh.device)},
          open(f"{work}/meta{rank}.json", "w"))
dist.destroy_process_group()
"""


def _rank_case():
    """Arctic's smoke MoE layer in bf16 (top-2, 8 experts), a GQA decode
    with a row at the cache's end, and a GQA ring prefill, on the CPU."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import tree_map
    cfg = dataclasses.replace(get_smoke_config("arctic-480b"),
                              dtype="bfloat16")
    p = tree_map(lambda t: t[0], init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")["blocks"]["pos0"])
    g = torch.Generator().manual_seed(3)

    def r(*shape):
        return torch.randn(shape, generator=g).to(torch.bfloat16)

    B, H, KVH, hd, S = 4, 8, 2, 64, 256
    return cfg, p["moe"], {
        "x": r(4, 24, cfg.d_model), **{w: p["moe"][w] for w in
                                        ("w_in", "w_gate", "w_out")},
        "q": r(B, H, hd), "k": r(B, S, KVH, hd), "v": r(B, S, KVH, hd),
        "lengths": torch.tensor([0, 77, 200, S], dtype=torch.int32),
        "new_k": r(B, KVH, hd), "new_v": r(B, KVH, hd),
        "rq": r(2, 128, H, hd), "rk": r(2, 128, KVH, hd),
        "rv": r(2, 128, KVH, hd),
        "tp_tokens": torch.randint(1, 256, (2, 16), generator=g),
        "tp_next": torch.randint(1, 256, (2, 1), generator=g)}


_WORLDS = {}


def _world(backend, tmp_path_factory):
    """(case, router output, each rank's outputs and meta) of the world of
    2 over ``backend``, run once."""
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.models.moe import route
    if backend in _WORLDS:
        return _WORLDS[backend]
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL puts one rank on a card: needs two cards")
    cfg, p, case = _rank_case()
    ids, wts, _ = route({"router": p["router"].cuda()}, cfg,
                        case["x"].cuda())
    case.update(ids=ids.cpu(), wts=wts.cpu())
    work = tmp_path_factory.mktemp(f"ranks_{backend}")
    torch.save(case, work / "case.pt")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANKS, str(r), "2", str(port), backend,
         str(work)], env=env, cwd=root, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            proc.kill()
    outs = [torch.load(work / f"out{r}.pt") for r in range(2)]
    metas = [json.loads((work / f"meta{r}.json").read_text())
             for r in range(2)]
    _WORLDS[backend] = (cfg, p, case, outs, metas)
    return _WORLDS[backend]


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_expert_parallel_moe_equals_single_rank_bitwise(card, backend,
                                                        tmp_path_factory):
    """Top-2 over 2 ranks of 4 experts each: a token's output is the same
    two bf16 terms the single-rank combine adds, so equal bit for bit."""
    from repro_torch.models.lm import tree_map
    from repro_torch.models.moe import moe_apply
    cfg, p, case, outs, metas = _world(backend, tmp_path_factory)
    want = moe_apply(tree_map(lambda t: t.cuda(), p), cfg, case["x"].cuda(),
                     case["ids"].cuda(), case["wts"].cuda()).cpu()
    for out, meta in zip(outs, metas):
        assert meta["backend"] == backend and meta["local_experts"] == 4
        assert meta["moe_gmm"] == 3
        assert torch.equal(out["moe"], want)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_seq_sharded_decode_within_bf16_of_the_decode_kernel(
        card, backend, tmp_path_factory):
    """The sequence-sharded cache's partials merged across 2 ranks against
    the decode kernel on the whole cache; the row at the cache's end
    writes nothing, on both (``parallel.check``)."""
    _, _, _, outs, metas = _world(backend, tmp_path_factory)
    for out, meta in zip(outs, metas):
        assert meta["caches_equal"]
        _close(out["decode"], out["decode_want"], torch.bfloat16)
        assert torch.equal(out["decode"], outs[0]["decode"])
        assert torch.equal(out["decode_want"], outs[0]["decode_want"])


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_ring_prefill_within_bf16_of_the_flash_kernel(card, backend,
                                                      tmp_path_factory):
    _, _, _, outs, _ = _world(backend, tmp_path_factory)
    for out in outs:
        _close(out["ring"], out["ring_want"], torch.bfloat16)
        assert torch.equal(out["ring"], outs[0]["ring"])
        assert torch.equal(out["ring_want"], outs[0]["ring_want"])


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_tensor_parallel_logits_equal_one_rank(card, backend,
                                               tmp_path_factory):
    """qwen3's smoke config in fp32 over 2 ranks, heads (1 KV head a
    rank), MLP and vocab split: the prefill's and a decode step's logits
    within 1e-4 of one rank's on the card, equal on both ranks, through
    flash and decode at the rank's 2 heads."""
    import dataclasses

    from repro_torch.bridge import init_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import LM, tree_map
    _, _, case, outs, metas = _world(backend, tmp_path_factory)
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
    lm = LM(cfg, tree_map(lambda t: t.cuda(), init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")), device="cuda")
    logits, pre = lm.prefill({"tokens": case["tp_tokens"].cuda()})
    caches = lm.init_cache(2, 32)
    for b in range(2):
        lm.splice(caches, pre, b, b)
    dec, _ = lm.decode(case["tp_next"].cuda(), torch.full(
        (2,), 16, dtype=torch.int32, device="cuda"), caches)
    for out, meta in zip(outs, metas):
        assert meta["tp_heads"] == cfg.n_heads // 2
        assert meta["tp_launches"]["flash_attention"] == cfg.n_layers
        assert meta["tp_launches"]["decode_attention"] == cfg.n_layers
        for key, want in (("tp_prefill", logits), ("tp_decode", dec)):
            torch.testing.assert_close(out[key], want.cpu(), rtol=1e-4,
                                       atol=1e-4)
            assert torch.equal(out[key], outs[0][key])


# ------------------------------------------------ data-parallel training
def _dp_step(mesh):
    """One data-parallel step of qwen2-7b's smoke config in fp32 on the
    card, as a rank of ``mesh`` (None: alone): global batch 4 whose rows
    hold 6, 12, 19 and 25 tokens of the mask, ZeRO-1 on, fp32 moments.
    Returns the metrics, the updated params, the launch counts and the
    moment entries this rank holds."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.bridge import init_params
    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_smoke_config)
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_leaves, tree_map
    from repro_torch.train.train_step import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), dtype="float32")
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("dp", "train", 32, 4),
                     parallel=ParallelConfig(attn_q_chunk=16,
                                             attn_kv_chunk=16),
                     warmup_steps=2, moment_dtype="float32")
    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    lm = LM(cfg, tree_map(lambda t: t.to(dev), init_params(
        cfg, torch.Generator().manual_seed(0), "cpu")), device=dev)
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
    batch = synthetic_batches(rcfg, dev)(0)
    keep = torch.tensor([6, 12, 19, 25], device=dev)
    batch["mask"] = (torch.arange(32, device=dev)[None, :]
                     < keep[:, None]).float()
    ops.reset_launch_counts()
    state, met = step_fn(state, batch)
    return {"metrics": {k: float(v) for k, v in met.items()},
            "params": {p: t.detach().cpu()
                       for p, t in tree_leaves(lm.params)},
            "launches": ops.launch_counts(),
            "backend": dist.get_backend() if mesh is not None else None,
            "moments": sum(t.numel() for _, t in tree_leaves(state.m))}


def _dp_rank(rank, mesh):
    return _dp_step(mesh)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_data_parallel_step_equals_one_rank(card, backend):
    """A 2-rank data-parallel step (``launch.world.spawn_world``): gloo
    with both ranks on the one card, NCCL with a card a rank (the
    reduce-scatter onto the ZeRO-1 slices). Loss and metrics within rtol
    1e-5 of one rank's step at the same global batch, the updated params
    within 1e-4 and equal bit for bit on both ranks, each rank holding
    half the moments; no kernel launches (the training route is plain
    PyTorch)."""
    from repro_torch.launch.world import spawn_world
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL puts one rank on a card: needs two cards")
    devices = ["cuda:0", "cuda:0"] if backend == "gloo" else \
        ["cuda:0", "cuda:1"]
    ranks = spawn_world(2, _dp_rank, devices=devices)
    one = _dp_step(None)
    for r in ranks:
        assert r["backend"] == backend
        assert not any(r["launches"].values()), r["launches"]
        assert one["moments"] / 2 <= r["moments"] < 0.51 * one["moments"]
        for k, want in one["metrics"].items():
            assert r["metrics"][k] == pytest.approx(want, rel=1e-5), k
        for p, want in one["params"].items():
            torch.testing.assert_close(r["params"][p], want, rtol=1e-4,
                                       atol=1e-4)
            assert torch.equal(r["params"][p], ranks[0]["params"][p]), p


# ------------------------------------------- training under the model axis
def _tp_step(mesh):
    """One step of qwen3-14b's smoke config in fp32 on the card, as a rank
    of ``mesh`` (None: alone), its params split over ``model`` (heads, MLP
    columns, vocab rows): global batch 4, ZeRO-1 on, fp32 moments.
    Returns the metrics, the updated params joined whole, the launch
    counts and the backend."""
    import dataclasses

    import torch.distributed as dist
    from repro_torch.bridge import init_params
    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_smoke_config)
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_leaves, tree_map
    from repro_torch.train.train_step import build_train_step, model_split
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("qwen3-14b"), dtype="float32")
    rcfg = RunConfig(model=cfg, shape=ShapeConfig("tp", "train", 32, 4),
                     parallel=ParallelConfig(attn_q_chunk=16,
                                             attn_kv_chunk=16),
                     warmup_steps=2, moment_dtype="float32")
    dev = mesh.device if mesh is not None else torch.device("cuda", 0)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    split = model_split(rcfg, mesh)
    if split is not None:
        params = split.slice_tree(params)
    lm = LM(cfg, tree_map(lambda t: t.to(dev), params), device=dev)
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
    ops.reset_launch_counts()
    state, met = step_fn(state, synthetic_batches(rcfg, dev)(0))
    whole = split.gather_tree(lm.params) if split is not None else lm.params
    return {"metrics": {k: float(v) for k, v in met.items()},
            "params": {p: t.detach().cpu() for p, t in tree_leaves(whole)},
            "launches": ops.launch_counts(),
            "backend": dist.get_backend() if mesh is not None else None}


def _tp_rank(rank, mesh):
    return _tp_step(mesh)


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_tensor_parallel_train_step_equals_one_rank(card, backend):
    """A train step split over ``model`` (``launch.world.spawn_world(...,
    model=2)``): gloo at (model 2) with both ranks on the one card, NCCL at
    (data 2, model 2) with a card a rank. Loss and metrics within rtol
    1e-5 of one rank's step at the same global batch, the updated params
    within 1e-4 and equal bit for bit on every rank; no kernel launches."""
    from repro_torch.launch.world import spawn_world
    if backend == "nccl" and torch.cuda.device_count() < 4:
        pytest.skip("NCCL puts one rank on a card: (data 2, model 2) needs "
                    "four cards")
    devices = (["cuda:0"] * 2 if backend == "gloo"
               else [f"cuda:{i}" for i in range(4)])
    ranks = spawn_world(len(devices), _tp_rank, devices=devices, model=2)
    one = _tp_step(None)
    for r in ranks:
        assert r["backend"] == backend
        assert not any(r["launches"].values()), r["launches"]
        for k, want in one["metrics"].items():
            assert r["metrics"][k] == pytest.approx(want, rel=1e-5), k
        for p, want in one["params"].items():
            torch.testing.assert_close(r["params"][p], want, rtol=1e-4,
                                       atol=1e-4)
            assert torch.equal(r["params"][p], ranks[0]["params"][p]), p


# ------------------------------------------------ FSDP parameter storage
def _fsdp_rank(rank, mesh):
    """On this rank of (data 2): ``fsdp_gather`` of a card tensor (its
    forward and the gradient it hands back) and ``reduce_scatter`` of
    another, then one ``fsdp_tp`` step of ``_fsdp_run``, its params
    joined whole."""
    import torch.distributed as dist
    from repro_torch.bridge import init_params
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_leaves, tree_map
    from repro_torch.parallel.collectives import fsdp_gather, reduce_scatter
    from repro_torch.train.train_step import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    group, dev = mesh.group("data"), mesh.device
    x = (torch.arange(12.0, device=dev).reshape(3, 4) + 100 * rank)
    t = x.clone().requires_grad_(True)
    y = fsdp_gather(t, 1, group)                      # (3, 8)
    (y * (rank + 1)).sum().backward()
    out = {"y": y.detach().cpu(), "grad": t.grad.cpu(),
           "scatter": reduce_scatter(torch.arange(
               16.0, device=dev).reshape(4, 4) * (rank + 1), 0, group).cpu(),
           "backend": dist.get_backend()}
    rcfg = _fsdp_run()
    # the slices this rank stores of the same draws
    lm = LM(rcfg.model, tree_map(lambda t: t.to(dev), init_params(
        rcfg.model, torch.Generator().manual_seed(0), "cpu", mesh=mesh,
        parallel=rcfg.parallel)), device=dev)
    step_fn, opt = build_train_step(lm, rcfg, mesh)
    state = opt.init(lm.params, step_fn.zero)
    ops.reset_launch_counts()
    state, met = step_fn(state, synthetic_batches(rcfg, dev)(0))
    out.update(metrics={k: float(v) for k, v in met.items()},
               params={p: t.detach().cpu() for p, t in tree_leaves(
                   step_fn.zero.gather_tree(lm.params))},
               stored=sum(t.numel() for _, t in tree_leaves(lm.params)),
               launches=ops.launch_counts())
    return out


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_fsdp_collectives_and_step_equal_plain_and_one_rank(card, backend):
    """FSDP storage on 2 ranks (``launch.world.spawn_world``): gloo with
    both ranks on the one card, NCCL with a card a rank (its
    reduce-scatter). ``fsdp_gather`` joins the ranks' slices in rank
    order and hands each rank its slice of the summed gradient;
    ``reduce_scatter`` gives each rank its rows of the plain sum. One
    ``fsdp_tp`` step of qwen2-7b's smoke config (``_fsdp_run``): loss
    and metrics within rtol 1e-5 of one rank's, the updated params within
    1e-4 and equal on both ranks, a rank storing at most 0.51 of the
    params; no kernel launches."""
    from repro_torch.launch.world import spawn_world
    if backend == "nccl" and torch.cuda.device_count() < 2:
        pytest.skip("NCCL puts one rank on a card: needs two cards")
    devices = ["cuda:0", "cuda:0"] if backend == "gloo" else \
        ["cuda:0", "cuda:1"]
    ranks = spawn_world(2, _fsdp_rank, devices=devices)
    xs = [torch.arange(12.0).reshape(3, 4) + 100 * r for r in range(2)]
    whole = sum(torch.arange(16.0).reshape(4, 4) * (r + 1) for r in range(2))
    ref = _fsdp_one_rank()
    n = sum(t.numel() for t in ref["params"].values())
    for r, got in enumerate(ranks):
        assert got["backend"] == backend
        assert torch.equal(got["y"], torch.cat(xs, dim=1))
        assert torch.equal(got["grad"], torch.full((3, 4), 3.0))   # 1 + 2
        assert torch.equal(got["scatter"], whole[2 * r:2 * r + 2])
        assert not any(got["launches"].values()), got["launches"]
        assert got["stored"] <= 0.51 * n
    for r in ranks:
        for k, want in ref["metrics"].items():
            assert r["metrics"][k] == pytest.approx(want, rel=1e-5), k
        for p, want in ref["params"].items():
            torch.testing.assert_close(r["params"][p], want, rtol=1e-4,
                                       atol=1e-4)
            assert torch.equal(r["params"][p], ranks[0]["params"][p]), p


def _fsdp_run():
    """qwen2-7b's smoke config in fp32 under ``fsdp_tp``, global batch 4,
    fp32 moments."""
    import dataclasses

    from repro_torch.configs import (
        ParallelConfig, RunConfig, ShapeConfig, get_smoke_config)
    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), dtype="float32")
    return RunConfig(model=cfg, shape=ShapeConfig("fsdp", "train", 32, 4),
                     parallel=ParallelConfig(strategy="fsdp_tp",
                                             attn_q_chunk=16,
                                             attn_kv_chunk=16),
                     warmup_steps=2, moment_dtype="float32")


def _fsdp_one_rank():
    """``_fsdp_rank``'s step alone on the card: the same weights, the
    global batch whole."""
    from repro_torch.bridge import init_params
    from repro_torch.data.synthetic import synthetic_batches
    from repro_torch.models.lm import LM, tree_leaves, tree_map
    from repro_torch.train.train_step import build_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    rcfg = _fsdp_run()
    dev = torch.device("cuda", 0)
    lm = LM(rcfg.model, tree_map(lambda t: t.to(dev), init_params(
        rcfg.model, torch.Generator().manual_seed(0), "cpu")), device=dev)
    step_fn, opt = build_train_step(lm, rcfg)
    state = opt.init(lm.params, step_fn.zero)
    state, met = step_fn(state, synthetic_batches(rcfg, dev)(0))
    return {"metrics": {k: float(v) for k, v in met.items()},
            "params": {p: t.detach().cpu()
                       for p, t in tree_leaves(lm.params)}}
