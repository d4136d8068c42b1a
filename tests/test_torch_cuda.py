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
                          (2, 64, 8, 112, 256, 64), (3, 7, 1, 112, 128, 32)])
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
                          (2, 96, 8, 64, 2, 128, 48)])
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
