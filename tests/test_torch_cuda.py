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
                          (112, 512, 512, 128, True)])
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
                          (2, 28, 4, 128, 256, 64)])
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
                          (3, 128, 8, 64, 1, 128, 128)])
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
