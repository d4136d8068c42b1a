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
                          (4, 32, 32, 128, True)])
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
                                     (4, 10, 96, 160), (4, 15, 96, 160)])
def test_gmm_kernel_matches_plain(card, E, C, d, f, dtype):
    """Ragged C, d and f, C = 1 (a decode step), C over one tile, and a C
    for each C-tile instance (1, 2, 4, 8, 16, 32 rows)."""
    x = torch.randn(E, C, d, generator=card, device="cuda").to(dtype)
    w = (0.1 * torch.randn(E, d, f, generator=card, device="cuda")).to(dtype)
    before = ops.launch_counts()["moe_gmm"]
    out = ops.gmm(x, w)
    assert ops.launch_counts()["moe_gmm"] == before + 1
    rtol, atol = GMM_TOL[dtype]
    torch.testing.assert_close(out.float(), moe_gmm_ref(x, w).float(),
                               rtol=rtol, atol=atol)


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
