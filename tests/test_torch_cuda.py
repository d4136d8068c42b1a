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
    decode_attention_ref, flash_attention_ref, paged_decode_attention_ref)

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
