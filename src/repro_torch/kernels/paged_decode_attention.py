"""One-token decode attention through a page table, on the card.

Replaces ``repro.kernels.paged_decode_attention.paged_decode_attention``
(the Pallas ``_paged_decode_kernel``). It runs the split body of
``csrc/decode_attention.cu`` with a page-table address, one split per
page, so with ``page_size`` equal to the contiguous kernel's ``block_s``
its output is bit-identical to ``decode_attention`` over the same tokens.
K/V are read in place through the table; no gathered copy is made. The
plain version is ``kernels.ref.paged_decode_attention_ref``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import (
    check_decode_args, scratch, scratch_sizes)
from repro_torch.kernels.flash_attention import DTYPES


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths):
    """q: (B, H, hd); pages: (P, page_size, KVH, hd); page_table:
    (B, pages_per_row) int32 physical page ids; lengths: (B,) int32 fill.

    Returns (B, H, hd) in q's dtype. Every table entry of a row below its
    length must name a page in [0, P): the kernel reads it unchecked, as
    the Pallas kernel's index map does. Lengths are clamped to
    [0, pages_per_row * page_size]; rows with length 0 return exact zeros.
    """
    build.forbid_autograd("paged_decode_attention", q, k_pages, v_pages)
    B, H, KVH, hd, G = check_decode_args(q, k_pages, v_pages, lengths,
                                         "paged_decode_attention")
    ps = k_pages.shape[1]
    if (not page_table.is_cuda or page_table.device != q.device
            or page_table.dtype != torch.int32 or page_table.dim() != 2
            or page_table.shape[0] != B or page_table.shape[1] < 1
            or not page_table.is_contiguous()):
        raise ValueError("paged_decode_attention: page_table must be a "
                         f"contiguous int32 (B={B}, n>=1) CUDA tensor")
    n_pt = page_table.shape[1]
    o = torch.empty_like(q)
    if B == 0:
        return o
    stream = build.stream_of(q)
    count, part = scratch(q.device, stream.value,
                          *scratch_sizes(B, KVH, n_pt, G, hd))
    lib = build.library("decode_attention")
    build.check(lib.paged_decode_attention_fwd(
        build.ptr(q), build.ptr(k_pages), build.ptr(v_pages),
        build.ptr(page_table), build.ptr(lengths), build.ptr(o),
        build.ptr(part), build.ptr(count), B, H, KVH, hd, ps, n_pt,
        DTYPES[q.dtype], stream), "paged_decode_attention")
    paged_decode_attention.launches += 1
    return o


paged_decode_attention.launches = 0
