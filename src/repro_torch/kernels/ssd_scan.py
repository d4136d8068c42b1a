"""Mamba2 chunked SSD scan on the card: ``csrc/ssd_scan.cu``.

Replaces ``repro.kernels.ssd_scan.ssd_scan`` (the Pallas ``_ssd_kernel``).
The plain version is ``kernels.ref.ssd_scan_ref``; ``kernels.ops.ssd``
picks between the two by the tensor's device.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.cost import Cost
from repro_torch.kernels.flash_attention import DTYPES

HEAD_DIMS = (16, 64)      # hp the kernel is built for
STATE_DIMS = (16, 128)    # ds the kernel is built for
MAX_CHUNK = 256           # MAXQ in csrc
HP_TILES = (16, 32, 64)   # hp columns a bf16 block may own


def hp_tile(B: int, nh: int, hp: int, dtype, wave) -> int:
    """Columns of hp one bf16 block owns; the grid is (hp / tile, nh, B).

    The narrowest tile whose grid fits in one wave of resident blocks,
    ``wave(tile)`` (SMs x blocks an SM holds of that tile), else the
    widest: narrower tiles put more blocks on the card, a second wave
    costs more than they gain, and every block recomputes its group's
    C.B scores. chip_smoke.py's phase-5 sweep times each tile at every
    mamba2 prefill group shape (PERF.md): at 3 prompts the tile of 64 (192
    blocks) is fastest, at 2 the tile of 32, at 1 the tiles of 16 and 32
    tie. The fp32 kernel takes all of hp.
    """
    if dtype != torch.bfloat16:
        return hp
    tiles = [t for t in HP_TILES if hp % t == 0]
    return next((t for t in tiles if B * nh * (hp // t) <= wave(t)),
                tiles[-1])


@functools.cache
def _wave(device_index: int, tile: int, ds: int) -> int:
    """Blocks of the bf16 instance (tile, ds) the card runs at once."""
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(build.library("ssd_scan").ssd_scan_occupancy(
            tile, ds, ctypes.addressof(blocks)), "ssd_scan occupancy")
        sms = torch.cuda.get_device_properties(
            device_index).multi_processor_count
    return sms * blocks.value


def ssd_scan(x, dt, A, Bg, Cg, *, chunk: int):
    """x: (B, S, nh, hp); dt: (B, S, nh) f32; A: (nh,) f32; Bg/Cg:
    (B, S, ng, ds) in x's dtype, head h reading group h // (nh / ng).

    Returns (y (B, S, nh, hp) fp32, final state (B, nh, hp, ds) fp32) of
    the scan from a zero state. S must be a multiple of ``chunk``.
    """
    build.forbid_autograd("ssd_scan", x, dt, A, Bg, Cg)
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bg", Bg), ("Cg", Cg)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"ssd_scan: {name} must be a CUDA tensor on x's "
                             "device")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if x.dim() != 4 or Bg.dim() != 4 or Cg.shape != Bg.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)} must be (B, S, nh, "
                         f"hp) and Bg, Cg one (B, S, ng, ds) shape")
    B, S, nh, hp = x.shape
    ng, ds = Bg.shape[2:]
    if (x.dtype not in DTYPES or Bg.dtype != x.dtype or Cg.dtype != x.dtype
            or dt.dtype != torch.float32 or A.dtype != torch.float32):
        raise ValueError("ssd_scan: x, Bg, Cg must share a dtype in "
                         f"{list(DTYPES)}; dt and A must be float32")
    if dt.shape != (B, S, nh) or A.shape != (nh,) or Bg.shape[:2] != (B, S):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bg {tuple(Bg.shape)} do not "
                         f"match x {tuple(x.shape)}")
    if hp not in HEAD_DIMS or ds not in STATE_DIMS:
        raise ValueError(f"ssd_scan: hp={hp} not in {HEAD_DIMS} or ds={ds} "
                         f"not in {STATE_DIMS}")
    if ng < 1 or nh % ng:
        raise ValueError(f"ssd_scan: ng={ng} must divide nh={nh}")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: S={S} must be a multiple of chunk="
                         f"{chunk}, and 1 <= chunk <= {MAX_CHUNK}")
    if B > 65535:
        raise ValueError(f"ssd_scan: B={B} exceeds the grid")
    y = torch.empty((B, S, nh, hp), dtype=torch.float32, device=x.device)
    state = torch.empty((B, nh, hp, ds), dtype=torch.float32, device=x.device)
    if B == 0 or nh == 0:
        return y, state
    tile = hp_tile(B, nh, hp, x.dtype,
                   lambda t: _wave(x.device.index, t, ds))
    return launch(x, dt, A, Bg, Cg, y, state, chunk, tile)


def launch(x, dt, A, Bg, Cg, y, state, chunk: int, tile: int):
    """Launch on checked arguments: ``ssd_scan`` passes ``hp_tile``; a
    timing sweep may pass another tile of ``HP_TILES`` dividing hp."""
    B, S, nh, hp = x.shape
    ng, ds = Bg.shape[2:]
    lib = build.library("ssd_scan")
    build.check(lib.ssd_scan_fwd(
        build.ptr(x), build.ptr(dt), build.ptr(A), build.ptr(Bg),
        build.ptr(Cg), build.ptr(y), build.ptr(state), B, S, nh, hp, ng, ds,
        chunk, tile, DTYPES[x.dtype], build.stream_of(x)), "ssd_scan")
    ssd_scan.launches += 1
    return y, state


ssd_scan.launches = 0


def io_bytes(B, S, nh, hp, ng, ds, elt) -> int:
    """Bytes one call must move: x, dt, A, B and C read once, y and the
    final state (fp32) written once."""
    return (elt * B * S * nh * hp + 4 * B * S * nh + 4 * nh
            + 2 * elt * B * S * ng * ds + 4 * B * S * nh * hp
            + 4 * B * nh * hp * ds)


def cost(B: int, S: int, nh: int, hp: int, ng: int, ds: int, chunk: int,
         dtype):
    """``kernels.cost.Cost`` of one call: ``io_bytes``; the C.B scores
    (operands in x's dtype) once per (row, chunk, group), and the
    products with an fp32 operand (the scores times dt x, the
    inter-chunk term, the state update) per head. The bf16 kernel runs
    the scores on bf16 tensor cores and the rest on TF32 ones; the fp32
    kernel runs both on CUDA cores."""
    if B == 0 or nh == 0:
        return Cost(0, 0)
    tri = chunk * (chunk + 1) // 2
    nc = S // chunk
    scores = 2 * nc * B * ng * tri * ds
    rest = 2 * nc * B * nh * (tri * hp + 2 * chunk * hp * ds)
    bf16 = dtype == torch.bfloat16
    return Cost(1, io_bytes(B, S, nh, hp, ng, ds, dtype.itemsize),
                ((scores, "bf16" if bf16 else "fp32"),
                 (rest, "tf32" if bf16 else "fp32")))


def meta(x, Bg):
    """(y, final state) of ``ssd_scan`` on x and Bg as meta tensors."""
    B, S, nh, hp = x.shape
    ds = Bg.shape[3]
    return (torch.empty((B, S, nh, hp), dtype=torch.float32, device="meta"),
            torch.empty((B, nh, hp, ds), dtype=torch.float32, device="meta"))
