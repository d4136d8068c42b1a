"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles to its own shared library with a plain C
interface, ``build/repro_torch_kernels/<name>-<hash>.so`` under the repo
root, where the hash covers every file in ``csrc/`` and the flags: a source
edit rebuilds, an unchanged tree reuses the library. Missing libraries are
built at first use, one nvcc process per source, all started together.
There is no fallback: without nvcc, or when a build fails, this raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "decode_attention", "moe_gmm", "ssd_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
DEFAULT_CUDA_HOME = "/usr/local/cuda"

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points and their argument types; every one returns cudaError_t.
SIGNATURES = {
    "flash_attention": {
        # q, k, v, o, BH, S, Sk, hd, causal, dtype, stream
        "flash_attention_fwd": (_P,) * 4 + (_I,) * 6 + (_P,),
    },
    "decode_attention": {
        # q, k, v, lengths, o, part, count, B, H, KVH, hd, S, block_s,
        # dtype, stream
        "decode_attention_fwd": (_P,) * 7 + (_I,) * 7 + (_P,),
        # q, kp, vp, table, lengths, o, part, count, B, H, KVH, hd, ps, n_pt,
        # dtype, stream
        "paged_decode_attention_fwd": (_P,) * 8 + (_I,) * 7 + (_P,),
    },
    "moe_gmm": {
        # x, w, counts, part, out, E, C, d, f, c_tile, vec, splits, dtype,
        # stream
        "moe_gmm_fwd": (_P,) * 5 + (_I,) * 8 + (_P,),
    },
    "ssd_scan": {
        # x, dt, A, Bg, Cg, y, state, B, S, nh, hp, ng, ds, chunk, hp_tile,
        # dtype, stream
        "ssd_scan_fwd": (_P,) * 7 + (_I,) * 9 + (_P,),
        # hp_tile, ds, out blocks per SM
        "ssd_scan_occupancy": (_I, _I, _P),
    },
}


def find_nvcc() -> str:
    """nvcc from ``$CUDA_HOME``, then ``PATH``, then the default toolkit."""
    home = os.environ.get("CUDA_HOME")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path(DEFAULT_CUDA_HOME) / "bin" / "nvcc")
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, "
        f"{DEFAULT_CUDA_HOME}/bin): the port's CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def build_all() -> float:
    """Build every missing library in parallel; returns the wall seconds.

    Raises ``RuntimeError`` naming the source and nvcc's output when a
    build fails. ptxas's register and shared-memory report is kept beside
    each library as ``<name>-<hash>.log``.
    """
    t0 = time.perf_counter()
    todo = [n for n in SOURCES if not library_path(n).exists()]
    if not todo:
        return 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.parent / f"{out.name}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    if name not in SIGNATURES:
        raise KeyError(f"unknown kernel library {name!r}")
    path = library_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def forbid_autograd(what: str, *tensors) -> None:
    """Raise when autograd would record a kernel call: the kernels are
    forward-only, so their outputs would carry no gradient back to their
    inputs, and the weights behind those would get none, silently. The
    training route runs plain tensor ops instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what}: a forward-only kernel called with grad mode on and an "
            "input that requires grad; training takes the plain route")


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error (no fallback)."""
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
