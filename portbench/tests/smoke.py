"""A cell of ``BENCHMARK.json`` shrunk to a size the CPU tests can run:
the same files, generator and reference, with the model's widths and the
traffic's lengths cut. Used by the tests only."""
from __future__ import annotations

import contextlib
import itertools
import sys
import time
from pathlib import Path
from types import SimpleNamespace

HERE = Path(__file__).resolve().parent
for p in (HERE.parent, HERE.parent.parent / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

import harness  # noqa: E402

SIZES = {"small": dict(n_layers=2, d_model=64, n_heads=4, head_dim=16,
                       d_ff=128, vocab_size=256),
         # wide enough for the fp8 control's error to stand clear of
         # bf16's on every seed tried
         "wide": dict(n_layers=4, d_model=256, n_heads=4, head_dim=64,
                      d_ff=512, vocab_size=256)}


# cells whose files are under portbench/ but whose entries wait for a
# later benchmark PR (PERF.md, Open questions): tested all the same
LATER = [{"name": "musicgen-large.montage-backlog",
          "config": "musicgen-large", "traffic": "montage-backlog",
          "chips": 1}]


def bench() -> dict:
    """``BENCHMARK.json`` with the cells of ``LATER`` it lacks."""
    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    have = {w["name"] for w in b["workloads"]}
    b["workloads"] += [w for w in LATER if w["name"] not in have]
    return b


def spec(cell: str, dtype: str = "bfloat16", size: str = "small") -> dict:
    s = harness.cell_spec(cell, bench())
    m = s["config"]["model"]
    kv = 4 if m["n_kv_heads"] == m["n_heads"] else 2
    m.update(SIZES[size], n_kv_heads=kv, dtype=dtype)
    if m.get("n_experts"):
        # C = T, as at full size: no token is dropped
        m.update(n_experts=8, d_ff_expert=64, capacity_factor=4.0)
    s["config"]["serve"] = {"max_batch": 4, "max_len": 128, "page_size": 16,
                            "prefill_tokens_per_step": 1536}
    t = s["traffic"]
    # outputs of about 11 tokens, not 66: the sample is cut to 12
    # requests with them, or the worst request's mean gap reads what one
    # rounding flip in a handful of tokens does (the bf16 witness reads
    # the same there)
    t.update(prompt={"median": 12, "sigma": 0.5, "min": 4, "max": 32},
             tokens_per_paper_second=1.0, warmup_steps=4,
             sample_max_requests=12)
    return s


@contextlib.contextmanager
def ticking_clock(tick: float = 1e-3):
    """The runner's clock advanced by ``tick`` seconds a reading, so a
    window holds the same steps on any host and a test's sample of
    finished requests is the same on every run."""
    import serve
    ticks = itertools.count()
    saved = serve.time
    serve.time = SimpleNamespace(perf_counter=lambda: next(ticks) * tick)
    try:
        yield
    finally:
        serve.time = saved


def run(cell: str, seed: int = 2**31 + 11, seconds: float = 0.2,
        dtype: str = "bfloat16", control=None, size: str = "small"):
    """The record of one run of the shrunk cell on the CPU, a window of
    ``seconds`` on the ticking clock."""
    import serve
    with ticking_clock():
        return serve.run(spec(cell, dtype, size), seed, seconds, False,
                         "cpu", 0.0, control=control)
