"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. It puts ``src`` and this folder on the path,
keeps every build and kernel cache inside the checkout, refuses to run
without the cards the cell asks for, loads, warms up, measures for
``--seconds``, checks the served output against the plain reference and
prints one JSON object as the last line of its standard output: the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics
with ``--trace 1``. The numbers compared, each beside its limit, are the
last lines of its standard error and the last key of that object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "build/inductor",
          "CUDA_CACHE_PATH": "build/cuda_cache"}
for k, v in CACHES.items():
    os.environ[k] = str(ROOT / v)
os.environ["USE_FLAX"] = "0"
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import harness
    spec = harness.cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell asks for {chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_START)
    if result is None:
        return 3
    print(json.dumps(result))
    return 0


def run_cell(spec, seed, seconds, traced, device, t_start):
    """Run the cell and assemble its result line (None: a forbidden
    module was loaded)."""
    import importlib

    import torch

    import harness
    runner = importlib.import_module(spec["gen"].KIND)
    rec = runner.run(spec, seed, seconds, traced, device, t_start)
    bad = harness.forbidden_modules()
    if bad:
        print("portbench: loaded in this process: " + ", ".join(bad),
              file=sys.stderr)
        return None
    limits = spec["config"]["limits"]
    compared = {k: {"value": rec["compared"][k], "limit": limits[k]}
                for k in limits}
    correct = (rec["failed"] == 0 and all(
        None not in (c["value"], c["limit"]) and c["value"] <= c["limit"]
        for c in compared.values()))
    metrics = harness.read_metrics(
        spec["per_layer"] if traced else spec["end_to_end"], rec)
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": spec["cell"]["chips"] if on_card else 0,
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": dev}
    if traced and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        out["breakdown"] = {"device_ops": rec["trace"]["device_ops"],
                            "idle_gaps": rec["trace"]["idle_gaps"]}
    out["compared"] = compared
    info = {k: v for k, v in rec["compared"].items() if k not in compared}
    print("portbench: scored " + json.dumps(info), file=sys.stderr)
    for k, c in compared.items():
        print(f"portbench: {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    return out


if __name__ == "__main__":
    sys.exit(main())
