"""What a run reads from ``BENCHMARK.json`` and the benchmark's files,
and the line it prints.

A cell names a configuration and a traffic mix; the harness finds
``configs/<config>.json``, ``traffic/<traffic>.json`` and the generator
the mix names (``gen/<generator>.py``), whose ``KIND`` names the runner
module (``serve.py``). Each metric is read by
``metrics/<name>.py``'s ``read(record)``, which returns a number or
None (nothing to read); a metric whose reader returns None is left out
of the line.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, bench: dict | None = None) -> dict:
    """The workload entry of ``BENCHMARK.json`` with its configuration,
    traffic, generator module and metric entries."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    gen = importlib.import_module(f"gen.{traffic['generator']}")
    return {"cell": cell,
            "config": load_json(HERE / "configs" / f"{cell['config']}.json"),
            "traffic": traffic, "gen": gen,
            "end_to_end": metrics_of(bench, "end_to_end", workload),
            "per_layer": metrics_of(bench, "per_layer", workload)}


def metrics_of(bench: dict, kind: str, workload: str) -> list[dict]:
    """The metrics of ``kind`` that ``workload`` reports: those that list
    it, and end-to-end metrics that list no cells. Every per-layer metric
    lists its cells."""
    out = []
    for m in bench[kind]:
        if "workloads" not in m and kind == "per_layer":
            raise ValueError(f"per-layer metric {m['name']!r} lists no "
                             "workloads")
        if workload in m.get("workloads", [workload]):
            out.append(m)
    return out


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"pb_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(entries: list[dict], rec: dict) -> dict:
    out = {}
    for m in entries:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)
