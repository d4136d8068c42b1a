"""Emulation launcher: ``python -m repro_torch.launch.emulate [--system ...]``.

Runs the paper's consolidated-cloud experiment (same engine as
examples/emulate_cloud.py, exposed as a launcher for scripting).
"""
from __future__ import annotations

import argparse
import json

from repro_torch.core.registry import available_systems
from repro_torch.sim import run_system
from repro_torch.sim.traces import standard_workloads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--system", nargs="*",
                    choices=available_systems(),
                    default=["dcs", "ssp", "drp", "dawningcloud"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args()
    wls = standard_workloads(args.seed)
    out = {}
    for system in args.system:
        res = run_system(system, wls, mtc_fixed_nodes=166)
        out[system] = {
            "total_node_hours": res.total_node_hours,
            "peak_nodes_per_hour": res.peak_nodes_per_hour,
            "adjust_count": res.adjust_count,
            "per_workload": {k: v.as_dict()
                             for k, v in res.per_workload.items()},
        }
    if args.json:
        print(json.dumps(out, indent=1))
    else:
        for system, r in out.items():
            print(f"{system:14s} total={r['total_node_hours']:.0f} "
                  f"peak={r['peak_nodes_per_hour']} "
                  f"adjusts={r['adjust_count']}")


if __name__ == "__main__":
    main()
