"""The paper's experiment end-to-end on the port: consolidate two HTC
providers (NASA, BLUE) and one MTC provider (Montage) on one cloud
platform and compare the usage models (``examples/emulate_cloud.py`` on
``repro_torch``): the paper's four (DCS / SSP / DRP / DawningCloud-DSP)
plus any scenario registered with ``repro_torch.core.registry``
(``--all`` runs every registered system, e.g. the beyond-paper
``dawningcloud-backfill`` mix). The emulator is host code: no card.

  PYTHONPATH=src python examples/emulate_cloud_torch.py [--policy-set paper|tuned]
"""
from __future__ import annotations

import argparse

from repro_torch.core.policy import MgmtPolicy
from repro_torch.core.registry import available_systems
from repro_torch.sim import run_system
from repro_torch.sim.traces import standard_workloads

POLICIES = {
    "paper": {"nasa": MgmtPolicy.htc(40, 1.2), "blue": MgmtPolicy.htc(80, 1.5),
              "montage": MgmtPolicy.mtc(10, 8.0)},
    "tuned": {"nasa": MgmtPolicy.htc(40, 1.0), "blue": MgmtPolicy.htc(40, 1.0),
              "montage": MgmtPolicy.mtc(10, 8.0)},
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy-set", default="tuned", choices=list(POLICIES))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--all", action="store_true",
                    help="run every registered system, not just the paper's")
    args = ap.parse_args(argv)
    wls = standard_workloads(args.seed)
    print("workloads:")
    for wl in wls:
        print(f"  {wl.name:8s} {wl.kind} jobs={len(wl.jobs):5d} "
              f"platform={wl.trace_nodes} util={wl.utilization():.1%}")
    systems = (available_systems() if args.all
               else ("dcs", "ssp", "drp", "dawningcloud"))
    results = {}
    for system in systems:
        results[system] = run_system(
            system, wls, policies=POLICIES[args.policy_set],
            mtc_fixed_nodes=166)
    print(f"\n{'system':22s} {'total node*h':>12s} {'peak/h':>7s} "
          f"{'adjusts':>8s}")
    for system, res in results.items():
        print(f"{system:22s} {res.total_node_hours:>12.0f} "
              f"{res.peak_nodes_per_hour:>7d} {res.adjust_count:>8d}")
    dc = results["dawningcloud"].total_node_hours
    print(f"\nDawningCloud saves {1 - dc/results['dcs'].total_node_hours:.1%}"
          f" vs DCS/SSP and {1 - dc/results['drp'].total_node_hours:.1%} vs"
          f" DRP\n=> the MTC/HTC providers and the resource provider all"
          f" benefit from the economies of scale (paper's conclusion).")
    return results


if __name__ == "__main__":
    main()
