"""Roofline terms per (arch x shape x mesh) from the port's dry-run
artifacts, on H100s: the counterpart of ``benchmarks/roofline.py``.

Three terms, each the seconds one rank's step would take if that
resource were its only limit (an artifact is one rank's record):

  compute     FLOPs / 989e12 bf16 FLOP/s, from the rank's counted FLOPs
              (``cost.flops``: torch's operations and the kernels'), and
              beside it from the analytic EXEC_FLOPS / chips
              (``launch.flops``, the reference's schedule);
  memory      the analytic HBM_BYTES / chips / 3.35e12 B/s;
  collective  the recorded wire bytes (``launch.comm_analysis``) over the
              link they cross: a group inside a node of 8 over NVLink, a
              group that spans nodes over the inter-node fabric.

The compute and memory peaks are ``kernels.cost``'s (H100 SXM data
sheet, ``PERF.md`` §3). The link rates are data-sheet assumptions, per
GPU and direction, not measured here:

  NVLINK_BW  450e9 B/s: NVLink 4, 18 links, 900 GB/s per GPU both ways
             together (NVIDIA H100 SXM data sheet);
  FABRIC_BW  50e9 B/s: one 400 Gb/s ConnectX-7 InfiniBand NDR port per
             GPU (NVIDIA DGX H100 data sheet: 8 ports a node).

No TPU figure carries over. The dominant term is the bottleneck; the
roofline fraction is the counted compute term over the largest term.

Usage: ``PYTHONPATH=src python -m repro_torch.launch.roofline`` after
``python -m repro_torch.launch.dryrun``.
"""
from __future__ import annotations

import json

from repro_torch.kernels.cost import PEAK_BYTES, PEAK_FLOPS
from repro_torch.launch.dryrun import ARTIFACT_DIR

PEAK_BF16 = PEAK_FLOPS["bf16"]
NVLINK_BW = 450e9      # B/s per GPU and direction, inside a node
FABRIC_BW = 50e9       # B/s per GPU and direction, across nodes
HBM_CAPACITY = 80e9    # bytes of an H100 80GB


def load_artifacts(mesh: str = "pod") -> list[dict]:
    if not ARTIFACT_DIR.is_dir():
        return []
    return [json.loads(p.read_text())
            for p in sorted(ARTIFACT_DIR.glob(f"*__{mesh}.json"))]


def roofline_row(art: dict) -> dict:
    if art.get("status") != "ok":
        return {"arch": art["arch"], "shape": art["shape"],
                "status": art.get("status"),
                "note": art.get("reason", art.get("error", ""))[:70]}
    chips = art["n_devices"]
    a, coll, mem = art["analytic"], art["collectives"], art["memory"]
    compute_s = art["cost"]["flops"] / PEAK_BF16
    memory_s = a["hbm_bytes"] / chips / PEAK_BYTES
    collective_s = (coll["wire_bytes_intra_node"] / NVLINK_BW
                    + coll["wire_bytes_cross_node"] / FABRIC_BW)
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return {
        "arch": art["arch"], "shape": art["shape"], "status": "ok",
        "chips": chips,
        "compute_s": compute_s,
        "compute_exec_s": a["exec_flops"] / chips / PEAK_BF16,
        "memory_s": memory_s, "collective_s": collective_s,
        "dominant": dominant,
        "roofline_fraction": compute_s / bound if bound else 0.0,
        "model_flops": a["model_flops"], "exec_flops": a["exec_flops"],
        "counted_flops": art["cost"]["flops"],
        "peak_gib": mem["peak_bytes"] / 2**30,
        "args_gib": mem["argument_bytes"] / 2**30,
        "fits_hbm": mem["peak_bytes"] < HBM_CAPACITY,
        "wire_nvlink_gib": coll["wire_bytes_intra_node"] / 2**30,
        "wire_fabric_gib": coll["wire_bytes_cross_node"] / 2**30,
    }


def table(mesh: str = "pod") -> list[dict]:
    return [roofline_row(a) for a in load_artifacts(mesh)]


def main() -> None:
    for mesh in ("pod", "multipod"):
        rows = table(mesh)
        if not rows:
            print(f"(no {mesh} artifacts: run python -m "
                  "repro_torch.launch.dryrun)")
            continue
        print(f"\n== H100 roofline ({mesh}, per rank) ==")
        print(f"{'arch':22s} {'shape':12s} {'comp_s':>9s} {'exec_s':>9s} "
              f"{'mem_s':>9s} {'coll_s':>9s} {'dom':>5s} {'roof%':>6s} "
              f"{'peakGiB':>8s} {'fits':>5s}")
        for r in rows:
            if r.get("status") != "ok":
                print(f"{r['arch']:22s} {r['shape']:12s} -- {r['status']}: "
                      f"{r.get('note', '')}")
                continue
            print(f"{r['arch']:22s} {r['shape']:12s} {r['compute_s']:9.4f} "
                  f"{r['compute_exec_s']:9.4f} {r['memory_s']:9.4f} "
                  f"{r['collective_s']:9.4f} {r['dominant'][:4]:>5s} "
                  f"{r['roofline_fraction']:6.1%} {r['peak_gib']:8.1f} "
                  f"{'y' if r['fits_hbm'] else 'N':>5s}")


if __name__ == "__main__":
    main()
