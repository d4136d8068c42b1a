"""Two dry runs of the port side by side, cell by cell: what a rank holds
of params, caches and batch, its peak, its counted FLOPs, and its
collectives (how many, and the all-gathers' wire bytes), before and
after, with the after run's FLOPs by torch operation and of the kernels
where it records them so.

Each directory holds the artifacts of ``python -m repro_torch.launch.dryrun``
(``artifacts/dryrun_torch/`` of a checkout). To set a change beside its
parent, unpack the parent with ``git archive`` under ``build/``, run the
sweep in both trees, then:

  python benchmarks/torch_dryrun_compare.py build/<parent>/artifacts/dryrun_torch \\
      artifacts/dryrun_torch [--shape decode_32k prefill_32k long_500k]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

GIB = 2 ** 30


def load(path: Path) -> dict:
    """(arch, shape, mesh) -> artifact, the cells that ran."""
    out = {}
    for f in sorted(path.glob("*.json")):
        art = json.loads(f.read_text())
        if art.get("status") == "ok":
            out[art["arch"], art["shape"], art["mesh"]] = art
    return out


def _parts(art) -> dict:
    """FLOPs by torch operation and, as "kernels", of the kernels; {} for
    an artifact without the breakdown."""
    cost = art["cost"]
    if "flops_by_op" not in cost:
        return {}
    return dict(cost["flops_by_op"], kernels=cost["flops_kernels"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("before", type=Path)
    ap.add_argument("after", type=Path)
    ap.add_argument("--shape", nargs="*", default=None)
    args = ap.parse_args(argv)
    before, after = load(args.before), load(args.after)
    missing = sorted(k for k in set(before) ^ set(after)
                     if not args.shape or k[1] in args.shape)
    print(f"{'cell':48s} {'params GiB before -> after':>27s} "
          f"{'caches x':>9s} {'batch x':>8s} "
          f"{'peak GiB before -> after':>26s} {'FLOPs x':>8s} "
          f"{'collectives':>13s} {'all-gather MiB':>21s}")
    for key in sorted(set(before) & set(after)):
        if args.shape and key[1] not in args.shape:
            continue
        b, a = before[key], after[key]
        hb, ha = b["memory"]["held"], a["memory"]["held"]
        ratio = (lambda x, y: f"{x / y:.4f}" if y else "-")  # noqa: E731
        cb, ca = b["collectives"], a["collectives"]
        ag = [c["by_kind"].get("all-gather", 0) / 2**20 for c in (cb, ca)]
        print(f"{' '.join(key):48s} {hb['params'] / GIB:12.3f} -> "
              f"{ha['params'] / GIB:10.3f} "
              f"{ratio(hb['caches'], ha['caches']):>9s} "
              f"{ratio(hb['batch'], ha['batch']):>8s} "
              f"{b['memory']['peak_bytes'] / GIB:11.3f} -> "
              f"{a['memory']['peak_bytes'] / GIB:10.3f} "
              f"{ratio(b['cost']['flops'], a['cost']['flops']):>8s} "
              f"{cb['n_ops']:6d} -> {ca['n_ops']:<6d}"
              f"{ag[0]:10.1f} -> {ag[1]:<10.1f}"
              + "".join(f"  {op} {n:.4e}" for op, n in _parts(a).items()))
    if missing:
        print("cells in one run only:", missing)
    return 1 if missing else 0


if __name__ == "__main__":
    raise SystemExit(main())
