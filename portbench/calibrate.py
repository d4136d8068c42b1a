"""The readings that a cell's limits are set from: the program's and the
precision control's, on many seeds, in one process.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file>]

For each seed it runs the cell as ``run.py`` does (set-up, warm-up, a
window of ``--seconds``, the sample, the reference) and then scores the
same prompts and served tokens with the reference rounded to fp8
(``reference.model``'s ``quant="fp8"``, the control) and to bf16 (the
witness): the gaps of the program's served tokens, and of the tokens
the control and the witness put first. One JSON line a seed, on
standard output and in ``--out``. The benchmark's own runs run neither.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402,F401  (paths and cache directories)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    import harness
    import serve
    spec = harness.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    t = T_START
    for seed in args.seeds:
        rec = serve.run(spec, seed, args.seconds, False, "cuda", t,
                        control="fp8", witness="bf16")
        line = {"workload": args.workload, "seed": seed,
                "setup_s": rec["setup_s"], **rec["compared"],
                "tokens_per_s": rec["window"]["tokens"]
                / rec["window"]["seconds"],
                "check_s": time.perf_counter() - t - rec["setup_s"]
                - rec["window"]["seconds"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
