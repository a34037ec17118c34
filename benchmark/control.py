"""Readings that set a cell's limits, made on the card: the program, its
control (the lower precision the cell's ``workloads/<cell>.json`` names)
or a planted fault (``faults.py``), over several seeds in one process.

    python3 benchmark/control.py --workload <cell> --variant program|control|<fault> \\
        --seeds 1,2,3 [--seconds 5] [--trace 0|1]

Prints one JSON line per seed: the seed, the variant and the run's
result (its ``checks`` hold the compared numbers). The benchmark's own
runs never run this.
"""

import os
import sys

sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

from benchmark import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--variant", default="program")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--trace", type=int, default=0)
    args = ap.parse_args()
    harness.set_cache_dirs()
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                             variant=args.variant)
        print(json.dumps({"seed": seed, "variant": args.variant, "workload": args.workload,
                          "wall_s": time.perf_counter() - t0, "result": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
