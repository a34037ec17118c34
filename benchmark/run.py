"""Run one benchmark cell once and print its result as the last line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Exits 1 without a result where no card is
visible, the cell's files or the program are missing, or the process
loaded JAX or the JAX package.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT   # the package, not this folder's modules one by one

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    harness.set_cache_dirs()
    sys.exit(harness.main(t_start=harness.process_start()))
