#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``benchmark/harness.py``).
Exits non-zero, with no result, without the CUDA devices the cell asks
for, without the program in the checkout, or if JAX was loaded.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path[0] = ROOT
    from benchmark.env import run_environment

    os.environ.update(run_environment())
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], T_START))
