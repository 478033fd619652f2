#!/usr/bin/env python3
"""Readings of a cell's checks over several seeds in one process, for
setting its limits (not part of a benchmark run):

    python3 benchmark/control.py --workload <name> --mode program|control \
        --seconds <s> --seeds <n> [<n> ...]

``program`` reads the program's numbers (the lower readings); ``control``
puts the reference, computed at the precision below the configuration's
(bfloat16 images and costs for the SSD chain; TF32 operands for the
perceptual search), in the program's place (the upper readings). Each
seed prints one JSON line: the seed, the requests made and every check's
reading beside its limit. Needs a CUDA device.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "control"), required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    c = harness.cell(harness.load_spec(), args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.measure(c, seed, args.seconds, False, torch.device("cuda", 0), t0,
                            control=args.mode == "control")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "attempted": r["attempted"], "correct": r["correct"],
                          "seconds": time.perf_counter() - t0, "checks": r["checks"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = ROOT
    from benchmark.env import run_environment

    os.environ.update(run_environment())
    sys.exit(main(sys.argv[1:]))
