#!/usr/bin/env python3
"""The readings a cell's limits are set from (``bench/workloads/<cell>.json``
records them), on the chip at the cell's own size, seeds in one process:

    python3 bench/readings.py --workload NAME --seeds S1 S2 ... \\
        [--upper] [--out FILE]

For each seed, the cell's kind (``bench/systems/<kind>``) gives the lower
readings (the program against the plain reference, as a run compares
them) and, with ``--upper``, the upper ones (the control and each fault
the kind can plant in its timed path). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

if __name__ == "__main__":                     # run as a script
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from bench import run as harness               # noqa: E402


def one_seed(cell: dict, seed: int, upper: bool, device="cuda") -> dict:
    return harness.system_module(cell).readings(cell, seed, upper, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--upper", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness._paths()
    cell = harness.load_cell(args.workload)
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        row = json.dumps(one_seed(cell, seed, args.upper))
        print(row, flush=True)
        if out:
            print(row, file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
