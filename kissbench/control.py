"""The control of a cell's comparison: the plain reference put in the
program's place one step short (a sort one doubling short, an index on a
suffix array sorted to 256 characters where the order is full, a backward
search one LF step short), compared by the cell's own check. Every number
the control reads must fail its limit on some seed; the benchmark's runs
never run this.

    python -m kissbench.control --workload <name> --seeds 1,2,3

prints one JSON line a seed: ``{"seed": s, "checks": {name: {"value",
"limit"}}, "fails": bool}``, then ``{"all_fail": bool}``.
"""

from __future__ import annotations

import argparse
import json
import sys

from kissbench.run import Bench, parse_device


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m kissbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated run seeds")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--root", default=None)
    args = p.parse_args(argv)
    bench = Bench.load(args.root, args.workload)
    device = parse_device(args.device, int(bench.workload["chips"]))
    if device is None:
        return 2
    from kissbench.cell import Context

    entry = bench.module("entries", bench.traffic["entry"])
    every = True
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(args.workload, bench.config, bench.traffic, seed,
                      device)
        checks = entry.Cell(ctx).control()
        fails = any(c.value > c.limit for c in checks)
        every &= fails
        print(json.dumps({
            "seed": seed, "fails": fails,
            "checks": {c.name: {"value": c.value, "limit": c.limit}
                       for c in checks}}), flush=True)
    print(json.dumps({"all_fail": every}), flush=True)
    return 0 if every else 1


if __name__ == "__main__":
    sys.exit(main())
