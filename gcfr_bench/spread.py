"""Spreads of a cell's runs, for its bounds: the quartile spread of each metric over a set.

    python -m gcfr_bench.spread set1/*.out -- set2/*.out

Each file holds one run's standard output; its last line is the result. For
each metric it prints each set's median and spread, (Q3 - Q1) / median with
statistics.quantiles' quartiles, and five times the wider spread (the bound
it suggests, never under 1%).
"""

from __future__ import annotations

import json
import statistics
import sys

from gcfr_bench import core


def read(paths):
    by = {}
    for p in paths:
        with open(p) as f:
            r = json.loads(f.read().strip().splitlines()[-1])
        for k, v in r["metrics"].items():
            by.setdefault(k, []).append(v["value"])
    return by


def main(argv) -> int:
    sets = [s.split() for s in " ".join(argv).split(" -- ")]
    read_sets = [read(s) for s in sets]
    for name in sorted(set().union(*read_sets)):
        spreads = []
        for i, by in enumerate(read_sets):
            v = by.get(name, [])
            if len(v) >= 2:
                spreads.append(core.quartile_spread(v))
                print(f"{name} set {i + 1}: n={len(v)} median {statistics.median(v)!r} spread {spreads[-1]!r}")
        if spreads:
            print(f"{name}: widest spread {max(spreads)!r}, bound at 5x {max(0.01, 5 * max(spreads))!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
