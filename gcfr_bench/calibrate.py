"""The readings a cell's limits are set from: the program's numbers and its control's, on many seeds.

    python -m gcfr_bench.calibrate --workload <cell> --seeds 1,2,3 --seconds 3 [--faults]

For each seed, in one process: the cell's set-up, a window of `--seconds` at
the cell's own load, the program's state freed, then the numbers `correct`
compares, for the program (the lower readings) and for the control, the
reference in the next precision below the configuration's in the
program's place (the upper readings). With `--faults` a training cell also
reads the faults its program can have. One JSON line per seed; benchmark runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--faults", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from gcfr_bench import core

    wl = core.workload(args.workload)
    cfg = core.config(wl["config"])
    for seed in (int(s) for s in args.seeds.split(",")):
        drv = core.driver_module(wl["driver"]).Driver(wl, cfg, seed, args.device)
        drv.setup()
        drv.window(args.seconds)
        drv.free()
        verdict = drv.check()
        row = {"workload": args.workload, "seed": seed, "program": drv.gaps,
               "control": drv.control()}
        if args.faults and hasattr(drv, "faults"):
            row["faults"] = drv.faults()
        print(json.dumps(row), flush=True)
        del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
