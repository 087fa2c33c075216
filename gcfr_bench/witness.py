"""A second witness for a relighting cell's check: the plain reference in float64.

    python -m gcfr_bench.witness --workload <cell> --seeds 1,2,3 --seconds 3 [--far 8]

For each seed, in one process: the cell's set-up, a window of `--seconds` at
the cell's own load, the program's state freed, then the kept calls' uint8
outputs against the reference in float32 (the check's own answers) and in
float64, and the two references against each other. Of the face bytes on
which the program and the float32 reference differ by more than `--far`
levels, it counts those on which the float64 reference sides with the
program, with the float32 reference, or with neither. One JSON line per seed;
benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def answers64(drv):
    """The reference's uint8 answers for the driver's kept calls, computed in float64."""
    import torch

    net = drv.reference_net().double()
    drv._net = lambda x: net(x.double())
    want = []
    with torch.no_grad():
        for k, _ in drv.kept.items:
            want.append(drv._reference(k)[0])
    drv._net = None
    return np.concatenate(want)


def sides(got: np.ndarray, want32: np.ndarray, want64: np.ndarray, face: np.ndarray, far: int) -> dict:
    """Of the face bytes where `got` and `want32` differ by more than `far` levels, how many
    `want64` lies nearer to each (ties count as neither)."""
    g, a, b = (x.astype(np.int16) for x in (got, want32, want64))
    sel = (np.abs(g - a) > far) & face[..., None]
    to_got, to_32 = np.abs(b - g)[sel], np.abs(b - a)[sel]
    return {"far_bytes": int(sel.sum()), "with_program": int((to_got < to_32).sum()),
            "with_float32": int((to_32 < to_got).sum()), "with_neither": int((to_got == to_32).sum()),
            "float32_vs_float64_far_bytes": int(((np.abs(a - b) > far) & face[..., None]).sum())}


def witness(drv, far: int) -> dict:
    from gcfr_bench import core

    want32, face = drv.answers(False)
    got = np.concatenate([buf.numpy() for _, buf in drv.kept.items])
    want64 = answers64(drv)
    return {"program_vs_float32": core.u8_gaps(got, want32, face),
            "program_vs_float64": core.u8_gaps(got, want64, face),
            "float32_vs_float64": core.u8_gaps(want32, want64, face),
            "sides": sides(got, want32, want64, face, far)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--far", type=int, default=8)
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
        print(json.dumps({"workload": args.workload, "seed": seed, **witness(drv, args.far)}), flush=True)
        del drv
    return 0


if __name__ == "__main__":
    sys.exit(main())
