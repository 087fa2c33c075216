"""The serving cell's knee: one sweep of offered rates against one server.

    python -m gcfr_bench.knee --workload single_image.serve_overload --rates 60,80,100 --seconds 10 --seed 1

For each rate, an open loop of the cell's own requests for `--seconds`; per
rate it prints the share of requests finished by a second past the window's
close, the latency quantiles (ms, timed from when each was due), the
backlog's trend (the median latency of the window's last third over its
first third's), how late the generator sent, and the server's rows a batch.
The knee is the highest rate at which it and every lower rate of the sweep
had at least 99% finished and no growing backlog (a trend under 1.5).
Benchmark runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", default="single_image.serve_overload")
    parser.add_argument("--rates", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    from gcfr_bench import core

    wl = core.workload(args.workload)
    drv = core.driver_module(wl["driver"]).Driver(wl, core.config(wl["config"]), args.seed, args.device)
    drv.setup()
    knee, passed = None, True
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            before = drv._get("/statz")
            run = drv.open_loop(rate, args.seconds, rng=np.random.default_rng([args.seed, int(rate * 1000)]))
            after = drv._get("/statz")
            lat, due = run["latency"], run["due"]
            done = due + lat
            n = len(lat)
            third = n // 3
            ok = np.isfinite(lat)
            trend = float(np.median(lat[-third:][ok[-third:]]) / np.median(lat[:third][ok[:third]]))
            finished = float(np.mean(done <= args.seconds + 1.0))
            batches = after["batches"] - before["batches"]
            row = {"rate": rate, "requests": n, "finished_share": finished, "failed": int(np.sum(~ok)),
                   "p50_ms": 1e3 * float(np.median(lat[ok])), "p95_ms": 1e3 * core.percentile(lat[ok], 95),
                   "p99_ms": 1e3 * core.percentile(lat[ok], 99), "trend": trend,
                   "late_p99_ms": 1e3 * core.percentile(run["late"], 99),
                   "rows_per_batch": (after["batched_rows"] - before["batched_rows"]) / max(batches, 1)}
            print(json.dumps(row), flush=True)
            passed = passed and finished >= 0.99 and trend < 1.5
            if passed:
                knee = rate
    finally:
        drv.free()
    print(json.dumps({"knee_req_per_s": knee}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
