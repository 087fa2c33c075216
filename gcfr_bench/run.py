"""Run one cell of the benchmark once and print its result as the last line.

    python -m gcfr_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is BENCHMARK.json's workload of that name; its file
`gcfr_bench/workloads/<cell>.json` names the configuration, the driver and the
traffic. A run makes its weights and inputs from the seed, warms up the
cell's own shapes (set-up), measures for `--seconds`, and then, with the
program's state freed, checks what the timed path produced against the plain
reference (`gcfr_bench/reference`). With `--trace 0` the metrics are the
cell's end-to-end metrics; with `--trace 1` a steady stretch runs under
torch.profiler after the window (the serving cell's server profiles itself
from a few seconds before the window's close until its last reply) and the
metrics are the cell's per-layer metrics, each read by
`gcfr_bench/metrics/<name>.py`.

The last line of standard output is one JSON object: correct, attempted,
failed, metrics, device, (traced) breakdown, and `check`, each compared
number with its limit, which also end standard error. It exits non-zero,
printing no result, without CUDA, with fewer cards than the cell asks for,
or when JAX or the JAX package is loaded once the window has closed.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


class RunView:
    """What a per-layer metric's reader sees: the driver, the window's record and the trace."""

    def __init__(self, driver, window, trace, seconds):
        self.driver, self.window, self.trace, self.seconds = driver, window, trace, seconds


def merge(target: dict, changes: dict) -> None:
    for key, value in changes.items():
        if isinstance(value, dict) and isinstance(target.get(key), dict):
            merge(target[key], value)
        else:
            target[key] = value


def cell_metrics(manifest: dict, cell: str, kind: str) -> list:
    """The manifest's `end_to_end` or `per_layer` entries that this cell reports."""
    return [m for m in manifest[kind] if "workloads" not in m or cell in m["workloads"]]


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device: str = "cuda", t0=None,
             overrides=None, manifest=None) -> dict:
    """One run of `cell`: the result object (without the process-level checks).

    `overrides` ({"workload": {...}, "config": {...}}, merged into the files'
    dicts key by key) lets the tests run a cell at a size the CPU holds;
    `device` 'cpu' runs the program's plain paths there.
    """
    from gcfr_bench import core

    t0 = _T0 if t0 is None else t0
    manifest = manifest or core.manifest()
    wl = core.workload(cell)
    cfg = core.config(wl["config"])
    merge(wl, (overrides or {}).get("workload") or {})
    merge(cfg, (overrides or {}).get("config") or {})
    drv = core.driver_module(wl["driver"]).Driver(wl, cfg, seed, device)
    drv.traced = trace
    try:
        drv.setup()
        setup_s = core.now() - t0
        window = drv.window(seconds)
        peak = drv.memory_peak()
    except BaseException:
        drv.free()  # stops what the driver started (the server process)
        raise
    metrics, breakdown, dev = {}, None, drv.device_info()
    dev["memory_peak_bytes"] = int(peak)
    if trace:
        tr = drv.trace(window)
        view = RunView(drv, window, tr, seconds)
        for m in cell_metrics(manifest, cell, "per_layer"):
            value = core.metric_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if tr is not None:
            dev["busy_s"], dev["window_s"] = tr.busy_s, tr.window_s
            breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    else:
        values = {"setup_s": setup_s, **window["metrics"]}
        for m in cell_metrics(manifest, cell, "end_to_end"):
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    drv.free()
    verdict = drv.check()
    result = {"correct": verdict.correct, "attempted": int(window["attempted"]), "failed": int(window["failed"]),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = verdict.as_dict()
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from gcfr_bench import core

    manifest = core.manifest()
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; BENCHMARK.json has {sorted(cells)}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cells[args.workload]["chips"]:
        print(f"{args.workload} needs {cells[args.workload]['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), manifest=manifest)
    found = core.forbidden_modules(sys.modules)
    if found:
        print(f"the run loaded {found}: the benchmark measures the PyTorch port alone", file=sys.stderr)
        return 3
    for name, row in result["check"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
