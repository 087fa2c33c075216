"""The program's own spans in a traced stretch: the device time and the idle time of each
call, by the `gcfr.*` span that launched them.

The port opens `gcfr.*` spans (geomconsistentfr_torch/utils/profiling.span) around the
stages of a relight call: gcfr.upload, gcfr.cnn (gcfr.cnn.encoder, gcfr.cnn.lighting_head,
gcfr.cnn.decoder_albedo, gcfr.cnn.decoder_depth), gcfr.render (gcfr.render.march) and
gcfr.pack. `program_split(run)` runs one more profiled stretch of the driver's own calls,
with the inputs and the count of its traced stretch and `host.fetch` as the driver has it,
and assigns, on the profiler's one clock:

  * each device operation (kernel, copy, set) to the innermost host span open when it was
    launched: its `correlation` joins it to its launch (a `cuda_runtime` or `cuda_driver`
    event). An operation whose launch went unrecorded takes the span of the operation
    before it on its stream, since a stream runs its operations in launch order; the
    device time assigned so is counted (`fallback_s`);
  * each idle gap of the device to the innermost host span open when the gap began, as
    core.Trace.idle_gaps does.

Host spans are every `record_function` of the trace but the stretch itself: the program's
`gcfr.*` and the harness's `entry.*` and `host.fetch`. What lies in none is 'outside_spans'.
The split is computed once a run and kept on the run's view. Where the trace holds no
`gcfr.*` span (a program that opens none), the readers of the spans give nothing.

    python -m gcfr_bench.spans --workload single_image.batch64 --seed 7 --seconds 10 [--ops-calls 4]

runs a cell's set-up, window and traced stretch on the card and prints, as one JSON line,
the cell's per-layer metrics, the split (device and idle ms a call by span), the host's ms a
call in the window and in each stretch, and with --ops-calls, each span's device ms by the
operator that launched it: the outermost aten operator around the launch and the innermost
function of the port's source on the Python stack (a stretch of that many calls under
`with_stack`). The report is for the records; no metric reads the operator split.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Optional

from gcfr_bench import core

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
OUTSIDE = "outside_spans"
PROGRAM = "gcfr."
ATTR = "_gcfr_program_split"


def _stacks_at(intervals, times) -> list:
    """For each time, the intervals (name, start, end) open at it (start <= t < end), outermost
    first. Intervals nest as a thread's spans do; the innermost is the one begun last."""
    ivs = sorted(intervals, key=lambda iv: (iv[1], -iv[2]))
    out = [None] * len(times)
    stack, i = [], 0
    for q in sorted(range(len(times)), key=times.__getitem__):
        t = times[q]
        while i < len(ivs) and ivs[i][1] <= t:
            while stack and stack[-1][2] <= ivs[i][1]:
                stack.pop()
            stack.append(ivs[i])
            i += 1
        while stack and stack[-1][2] <= t:
            stack.pop()
        out[q] = [iv[0] for iv in stack if iv[2] > t]
    return out


def _port_frame(name: str) -> Optional[str]:
    """'layers.py: leaky_relu' for a Python stack event of the port's source, else None."""
    if "geomconsistentfr_torch" not in name or ": " not in name:
        return None
    where, func = name.rsplit(": ", 1)
    return f"{os.path.basename(where.split('(')[0])}: {func}"


class Split:
    """Device and idle seconds of one profiled stretch, by host span.

    events: a torch.profiler Chrome trace's events; calls: the stretch's calls; host_seconds:
    the host's clock around them. With `ops`, each operation also carries the outermost aten
    operator around its launch and the innermost port function on the Python stack there
    (`ops_s`, by (span, operator)).
    """

    def __init__(self, events: list, calls: int, ops: bool = False, host_seconds: float = float("nan")):
        def x(cat):
            return [e for e in events if e.get("ph") == "X" and e.get("cat") in cat]

        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in x(("user_annotation",))]
        stretch = [s for s in spans if s[0] == "stretch"]
        spans = [s for s in spans if s[0] != "stretch"]
        ops_ev = x(core.DEVICE_CATS)
        if stretch:
            self.start, self.end = stretch[0][1], stretch[0][2]
        else:
            self.start = min((float(e["ts"]) for e in ops_ev), default=0.0)
            self.end = max((float(e["ts"]) + float(e.get("dur", 0.0)) for e in ops_ev), default=0.0)
        self.calls, self.host_seconds = int(calls), host_seconds
        self.names = {s[0] for s in spans}
        self.aten_ops = sum(e.get("cat") == "cpu_op" for e in events)
        launches = {}
        for e in x(LAUNCH_CATS):
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches.setdefault(corr, e)

        # Each operation's launch time, or None where its launch went unrecorded.
        launch_ts = []
        for e in ops_ev:
            ev = launches.get((e.get("args") or {}).get("correlation"))
            launch_ts.append(None if ev is None else float(ev["ts"]))
        known = [i for i, t in enumerate(launch_ts) if t is not None]
        stacks = _stacks_at(spans, [launch_ts[i] for i in known])
        span_of = [None] * len(ops_ev)
        for i, st in zip(known, stacks):
            span_of[i] = st[-1] if st else OUTSIDE
        labels = [None] * len(ops_ev)
        if ops:
            aten = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in x(("cpu_op",))]
            frames = [(f, float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                      for e in x(("python_function",)) for f in [_port_frame(e["name"])] if f]
            times = [launch_ts[i] for i in known]
            for i, a, p in zip(known, _stacks_at(aten, times), _stacks_at(frames, times)):
                labels[i] = " @ ".join([a[0] if a else "(no aten op)"] + ([p[-1]] if p else []))

        # Unrecorded launches: the span of the operation before on the same stream.
        self.fallback_s = self.unassigned_s = 0.0
        by_stream = {}
        for i, e in enumerate(ops_ev):
            by_stream.setdefault((e.get("pid"), (e.get("args") or {}).get("stream", e.get("tid"))), []).append(i)
        for idx in by_stream.values():
            idx.sort(key=lambda i: float(ops_ev[i]["ts"]))
            prev = None
            for i in idx:
                if span_of[i] is None and prev is not None:
                    span_of[i] = span_of[prev]
                    if self._inside(ops_ev[i]):
                        self.fallback_s += float(ops_ev[i].get("dur", 0.0)) / 1e6
                if span_of[i] is not None:
                    prev = i

        self.device_s, self.ops_s, self.total_s = {}, {}, 0.0
        busy = []
        for i, e in enumerate(ops_ev):
            s, d = float(e["ts"]), float(e.get("dur", 0.0))
            if s + d > self.start and s < self.end:
                busy.append((max(s, self.start), min(s + d, self.end)))
            if not self._inside(e):
                continue
            self.total_s += d / 1e6
            if span_of[i] is None:
                self.unassigned_s += d / 1e6
                continue
            self.device_s[span_of[i]] = self.device_s.get(span_of[i], 0.0) + d / 1e6
            if ops:
                key = (span_of[i], labels[i] or "(no launch record)")
                self.ops_s[key] = self.ops_s.get(key, 0.0) + d / 1e6
        merged = core.merge(busy)
        edges = [self.start] + [v for se in merged for v in se] + [self.end]
        gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
        self.idle_s = {}
        for (s, e), st in zip(gaps, _stacks_at(spans, [g[0] for g in gaps])):
            name = st[-1] if st else OUTSIDE
            self.idle_s[name] = self.idle_s.get(name, 0.0) + (e - s) / 1e6

    def _inside(self, e) -> bool:
        return self.start <= float(e["ts"]) < self.end

    def _per_call_ms(self, seconds: float) -> float:
        return 1e3 * seconds / self.calls

    def device_ms(self, *names: str) -> Optional[float]:
        """Device ms a call of the operations whose innermost span is one of `names`; None
        where none of the spans was opened."""
        if not self.names.intersection(names):
            return None
        return self._per_call_ms(sum(self.device_s.get(n, 0.0) for n in names))

    def program_idle_ms(self) -> Optional[float]:
        """Idle ms a call of the gaps that began while a `gcfr.*` span was innermost; None where
        the program opened no such span."""
        if not any(n.startswith(PROGRAM) for n in self.names):
            return None
        return self._per_call_ms(sum(v for n, v in self.idle_s.items() if n.startswith(PROGRAM)))

    def report(self) -> dict:
        """The split for the records: ms a call by span, and the shares of the device time."""
        total = self.total_s or float("nan")
        program = sum(v for n, v in self.device_s.items() if n.startswith(PROGRAM))
        out = {
            "calls": self.calls,
            "aten_ops": self.aten_ops,
            "device_ms": {n: self._per_call_ms(v) for n, v in sorted(self.device_s.items(), key=lambda kv: -kv[1])},
            "idle_ms": {n: self._per_call_ms(v) for n, v in sorted(self.idle_s.items(), key=lambda kv: -kv[1])},
            "device_sum_ms": self._per_call_ms(self.total_s),
            "stretch_ms": (self.end - self.start) / 1e3 / self.calls,
            "program_share": program / total,
            "program_or_fetch_share": (program + self.device_s.get("host.fetch", 0.0)) / total,
            "fallback_share": self.fallback_s / total,
            "unassigned_share": self.unassigned_s / total,
        }
        if self.ops_s:
            out["ops_ms"] = {f"{s} | {op}": self._per_call_ms(v)
                             for (s, op), v in sorted(self.ops_s.items(), key=lambda kv: -kv[1])}
        return out


@contextlib.contextmanager
def _spans_only():
    """While torch's profiler starts within the block, it records, of the host's operators,
    only the spans of `record_function` (RecordScope.USER_SCOPE): the device's operations and
    their launches as always, but not the aten operators, whose records would stretch the
    host's work between launches. Where torch's profiler is started otherwise, it records
    all, as the trace's `aten_ops` count then shows."""
    from torch.autograd import profiler as autograd_profiler

    try:
        from torch._C._profiler import RecordScope

        scopes = {RecordScope.USER_SCOPE}
    except ImportError:
        yield
        return
    enable = autograd_profiler._enable_profiler

    def spans_only(config, activities, *_scopes):
        enable(config, activities, scopes)

    autograd_profiler._enable_profiler = spans_only
    try:
        yield
    finally:
        autograd_profiler._enable_profiler = enable


def profiled_stretch(driver, calls: int, stack: bool = False):
    """`calls` of the driver's own calls under torch.profiler, as its traced stretch makes them:
    (the Chrome trace's events, the host's seconds). With `stack`, the aten operators and the
    Python stack are recorded too (for the operator split); without, the spans alone."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if driver.device.type == "cuda" else [])
    prof = profile(activities=acts, with_stack=stack)
    with contextlib.nullcontext() if stack else _spans_only():
        prof.start()
    try:
        with record_function("stretch"):
            t0 = core.now()
            for i in range(calls):
                out = driver._call(i % driver.n_inputs, True)
                with record_function("host.fetch"):
                    driver.free_bufs.append(driver._fetch(out))
            driver._sync()
            host = core.now() - t0
    finally:
        prof.stop()
    path = os.path.join(core.scratch_dir(), "trace.json")
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        if os.path.exists(path):
            os.remove(path)
        os.rmdir(os.path.dirname(path))
    return events, host


def program_split(run) -> Optional[Split]:
    """The run's split by span, computed at the first call and kept on the run's view. None
    without a trace, off the card (where no device operation is traced) or for a driver
    whose calls the stretch cannot repeat."""
    if not hasattr(run, ATTR):
        split = None
        drv = run.driver
        if run.trace is not None and drv.device.type == "cuda" and hasattr(drv, "_call"):
            calls = int(run.trace.info["calls"])
            events, host = profiled_stretch(drv, calls)
            split = Split(events, calls, host_seconds=host)
        setattr(run, ATTR, split)
    return getattr(run, ATTR)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--ops-calls", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    from gcfr_bench import run

    if not torch.cuda.is_available():
        print("the split needs a CUDA device", file=sys.stderr)
        return 2
    manifest = core.manifest()
    wl = core.workload(args.workload)
    drv = core.driver_module(wl["driver"]).Driver(wl, core.config(wl["config"]), args.seed, "cuda")
    drv.traced = True
    drv.setup()
    window = drv.window(args.seconds)
    tr = drv.trace(window)
    view = run.RunView(drv, window, tr, args.seconds)
    metrics = {}
    for m in run.cell_metrics(manifest, args.workload, "per_layer"):
        metrics[m["name"]] = core.metric_reader(m["name"]).read(view)
    split = program_split(view)
    cnn = [n for n in split.names if n == "gcfr.cnn" or n.startswith("gcfr.cnn.")]
    cnn_ms = split.device_ms(*cnn) + split._per_call_ms(sum(split.idle_s.get(n, 0.0) for n in cnn))
    # The cell's own split of the march's and the CNN's readings (march_ms.relight, ...), where it has them.
    march_ms, cnn_alone_ms = (next((v for k, v in metrics.items() if k.split(".")[0] == q and v), None)
                              for q in ("march_ms", "cnn_ms"))
    march_span_ms = split.device_ms("gcfr.render.march")
    out = {"workload": args.workload, "seed": args.seed, "device": torch.cuda.get_device_name(),
           "metrics": metrics,
           "host_ms_per_call": {"window": 1e3 * window["seconds"] / window["calls"],
                                "driver_stretch": 1e3 * tr.host_seconds / tr.info["calls"],
                                "split_stretch": 1e3 * split.host_seconds / split.calls},
           "split": split.report(),
           "against": {"march_span_over_march_ms": march_span_ms / march_ms if march_ms else None,
                       "cnn_spans_ms": cnn_ms,
                       "cnn_spans_over_cnn_ms": cnn_ms / cnn_alone_ms if cnn_alone_ms else None}}
    if args.ops_calls:
        events, host = profiled_stretch(drv, args.ops_calls, stack=True)
        out["ops"] = Split(events, args.ops_calls, ops=True, host_seconds=host).report()
        out["host_ms_per_call"]["ops_stretch"] = 1e3 * host / args.ops_calls
    drv.free()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
