"""The serving cell's server process: `geomconsistentfr_torch.serve` as it is, plus what
the benchmark reads of it from outside.

    python -m gcfr_bench.drivers.serve_child <record.json> [--profile] -- <serve's arguments>

With --profile the profiler's tracing library loads at start-up; then
SIGUSR1 starts torch.profiler (device activity) and SIGUSR2 stops it and
writes the stretch's device busy seconds, length and top operations to
<record.json>.trace; at exit the process's peak of allocated device memory,
and the modules it loaded whose top-level name is JAX's or the JAX package's,
go to <record.json>. Without the signals the server runs untouched.
GCFR_BENCH_FAULT=answer_altered or =forbidden_module plants one of the
benchmark's tests' faults.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
import types

import torch

from gcfr_bench import core


def plant_altered_answer() -> None:
    """The benchmark's tests' fault: every batch's first reply altered where it is produced."""
    from geomconsistentfr_torch.infer import Relighter

    produce = Relighter.forward_visuals

    def altered(self, *args, **kwargs):
        out = produce(self, *args, **kwargs).clone()
        out[0] ^= 64
        return out

    Relighter.forward_visuals = altered


def main(argv) -> int:
    record, args = argv[0], argv[argv.index("--") + 1:]
    prof = {}
    if "--profile" in argv[:argv.index("--")]:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):  # loads CUPTI now, not inside the window
            pass

    def start(signum, frame):
        from torch.profiler import ProfilerActivity, profile

        prof["p"] = profile(activities=[ProfilerActivity.CUDA])
        prof["p"].__enter__()
        prof["t0"] = time.perf_counter()

    def stop(signum, frame):
        p = prof.pop("p", None)
        if p is None:
            return
        host = time.perf_counter() - prof["t0"]
        p.__exit__(None, None, None)
        tr = core.Trace.from_profiler(p, host)
        out = {"busy_s": tr.busy_s, "window_s": host, "device_ops": tr.device_ops()}
        with open(record + ".trace", "w") as f:
            json.dump(out, f)

    signal.signal(signal.SIGUSR1, start)
    signal.signal(signal.SIGUSR2, stop)
    fault = os.environ.get("GCFR_BENCH_FAULT")
    if fault == "answer_altered":
        plant_altered_answer()
    elif fault == "forbidden_module":
        sys.modules["jax"] = types.ModuleType("jax")
    from geomconsistentfr_torch import serve

    rc = serve.main(args)
    with open(record, "w") as f:
        json.dump({"memory_peak_bytes": torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0,
                   "kind": torch.cuda.get_device_name() if torch.cuda.is_available() else "cpu",
                   "forbidden": core.forbidden_modules(sys.modules)}, f)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
