"""Tracing and NaN hunting (port of geomconsistentfr_tpu/utils/profiling.py).

  * `trace(log_dir)`: a context manager around `torch.profiler` (CPU
    activities, and CUDA's where a card is present) that writes a Chrome
    trace (`trace_<pid>_<time>.json`, viewable in Perfetto or
    chrome://tracing) into `log_dir` on exit. The CUDA kernels appear in it
    under their own names (stage_kernel, march_kernel, march_grad_kernel,
    cuDNN's).
  * `span(name)`: the program's named spans (`gcfr.*`), which a profiler's
    trace shows on the host's timeline, on the clock of the device's
    kernels and copies; with no profiler recording they cost one check.
  * `COUNTS`, `count(name, n)`: the program's counters beside its spans,
    counted alike whether or not a profiler records: detect.frames,
    detect.candidates (rows past S3FD's candidate threshold), detect.kept
    (boxes past NMS and the score threshold), detect.d2h_bytes (what
    detection copies to the host) and crop.skipped (frames that gave
    `Relighter.relight_frames` no crop). A reader takes the difference of two
    snapshots.
  * `debug_nans(enable)`: the counterpart of `jax_debug_nans`, see below.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


_NO_SPAN = contextlib.nullcontext()

COUNTS = dict.fromkeys(("detect.frames", "detect.candidates", "detect.kept", "detect.d2h_bytes", "crop.skipped"), 0)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of COUNTS (one of its keys)."""
    COUNTS[name] += int(n)


def span(name: str):
    """A `record_function` span named `name` while a profiler records, else one shared
    no-op context (a `record_function` costs about ten times the check even with the
    profiler off). The relight path's spans: gcfr.upload, gcfr.cnn (its stages
    gcfr.cnn.encoder, gcfr.cnn.lighting_head, gcfr.cnn.decoder_albedo and
    gcfr.cnn.decoder_depth), gcfr.render (its march gcfr.render.march) and gcfr.pack;
    the detect-and-crop path's (`Relighter.relight_frames`, before it relights): gcfr.detect.prep,
    gcfr.detect.trunk, gcfr.detect.decode, gcfr.detect.nms and gcfr.crop; the training step's: gcfr.train.batch, gcfr.train.forward, gcfr.train.backward and
    gcfr.train.optimizer."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block; its Chrome trace goes to a new file in `log_dir`."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)


def _first_nan(out) -> Optional[str]:
    """Where a module's output (a tensor, or tensors in tuples, lists, dicts
    and named tuples) holds a NaN: a description, or None."""
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() and bool(torch.isnan(out).any()):
            return f"{tuple(out.shape)} {out.dtype}"
        return None
    items = out.items() if isinstance(out, dict) else enumerate(out) if isinstance(out, (tuple, list)) else ()
    for key, value in items:
        found = _first_nan(value)
        if found:
            return f"[{key}] {found}"
    return None


def _raise_on_nan(module, _inputs, output):
    found = _first_nan(output)
    if found:
        raise FloatingPointError(f"NaN in the output of {type(module).__name__}: {found}")


_NAN_HOOK = None


def debug_nans(enable: bool = True) -> None:
    """Stop at the first NaN: `torch.autograd.set_detect_anomaly(enable)` and a
    forward hook on every nn.Module that raises FloatingPointError at the
    first module output holding a NaN.

    What this catches: a NaN (or an error) made by any backward function --
    anomaly mode raises there and prints the traceback of the forward op that
    recorded it -- and a NaN in the output of any module's forward
    (RelightNet, PatchGAN, their layers), named by the module's class.

    What JAX's `jax_debug_nans` catches that this does not: a NaN made in the
    forward by an op outside every module (the renderer, the losses, SSIM)
    is seen only when it reaches a module or the backward, not at the op
    that made it; and JAX checks every primitive's output, optimizer updates
    included, where a NaN that Adam writes into a parameter shows here only
    at the next forward. Infinities are not checked (jax_debug_infs is a
    separate flag there too). Both checks cost a host sync per module
    output and a slower backward: for fault isolation, not for timing.
    """
    global _NAN_HOOK
    torch.autograd.set_detect_anomaly(enable)
    if enable and _NAN_HOOK is None:
        _NAN_HOOK = torch.nn.modules.module.register_module_forward_hook(_raise_on_nan)
    elif not enable and _NAN_HOOK is not None:
        _NAN_HOOK.remove()
        _NAN_HOOK = None

