"""Tracing, step timing and NaN hunting (port of geomconsistentfr_tpu/utils/profiling.py).

  * `trace(log_dir)`: a context manager around `torch.profiler` (CPU
    activities, and CUDA's where a card is present) that writes a Chrome
    trace (`trace_<pid>_<time>.json`, viewable in Perfetto or
    chrome://tracing) into `log_dir` on exit. The CUDA kernels appear in it
    under their own names (stage_kernel, march_kernel, march_grad_kernel,
    cuDNN's).
  * `StepTimer`: wall-clock step time with an exponential moving average.
  * `debug_nans(enable)`: the counterpart of `jax_debug_nans`, see below.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


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


class StepTimer:
    """EMA wall-clock step timing: `with timer: ...` then `timer.ms`."""

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ms: Optional[float] = None
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = (time.perf_counter() - self._t0) * 1e3
        self.ms = dt if self.ms is None else self.decay * self.ms + (1 - self.decay) * dt
        return False

