"""What every cell shares: its files, seeded weights and inputs, the trace's
reduction, the comparison's arithmetic and the result line.

A cell is found by name: `workloads/<cell>.json` names its configuration
(`configs/<config>.json`), its driver (`drivers/<driver>.py`) and its
traffic parameters; a per-layer metric named in BENCHMARK.json is read by
`metrics/<metric>.py`, or for `<quantity>.<split>` without a file of its own,
by `metrics/<quantity>.py`. Adding a cell, a configuration or a metric adds
files.

To add a cell, add:

1. `workloads/<cell>.json`: its configuration, driver, chips, why, traffic
   parameters and the limits of its `check`;
2. `tests/sizes/<cell>.json`: the sizes at which the tests run it, `small` on
   the CPU and `card` on the card, and `entry`, the Relighter method whose
   output it fetches and checks (or null); the tests find it by name;
3. where they are new: `configs/<config>.json` (the configuration as run,
   with its source, `reduced` and `assumed`) and `drivers/<driver>.py`
   (traffic, timed call, work counts and the reference's answers, with the
   reference itself under `reference/`);
4. where they are new: `metrics/<metric>.py`, one reader a per-layer metric;
5. last, the cell's entries in BENCHMARK.json: the configuration, the
   workload, the cell's name under each end-to-end metric it reports, and
   its per-layer metrics.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import statistics
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "geomconsistentfr_tpu")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def workload(name: str) -> dict:
    return read_json(BENCH / "workloads" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def driver_module(name: str):
    return importlib.import_module(f"gcfr_bench.drivers.{name}")


def metric_reader(name: str):
    """The module `metrics/<name>.py`, or where there is none, the reader of the name with
    its last dotted part dropped: `idle_pct.sweep` is read by `metrics/idle_pct.py`, one
    quantity's reader for each of the end-to-end metrics it is split by."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        return metric_reader(name.rsplit(".", 1)[0])
    spec = importlib.util.spec_from_file_location(f"gcfr_bench.metrics.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules(modules) -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def scratch_dir() -> str:
    """A fresh directory under TMPDIR for this run's files (a trace, a checkpoint)."""
    return tempfile.mkdtemp(prefix="gcfr_bench_", dir=os.environ.get("TMPDIR") or None)


# ---------------------------------------------------------------------------
# Seeded weights and inputs
# ---------------------------------------------------------------------------

def seeded_state_dict(module_cls, seed: int, device, **kwargs) -> dict:
    """A state dict for `module_cls(**kwargs)`'s parameter names: torch's default
    init (uniform within +-1/sqrt(fan_in)) for convolutions and linears, BatchNorm
    at identity, drawn on `device` from one generator in one call, float32."""
    import torch
    from torch import nn

    with torch.device("meta"):
        template = module_cls(**kwargs)
    leaves = []
    for mname, m in template.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            for pname, p in (("weight", m.weight), ("bias", m.bias)):
                if p is not None:
                    leaves.append((f"{mname}.{pname}", tuple(p.shape), 1.0 / fan_in ** 0.5))
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(int(np.prod(s)) for _, s, _ in leaves), generator=gen, device=device)
    flat = flat.mul_(2.0).sub_(1.0)
    state, at = {}, 0
    for name, shape, bound in leaves:
        n = int(np.prod(shape))
        state[name] = flat[at:at + n].view(shape).mul(bound)
        at += n
    for mname, m in template.named_modules():
        if isinstance(m, nn.BatchNorm2d):
            c = m.num_features
            state[f"{mname}.weight"] = torch.ones(c, device=device)
            state[f"{mname}.bias"] = torch.zeros(c, device=device)
            state[f"{mname}.running_mean"] = torch.zeros(c, device=device)
            state[f"{mname}.running_var"] = torch.ones(c, device=device)
            state[f"{mname}.num_batches_tracked"] = torch.zeros((), dtype=torch.long, device=device)
    return state


def faces(device=None, size: int = 256):
    """The ten faces of the benchmark's data file: dict of uint8 image (10, S, S, 3),
    uint8 mask (10, S, S), uint8 grey albedo and float16 depth (the reference
    model's own outputs for them, kept as pseudo ground truth). The file holds
    them at 256x256; a smaller `size` (the CPU tests') takes every k-th pixel."""
    import torch

    with np.load(BENCH / "data" / "faces.npz") as z:
        step = z["image"].shape[1] // size
        out = {k: np.ascontiguousarray(z[k][:, ::step, ::step]) for k in ("image", "mask", "albedo_gray", "depth")}
    if device is None:
        return out
    return {k: torch.as_tensor(v).to(device) for k, v in out.items()}


def seeded_lights(gen, n: int, device, z_min: float = 0.5):
    """n unit light directions (n, 3) with z >= z_min, uniform over that cap."""
    import torch

    z = z_min + (1.0 - z_min) * torch.rand(n, generator=gen, device=device)
    phi = 2.0 * np.pi * torch.rand(n, generator=gen, device=device)
    r = torch.sqrt(1.0 - z * z)
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def jittered_faces(gen, face_ids, device, levels: int, size: int = 256):
    """(uint8 images, uint8 masks) of the faces `face_ids` (a tensor on `device`),
    each image moved by a seeded jitter of at most `levels` per byte."""
    import torch

    f = faces(device, size)
    img = f["image"][face_ids].to(torch.int16)
    noise = torch.randint(-levels, levels + 1, img.shape, generator=gen, device=device, dtype=torch.int16)
    return (img + noise).clamp_(0, 255).to(torch.uint8), f["mask"][face_ids]


class Reservoir:
    """A uniform sample of k items from a stream of unknown length, drawn from a seed."""

    def __init__(self, k: int, seed):
        self.k, self.items, self.seen = k, [], 0
        self.rng = np.random.default_rng(seed)

    def offer(self, item) -> Optional[object]:
        """Keep `item` or not; returns what was dropped (an evicted item, or `item`)."""
        n, self.seen = self.seen, self.seen + 1
        if n < self.k:
            self.items.append(item)
            return None
        j = int(self.rng.integers(0, n + 1))
        if j < self.k:
            old, self.items[j] = self.items[j], item
            return old
        return item


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device operations and the benchmark's host spans of one traced stretch.

    From a torch.profiler chrome trace: device operations (kernels, copies,
    sets) as (name, start_us, dur_us); the spans the harness opened with
    `record_function` as (name, start_us, end_us); the stretch is the span
    named 'stretch'. `calls` and the work fields are set by the driver.
    """

    def __init__(self, events: list, host_seconds: float):
        self.ops = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
                    for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
        stretch = [s for s in spans if s[0] == "stretch"]
        if stretch:
            self.start, self.end = stretch[0][1], stretch[0][2]
        else:
            self.start = min((s for _, s, _ in self.ops), default=0.0)
            self.end = max((s + d for _, s, d in self.ops), default=0.0)
        self.spans = [s for s in spans if s[0] != "stretch"]
        self.host_seconds = host_seconds
        self.busy = merge([(max(s, self.start), min(s + d, self.end)) for _, s, d in self.ops
                           if s + d > self.start and s < self.end])
        self.info: dict = {}

    @staticmethod
    def from_profiler(prof, host_seconds: float) -> "Trace":
        path = os.path.join(scratch_dir(), "trace.json")
        prof.export_chrome_trace(path)
        try:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
            os.rmdir(os.path.dirname(path))
        return Trace(events, host_seconds)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e6

    def device_seconds(self, match) -> float:
        """Seconds of device operations whose name `match` accepts, inside the stretch."""
        return sum(d for n, s, d in self.ops if match(n) and self.start <= s < self.end) / 1e6

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for n, s, d in self.ops:
            if self.start <= s < self.end:
                key = n[:96]
                by[key] = by.get(key, 0.0) + d / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time by the innermost benchmark span open on the host when it began."""
        edges = [self.start] + [x for se in self.busy for x in se] + [self.end]
        by = {}
        for s, e in zip(edges[0::2], edges[1::2]):
            if e <= s:
                continue
            open_ = [sp for sp in self.spans if sp[1] <= s < sp[2]]
            name = min(open_, key=lambda sp: sp[2] - sp[1])[0] if open_ else "outside_spans"
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:top]


# ---------------------------------------------------------------------------
# Comparisons and statistics
# ---------------------------------------------------------------------------

def quartile_spread(values) -> float:
    """(Q3 - Q1) / median, with statistics.quantiles' quartiles."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order statistics."""
    return float(np.percentile(np.asarray(values, np.float64), q))


def u8_gaps(got: np.ndarray, want: np.ndarray, face: np.ndarray) -> dict:
    """Levels by which uint8 outputs differ, over each image's face pixels.

    got, want (N, H, W, C) uint8; face (N, H, W) bool. Returns the worst
    image's share of face bytes off by more than one level, the mean gap in
    levels over every face byte, and the share of face bytes that differ at
    all (which a few pixels far off, as at a shadow's edge, barely move).
    """
    gap = np.abs(got.astype(np.int16) - want.astype(np.int16))
    f = face[..., None]
    off = ((gap > 1) & f).reshape(len(gap), -1).sum(axis=1) / (f.reshape(len(gap), -1).sum(axis=1) * gap.shape[-1])
    n_bytes = f.sum() * gap.shape[-1]
    return {"worst_image_off_by_2": float(off.max()),
            "mean_gap": float((gap * f).sum() / n_bytes),
            "moved_share": float(((gap > 0) & f).sum() / n_bytes)}


class Verdict:
    """Numbers compared with their limits; `correct` when each is within its own."""

    def __init__(self):
        self.rows = []

    def add(self, name: str, value: float, limit: float) -> None:
        self.rows.append((name, float(value), float(limit)))

    @property
    def correct(self) -> bool:
        return bool(self.rows) and all(np.isfinite(v) and v <= lim for _, v, lim in self.rows)

    def as_dict(self) -> dict:
        return {n: {"value": v, "limit": lim} for n, v, lim in self.rows}


def now() -> float:
    return time.perf_counter()
