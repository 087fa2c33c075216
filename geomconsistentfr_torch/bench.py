"""Benchmark on the card: relit 256x256 images a second (the full forward, shadow march included).

    python -m geomconsistentfr_torch.bench

The counterpart of the root bench.py (the JAX bench, which stays as it is):
the same work, knobs and one JSON line {"metric", "value", "unit",
"vs_baseline"}. It times `Relighter.forward` (RelightNet and `render`) on
seeded random weights at batch BENCH_BATCH (64), 256x256, the golden
`ref_transfer_00104` face mask (BENCH_MASK=random: the scattered 80% mask),
at the tier BENCH_PRECISION (fast; BENCH_STRICT=1 means strict).
BENCH_COL_CHUNK sets `RenderConfig.shadow_col_chunk` (the config and the
kernels refuse a value they cannot cull with). The inputs are made on the
device once; each of BENCH_ITERS (5) timed iterations perturbs the images by
salt * 1e-7 and fetches the scalar `rendered.sum()`, after one warm-up
iteration that also builds the kernels. `torch.cuda.synchronize()` precedes
every timestamp.

vs_baseline = ours / (north_star_multiplier * cpu_reference_imgs_per_sec),
from BENCH_CPU_REF.json (the reference implementation's CPU throughput).
It runs on CUDA only and raises without a card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNIT = "images/sec/chip (256x256 full forward, 160-sample shadow march)"


def bench_config():
    """The tier and column chunk the environment asks for."""
    from geomconsistentfr_torch.config import apply_precision_tier, preset_single_image

    tier = "strict" if os.environ.get("BENCH_STRICT") == "1" else os.environ.get("BENCH_PRECISION", "fast")
    cfg = apply_precision_tier(preset_single_image(), tier)
    if os.environ.get("BENCH_COL_CHUNK"):
        chunk = int(os.environ["BENCH_COL_CHUNK"])
        cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, shadow_col_chunk=chunk))
    return tier, cfg


def run(device=None) -> dict:
    import numpy as np
    import torch

    from geomconsistentfr_torch.infer import Relighter, resolve_device
    from geomconsistentfr_torch.models.relightnet import RelightNet

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the bench times the card; got device {dev}")
    tier, cfg = bench_config()
    batch = int(os.environ.get("BENCH_BATCH", "64"))
    iters = int(os.environ.get("BENCH_ITERS", "5"))
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    rl = Relighter(cfg, state, device=dev)

    rng = np.random.default_rng(0)
    images = torch.as_tensor(rng.uniform(0, 1, (batch, 256, 256, 3)), dtype=torch.float32, device=dev)
    if os.environ.get("BENCH_MASK", "face") == "random":
        mask = (rng.uniform(0, 1, (256, 256)) > 0.2).astype(np.float32)
    else:
        mask = np.load(ROOT / "tests" / "golden" / "ref_transfer_00104.npz")["mask"]
    masks = torch.as_tensor(mask, device=dev).expand(batch, 256, 256).contiguous()
    lights = torch.tensor([[0.3, 0.4, 0.8660254]], device=dev).expand(batch, 3).contiguous()

    def forward(salt: float) -> float:
        return float(rl.forward(images + salt * 1e-7, masks, lights).rendered.sum())

    forward(0.0)  # builds the kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        forward(float(i + 1))
    torch.cuda.synchronize()
    imgs_per_sec = batch * iters / (time.perf_counter() - t0)

    ref = json.loads((ROOT / "BENCH_CPU_REF.json").read_text())
    target = ref["north_star_multiplier"] * ref["cpu_reference_imgs_per_sec"]
    return {
        "metric": "relight_throughput",
        "value": round(imgs_per_sec, 3),
        "unit": UNIT,
        "vs_baseline": round(imgs_per_sec / target, 3),
        "tier": tier,
        "batch": batch,
        "device": torch.cuda.get_device_name(dev),
    }


def main() -> int:
    print(json.dumps(run()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
