#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (geomconsistentfr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. device   CUDA is required (no CPU fallback); the card's name and power
              limit as nvidia-smi reports them.
  2. build    every kernel of the port is compiled from csrc/ (nvcc, sm_90a).
  3. march    the march kernel vs its plain PyTorch version on the card:
              256x256, batch 8, the golden fixtures' depth maps and face
              masks, 160 and 159 samples, both vetoes, cull off/row/col-32,
              all three gates.
  4. golden   the ten golden fixtures rendered through the kernel at the
              strict tier, against the reference outputs they store.
  5. e2e      Relighter.forward at full width (batch 64, 256x256,
              preset_single_image) at the strict and fast tiers with random
              weights from a seeded torch.Generator: img/s (median of five
              windows), finite outputs, kernel launch counts, and the
              forward's min distances and rendered image against the plain
              march on the same batch.
  6. timing   each kernel's time per launch beside its bound and its plain
              version's time, at the main path's shapes, after holding the
              two outputs against each other.
Then the `kernels` JSON line, the nvidia-smi line, and, last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Bars (march and golden) are those of tests/test_torch_shadows.py and
tests/test_torch_render.py.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"

# Published H100 SXM peaks (dense, no sparsity) used for bounds.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Float32 operations per live pixel-sample of the march kernel, counted from
# csrc/march.cu (an FMA counts 2; min, max, floor, ceil, rint and compares
# count 1): coordinates 8 (two FMAs, four add/sub), one-hot veto 8 (two rint,
# two add/sub, four min/max), depth taps 12 (floor/ceil x4, min/max x8), tap
# weights 4, bilinear depth 9, BA 5, cross product 9, norm^2 5, carry 2 = 62.
# The bilinear veto replaces the one-hot's 8 with 40 (clamps 4, floor 2,
# hat weights 10, tap indices 10, four compares, 9 for the interpolation
# and the threshold) = 94. Per-pixel setup (endpoint, BC, denominator,
# final sqrt/div) is about 40.
OPS_PER_SAMPLE = {"onehot": 62, "bilinear": 94}
OPS_PER_PIXEL = 40


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond: bool, phase: str, msg: str) -> None:
    if not cond:
        raise PhaseError(f"{phase}: {msg}")


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if proc.returncode != 0:
        raise PhaseError(f"device: nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def march_stats(got, want):
    """Sentinel agreement, 0.9999-quantile, mean and max |d| off the sentinel."""
    import torch

    big_w, big_g = want >= 1e5, got >= 1e5
    agree = (big_w == big_g).float().mean().item()
    diff = (got - want).abs()[~(big_w | big_g)]
    if diff.numel() == 0:
        return agree, 0.0, 0.0, 0.0
    q = torch.quantile(diff.double().cpu(), 0.9999).item()
    return agree, q, diff.mean().item(), diff.max().item()


def check_march(got, want, phase: str, tag: str) -> float:
    """The kernel bars of tests/test_torch_shadows.py; returns max |d| off the sentinel."""
    agree, q, mean, mx = march_stats(got, want)
    check(agree >= 0.9999, phase, f"{tag}: sentinel agreement {agree}")
    check(q < 1e-3, phase, f"{tag}: 0.9999-quantile |d| {q}")
    check(mean < 1e-4, phase, f"{tag}: mean |d| {mean}")
    return mx


def cuda_time_ms(fn, iters: int, warmup: int = 1, windows: int = 1) -> float:
    """Device time of one fn(), by CUDA events: the median over `windows`
    windows of the mean over `iters` back-to-back calls."""
    import statistics

    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(stop) / iters)
    return statistics.median(per_call)


def load_goldens():
    import numpy as np

    fixtures = sorted(GOLDEN.glob("ref_*.npz"))
    check(len(fixtures) == 10, "golden", f"expected 10 golden fixtures, found {len(fixtures)}")
    return [(p.name, dict(np.load(p))) for p in fixtures]


def phase_march(goldens, dev):
    """Kernel vs plain march on the card, at 256^2, batch 8, real face data."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K

    batch = goldens[:8]
    depth = torch.from_numpy(np.stack([g["depth"][0, 0] for _, g in batch])).to(dev)
    mask = torch.from_numpy(np.stack([g["mask"] for _, g in batch])).to(dev)
    unit = np.stack([g["target_light"][0] for _, g in batch]).astype(np.float32)
    lights = unit / np.linalg.norm(unit, axis=1, keepdims=True) * 4013.0
    lights[0] = [5.0, -3.0, 20.0]        # inside the image: both gates fire
    lights[1] = [600.0, -300.0, 3000.0]  # inside only the 'wide' gate region
    light = torch.from_numpy(lights.astype(np.float32)).to(dev)

    worst = 0.0
    runs = 0
    for preset in ("preset_single_image", "preset_lighting_transfer"):
        base = getattr(C, preset)().render
        for gather in ("onehot", "bilinear"):
            for cull in (dict(), dict(shadow_mask_cull=True), dict(shadow_mask_cull=True, shadow_col_chunk=32)):
                for gate in ("none", "inside_image", "wide"):
                    cfg = dataclasses.replace(base, shadow_mask_gather=gather, shadow_bias_gate=gate, **cull)
                    got = K.ray_march_min_distance_cuda(depth, mask, light, cfg)
                    want = S.ray_march_min_distance_batch(depth, mask, light, cfg)
                    torch.cuda.synchronize()
                    worst = max(worst, check_march(got, want, "march", f"{preset}/{gather}/{cull}/{gate}"))
                    runs += 1
    emit("march", ok=True, configs=runs, batch=8, size=256, samples=[160, 159], max_abs_err=worst)
    return worst


def phase_golden(goldens, dev):
    """The ten fixtures through render() on the card (kernel path) vs the reference."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.render import render

    rows = []
    for name, fx in goldens:
        transfer = "transfer" in name
        preset = C.preset_lighting_transfer() if transfer else C.preset_single_image()
        ambient = fx["target_ambient"] if transfer else np.zeros((1,), np.float32)
        args = dict(
            albedo=np.ascontiguousarray(np.moveaxis(fx["albedo"], 1, -1)),
            depth=np.ascontiguousarray(fx["depth"][:, 0]),
            lighting=np.zeros((1, 4), np.float32),
            mask=fx["mask"][None],
        )
        t = {k: torch.from_numpy(v).to(dev) for k, v in args.items()}
        light = torch.from_numpy(fx["target_light"]).to(dev)
        amb = torch.from_numpy(ambient).to(dev)
        face = fx["mask"][None] > 0
        # The strict tier's arithmetic with the cull off (raw arrays are then
        # reference-comparable everywhere), then with the tier's cull, which
        # may change only fully off-face blocks.
        strict = C.apply_precision_tier(preset, "strict").render
        outs = {}
        for cull in (False, True):
            cfg = dataclasses.replace(strict, shadow_mask_cull=cull)
            before = K.LAUNCHES
            outs[cull] = render(t["albedo"], t["depth"], t["lighting"], t["mask"], cfg,
                                target_light=light, target_ambient=amb)
            check(K.LAUNCHES == before + 1, "golden", f"{name}: render did not launch the march kernel")
        w = outs[False].shadow_mask_weights.cpu().numpy()
        sw = float(np.abs(w - fx["shadow_weights"]).mean())
        check(sw <= 1e-5, "golden", f"{name}: shadow-weight mean |d| {sw}")
        culled = outs[True].shadow_mask_weights.cpu().numpy()
        check(bool((culled[face] == w[face]).all()), "golden", f"{name}: the cull changed on-face weights")
        row = dict(fixture=name, sw_mean_abs=sw)
        if transfer:
            rendered = outs[False].rendered.cpu().numpy()
            mse = float(np.mean((rendered - np.moveaxis(fx["rendered"], 1, -1)) ** 2))
            psnr = 10.0 * np.log10(1.0 / max(mse, 1e-30))
            check(psnr >= 100.0, "golden", f"{name}: rendered PSNR {psnr}")
            row["psnr_db"] = psnr
        rows.append(row)
    emit("golden", ok=True, fixtures=rows)


def phase_e2e(goldens, dev, seed=0, batch=64):
    """Relighter.forward at full width, strict and fast, kernel path vs plain path."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.ops.shading import composite, shadow_weights

    fx = dict(goldens)["ref_transfer_00104.npz"]
    gen = torch.Generator().manual_seed(seed)
    images = torch.from_numpy(np.repeat(fx["image"][None], batch, 0)).to(dev)
    masks = torch.from_numpy(np.repeat(fx["mask"][None], batch, 0)).to(dev)
    dirs = torch.randn((batch, 3), generator=gen)
    dirs[:, 2] = dirs[:, 2].abs() + 0.5
    lights = dirs.to(dev)

    results = {}
    launches = 0
    worst = 0.0
    for tier in ("strict", "fast"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(seed)).state_dict()
        rl = Relighter(cfg, state)  # default device: cuda
        check(rl.device.type == "cuda", "e2e", f"Relighter chose {rl.device}")

        # The main path, counted on its own.
        K.LAUNCHES = 0
        out = rl.forward(images, masks, lights)
        torch.cuda.synchronize()
        n = K.LAUNCHES
        check(n == 1, "e2e", f"{tier}: forward launched the march kernel {n} times, expected 1")
        launches += n
        for field in out._fields:
            v = getattr(out, field)
            check(bool(torch.isfinite(v).all()), "e2e", f"{tier}: non-finite {field}")
        check(tuple(out.rendered.shape) == (batch, 256, 256, 3), "e2e", f"{tier}: rendered {tuple(out.rendered.shape)}")

        # Kernel path vs plain path on the same batch: the plain march on the
        # forward's own depth, masks and light point, then the same shadow
        # weights and composite as render().
        depth = out.depth.float().contiguous()
        light_pt = cfg.render.light_distance * out.unit_light_direction.float()
        plain_md = S.ray_march_min_distance_batch(depth, masks, light_pt, cfg.render)
        md_err = check_march(out.min_distance, plain_md, "e2e", f"{tier}: min_distance")
        worst = max(worst, md_err)
        _, plain_rendered = composite(out.albedo, out.full_shading, out.ambient_light, shadow_weights(plain_md))
        mse = torch.mean((out.rendered - plain_rendered) ** 2).item()
        psnr = 10.0 * np.log10(1.0 / max(mse, 1e-30))
        check(psnr >= 80.0, "e2e", f"{tier}: kernel vs plain rendered PSNR {psnr}")
        del plain_md, plain_rendered

        # Throughput, and where the time goes: the CNN alone and the march
        # alone. Each is the median of 5 windows of 8 calls (about 2 s of
        # forwards per tier).
        ms = cuda_time_ms(lambda: rl.forward(images, masks, lights), 8, windows=5)
        with torch.no_grad():
            net_ms = cuda_time_ms(lambda: rl.model(images, rl.use_skips), 8, windows=5)
        march_ms = cuda_time_ms(
            lambda: K.ray_march_min_distance_cuda(depth, masks, light_pt, cfg.render), 20, windows=5
        )
        results[tier] = dict(img_per_s=batch / (ms / 1e3), forward_ms=ms, cnn_ms=net_ms,
                             march_ms=march_ms, launches=n, kernel_vs_plain_psnr_db=psnr,
                             min_distance_max_abs_err=md_err)
        emit("e2e", ok=True, tier=tier, batch=batch, size=256, **results[tier])
        del rl, out, depth
        torch.cuda.empty_cache()
    return launches, results, worst


def phase_timing(goldens, dev, batch=64):
    """The march kernel's time per launch beside its bound and its plain version."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K

    fx = dict(goldens)["ref_transfer_00104.npz"]
    depth = torch.from_numpy(np.repeat(fx["depth"][:, 0], batch, 0)).to(dev).contiguous()
    mask = torch.from_numpy(np.repeat(fx["mask"][None], batch, 0)).to(dev).contiguous()
    gen = torch.Generator().manual_seed(1)
    dirs = torch.randn((batch, 3), generator=gen)
    dirs[:, 2] = dirs[:, 2].abs() + 0.5
    light = (4013.0 * torch.nn.functional.normalize(dirs, dim=-1)).to(dev)

    rows = {}
    for tier in ("strict", "fast"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier).render
        s, (h, w) = cfg.num_sample_points, (cfg.img_height, cfg.img_width)
        live = S.cull_live_blocks(mask, S.effective_col_chunk(cfg))
        live_px = int(live.sum().item()) * 8 * S.effective_col_chunk(cfg)
        ops = live_px * (s * OPS_PER_SAMPLE[S.resolve_mask_gather(cfg)] + OPS_PER_PIXEL) + (batch * h * w - live_px)
        nbytes = 4 * (3 * batch * h * w + 3 * batch + s) + live.numel()
        bound_ms = 1e3 * max(ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
        got = K.ray_march_min_distance_cuda(depth, mask, light, cfg)
        want = S.ray_march_min_distance_batch(depth, mask, light, cfg)
        err = check_march(got, want, "timing", f"{tier}: batch {batch}")
        del got, want
        ms = cuda_time_ms(lambda: K.ray_march_min_distance_cuda(depth, mask, light, cfg), 20, warmup=3, windows=5)
        plain_ms = cuda_time_ms(lambda: S.ray_march_min_distance_batch(depth, mask, light, cfg), 2)
        rows[tier] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, max_abs_err=err,
                          bound_by="operations" if ops / PEAK_F32_FLOPS >= nbytes / PEAK_BYTES_PER_S else "bytes",
                          live_pixel_fraction=live_px / (batch * h * w), ops=ops, bytes=nbytes,
                          veto=S.resolve_mask_gather(cfg), samples=s)
        emit("timing", ok=True, tier=tier, batch=batch, size=256, **rows[tier])
    return rows


def main() -> int:
    if not (ROOT / "geomconsistentfr_torch" / "csrc" / "march.cu").is_file():
        print("chip_smoke.py: the geomconsistentfr_torch package is not beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        emit("device", ok=False, error="torch.cuda.is_available() is false; this script needs a CUDA GPU")
        return 1
    try:
        smi = nvidia_smi_line()
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        dev = torch.device("cuda:0")
        emit("device", ok=True, kind=kind, count=count, capability=list(torch.cuda.get_device_capability(0)),
             torch=torch.__version__, cuda=torch.version.cuda, nvidia_smi=smi)

        from geomconsistentfr_torch.ops import shadows_cuda as K

        t0 = time.perf_counter()
        _, log = K.build()
        K._library()
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
        emit("build", ok=True, seconds=time.perf_counter() - t0, kernels=["march"], ptxas=regs)

        goldens = load_goldens()
        max_err = phase_march(goldens, dev)
        phase_golden(goldens, dev)
        launches, e2e, e2e_err = phase_e2e(goldens, dev)
        timing = phase_timing(goldens, dev)
    except PhaseError as e:
        emit("failed", ok=False, error=str(e))
        return 1

    t = timing["strict"]
    # The worst kernel-vs-plain |d| of every comparison: the march phase
    # (batch 8), the main path's own batches and the timing inputs (batch 64).
    max_err = max(max_err, e2e_err, *(row["max_abs_err"] for row in timing.values()))
    kernels = [dict(
        name="march", route="cuda", source="geomconsistentfr_torch/csrc/march.cu",
        replaces="geomconsistentfr_tpu/ops/shadows_pallas.py:64",
        launches=launches, max_abs_err=max_err, ms=t["ms"], plain_ms=t["plain_ms"],
        bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
    )]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
