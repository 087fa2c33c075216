#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (geomconsistentfr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits non-zero):
  1. device   CUDA is required (no CPU fallback); the card's name and power
              limit as nvidia-smi reports them.
  2. build    every kernel of the port is compiled from csrc/ (nvcc, sm_90a):
              march (K1), march_argmin (K2) and refine (K3), with the
              registers ptxas reports for each.
  3. march    each kernel vs its plain PyTorch version on the card, batch 8,
              the golden fixtures' depth maps and face masks:
              K1 at 256x256, 160 and 159 samples, both vetoes, cull
              off/row/col-32, all three gates;
              K2 on those maps pooled 4x4 under the draft tier (64x64, 80
              samples, plus a slice of the t grid), both vetoes, cull
              off/row, all three gates, its winning index too;
              K3 at 256x256 around the plain K2's upsampled t*, both vetoes,
              cull off/col-64, all three gates.
  4. golden   the ten golden fixtures rendered through the kernels at the
              strict tier (K1) and at the draft tier (K2 then K3), against the
              reference outputs they store.
  5. e2e      Relighter.forward at full width (batch 64, 256x256,
              preset_single_image) at the strict, fast and draft tiers with
              random weights from a seeded torch.Generator: img/s (median of
              five windows), finite outputs, kernel launch counts, and the
              forward's min distances and rendered image against the plain
              path on the same batch.
  6. timing   each kernel's time per launch beside its bound and its plain
              version's time, at the main path's shapes, after holding the
              two outputs against each other.
Then the `kernels` JSON line, the nvidia-smi line, and, last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Bars (march and golden) are those of tests/test_torch_shadows.py,
tests/test_torch_render.py and tests/test_torch_draft.py.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
KERNELS = ("march", "march_argmin", "refine")

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
# What K2 and K3 add to a sample: K2's carry is a compare and two selects
# instead of one min (+2); K3's t is an add and a clamp (min, max) (+3).
EXTRA_OPS_PER_SAMPLE = {"march": 0, "march_argmin": 2, "refine": 3}


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


def ptxas_registers(log: str) -> dict:
    """kernel name -> the ptxas 'Used N registers' line of its instantiation."""
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            entry = m.group(1)
        elif "registers" in line and entry is not None:
            form = re.search(r"march_kernelILi(\d)E", entry)
            if form:
                regs[KERNELS[int(form.group(1))]] = line.split(":", 1)[-1].strip()
    return regs


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


def check_tstar(got_t, want_t, phase: str, tag: str) -> float:
    """K2's winning offsets agree with the plain argmin on >= 0.9999 of pixels."""
    agree = (got_t == want_t).float().mean().item()
    check(agree >= 0.9999, phase, f"{tag}: t* agreement {agree}")
    return agree


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


def kernel_device_ms(fn, iters: int = 20):
    """Device time per launch of the march kernel that fn() launches, as
    torch.profiler reports it (None if the profiler sees no CUDA kernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if "march_kernel" in ev.key:
            total += getattr(ev, "device_time_total", getattr(ev, "cuda_time_total", 0.0))
    return total / iters / 1e3 if total > 0 else None


def load_goldens():
    import numpy as np

    fixtures = sorted(GOLDEN.glob("ref_*.npz"))
    check(len(fixtures) == 10, "golden", f"expected 10 golden fixtures, found {len(fixtures)}")
    return [(p.name, dict(np.load(p))) for p in fixtures]


def reset_launches():
    from geomconsistentfr_torch.ops import shadows_cuda as K

    for name in K.LAUNCHES:
        K.LAUNCHES[name] = 0


def phase_march(goldens, dev):
    """Each kernel vs its plain version on the card, batch 8, real face data."""
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

    worst = dict.fromkeys(KERNELS, 0.0)
    runs = dict.fromkeys(KERNELS, 0)
    tstar_agree = 1.0
    for preset in ("preset_single_image", "preset_lighting_transfer"):
        base = getattr(C, preset)().render
        draft = C.apply_precision_tier(getattr(C, preset)(), "draft").render
        for gather in ("onehot", "bilinear"):
            for gate in ("none", "inside_image", "wide"):
                for cull in (dict(), dict(shadow_mask_cull=True), dict(shadow_mask_cull=True, shadow_col_chunk=32)):
                    cfg = dataclasses.replace(base, shadow_mask_gather=gather, shadow_bias_gate=gate, **cull)
                    got = K.ray_march_min_distance_cuda(depth, mask, light, cfg)
                    want = S.ray_march_min_distance_batch(depth, mask, light, cfg)
                    torch.cuda.synchronize()
                    tag = f"K1 {preset}/{gather}/{cull}/{gate}"
                    worst["march"] = max(worst["march"], check_march(got, want, "march", tag))
                    runs["march"] += 1

                # K2 on the draft tier's pooled inputs (64x64, 80 samples; the
                # draft's 64-column cull is the row cull there), then K3 at full
                # resolution around the plain K2's t*. The config refuses the
                # one-hot veto beside the TPU step pack, which the port ignores.
                for cull in (False, True):
                    cfg = dataclasses.replace(draft, shadow_mask_gather=gather, shadow_bias_gate=gate,
                                              shadow_mask_cull=cull, shadow_step_pack=1)
                    m_depth, m_mask, m_light, m_cfg = S.scale_march_inputs(depth, mask, light, cfg)
                    slices = (None, S.sample_ts(m_cfg).astype(np.float32)[17:53]) if gate == "none" else (None,)
                    for ts in slices:
                        got_d, got_t = K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, ts,
                                                                     return_argmin_t=True)
                        want_d, want_t = S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, ts,
                                                                        return_argmin_t=True)
                        torch.cuda.synchronize()
                        tag = f"K2 {preset}/{gather}/cull={cull}/{gate}/ts={'slice' if ts is not None else 'all'}"
                        worst["march_argmin"] = max(worst["march_argmin"], check_march(got_d, want_d, "march", tag))
                        tstar_agree = min(tstar_agree, check_tstar(got_t, want_t, "march", tag))
                        runs["march_argmin"] += 1
                        if ts is not None:
                            continue
                        t_map = S.upsample_tstar_nn(want_t, cfg)
                        got = K.refine_min_distance_cuda(depth, mask, light, t_map, cfg)
                        want = S.refine_min_distance_batch(depth, mask, light, t_map, cfg)
                        torch.cuda.synchronize()
                        tag = f"K3 {preset}/{gather}/cull={cull}/{gate}"
                        worst["refine"] = max(worst["refine"], check_march(got, want, "march", tag))
                        runs["refine"] += 1
    emit("march", ok=True, configs=runs, batch=8, size={"march": 256, "march_argmin": 64, "refine": 256},
         samples={"march": [160, 159], "march_argmin": [80, 36], "refine": 8},
         tstar_agreement=tstar_agree, max_abs_err=worst)
    return worst


def golden_args(fx, transfer, dev):
    import numpy as np
    import torch

    ambient = fx["target_ambient"] if transfer else np.zeros((1,), np.float32)
    args = dict(
        albedo=np.ascontiguousarray(np.moveaxis(fx["albedo"], 1, -1)),
        depth=np.ascontiguousarray(fx["depth"][:, 0]),
        lighting=np.zeros((1, 4), np.float32),
        mask=fx["mask"][None],
    )
    t = {k: torch.from_numpy(v).to(dev) for k, v in args.items()}
    return (t["albedo"], t["depth"], t["lighting"], t["mask"]), dict(
        target_light=torch.from_numpy(fx["target_light"]).to(dev), target_ambient=torch.from_numpy(ambient).to(dev))


def phase_golden(goldens, dev):
    """The ten fixtures through render() on the card (kernel path) vs the reference."""
    import numpy as np

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.render import render

    rows = []
    for name, fx in goldens:
        transfer = "transfer" in name
        preset = C.preset_lighting_transfer() if transfer else C.preset_single_image()
        args, targets = golden_args(fx, transfer, dev)
        face = fx["mask"][None] > 0
        # The strict tier's arithmetic with the cull off (raw arrays are then
        # reference-comparable everywhere), then with the tier's cull, which
        # may change only fully off-face blocks.
        strict = C.apply_precision_tier(preset, "strict").render
        outs = {}
        for cull in (False, True):
            cfg = dataclasses.replace(strict, shadow_mask_cull=cull)
            reset_launches()
            outs[cull] = render(*args, cfg, **targets)
            check(K.LAUNCHES == {"march": 1, "march_argmin": 0, "refine": 0}, "golden",
                  f"{name}: strict render launched {K.LAUNCHES}")
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

        # The draft tier: K2 then K3, at the bars of tests/test_torch_draft.py.
        reset_launches()
        draft = render(*args, C.apply_precision_tier(preset, "draft").render, **targets)
        check(K.LAUNCHES == {"march": 0, "march_argmin": 1, "refine": 1}, "golden",
              f"{name}: draft render launched {K.LAUNCHES}")
        dw = draft.shadow_mask_weights.cpu().numpy()
        row["draft_sw_face_mean_abs"] = float(np.abs(dw - fx["shadow_weights"])[face].mean())
        if transfer:
            m = fx["mask"]
            sq = (draft.rendered.cpu().numpy() - np.moveaxis(fx["rendered"], 1, -1)) ** 2
            mse = float(np.sum(sq * m[None, :, :, None]) / (3.0 * max(np.sum(m), 1.0)))
            row["draft_face_psnr_db"] = 10.0 * np.log10(1.0 / max(mse, 1e-30))
            check(row["draft_face_psnr_db"] >= 45.0, "golden", f"{name}: draft face-visible PSNR {row['draft_face_psnr_db']}")
        else:
            check(row["draft_sw_face_mean_abs"] <= 1e-2, "golden",
                  f"{name}: draft face shadow-weight mean |d| {row['draft_sw_face_mean_abs']}")
        rows.append(row)
    emit("golden", ok=True, fixtures=rows)


def plain_min_distance(depth, mask, light_pt, cfg):
    """The plain versions of the tier's march on the card: K1's, or K2's then K3's."""
    from geomconsistentfr_torch.ops import shadows as S

    if cfg.shadow_resolution_scale == 1:
        return S.ray_march_min_distance_batch(depth, mask, light_pt, cfg)
    m_depth, m_mask, m_light, m_cfg = S.scale_march_inputs(depth, mask, light_pt, cfg)
    _, t_star = S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    return S.refine_min_distance_batch(depth, mask, light_pt, S.upsample_tstar_nn(t_star, cfg), cfg)


TIER_LAUNCHES = {
    "strict": {"march": 1, "march_argmin": 0, "refine": 0},
    "fast": {"march": 1, "march_argmin": 0, "refine": 0},
    "draft": {"march": 0, "march_argmin": 1, "refine": 1},
}


def phase_e2e(goldens, dev, seed=0, batch=64):
    """Relighter.forward at full width, strict, fast and draft, kernel path vs plain path."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.ops.shading import composite, shadow_weights
    from geomconsistentfr_torch.render import shadow_min_distance

    fx = dict(goldens)["ref_transfer_00104.npz"]
    gen = torch.Generator().manual_seed(seed)
    images = torch.from_numpy(np.repeat(fx["image"][None], batch, 0)).to(dev)
    masks = torch.from_numpy(np.repeat(fx["mask"][None], batch, 0)).to(dev)
    dirs = torch.randn((batch, 3), generator=gen)
    dirs[:, 2] = dirs[:, 2].abs() + 0.5
    lights = dirs.to(dev)

    results = {}
    launches = dict.fromkeys(KERNELS, 0)
    worst = dict.fromkeys(KERNELS, 0.0)
    for tier in ("strict", "fast", "draft"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(seed)).state_dict()
        rl = Relighter(cfg, state)  # default device: cuda
        check(rl.device.type == "cuda", "e2e", f"Relighter chose {rl.device}")

        # The main path, counted on its own.
        reset_launches()
        out = rl.forward(images, masks, lights)
        torch.cuda.synchronize()
        n = dict(K.LAUNCHES)
        check(n == TIER_LAUNCHES[tier], "e2e", f"{tier}: forward launched {n}, expected {TIER_LAUNCHES[tier]}")
        for name in KERNELS:
            launches[name] += n[name]
        for field in out._fields:
            v = getattr(out, field)
            check(bool(torch.isfinite(v).all()), "e2e", f"{tier}: non-finite {field}")
        check(tuple(out.rendered.shape) == (batch, 256, 256, 3), "e2e", f"{tier}: rendered {tuple(out.rendered.shape)}")

        # Kernel path vs plain path on the same batch: the plain versions of
        # the tier's march on the forward's own depth, masks and light point,
        # then the same shadow weights and composite as render().
        depth = out.depth.float().contiguous()
        light_pt = (cfg.render.light_distance * out.unit_light_direction.float()).contiguous()
        plain_md = plain_min_distance(depth, masks, light_pt, cfg.render)
        md_err = check_march(out.min_distance, plain_md, "e2e", f"{tier}: min_distance")
        kernel = "march" if tier != "draft" else "refine"
        worst[kernel] = max(worst[kernel], md_err)
        _, plain_rendered = composite(out.albedo, out.full_shading, out.ambient_light, shadow_weights(plain_md))
        mse = torch.mean((out.rendered - plain_rendered) ** 2).item()
        psnr = 10.0 * np.log10(1.0 / max(mse, 1e-30))
        check(psnr >= 80.0, "e2e", f"{tier}: kernel vs plain rendered PSNR {psnr}")
        del plain_md, plain_rendered

        # Throughput, and where the time goes: the CNN alone and the whole
        # march alone (at draft: pool, K2, upsample, K3). Each is the median
        # of 5 windows of 8 calls (about 2 s of forwards per tier).
        ms = cuda_time_ms(lambda: rl.forward(images, masks, lights), 8, windows=5)
        with torch.no_grad():
            net_ms = cuda_time_ms(lambda: rl.model(images, rl.use_skips), 8, windows=5)
        march_ms = cuda_time_ms(lambda: shadow_min_distance(depth, masks, light_pt, cfg.render), 20, windows=5)
        results[tier] = dict(img_per_s=batch / (ms / 1e3), forward_ms=ms, cnn_ms=net_ms,
                             march_ms=march_ms, launches=n, kernel_vs_plain_psnr_db=psnr,
                             min_distance_max_abs_err=md_err)
        emit("e2e", ok=True, tier=tier, batch=batch, size=256, **results[tier])
        del rl, out, depth
        torch.cuda.empty_cache()
    return launches, results, worst


def bound(ops: float, nbytes: float) -> dict:
    """The least time for the work: the larger of operations and bytes over their peaks."""
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=1e3 * max(by_ops, by_bytes), bound_by="operations" if by_ops >= by_bytes else "bytes",
                ops=ops, bytes=nbytes)


def timing_row(name, kernel_fn, plain_fn, ops, nbytes, phase_tag):
    """Time one kernel's wrapper, its device time and its plain version."""
    ms = cuda_time_ms(kernel_fn, 20, warmup=3, windows=5)
    device_ms = kernel_device_ms(kernel_fn)
    plain_ms = cuda_time_ms(plain_fn, 2)
    row = dict(kernel=name, ms=ms, kernel_device_ms=device_ms, plain_ms=plain_ms, **bound(ops, nbytes))
    emit("timing", ok=True, **phase_tag, **row)
    return row


def phase_timing(goldens, dev, batch=64):
    """Each kernel's time per launch beside its bound and its plain version, at the main path's shapes."""
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

    def live_pixels(m, cfg):
        chunk = S.effective_col_chunk(cfg)
        live = S.cull_live_blocks(m, chunk)
        return int(live.sum().item()) * 8 * chunk, live.numel()

    def march_ops(name, live_px, n_px, samples, cfg):
        per_sample = OPS_PER_SAMPLE[S.resolve_mask_gather(cfg)] + EXTRA_OPS_PER_SAMPLE[name]
        return live_px * (samples * per_sample + OPS_PER_PIXEL) + (n_px - live_px)

    rows = {}
    for tier in ("strict", "fast"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier).render
        s, (h, w) = cfg.num_sample_points, (cfg.img_height, cfg.img_width)
        live_px, n_flags = live_pixels(mask, cfg)
        ops = march_ops("march", live_px, batch * h * w, s, cfg)
        nbytes = 4 * (3 * batch * h * w + 3 * batch + s) + n_flags
        got = K.ray_march_min_distance_cuda(depth, mask, light, cfg)
        want = S.ray_march_min_distance_batch(depth, mask, light, cfg)
        err = check_march(got, want, "timing", f"{tier}: batch {batch}")
        del got, want
        rows[tier] = timing_row(
            "march", lambda: K.ray_march_min_distance_cuda(depth, mask, light, cfg),
            lambda: S.ray_march_min_distance_batch(depth, mask, light, cfg), ops, nbytes,
            dict(tier=tier, batch=batch, size=256, veto=S.resolve_mask_gather(cfg), samples=s,
                 live_pixel_fraction=live_px / (batch * h * w)),
        )
        rows[tier]["max_abs_err"] = err

    # The draft tier's two kernels at its shapes: K2 on the pooled batch
    # (64x64, 80 samples, row cull), K3 at 256x256 around K2's t* (8
    # offsets, 8x64 cull).
    cfg = C.apply_precision_tier(C.preset_single_image(), "draft").render
    m_depth, m_mask, m_light, m_cfg = S.scale_march_inputs(depth, mask, light, cfg)
    s, (h, w) = m_cfg.num_sample_points, (m_cfg.img_height, m_cfg.img_width)
    got_d, got_t = K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    want_d, want_t = S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    err = check_march(got_d, want_d, "timing", f"draft K2: batch {batch}")
    agree = check_tstar(got_t, want_t, "timing", f"draft K2: batch {batch}")
    live_px, n_flags = live_pixels(m_mask, m_cfg)
    ops = march_ops("march_argmin", live_px, batch * h * w, s, m_cfg)
    nbytes = 4 * (4 * batch * h * w + 3 * batch + s) + n_flags  # depth, mask, out, idx
    tag = dict(tier="draft", batch=batch, size=h, veto=S.resolve_mask_gather(m_cfg), samples=s,
               live_pixel_fraction=live_px / (batch * h * w))
    rows["draft_argmin"] = timing_row(
        "march_argmin",
        lambda: K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True),
        lambda: S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True),
        ops, nbytes, dict(tag, tstar_agreement=agree),
    )
    rows["draft_argmin"]["max_abs_err"] = err

    t_map = S.upsample_tstar_nn(got_t, cfg)
    got = K.refine_min_distance_cuda(depth, mask, light, t_map, cfg)
    want = S.refine_min_distance_batch(depth, mask, light, t_map, cfg)
    err = check_march(got, want, "timing", f"draft K3: batch {batch}")
    del got, want, got_d, want_d, want_t
    n_off, (h, w) = 2 * cfg.shadow_refine_halfwidth, (cfg.img_height, cfg.img_width)
    live_px, n_flags = live_pixels(mask, cfg)
    ops = march_ops("refine", live_px, batch * h * w, n_off, cfg)
    nbytes = 4 * (4 * batch * h * w + 3 * batch + n_off) + n_flags  # depth, mask, t_map, out
    rows["draft_refine"] = timing_row(
        "refine", lambda: K.refine_min_distance_cuda(depth, mask, light, t_map, cfg),
        lambda: S.refine_min_distance_batch(depth, mask, light, t_map, cfg), ops, nbytes,
        dict(tier="draft", batch=batch, size=h, veto=S.resolve_mask_gather(cfg), samples=n_off,
             live_pixel_fraction=live_px / (batch * h * w)),
    )
    rows["draft_refine"]["max_abs_err"] = err
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
        regs = ptxas_registers(log)
        check(sorted(regs) == sorted(KERNELS), "build", f"ptxas reported {sorted(regs)}, expected {sorted(KERNELS)}")
        emit("build", ok=True, seconds=time.perf_counter() - t0, kernels=list(KERNELS), ptxas=regs)

        goldens = load_goldens()
        march_err = phase_march(goldens, dev)
        phase_golden(goldens, dev)
        launches, e2e, e2e_err = phase_e2e(goldens, dev)
        timing = phase_timing(goldens, dev)
    except PhaseError as e:
        emit("failed", ok=False, error=str(e))
        return 1

    # max_abs_err: the worst kernel-vs-plain |d| of every comparison of that
    # kernel: the march phase (batch 8), the main path's own batches and the
    # timing inputs (batch 64). `ms` and the bound are at the main path's
    # shapes: K1 at the strict tier, K2 and K3 at the draft tier.
    rows = {"march": (timing["strict"], [timing["fast"]], "geomconsistentfr_tpu/ops/shadows_pallas.py:64"),
            "march_argmin": (timing["draft_argmin"], [], "geomconsistentfr_tpu/ops/shadows_pallas.py:881"),
            "refine": (timing["draft_refine"], [], "geomconsistentfr_tpu/ops/shadows_pallas.py:900")}
    kernels = []
    for name, (t, others, replaces) in rows.items():
        max_err = max(march_err[name], e2e_err[name], t["max_abs_err"], *(o["max_abs_err"] for o in others))
        kernels.append(dict(
            name=name, route="cuda", source="geomconsistentfr_torch/csrc/march.cu", replaces=replaces,
            launches=launches[name], max_abs_err=max_err, ms=t["ms"], plain_ms=t["plain_ms"],
            bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
        ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
