#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (geomconsistentfr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-parent DIR

With no argument it runs the phases below. `--compare-parent DIR` times the
march kernels of another checkout (e.g. the parent commit, unpacked with
`git archive` into a git-ignored directory) beside this one's, in turns
(parent, this tree, this tree, parent), each in a child process of its own
(`--timing-of ROOT`, which times one tree), with the SASS counts of both
builds, and prints each run and a summary line.

Phases (each prints one JSON line; any failure exits non-zero):
  1. device   CUDA is required (no CPU fallback); the card's name and power
              limit as nvidia-smi reports them.
  2. build    every kernel of the port is compiled from csrc/ (nvcc, sm_90a):
              march (K1), march_argmin (K2), refine (K3) and march_grad (the
              backward of the training march K4, whose forward is K2), with
              the registers ptxas reports for each and the counts of F2I,
              I2F, FRND, LDG and float32 and integer arithmetic opcodes in
              its SASS (cuobjdump -sass), in the whole function and in each
              of its loops.
  3. march    each kernel vs its plain PyTorch version on the card, batch 8,
              the golden fixtures' depth maps and face masks (K1-K3 bit for
              bit, K2's winning index on every pixel):
              K1 at 256x256, 160 and 159 samples, both vetoes, cull
              off/row/col-32, all three gates;
              K2 on those maps pooled 4x4 under the draft tier (64x64, 80
              samples, plus a slice of the t grid), both vetoes, cull
              off/row, all three gates, its winning index too;
              K3 at 256x256 around the plain K2's upsampled t*, both vetoes,
              cull off/col-64, all three gates, and around the plain K2's
              index (the draft path's form), bit-equal to the t_map form;
              march_grad at 256x256 under preset_target_lighting_train (160
              samples) and on the transfer grid (159 from 0.03), a seeded
              random cotangent, both vetoes, cull off/col-32, all three
              gates: K2 forward and march_grad backward through the
              autograd Function, against the plain VJP at the kernel's
              winners.
  4. golden   the ten golden fixtures rendered through the kernels at the
              strict tier (K1) and at the draft tier (K2 then K3), against the
              reference outputs they store.
  5. e2e      Relighter.forward at full width (batch 64, 256x256,
              preset_single_image) at the strict, fast and draft tiers with
              random weights from a seeded torch.Generator: img/s (median of
              five windows), finite outputs, kernel launch counts (and no
              upsampled t* map or cull-flag pass on the path), and the
              forward's min distances (bit for bit) and rendered image
              against the plain path on the same batch.
  6. timing   each kernel's time per launch beside its bound and its plain
              version's time, at the main paths' shapes, after holding the
              two outputs against each other; and the whole draft march
              (pool, K2, K3) as a row of its own.
  7. train    Trainer.run_epoch at full width (preset_target_lighting_train,
              batch 3, 256x256, SyntheticFaceData, seeded random G and D),
              six steps crossing a D update at steps 0 and 5: finite losses,
              G moving every step and D only on its update steps, one K2 and
              one march_grad launch per step and no K1; the first step against
              the same step on the CPU (plain path); step ms, img/s, how the
              step splits, and the card's idle share of a step.
  8. parallel two ranks of torch.distributed (parallel/distributed.spawn,
              a file:// rendezvous): on one card they share it over gloo,
              with a card each they run NCCL. Each rank runs
              Relighter(parallel='samples') at batch 64, strict (K1 on its
              80 of the 160 samples) and draft (K2 on its slice, K3 on
              every rank), against the same forward in one process; K5 on
              the golden depth maps (batch 8, 160 samples), bit-equal to K2
              on the full grid, against its plain version and, through
              march_grad, against K4; two steps of the 1x2 grid train step
              (batch 3, K5 and march_grad on each rank) and one 2x1
              data-parallel step (batch 4). After each step every rank's
              parameters, BatchNorm statistics and Adam moments hash the
              same; the steps are held against the same steps in one
              process on the card. Per-rank times are labelled "2 ranks on
              one <card>": two ranks on one card scale nothing. The train
              and parallel phases run last, so the others run as before.
Then the `kernels` JSON line (K1-K4 and K5, `march_sp`), the nvidia-smi
line, and, last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Bars (march and golden) are those of tests/test_torch_shadows.py,
tests/test_torch_render.py and tests/test_torch_draft.py; march_grad's are
those of tests/test_torch_cuda.py (GRAD_BARS below).
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
KERNELS = ("march", "march_argmin", "refine", "march_grad")  # the compiled functions, in form order
# K5 (march_sp) launches the march_argmin form on a rank's slice of the t grid.
ALL_KERNELS = KERNELS + ("march_sp",)

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
# and the threshold) = 94 before the veto shared the depth taps. It reads
# the depth quad's corners (its floor and tap indices are the depth taps',
# counted once): clamps 4, the clamped floors 2 (max with 0), hat weights
# 10, four compares, 9 for the interpolation and the threshold = 29, so the
# bilinear sample is 62 - 8 + 29 = 83. Per-pixel setup (endpoint, BC,
# denominator, final sqrt/div) is about 40.
OPS_PER_SAMPLE = {"onehot": 62, "bilinear": 83}
OPS_PER_PIXEL = 40
# The draft march's pooling, per full-resolution pixel: the face test, its
# cast, the depth product and the two block sums.
POOL_OPS_PER_PIXEL = 5
# What K2 and K3 add to a sample: K2's carry is a compare and two selects
# instead of one min (+2); K3's t is an add and a clamp (min, max) (+3).
EXTRA_OPS_PER_SAMPLE = {"march": 0, "march_argmin": 2, "refine": 3}
# march_grad, per pixel with a gradient (on-face winner, live, nonzero
# cotangent), counted from csrc/march.cu as above: the setup 40, the sample
# at t* 63 (the march's 62 less its carry, plus the numerator's add and sqrt
# and the division), the chain rule 95 (through the distance 38, into the
# depth taps 8, the sample position 13, the endpoint Jacobian 28, the light's
# three sums 8) and the block's light reduction 15 (five shuffle-adds for
# each of three sums) = 213; the
# bilinear veto adds its 32. A pixel whose winner is vetoed stops after the
# setup and the veto (40 + 16); every other pixel does the reduction (15).
GRAD_OPS = {"grad": 213, "vetoed": 56, "other": 15, "bilinear_extra": 32}
# march_grad vs the plain VJP (tests/test_torch_cuda.py): its atomics add in
# any order, so the bars are relative to the gradient's size.
GRAD_BARS = {"d_depth_rel_to_max": 1e-4, "d_light_rel_to_image_max": 1e-4}


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
            elif "march_grad_kernel" in entry:
                regs["march_grad"] = line.split(":", 1)[-1].strip()
    return regs


# SASS opcode groups counted per kernel (the base opcode, before its first '.').
SASS_CONVERSIONS = ("F2I", "I2F", "FRND", "F2F", "I2FP", "F2IP")
SASS_F32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FADD32I", "FMUL32I", "FFMA32I")
SASS_INT = ("IADD3", "IADD", "IADD32I", "VIADD", "IMAD", "IMAD32I", "IMNMX", "VIMNMX", "VIADDMNMX", "ISETP",
            "LOP3", "SHF", "LEA", "IABS", "SEL", "PRMT")
SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def sass_kernel_name(mangled: str):
    form = re.search(r"march_kernelILi(\d)E", mangled)
    if form:
        return KERNELS[int(form.group(1))]
    return "march_grad" if "march_grad_kernel" in mangled else None


def opcode_counts(instrs) -> dict:
    bases = [op.split(".")[0] for _, op, _ in instrs]
    counts = {op: bases.count(op) for op in (*SASS_CONVERSIONS, "LDG")}
    counts.update(f32=sum(b in SASS_F32 for b in bases), int=sum(b in SASS_INT for b in bases),
                  mufu=bases.count("MUFU"), total=len(bases))
    return counts


def sass_counts(lib: Path, cuobjdump: Path) -> dict:
    """kernel name -> opcode counts of its SASS, in the whole function and in each loop.

    A loop is the address range from a backward branch's target to the
    branch; loops are listed largest first (the sample loops lead).
    """
    proc = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise PhaseError(f"build: cuobjdump failed: {proc.stderr.strip()}")
    functions, name = {}, None
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            name = sass_kernel_name(line.split("Function :", 1)[1].strip())
            if name is not None:
                functions[name] = []
            continue
        m = SASS_INSTR.search(line)
        if m and name is not None:
            tokens = m.group(2).split()
            if tokens and tokens[0].startswith("@"):
                tokens = tokens[1:]
            if tokens:
                functions[name].append((int(m.group(1), 16), tokens[0], tokens[1:]))
    result = {}
    for name, instrs in functions.items():
        loops = []
        for addr, op, args in instrs:
            if op.split(".")[0] == "BRA" and args and args[0].startswith("0x") and int(args[0], 16) <= addr:
                start = int(args[0], 16)
                loops.append(dict(start=start, end=addr,
                                  **opcode_counts([i for i in instrs if start <= i[0] <= addr])))
        result[name] = dict(function=opcode_counts(instrs), loops=sorted(loops, key=lambda d: -d["total"]))
    return result


def cuobjdump_path() -> Path:
    from geomconsistentfr_torch.ops import shadows_cuda as K

    return Path(K._nvcc()).parent / "cuobjdump"


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


def check_equal(got, want, phase: str, tag: str) -> float:
    """The march bars, then bit-equality (K1-K3 against their plain versions); returns max |d| off the sentinel."""
    mx = check_march(got, want, phase, tag)
    check(torch_equal_bits(got, want), phase, f"{tag}: not bit-equal to the plain version (max |d| {mx})")
    return mx


def torch_equal_bits(a, b) -> bool:
    import torch

    return a.shape == b.shape and bool(torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def check_tstar(got_t, want_t, phase: str, tag: str) -> float:
    """K2's winning offsets agree with the plain argmin on every pixel."""
    agree = (got_t == want_t).float().mean().item()
    check(agree == 1.0, phase, f"{tag}: t* agreement {agree}")
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


def kernel_device_ms(fn, iters: int = 20, name: str = "march_kernel"):
    """Device time per launch of the kernel `name` that fn() launches, as
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
        if name in ev.key:
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
                    worst["march"] = max(worst["march"], check_equal(got, want, "march", tag))
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
                        worst["march_argmin"] = max(worst["march_argmin"], check_equal(got_d, want_d, "march", tag))
                        tstar_agree = min(tstar_agree, check_tstar(got_t, want_t, "march", tag))
                        runs["march_argmin"] += 1
                        if ts is not None:
                            continue
                        t_map = S.upsample_tstar_nn(want_t, cfg)
                        got = K.refine_min_distance_cuda(depth, mask, light, t_map, cfg)
                        want = S.refine_min_distance_batch(depth, mask, light, t_map, cfg)
                        # The draft path's form: the centre read from the plain K2's index.
                        table = K._ts_for(dev, m_cfg)
                        _, want_idx = S.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, table)
                        got_from_idx = K.refine_around_argmin_cuda(depth, mask, light, want_idx, table, cfg)
                        torch.cuda.synchronize()
                        tag = f"K3 {preset}/{gather}/cull={cull}/{gate}"
                        worst["refine"] = max(worst["refine"], check_equal(got, want, "march", tag))
                        check(torch_equal_bits(got_from_idx, got), "march", f"{tag}: the index form differs")
                        runs["refine"] += 1

    # march_grad: K2 forward and march_grad backward through the autograd
    # Function under the training presets, against the plain VJP at the
    # kernel's own winners. The lights inside the image sit off the pixel
    # grid (tests/test_torch_cuda.py GRAD_LIGHTS says why).
    grad_lights = lights.copy()
    grad_lights[0] = [5.37, -3.61, 20.0]
    grad_lights[1] = [600.3, -300.7, 3000.0]
    g_light = torch.from_numpy(grad_lights.astype(np.float32)).to(dev)
    cot = torch.from_numpy(np.random.default_rng(0).normal(size=tuple(depth.shape)).astype(np.float32)).to(dev)
    grad_err = {"d_depth": 0.0, "d_depth_rel_to_max": 0.0, "d_light_rel_to_image_max": 0.0}
    train = C.preset_target_lighting_train().render
    for grid in (dict(), dict(num_sample_points=159, t_start=0.03)):
        for gather in ("onehot", "bilinear"):
            for gate in ("none", "inside_image", "wide"):
                for cull in (dict(), dict(shadow_mask_cull=True, shadow_col_chunk=32)):
                    cfg = dataclasses.replace(train, shadow_mask_gather=gather, shadow_bias_gate=gate, **grid, **cull)
                    tag = f"march_grad {cfg.num_sample_points}/{gather}/{cull}/{gate}"
                    d, lp = depth.clone().requires_grad_(), g_light.clone().requires_grad_()
                    out = K.ray_march_min_distance_cuda(d, mask, lp, cfg)
                    (out * cot).sum().backward()
                    _, t_star = K.ray_march_min_distance_cuda(depth, mask, g_light, cfg, return_argmin_t=True)
                    want_d, want_l = S.march_vjp(depth, mask, g_light, t_star, cot, cfg)
                    torch.cuda.synchronize()
                    check_march(out.detach(), S.ray_march_min_distance_batch(depth, mask, g_light, cfg), "march", tag)
                    dd = (d.grad - want_d).abs().max().item()
                    dd_rel = dd / max(want_d.abs().max().item(), 1e-30)
                    scale = want_l.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)
                    dl_rel = ((lp.grad - want_l).abs() / scale).max().item()
                    check(dd_rel <= GRAD_BARS["d_depth_rel_to_max"], "march", f"{tag}: d_depth |d| {dd_rel} of max")
                    check(dl_rel <= GRAD_BARS["d_light_rel_to_image_max"], "march",
                          f"{tag}: d_light |d| {dl_rel} of its image's max")
                    for key, v in zip(grad_err, (dd, dd_rel, dl_rel)):
                        grad_err[key] = max(grad_err[key], v)
                    runs["march_grad"] += 1
    worst["march_grad"] = grad_err["d_depth"]
    emit("march", ok=True, configs=runs, batch=8, bit_equal=["march", "march_argmin", "refine"],
         size={"march": 256, "march_argmin": 64, "refine": 256, "march_grad": 256},
         samples={"march": [160, 159], "march_argmin": [80, 36], "refine": 8, "march_grad": [160, 159]},
         tstar_agreement=tstar_agree, max_abs_err=worst, march_grad_err=grad_err, march_grad_bars=GRAD_BARS)
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
            check(K.LAUNCHES == {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0}, "golden",
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
        check(K.LAUNCHES == {"march": 0, "march_argmin": 1, "refine": 1, "march_grad": 0, "march_sp": 0}, "golden",
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
    "strict": {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0},
    "fast": {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0},
    "draft": {"march": 0, "march_argmin": 1, "refine": 1, "march_grad": 0, "march_sp": 0},
}


class CallCounter:
    """Counts the calls of module attributes (functions) while active, then restores them."""

    def __init__(self, *targets):
        self.targets, self.calls = targets, {}

    def __enter__(self):
        self.saved = [getattr(mod, name) for mod, name in self.targets]
        for (mod, name), fn in zip(self.targets, self.saved):
            key = f"{mod.__name__}.{name}"
            self.calls[key] = 0

            def counted(*a, _fn=fn, _key=key, **kw):
                self.calls[_key] += 1
                return _fn(*a, **kw)

            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.targets, self.saved):
            setattr(mod, name, fn)


def phase_e2e(goldens, dev, seed=0, batch=64):
    """Relighter.forward at full width, strict, fast and draft, kernel path vs plain path."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch import render as R
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import shadows as S
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

        # The main path, counted on its own. No tier makes an upsampled t*
        # map or a cull-flag pass: K3 reads K2's index, the kernels cull.
        reset_launches()
        with CallCounter((S, "upsample_tstar_nn"), (R, "upsample_tstar_nn"), (S, "cull_live_blocks")) as glue:
            out = rl.forward(images, masks, lights)
        torch.cuda.synchronize()
        n = dict(K.LAUNCHES)
        check(n == TIER_LAUNCHES[tier], "e2e", f"{tier}: forward launched {n}, expected {TIER_LAUNCHES[tier]}")
        check(not any(glue.calls.values()), "e2e", f"{tier}: the forward called {glue.calls}")
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
        md_err = check_equal(out.min_distance, plain_md, "e2e", f"{tier}: min_distance")
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
                             march_ms=march_ms, launches=n, glue_calls=glue.calls, kernel_vs_plain_psnr_db=psnr,
                             min_distance_max_abs_err=md_err)
        emit("e2e", ok=True, tier=tier, batch=batch, size=256, **results[tier])
        del rl, out, depth
        torch.cuda.empty_cache()
    return launches, results, worst


# The card's first training step against the same step on the CPU (the plain
# march and VJP), from the same weights and batch, float32 on both sides:
# each loss term within 1e-4 of its size, the gradient norm of D within 1e-3
# and of G within 1e-2. The convolutions, reductions and the renderer's
# eager ops round differently on the two devices, and G's gradient is
# sensitive to rounding: the line also prints how far it moves on the CPU
# alone when the images move by one ulp. 1.7e-3 (G) and 1.3e-5 (D) were
# measured on an H100.
TRAIN_BARS = {"loss_rel": 1e-4, "g_grad_norm_rel": 1e-2, "d_grad_norm_rel": 1e-3}
TRAIN_STEP_LAUNCHES = {"march": 0, "march_argmin": 1, "refine": 0, "march_grad": 1, "march_sp": 0}


def flat_params(module):
    import torch

    return torch.cat([p.detach().flatten() for p in module.parameters()]).clone()


def named_grads(state) -> dict:
    return {f"{m}.{n}": p.grad.detach().cpu().clone()
            for m, mod in (("g", state.g), ("d", state.d)) for n, p in mod.named_parameters()}


def grad_norms(grads: dict) -> dict:
    import torch

    return {m: torch.linalg.vector_norm(torch.cat([v.flatten() for k, v in grads.items() if k.startswith(m + ".")])).item()
            for m in ("g", "d")}


def device_busy_ms(fn, iters: int) -> float:
    """Device time per fn() summed over every kernel and copy the profiler sees."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(ev, "self_device_time_total", getattr(ev, "self_cuda_time_total", 0.0))
                for ev in prof.key_averages())
    return total / iters / 1e3


def phase_train(dev, seed=0, steps=6):
    """Trainer.run_epoch at full width on the card (K2 forward, march_grad backward)."""
    import shutil
    import tempfile

    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
    from geomconsistentfr_torch.models.layers import no_tf32
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.render import render

    cfg = C.preset_target_lighting_train()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batches_per_epoch=steps, log_every_steps=1))
    tcfg, b = cfg.train, cfg.train.batch_size
    data = SyntheticFaceData(num_samples=steps * b, size=256, seed=seed)
    workdir = tempfile.mkdtemp(prefix="gcfr_train_")
    try:
        trainer = T.Trainer(cfg, data, workdir=workdir)  # default device: cuda
        check(trainer.device.type == "cuda", "train", f"Trainer chose {trainer.device}")
        state = trainer.init_or_resume(torch.Generator().manual_seed(seed))
        init_g, init_d = flat_params(state.g), flat_params(state.d)

        # Each step of the main path, recorded: launches, losses, which
        # parameters moved; the first step's batch and gradient norms.
        records = []
        step_fn = trainer.step_fn

        def recorded(st, batch, use_skips):
            g0, d0, n0, step = flat_params(st.g), flat_params(st.d), dict(K.LAUNCHES), st.step
            metrics = step_fn(st, batch, use_skips=use_skips)
            rec = dict(step=step, launches={k: v - n0[k] for k, v in K.LAUNCHES.items()},
                       losses={k: float(v) for k, v in metrics.items()},
                       g_moved=not torch.equal(g0, flat_params(st.g)), d_moved=not torch.equal(d0, flat_params(st.d)))
            if not records:
                rec["batch"] = {k: v.cpu() for k, v in batch.items()}
                rec["grads"] = named_grads(st)
            records.append(rec)
            return metrics

        trainer.step_fn = recorded
        reset_launches()
        state, avg = trainer.run_epoch(state, 0)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        trainer.step_fn = step_fn
        want = {k: v * steps for k, v in TRAIN_STEP_LAUNCHES.items()}
        check(launches == want, "train", f"{steps} steps launched {launches}, expected {want}")
        check(len(records) == steps and state.step == steps, "train", f"ran {len(records)} steps to step {state.step}")
        for r in records:
            check(r["launches"] == TRAIN_STEP_LAUNCHES, "train", f"step {r['step']} launched {r['launches']}")
            check(all(np.isfinite(v) for v in r["losses"].values()), "train", f"step {r['step']}: {r['losses']}")
            check(r["g_moved"], "train", f"step {r['step']}: G did not move")
            d_step = r["step"] % tcfg.gd_ratio == 0
            check(r["d_moved"] == d_step, "train", f"step {r['step']}: D moved {r['d_moved']}, its update step {d_step}")
        check(all(np.isfinite(v) for v in avg.values()), "train", f"epoch means {avg}")
        emit("train", ok=True, part="steps", preset="preset_target_lighting_train", batch=b, size=256, steps=steps,
             launches=launches, d_update_steps=[r["step"] for r in records if r["d_moved"]],
             losses=[r["losses"] for r in records])

        # The first step again on the CPU: the plain argmin march and VJP,
        # the same weights (drawn on the CPU from the same seed) and batch.
        first = records[0]
        cpu = T.init_state(cfg, "cpu", torch.Generator().manual_seed(seed))
        check(torch.equal(flat_params(cpu.g), init_g.cpu()) and torch.equal(flat_params(cpu.d), init_d.cpu()),
              "train", "the CPU state's initial weights differ from the card's")
        t0 = time.perf_counter()
        cpu_losses = {k: float(v) for k, v in T.train_step(cpu, first["batch"], cfg, cfg.model.skip_gates(0)).items()}
        cpu_s = time.perf_counter() - t0
        cpu_grads = named_grads(cpu)
        card_norms, cpu_norms = grad_norms(first["grads"]), grad_norms(cpu_grads)
        loss_rel = {k: abs(first["losses"][k] - v) / max(abs(v), 1e-30) for k, v in cpu_losses.items()}
        norm_rel = {k: abs(card_norms[k] - v) / max(abs(v), 1e-30) for k, v in cpu_norms.items()}
        # Where the two gradients part most: the tensors with the largest |d|.
        diffs = sorted(((torch.linalg.vector_norm(first["grads"][k] - v).item(), torch.linalg.vector_norm(v).item(), k)
                        for k, v in cpu_grads.items()), reverse=True)
        # The yardstick: the same CPU step with the images one ulp up.
        ulp = T.init_state(cfg, "cpu", torch.Generator().manual_seed(seed))
        nudged = dict(first["batch"], image=torch.nextafter(first["batch"]["image"], torch.tensor(2.0)))
        T.train_step(ulp, nudged, cfg, cfg.model.skip_gates(0))
        ulp_norms = grad_norms(named_grads(ulp))
        ulp_rel = {k: abs(ulp_norms[k] - v) / max(abs(v), 1e-30) for k, v in cpu_norms.items()}
        del ulp
        check(max(loss_rel.values()) <= TRAIN_BARS["loss_rel"], "train", f"first step vs CPU: loss rel {loss_rel}")
        check(all(v <= TRAIN_BARS[f"{k}_grad_norm_rel"] for k, v in norm_rel.items()), "train",
              f"first step vs CPU: grad-norm rel {norm_rel}")
        emit("train", ok=True, part="first_step_vs_cpu", bars=TRAIN_BARS, loss_rel=loss_rel, grad_norm_rel=norm_rel,
             grad_norms_card=card_norms, grad_norms_cpu=cpu_norms, cpu_step_s=cpu_s,
             largest_grad_diffs=[dict(param=k, diff_norm=d, grad_norm=n) for d, n, k in diffs[:4]],
             cpu_one_ulp_input_grad_norm_rel=ulp_rel)
        del cpu

        # Speed: train_step alone (median of five windows of four steps), a
        # whole unrecorded epoch through the Trainer, and how a step splits.
        batch = {k: v.to(dev) for k, v in first["batch"].items()}
        skips = cfg.model.skip_gates(0)
        step_ms = cuda_time_ms(lambda: T.train_step(state, batch, cfg, skips), 4, warmup=2, windows=5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = trainer.run_epoch(state, 1)
        torch.cuda.synchronize()
        epoch_s = time.perf_counter() - t0

        images, mask, rcfg = batch["image"], batch["face_mask"], cfg.render
        with torch.no_grad(), no_tf32():
            net = state.g(images, skips)
            out = render(net.albedo, net.depth, net.lighting, mask, rcfg)
        depth = out.depth.contiguous()
        light_pt = (rcfg.light_distance * out.unit_light_direction).contiguous()
        ts = K._ts_for(dev, rcfg)
        _, idx = K._launch_argmin(depth, mask, light_pt, ts, rcfg)
        cot = torch.randn(depth.shape, device=dev, generator=torch.Generator(dev).manual_seed(seed))

        def cnn():
            with no_tf32():
                o = state.g(images, skips)
                (o.albedo.sum() + o.depth.sum() + o.lighting.sum()).backward()

        def disc():
            with no_tf32():
                (state.d(images.detach()).sum() + state.d(images).sum() + state.d(images.detach()).sum()).backward()

        def march_fwd():
            with torch.no_grad():
                K.RayMarchMinDistance.apply(depth, mask, light_pt, rcfg)

        split = dict(cnn_fwd_bwd_ms=cuda_time_ms(cnn, 4, windows=5), d_fwd_bwd_ms=cuda_time_ms(disc, 4, windows=5),
                     march_fwd_k2_ms=cuda_time_ms(march_fwd, 20, windows=5),
                     march_bwd_grad_ms=cuda_time_ms(lambda: K.march_grad_cuda(depth, mask, light_pt, idx, ts, cot, rcfg),
                                                    20, windows=5))
        split["rest_ms"] = step_ms - sum(split.values())
        busy_ms = device_busy_ms(lambda: T.train_step(state, batch, cfg, skips), 4)
        result = dict(step_ms=step_ms, img_per_s=b / (step_ms / 1e3), epoch_s=epoch_s,
                      epoch_img_per_s=steps * b / epoch_s, **split, device_busy_ms_per_step=busy_ms,
                      device_idle_share=max(0.0, 1.0 - busy_ms / step_ms))
        emit("train", ok=True, part="speed", batch=b, size=256, **result)
        return launches, result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


# The parallel phase: two ranks of torch.distributed. On one card they share
# it over gloo (NCCL refuses two ranks on one GPU); with a card each, NCCL.
PARALLEL_RANKS = 2
SAMPLES_LAUNCHES = {  # per rank, per sample-parallel Relighter.forward
    "strict": {"march": 1, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0},
    "draft": {"march": 0, "march_argmin": 1, "refine": 1, "march_grad": 0, "march_sp": 0},
}
GRID_STEP_LAUNCHES = {"march": 0, "march_argmin": 0, "refine": 0, "march_grad": 1, "march_sp": 1}
LATER_STEP_BARS = {k: 10 * v for k, v in TRAIN_BARS.items()}
DP_G_GRAD_NORM_REL = 0.15


def state_digest(state) -> str:
    """sha256 over a TrainState's parameters, BatchNorm statistics and Adam moments, in order."""
    import hashlib

    h = hashlib.sha256()
    for module, opt in ((state.g, state.opt_g), (state.d, state.opt_d)):
        for t in module.state_dict().values():
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        for p in module.parameters():
            for key in ("exp_avg", "exp_avg_sq"):
                if p in opt.state:
                    h.update(opt.state[p][key].detach().cpu().numpy().tobytes())
    return h.hexdigest()


def serving_inputs(goldens, dev, seed, batch=64):
    """phase_e2e's batch: the 00104 face and mask, seeded random light directions."""
    import numpy as np
    import torch

    fx = dict(goldens)["ref_transfer_00104.npz"]
    gen = torch.Generator().manual_seed(seed)
    images = torch.from_numpy(np.repeat(fx["image"][None], batch, 0)).to(dev)
    masks = torch.from_numpy(np.repeat(fx["mask"][None], batch, 0)).to(dev)
    dirs = torch.randn((batch, 3), generator=gen)
    dirs[:, 2] = dirs[:, 2].abs() + 0.5
    return images, masks, dirs.to(dev)


def train_batches(seed, b, n):
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData

    data = SyntheticFaceData(num_samples=n * b, size=256, seed=seed)
    return [data.get_batch(range(i * b, (i + 1) * b)) for i in range(n)]


def parallel_rank(dev, out_dir: str, seed: int) -> None:
    """One rank of the parallel phase; writes <out_dir>/rank<r>.json. Every
    rank runs the same calls in the same order (their collectives pair up)."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.parallel import mesh as M

    rank = torch.distributed.get_rank()
    res = dict(rank=rank, device=str(dev), backend=torch.distributed.get_backend())
    goldens = load_goldens()
    world = M.make_mesh(dev)

    # 1. Sample-parallel serving: Relighter(parallel='samples') at batch 64,
    # strict (K1 on 80 of the 160 samples) and draft (K2 on 40 of the 80
    # strided samples, then K3 on every rank), against the same forward in
    # this process alone.
    images, masks, lights = serving_inputs(goldens, dev, seed)
    res["samples"] = {}
    for tier in ("strict", "draft"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(seed)).state_dict()
        rl = Relighter(cfg, state, mesh=world, parallel="samples")
        one = Relighter(cfg, state, device=dev)
        reset_launches()
        out = rl.forward(images, masks, lights)
        torch.cuda.synchronize()
        n = dict(K.LAUNCHES)
        check(n == SAMPLES_LAUNCHES[tier], "parallel", f"{tier}: sample-parallel forward launched {n}")
        for field in out._fields:
            check(bool(torch.isfinite(getattr(out, field)).all()), "parallel", f"{tier}: non-finite {field}")
        check(tuple(out.rendered.shape) == (64, 256, 256, 3), "parallel", f"{tier}: {tuple(out.rendered.shape)}")
        want = one.forward(images, masks, lights)
        equal = (out.min_distance == want.min_distance).float().mean().item()
        # Strict: the MIN over the slices is the full grid's, bit for bit. Draft:
        # two slices' winners can tie in distance but not in norm^2, and the
        # first-winner combine may then pick another t* than the full grid
        # does, so its refine window moves on those few pixels.
        check(equal == 1.0 if tier == "strict" else equal >= 0.9999, "parallel",
              f"{tier}: min_distance equal to one process's on {equal} of pixels")
        md_err = check_march(out.min_distance, want.min_distance, "parallel", f"{tier}: sample-parallel vs one")
        rendered_equal = (out.rendered == want.rendered).float().mean().item()
        ms = cuda_time_ms(lambda: rl.forward(images, masks, lights), 4, windows=3)
        one_ms = cuda_time_ms(lambda: one.forward(images, masks, lights), 4, windows=3)
        combine_ms = cuda_time_ms(lambda: M.all_min(want.min_distance, world.world_group), 8, windows=3)
        res["samples"][tier] = dict(launches=n, min_distance_equal=equal, rendered_equal=rendered_equal,
                                    min_distance_max_abs_err=md_err, forward_ms=ms, one_process_forward_ms=one_ms,
                                    min_combine_ms=combine_ms)
        del rl, one, out, want
        torch.cuda.empty_cache()

    # 2. K5 on the golden depth maps (batch 8, 256x256, 160 samples, 80 per
    # rank): bit-equal to K2 on the full grid, its winner too on >= 0.9999 of
    # pixels; against its plain version (the plain argmin march on the slice,
    # the same combine, the plain VJP at the winner) and, through march_grad,
    # against RayMarchMinDistance (K4) on this rank alone.
    cfg = C.preset_target_lighting_train().render
    batch = goldens[:8]
    depth = torch.from_numpy(np.stack([g["depth"][0, 0] for _, g in batch])).to(dev)
    mask = torch.from_numpy(np.stack([g["mask"] for _, g in batch])).to(dev)
    unit = np.stack([g["target_light"][0] for _, g in batch]).astype(np.float32)
    light = torch.from_numpy(unit / np.linalg.norm(unit, axis=1, keepdims=True) * 4013.0).to(dev)
    cot = torch.from_numpy(np.random.default_rng(seed).normal(size=tuple(depth.shape)).astype(np.float32)).to(dev)
    n_s = world.size
    table = torch.as_tensor(S.sharded_sample_ts(cfg, n_s), device=dev)
    ts_local = table.view(n_s, -1)[rank].contiguous()
    group = world.world_group

    reset_launches()
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    out = K.RayMarchMinDistanceSP.apply(d, mask, lp, cfg, ts_local, group)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    n = dict(K.LAUNCHES)
    check(n == GRID_STEP_LAUNCHES, "parallel", f"K5 forward and backward launched {n}")
    full, full_idx = K._launch_argmin(depth, mask, light, K._ts_for(dev, cfg), cfg)
    check(torch.equal(out.detach(), full), "parallel", "K5: distances differ from K2 on the full grid")
    local_min, local_idx = K._argmin_march(depth, mask, light, ts_local, cfg)
    _, idx, _ = K._first_winner(local_min, local_idx, ts_local, group)
    idx_agree = (idx == full_idx).float().mean().item()
    check(idx_agree >= 0.9999, "parallel", f"K5: winner equal to the full grid's on {idx_agree} of pixels")
    plain_min, plain_idx = S.ray_march_argmin_batch(depth, mask, light, cfg, ts_local)
    plain_out, plain_gidx, _ = K._first_winner(plain_min, plain_idx, ts_local, group)
    k5_err = check_march(out.detach(), plain_out, "parallel", "K5 vs its plain version")
    plain_idx_agree = (plain_gidx == idx).float().mean().item()
    check(plain_idx_agree >= 0.9999, "parallel", f"K5 vs plain: winner equal on {plain_idx_agree} of pixels")
    want_d, want_l = S.march_vjp(depth, mask, light, table[idx.long()], cot, cfg)
    d4, lp4 = depth.clone().requires_grad_(), light.clone().requires_grad_()
    (K.RayMarchMinDistance.apply(d4, mask, lp4, cfg) * cot).sum().backward()
    grad_err = {}
    for tag, (gd, gl) in (("vs_plain_vjp", (want_d, want_l)), ("vs_k4", (d4.grad, lp4.grad))):
        dd_rel = (d.grad - gd).abs().max().item() / max(gd.abs().max().item(), 1e-30)
        dl_rel = ((lp.grad - gl).abs() / gl.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
        check(dd_rel <= GRAD_BARS["d_depth_rel_to_max"] and dl_rel <= GRAD_BARS["d_light_rel_to_image_max"],
              "parallel", f"K5 gradients {tag}: d_depth {dd_rel}, d_light {dl_rel}")
        grad_err[tag] = dict(d_depth_rel_to_max=dd_rel, d_light_rel_to_image_max=dl_rel)

    # K5 timed at the training shape (3, 256, 256): the whole forward, the
    # kernel on the slice alone, the combine alone, march_grad at the winner,
    # and the plain version (the plain argmin march on the slice, the combine).
    td, tm, tl, tc = (x[:3].contiguous() for x in (depth, mask, light, cot))
    with torch.no_grad():
        k5_ms = cuda_time_ms(lambda: K.RayMarchMinDistanceSP.apply(td, tm, tl, cfg, ts_local, group), 10, windows=5)
    slice_ms = cuda_time_ms(lambda: K._launch_argmin(td, tm, tl, ts_local, cfg), 20, windows=5)
    slice_device_ms = kernel_device_ms(lambda: K._launch_argmin(td, tm, tl, ts_local, cfg))
    t_min, t_idx = K._launch_argmin(td, tm, tl, ts_local, cfg)
    combine_ms = cuda_time_ms(lambda: K._first_winner(t_min, t_idx, ts_local, group), 10, windows=5)
    _, t_gidx, t_table = K._first_winner(t_min, t_idx, ts_local, group)
    bwd_ms = cuda_time_ms(lambda: K.march_grad_cuda(td, tm, tl, t_gidx, t_table, tc, cfg), 20, windows=5)
    plain_ms = cuda_time_ms(lambda: K._first_winner(*S.ray_march_argmin_batch(td, tm, tl, cfg, ts_local),
                                                    ts_local, group), 2)
    b, h, w = td.shape
    live = b * h * w  # the training march has no cull
    ops = live * (ts_local.numel() * (OPS_PER_SAMPLE[S.resolve_mask_gather(cfg)] + EXTRA_OPS_PER_SAMPLE[
        "march_argmin"]) + OPS_PER_PIXEL)
    # K2 on the slice (depth, mask, out, idx; light; the slice), then the
    # combine's inputs and outputs (local min and index in, global min and
    # index out).
    nbytes = 4 * (4 * b * h * w + 3 * b + ts_local.numel()) + 4 * 4 * b * h * w
    res["k5"] = dict(launches=n, distances_equal_full_grid=True, winner_agreement=idx_agree,
                     plain_winner_agreement=plain_idx_agree, max_abs_err=k5_err, grad_err=grad_err,
                     ms=k5_ms, kernel_ms=slice_ms, kernel_device_ms=slice_device_ms, combine_ms=combine_ms,
                     backward_ms=bwd_ms, plain_ms=plain_ms, samples_per_rank=ts_local.numel(),
                     **bound(ops, nbytes))
    del d, lp, d4, lp4, out, full, want_d
    torch.cuda.empty_cache()

    # 3. The 1x2 grid train step: two steps at preset_target_lighting_train,
    # batch 3 on each rank, the march K5 on 80 samples per rank.
    tcfg = C.preset_target_lighting_train()
    skips = tcfg.model.skip_gates(0)

    def run_steps(step, mesh, batches, b):
        state = T.init_state(tcfg, dev, torch.Generator().manual_seed(seed))
        part = mesh.batch_slice(b)
        locals_ = [T.decode_batch({k: v[part] for k, v in hb.items()}, dev) for hb in batches]
        reset_launches()
        records = []
        for local in locals_:
            m = step(state, local, use_skips=skips)
            records.append(dict(losses={k: float(v) for k, v in m.items()}, digest=state_digest(state),
                                grad_norms=grad_norms(named_grads(state))))
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        step_ms = cuda_time_ms(lambda: step(state, locals_[0], use_skips=skips), 2, warmup=1, windows=3)
        return dict(records=records, launches=launches, step_ms=step_ms)

    grid = M.make_mesh_grid(1, n_s, dev)
    res["grid"] = run_steps(T.make_grid_parallel_step(tcfg, grid), grid, train_batches(seed, 3, 2), 3)
    want = {k: 2 * v for k, v in GRID_STEP_LAUNCHES.items()}
    check(res["grid"]["launches"] == want, "parallel", f"grid steps launched {res['grid']['launches']}")
    res["grid"]["combine_share"] = combine_ms / res["grid"]["step_ms"]

    # 4. The 2x1 data-parallel step: batch 4, two images per rank.
    res["dp"] = run_steps(T.make_data_parallel_step(tcfg, world), world, train_batches(seed, 4, 1), 4)
    check(res["dp"]["launches"] == TRAIN_STEP_LAUNCHES, "parallel", f"DP step launched {res['dp']['launches']}")
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def phase_parallel(dev, seed=0):
    """Two ranks: sample-parallel serving, K5, the 1x2 grid and 2x1 data-parallel steps."""
    import shutil
    import tempfile

    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.parallel import distributed

    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="gcfr_parallel_")
    try:
        t0 = time.perf_counter()
        try:
            distributed.spawn(parallel_rank, PARALLEL_RANKS, "cuda", str(Path(tmp) / "rdzv"), args=(tmp, seed))
        except Exception as e:  # a rank raised: its traceback is in the message
            raise PhaseError(f"parallel: a rank failed: {e}") from e
        spawn_s = time.perf_counter() - t0
        ranks = [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(PARALLEL_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    label = f"{PARALLEL_RANKS} ranks on one {torch.cuda.get_device_name(0)}" if torch.cuda.device_count() < 2 \
        else f"{PARALLEL_RANKS} ranks, one card each"
    r0 = ranks[0]
    emit("parallel", ok=True, part="samples_forward", ranks=label, batch=64, size=256,
         backend=r0["backend"], per_rank={r["rank"]: r["samples"] for r in ranks})
    emit("parallel", ok=True, part="k5", ranks=label, batch=8, size=256, samples=160,
         per_rank={r["rank"]: r["k5"] for r in ranks})
    for part in ("grid", "dp"):
        for r in ranks[1:]:
            for i, (a, b) in enumerate(zip(r0[part]["records"], r[part]["records"])):
                diff = {k: (v, b["losses"][k]) for k, v in a["losses"].items() if v != b["losses"][k]}
                check(a["digest"] == b["digest"] and not diff, "parallel",
                      f"{part} step {i}: ranks 0 and {r['rank']} differ (state hashes equal: "
                      f"{a['digest'] == b['digest']}; losses that differ: {diff})")

    # The same steps in this process alone, on the same card. The ranks sum
    # in another order (BatchNorm moments over a group, march_grad's and
    # cuDNN's atomics), and G's gradient is ill-conditioned: its norm moves
    # by percents at batch 4 when the images move by one ulp, because some
    # BatchNorm channels are nearly constant and E[x^2] - E[x]^2 cancels. On
    # the CPU at this batch the data-parallel step's G norm is 4.3% from one
    # process's and one ulp of input moves it 4.0%; on an H100 6.9% and 2.0%.
    # So the first step is held at TRAIN_BARS, but the data-parallel step's G
    # norm at DP_G_GRAD_NORM_REL; the one-ulp yardstick is printed beside it.
    # Later steps at LATER_STEP_BARS, as Adam's first update (+-lr where a
    # gradient is rounding) carries the rounding into the next step's losses
    # (tests/test_torch_train.py).
    tcfg = C.preset_target_lighting_train()
    skips = tcfg.model.skip_gates(0)
    compare = {}
    for part, batches in (("grid", train_batches(seed, 3, 2)), ("dp", train_batches(seed, 4, 1))):
        nudged = T.init_state(tcfg, dev, torch.Generator().manual_seed(seed))
        first = T.decode_batch(batches[0], dev)
        T.train_step(nudged, dict(first, image=torch.nextafter(first["image"], torch.tensor(2.0, device=dev))),
                     tcfg, skips)
        ulp_norms = grad_norms(named_grads(nudged))
        del nudged
        state = T.init_state(tcfg, dev, torch.Generator().manual_seed(seed))
        rows = []
        for i, hb in enumerate(batches):
            m = T.train_step(state, T.decode_batch(hb, dev), tcfg, skips)
            got = r0[part]["records"][i]
            loss_rel = max(abs(got["losses"][k] - float(v)) / max(abs(float(v)), 1e-30) for k, v in m.items())
            norms = grad_norms(named_grads(state))
            norm_rel = {k: abs(got["grad_norms"][k] - v) / max(abs(v), 1e-30) for k, v in norms.items()}
            if i == 0:
                ulp_rel = {k: abs(ulp_norms[k] - v) / max(abs(v), 1e-30) for k, v in norms.items()}
                bars = dict(TRAIN_BARS, g_grad_norm_rel=DP_G_GRAD_NORM_REL) if part == "dp" else TRAIN_BARS
            else:
                bars = LATER_STEP_BARS
            check(loss_rel <= bars["loss_rel"], "parallel", f"{part} step {i} vs one process: loss {loss_rel}")
            check(all(v <= bars[f"{k}_grad_norm_rel"] for k, v in norm_rel.items()), "parallel",
                  f"{part} step {i} vs one process: grad norm {norm_rel}, bars {bars}")
            rows.append(dict(loss_rel=loss_rel, grad_norm_rel=norm_rel, bars=bars,
                             **({"one_ulp_input_grad_norm_rel": ulp_rel} if i == 0 else {})))
        compare[part] = rows
        del state
    torch.cuda.empty_cache()
    for part, b in (("grid", 3), ("dp", 4)):
        emit("parallel", ok=True, part=f"{part}_train", ranks=label, batch=b, size=256,
             mesh="1x2 (data x samples)" if part == "grid" else "2x1 (data)", vs_one_process=compare[part],
             per_rank={r["rank"]: {k: v for k, v in r[part].items() if k != "records"} for r in ranks},
             losses=[rec["losses"] for rec in r0[part]["records"]])
    emit("parallel", ok=True, part="summary", ranks=label, spawn_s=spawn_s)
    launches = dict.fromkeys(ALL_KERNELS, 0)
    for r in ranks:
        for counts in (*(v["launches"] for v in r["samples"].values()), r["grid"]["launches"],
                       r["dp"]["launches"]):
            for k in ALL_KERNELS:
                launches[k] += counts[k]
    return launches, r0["k5"]


def bound(ops: float, nbytes: float) -> dict:
    """The least time for the work: the larger of operations and bytes over their peaks."""
    by_ops, by_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return dict(bound_ms=1e3 * max(by_ops, by_bytes), bound_by="operations" if by_ops >= by_bytes else "bytes",
                ops=ops, bytes=nbytes)


def timing_row(name, kernel_fn, plain_fn, ops, nbytes, phase_tag, device_name="march_kernel"):
    """Time one kernel's wrapper, its device time and its plain version.

    kernel_device_ms is the kernel alone; wrapper_device_ms every kernel the
    wrapper launches (with K1-K3, the input staging too). With no
    device_name the row is a path of several kernels, and both are its
    device time.
    """
    ms = cuda_time_ms(kernel_fn, 20, warmup=3, windows=5)
    busy_ms = device_busy_ms(kernel_fn, 20)
    device_ms = kernel_device_ms(kernel_fn, name=device_name) if device_name else busy_ms
    plain_ms = cuda_time_ms(plain_fn, 2)
    row = dict(kernel=name, ms=ms, kernel_device_ms=device_ms, wrapper_device_ms=busy_ms, plain_ms=plain_ms,
               **bound(ops, nbytes))
    emit("timing", ok=True, **phase_tag, **row)
    return row


def timing_inputs(goldens, dev, batch):
    """The timed marches' inputs: the 00104 depth map and face mask, seeded random light points."""
    import numpy as np
    import torch

    fx = dict(goldens)["ref_transfer_00104.npz"]
    depth = torch.from_numpy(np.repeat(fx["depth"][:, 0], batch, 0)).to(dev).contiguous()
    mask = torch.from_numpy(np.repeat(fx["mask"][None], batch, 0)).to(dev).contiguous()
    dirs = torch.randn((batch, 3), generator=torch.Generator().manual_seed(1))
    dirs[:, 2] = dirs[:, 2].abs() + 0.5
    return depth, mask, (4013.0 * torch.nn.functional.normalize(dirs, dim=-1)).to(dev)


def phase_timing(goldens, dev, batch=64):
    """Each kernel's time per launch beside its bound and its plain version, at the main path's shapes."""
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.render import shadow_min_distance

    depth, mask, light = timing_inputs(goldens, dev, batch)

    def live_pixels(m, cfg):
        if not cfg.shadow_mask_cull:
            return m.numel()
        chunk = S.effective_col_chunk(cfg)
        return int(S.cull_live_blocks(m, chunk).sum().item()) * 8 * chunk

    def march_ops(name, live_px, n_px, samples, cfg):
        per_sample = OPS_PER_SAMPLE[S.resolve_mask_gather(cfg)] + EXTRA_OPS_PER_SAMPLE[name]
        return live_px * (samples * per_sample + OPS_PER_PIXEL) + (n_px - live_px)

    rows = {}
    for tier in ("strict", "fast"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier).render
        s, (h, w) = cfg.num_sample_points, (cfg.img_height, cfg.img_width)
        live_px = live_pixels(mask, cfg)
        ops = march_ops("march", live_px, batch * h * w, s, cfg)
        nbytes = 4 * (3 * batch * h * w + 3 * batch + s)  # depth, mask, out; light; ts
        got = K.ray_march_min_distance_cuda(depth, mask, light, cfg)
        want = S.ray_march_min_distance_batch(depth, mask, light, cfg)
        err = check_equal(got, want, "timing", f"{tier}: batch {batch}")
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
    err = check_equal(got_d, want_d, "timing", f"draft K2: batch {batch}")
    agree = check_tstar(got_t, want_t, "timing", f"draft K2: batch {batch}")
    live_px = live_pixels(m_mask, m_cfg)
    ops = march_ops("march_argmin", live_px, batch * h * w, s, m_cfg)
    nbytes = 4 * (4 * batch * h * w + 3 * batch + s)  # depth, mask, out, idx; light; ts
    tag = dict(tier="draft", batch=batch, size=h, veto=S.resolve_mask_gather(m_cfg), samples=s,
               live_pixel_fraction=live_px / (batch * h * w))
    rows["draft_argmin"] = timing_row(
        "march_argmin",
        lambda: K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True),
        lambda: S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True),
        ops, nbytes, dict(tag, tstar_agreement=agree),
    )
    rows["draft_argmin"]["max_abs_err"] = err

    # K3 as the draft path runs it: around K2's int32 index (64, 64, 64) into
    # its table, with no upsampled t* map; bit-equal to the t_map form too.
    sc = cfg.shadow_resolution_scale
    table = K._ts_for(dev, m_cfg)
    _, idx = K._argmin_march(m_depth, m_mask, m_light, table, m_cfg)
    t_map = S.upsample_tstar_nn(table[idx.long()], cfg)
    got = K.refine_around_argmin_cuda(depth, mask, light, idx, table, cfg)
    want = S.refine_min_distance_batch(depth, mask, light, t_map, cfg)
    err = check_equal(got, want, "timing", f"draft K3: batch {batch}")
    check(torch_equal_bits(K.refine_min_distance_cuda(depth, mask, light, t_map, cfg), got), "timing",
          f"draft K3: batch {batch}: the index form differs from the t_map form")
    del got, want, got_d, want_d, want_t, t_map
    n_off, (h, w) = 2 * cfg.shadow_refine_halfwidth, (cfg.img_height, cfg.img_width)
    live_px = live_pixels(mask, cfg)
    ops = march_ops("refine", live_px, batch * h * w, n_off, cfg)
    # depth, mask, out; K2's index; light; the offsets and K2's table
    nbytes = 4 * (3 * batch * h * w + batch * (h // sc) * (w // sc) + 3 * batch + n_off + table.numel())
    tag = dict(tier="draft", batch=batch, size=h, veto=S.resolve_mask_gather(cfg), samples=n_off,
               live_pixel_fraction=live_px / (batch * h * w))
    rows["draft_refine"] = timing_row(
        "refine", lambda: K.refine_around_argmin_cuda(depth, mask, light, idx, table, cfg),
        lambda: S.refine_min_distance_batch(depth, mask, light, S.upsample_tstar_nn(table[idx.long()], cfg), cfg),
        ops, nbytes, tag,
    )
    rows["draft_refine"]["max_abs_err"] = err

    # The whole draft march, as render() runs it: pool, K2, K3. Its bound
    # counts the pooling's operations and the three kernels' work, and the
    # bytes the function itself must move (depth and mask in, distances out).
    got = shadow_min_distance(depth, mask, light, cfg)
    err = check_equal(got, plain_min_distance(depth, mask, light, cfg), "timing", f"draft march: batch {batch}")
    del got
    ops = POOL_OPS_PER_PIXEL * batch * h * w + rows["draft_argmin"]["ops"] + rows["draft_refine"]["ops"]
    rows["draft_march"] = timing_row(
        "draft_march", lambda: shadow_min_distance(depth, mask, light, cfg),
        lambda: plain_min_distance(depth, mask, light, cfg), ops, 4 * (3 * batch * h * w + 3 * batch),
        dict(tag, samples=[m_cfg.num_sample_points, n_off]), device_name=None,
    )
    rows["draft_march"]["max_abs_err"] = err

    # The training march at its shapes (preset_target_lighting_train: batch
    # 3, 256x256, 160 samples, one-hot veto, no cull, no gate): K2 forward,
    # then march_grad at K2's winners with a seeded random cotangent.
    cfg = C.preset_target_lighting_train().render
    b, s, (h, w) = 3, cfg.num_sample_points, (cfg.img_height, cfg.img_width)
    td, tm, tl = depth[:b].contiguous(), mask[:b].contiguous(), light[:b].contiguous()
    got_d, got_t = K.ray_march_min_distance_cuda(td, tm, tl, cfg, return_argmin_t=True)
    want_d, want_t = S.ray_march_min_distance_batch(td, tm, tl, cfg, return_argmin_t=True)
    err = check_equal(got_d, want_d, "timing", f"train K2: batch {b}")
    agree = check_tstar(got_t, want_t, "timing", f"train K2: batch {b}")
    tag = dict(tier="train", batch=b, size=h, veto=S.resolve_mask_gather(cfg), samples=s, live_pixel_fraction=1.0)
    rows["train_argmin"] = timing_row(
        "march_argmin", lambda: K.ray_march_min_distance_cuda(td, tm, tl, cfg, return_argmin_t=True),
        lambda: S.ray_march_min_distance_batch(td, tm, tl, cfg, return_argmin_t=True),
        march_ops("march_argmin", b * h * w, b * h * w, s, cfg), 4 * (4 * b * h * w + 3 * b + s),
        dict(tag, tstar_agreement=agree),
    )
    rows["train_argmin"]["max_abs_err"] = err

    ts = K._ts_for(dev, cfg)
    _, idx = K._launch_argmin(td, tm, tl, ts, cfg)
    t_star = ts[idx.long()]
    cot = torch.randn((b, h, w), generator=torch.Generator().manual_seed(2)).to(dev)
    got_dd, got_dl = K.march_grad_cuda(td, tm, tl, idx, ts, cot, cfg)
    want_dd, want_dl = S.march_vjp(td, tm, tl, t_star, cot, cfg)
    err = (got_dd - want_dd).abs().max().item()
    check(err <= GRAD_BARS["d_depth_rel_to_max"] * want_dd.abs().max().item(), "timing", f"train march_grad: d_depth {err}")
    dl_rel = ((got_dl - want_dl).abs() / want_dl.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
    check(dl_rel <= GRAD_BARS["d_light_rel_to_image_max"], "timing", f"train march_grad: d_light {dl_rel}")
    # The work this run's data needs: pixels whose winner is on the face and
    # whose cotangent is nonzero differentiate, vetoed winners stop early.
    vetoed = S.sample_distance_at_batch(td, tm, tl, t_star, cfg) >= 1e5
    n_grad = int((~vetoed & (cot != 0)).sum().item())
    n_vetoed = int(vetoed.sum().item())
    bilinear = GRAD_OPS["bilinear_extra"] if S.resolve_mask_gather(cfg) == "bilinear" else 0
    ops = (n_grad * (GRAD_OPS["grad"] + bilinear) + n_vetoed * (GRAD_OPS["vetoed"] + bilinear)
           + (b * h * w - n_grad - n_vetoed) * GRAD_OPS["other"])
    nbytes = 4 * (5 * b * h * w + 6 * b + s)  # depth, mask, idx, cotangent, d_depth; light, d_light; ts
    rows["train_grad"] = timing_row(
        "march_grad", lambda: K.march_grad_cuda(td, tm, tl, idx, ts, cot, cfg),
        lambda: S.march_vjp(td, tm, tl, t_star, cot, cfg), ops, nbytes,
        dict(tier="train", batch=b, size=h, veto=S.resolve_mask_gather(cfg), pixels_with_gradient=n_grad,
             pixels_vetoed=n_vetoed, d_light_rel_to_image_max=dl_rel),
        device_name="march_grad_kernel",
    )
    rows["train_grad"]["max_abs_err"] = err
    return rows


def compare_timing(goldens, dev, batch=64) -> dict:
    """The march kernels at the main paths' shapes, through the API this tree and
    its parent share: K1 strict and fast, K2 at draft and at the training
    shape, the whole draft march with K2's and K3's kernel times in it, and
    K3 alone at 1, 8 and 16 offsets and fully culled. Each row: the call's ms
    (CUDA events), the kernel alone and every kernel the call launches
    (torch.profiler)."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.render import shadow_min_distance

    depth, mask, light = timing_inputs(goldens, dev, batch)

    def row(fn, name="march_kernel", **kernels):
        r = dict(ms=cuda_time_ms(fn, 20, warmup=3, windows=5), kernel_device_ms=kernel_device_ms(fn, name=name),
                 device_busy_ms=device_busy_ms(fn, 20))
        r.update({k: kernel_device_ms(fn, name=v) for k, v in kernels.items()})
        return r

    rows = {}
    for tier in ("strict", "fast"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier).render
        rows[f"K1_{tier}"] = row(lambda: K.ray_march_min_distance_cuda(depth, mask, light, cfg))
    cfg = C.apply_precision_tier(C.preset_single_image(), "draft").render
    m_depth, m_mask, m_light, m_cfg = S.scale_march_inputs(depth, mask, light, cfg)
    rows["K2_draft"] = row(lambda: K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True))
    rows["draft_march"] = row(lambda: shadow_min_distance(depth, mask, light, cfg), name="march_kernel<2>",
                              k2_device_ms="march_kernel<1>")
    # K3 alone around the upsampled t*, at 1, 8 and 16 offsets and with every
    # cull unit empty: its time per sample and per pixel apart.
    _, t_star = K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    t_map = S.upsample_tstar_nn(t_star, cfg).contiguous()
    for n in (1, 8, 16):
        offsets = ((np.arange(n) - n // 2) * cfg.t_step).astype(np.float32)
        rows[f"K3_{n}_offsets"] = row(lambda: K.refine_min_distance_cuda(depth, mask, light, t_map, cfg, offsets))
    empty = torch.zeros_like(mask)
    rows["K3_all_culled"] = row(lambda: K.refine_min_distance_cuda(depth, empty, light, t_map, cfg))
    tcfg = C.preset_target_lighting_train().render
    td, tm, tl = depth[:3].contiguous(), mask[:3].contiguous(), light[:3].contiguous()
    rows["K2_train"] = row(lambda: K.ray_march_min_distance_cuda(td, tm, tl, tcfg, return_argmin_t=True))
    return rows


def timing_child(root: Path) -> int:
    """--timing-of ROOT, compare_parent's child: build ROOT's kernels and print one compare_run line."""
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        emit("compare_run", ok=False, error="torch.cuda.is_available() is false")
        return 1
    from geomconsistentfr_torch.ops import shadows_cuda as K

    check(Path(K.__file__).resolve().is_relative_to(root), "compare", f"imported {K.__file__}, not {root}'s package")
    lib, log = K.build()
    K._library()
    emit("compare_run", ok=True, root=str(root), ptxas=ptxas_registers(log), sass=sass_counts(lib, cuobjdump_path()),
         timing=compare_timing(load_goldens(), torch.device("cuda:0")), nvidia_smi=nvidia_smi_line())
    return 0


def compare_parent(parent: Path) -> int:
    """--compare-parent DIR: DIR's kernels and this tree's, timed in turns in processes of their own."""
    runs = []
    for tree, root in (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--timing-of", str(root)],
                              capture_output=True, text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith('{"phase": "compare_run"')]
        if proc.returncode != 0 or not lines:
            emit("compare", ok=False, tree=tree, error=proc.stderr[-3000:])
            return 1
        run = json.loads(lines[-1])
        print(json.dumps(dict(run, tree=tree)), flush=True)
        runs.append((tree, run))
    summary = {key: {f"{tree}_{i}": {k: run["timing"][key][k] for k in ("ms", "kernel_device_ms")}
                     for i, (tree, run) in enumerate(runs)} for key in runs[0][1]["timing"]}
    emit("compare", ok=True, order=[t for t, _ in runs], rows=summary)
    print(runs[0][1]["nvidia_smi"], flush=True)
    return 0


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] in ("--timing-of", "--compare-parent"):
        target = Path(sys.argv[2]).resolve()
        if not (target / "geomconsistentfr_torch" / "csrc" / "march.cu").is_file():
            print(f"chip_smoke.py: {target} holds no geomconsistentfr_torch/csrc/march.cu", file=sys.stderr)
            return 2
        try:
            return timing_child(target) if sys.argv[1] == "--timing-of" else compare_parent(target)
        except PhaseError as e:
            emit("failed", ok=False, error=str(e))
            return 1
    if len(sys.argv) != 1:
        print("usage: chip_smoke.py [--compare-parent DIR]", file=sys.stderr)
        return 2
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
        lib, log = K.build()
        K._library()
        seconds = time.perf_counter() - t0
        regs = ptxas_registers(log)
        check(sorted(regs) == sorted(KERNELS), "build", f"ptxas reported {sorted(regs)}, expected {sorted(KERNELS)}")
        sass = sass_counts(lib, cuobjdump_path())
        check(sorted(sass) == sorted(KERNELS), "build", f"cuobjdump showed {sorted(sass)}, expected {sorted(KERNELS)}")
        emit("build", ok=True, seconds=seconds, kernels=list(KERNELS), ptxas=regs, sass=sass,
             loop_conversions={k: sum(lp[op] for lp in v["loops"] for op in ("F2I", "I2F", "FRND"))
                               for k, v in sass.items()})

        goldens = load_goldens()
        march_err = phase_march(goldens, dev)
        phase_golden(goldens, dev)
        launches, e2e, e2e_err = phase_e2e(goldens, dev)
        timing = phase_timing(goldens, dev)
        train_launches, train = phase_train(dev)
        parallel_launches, k5 = phase_parallel(dev)
    except PhaseError as e:
        emit("failed", ok=False, error=str(e))
        return 1

    # max_abs_err: the worst kernel-vs-plain |d| of every comparison of that
    # kernel: the march phase (batch 8), the main path's own batches and the
    # timing inputs (batch 64, and batch 3 for training); for march_grad, of
    # d_depth. `ms` (the wrapper, K1-K3's input staging included), kernel_ms
    # (the kernel alone) and the bound are at the main paths' shapes: K1 at the
    # strict tier, K2 and K3 at the draft tier (K2 at the training shape in
    # the train_* keys), march_grad at training, K5 at the training shape on
    # two ranks. `launches` sums the main paths' runs: one forward per tier,
    # the six training steps, and the parallel phase's forwards and steps
    # over both ranks.
    rows = {"march": (timing["strict"], [timing["fast"]], "geomconsistentfr_tpu/ops/shadows_pallas.py:64"),
            "march_argmin": (timing["draft_argmin"], [timing["train_argmin"]],
                             "geomconsistentfr_tpu/ops/shadows_pallas.py:881"),
            "refine": (timing["draft_refine"], [], "geomconsistentfr_tpu/ops/shadows_pallas.py:900"),
            "march_grad": (timing["train_grad"], [], "geomconsistentfr_tpu/ops/shadows_pallas.py:776")}
    kernels = []
    for name, (t, others, replaces) in rows.items():
        max_err = max(march_err[name], e2e_err[name], t["max_abs_err"], *(o["max_abs_err"] for o in others))
        row = dict(
            name=name, route="cuda", source="geomconsistentfr_torch/csrc/march.cu", replaces=replaces,
            launches=launches[name] + train_launches[name] + parallel_launches[name], max_abs_err=max_err,
            ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            kernel_ms=t["kernel_device_ms"],
        )
        if name == "march_argmin":
            k2 = timing["train_argmin"]
            row.update(train_ms=k2["ms"], train_kernel_ms=k2["kernel_device_ms"], train_plain_ms=k2["plain_ms"],
                       train_bound_ms=k2["bound_ms"])
        kernels.append(row)
    kernels.append(dict(
        name="march_sp", route="cuda", source="geomconsistentfr_torch/csrc/march.cu",
        replaces="geomconsistentfr_tpu/ops/shadows_pallas.py:815", launches=parallel_launches["march_sp"],
        max_abs_err=k5["max_abs_err"], ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
        bound_by=k5["bound_by"], library_ms=None, kernel_ms=k5["kernel_ms"], combine_ms=k5["combine_ms"],
        backward_ms=k5["backward_ms"], ranks=PARALLEL_RANKS,
    ))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
