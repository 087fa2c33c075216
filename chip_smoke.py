#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (geomconsistentfr_torch) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --compare-parent DIR

With no argument it runs the phases below. `--compare-parent DIR` times the
march kernels of another checkout (e.g. the parent commit, unpacked with
`git archive` into a git-ignored directory) beside this one's, in turns
(parent, this tree, this tree, parent), each in a child process of its own
(`--timing-of ROOT`, which times one tree), with the SASS counts of both
builds, and prints each run and a summary line (compare_timing lists the
rows). Each turn also spawns two ranks on the card (parallel_timing_rank):
K5's forward, its slice, its combine, the collectives a forward issues and
their bytes, one int64 all_reduce (the collective floor), march_grad at the
winner, the 1x2 grid step and the combine's share of it, and the
sample-parallel draft forward.

Phases (each prints one JSON line; any failure exits non-zero):
  1. device   CUDA is required (no CPU fallback); the card's name and power
              limit as nvidia-smi reports them.
  2. build    every kernel of the port is compiled from csrc/ (nvcc, sm_90a):
              march (K1), march_argmin (K2), refine (K3), march_grad (the
              backward of the training march K4, whose forward is K2),
              stage (the staging every march reads) and unpack_key (K5's
              unpack of K2's packed keys), with
              the registers ptxas reports for each and the counts of F2I,
              I2F, FRND, LDG and float32 and integer arithmetic opcodes in
              its SASS (cuobjdump -sass), in the whole function and in each
              of its loops. K1-K3 are built for each of the four vetoes
              (onehot, bilinear, hat, hat_y) and each form of their taps
              (the quad; the clamped taps for t outside [0, 1] and H or W
              above 2048), march_grad (one-hot only) in both tap forms.
  3. march    each kernel vs its plain PyTorch version on the card, batch 8,
              the golden fixtures' depth maps and face masks (K1-K3 bit for
              bit, K2's winning index on every pixel):
              K1 at 256x256, 160 and 159 samples, all four vetoes, cull
              off/row/col-32, all three gates;
              K2 on those maps pooled 4x4 under the draft tier (64x64, 80
              samples, plus a slice of the t grid), all four vetoes, cull
              off/row, all three gates, its winning index too;
              K3 at 256x256 around the plain K2's upsampled t*, all vetoes,
              cull off/col-64, all three gates, and around the plain K2's
              index (the draft path's form), bit-equal to the t_map form;
              the staging (full resolution with the cull's flags, and the
              draft pass: pooled and full quads, both flags, the light) bit
              for bit, and the draft march (staging, K2, K3) bit-equal to
              the plain draft path;
              at the surface's other batch sizes, 1 and the sweep's 21
              lights on one face: the staging, K1 and the draft march under
              the single_image, lighting_transfer and multipie_eval presets
              at every serving tier;
              march_grad at 256x256 under preset_target_lighting_train (160
              samples) and on the transfer grid (159 from 0.03), a seeded
              random cotangent, every forward veto (the backward vetoes
              one-hot), cull off/col-32, all three gates: K2 forward and
              march_grad backward through the autograd Function, against
              the plain VJP at the kernel's winners;
              at what RenderConfig admits beyond the presets (march_admitted),
              all four vetoes: the staging, K1, K2, K3 (t_map and index
              forms) bit for bit and march_grad at 60x60, 240x240 (chunk
              48) and 8x4096 (the clamped taps), and a t grid to 1.02 at
              256x256 (the clamped taps); the draft march at 240x240 (a
              60x60 low-resolution march).
  4. golden   the ten golden fixtures rendered through the kernels at the
              strict tier (K1) and at the draft tier (K2 then K3), against the
              reference outputs they store.
  5. e2e      Relighter.forward at full width (batch 64, 256x256,
              preset_single_image) at the strict, fast and draft tiers with
              random weights from a seeded torch.Generator: img/s (median of
              five windows), finite outputs, kernel launch counts (and no
              upsampled t* map, cull-flag pass or pooling op on the path;
              the march's device launches by torch.profiler), and the
              forward's min distances (bit for bit) and rendered image
              against the plain path on the same batch.
  6. cudnn    the CNN under cuDNN's default algorithms and under the
              deterministic ones that Relighter runs, strict and fast, at
              batch 1, 8 and 64: ms (alternating windows), and the bytes of
              a batch-1 visual pack that move from call to call under each.
  7. cli      `python -m geomconsistentfr_torch.cli` in processes of its own
              (every process of phases 7-10 runs the module as -m does, under
              a wrapper that reports its kernel launches and clock at exit),
              on seeded random weights saved as a .pth and the goldens
              written as PNGs by the port's own writer: relight at strict
              and draft (its six PNGs byte-equal to Relighter.forward_visuals
              at batch 1 in this process), sweep (every tile equal to
              relight_sweep_rendered_u8), transfer (the estimated light
              equal to estimate_lighting's, the render byte-equal), config
              and fix-border; seconds per command, start-up apart.
     admitted the slice of the surface at what RenderConfig admits beyond
              the presets, seven commands at once: `cli relight --config`
              at 240x240 with each tier's fields in the file (the draft's
              chunk 0: a 60x60 low-resolution march), `cli relight
              --precision fast --config` with the 'hat' and 'hat_y' vetoes
              at 256x256 (each relight's PNGs byte-equal to forward_visuals
              here, its launches its march's), and one `cli train
              --precision fast` step (bilinear forward, one-hot backward)
              within FAST_LOSS_REL of the same step here; img/s of
              Relighter.forward at batch 64 and of the step.
  8. bench    `python -m geomconsistentfr_torch.bench` at strict, fast and
              draft: its JSON lines, each value within 15% of e2e's img/s.
  9. serve    `python -m geomconsistentfr_torch.serve --port 0 --warmup`: a
              lone /relight per tier byte-equal to forward_visuals at batch
              1, eight concurrent strict requests coalesced (within one
              level), /estimate, /transfer, JPEG (or its 400), a bad tier;
              then 16 client threads x 32 PNG requests at the default tier
              (req/s, p50 and p99, /statz, the host's decode and encode ms
              a request, the cores the server and the clients kept busy)
              and SIGTERM during a burst: every admitted request answered.
 10. eval     `cli eval-multipie` on a synthetic Multi-PIE directory of 64
              triples (the protocol has 862; cut for the time limit) tiled
              from the goldens and their mirror images, scored with LPIPS (alex: a seeded trunk in
              torchvision's layout and seeded heads in the LPIPS library's):
              the dump byte-equal to forward_visuals of the same batches, the
              printed metrics equal to evaluate_output_dir's, the LPIPS mean
              of its first 16 triples (`--eval-only` in another process)
              within 1e-6 of an LPIPSMetric's on the card here; images a
              second and the scoring's, LPIPS's and the device's shares.
     train_cli  `cli build-cache` of an MP_data tree of 512 SyntheticFaceData
              samples at 256x256 (JPEGs by the port's encode_jpeg, .mat
              files, PNG depth masks): its .npy files byte-equal to
              build_cache here, its decoder named (and whether libjpeg is
              on the machine); then `cli train` on that cache at full width
              (preset_target_lighting_train, batch 3) with the set resident
              on the card, two epochs of four batches, --profile and
              --visualize-every 1: its launches (stage, K2 and march_grad a
              step, K1 for each epoch's visuals), the Chrome traces naming
              stage_kernel, march_kernel and march_grad_kernel, the visuals;
              here, the resident batches bit-equal to the streamed ones; a
              one-step epoch of another `cli train` within 1e-4 of the same
              epoch here (the four-step epoch's means are reported: the
              backward's atomics part them by more a few steps on); a
              step's ms with the set resident against streamed.
     lpips    LPIPSMetric (alex, vgg, squeeze) at 256x256, batch 1 and 8, on
              the card against the CPU (1e-4 of the map's largest value), ms
              a pair; `cli lpips-train` (a few steps) and `cli lpips-score`
              (2afc and jnd) on synthetic BAPPS trees of 64 triplets at
              64x64, the scores equal to this process's.
     crop     a seeded S3FD (its face biases shifted so that a few boxes
              pass) saved in face_alignment's keys; `cli crop --s3fd-weights`
              on a 1024x1024 frame holding a golden face: the crop byte-equal
              to crop_largest_face here; the heads on the card against the
              CPU (1e-4 relative); S3FD ms a frame, the command's seconds.
     visualize_lighting  `cli visualize-lighting`: the 21 presets' spheres
              equal to lighting_sphere here.
     orbax    the committed full-width orbax fixture that the JAX package
              wrote (tests/golden/orbax_relightnet_seed0: RelightNet's
              transfer-variant variables, OCDBT, zstd chunks) read by the
              port's own reader, every leaf against its sha256 and the read's
              seconds; load_relighter on the directory at strict and draft,
              forward_visuals of the goldens (batch 8) byte-equal to a
              Relighter of the same weights in memory; `cli convert` of the
              surface's .pth, read back to the same tensors.
     launch   two ranks under `python -m torch.distributed.run --standalone
              --nproc-per-node 2` sharing the card over gloo (each rank under
              the wrapper, which also records its exit code). Four commands
              at once: `cli relight --sample-parallel` at strict and draft,
              its PNGs byte-equal to phase cli's; `cli eval-multipie
              --data-parallel` on phase eval's triples, byte-equal to its
              dump (a row that differs is held at each rank's half batch in
              this process, and the bytes and levels it differs by at the
              whole batch are printed); `cli train` (batch 4, two epochs of
              two steps, lr 1e-6) within LATER_STEP_BARS of the same epochs
              here. Then the server with --data-parallel and with
              --grid-parallel 1x2: a lone request per tier byte-equal to
              forward_visuals at batch 1, phase serve's load (req/s, p50,
              p99 beside its one-rank numbers), every answer equal to one
              process at the batch sizes the server pads to (or at each
              rank's half of them), every tier built over both ranks, then
              SIGTERM: every rank exits 0.
 11. timing   each kernel's time per launch beside its bound and its plain
              version's time, at the main paths' shapes, after holding the
              two outputs against each other; the draft staging alone; the
              whole draft march (staging, K2, K3: three device launches) as
              a row of its own; march_grad at batch 3 and 64 (one fill and
              the kernel); a one-element fill, the launch floor; then each
              kernel in its other forms (time_forms): 'hat' and 'hat_y' at
              the main paths' shapes, 240x240 and 8x4096.
  12. train   Trainer.run_epoch at full width (preset_target_lighting_train,
              batch 3, 256x256, SyntheticFaceData, seeded random G and D),
              six steps crossing a D update at steps 0 and 5: finite losses,
              G moving every step and D only on its update steps, one K2 and
              one march_grad launch per step and no K1; the first step against
              the same step on the CPU (plain path); step ms, img/s, how the
              step splits, and the card's idle share of a step.
  13. parallel two ranks of torch.distributed (parallel/distributed.spawn,
              a file:// rendezvous): on one card they share it over gloo,
              with a card each they run NCCL. Each rank runs
              Relighter(parallel='samples') at batch 64, strict (K1 on its
              80 of the 160 samples) and draft (K2 on its slice, K3 on
              every rank), against the same forward in one process; K5 on
              the golden depth maps (batch 8, 160 samples): K2's key form
              on the rank's slice (bit-equal to its packed index form), one
              MIN of the int64 keys (exactly one collective a forward), the
              unpack (bit-equal to its plain version), march_grad at t*
              (its t-map form bit-equal to its index form); its distances
              bit-equal to K2 on the full grid and t* its winner, against
              its plain version and, through march_grad, against K4; K5
              timed at the training shape (3, 256^2: forward, combine,
              collectives, bytes a rank, the collective floor); two steps
              of the 1x2 grid train step
              (batch 3, K5 and march_grad on each rank) and one 2x1
              data-parallel step (batch 4). After each step every rank's
              parameters, BatchNorm statistics and Adam moments hash the
              same; the steps are held against the same steps in one
              process on the card. Per-rank times are labelled "2 ranks on
              one <card>": two ranks on one card scale nothing. The train
              and parallel phases run last, so the others run as before.
  14. epilogue csrc/epilogue.cu (the CNN's eval-mode epilogue) built, with
              ptxas's registers; at batch 64, channels-last as the CNN runs,
              each form at the shapes where RelightNet's forward runs it
              (EPILOGUE_ROWS: bn_act alone at 256^2 x 16, alone and with a
              projection shortcut at 16^2 x 155, where C is not a multiple
              of 4; the join with a shortcut and the skip from 16^2 x 64;
              the 16-channel 3x3 layers are phase conv3x3's), bit-equal to the
              eager composition; the kernel alone (torch.profiler) and the
              wrapper (CUDA events) per launch beside the bound by bytes at
              3.35 TB/s and the eager composition's time; Relighter's
              forward_visuals at batch 64 (tier high): the epilogues
              (epilogue_counts(): 29 launches of epilogue.cu and 18 of
              conv3x3.cu, none eager) and the BatchNorms they hold. It runs
              right after build.
  15. conv3x3  csrc/conv3x3.cu (the direct 3x3 convolution of the 16-channel
              layers, the epilogue in its store) built, with ptxas's
              registers and no spills; at each form and shape where the
              batch-64 forward runs it (CONV3X3_ROWS: bn_act alone and with a
              plain residual at 256^2 and 128^2, the transposed h8_1, the
              join with a plain residual and the skip from 128^2 and with the
              shortcut and the skip from 64^2) and at batch 1 and 8, held
              against float64 (relative error <= 1e-5 of the output's
              largest magnitude, and cuDNN's for comparison), two launches
              bit-equal; the kernel alone (torch.profiler) and the call
              (CUDA events) per launch beside cuDNN under
              deterministic_convs followed by epilogue.cu (CUDA events and
              its device time), the plain path (cuDNN, then the eager
              epilogue), the bounds by operations at 67 TFLOP/s and by bytes
              at 3.35 TB/s, and the kernel's share of the bound by
              operations; Relighter's forward_visuals at batch 64 in both
              variants: 18 direct launches, 47 epilogues, two forwards
              bit-equal, and 2 direct launches an estimate_lighting. It runs
              right after epilogue.
  16. pack     csrc/pack.cu (the uint8 visual pack of forward_visuals)
              built, with ptxas's registers and no spills; at batch 1, 8 and
              64 at 256^2, albedo and rendered as permuted NCHW maps read by
              their strides, equal byte for byte to the eager pack_visuals;
              the kernels alone (torch.profiler: the depth range and the
              pack) and the wrapper (CUDA events) per call beside the bound
              by bytes at 3.35 TB/s and the eager pack's time; Relighter's
              forward_visuals at batch 64: 1 'pack' launch beside the 29
              'epilogue' and 18 'conv3x3', its pack equal to the eager one
              on render()'s own maps (their strides, and both packs' times
              there). It runs right after conv3x3.
Last (also after a failed phase), the `profiler` line: how many
torch.profiler windows (`profiled`) it read, in how many the uncounted first
call held fewer activities than a counted one, and how many were short.
The phases from cli to launch (7-10 and those named) run in phase_surface.
Then the `kernels` JSON line (K1-K4, K5 as `march_sp`, and `unpack_key`,
which replaces the reference's pmin combine; K1-K4 with the vetoes and
shape forms phase march held them at, and their times in those forms), the
nvidia-smi line, and, last:
  {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Bars (march and golden) are those of tests/test_torch_shadows.py,
tests/test_torch_render.py and tests/test_torch_draft.py; march_grad's are
those of tests/test_torch_cuda.py (GRAD_BARS below).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden"
# The kernels by the names their launches count under: the march's three forms
# in form order, its backward, and the staging every march reads (at the draft
# tier, pooled).
KERNELS = ("march", "march_argmin", "refine", "march_grad", "stage")
# The compiled functions. Each march form is built for each form of its taps
# and for the vetoes 'onehot' (whose function also holds the 'bilinear'
# veto's loop, picked at run time), 'hat' and 'hat_y': "march",
# "march.hat", ..., "march.hat_y.clamp" (the one-hot quad form keeps the bare
# name; ".clamp" is the clamped taps of csrc/march.cu's range, for t outside
# [0, 1] and H or W above 2048); K2 is built twice more, one thread a pixel
# and (at 128 samples or more) two threads a pixel, "march_argmin_split";
# march_grad (one-hot only) in both tap forms; the unpack of K2's keys after
# their MIN over the ranks (K5), "unpack_key".
VETOES = ("onehot", "bilinear", "hat", "hat_y")
COMPILED_VETOES = (0, 2, 3)
MARCH_FORMS = ("march", "march_argmin", "refine", "march_argmin_split")


def compiled_name(base: str, veto: int = 0, clamp: bool = False) -> str:
    return base + ("" if veto == 0 else "." + VETOES[veto]) + (".clamp" if clamp else "")


COMPILED = (tuple(compiled_name(f, v, c) for f in MARCH_FORMS for v in COMPILED_VETOES for c in (False, True))
            + ("march_grad", "march_grad.clamp", "stage", "unpack_key"))
# K5 (march_sp) launches the march_argmin form's key epilogue on a rank's slice
# of the t grid; unpack_key unpacks the keys after their MIN over the ranks.
ALL_KERNELS = KERNELS + ("march_sp", "unpack_key")


def counts(**n) -> dict:
    """Launch counts of the march kernels by name (csrc/march.cu's, as cuda_lib.LAUNCHES counts
    them), 0 where not given."""
    return {k: n.get(k, 0) for k in ("stage", *KERNELS[:4], "march_sp", "unpack_key")}


def march_launches() -> dict:
    """cuda_lib.LAUNCHES' march kernels, the keys of counts() (phases epilogue and conv3x3 count
    the CNN's kernels)."""
    from geomconsistentfr_torch.ops import cuda_lib, shadows_cuda

    return {k: cuda_lib.LAUNCHES[k] for k in shadows_cuda.LIBRARY.kernels}


def epilogue_counts() -> dict:
    """The CNN's epilogues since reset_launches: 'fused' the launches of csrc/epilogue.cu and of
    csrc/conv3x3.cu, 'eager' the eager compositions (layers.EAGER_EPILOGUES)."""
    from geomconsistentfr_torch.models import layers
    from geomconsistentfr_torch.ops import cuda_lib

    return dict(fused=cuda_lib.LAUNCHES["epilogue"] + cuda_lib.LAUNCHES["conv3x3"], eager=layers.EAGER_EPILOGUES)


def build_library(library):
    """Build a kernel library (ops/cuda_lib.build) and load it: (the .so, ptxas's log)."""
    from geomconsistentfr_torch.ops import cuda_lib

    built = cuda_lib.build(library.source)
    library.load()
    return built


class CollectiveCounter:
    """Counts the torch.distributed collectives called inside it, and the bytes of the
    tensors this rank hands them (an all_gather's input, an all_reduce's buffer)."""

    NAMES = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast", "reduce", "reduce_scatter",
             "reduce_scatter_tensor", "all_to_all", "all_to_all_single", "gather", "scatter")

    def __enter__(self):
        import torch
        import torch.distributed as dist

        self.calls, self.nbytes, self._saved = 0, 0, {}
        for name in self.NAMES:
            fn = getattr(dist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def counted(*args, _fn=fn, **kwargs):
                self.calls += 1
                self.nbytes += sum(a.numel() * a.element_size() for a in args if torch.is_tensor(a))
                return _fn(*args, **kwargs)

            setattr(dist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for name, fn in self._saved.items():
            setattr(dist, name, fn)
        return False

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
# each of three sums) = 213; its veto is the one-hot veto whatever the
# forward's. A pixel whose winner is vetoed stops after the setup and the
# veto (40 + 16); every other pixel does the reduction (15).
GRAD_OPS = {"grad": 213, "vetoed": 56, "other": 15}
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


def ptxas_registers(log: str, name_of=None) -> dict:
    """kernel name -> the ptxas 'Used N registers' line of its instantiation;
    `name_of` names a mangled entry (march.cu's kernels by default), None to skip it."""
    name_of = name_of or sass_kernel_name
    regs, entry = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?(\S+?)'?(?: for|$)", line)
        if m:
            entry = m.group(1)
        elif "registers" in line and entry is not None:
            name = name_of(entry)
            if name is not None:
                regs[name] = line.split(":", 1)[-1].strip()
    return regs


def epilogue_kernel_name(mangled: str):
    """'bn_act<cl, 4>' for csrc/epilogue.cu's bn_act_kernel<true, 4>, and so for the join."""
    m = re.search(r"(bn_act|join)_kernelILb([01])ELi(\d+)E", mangled)
    return m and f"{m.group(1)}<{'cl' if m.group(2) == '1' else 'nchw'}, {m.group(3)}>"


# SASS opcode groups counted per kernel (the base opcode, before its first '.').
SASS_CONVERSIONS = ("F2I", "I2F", "FRND", "F2F", "I2FP", "F2IP")
SASS_F32 = ("FADD", "FMUL", "FFMA", "FMNMX", "FSETP", "FSEL", "FSET", "FADD32I", "FMUL32I", "FFMA32I")
SASS_INT = ("IADD3", "IADD", "IADD32I", "VIADD", "IMAD", "IMAD32I", "IMNMX", "VIMNMX", "VIADDMNMX", "ISETP",
            "LOP3", "SHF", "LEA", "IABS", "SEL", "PRMT")
SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);")


def sass_kernel_name(mangled: str):
    # march_kernel<form, lanes, veto, clamp>; a parent's may have no veto and clamp, or no lanes.
    form = re.search(r"march_kernelILi(\d)E(?:Li(\d)E)?(?:Li(\d)ELb([01])E)?", mangled)
    if form:
        base = KERNELS[int(form.group(1))] + ("_split" if form.group(2) not in (None, "1") else "")
        return compiled_name(base, int(form.group(3) or 0), form.group(4) == "1")
    if "march_grad_kernel" in mangled:
        return "march_grad.clamp" if "march_grad_kernelILb1E" in mangled else "march_grad"
    if "unpack_key_kernel" in mangled:
        return "unpack_key"
    return "stage" if "stage_kernel" in mangled else None


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
    from geomconsistentfr_torch.ops import cuda_lib

    return Path(cuda_lib._nvcc()).parent / "cuobjdump"


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


def staged_equal(got, want) -> bool:
    """Two shadows.Staged bit for bit: the same fields present, each the same bits."""
    import torch

    for field in got._fields:
        g, w = getattr(got, field), getattr(want, field)
        if (g is None) != (w is None):
            return False
        if g is not None and not (g.dtype == w.dtype and g.shape == w.shape
                                  and torch.equal(g.contiguous().view(torch.uint8), w.contiguous().view(torch.uint8))):
            return False
    return True


def device_activities(fn, per_call: int, calls: int = 5) -> list:
    """The names of the device activities (kernels, fills, copies) of `calls` calls of fn(), by torch.profiler
    (the fullest of up to PROFILE_WINDOWS windows, enough at per_call a call: see `profiled`)."""
    return [n for n, _ in profiled(fn, calls, lambda n: True, per_call)]


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


def paired_host_ms(a, b, iters: int = 20, rounds: int = 15) -> dict:
    """a() and b() by wall clock in turns within one process: windows of
    `iters` calls of each, the order alternating, each window ending on a
    synchronize. The medians per call, and the median over rounds of a's
    window over b's: the host's load moves a whole process by tens of
    percent, and moves a and b alike."""
    import statistics

    import torch

    a()
    b()
    torch.cuda.synchronize()
    ta, tb = [], []
    for r in range(rounds):
        for fn, out in ((a, ta), (b, tb)) if r % 2 == 0 else ((b, tb), (a, ta)):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) / iters * 1e3)
    return dict(a_ms=statistics.median(ta), b_ms=statistics.median(tb),
                a_over_b=statistics.median(x / y for x, y in zip(ta, tb)))


# torch.profiler on the card's machine drops a window's first device activity
# in some windows, and now and then most of a window's (a window of 20
# launches has read 2); it never adds any. So each window opens on a marker
# kernel (a one-element negation, left out), and a reading is taken again, up
# to five windows, until the window holds a whole number of launches per
# call; the fullest window is kept. Three windows in a row have read nothing
# (march_grad_cuda at batch 64, H100 80GB HBM3). After the epilogue phase's
# windows, e2e's march profile lost the first launch of a kernel in the
# window (stage_kernel of five (stage, K1) calls) in all five tries, after the
# marker and a 2 ms spin. So each window opens on the marker and a short
# spin, runs fn() once, which takes the window's first launch of each of its
# kernels, and then the counted calls between two device-side spins of about
# 2 ms (torch.cuda._sleep, after a synchronize): only the activities between
# the long spins are read.
# PROFILE_EDGES counts the windows, those whose first call held fewer
# activities than each counted call (first_call_short), and those that held
# too few activities (short).
PROFILE_WINDOWS = 5
PROFILE_PAD_CYCLES = 4_000_000
PROFILE_EDGES = {"windows": 0, "first_call_short": 0, "short": 0}


def is_spin(e) -> bool:
    """A profile window's delimiting spin: torch.cuda._sleep's kernel, 0.5 ms or longer."""
    return "spin_kernel" in e.name and e.time_range.elapsed_us() >= 500


def profiled(fn, iters: int, keep, per_call: int = 0) -> list:
    """(name, device us) of the device activities of `iters` calls of fn() that
    keep(name) accepts, from the fullest of up to PROFILE_WINDOWS windows; a
    window is enough when it holds per_call activities a call (given) or a
    whole number of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    best = []
    for _ in range(PROFILE_WINDOWS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.neg_()
            torch.cuda._sleep(1000)  # the window's first spin, too short to delimit
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
            torch.cuda.synchronize()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(PROFILE_PAD_CYCLES)
            torch.cuda.synchronize()
        device = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        spins = [i for i, e in enumerate(device) if is_spin(e)]
        first = counted = []
        if len(spins) == 2:
            first, counted = ([e for e in part if not ("neg_kernel" in e.name or "spin_kernel" in e.name) and keep(e.name)]
                              for part in (device[:spins[0]], device[spins[0] + 1:spins[1]]))
        PROFILE_EDGES["windows"] += 1
        PROFILE_EDGES["first_call_short"] += len(first) * iters < len(counted)
        seen = [(e.name, e.time_range.elapsed_us()) for e in counted]
        if len(seen) > len(best):
            best = seen
        if best and (len(best) == per_call * iters if per_call else len(best) % iters == 0):
            break
        PROFILE_EDGES["short"] += 1
    return best


def kernel_device_ms(fn, iters: int = 20, name: str = "march_kernel", readings: int = 3):
    """Device time per call of the kernels named `name` that fn() launches, as
    torch.profiler reports them: the median of `readings` readings (one has
    read half the kernel's time against its call's whole device time), or
    None if it sees no such kernel."""
    import statistics

    per_reading = []
    for _ in range(readings):
        seen = profiled(fn, iters, lambda n: name in n)
        if seen:
            per_call = max(1, round(len(seen) / iters))
            per_reading.append(sum(us for _, us in seen) / len(seen) * per_call / 1e3)
    return statistics.median(per_reading) if per_reading else None


# The epilogue's forms at the shapes (B, C, H, W) of the convolution's output
# where RelightNet's batch-64 forward runs them, and its launches there a
# forward: bn_act alone (c1_og, c2_2-3), with a projection shortcut's conv
# output and BatchNorm (h4_2); the join with a projection shortcut (the first
# decoder stage) and the skip at twice the size. The 16-channel 3x3 layers
# compute their epilogue in csrc/conv3x3.cu's store (CONV3X3_ROWS).
EPILOGUE_ROWS = (("bn_act", (64, 16, 256, 256), 5), ("bn_act", (64, 155, 16, 16), 1),
                 ("bn_act_shortcut", (64, 155, 16, 16), 1), ("join_shortcut_skip", (64, 64, 16, 16), 2))
# Float32 maps of the convolution output's size a form reads and writes, once each.
EPILOGUE_MAPS = {"bn_act": 2, "bn_act_shortcut": 3, "join_shortcut_skip": 1 + 1 + 4 + 4}


def phase_epilogue(dev):
    """The epilogue kernel built, held bit for bit against the eager composition
    at the main path's shapes, timed, and its launches counted on a batch-64 forward."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models import layers
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import epilogue_cuda as E

    t0 = time.perf_counter()
    _, log = build_library(E.LIBRARY)
    build_s = time.perf_counter() - t0
    regs = ptxas_registers(log, epilogue_kernel_name)
    gen = torch.Generator(device=dev).manual_seed(0)
    cl = torch.channels_last
    rows = []
    for form, (b, c, h, w), per_forward in EPILOGUE_ROWS:
        join = form.startswith("join")

        def rand(*s):
            return torch.randn(*s, generator=gen, device=dev).contiguous(memory_format=cl)

        def bn():
            m = layers.BatchNorm(c).to(dev).eval()
            with torch.no_grad():
                for t in (m.running_mean, m.bias):
                    t.copy_(0.3 * torch.randn(c, generator=gen, device=dev))
                for t in (m.running_var, m.weight):
                    t.copy_(0.5 + torch.rand(c, generator=gen, device=dev))
            return m

        u, v = rand(b, c, h, w), rand(b, c, h, w)
        bias, bias2 = torch.randn(c, generator=gen, device=dev), torch.randn(c, generator=gen, device=dev)
        bn1, bn2 = bn(), bn()
        skip = rand(b, c, 2 * h, 2 * w) if join else None
        a = E.Affine(u, bn1.eval_vectors(bias), True)
        r = E.Affine(v, bn2.eval_vectors(bias2), True) if "shortcut" in form else None

        def kernel():
            return E.join(a, r, 0.2, skip) if join else E.bn_act(a, r, 0.2)

        def eager():
            y = bn1(u + bias.view(1, -1, 1, 1), torch.float32)
            if "shortcut" in form:
                y = bn2(v + bias2.view(1, -1, 1, 1), torch.float32) + y
            y = layers.leaky_relu(y, 0.2)
            return layers.upsample2_nearest(y) + skip if join else y

        with torch.no_grad():
            got, want = kernel(), eager()
            torch.cuda.synchronize()
            check(torch_equal_bits(got, want) and got.stride() == want.stride(), "epilogue",
                  f"{form} at {(b, c, h, w)}: the kernel differs from the eager composition")
            name = "join_kernel" if join else "bn_act_kernel"
            bound = EPILOGUE_MAPS[form] * b * c * h * w * 4 / PEAK_BYTES_PER_S * 1e3
            kernel_ms = kernel_device_ms(kernel, name=name)
            rows.append(dict(form=form, shape=[b, c, h, w], per_forward=per_forward, kernel_ms=kernel_ms,
                             ms=cuda_time_ms(kernel, 20, windows=3), eager_ms=cuda_time_ms(eager, 20, windows=3),
                             bound_ms=bound, bound_by="bytes",
                             hbm_share=None if kernel_ms is None else bound / kernel_ms))
        del u, v, skip, got, want, a, r

    # The benchmark's configuration: Relighter.forward_visuals at batch 64, tier high.
    cfg = C.apply_precision_tier(C.preset_single_image(), "high")
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    rl = Relighter(cfg, state, device=dev)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    masks = np.full((64, 256, 256), 255, np.uint8)
    light = np.repeat(np.asarray([[0.3, 0.4, 0.87]], np.float32), 64, 0)
    rl.forward_visuals(images, masks, light)
    reset_launches()
    rl.forward_visuals(images, masks, light).cpu()
    epilogues = epilogue_counts()
    bns = sum(isinstance(m, layers.BatchNorm) for m in rl.model.modules())
    check(epilogues == {"fused": 47, "eager": 0}, "epilogue", f"a batch-64 forward evaluated {epilogues}")
    emit("epilogue", ok=True, build_s=build_s, ptxas=regs, rows=rows, forward_epilogues=epilogues,
         forward_batchnorms=bns)


def conv3x3_kernel_name(mangled: str):
    """'conv3x3' for csrc/conv3x3.cu's conv3x3_kernel."""
    return "conv3x3" if "conv3x3_kernel" in mangled else None


# The direct convolution's rows: its form, the (B, 16, H, W) input, whether the
# layer is a ConvTranspose2d, and its launches a batch-64 forward (both
# decoders and the encoder): bn_act alone at 256^2 (skip_s4_1, c2_1) and 128^2
# (h1_1, skip_s3_1; the deconv h8_1), with a plain residual (skip_s4_2; h1_2,
# skip_s3_2), the join with a plain residual and the skip from 128^2 (h8_2),
# with the projection shortcut from 32 channels and the skip from 64^2 (h7_2);
# then the batch sizes of the sweep (1) and the server (8), which no cell runs.
CONV3X3_ROWS = (("bn_act", (64, 16, 256, 256), False, 4), ("bn_act_residual", (64, 16, 256, 256), False, 2),
                ("bn_act", (64, 16, 128, 128), False, 3), ("bn_act", (64, 16, 128, 128), True, 2),
                ("bn_act_residual", (64, 16, 128, 128), False, 3),
                ("join_residual_skip", (64, 16, 128, 128), True, 2),
                ("join_shortcut_skip", (64, 16, 64, 64), True, 2),
                ("bn_act", (1, 16, 256, 256), False, 0), ("bn_act", (8, 16, 256, 256), False, 0),
                ("bn_act_residual", (1, 16, 128, 128), False, 0), ("bn_act_residual", (8, 16, 128, 128), False, 0),
                ("join_shortcut_skip", (1, 16, 64, 64), True, 0), ("join_shortcut_skip", (8, 16, 64, 64), True, 0))
CONV3X3_LAUNCHES = {"forward": 18, "estimate": 2}


def conv3x3_call(form, shape, transposed, dev, seed):
    """(conv_bn_act on seeded inputs in `form`, the same in float64 on the eager formulas,
    float32 maps the call reads and writes once each)."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from geomconsistentfr_torch.models import layers
    from geomconsistentfr_torch.ops import conv3x3_cuda as D

    gen = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    b, c, h, w = shape

    def rand(*s):
        return torch.randn(*s, generator=gen, device=dev).contiguous(memory_format=cl)

    def bn(ch):
        m = layers.BatchNorm(ch).to(dev).eval()
        with torch.no_grad():
            for t in (m.running_mean, m.bias):
                t.copy_(0.3 * torch.randn(ch, generator=gen, device=dev))
            for t in (m.running_var, m.weight):
                t.copy_(0.5 + torch.rand(ch, generator=gen, device=dev))
        return m

    x = rand(b, c, h, w)
    conv = (nn.ConvTranspose2d if transposed else nn.Conv2d)(c, c, 3, padding=1).to(dev)
    main = layers.Branch(conv, bn(c), x, torch.float32)
    join = form.startswith("join")
    skip = rand(b, c, 2 * h, 2 * w) if join else None
    residual, maps = None, 2
    if "residual" in form:
        residual, maps = rand(b, c, h, w), 3
    elif "shortcut" in form:
        v = rand(b, 2 * c, h, w)
        residual, maps = layers.Branch((nn.ConvTranspose2d if transposed else nn.Conv2d)(2 * c, c, 3, padding=1)
                                       .to(dev), bn(c), v, torch.float32), 3
    if join:
        maps += 3 + 4  # the output and the skip at four times the size, less the one counted
    extra = dict(upsample=True, skip=skip) if join else {}

    def call():
        return layers.conv_bn_act(main, residual, 0.2, dtype=torch.float32, **extra)

    def want64():
        def affine(br, u):
            m = br.bn
            y = u + br.conv.bias.double().view(1, -1, 1, 1)
            return ((y - m.running_mean.double().view(1, -1, 1, 1)) / torch.sqrt(m.running_var.double() + m.eps)
                    .view(1, -1, 1, 1)) * m.weight.double().view(1, -1, 1, 1) + m.bias.double().view(1, -1, 1, 1)

        y = affine(main, F.conv2d(x.double(), D.conv_weight(conv).double(), padding=1))
        if isinstance(residual, layers.Branch):
            y = y + affine(residual, F.conv2d(residual.x.double(), D.conv_weight(residual.conv).double(), padding=1))
        elif residual is not None:
            y = y + residual.double()
        y = torch.where(y >= 0, y, 0.2 * y)
        return F.interpolate(y, scale_factor=2, mode="nearest") + skip.double() if join else y

    return call, want64, maps


def patched(module, name, value, fn):
    """fn() with module.name set to value for the call."""
    def run():
        saved = getattr(module, name)
        setattr(module, name, value)
        try:
            return fn()
        finally:
            setattr(module, name, saved)
    return run


def phase_conv3x3(dev):
    """The direct convolution built, held against float64 at the main path's shapes and at
    batch 1 and 8, timed against cuDNN (deterministic) followed by epilogue.cu, and its
    launches counted on a batch-64 forward and an estimate pass."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models import layers
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import conv3x3_cuda as D
    from geomconsistentfr_torch.ops import cuda_lib
    from geomconsistentfr_torch.ops import epilogue_cuda as E

    t0 = time.perf_counter()
    _, log = build_library(D.LIBRARY)
    build_s = time.perf_counter() - t0
    regs = ptxas_registers(log, conv3x3_kernel_name)
    check(sorted(regs) == ["conv3x3"], "conv3x3", f"ptxas reported {regs}")
    check(not re.search(r"[1-9]\d* bytes spill", log), "conv3x3", f"ptxas reports spills: {log}")
    rows = []
    for i, (form, (b, c, h, w), transposed, per_forward) in enumerate(CONV3X3_ROWS):
        call, want64, maps = conv3x3_call(form, (b, c, h, w), transposed, dev, i)
        cudnn = patched(D, "takes", lambda *args: False, call)  # cuDNN, then epilogue.cu
        plain = patched(E, "use_fused", lambda *args: False, call)  # cuDNN, then the eager epilogue

        with torch.no_grad(), layers.exact_convs():
            reset_launches()
            got, again = call(), call()
            torch.cuda.synchronize()
            direct = cuda_lib.LAUNCHES["conv3x3"]
            check(direct == 2, "conv3x3", f"{form} at {(b, c, h, w)}: {direct} direct launches")
            check(torch_equal_bits(got, again), "conv3x3", f"{form} at {(b, c, h, w)}: two launches differ")
            want = want64()
            scale = want.abs().max().item()
            rel_err = (got.double() - want).abs().max().item() / scale
            cudnn_err = (cudnn().double() - want).abs().max().item() / scale
            check(rel_err <= 1e-5, "conv3x3", f"{form} at {(b, c, h, w)}: relative error {rel_err} against float64")
            del got, again, want
            ops = 2 * b * h * w * c * c * 9
            nbytes = maps * b * c * h * w * 4
            by_ops, by_bytes = ops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
            kernel_ms = kernel_device_ms(call, name="conv3x3_kernel")
            rows.append(dict(form=form, shape=[b, c, h, w], transposed=transposed, per_forward=per_forward,
                             rel_err=rel_err, cudnn_rel_err=cudnn_err,
                             kernel_ms=kernel_ms, ms=cuda_time_ms(call, 10, windows=3),
                             cudnn_ms=cuda_time_ms(cudnn, 10, windows=3),
                             cudnn_device_ms=sum(us for _, us in profiled(cudnn, 10, lambda n: True)) / 10 / 1e3,
                             plain_ms=cuda_time_ms(plain, 10, windows=3),
                             bound_ms=max(by_ops, by_bytes),
                             bound_by="operations" if by_ops >= by_bytes else "bytes", ops_bound_ms=by_ops,
                             bytes_bound_ms=by_bytes,
                             ops_share=None if kernel_ms is None else by_ops / kernel_ms))
        del call, want64
        torch.cuda.empty_cache()

    # Relighter.forward_visuals at batch 64, tier high, both variants, and an estimate pass.
    forward = {}
    for variant, preset in (("target", C.preset_single_image), ("transfer", C.preset_lighting_transfer)):
        cfg = C.apply_precision_tier(preset(), "high")
        rl = Relighter(cfg, RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict(),
                       device=dev)
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
        masks = np.full((64, 256, 256), 255, np.uint8)
        light = np.repeat(np.asarray([[0.3, 0.4, 0.87]], np.float32), 64, 0)
        first = rl.forward_visuals(images, masks, light).cpu()
        reset_launches()
        again = rl.forward_visuals(images, masks, light).cpu()
        counts = dict(direct=cuda_lib.LAUNCHES["conv3x3"], **epilogue_counts())
        check(torch.equal(first, again), "conv3x3", f"{variant}: two batch-64 forwards differ")
        reset_launches()
        rl.estimate_lighting(images)[0].cpu()
        counts["estimate_direct"] = cuda_lib.LAUNCHES["conv3x3"]
        want = dict(direct=CONV3X3_LAUNCHES["forward"], fused=47, eager=0,
                    estimate_direct=CONV3X3_LAUNCHES["estimate"])
        check(counts == want, "conv3x3", f"{variant}: {counts}, expected {want}")
        forward[variant] = counts
        del rl
    emit("conv3x3", ok=True, build_s=build_s, ptxas=regs, rows=rows, forward=forward)


# The pack's rows: (B, H, W); a pixel reads 13 float32 values and its depth once more for
# the range, and writes 12 bytes.
PACK_ROWS = ((64, 256, 256), (8, 256, 256), (1, 256, 256))
PACK_BYTES_PER_PIXEL = 13 * 4 + 4 + 12


def pack_kernel_name(mangled: str):
    """'range' and 'pack' for csrc/pack.cu's range_kernel and pack_kernel."""
    m = re.search(r"(range|pack)_kernel", mangled)
    return m and m.group(1)


def pack_maps(shape, dev, seed):
    """(outputs, masks) on the card in the renderer's ranges, binary masks; albedo and rendered
    as (B, H, W, 3) views of NCHW maps, read by their strides (render() leaves them contiguous,
    as the forward below does)."""
    import torch

    from geomconsistentfr_torch.render import RenderOutputs

    b, h, w = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*s):
        return torch.rand(*s, generator=gen, device=dev)

    maps = dict(rendered=rand(b, 3, h, w).permute(0, 2, 3, 1) * 1.3, albedo=rand(b, 3, h, w).permute(0, 2, 3, 1),
                surface_normals=rand(b, h, w, 3) * 2.0 - 1.0, shadow_mask_weights=rand(b, h, w),
                depth=rand(b, h, w) * 60.0 + 70.0, final_shading=rand(b, h, w) * 1.5)
    return RenderOutputs(**{f: maps.get(f) for f in RenderOutputs._fields}), (rand(b, h, w) > 0.2).float()


def phase_pack(dev):
    """The pack kernel built, held byte for byte against the eager pack at batch 1, 8 and 64,
    timed against it and its bound, and its launches counted on a batch-64 forward_visuals."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch import infer
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import cuda_lib
    from geomconsistentfr_torch.ops import pack_cuda as P

    t0 = time.perf_counter()
    _, log = build_library(P.LIBRARY)
    build_s = time.perf_counter() - t0
    regs = ptxas_registers(log, pack_kernel_name)
    check(sorted(regs) == ["pack", "range"], "pack", f"ptxas reported {regs}")
    check(not re.search(r"[1-9]\d* bytes spill", log), "pack", f"ptxas reports spills: {log}")
    rows = []
    for i, (b, h, w) in enumerate(PACK_ROWS):
        outputs, masks = pack_maps((b, h, w), dev, i)

        def kernel():
            return infer.pack_visuals(outputs, masks)

        eager = patched(P, "takes", lambda *args: False, kernel)
        with torch.no_grad():
            reset_launches()
            got = kernel()
            torch.cuda.synchronize()
            check(cuda_lib.LAUNCHES["pack"] == 1, "pack", f"{(b, h, w)}: {cuda_lib.LAUNCHES['pack']} launches")
            check(torch.equal(got, eager()), "pack", f"{(b, h, w)}: the kernel differs from the eager pack")
            del got
            pack_ms = kernel_device_ms(kernel, name="pack_kernel")
            range_ms = kernel_device_ms(kernel, name="range_kernel")
            kernel_ms = None if pack_ms is None or range_ms is None else pack_ms + range_ms
            bound = PACK_BYTES_PER_PIXEL * b * h * w / PEAK_BYTES_PER_S * 1e3
            rows.append(dict(shape=[b, h, w], kernel_ms=kernel_ms, pack_kernel_ms=pack_ms, range_kernel_ms=range_ms,
                             ms=cuda_time_ms(kernel, 20, windows=3), eager_ms=cuda_time_ms(eager, 20, windows=3),
                             bound_ms=bound, bound_by="bytes",
                             hbm_share=None if kernel_ms is None else bound / kernel_ms))
        del outputs, masks
        torch.cuda.empty_cache()

    # The benchmark's configuration: Relighter.forward_visuals at batch 64, tier high.
    cfg = C.apply_precision_tier(C.preset_single_image(), "high")
    rl = Relighter(cfg, RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict(), device=dev)
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (64, 256, 256, 3), dtype=np.uint8)
    masks = (rng.random((64, 256, 256)) > 0.2).astype(np.float32)
    light = np.repeat(np.asarray([[0.3, 0.4, 0.87]], np.float32), 64, 0)
    rl.forward_visuals(images, masks, light)
    reset_launches()
    got = rl.forward_visuals(images, masks, light)
    torch.cuda.synchronize()
    launches = {k: cuda_lib.LAUNCHES[k] for k in ("epilogue", "conv3x3", "pack")}
    check(launches == {"epilogue": 29, "conv3x3": 18, "pack": 1}, "pack", f"a batch-64 forward launched {launches}")
    with torch.no_grad():
        outputs, m = rl._forward_local(images, masks, light, None)
        strides = {f: list(getattr(outputs, f).stride()) for f in P.CHANNEL_MAPS + P.PLANE_MAPS}
        kernel = functools.partial(infer.pack_visuals, outputs, m)
        eager = patched(P, "takes", lambda *args: False, kernel)
        check(torch.equal(got, eager()), "pack", "the batch-64 forward's pack differs from the eager pack")
        render_ms = dict(ms=cuda_time_ms(kernel, 20, windows=3), eager_ms=cuda_time_ms(eager, 20, windows=3))
    emit("pack", ok=True, build_s=build_s, ptxas=regs, rows=rows, forward_launches=launches, render_strides=strides,
         render_outputs=render_ms)


def load_goldens():
    import numpy as np

    fixtures = sorted(GOLDEN.glob("ref_*.npz"))
    check(len(fixtures) == 10, "golden", f"expected 10 golden fixtures, found {len(fixtures)}")
    return [(p.name, dict(np.load(p))) for p in fixtures]


def reset_launches():
    """Every kernel's launch count (cuda_lib.LAUNCHES) and the eager epilogues' to 0."""
    from geomconsistentfr_torch.models import layers
    from geomconsistentfr_torch.ops import cuda_lib

    cuda_lib.LAUNCHES.update(dict.fromkeys(cuda_lib.LAUNCHES, 0))
    layers.EAGER_EPILOGUES = 0


def phase_march(goldens, dev):
    """Each kernel vs its plain version on the card, batch 8, real face data."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.lighting_presets import LIGHT_PRESETS
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
    # What each kernel was held at: its vetoes and its shape forms.
    ran = {k: dict(vetoes=set(), forms=set()) for k in KERNELS[:4]}

    def held(kernel, veto, form):
        ran[kernel]["vetoes"].add(veto)
        ran[kernel]["forms"].add(form)

    tstar_agree = 1.0
    for preset in ("preset_single_image", "preset_lighting_transfer"):
        base = getattr(C, preset)().render
        draft = C.apply_precision_tier(getattr(C, preset)(), "draft").render
        for gather in VETOES:
            for gate in ("none", "inside_image", "wide"):
                for cull in (dict(), dict(shadow_mask_cull=True), dict(shadow_mask_cull=True, shadow_col_chunk=32)):
                    cfg = dataclasses.replace(base, shadow_mask_gather=gather, shadow_bias_gate=gate, **cull)
                    got = K.ray_march_min_distance_cuda(depth, mask, light, cfg)
                    want = S.ray_march_min_distance_batch(depth, mask, light, cfg)
                    torch.cuda.synchronize()
                    tag = f"K1 {preset}/{gather}/{cull}/{gate}"
                    if gate == "none":  # the staging at full resolution, with the cull's flags
                        check(staged_equal(K._stage(depth, mask, light, cfg, flags=True),
                                           S.stage_inputs(depth, mask, light, cfg)), "march", f"stage {tag}")
                        runs["stage"] += 1
                    worst["march"] = max(worst["march"], check_equal(got, want, "march", tag))
                    runs["march"] += 1
                    held("march", gather, "256x256")

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
                        held("march_argmin", gather, "64x64")
                        if ts is not None:
                            continue
                        t_map = S.upsample_tstar_nn(want_t, cfg)
                        got = K.refine_min_distance_cuda(depth, mask, light, t_map, cfg)
                        want = S.refine_min_distance_batch(depth, mask, light, t_map, cfg)
                        # The draft path's form: the centre read from the plain K2's index.
                        table, _ = K._ts_for(dev, m_cfg)
                        _, want_idx = S.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, table)
                        got_from_idx = K.refine_around_argmin_cuda(depth, mask, light, want_idx, table, cfg)
                        torch.cuda.synchronize()
                        tag = f"K3 {preset}/{gather}/cull={cull}/{gate}"
                        worst["refine"] = max(worst["refine"], check_equal(got, want, "march", tag))
                        check(torch_equal_bits(got_from_idx, got), "march", f"{tag}: the index form differs")
                        runs["refine"] += 1
                        held("refine", gather, "256x256")
                        # The draft path itself: the staging pass (bit-equal to its
                        # plain version), K2 on its pooled quad and flags, K3 on its
                        # full-resolution quad and flags.
                        check(staged_equal(K._stage(depth, mask, light, cfg, draft=True, flags=True),
                                           S.stage_inputs(depth, mask, light, cfg)), "march", f"draft stage {tag}")
                        runs["stage"] += 1
                        check_equal(K.draft_march(depth, mask, light, cfg), want, "march", f"draft march {tag}")

    # The shapes the user-facing surface gives the kernels: batch 1 (a CLI
    # relight or transfer, a lone server request) and the sweep's batch of
    # every light preset on one face, under each preset the surface runs at
    # each serving tier's own march settings: the staging, K1, and the draft
    # march (staging, K2, K3) against their plain versions.
    fx = dict(goldens)["ref_transfer_00104.npz"]
    preset_units = np.asarray(list(LIGHT_PRESETS.values()), np.float32)
    surface_runs = {}
    for units in (unit[2:3], preset_units):
        b = len(units)
        d = torch.from_numpy(np.repeat(fx["depth"][0, 0][None], b, 0)).to(dev)
        m = torch.from_numpy(np.repeat(fx["mask"][None], b, 0)).to(dev)
        for preset in ("single_image", "lighting_transfer", "multipie_eval"):
            for tier in ("strict", "high", "fast", "draft"):
                cfg = C.apply_precision_tier(C.PRESETS[preset](), tier).render
                lp = torch.from_numpy(units / np.linalg.norm(units, axis=1, keepdims=True)
                                      * np.float32(cfg.light_distance)).to(dev)
                tag = f"batch {b} {preset}/{tier}"
                if tier == "draft":
                    m_depth, m_mask, m_light, m_cfg = S.scale_march_inputs(d, m, lp, cfg)
                    _, want_t = S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
                    want = S.refine_min_distance_batch(d, m, lp, S.upsample_tstar_nn(want_t, cfg), cfg)
                    check(staged_equal(K._stage(d, m, lp, cfg, draft=True, flags=True), S.stage_inputs(d, m, lp, cfg)),
                          "march", f"draft stage {tag}")
                    worst["refine"] = max(worst["refine"], check_equal(K.draft_march(d, m, lp, cfg), want, "march",
                                                                       f"draft march {tag}"))
                else:
                    check(staged_equal(K._stage(d, m, lp, cfg, flags=True), S.stage_inputs(d, m, lp, cfg)),
                          "march", f"stage {tag}")
                    got = K.ray_march_min_distance_cuda(d, m, lp, cfg)
                    want = S.ray_march_min_distance_batch(d, m, lp, cfg)
                    worst["march"] = max(worst["march"], check_equal(got, want, "march", f"K1 {tag}"))
                torch.cuda.synchronize()
                key = f"batch_{b}_{'draft_march' if tier == 'draft' else 'march'}"
                surface_runs[key] = surface_runs.get(key, 0) + 1

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
        for gather in VETOES:
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
                    held("march_grad", gather, "256x256")
    admitted = march_admitted(batch, dev, worst, grad_err, held)
    worst["march_grad"] = grad_err["d_depth"]
    emit("march", ok=True, configs=runs, batch=8, surface_configs=surface_runs,
         bit_equal=["march", "march_argmin", "refine", "stage"],
         size={"march": 256, "march_argmin": 64, "refine": 256, "march_grad": 256},
         samples={"march": [160, 159], "march_argmin": [80, 36], "refine": 8, "march_grad": [160, 159]},
         tstar_agreement=tstar_agree, max_abs_err=worst, march_grad_err=grad_err, march_grad_bars=GRAD_BARS,
         admitted=admitted)
    return worst, {k: {f: sorted(v) for f, v in r.items()} for k, r in ran.items()}


# The sizes and t tables RenderConfig admits beyond the presets', as phase
# march holds them (H, W, shadow_col_chunk): rows that no 8-row group fills,
# a chunk that is no power of two, W above 2048 (the clamped taps).
ADMITTED_SHAPES = {"60x60": (60, 60, 0), "240x240_col48": (240, 240, 48), "8x4096": (8, 4096, 0)}


def admitted_inputs(batch, dev, h, w):
    """The golden depth maps and face masks cut (or tiled along a row) to h x w, and far lights."""
    import numpy as np
    import torch

    depth = np.stack([g["depth"][0, 0] for _, g in batch])
    mask = np.stack([g["mask"] for _, g in batch]).astype(np.float32)
    if w > depth.shape[2]:  # rows of 8 images side by side, each image's row band in turn
        reps = w // depth.shape[2]
        pick = lambda a: np.concatenate([np.roll(a, i, axis=0)[:, 120:120 + h] for i in range(reps)], axis=2)
        depth, mask = pick(depth), pick(mask)
    else:
        y0, x0 = (depth.shape[1] - h) // 2, (depth.shape[2] - w) // 2
        depth, mask = depth[:, y0:y0 + h, x0:x0 + w], mask[:, y0:y0 + h, x0:x0 + w]
    unit = np.stack([g["target_light"][0] for _, g in batch]).astype(np.float32)
    light = unit / np.linalg.norm(unit, axis=1, keepdims=True) * 4013.0
    light[0] = [0.37 * w / 4, -0.29 * h / 4, 20.0]  # inside the image
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev) for a in (depth, mask, light)]


SPARSE_PIXELS = 512  # march_admitted's cotangent: nonzero on this many pixels of each image


def sparse_cotangent(shape, rng, dev, first_col=0, edge=0):
    """A seeded normal cotangent on SPARSE_PIXELS random pixels of each image from column
    `first_col` on and on every pixel of its last `edge` columns, 0 elsewhere, and those pixels'
    flat indices (B, k)."""
    import numpy as np
    import torch

    b, h, w = shape
    cols = np.arange(h * w) % w
    pool, last = np.flatnonzero((cols >= first_col) & (cols < w - edge)), np.flatnonzero(cols >= w - edge)
    pix = np.stack([np.concatenate([rng.choice(pool, SPARSE_PIXELS, replace=False), last]) for _ in range(b)])
    cot = np.zeros((b, h * w), np.float32)
    np.put_along_axis(cot, pix, rng.normal(size=pix.shape).astype(np.float32), axis=1)
    return torch.from_numpy(cot.reshape(shape)).to(dev), torch.from_numpy(pix).to(dev)


def light_terms(depth, mask, light, t_star, cot, pix, cfg, chunk=1024):
    """(B, 3) float64: per image, the sum over the pixels `pix` (B, k) (every pixel with a nonzero
    cotangent) of |that pixel's term of d_light| (the plain VJP with the cotangent kept at one
    pixel at a time, `chunk` pixels a call)."""
    import torch

    from geomconsistentfr_torch.ops import shadows as S

    b, h, w = depth.shape
    out = torch.zeros((b, 3), dtype=torch.float64, device=depth.device)
    for i in range(b):
        for part in pix[i].split(chunk):
            k = part.numel()
            one = torch.zeros((k, h * w), device=depth.device)
            one[torch.arange(k, device=depth.device), part] = cot[i].reshape(-1)[part]
            rep = [x[i:i + 1].expand(k, *x.shape[1:]).contiguous() for x in (depth, mask, light, t_star)]
            _, dl = S.march_vjp(*rep, one.view(k, h, w), cfg)
            out[i] += dl.abs().double().sum(dim=0)
    return out


def endpoints(xx, yy, lx, ly, cfg, pick=None):
    """shadows.border_endpoints, with its one data-dependent branch (the exit through a
    horizontal border, `inter`) and its clamps taken from `pick` where given, as this function
    returns them -> (ex, ey, pick)."""
    import torch

    from geomconsistentfr_torch.ops import shadows as S

    left, right = -cfg.half_w, cfg.img_width - cfg.half_w - 1.0
    bottom, top = 1.0 - cfg.half_h, cfg.half_h
    slopes = (ly - yy) / (lx - xx + S.EPS)
    icpt = ly - slopes * lx
    xv = torch.where(lx < left, left, right)
    yh = torch.where(ly < bottom, bottom, top)
    ey_v = slopes * xv + icpt
    ex_h = (yh - icpt) / (slopes + S.EPS)
    zx_mid, zy_mid = (lx >= left) & (lx <= right), (ly >= bottom) & (ly <= top)
    inter = (ex_h >= left) & (ex_h <= right) if pick is None else pick[0]
    inside = zx_mid & zy_mid
    ex = torch.where(inside, lx, torch.where(zy_mid, xv, torch.where(zx_mid | inter, ex_h, xv)))
    ey = torch.where(inside, ly, torch.where(zy_mid | ~(zx_mid | inter), ey_v, yh))
    if pick is None:
        pick = (inter, ex < left, ex > right, ey < bottom, ey > top)
    ex = torch.where(pick[1], left, torch.where(pick[2], right, ex))
    ey = torch.where(pick[3], bottom, torch.where(pick[4], top, ey))
    return ex, ey, pick


def light_grad_f64(depth, mask, light, t_star, cot, cfg):
    """(B, 3) float64: the plain VJP's d_light (shadows.march_vjp: the one-hot veto, the cull) in
    float64 arithmetic, with every discrete choice (the endpoint's branch and clamps, the four
    taps, the veto) taken from its float32 evaluation: the gradient that both float32 versions
    approximate, apart from them only by rounding."""
    import torch

    from geomconsistentfr_torch.ops import shadows as S

    b, h, w = depth.shape
    hw, hh = cfg.half_w, cfg.half_h
    xx, yy = S.pixel_grid_centered(h, w, device=depth.device)
    ex, ey, pick = endpoints(xx, yy, light[:, 0].view(b, 1, 1), light[:, 1].view(b, 1, 1), cfg)
    want = S.border_endpoints(xx, yy, light[:, 0].view(b, 1, 1), light[:, 1].view(b, 1, 1), cfg)
    check(torch.equal(ex, want[0]) and torch.equal(ey, want[1]), "march", "endpoints() is not border_endpoints")
    sx, sy = S._fma(t_star, ex - xx, xx), S._fma(t_star, ey - yy, yy)
    xt, yt = sx + hw - S.EPS, (hh - sy) - S.EPS
    x0, x1, y0, y1 = xt.floor(), xt.ceil(), yt.floor(), yt.ceil()
    on = S._gather((mask != 0).float().reshape(b, -1), hh - torch.round(sy), torch.round(sx) + hw, h, w) != 0
    if cfg.shadow_mask_cull:
        on &= S._live_pixels(mask, cfg)
    dep = depth.double().reshape(b, -1)
    d_ul, d_ur, d_ll, d_lr = (S._gather(dep, y, x, h, w) for y, x in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))

    xx, yy, d0, t = xx.double(), yy.double(), depth.double(), t_star.double()
    lp = light.double().requires_grad_()
    lx, ly, lz = (lp[:, i].view(b, 1, 1) for i in range(3))
    ex, ey, _ = endpoints(xx, yy, lx, ly, cfg, pick)
    xt, yt = t * (ex - xx) + xx + hw - S.EPS, (hh - (t * (ey - yy) + yy)) - S.EPS
    iu = d_ul * (x1 - xt) + d_ur * (xt - x0)  # at an integer x (x0 == x1) 0, as in float32
    il = d_ll * (x1 - xt) + d_lr * (xt - x0)
    ba = ((xt - hw) - xx, (hh - yt) - yy, iu * (y1 - yt) + il * (yt - y0) - d0)
    bc = (lx - xx, ly - yy, lz - d0)
    n2 = ((ba[1] * bc[2] - ba[2] * bc[1]) ** 2 + (ba[2] * bc[0] - ba[0] * bc[2]) ** 2
          + (ba[0] * bc[1] - ba[1] * bc[0]) ** 2)
    dist = torch.sqrt(n2 + S.EPS) / torch.sqrt(bc[0] ** 2 + bc[1] ** 2 + bc[2] ** 2 + S.EPS)
    (grad,) = torch.autograd.grad((dist * torch.where(on, cot.double(), 0.0)).sum(), lp)
    return grad


def march_admitted(batch, dev, worst, grad_err, held) -> dict:
    """Each kernel at the sizes and tables RenderConfig admits beyond the presets', all four
    vetoes, against its plain version: the staging, K1, K2 (and its winners), K3 around a t_map
    and around K2's index bit for bit, march_grad at GRAD_BARS through autograd; the draft march
    at 240x240 (a 60x60 low-resolution march); a t grid to 1.02 at 256x256 (the clamped taps)."""
    import dataclasses

    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K

    cot_rng = np.random.default_rng(1)
    shapes = {name: admitted_inputs(batch, dev, h, w) for name, (h, w, _) in ADMITTED_SHAPES.items()}
    shapes["t_to_1.02"] = admitted_inputs(batch, dev, 256, 256)
    runs = {}
    for name, (depth, mask, light) in shapes.items():
        h, w = depth.shape[1:]
        chunk = ADMITTED_SHAPES.get(name, (0, 0, 32))[2]
        grid = dict(num_sample_points=200, t_stop=1.025) if name == "t_to_1.02" else {}
        base = C.apply_precision_tier(C.preset_single_image(), "strict").render
        for veto in VETOES:
            cfg = dataclasses.replace(base, img_height=h, img_width=w, shadow_col_chunk=chunk, shadow_mask_gather=veto,
                                      shadow_bias_gate="inside_image", shadow_refine_halfwidth=4, **grid)
            tag = f"{name}/{veto}"
            check(staged_equal(K._stage(depth, mask, light, cfg, flags=True), S.stage_inputs(depth, mask, light, cfg)),
                  "march", f"stage {tag}")
            worst["march"] = max(worst["march"], check_equal(K.ray_march_min_distance_cuda(depth, mask, light, cfg),
                                                             S.ray_march_min_distance_batch(depth, mask, light, cfg),
                                                             "march", f"K1 {tag}"))
            got_d, got_t = K.ray_march_min_distance_cuda(depth, mask, light, cfg, return_argmin_t=True)
            want_d, want_t = S.ray_march_min_distance_batch(depth, mask, light, cfg, return_argmin_t=True)
            worst["march_argmin"] = max(worst["march_argmin"], check_equal(got_d, want_d, "march", f"K2 {tag}"))
            check_tstar(got_t, want_t, "march", f"K2 {tag}")
            got = K.refine_min_distance_cuda(depth, mask, light, want_t, cfg)
            want = S.refine_min_distance_batch(depth, mask, light, want_t, cfg)
            worst["refine"] = max(worst["refine"], check_equal(got, want, "march", f"K3 {tag}"))
            ts, _ = K._ts_for(dev, cfg)
            _, idx = S.ray_march_argmin_batch(depth, mask, light, cfg, ts)
            by_idx = K.refine_around_argmin_cuda(depth, mask, light, idx, ts, cfg)
            check(torch_equal_bits(by_idx, S.refine_min_distance_batch(depth, mask, light, ts[idx.long()], cfg)),
                  "march", f"K3 {tag}: the index form differs from its plain version")
            # march_grad through autograd: d_depth at its bar on every pixel with a cotangent;
            # d_light against the sum of those pixels' |terms| (at these sizes an image's light
            # gradient sums terms that cancel, as tests/test_torch_cuda.py's
            # test_k5_backward_in_one_process describes): its largest entry (image, component) off
            # a float64 evaluation (light_grad_f64) no more than twice the plain version's largest,
            # plus 1e-5; and up to W = 2048 within 1e-5 of the plain version's. At 8x4096 the two
            # float32 versions part from float64, and from each other, by up to some 4e-3 of the
            # terms, on either side, most where a far light stands over a pixel column, there the
            # plain one (autograd through the endpoint) the farther (PERF.md §6). On a cotangent
            # of SPARSE_PIXELS pixels an image; at W above 2048 those lie where the clamped taps
            # differ from the quad's, from column 2048 on with every pixel of the last 32
            # columns, and a dense cotangent on three images follows.
            def hold(gd, gm, gl, gt, cot, pix, what):
                d, lp = gd.clone().requires_grad_(), gl.clone().requires_grad_()
                (K.ray_march_min_distance_cuda(d, gm, lp, cfg) * cot).sum().backward()
                want_dd, want_dl = S.march_vjp(gd, gm, gl, gt, cot, cfg)
                dd = (d.grad - want_dd).abs().max().item()
                dd_rel = dd / max(want_dd.abs().max().item(), 1e-30)
                check(dd_rel <= GRAD_BARS["d_depth_rel_to_max"], "march", f"march_grad {tag} {what}: d_depth {dd_rel} of max")
                for key, v in zip(grad_err, (dd, dd_rel)):
                    grad_err[key] = max(grad_err[key], v)
                terms = light_terms(gd, gm, gl, gt, cot, pix, cfg).clamp_min(1e-30)
                got, plain, f64 = lp.grad.double(), want_dl.double(), light_grad_f64(gd, gm, gl, gt, cot, cfg)
                rel = {k: (a - b).abs() / terms for k, (a, b) in dict(
                    kernel_vs_plain=(got, plain), kernel_vs_float64=(got, f64), plain_vs_float64=(plain, f64)).items()}
                reading = {k: v.max().item() for k, v in rel.items()}
                grad_err.setdefault(f"d_light_rel_to_terms_{what}", {})[tag] = reading
                check(reading["kernel_vs_float64"] <= 2 * reading["plain_vs_float64"] + 1e-5
                      and (wide or reading["kernel_vs_plain"] <= 1e-5), "march",
                      f"march_grad {tag} {what}: d_light {reading} of the sum of its |terms|")

            wide = w > K.QUAD_MAX
            hold(depth, mask, light, got_t, *sparse_cotangent(depth.shape, cot_rng, dev, *((K.QUAD_MAX, 32) if wide else ())),
                 "sparse")
            if wide:
                cot = torch.from_numpy(cot_rng.normal(size=(3, h, w)).astype(np.float32)).to(dev)
                hold(*(x[:3].contiguous() for x in (depth, mask, light, got_t)), cot,
                     torch.arange(h * w, device=dev).expand(3, -1), "dense")
            form = f"{name} (clamped taps)" if K._ts_for(dev, cfg)[1] else name
            for kernel in ("march", "march_argmin", "refine", "march_grad"):
                held(kernel, veto, form)
            torch.cuda.synchronize()
            runs[name] = runs.get(name, 0) + 1
    # The draft march at 240x240: a 60x60 low-resolution march under the row cull.
    depth, mask, light = shapes["240x240_col48"]
    for veto in VETOES:
        cfg = dataclasses.replace(C.apply_precision_tier(C.preset_single_image(), "draft").render, img_height=240,
                                  img_width=240, shadow_col_chunk=0, shadow_mask_gather=veto, shadow_step_pack=1)
        tag = f"draft 240x240/{veto}"
        check(staged_equal(K._stage(depth, mask, light, cfg, draft=True, flags=True),
                           S.stage_inputs(depth, mask, light, cfg)), "march", f"stage {tag}")
        m_depth, m_mask, m_light, m_cfg = S.scale_march_inputs(depth, mask, light, cfg)
        _, want_t = S.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
        want = S.refine_min_distance_batch(depth, mask, light, S.upsample_tstar_nn(want_t, cfg), cfg)
        worst["refine"] = max(worst["refine"], check_equal(K.draft_march(depth, mask, light, cfg), want, "march", tag))
        held("march_argmin", veto, "60x60 (draft at 240x240)")
        held("refine", veto, "240x240 (draft)")
        runs["draft_240"] = runs.get("draft_240", 0) + 1
    return runs


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
            n = march_launches()
            check(n == counts(stage=1, march=1), "golden", f"{name}: strict render launched {n}")
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
        n = march_launches()
        check(n == counts(stage=1, march_argmin=1, refine=1), "golden", f"{name}: draft render launched {n}")
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
    "strict": counts(stage=1, march=1),
    "fast": counts(stage=1, march=1),
    "draft": counts(stage=1, march_argmin=1, refine=1),  # one staging pass for K2 and K3
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
        # map, a cull-flag pass or the draft pooling's eager ops: K3 reads K2's
        # index, the staging pass pools and flags, the kernels cull.
        reset_launches()
        with CallCounter((S, "upsample_tstar_nn"), (R, "upsample_tstar_nn"), (S, "cull_live_blocks"),
                         (S, "scale_march_inputs"), (R, "pool_march_inputs")) as glue:
            out = rl.forward(images, masks, lights)
        torch.cuda.synchronize()
        n = march_launches()
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
        # The march's device launches (torch.profiler): staging and K1, or at
        # draft the staging pass, K2 and K3, and nothing else.
        march_names = device_activities(lambda: shadow_min_distance(depth, masks, light_pt, cfg.render),
                                        sum(n.values()))
        check(len(march_names) == 5 * sum(n.values()), "e2e", f"{tier}: five marches ran {march_names}")
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
                             march_ms=march_ms, launches=n, march_device_launches=len(march_names) / 5,
                             glue_calls=glue.calls, kernel_vs_plain_psnr_db=psnr,
                             min_distance_max_abs_err=md_err)
        emit("e2e", ok=True, tier=tier, batch=batch, size=256, **results[tier])
        del rl, out, depth
        torch.cuda.empty_cache()
    return launches, results, worst


# The batch sizes the surface runs the CNN at: 1 (the CLI, a lone request),
# 8 (the server's full batches, the evaluation) and 64 (the bench, e2e).
CUDNN_BATCHES = (1, 8, 64)


def phase_cudnn(goldens, dev, seed=0, rounds=4):
    """What running the CNN under cuDNN's deterministic algorithms (as
    Relighter._net does) costs and buys, at strict and fast: the CNN's ms at
    each of CUDNN_BATCHES under cuDNN's defaults and under deterministic_convs
    (CUDA events, windows alternating between the two), and how many bytes of
    a batch-1 visual pack differ from the first call over four more calls
    (a batch of 8 run between the second and the third) under each."""
    import contextlib
    import statistics

    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.layers import deterministic_convs
    from geomconsistentfr_torch.models.relightnet import RelightNet

    check(not torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark, "cudnn",
          "cuDNN's global settings are not its defaults")
    fx = dict(goldens)["ref_transfer_00104.npz"]
    row = (fx["image"][None], fx["mask"][None], np.array([[0.6893, 0.3991, 0.6047]], np.float32),
           np.array([0.5], np.float32))
    settings = {"default": contextlib.nullcontext, "deterministic": deterministic_convs}
    for tier in ("strict", "fast"):
        started = time.perf_counter()
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        rl = Relighter(cfg, RelightNet(cfg.model, generator=torch.Generator().manual_seed(seed)).state_dict())
        cnn_ms = {}
        for b in CUDNN_BATCHES:
            x = torch.from_numpy(np.repeat(fx["image"][None], b, 0)).to(dev)
            windows = {name: [] for name in settings}
            with torch.no_grad():
                for r in range(rounds):
                    for name in list(settings)[:: 1 if r % 2 == 0 else -1]:
                        with settings[name]():
                            windows[name].append(cuda_time_ms(lambda: rl.model(x, rl.use_skips), 64 // b + 3))
            cnn_ms[b] = {name: statistics.median(v) for name, v in windows.items()}
            cnn_ms[b]["deterministic_over_default"] = statistics.median(
                d / a for d, a in zip(windows["deterministic"], windows["default"]))
        net, moved = rl._net, {}
        for name in settings:
            # Relighter._net with the setting's context in place of deterministic_convs.
            rl._net = lambda images, _ctx=settings[name]: _run_in(_ctx, rl.model, images, rl.use_skips)
            packs = []
            for k in range(5):
                if k == 2:
                    rl.forward_visuals(*(np.repeat(a, 8, 0) for a in row))
                packs.append(rl.forward_visuals(*row).cpu().numpy())
            moved[name] = [int(np.count_nonzero(p != packs[0])) for p in packs[1:]]
        rl._net = net
        check(not any(moved["deterministic"]), "cudnn",
              f"{tier}: under deterministic_convs a batch-1 pack moved by {moved['deterministic']} bytes")
        emit("cudnn", ok=True, tier=tier, cnn_ms=cnn_ms, pack_bytes_moved=moved,
             seconds=time.perf_counter() - started)
        del rl
        torch.cuda.empty_cache()


def _run_in(ctx, fn, *args):
    with ctx():
        return fn(*args)


# ---------------------------------------------------------------------------
# The user-facing surface: the CLI, the bench, the server and the Multi-PIE
# evaluation, each driven in processes of its own on seeded random weights.
# ---------------------------------------------------------------------------

# Runs `python -m MODULE ARGS` the way -m does (runpy.run_module, alter_sys)
# and at exit writes the process's march kernel launches (cuda_lib.LAUNCHES,
# zero at its start) and its clock to a JSON file: when the wrapper started,
# when torch, the package and the CUDA context were up, and the exit.
# Under torchrun each rank writes <report>.rank<RANK>.json, with its exit code.
RUN_MODULE = r"""
import atexit, json, os, runpy, sys, time
t_start = time.time()
report_path, module = sys.argv[1], sys.argv[2]
if "RANK" in os.environ:
    report_path = report_path[:-len(".json")] + f".rank{os.environ['RANK']}.json"
import torch
from geomconsistentfr_torch.ops import cuda_lib, shadows_cuda
torch.zeros(1, device="cuda")
t_ready = time.time()
exit_code = [None]

def report():
    with open(report_path, "w") as f:
        json.dump({"launches": {k: cuda_lib.LAUNCHES[k] for k in shadows_cuda.LIBRARY.kernels},
                   "t_start": t_start, "t_ready": t_ready, "t_end": time.time(), "exit_code": exit_code[0]}, f)

atexit.register(report)
sys.argv = [module] + sys.argv[3:]
try:
    runpy.run_module(module, run_name="__main__", alter_sys=True)
    exit_code[0] = 0
except SystemExit as e:
    exit_code[0] = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
    raise
"""
BENCH_REL_BAR = 0.15  # the bench's img/s within 15% of the e2e phase's, tier by tier
# 512 requests (2048 until PR 9, cut for the time limit); the launch phase's
# two-rank servers take the same load beside this one-rank server.
SERVE_CLIENTS, SERVE_PER_CLIENT = 16, 32
SERVE_BODIES = 64  # distinct request bodies (lights), reused round robin
# The protocol has 862 images; 64 keep the script within its time limit (the
# launch phase runs the same 64 over two ranks).
EVAL_IMAGES, EVAL_BATCH = 64, 8
SERVE_WARMUP_FORWARDS = 4 * 2  # every tier at the two batch sizes (1 and --max-batch 8)


def module_cmd(report: Path, module: str, *args) -> list:
    return [sys.executable, "-c", RUN_MODULE, str(report), module, *map(str, args)]


def torchrun_cmd(tmp: Path, report: Path, ranks: int, module: str, *args) -> list:
    """`python -m torch.distributed.run` of `ranks` ranks on this host, each running RUN_MODULE."""
    script = tmp / "run_module.py"
    if not script.exists():
        script.write_text(RUN_MODULE)
    return [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", str(ranks),
            str(script), str(report), module, *map(str, args)]


def rank_reports(report: Path, ranks: int) -> list:
    return [json.loads(report.with_name(f"{report.stem}.rank{r}.json").read_text()) for r in range(ranks)]


def module_env(**extra) -> dict:
    import os

    return dict(os.environ, PYTHONPATH=str(ROOT), **extra)


def run_module(tmp: Path, phase: str, tag: str, module: str, *args, env=None, timeout=300) -> dict:
    """One `python -m module args` on the card: its stdout, launches, and seconds (wall, start-up, run)."""
    report = tmp / f"{tag}.run.json"
    t0 = time.time()
    proc = subprocess.run(module_cmd(report, module, *args), cwd=ROOT, env=env or module_env(),
                          capture_output=True, text=True, timeout=timeout)
    wall = time.time() - t0
    check(proc.returncode == 0, phase, f"{tag}: {module} exited {proc.returncode}: {proc.stderr[-3000:]}")
    rep = json.loads(report.read_text())
    return dict(stdout=proc.stdout, stderr=proc.stderr, launches=rep["launches"], wall_s=wall,
                startup_s=rep["t_ready"] - t0, run_s=rep["t_end"] - rep["t_ready"])


def last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def to_u8(x):
    """floor(clip(x * 255)) as uint8, the port's write_image quantisation."""
    import numpy as np

    return np.clip(np.asarray(x, np.float32) * 255.0, 0, 255).astype(np.uint8)


def write_png(path: Path, pixels) -> str:
    """PNG bytes by the port's own writer (utils/png.py), whatever codecs the machine has."""
    from geomconsistentfr_torch.utils.png import encode_png

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(encode_png(pixels))
    return str(path)


def surface_files(goldens, tmp: Path, seed: int = 0) -> dict:
    """Seeded random transfer-variant weights as a .pth (the reference checkpoint's
    variant), and every golden image and face mask as a PNG."""
    import torch

    from geomconsistentfr_torch.config import preset_lighting_transfer
    from geomconsistentfr_torch.models.relightnet import RelightNet

    pth = tmp / "weights.pth"
    model = RelightNet(preset_lighting_transfer().model, generator=torch.Generator().manual_seed(seed))
    torch.save(model.state_dict(), pth)
    files = {"pth": str(pth)}
    for name, fx in goldens:
        stem = name[len("ref_"):-len(".npz")]
        files[stem] = write_png(tmp / "golden" / f"{stem}.png", to_u8(fx["image"]))
        files[stem + "_mask"] = write_png(tmp / "golden" / f"{stem}_mask.png", to_u8(fx["mask"]))
    return files


def surface_relighter(pth: str, preset: str, tier: str):
    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.infer import load_relighter

    return load_relighter(pth, cfg=C.apply_precision_tier(C.PRESETS[preset](), tier))


def pack_files_equal(paths: dict, pack, phase: str, tag: str) -> None:
    """The six PNGs of a visual pack decode to its bytes."""
    import numpy as np

    from geomconsistentfr_torch.infer import VISUAL_PACK_LAYOUT
    from geomconsistentfr_torch.utils.io import imread

    c = 0
    for kind, width in VISUAL_PACK_LAYOUT:
        want = pack[..., c : c + width] if width > 1 else pack[..., c]
        got = imread(paths[kind])
        diff = int(np.count_nonzero(got != want)) if got.shape == want.shape else -1
        check(diff == 0, phase, f"{tag}: {kind} differs from forward_visuals in {diff} bytes")
        c += width


def add_launches(total: dict, n: dict) -> None:
    for k, v in n.items():
        total[k] += v


def phase_cli(files, tmp: Path) -> dict:
    """`python -m geomconsistentfr_torch.cli` relight (strict, draft), sweep, transfer, config and
    fix-border, each in a process of its own, against the same calls in this process."""
    import numpy as np

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.lighting_presets import DEFAULT_AMBIENT, LIGHT_PRESETS
    from geomconsistentfr_torch.postprocess import fix_border_artifacts
    from geomconsistentfr_torch.utils.io import imread, read_image, read_mask

    started = time.perf_counter()
    pth, image, mask, ref = files["pth"], files["transfer_00104"], files["transfer_00104_mask"], files["target_00295"]
    img, msk = read_image(image), read_mask(mask)
    launches = counts()
    rows = {}

    def cli(tag, *args):
        r = run_module(tmp, "cli", tag, "geomconsistentfr_torch.cli", *args)
        add_launches(launches, r["launches"])
        rows[tag] = dict(wall_s=r["wall_s"], startup_s=r["startup_s"], run_s=r["run_s"], launches=r["launches"])
        return r

    light = np.asarray([LIGHT_PRESETS["multipie_14"]], np.float32)
    ambient = np.asarray([DEFAULT_AMBIENT], np.float32)
    for tier in ("strict", "draft"):
        out = tmp / f"cli_relight_{tier}"
        r = cli(f"relight_{tier}", "relight", "--checkpoint", pth, "--precision", tier, "--image", image,
                "--mask", mask, "--light-preset", "multipie_14", "--out", out)
        check(r["launches"] == TIER_LAUNCHES[tier], "cli", f"relight {tier} launched {r['launches']}")
        report = last_json(r["stdout"])
        pack = surface_relighter(pth, "single_image", tier).forward_visuals(img[None], msk[None], light,
                                                                           ambient)[0].cpu().numpy()
        pack_files_equal(report["outputs"], pack, "cli", f"relight {tier}")
    composited = str(tmp / "cli_relight_strict" / report["composited"])

    out = tmp / "cli_sweep"
    r = cli("sweep", "sweep", "--checkpoint", pth, "--image", image, "--mask", mask, "--out", out)
    check(r["launches"] == counts(stage=1, march=1), "cli", f"sweep launched {r['launches']}")
    names = list(LIGHT_PRESETS)
    lights = np.asarray([LIGHT_PRESETS[n] for n in names], np.float32)
    tiles = surface_relighter(pth, "single_image", "high").relight_sweep_rendered_u8(
        img, msk, lights, np.full((len(names),), DEFAULT_AMBIENT, np.float32)).cpu().numpy()
    for i, name in enumerate(names):
        check(np.array_equal(imread(str(out / f"transfer_00104_{name}.png")), tiles[i]), "cli",
              f"sweep tile {name} differs from relight_sweep_rendered_u8")

    out = tmp / "cli_transfer"
    r = cli("transfer", "transfer", "--checkpoint", pth, "--out", out, image, ref, mask)
    check(r["launches"] == counts(stage=1, march=1), "cli", f"transfer launched {r['launches']}")
    report = last_json(r["stdout"])
    rl = surface_relighter(pth, "lighting_transfer", "high")
    unit, amb = rl.estimate_lighting(read_image(ref)[None])
    check(report["estimated_direction"] == [float(v) for v in unit[0].cpu()]
          and report["estimated_ambient"] == float(amb[0]), "cli",
          f"transfer estimated {report['estimated_direction']}, {report['estimated_ambient']}; "
          f"estimate_lighting gives {unit[0].tolist()}, {float(amb[0])}")
    pack_files_equal(report["outputs"], rl.forward_visuals(img[None], msk[None], unit, amb)[0].cpu().numpy(),
                     "cli", "transfer")

    r = cli("config", "config", "--preset", "lighting_transfer")
    want = json.loads(json.dumps(C.to_dict(C.PRESETS["lighting_transfer"]()), default=str))
    check(json.loads(r["stdout"]) == want, "cli", "config printed another config than to_dict")

    fixed = tmp / "cli_fixed.png"
    r = cli("fix_border", "fix-border", "--image", composited, "--mask", mask, "--out-image", fixed)
    want = fix_border_artifacts(imread(composited), read_mask(mask)).astype(np.uint8)
    check(np.array_equal(imread(str(fixed)), want), "cli", "fix-border wrote other pixels than fix_border_artifacts")
    check(not any(r["launches"].values()), "cli", f"fix-border launched {r['launches']}")
    emit("cli", ok=True, launches=launches, seconds=time.perf_counter() - started, commands=rows)
    return launches


def phase_bench(tmp: Path, e2e: dict) -> dict:
    """`python -m geomconsistentfr_torch.bench` at strict, fast and draft, each within
    BENCH_REL_BAR of the e2e phase's img/s for the tier (both time Relighter.forward at batch 64)."""
    launches = counts()
    for tier in ("strict", "fast", "draft"):
        started = time.perf_counter()
        r = run_module(tmp, "bench", f"bench_{tier}", "geomconsistentfr_torch.bench",
                       env=module_env(BENCH_PRECISION=tier))
        line = last_json(r["stdout"])
        print(json.dumps(line), flush=True)
        check(line["metric"] == "relight_throughput" and line["tier"] == tier, "bench", f"bench printed {line}")
        forwards = 1 + 5  # the warm-up and BENCH_ITERS
        check(r["launches"] == {k: forwards * v for k, v in TIER_LAUNCHES[tier].items()}, "bench",
              f"{tier}: launched {r['launches']} in {forwards} forwards")
        add_launches(launches, r["launches"])
        rel = line["value"] / e2e[tier]["img_per_s"] - 1.0
        check(abs(rel) <= BENCH_REL_BAR, "bench",
              f"{tier}: the bench's {line['value']} img/s is {rel:+.1%} from e2e's {e2e[tier]['img_per_s']}")
        emit("bench", ok=True, tier=tier, img_per_s=line["value"], vs_baseline=line["vs_baseline"],
             e2e_img_per_s=e2e[tier]["img_per_s"], rel_to_e2e=rel, launches=r["launches"],
             seconds=time.perf_counter() - started, startup_s=r["startup_s"])
    return launches


class ServerProcess:
    """`python -m geomconsistentfr_torch.serve` in a process of its own (with `ranks`, that many
    ranks under torchrun), on a free port."""

    def __init__(self, tmp: Path, *args, ranks: int = 0, tag: str = "serve"):
        import threading

        self.report = tmp / f"{tag}.run.json"
        self.stderr = open(tmp / f"{tag}.stderr", "w+")
        self.t0 = time.time()
        cmd = (torchrun_cmd(tmp, self.report, ranks, "geomconsistentfr_torch.serve", *args) if ranks
               else module_cmd(self.report, "geomconsistentfr_torch.serve", *args))
        self.proc = subprocess.Popen(cmd, cwd=ROOT, env=module_env(), stdout=subprocess.PIPE, stderr=self.stderr,
                                     text=True)
        self.lines = []
        watchdog = threading.Timer(300.0, self.proc.kill)  # a server that never serves is killed
        watchdog.start()
        while True:  # the warm-up line, then the serving line
            line = self.proc.stdout.readline()
            if not line:
                watchdog.cancel()
                self.fail("exited before it served")
            if not line.startswith("{"):
                continue
            self.lines.append(json.loads(line))
            if "serving" in self.lines[-1]:
                break
        watchdog.cancel()
        self.port = int(self.lines[-1]["serving"].rsplit(":", 1)[1])
        self.ready_s = time.time() - self.t0

    def fail(self, what: str, phase: str = "serve"):
        self.stderr.seek(0)
        raise PhaseError(f"{phase}: the server {what}: {self.stderr.read()[-3000:]}")

    def request(self, method: str, path: str, body=None, timeout: float = 120.0):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=timeout)
        try:
            conn.request(method, path, body if body is None or isinstance(body, str) else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.stderr.close()


def cpu_seconds(pid: int) -> dict:
    """The CPU seconds (user and system) of process `pid` and of this process."""
    import os

    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    t = os.times()
    return dict(server=(int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK"), clients=t.user + t.system)


def b64_file(path: str) -> str:
    import base64

    return base64.b64encode(Path(path).read_bytes()).decode()


def phase_serve(files, tmp: Path, seed: int = 0) -> dict:
    """The server on the card: lone requests per tier byte-equal to forward_visuals at
    batch 1, a coalesced batch within one level, /estimate, /transfer, JPEG, a bad
    tier; then the closed-loop load and a drain on SIGTERM."""
    import base64
    import signal
    import threading

    import numpy as np

    from geomconsistentfr_torch import serve as SV
    from geomconsistentfr_torch.utils.io import decode_image, imread

    pth = files["pth"]
    img, msk = imread(files["transfer_00104"]), imread(files["transfer_00104_mask"])
    base = {"image": b64_file(files["transfer_00104"]), "mask": b64_file(files["transfer_00104_mask"])}
    rng = np.random.default_rng(seed)
    lights = rng.normal(size=(64, 3)).astype(np.float32)
    lights[:, 2] = np.abs(lights[:, 2]) + 0.5

    def unb64(s):
        return decode_image(base64.b64decode(s))

    def expected(rl, light, ambient=0.5):
        pack = rl.forward_visuals(img[None], msk[None], np.asarray(light, np.float32)[None],
                                  np.asarray([ambient], np.float32))[0].cpu().numpy()
        return pack[..., 0:3], pack[..., 3]

    started = time.perf_counter()
    server = ServerProcess(tmp, "--checkpoint", pth, "--port", "0", "--warmup")
    try:
        check(server.lines[-1]["tier"] == "high" and server.lines[-1]["device"] == "cuda", "serve",
              f"serving line {server.lines[-1]}")
        relighters = {t: surface_relighter(pth, "single_image", t) for t in ("strict", "high", "fast", "draft")}
        lone = {}
        for k, tier in enumerate(relighters):
            status, payload = server.request("POST", "/relight", {**base, "light": lights[k].tolist(),
                                                                  "precision": tier})
            check(status == 200, "serve", f"lone {tier} relight: {status} {payload}")
            rendered, weights = expected(relighters[tier], lights[k])
            for key, want in (("rendered", rendered), ("shadow_mask", weights)):
                got = unb64(payload[key])
                diff = int(np.count_nonzero(got != want)) if got.shape == want.shape else -1
                check(diff == 0, "serve", f"lone {tier} request: {key} differs from forward_visuals in {diff} bytes")
            lone[tier] = "byte-equal"

        _, before = server.request("GET", "/statz")
        barrier, got = threading.Barrier(8), {}

        def strict_request(k):
            barrier.wait()
            got[k] = server.request("POST", "/relight", {**base, "light": lights[8 + k].tolist(),
                                                         "precision": "strict"})

        threads = [threading.Thread(target=strict_request, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        _, after = server.request("GET", "/statz")
        batches = after["batches"] - before["batches"]
        check(batches < 8 and after["batched_rows"] - before["batched_rows"] == 8, "serve",
              f"8 concurrent strict requests ran in {batches} batches")
        worst = 0
        for k in range(8):
            status, payload = got[k]
            check(status == 200, "serve", f"coalesced strict request {k}: {status} {payload}")
            rendered, weights = expected(relighters["strict"], lights[8 + k])
            worst = max(worst, int(np.abs(unb64(payload["rendered"]).astype(np.int16) - rendered).max()),
                        int(np.abs(unb64(payload["shadow_mask"]).astype(np.int16) - weights).max()))
        check(worst <= 1, "serve", f"a coalesced strict row is {worst} levels from forward_visuals at batch 1")

        status, est = server.request("POST", "/estimate", {"image": base["image"]})
        unit, amb = relighters["high"].estimate_lighting(img[None])
        check(status == 200 and est["direction"] == [float(v) for v in unit[0].cpu()]
              and est["ambient"] == float(amb[0]), "serve", f"/estimate {status} {est}")
        ref = imread(files["target_00295"])
        status, tr = server.request("POST", "/transfer", {**base, "reference": b64_file(files["target_00295"])})
        unit, amb = relighters["high"].estimate_lighting(ref[None])
        check(status == 200 and tr["direction"] == [float(v) for v in unit[0].cpu()], "serve",
              f"/transfer {status}: {tr.get('direction')} against {unit[0].tolist()}")
        rendered, _ = expected(relighters["high"], unit[0].cpu().numpy(), float(amb[0]))
        check(np.array_equal(unb64(tr["rendered"]), rendered), "serve", "/transfer's render differs")
        status, jpeg = server.request("POST", "/relight", {**base, "light": lights[0].tolist(), "format": "jpeg"})
        if status == 200:
            check(base64.b64decode(jpeg["rendered"])[:2] == b"\xff\xd8", "serve", "the JPEG reply is not a JPEG")
            jpeg_result = "jpeg"
        else:
            check(status == 400 and "no JPEG encoder" in jpeg.get("error", ""), "serve", f"JPEG: {status} {jpeg}")
            jpeg_result = f"400: {jpeg['error']}"
        status, bad = server.request("POST", "/relight", {**base, "light": [0, 0, 1], "precision": "best"})
        check(status == 400 and "unknown precision" in bad["error"], "serve", f"bad tier: {status} {bad}")

        # Closed-loop load at the default tier: bodies built beforehand.
        bodies = [json.dumps({**base, "light": lights[k].tolist()}) for k in range(SERVE_BODIES)]
        latencies, statuses, lock = [], [], threading.Lock()

        def client(c):
            mine = []
            for j in range(SERVE_PER_CLIENT):
                t = time.perf_counter()
                status, _ = server.request("POST", "/relight", bodies[(c * SERVE_PER_CLIENT + j) % SERVE_BODIES])
                mine.append((status, time.perf_counter() - t))
            with lock:
                statuses.extend(s for s, _ in mine)
                latencies.extend(dt for _, dt in mine)

        _, s0 = server.request("GET", "/statz")
        cpu0 = cpu_seconds(server.proc.pid)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        cpu1 = cpu_seconds(server.proc.pid)
        # The cores the server and this process (the clients) kept busy.
        cores = {k: (cpu1[k] - cpu0[k]) / wall for k in cpu0}
        _, s1 = server.request("GET", "/statz")
        n = SERVE_CLIENTS * SERVE_PER_CLIENT
        check(statuses == [200] * n, "serve", f"load: statuses {sorted(set(statuses))}, {len(statuses)} of {n}")
        delta = {k: s1[k] - s0[k] for k in ("batches", "batched_rows", "padded_rows", "device_seconds",
                                            "pipelined_batches", "errors")}
        check(delta["batched_rows"] == n and delta["errors"] == 0, "serve", f"load: statz moved by {delta}")

        # The host's codec per request, in this process: what a handler does.
        rendered, weights = expected(relighters["high"], lights[0])
        reps = 10
        t = time.perf_counter()
        for _ in range(reps):
            SV._decode_image(base["image"], 256)
            SV._decode_image(base["mask"], 256)
        decode_ms = (time.perf_counter() - t) / reps * 1e3
        t = time.perf_counter()
        for _ in range(reps):
            SV._encode_image(rendered)
            SV._encode_image(weights)
        encode_ms = (time.perf_counter() - t) / reps * 1e3
        # What holds the worker: one batch of 8 at the default tier, back to
        # back from one thread (CUDA events), against the kernels' own time.
        b8 = (np.repeat(img[None], 8, 0), np.repeat(msk[None], 8, 0), lights[:8], np.full((8,), 0.5, np.float32))
        b8_ms = cuda_time_ms(lambda: relighters["high"].forward_visuals(*b8), 8, windows=3)
        b8_busy_ms = device_busy_ms(lambda: relighters["high"].forward_visuals(*b8), 8)
        lat = np.asarray(latencies) * 1e3
        load = dict(clients=SERVE_CLIENTS, requests=n, wall_s=wall, req_per_s=n / wall,
                    p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)),
                    mean_ms=float(lat.mean()), statz=delta, mean_batch_rows=delta["batched_rows"] / delta["batches"],
                    decode_ms_per_request=decode_ms, encode_ms_per_request=encode_ms,
                    batch8_span_ms=delta["device_seconds"] / delta["batches"] * 1e3, batch8_back_to_back_ms=b8_ms,
                    batch8_device_busy_ms=b8_busy_ms, cores_busy=cores,
                    share_of_wall={"decode": n * decode_ms / 1e3 / wall, "device": delta["device_seconds"] / wall,
                                   "encode": n * encode_ms / 1e3 / wall})

        # The drain: a burst in flight, then SIGTERM. Every request the worker
        # admitted is answered; the rest were refused at the socket.
        _, s2 = server.request("GET", "/statz")
        results, lock, first = [], threading.Lock(), threading.Event()

        def burst(k):
            try:
                status, _ = server.request("POST", "/relight", bodies[k])
            except OSError as e:  # refused or reset after the listener closed
                status = type(e).__name__
            with lock:
                results.append((status, time.perf_counter()))
            first.set()

        threads = [threading.Thread(target=burst, args=(k,)) for k in range(24)]
        for t in threads:
            t.start()
        first.wait(timeout=120)  # the server is answering the burst: signal it now
        t_sig = time.perf_counter()
        server.proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=120)
        out, _ = server.proc.communicate(timeout=120)
        final = last_json(out)
        answered = sum(1 for s, _ in results if s == 200)
        admitted = final["stats"]["relight_requests"] - s2["relight_requests"]
        in_flight = sum(1 for s, t in results if s == 200 and t > t_sig)
        check(server.proc.returncode == 0 and final["drained"], "serve",
              f"drain: exit {server.proc.returncode}, {final}")
        check(answered == admitted and in_flight > 0, "serve",
              f"drain: {answered} answered, {admitted} admitted, {in_flight} answered after SIGTERM")
        launches = json.loads(server.report.read_text())["launches"]
    finally:
        server.close()
    forwards = SERVE_WARMUP_FORWARDS + final["stats"]["batches"]
    check(launches["stage"] == forwards and launches["march"] + launches["march_argmin"] == forwards
          and launches["refine"] == launches["march_argmin"] == 2 + 1, "serve",
          f"launched {launches} in {forwards} forwards (3 of them draft)")
    emit("serve", ok=True, launches=launches, seconds=time.perf_counter() - started, ready_s=server.ready_s,
         warmup_s=server.lines[0]["warmup_seconds"],
         lone=lone, coalesced=dict(batches=batches, max_level_diff=worst), jpeg=jpeg_result, load=load,
         drain=dict(burst=len(results), answered=answered, admitted=admitted, answered_after_sigterm=in_flight,
                    refused=len(results) - answered))
    return launches, load


def phase_eval(goldens, files, tmp: Path, lpips_files: tuple) -> dict:
    """`cli eval-multipie` over a synthetic Multi-PIE directory of EVAL_IMAGES triples made from the goldens,
    scored with LPIPS (alex; a seeded trunk and heads in torchvision's and the library's layouts)."""
    import numpy as np
    import scipy.io

    from geomconsistentfr_torch.lighting_presets import LIGHT_PRESETS, MULTIPIE_FLASH_ORDER
    from geomconsistentfr_torch.metrics.eval_multipie import evaluate_output_dir
    from geomconsistentfr_torch.utils.io import read_image_u8, read_mask_u8
    from geomconsistentfr_torch.utils.png import encode_png

    started = time.perf_counter()
    root = tmp / "multipie"
    dirs = [root / d for d in ("input_images_MP_18_lightings", "groundtruth_images_MP_18_lightings",
                               "MP_depth_masks_fill_nose")]
    for d in dirs:
        d.mkdir(parents=True)
    scipy.io.savemat(root / "MP_lighting_directions.mat",
                     {"lighting_directions": np.asarray([LIGHT_PRESETS[n] for n in MULTIPIE_FLASH_ORDER])})
    # The goldens tiled, each also mirrored: twenty distinct triples, encoded
    # once by the port's own writer; image i takes triple i % 20 and Multi-PIE
    # light i % 18 + 1.
    variants = []
    for flip in (False, True):
        for _, fx in goldens:
            f = (lambda a: a[:, ::-1]) if flip else (lambda a: a)
            variants.append([encode_png(to_u8(f(a))) for a in
                             (fx["image"], fx["rendered"][0].transpose(1, 2, 0), fx["mask"])])
    for i in range(EVAL_IMAGES):
        image, gt, mask = variants[i % len(variants)]
        (dirs[0] / f"{i:03d}.png").write_bytes(image)
        (dirs[1] / f"{i:03d}_{i % 18 + 1}.png").write_bytes(gt)
        (dirs[2] / f"{i:03d}.png").write_bytes(mask)
    out = tmp / "eval_dump"
    trunk, lin = lpips_files
    r = run_module(tmp, "eval", "eval", "geomconsistentfr_torch.cli", "eval-multipie", "--checkpoint", files["pth"],
                   "--data-root", root, "--batch-size", EVAL_BATCH, "--out", out, "--lpips-trunk", trunk,
                   "--lpips-lin", lin, timeout=900)
    metrics = last_json(r["stdout"])
    check(metrics.pop("num_inferred") == EVAL_IMAGES, "eval", f"eval-multipie printed {metrics}")
    lpips = {k: metrics.pop(k) for k in ("masked_lpips_mean", "masked_lpips_std")}
    check(all(v == v and v >= 0 for v in lpips.values()), "eval", f"eval-multipie printed LPIPS {lpips}")
    batches = -(-EVAL_IMAGES // EVAL_BATCH)
    check(r["launches"] == counts(stage=batches, march=batches), "eval",
          f"launched {r['launches']} in {batches} batches")
    t = time.perf_counter()
    recomputed = evaluate_output_dir(str(out), str(dirs[1]), str(dirs[2]))
    score_s = time.perf_counter() - t
    check(metrics == recomputed, "eval", f"printed {metrics}, recomputed {recomputed}")

    # The dump against forward_visuals of the same batches (the tail padded
    # with its last image, as run_inference pads it).
    rl = surface_relighter(files["pth"], "multipie_eval", "high")
    directions = scipy.io.loadmat(root / "MP_lighting_directions.mat")["lighting_directions"]
    for start in range(0, EVAL_IMAGES, EVAL_BATCH):
        idx = [min(i, EVAL_IMAGES - 1) for i in range(start, start + EVAL_BATCH)]
        imgs = np.stack([read_image_u8(str(dirs[0] / f"{i:03d}.png")) for i in idx])
        msks = np.stack([read_mask_u8(str(dirs[2] / f"{i:03d}.png")) for i in idx])
        lights = np.asarray([directions[i % 18] for i in idx], np.float32)
        pack = rl.forward_visuals(imgs, msks, target_light=lights).cpu().numpy()
        for k, i in enumerate(range(start, min(start + EVAL_BATCH, EVAL_IMAGES))):
            pack_files_equal({kind: str(out / f"{i:03d}_{kind}.png") for kind in
                              ("rendered_image", "shadow_mask", "albedo", "depth", "shading", "surface_normals")},
                             pack[k], "eval", f"image {i}")
    # The card's busy time for one batch (torch.profiler), times the batches.
    device_s = device_busy_ms(lambda: rl.forward_visuals(imgs, msks, target_light=lights), 4) / 1e3 * batches
    sub = eval_lpips_subset(root, out, tmp, trunk, lin)
    lpips_s = sub["lpips_ms_an_image"] / 1e3 * EVAL_IMAGES
    emit("eval", ok=True, images=EVAL_IMAGES, batch=EVAL_BATCH, metrics=metrics, lpips=lpips, launches=r["launches"],
         seconds=time.perf_counter() - started,
         wall_s=r["wall_s"], startup_s=r["startup_s"], run_s=r["run_s"], img_per_s=EVAL_IMAGES / r["run_s"],
         scoring_s=score_s, scoring_share=score_s / r["run_s"], lpips_s=lpips_s, lpips_share=lpips_s / r["run_s"],
         device_s=device_s, device_share=device_s / r["run_s"], lpips_subset=sub)
    return r["launches"]


# ---------------------------------------------------------------------------
# Training from the CLI and the secondary models: build-cache and train,
# LPIPS (in the evaluation, alone, its 2AFC trainer and scorer), S3FD's crop
# and the lighting spheres, each command in a process of its own.
# ---------------------------------------------------------------------------

TRAIN_CLI_SAMPLES = 512  # the MP_data tree build-cache packs, 256x256
TRAIN_CLI_BATCHES = 4  # batches an epoch of `cli train`, two epochs
TRAIN_CLI_TIMED_STEPS = 8  # steps a window when timing 'device' against 'stream'
LPIPS_BAR = 1e-4  # LPIPS on the card vs the CPU, of the map's largest value
LPIPS_EVAL_REL = 1e-6  # the CLI's LPIPS mean vs an in-process LPIPSMetric, relative
LPIPS_EVAL_SUBSET = 16  # triples of that comparison
BAPPS_TRIPLETS, BAPPS_SIZE = 64, 64  # the synthetic 2AFC / JND trees (BAPPS's load size)
S3FD_BAR = 1e-4  # S3FD's heads on the card vs the CPU, of each head's largest value
CROP_FRAME = 1024  # CelebA-HQ's original size


def lpips_weight_files(tmp: Path, seed: int = 0) -> tuple:
    """A seeded AlexNet trunk in torchvision's layout (features.N.*) and seeded non-negative
    linear heads in the LPIPS library's layout (lin{i}.model.1.weight), as .pth files."""
    import torch

    from geomconsistentfr_torch.models.lpips import LPIPS

    model = LPIPS("alex", generator=torch.Generator().manual_seed(seed))
    trunk, lin = tmp / "alexnet_features.pth", tmp / "alex_lin.pth"
    torch.save(model.trunk.state_dict(), trunk)
    torch.save({k: v.abs() for k, v in model.state_dict().items() if k.startswith("lin")}, lin)
    return str(trunk), str(lin)


def write_mp_data(root: Path, n: int) -> dict:
    """An MP_data tree (the reference's six directories) of n SyntheticFaceData samples at
    256x256: face, albedo and face-mask JPEGs by the port's encode_jpeg, depth and light .mat
    files by scipy.io.savemat, depth-mask PNGs by the port's writer."""
    import numpy as np
    import scipy.io

    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
    from geomconsistentfr_torch.utils.io import encode_jpeg

    dirs = {k: root / d for k, d in (("image", "CelebA-HQ_DFNRMVS_cropped"),
                                    ("light", "lighting_directions_CelebAHQ_DFNRMVS"),
                                    ("depth", "depth_maps_CelebA-HQ"), ("depth_mask", "depth_masks_CelebA-HQ_DFNRMVS"),
                                    ("albedo", "CelebA-HQ_albedo_grayscale"), ("face", "CelebAHQ_face_masks"))}
    for d in dirs.values():
        d.mkdir(parents=True)
    data = SyntheticFaceData(num_samples=n, size=256, seed=0)
    t0 = time.perf_counter()
    for i in range(n):
        s = data.get_batch([i])
        stem = f"{i:05d}"
        (dirs["image"] / f"{stem}.jpg").write_bytes(encode_jpeg(to_u8(s["image"][0]), 95))
        (dirs["albedo"] / f"{stem}.jpg").write_bytes(encode_jpeg(to_u8(s["albedo_gt"][0]), 95))
        (dirs["face"] / f"{stem}.jpg").write_bytes(encode_jpeg(to_u8(s["face_mask"][0]), 95))
        write_png(dirs["depth_mask"] / f"{stem}_depth.png", to_u8(s["depth_mask"][0]))
        scipy.io.savemat(dirs["depth"] / f"{stem}_depth.mat", {"depth_img": s["depth_gt"][0]})
        scipy.io.savemat(dirs["light"] / f"{stem}.jpg.mat", {"lighting_direction": s["light_gt"][0][None]})
    return {"seconds": time.perf_counter() - t0}


def libjpeg_here() -> dict:
    """Whether this machine has libjpeg's header and library, and what the native loader built."""
    import os

    from geomconsistentfr_torch.data import native_loader

    proc = subprocess.run(["ldconfig", "-p"], capture_output=True, text=True)
    return dict(jpeglib_h=os.path.exists("/usr/include/jpeglib.h"),
                ldconfig_jpeg=[ln.strip() for ln in proc.stdout.splitlines() if "jpeg" in ln],
                has_native_jpeg=native_loader.has_native_jpeg())


def phase_train_cli(tmp: Path) -> dict:
    """`cli build-cache` of a 512-sample MP_data tree, then `cli train` at full width with the
    set resident on the card, traced and with visuals, against the same work in this process."""
    import statistics

    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.data.celebahq import CelebAHQRelightingData, build_cache, jpeg_reader
    from geomconsistentfr_torch.train import DeviceResidentBatches, Trainer

    started = time.perf_counter()
    jpeg = libjpeg_here()
    print(json.dumps({"phase": "train_cli", "libjpeg": jpeg}), flush=True)
    tree = write_mp_data(tmp / "MP_data", TRAIN_CLI_SAMPLES)
    cache = tmp / "train_cache"
    r = run_module(tmp, "train_cli", "build_cache", "geomconsistentfr_torch.cli", "build-cache",
                   "--src", tmp / "MP_data", "--out", cache)
    built = last_json(r["stdout"])
    print(json.dumps({"phase": "train_cli", "tree_s": tree["seconds"], "build_cache": built}), flush=True)
    check(built["num_samples"] == TRAIN_CLI_SAMPLES and built["decoder"] == jpeg_reader()[0], "train_cli",
          f"build-cache printed {built}")
    check(not any(r["launches"].values()), "train_cli", f"build-cache launched {r['launches']}")
    build_cache(str(tmp / "MP_data"), str(tmp / "train_cache_here"))
    for name in sorted(p.name for p in cache.iterdir()):
        check((cache / name).read_bytes() == (tmp / "train_cache_here" / name).read_bytes(), "train_cli",
              f"build-cache's {name} differs from build_cache in this process")

    cfg_path = tmp / "train_cli.json"
    cfg_path.write_text(json.dumps({"train": {"data_residency": "device", "batches_per_epoch": TRAIN_CLI_BATCHES}}))
    out = tmp / "train_run"
    r_train = run_module(tmp, "train_cli", "train", "geomconsistentfr_torch.cli", "train", "--data", cache,
                         "--config", cfg_path, "--epochs", 2, "--profile", "--visualize-every", 1, "--out", out,
                         timeout=600)
    lines = [json.loads(x) for x in r_train["stdout"].strip().splitlines()]
    print(json.dumps({"phase": "train_cli", "train_wall_s": r_train["wall_s"], "epochs": lines}), flush=True)
    check([m["epoch"] for m in lines] == [0, 1], "train_cli", f"train printed {lines}")
    steps = 2 * TRAIN_CLI_BATCHES
    # Each step stages, marches (K2) and steps back (march_grad); each epoch's visuals march once (K1).
    want = counts(stage=steps + 2, march_argmin=steps, march_grad=steps, march=2)
    check(r_train["launches"] == want, "train_cli", f"train launched {r_train['launches']}, expected {want}")
    traces = sorted((out / "profile").glob("*.json"))
    check(len(traces) == 2, "train_cli", f"expected a trace an epoch, found {[p.name for p in traces]}")
    trace_text = traces[0].read_text()
    for kernel in ("stage_kernel", "march_kernel", "march_grad_kernel"):
        check(kernel in trace_text, "train_cli", f"the trace does not name {kernel}")
    index = out / "visuals" / "index.html"
    pngs = sorted(str(p.relative_to(out)) for p in (out / "visuals").glob("epoch_*/*.png"))
    check(index.exists() and len(pngs) == 10 and all(p.split("/", 1)[1] in index.read_text() for p in pngs),
          "train_cli", f"visuals: index {index.exists()}, PNGs {pngs}")

    # The same cache in this process: resident batches against streamed ones, bit for bit;
    # the first epoch's losses against the CLI's; a step's time under each residency.
    cfg = C.load_config(str(cfg_path), preset="target_lighting_train")
    data = CelebAHQRelightingData(str(cache))
    trainers = {res: Trainer(dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_residency=res)),
                             data, workdir=str(tmp / f"train_here_{res}")) for res in ("device", "stream")}
    check(isinstance(trainers["device"]._resident(), DeviceResidentBatches), "train_cli", "the set is not resident")
    for epoch in (0, 1):
        got = trainers["device"]._batches(np.random.default_rng([cfg.train.seed, epoch]), 0)
        want_b = trainers["stream"]._batches(np.random.default_rng([cfg.train.seed, epoch]), 0)
        for i, (g, w) in enumerate(zip(got, want_b)):
            for k in w:
                check(g[k].is_cuda and torch.equal(g[k], w[k]), "train_cli",
                      f"epoch {epoch} batch {i}: resident {k} differs from the streamed one")

    def rel_to(got: dict, want: dict) -> float:
        return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-12) for k in want if k not in ("epoch", "seconds"))

    # The four-step epoch's means are reported, not held: march_grad's atomics and cuDNN's
    # backward add in no fixed order, and at lr 1e-4 the GAN's trajectory amplifies the last
    # bits of one step into percents a few steps on (tests/test_torch_train.py's docstring).
    # What is held is a one-step epoch (its losses precede any update) from another `cli train`.
    _, here4 = trainers["stream"].run_epoch(trainers["stream"].init_or_resume(), 0)
    one = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batches_per_epoch=1))
    cfg_path.write_text(json.dumps({"train": {"data_residency": "device", "batches_per_epoch": 1}}))
    r_one = run_module(tmp, "train_cli", "train_one_step", "geomconsistentfr_torch.cli", "train", "--data", cache,
                       "--config", cfg_path, "--epochs", 1, "--out", tmp / "train_run_one")
    check(r_one["launches"] == counts(stage=1, march_argmin=1, march_grad=1), "train_cli",
          f"a one-step epoch launched {r_one['launches']}")
    ref = Trainer(dataclasses.replace(one, train=dataclasses.replace(one.train, data_residency="stream")), data,
                  workdir=str(tmp / "train_here_one"))
    _, here1 = ref.run_epoch(ref.init_or_resume(), 0)
    rel = rel_to(last_json(r_one["stdout"]), here1)
    check(rel <= TRAIN_BARS["loss_rel"], "train_cli", f"the CLI's first-step losses are {rel:.3g} from this process's")

    runs = {}  # residency -> (trainer, state, ms a step of each timed window)
    for res in ("device", "stream"):
        tcfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_residency=res,
                                                                  batches_per_epoch=TRAIN_CLI_TIMED_STEPS))
        trainer = Trainer(tcfg, data, workdir=str(tmp / f"train_timed_{res}"))
        runs[res] = (trainer, trainer.init_or_resume(), [])
    for rnd in range(5):  # alternating windows; the first of each is a warm-up
        for res in (("device", "stream") if rnd % 2 == 0 else ("stream", "device")):
            trainer, st, ms = runs[res]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_epoch(st, 0)
            torch.cuda.synchronize()
            if rnd:
                ms.append((time.perf_counter() - t0) / TRAIN_CLI_TIMED_STEPS * 1e3)
    step_ms = {res: statistics.median(ms) for res, (_, _, ms) in runs.items()}
    emit("train_cli", ok=True, samples=TRAIN_CLI_SAMPLES, tree_s=tree["seconds"], decoder=built["decoder"],
         libjpeg=jpeg, build_cache_s=built["seconds"], build_cache_samples_per_s=built["samples_per_s"],
         build_cache_wall_s=r["wall_s"], build_cache_startup_s=r["startup_s"],
         train_wall_s=r_train["wall_s"], train_startup_s=r_train["startup_s"], train_run_s=r_train["run_s"],
         epochs=lines, first_step_rel_to_here=rel, four_step_epoch_rel_to_here=rel_to(lines[0], here4),
         launches=r_train["launches"], one_step_launches=r_one["launches"], traces=[p.name for p in traces],
         trace_bytes=sum(p.stat().st_size for p in traces), visuals=pngs,
         step_ms_device=step_ms["device"], step_ms_stream=step_ms["stream"],
         step_device_over_stream=step_ms["device"] / step_ms["stream"], seconds=time.perf_counter() - started)
    add_launches(r_train["launches"], r_one["launches"])
    return r_train["launches"]


def eval_lpips_subset(root: Path, out: Path, tmp: Path, trunk: str, lin: str) -> dict:
    """`cli eval-multipie --eval-only` with LPIPS over the first LPIPS_EVAL_SUBSET triples of the
    evaluation's dump, against evaluate_output_dir with an LPIPSMetric on the card in this process."""
    import os

    from geomconsistentfr_torch.metrics.eval_multipie import evaluate_output_dir
    from geomconsistentfr_torch.models.lpips import LPIPSMetric, load_trunk_state

    sub, dump = tmp / "multipie_subset", tmp / "eval_dump_subset"
    for d in ("input_images_MP_18_lightings", "groundtruth_images_MP_18_lightings", "MP_depth_masks_fill_nose"):
        (sub / d).mkdir(parents=True)
        for name in sorted(os.listdir(root / d))[:LPIPS_EVAL_SUBSET]:
            os.symlink(root / d / name, sub / d / name)
    dump.mkdir()
    for name in sorted(n for n in os.listdir(out) if n.endswith("_rendered_image.png"))[:LPIPS_EVAL_SUBSET]:
        os.symlink(out / name, dump / name)
    r = run_module(tmp, "eval", "eval_lpips_subset", "geomconsistentfr_torch.cli", "eval-multipie", "--checkpoint",
                   "unused.pth", "--data-root", sub, "--out", dump, "--eval-only", "--lpips-trunk", trunk,
                   "--lpips-lin", lin)
    got = last_json(r["stdout"])
    metric = LPIPSMetric(lin_weights_path=lin, trunk_state=load_trunk_state(trunk))
    want = evaluate_output_dir(str(dump), str(sub / "groundtruth_images_MP_18_lightings"),
                               str(sub / "MP_depth_masks_fill_nose"), lpips_fn=metric)
    rel = abs(got["masked_lpips_mean"] - want["masked_lpips_mean"]) / abs(want["masked_lpips_mean"])
    check(rel <= LPIPS_EVAL_REL, "eval", f"the CLI's LPIPS mean over {LPIPS_EVAL_SUBSET} triples is {rel:.3g} "
          f"from this process's ({got['masked_lpips_mean']} vs {want['masked_lpips_mean']})")
    # LPIPS's own cost an image, as evaluate_output_dir pays it (the host's float64 arrays in,
    # the map back): the share of the evaluation it takes.
    import numpy as np

    a = np.random.default_rng(0).uniform(0, 1, (256, 256, 3))
    metric(a, a)
    t0 = time.perf_counter()
    for _ in range(20):
        metric(a, a)
    return dict(subset_rel=rel, subset_mean=got["masked_lpips_mean"], subset_wall_s=r["wall_s"],
                lpips_ms_an_image=(time.perf_counter() - t0) / 20 * 1e3)


def bapps_trees(tmp: Path) -> tuple:
    """A 2AFC tree and a JND tree of BAPPS_TRIPLETS synthetic patches each (the goldens' faces
    cut to 64x64, distorted twice), by the port's PNG writer."""
    import numpy as np

    rng = np.random.default_rng(0)
    faces = [to_u8(np.load(p)["image"]) for p in sorted(GOLDEN.glob("ref_*.npz"))]
    roots = (tmp / "bapps_2afc", tmp / "bapps_jnd")
    for root, dirs, scalar in ((roots[0], ("ref", "p0", "p1"), "judge"), (roots[1], ("p0", "p1"), "same")):
        (root / scalar).mkdir(parents=True)
        for i in range(BAPPS_TRIPLETS):
            y, x = rng.integers(0, 256 - BAPPS_SIZE, 2)
            ref = faces[i % len(faces)][y:y + BAPPS_SIZE, x:x + BAPPS_SIZE].astype(np.int32)
            for d in dirs:
                noise = 0 if d == "ref" else rng.normal(scale=8 if d == "p0" else 20, size=ref.shape)
                write_png(root / d / f"{i:06d}.png", np.clip(ref + noise, 0, 255).astype(np.uint8))
            np.save(root / scalar / f"{i:06d}.npy", rng.uniform(0, 1, (1,)).astype(np.float32))
    return roots


def phase_lpips(tmp: Path, trunk: str, lin: str) -> dict:
    """LPIPSMetric (alex, vgg, squeeze) at 256x256 on the card against the CPU, its ms a pair;
    `cli lpips-train` and `cli lpips-score` (2afc, jnd) on synthetic BAPPS trees."""
    import numpy as np
    import torch

    from geomconsistentfr_torch.data.bapps import score_2afc_directory, score_jnd_directory
    from geomconsistentfr_torch.models.lpips import LPIPSMetric, load_lin_weights, load_trunk_state

    started = time.perf_counter()
    rng = np.random.default_rng(1)
    gt = torch.from_numpy(rng.uniform(0, 1, (8, 256, 256, 3)).astype(np.float32))
    pred = torch.clamp(gt + torch.from_numpy(rng.normal(scale=0.1, size=gt.shape).astype(np.float32)), 0, 1)
    nets = {}
    for net in ("alex", "vgg", "squeeze"):
        card, cpu = (LPIPSMetric(allow_random_trunk=True, net=net, device=d) for d in ("cuda", "cpu"))
        want = cpu.batch(gt, pred)
        row = {}
        for b in (1, 8):
            got = card.batch(gt[:b], pred[:b]).cpu()
            err = (got - want[:b]).abs().max().item() / want[:b].abs().max().item()
            check(err <= LPIPS_BAR, "lpips", f"{net} batch {b}: the card is {err:.3g} of the map's max from the CPU")
            g, p = gt[:b].cuda(), pred[:b].cuda()
            ms = cuda_time_ms(lambda: card.batch(g, p), iters=10, warmup=2, windows=3)
            row[f"b{b}"] = dict(rel_err=err, ms=ms, ms_a_pair=ms / b)
        nets[net] = row

    roots = bapps_trees(tmp)
    heads = tmp / "lpips_trained.npz"
    r_train = run_module(tmp, "lpips", "lpips_train", "geomconsistentfr_torch.cli", "lpips-train", "--data-root",
                         roots[0], "--out", heads, "--trunk", trunk, "--epochs", 1, "--epochs-decay", 1,
                         "--batch-size", 16)
    train_lines = [json.loads(x) for x in r_train["stdout"].strip().splitlines()]
    check(len(train_lines) == 3 and all(np.isfinite(m["loss_total"]) for m in train_lines[:2])
          and len(load_lin_weights(str(heads))) == 5, "lpips", f"lpips-train printed {train_lines}")
    metric = LPIPSMetric(lin_weights_path=lin, trunk_state=load_trunk_state(trunk))

    def distance(a, b):
        return float(np.mean(metric(a, b)))

    scores = {}
    for mode, root in (("2afc", roots[0]), ("jnd", roots[1])):
        r = run_module(tmp, "lpips", f"lpips_score_{mode}", "geomconsistentfr_torch.cli", "lpips-score", "--mode",
                       mode, "--data-root", root, "--trunk", trunk, "--lin", lin)
        got = last_json(r["stdout"])["score"]
        want = round((score_2afc_directory if mode == "2afc" else score_jnd_directory)(str(root), distance), 6)
        check(got == want, "lpips", f"lpips-score {mode} printed {got}, this process scores {want}")
        scores[mode] = dict(score=got, wall_s=r["wall_s"], startup_s=r["startup_s"])
    emit("lpips", ok=True, nets=nets, lpips_train=dict(lines=train_lines, wall_s=r_train["wall_s"],
                                                       startup_s=r_train["startup_s"]),
         lpips_score=scores, seconds=time.perf_counter() - started)


def crop_frame(goldens) -> tuple:
    """A CROP_FRAME^2 RGB frame: a golden face scaled to 512x512 on a textured background."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    rng = np.random.default_rng(3)
    frame = rng.integers(40, 120, (CROP_FRAME, CROP_FRAME, 3)).astype(np.uint8)
    face = torch.from_numpy(goldens[0][1]["image"]).permute(2, 0, 1)[None].float()
    face = F.interpolate(face, size=(512, 512), mode="bilinear", align_corners=False)[0].permute(1, 2, 0).numpy()
    frame[300:812, 260:772] = to_u8(face)
    return frame


def calibrated_s3fd(frame, seed: int = 0):
    """A seeded S3FD whose face biases are shifted so that a few boxes pass: the four finer heads
    (anchors of 16-128 px, below the crop's 200 px minimum) never fire, and on the two coarsest
    (256 and 512 px) five anchors of this frame score above 0.5. Random weights would score
    every anchor near 0.5, and every anchor would go to the NMS, quadratic in them."""
    import numpy as np
    import torch

    from geomconsistentfr_torch.models.s3fd import S3FD, SOURCES, heads
    from geomconsistentfr_torch.preprocess import PAD

    model = S3FD(generator=torch.Generator().manual_seed(seed)).cuda()
    padded = np.pad(frame, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="reflect")[..., ::-1]
    outs = heads(model, np.ascontiguousarray(padded))
    # Face-minus-background logits of every anchor of the two coarsest heads; the shift puts
    # the fifth best at a score of 0.5.
    margins = np.sort(np.concatenate([(outs[2 * i][..., 1] - outs[2 * i][..., 0]).ravel() for i in (4, 5)]))
    shift = -0.5 * float(margins[-5] + margins[-6])
    with torch.no_grad():
        for i, (src, _) in enumerate(SOURCES):
            bias = getattr(model, f"{src}_mbox_conf").bias
            bias[3 if i == 0 else 1] += -100.0 if i < 4 else shift
    return model


def phase_crop(goldens, tmp: Path) -> dict:
    """`cli crop --s3fd-weights` on a 1024x1024 frame against crop_largest_face in this process;
    S3FD's heads on the card against the CPU; S3FD ms a frame."""
    import numpy as np
    import torch

    from geomconsistentfr_torch.models.s3fd import heads
    from geomconsistentfr_torch.preprocess import PAD, crop_largest_face, detect_faces_s3fd
    from geomconsistentfr_torch.utils.io import imread

    started = time.perf_counter()
    frame = crop_frame(goldens)
    image = write_png(tmp / "crop_frame.png", frame)
    model = calibrated_s3fd(frame)
    weights = tmp / "s3fd.pth"
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    detections = detect_faces_s3fd(frame, model=model)
    check(0 < len(detections) <= 5, "crop", f"S3FD kept {len(detections)} boxes")
    want = crop_largest_face(frame, [tuple(float(v) for v in d[:4]) for d in detections])
    check(want is not None, "crop", "the largest detected face is below the crop's 200 px minimum")
    out = tmp / "crop.png"
    r = run_module(tmp, "crop", "crop", "geomconsistentfr_torch.cli", "crop", "--image", image, "--s3fd-weights",
                   weights, "--out-image", out)
    report = last_json(r["stdout"])
    check(report["detections"] == len(detections), "crop", f"crop printed {report}, {len(detections)} here")
    diff = int(np.count_nonzero(imread(str(out)) != want))
    check(diff == 0, "crop", f"the CLI's crop differs from crop_largest_face in {diff} bytes")

    padded = np.ascontiguousarray(np.pad(frame, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="reflect")[..., ::-1])
    card = heads(model, padded)
    cpu = heads(model.cpu(), padded)
    errs = [float(np.abs(g - w).max() / np.abs(w).max()) for g, w in zip(card, cpu)]
    check(max(errs) <= S3FD_BAR, "crop", f"S3FD's heads on the card are {max(errs):.3g} from the CPU's")
    model.cuda()
    x = torch.from_numpy((padded.astype(np.float32) - np.float32([104.0, 117.0, 123.0]))[None]).cuda()
    from geomconsistentfr_torch.models.layers import exact_convs

    with torch.no_grad(), exact_convs():
        frame_ms = cuda_time_ms(lambda: model(x), iters=5, warmup=2, windows=3)
    emit("crop", ok=True, frame=CROP_FRAME, detections=len(detections), best_score=float(detections[0][4]),
         heads_rel_err=max(errs), s3fd_ms_a_frame=frame_ms, wall_s=r["wall_s"], startup_s=r["startup_s"],
         run_s=r["run_s"], seconds=time.perf_counter() - started)


def phase_visualize_lighting(tmp: Path) -> None:
    """`cli visualize-lighting` for the 21 presets, each PNG the bytes of lighting_sphere in this process."""
    import numpy as np

    from geomconsistentfr_torch.lighting_presets import LIGHT_PRESETS, lighting_sphere
    from geomconsistentfr_torch.utils.io import imread

    out = tmp / "spheres"
    r = run_module(tmp, "visualize_lighting", "visualize_lighting", "geomconsistentfr_torch.cli",
                   "visualize-lighting", "--out", out)
    check(last_json(r["stdout"])["count"] == len(LIGHT_PRESETS) == 21, "visualize_lighting", r["stdout"])
    for name, direction in LIGHT_PRESETS.items():
        want = (lighting_sphere(direction) * 255.0 + 0.5).astype(np.uint8)
        check(np.array_equal(imread(str(out / f"{name}.png")), want), "visualize_lighting",
              f"{name}.png differs from lighting_sphere")
    emit("visualize_lighting", ok=True, spheres=len(LIGHT_PRESETS), wall_s=r["wall_s"], startup_s=r["startup_s"])


# ---------------------------------------------------------------------------
# Orbax checkpoints (the port's own reader and writer) and the multi-rank
# launch of the CLI, the trainer and the server under torchrun.
# ---------------------------------------------------------------------------

ORBAX_FIXTURE = GOLDEN / "orbax_relightnet_seed0"  # tests/torch_make_orbax_fixture.py wrote it with JAX
ORBAX_HASHES = GOLDEN / "orbax_relightnet_seed0.sha256.json"
ORBAX_BATCH = 8  # the golden faces, through a Relighter loaded from the fixture
LAUNCH_RANKS = 2  # ranks of each torchrun, on the one card (gloo)
# `cli train` over two ranks: batch 4 (two images a rank), two epochs of two
# steps. At the preset's lr 1e-4 the GAN amplifies the order of the ranks'
# sums (BatchNorm moments, march_grad's and cuDNN's atomics) into percents of
# a loss within a few steps (phase train_cli); at 1e-6 the four steps stay
# within LATER_STEP_BARS of one process, so they can be held there.
LAUNCH_TRAIN = {"train": {"batch_size": 4, "batches_per_epoch": 2, "learning_rate": 1e-6, "log_every_steps": 1,
                          "checkpoint_every_steps": 0}}
LAUNCH_TRAIN_SAMPLES = 16


def phase_orbax(goldens, files, tmp: Path) -> dict:
    """The committed JAX-written fixture through the port's reader (every leaf to its sha256),
    load_relighter on it against a Relighter of the same weights in memory (strict and draft,
    bytes), and `cli convert` of the surface's .pth read back."""
    import hashlib

    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.convert import (
        load_checkpoint,
        state_dict_from_jax_variables,
        transfer_to_target_variant,
    )
    from geomconsistentfr_torch.infer import Relighter, load_relighter
    from geomconsistentfr_torch.utils import zstd
    from geomconsistentfr_torch.utils.checkpoint import restore_variables

    started = time.perf_counter()
    want = json.loads(ORBAX_HASHES.read_text())
    reads = []
    for _ in range(3):
        t = time.perf_counter()
        tree = restore_variables(str(ORBAX_FIXTURE))
        reads.append(time.perf_counter() - t)
    flat = {f"{group}.{module}.{leaf}": v for group, modules in tree.items() for module, leaves in modules.items()
            for leaf, v in leaves.items()}
    check(sorted(flat) == sorted(want["leaves"]), "orbax", f"read {len(flat)} leaves, the hashes list "
          f"{len(want['leaves'])}")
    for name, v in flat.items():
        h = want["leaves"][name]
        check(v.dtype.str == h["dtype"] and list(v.shape) == h["shape"]
              and hashlib.sha256(v.tobytes()).hexdigest() == h["sha256"], "orbax", f"{name} differs from its hash")
    values = int(sum(v.size for v in flat.values()))
    check(values == want["num_values"], "orbax", f"{values} values, the hashes say {want['num_values']}")
    on_disk = sum(p.stat().st_size for p in ORBAX_FIXTURE.rglob("*") if p.is_file())

    dev = torch.device("cuda")
    batch = goldens[:ORBAX_BATCH]
    images = torch.from_numpy(np.stack([g["image"] for _, g in batch])).to(dev)
    masks = torch.from_numpy(np.stack([g["mask"] for _, g in batch])).to(dev)
    lights = torch.from_numpy(np.stack([g["target_light"][0] for _, g in batch]).astype(np.float32)).to(dev)
    state = transfer_to_target_variant(state_dict_from_jax_variables(tree))
    launches, tiers = counts(), {}
    for tier in ("strict", "draft"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        torch.cuda.synchronize()
        t = time.perf_counter()
        rl = load_relighter(str(ORBAX_FIXTURE), cfg=cfg)
        load_s = time.perf_counter() - t
        reset_launches()
        got = rl.forward_visuals(images, masks, lights).cpu()
        n = march_launches()
        check(n == TIER_LAUNCHES[tier], "orbax", f"{tier}: the forward launched {n}")
        add_launches(launches, n)
        ref = Relighter(cfg, state).forward_visuals(images, masks, lights).cpu()
        diff = int((got != ref).sum())
        check(diff == 0, "orbax", f"{tier}: load_relighter(dir) differs from the weights in memory in {diff} bytes")
        tiers[tier] = dict(load_relighter_s=load_s, batch=ORBAX_BATCH, bytes_equal=True)
        del rl

    out = tmp / "converted"
    r = run_module(tmp, "orbax", "convert", "geomconsistentfr_torch.cli", "convert", "--pth", files["pth"],
                   "--out", out)
    report = last_json(r["stdout"])
    pth = load_checkpoint(files["pth"])
    n_values = sum(v.numel() for k, v in pth.items() if not k.endswith("num_batches_tracked"))
    check(report == {"out": str(out), "num_values": n_values}, "orbax", f"convert printed {report}")
    back = state_dict_from_jax_variables(restore_variables(str(out)))
    same = sorted(back) == sorted(pth) and all(torch.equal(back[k], pth[k]) for k in pth)
    check(same, "orbax", "the converted checkpoint reads back to other tensors than the .pth")
    check(not any(r["launches"].values()), "orbax", f"convert launched {r['launches']}")
    emit("orbax", ok=True, fixture=str(ORBAX_FIXTURE.relative_to(ROOT)), leaves=len(flat), values=values,
         bytes_on_disk=on_disk, read_s=sorted(reads)[1], read_s_each=reads, libzstd=zstd.version(), tiers=tiers,
         launches=launches, convert=dict(num_values=n_values, wall_s=r["wall_s"], startup_s=r["startup_s"],
                                         run_s=r["run_s"], read_back="equal"),
         seconds=time.perf_counter() - started)
    return launches


def start_ranks(tmp: Path, tag: str, module: str, *args) -> dict:
    """Start `python -m module args` as LAUNCH_RANKS ranks under torchrun; finish_ranks waits for it."""
    report = tmp / f"{tag}.run.json"
    out, err = open(tmp / f"{tag}.stdout", "w+"), open(tmp / f"{tag}.stderr", "w+")
    proc = subprocess.Popen(torchrun_cmd(tmp, report, LAUNCH_RANKS, module, *args), cwd=ROOT, env=module_env(),
                            stdout=out, stderr=err, text=True)
    return dict(tag=tag, proc=proc, report=report, out=out, err=err, t0=time.time())


def finish_ranks(run: dict, timeout=600) -> dict:
    """Rank 0's stdout, the launches of each rank, the seconds (wall, start-up to the slowest rank's
    CUDA context, run) of a start_ranks run; fails unless torchrun and every rank exited 0."""
    tag, proc = run["tag"], run["proc"]
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    wall = time.time() - run["t0"]
    run["out"].seek(0)
    run["err"].seek(0)
    stdout, stderr = run["out"].read(), run["err"].read()
    run["out"].close()
    run["err"].close()
    check(proc.returncode == 0, "launch", f"{tag}: torchrun exited {proc.returncode}: {stderr[-3000:]}")
    reps = rank_reports(run["report"], LAUNCH_RANKS)
    check(all(rep["exit_code"] == 0 for rep in reps), "launch", f"{tag}: ranks exited {[r['exit_code'] for r in reps]}")
    ready = max(rep["t_ready"] for rep in reps)
    return dict(stdout=stdout, per_rank=[rep["launches"] for rep in reps], wall_s=wall,
                startup_s=ready - run["t0"], run_s=max(rep["t_end"] for rep in reps) - ready)


def json_lines(text: str) -> list:
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def png_diff(a_path, b_path) -> tuple:
    """(bytes that differ, the largest difference in levels) between two PNGs' pixels."""
    import numpy as np

    from geomconsistentfr_torch.utils.io import imread

    a, b = imread(str(a_path)).astype(np.int16), imread(str(b_path)).astype(np.int16)
    return int(np.count_nonzero(a != b)), int(np.abs(a - b).max())


def expected_rows(rl, img, msk, lights, b: int):
    """forward_visuals of each light as a row of a batch of b copies of the face: (rendered, weights)."""
    import numpy as np

    out = []
    for start in range(0, len(lights), b):
        rows = [lights[(start + k) % len(lights)] for k in range(b)]
        pack = rl.forward_visuals(np.repeat(img[None], b, 0), np.repeat(msk[None], b, 0), np.asarray(rows),
                                  np.full((b,), 0.5, np.float32)).cpu().numpy()
        out += [(p[..., 0:3], p[..., 3]) for p in pack[:min(b, len(lights) - start)]]
    return out


def launch_server(files, tmp: Path, tag: str, flags: tuple, lone_rows: dict, load_rows: dict, sizes: dict, lights):
    """The server as LAUNCH_RANKS ranks under torchrun: a lone request per tier byte-equal to
    forward_visuals at batch 1 (lone_rows), phase serve's closed-loop load at the default tier with
    every answer held against one process at the batch sizes `sizes` (load_rows: batch size -> a row
    per light), then SIGTERM: every rank exits 0."""
    import base64
    import signal
    import threading

    import numpy as np

    from geomconsistentfr_torch.utils.io import decode_image

    base = {"image": b64_file(files["transfer_00104"]), "mask": b64_file(files["transfer_00104_mask"])}
    started = time.perf_counter()
    server = ServerProcess(tmp, "--checkpoint", files["pth"], "--port", "0", "--warmup", *flags,
                           ranks=LAUNCH_RANKS, tag=f"launch_{tag}")
    try:
        serving = server.lines[-1]
        check(serving.get("ranks") == LAUNCH_RANKS, "launch", f"{tag}: serving line {serving}")
        lone = {}
        for k, tier in enumerate(("strict", "high", "draft")):
            status, payload = server.request("POST", "/relight", {**base, "light": lights[k].tolist(),
                                                                  "precision": tier})
            check(status == 200, "launch", f"{tag}: lone {tier}: {status} {payload}")
            rendered, weights = lone_rows[tier][k]
            got = (decode_image(base64.b64decode(payload["rendered"])),
                   decode_image(base64.b64decode(payload["shadow_mask"])))
            check(np.array_equal(got[0], rendered) and np.array_equal(got[1], weights), "launch",
                  f"{tag}: a lone {tier} request differs from forward_visuals at batch 1")
            lone[tier] = "byte-equal"

        bodies = [json.dumps({**base, "light": lights[k].tolist()}) for k in range(len(lights))]
        latencies, answers, lock = [], [], threading.Lock()

        def client(c):
            mine = []
            for j in range(SERVE_PER_CLIENT):
                k = (c * SERVE_PER_CLIENT + j) % len(lights)
                t = time.perf_counter()
                status, payload = server.request("POST", "/relight", bodies[k])
                mine.append((time.perf_counter() - t, k, status, payload))
            with lock:
                latencies.extend(m[0] for m in mine)
                answers.extend(m[1:] for m in mine)

        _, s0 = server.request("GET", "/statz")
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,)) for c in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        _, s1 = server.request("GET", "/statz")
        n = SERVE_CLIENTS * SERVE_PER_CLIENT
        check(len(answers) == n and all(a[1] == 200 for a in answers), "launch", f"{tag}: {len(answers)} answers")
        # Each answer against one process: first at the batch sizes the server pads to (B), else at each
        # rank's share of them (B / 2, data mode), where cuDNN may pick other algorithms.
        held = {"at_B": 0, "at_B_over_2": 0}
        worst = dict(bytes_at_B=0, levels_at_B=0)
        for k, _, payload in answers:
            got = (decode_image(base64.b64decode(payload["rendered"])),
                   decode_image(base64.b64decode(payload["shadow_mask"])))

            def equal(b):
                return all(np.array_equal(g, w) for g, w in zip(got, load_rows[b][k]))

            if any(equal(b) for b in sizes["B"]):
                held["at_B"] += 1
                continue
            check(any(equal(b) for b in sizes["B_over_2"]), "launch",
                  f"{tag}: light {k}'s answer equals no one-process forward_visuals at {sizes}")
            held["at_B_over_2"] += 1
            diffs = [(sum(int(np.count_nonzero(g != w)) for g, w in zip(got, load_rows[b][k])),
                      max(int(np.abs(g.astype(np.int16) - w).max()) for g, w in zip(got, load_rows[b][k])))
                     for b in sizes["B"]]
            nbytes, levels = min(diffs)
            worst = dict(bytes_at_B=max(worst["bytes_at_B"], nbytes), levels_at_B=max(worst["levels_at_B"], levels))
        delta = {k: s1[k] - s0[k] for k in ("batches", "batched_rows", "padded_rows", "errors")}
        lat = np.asarray(latencies) * 1e3
        load = dict(clients=SERVE_CLIENTS, requests=n, wall_s=wall, req_per_s=n / wall,
                    p50_ms=float(np.percentile(lat, 50)), p99_ms=float(np.percentile(lat, 99)), statz=delta,
                    mean_batch_rows=delta["batched_rows"] / max(delta["batches"], 1), answers=held, **worst)
        server.proc.send_signal(signal.SIGTERM)
        out, _ = server.proc.communicate(timeout=120)
    finally:
        server.close()
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    final = next((x for x in lines if "drained" in x), None)
    follower = next((x for x in lines if "follower" in x), None)
    check(final is not None and final["drained"], "launch", f"{tag}: after SIGTERM rank 0 printed {lines}")
    reps = rank_reports(server.report, LAUNCH_RANKS)
    check(all(rep["exit_code"] == 0 for rep in reps), "launch",
          f"{tag}: after SIGTERM the ranks exited {[rep['exit_code'] for rep in reps]}")
    check(follower is not None and follower["tiers"] == final["tiers"]
          and all(v["ranks"] == LAUNCH_RANKS for v in final["tiers"].values()), "launch",
          f"{tag}: tiers {final['tiers']}, follower {follower}")
    per_rank = [rep["launches"] for rep in reps]
    for r, n_r in enumerate(per_rank):
        check(all(n_r[k] > 0 for k in ("stage", "march", "march_argmin", "refine")), "launch",
              f"{tag}: rank {r} launched {n_r}")
    return per_rank, dict(flags=list(flags), serving=serving, ready_s=server.ready_s, lone=lone, load=load,
                          sigterm=dict(exit_codes=[rep["exit_code"] for rep in reps], drained=final["drained"]),
                          launches_per_rank=per_rank, tiers=final["tiers"], seconds=time.perf_counter() - started)


def phase_launch(files, tmp: Path, serve_load: dict) -> dict:
    """Two ranks under torchrun sharing the card (gloo). At once: `cli relight --sample-parallel`
    (strict, draft) and `cli eval-multipie --data-parallel` against the single-process runs of
    phases cli and eval, and `cli train` against the same epochs in this process. Then the server
    with --data-parallel and with --grid-parallel 1x2 at phase serve's load (beside its one-rank
    numbers, `serve_load`), and SIGTERM."""
    import numpy as np
    import scipy.io
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
    from geomconsistentfr_torch.train import Trainer
    from geomconsistentfr_torch.utils.io import imread, read_image_u8, read_mask_u8

    started = time.perf_counter()
    label = f"{LAUNCH_RANKS} ranks on one {torch.cuda.get_device_name(0)}"
    launches, rows = counts(), {}
    pth, image, mask = files["pth"], files["transfer_00104"], files["transfer_00104_mask"]
    root = tmp / "multipie"  # phase eval's triples and dump
    cfg_path = tmp / "launch_train.json"
    cfg_path.write_text(json.dumps(LAUNCH_TRAIN))

    # The four commands run at the same time (their start-up is most of each); each is
    # checked by its bytes or losses, which do not depend on the others.
    runs = {f"relight_{tier}": start_ranks(tmp, f"launch_relight_{tier}", "geomconsistentfr_torch.cli",
                                           "relight", "--sample-parallel", "--checkpoint", pth, "--precision",
                                           tier, "--image", image, "--mask", mask, "--light-preset",
                                           "multipie_14", "--out", tmp / f"launch_relight_{tier}")
            for tier in ("strict", "draft")}
    runs["eval"] = start_ranks(tmp, "launch_eval", "geomconsistentfr_torch.cli", "eval-multipie", "--data-parallel",
                               "--checkpoint", pth, "--data-root", root, "--batch-size", EVAL_BATCH,
                               "--out", tmp / "launch_eval")
    runs["train"] = start_ranks(tmp, "launch_train", "geomconsistentfr_torch.cli", "train", "--data", "synthetic",
                                "--synthetic-samples", LAUNCH_TRAIN_SAMPLES, "--config", cfg_path, "--epochs", 2,
                                "--out", tmp / "launch_train")
    results = {name: finish_ranks(run) for name, run in runs.items()}
    commands_s = time.perf_counter() - started

    def row(r, **extra):
        for n in r["per_rank"]:
            add_launches(launches, n)
        return dict(per_rank=r["per_rank"], wall_s=r["wall_s"], startup_s=r["startup_s"], run_s=r["run_s"], **extra)

    # relight --sample-parallel against phase cli's single-process PNGs.
    for tier in ("strict", "draft"):
        r, out, one = results[f"relight_{tier}"], tmp / f"launch_relight_{tier}", tmp / f"cli_relight_{tier}"
        check(len(json_lines(r["stdout"])) == 1, "launch", f"relight {tier}: {r['stdout'][-500:]}")
        check(r["per_rank"] == [SAMPLES_LAUNCHES[tier]] * LAUNCH_RANKS, "launch",
              f"relight {tier}: the ranks launched {r['per_rank']}")
        names = sorted(p.name for p in one.iterdir())
        check(len(names) == 7 and sorted(p.name for p in out.iterdir()) == names, "launch", f"relight {tier}: files")
        for name in names:
            check((out / name).read_bytes() == (one / name).read_bytes(), "launch",
                  f"relight {tier}: {name} differs from the single-process run")
        rows[f"relight_{tier}"] = row(r, files_byte_equal=len(names))

    # eval-multipie --data-parallel against phase eval's dump.
    r, out, dump = results["eval"], tmp / "launch_eval", tmp / "eval_dump"
    metrics = json_lines(r["stdout"])
    check(len(metrics) == 1 and metrics[0]["num_inferred"] == EVAL_IMAGES, "launch", f"eval printed {metrics}")
    batches = EVAL_IMAGES // EVAL_BATCH
    check(r["per_rank"] == [counts(stage=batches, march=batches)] * LAUNCH_RANKS, "launch",
          f"eval: the ranks launched {r['per_rank']}")
    kinds = ("rendered_image", "shadow_mask", "albedo", "depth", "shading", "surface_normals")
    differ = [(i, kind) for i in range(EVAL_IMAGES) for kind in kinds
              if (out / f"{i:03d}_{kind}.png").read_bytes() != (dump / f"{i:03d}_{kind}.png").read_bytes()]
    at_b = [png_diff(out / f"{i:03d}_{kind}.png", dump / f"{i:03d}_{kind}.png") for i, kind in differ]
    if differ:  # each rank ran half of each batch: hold those rows at B / 2 in one process
        rl = surface_relighter(pth, "multipie_eval", "high")
        directions = scipy.io.loadmat(root / "MP_lighting_directions.mat")["lighting_directions"]
        half = EVAL_BATCH // LAUNCH_RANKS
        dirs = (root / "input_images_MP_18_lightings", root / "MP_depth_masks_fill_nose")
        for start in sorted({i - i % half for i, _ in differ}):
            idx = range(start, start + half)
            pack = rl.forward_visuals(np.stack([read_image_u8(str(dirs[0] / f"{i:03d}.png")) for i in idx]),
                                      np.stack([read_mask_u8(str(dirs[1] / f"{i:03d}.png")) for i in idx]),
                                      target_light=np.asarray([directions[i % 18] for i in idx], np.float32))
            for k, i in enumerate(idx):
                pack_files_equal({kind: str(out / f"{i:03d}_{kind}.png") for kind in kinds}, pack[k].cpu().numpy(),
                                 "launch", f"eval image {i} at batch {half}")
    rows["eval"] = row(r, images=EVAL_IMAGES, batch=EVAL_BATCH, files=EVAL_IMAGES * len(kinds),
                       files_differing_at_B=len(differ), bytes_differing_at_B=sum(b for b, _ in at_b),
                       max_levels_at_B=max((lv for _, lv in at_b), default=0),
                       held_at_B_over_2=len({i for i, _ in differ}))

    # cli train: two epochs of two data-parallel steps, against the same epochs in this process.
    r = results["train"]
    epochs = json_lines(r["stdout"])
    check([m["epoch"] for m in epochs] == [0, 1], "launch", f"train printed {epochs}")
    steps = 2 * LAUNCH_TRAIN["train"]["batches_per_epoch"]
    want = {k: steps * v for k, v in TRAIN_STEP_LAUNCHES.items()}
    check(r["per_rank"] == [want] * LAUNCH_RANKS, "launch", f"train: the ranks launched {r['per_rank']}")
    cfg = C.load_config(str(cfg_path), preset="target_lighting_train")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_residency="stream"))
    trainer = Trainer(cfg, SyntheticFaceData(num_samples=LAUNCH_TRAIN_SAMPLES, size=256),
                      workdir=str(tmp / "launch_train_here"))
    state, rels = trainer.init_or_resume(), []
    for epoch, got in enumerate(epochs):
        state, here = trainer.run_epoch(state, epoch)
        rels.append(max(abs(got[k] - v) / max(abs(v), 1e-12) for k, v in here.items() if k not in ("epoch", "seconds")))
    check(max(rels) <= LATER_STEP_BARS["loss_rel"], "launch",
          f"train: the epochs' losses are {rels} from one process's (bar {LATER_STEP_BARS['loss_rel']})")
    rows["train"] = row(r, batch=LAUNCH_TRAIN["train"]["batch_size"], steps=steps, loss_rel_to_one_process=rels,
                        bar=LATER_STEP_BARS["loss_rel"], epochs=epochs)
    del trainer, state
    torch.cuda.empty_cache()

    # The servers in data and grid mode, each alone on the card, at phase serve's load.
    img, msk = imread(image), imread(mask)
    rng = np.random.default_rng(0)
    lights = rng.normal(size=(SERVE_BODIES, 3)).astype(np.float32)
    lights[:, 2] = np.abs(lights[:, 2]) + 0.5
    relighters = {t: surface_relighter(pth, "single_image", t) for t in ("strict", "high", "draft")}
    lone_rows = {t: expected_rows(rl, img, msk, lights[:3], 1) for t, rl in relighters.items()}
    load_rows = {b: expected_rows(relighters["high"], img, msk, lights, b) for b in (1, 2, 4, 8)}
    del relighters
    torch.cuda.empty_cache()
    servers = {"one_rank": {k: serve_load[k] for k in ("clients", "requests", "wall_s", "req_per_s", "p50_ms",
                                                       "p99_ms", "mean_batch_rows")}}
    for tag, flags, sizes in (("data", ("--data-parallel",), {"B": (2, 8), "B_over_2": (1, 4)}),
                              ("grid_1x2", ("--grid-parallel", "1x2"), {"B": (1, 8), "B_over_2": ()})):
        per_rank, servers[tag] = launch_server(files, tmp, tag, flags, lone_rows, load_rows, sizes, lights)
        for n in per_rank:
            add_launches(launches, n)
    emit("launch", ok=True, ranks=label, backend="gloo" if torch.cuda.device_count() < LAUNCH_RANKS else "nccl",
         launches=launches, commands_at_once_s=commands_s, seconds=time.perf_counter() - started, **rows,
         servers=servers)
    return launches

# The render fields each tier sets (config.apply_precision_tier), which a
# --config file without --precision carries itself.
TIER_RENDER_FIELDS = ("shadow_matmul_precision", "shadow_resolution_scale", "shadow_refine_halfwidth",
                      "shadow_lowres_t_stride", "shadow_step_pack", "shadow_mask_cull", "shadow_col_chunk")
ADMITTED_SIZE = 240  # a size RenderConfig admits whose march the presets never run (the draft's is 60x60)


def admitted_runs() -> dict:
    """tag -> (the --config file's contents, its preset, the CLI's other flags): `cli relight
    --config` at 240x240 with each tier's fields in the file (chunk 48; the draft's 0, so its
    low-resolution march is 60x60), `cli relight --precision fast --config` with the 'hat' and
    'hat_y' vetoes at 256x256, and one `cli train --precision fast` step at batch 3."""
    from geomconsistentfr_torch import config as C

    runs = {}
    for tier in ("strict", "high", "fast", "draft"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        render = {f: getattr(cfg.render, f) for f in TIER_RENDER_FIELDS}
        render.update(img_height=ADMITTED_SIZE, img_width=ADMITTED_SIZE, shadow_col_chunk=0 if tier == "draft" else 48)
        runs[f"relight_{ADMITTED_SIZE}_{tier}"] = ({"model": {"compute_dtype": cfg.model.compute_dtype},
                                                    "render": render}, "single_image", ())
    for veto in ("hat", "hat_y"):
        runs[f"relight_fast_{veto}"] = ({"render": {"shadow_mask_gather": veto}}, "single_image", ("--precision", "fast"))
    runs["train_fast"] = ({"train": {"batch_size": 3, "batches_per_epoch": 1}}, "target_lighting_train",
                          ("--precision", "fast"))
    return runs


def phase_admitted(files, tmp: Path) -> dict:
    """The slice of the surface at what RenderConfig admits beyond the presets (admitted_runs), each
    command in a process of its own, all started at once: each relight's six PNGs byte-equal to
    Relighter.forward_visuals at batch 1 in this process and its launches those of its march, the
    train step's losses within FAST_LOSS_REL of the same step here; img/s of Relighter.forward at
    batch 64 and of the train step here."""
    import numpy as np
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
    from geomconsistentfr_torch.infer import load_relighter
    from geomconsistentfr_torch.lighting_presets import DEFAULT_AMBIENT, LIGHT_PRESETS
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.train import Trainer
    from geomconsistentfr_torch.utils.io import read_image, read_mask

    started = time.perf_counter()
    pth, image, mask = files["pth"], files["transfer_00104"], files["transfer_00104_mask"]
    runs, procs = admitted_runs(), {}
    for tag, (body, preset, flags) in runs.items():
        path = tmp / f"{tag}.json"
        path.write_text(json.dumps(body))
        if tag == "train_fast":
            args = ("train", "--config", path, *flags, "--data", "synthetic", "--synthetic-samples", 3, "--epochs", 1,
                    "--out", tmp / tag)
        else:
            args = ("relight", "--checkpoint", pth, "--config", path, *flags, "--image", image, "--mask", mask,
                    "--light-preset", "multipie_14", "--out", tmp / tag)
        report = tmp / f"{tag}.run.json"
        out, err = open(tmp / f"{tag}.stdout", "w+"), open(tmp / f"{tag}.stderr", "w+")
        procs[tag] = (subprocess.Popen(module_cmd(report, "geomconsistentfr_torch.cli", *args), cwd=ROOT,
                                       env=module_env(), stdout=out, stderr=err, text=True), report, out, err)
    results = {}
    for tag, (proc, report, out, err) in procs.items():
        try:
            proc.wait(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.seek(0)
        err.seek(0)
        stdout, stderr = out.read(), err.read()
        out.close()
        err.close()
        check(proc.returncode == 0, "admitted", f"{tag}: the cli exited {proc.returncode}: {stderr[-3000:]}")
        rep = json.loads(report.read_text())
        results[tag] = dict(stdout=stdout, launches=rep["launches"], run_s=rep["t_end"] - rep["t_ready"])

    light = np.asarray([LIGHT_PRESETS["multipie_14"]], np.float32)
    ambient = np.asarray([DEFAULT_AMBIENT], np.float32)
    launches, rows = counts(), {}
    for tag, (body, preset, flags) in runs.items():
        r = results[tag]
        add_launches(launches, r["launches"])
        cfg = C.load_config(str(tmp / f"{tag}.json"), preset=preset)
        if flags:
            cfg = C.apply_precision_tier(cfg, flags[1])
        veto = S.resolve_mask_gather(cfg.render)
        if tag == "train_fast":
            check(veto == "bilinear", "admitted", f"{tag}: the veto is {veto}")
            check(r["launches"] == counts(stage=1, march_argmin=1, march_grad=1), "admitted",
                  f"{tag} launched {r['launches']}")
            trainer = Trainer(cfg, SyntheticFaceData(num_samples=3, size=cfg.render.img_height),
                              workdir=str(tmp / f"{tag}_here"))
            state, here = trainer.run_epoch(trainer.init_or_resume(), 0)
            got = last_json(r["stdout"])
            rel = max(abs(got[k] - here[k]) / max(abs(here[k]), 1e-12) for k in here if k not in ("epoch", "seconds"))
            check(rel <= FAST_LOSS_REL, "admitted", f"{tag}: the CLI's losses are {rel:.3g} from this process's")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.run_epoch(state, 1)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            rows[tag] = dict(veto=veto, launches=r["launches"], loss_rel_to_here=rel, step_ms=step_s * 1e3,
                             img_per_s=cfg.train.batch_size / step_s, run_s=r["run_s"])
            continue
        size = cfg.render.img_height
        want_launches = (counts(stage=1, march_argmin=1, refine=1) if cfg.render.shadow_resolution_scale > 1
                         else counts(stage=1, march=1))
        check(r["launches"] == want_launches, "admitted", f"{tag} launched {r['launches']}, expected {want_launches}")
        rl = load_relighter(pth, cfg=cfg)
        img, msk = read_image(image, size), read_mask(mask, size)
        pack = rl.forward_visuals(img[None], msk[None], light, ambient)[0].cpu().numpy()
        pack_files_equal(last_json(r["stdout"])["outputs"], pack, "admitted", tag)
        imgs, msks, lights = (torch.from_numpy(np.repeat(x[None] if x is not light else x, 64, 0)).cuda()
                              for x in (img, msk, light))
        ms = cuda_time_ms(lambda: rl.forward(imgs, msks, lights), 4, windows=3)
        rows[tag] = dict(size=size, veto=veto, chunk=cfg.render.shadow_col_chunk,
                         march=f"{size // cfg.render.shadow_resolution_scale}^2", launches=r["launches"],
                         forward_ms_64=ms, img_per_s=64 / (ms / 1e3), run_s=r["run_s"])
        del rl
        torch.cuda.empty_cache()
    emit("admitted", ok=True, runs=rows, launches=launches, seconds=time.perf_counter() - started)
    return launches


def phase_surface(goldens, e2e: dict) -> dict:
    """The cli, admitted, bench, serve, eval, train_cli, lpips, crop, visualize_lighting, orbax and
    launch phases, in a temporary directory; their launches summed."""
    import tempfile

    launches = counts()
    with tempfile.TemporaryDirectory(prefix="gcfr_surface_") as d:
        tmp = Path(d)
        files = surface_files(goldens, tmp)
        add_launches(launches, phase_cli(files, tmp))
        add_launches(launches, phase_admitted(files, tmp))
        add_launches(launches, phase_bench(tmp, e2e))
        serve_launches, serve_load = phase_serve(files, tmp)
        add_launches(launches, serve_launches)
        lpips_files = lpips_weight_files(tmp)
        add_launches(launches, phase_eval(goldens, files, tmp, lpips_files))
        add_launches(launches, phase_train_cli(tmp))
        phase_lpips(tmp, *lpips_files)
        phase_crop(goldens, tmp)
        phase_visualize_lighting(tmp)
        add_launches(launches, phase_orbax(goldens, files, tmp))
        add_launches(launches, phase_launch(files, tmp, serve_load))
    return launches


# The card's first training step against the same step on the CPU (the plain
# march and VJP), from the same weights and batch, float32 on both sides:
# each loss term within 1e-4 of its size, the gradient norm of D within 1e-3
# and of G within 1e-2. The convolutions, reductions and the renderer's
# eager ops round differently on the two devices, and G's gradient is
# sensitive to rounding: the line also prints how far it moves on the CPU
# alone when the images move by one ulp. 1.7e-3 (G) and 1.3e-5 (D) were
# measured on an H100.
TRAIN_BARS = {"loss_rel": 1e-4, "g_grad_norm_rel": 1e-2, "d_grad_norm_rel": 1e-3}
# A bfloat16 CNN's losses from two processes (the fast tier's train step): one
# bfloat16 ulp, 2^-8, of their size. cuDNN picks its algorithms in each
# process, and at bfloat16 they round apart by a fraction of that.
FAST_LOSS_REL = 2.0 ** -8
TRAIN_STEP_LAUNCHES = counts(stage=1, march_argmin=1, march_grad=1)


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
    return sum(us for _, us in profiled(fn, iters, lambda n: True)) / iters / 1e3


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
            g0, d0, n0, step = flat_params(st.g), flat_params(st.d), march_launches(), st.step
            metrics = step_fn(st, batch, use_skips=use_skips)
            rec = dict(step=step, launches={k: v - n0[k] for k, v in march_launches().items()},
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
        launches = march_launches()
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
        ts, clamp = K._ts_for(dev, rcfg)
        _, idx, staged = K._launch_argmin(depth, mask, light_pt, ts, rcfg, clamp=clamp)
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
                     march_bwd_grad_ms=cuda_time_ms(
                         lambda: K.march_grad_cuda(depth, mask, light_pt, idx, ts, cot, rcfg, staged), 20, windows=5))
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
    "strict": counts(stage=1, march=1),
    # The pooling (the draft staging's, shadows_cuda.pool_march_inputs), K2's key form on the rank's
    # slice of the pooled inputs, the unpack of the keys' MIN, K3 around the combined t*: each stages
    # its own input
    "draft": counts(stage=3, march_argmin=1, refine=1, unpack_key=1),
}
GRID_STEP_LAUNCHES = counts(stage=1, march_grad=1, march_sp=1, unpack_key=1)
# The collectives a K5 forward issues (forward and backward): one MIN of the int64 keys.
K5_COLLECTIVES = 1
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


def k5_inputs(goldens, dev, seed, batch=8):
    """K5's inputs: the golden depth maps and masks, their target lights at the training light
    distance, a seeded random cotangent."""
    import numpy as np
    import torch

    fixtures = [g for _, g in goldens[:batch]]
    depth = torch.from_numpy(np.stack([g["depth"][0, 0] for g in fixtures])).to(dev)
    mask = torch.from_numpy(np.stack([g["mask"] for g in fixtures])).to(dev)
    unit = np.stack([g["target_light"][0] for g in fixtures]).astype(np.float32)
    light = torch.from_numpy(unit / np.linalg.norm(unit, axis=1, keepdims=True) * 4013.0).to(dev)
    cot = torch.from_numpy(np.random.default_rng(seed).normal(size=tuple(depth.shape)).astype(np.float32)).to(dev)
    return depth, mask, light, cot


def parallel_rank(dev, out_dir: str, seed: int) -> None:
    """One rank of the parallel phase; writes <out_dir>/rank<r>.json. Every
    rank runs the same calls in the same order (their collectives pair up)."""
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
    # strict (K1 on 80 of the 160 samples) and draft (K2's key form on 40 of
    # the 80 strided samples, the keys' MIN and the unpack, then K3 on every
    # rank), against the same forward in this process alone.
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
        n = march_launches()
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
    # rank): one collective (forward and backward), bit-equal to K2 on the
    # full grid, its t* equal to the full grid's winner on >= 0.9999 of
    # pixels; K2's key form bit-equal to its packed index form, the unpack to
    # its plain version, march_grad's t-map form to its index form; against
    # its plain version (the plain argmin march on the slice, pack_march_key,
    # the same MIN, unpack_march_key, the plain VJP at the winner) and,
    # through march_grad, against RayMarchMinDistance (K4) on this rank alone.
    cfg = C.preset_target_lighting_train().render
    depth, mask, light, cot = k5_inputs(goldens, dev, seed)
    n_s = world.size
    table = torch.as_tensor(S.sharded_sample_ts(cfg, n_s), device=dev)
    ts_local = table.view(n_s, -1)[rank].contiguous()
    group = world.world_group

    reset_launches()
    d, lp = depth.clone().requires_grad_(), light.clone().requires_grad_()
    with CollectiveCounter() as collectives:
        out = K.RayMarchMinDistanceSP.apply(d, mask, lp, cfg, ts_local, group)
        (out * cot).sum().backward()
    torch.cuda.synchronize()
    n = march_launches()
    check(n == GRID_STEP_LAUNCHES, "parallel", f"K5 forward and backward launched {n}")
    check(collectives.calls == K5_COLLECTIVES, "parallel", f"K5 issued {collectives.calls} collectives")
    ts_full, clamp = K._ts_for(dev, cfg)
    full, full_idx, _ = K._launch_argmin(depth, mask, light, ts_full, cfg, clamp=clamp)
    check(torch.equal(out.detach(), full), "parallel", "K5: distances differ from K2 on the full grid")
    local_min, local_idx, _ = K._launch_argmin(depth, mask, light, ts_local, cfg, clamp=clamp)
    key, _ = K._march_key(depth, mask, light, ts_local, cfg, clamp=clamp)
    check(torch.equal(key, S.pack_march_key(local_min, ts_local[local_idx.long()])), "parallel",
          "K2's key form differs from its packed index form")
    reduced = M.all_min(key, group)
    got_d, t_star = K.unpack_march_key(reduced)
    plain_d, plain_t = S.unpack_march_key(reduced)
    check(torch_equal_bits(got_d, plain_d) and torch_equal_bits(t_star, plain_t), "parallel",
          "the unpack kernel differs from its plain version")
    check(torch.equal(got_d, full), "parallel", "K5: the unpacked distances differ from K2 on the full grid")
    t_agree = (t_star == ts_full[full_idx.long()]).float().mean().item()
    check(t_agree >= 0.9999, "parallel", f"K5: t* equal to the full grid's winner on {t_agree} of pixels")
    plain_min, plain_idx = S.ray_march_argmin_batch(depth, mask, light, cfg, ts_local)
    plain_out, plain_t = S.unpack_march_key(M.all_min(S.pack_march_key(plain_min, ts_local[plain_idx.long()]), group))
    k5_err = check_march(out.detach(), plain_out, "parallel", "K5 vs its plain version")
    plain_t_agree = (plain_t == t_star).float().mean().item()
    check(plain_t_agree >= 0.9999, "parallel", f"K5 vs plain: t* equal on {plain_t_agree} of pixels")
    want_d, want_l = S.march_vjp(depth, mask, light, t_star, cot, cfg)
    d4, lp4 = depth.clone().requires_grad_(), light.clone().requires_grad_()
    (K.RayMarchMinDistance.apply(d4, mask, lp4, cfg) * cot).sum().backward()
    grad_err = {}
    for tag, (gd, gl) in (("vs_plain_vjp", (want_d, want_l)), ("vs_k4", (d4.grad, lp4.grad))):
        dd_rel = (d.grad - gd).abs().max().item() / max(gd.abs().max().item(), 1e-30)
        dl_rel = ((lp.grad - gl).abs() / gl.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
        check(dd_rel <= GRAD_BARS["d_depth_rel_to_max"] and dl_rel <= GRAD_BARS["d_light_rel_to_image_max"],
              "parallel", f"K5 gradients {tag}: d_depth {dd_rel}, d_light {dl_rel}")
        grad_err[tag] = dict(d_depth_rel_to_max=dd_rel, d_light_rel_to_image_max=dl_rel)
    # march_grad's t-map form (K5's backward) against its index form, bit for
    # bit: 64 copies of one golden image, each with a cotangent on one
    # on-face pixel, so one thread makes each copy's gradients and the
    # atomics add in one order.
    on = torch.nonzero(mask[0].reshape(-1)).view(-1)
    pick = on[torch.randperm(on.numel(), generator=torch.Generator().manual_seed(seed))[:64].to(dev)]
    rep_d, rep_m, rep_l = (x[:1].expand(64, *x.shape[1:]).contiguous() for x in (depth, mask, light))
    _, rep_idx, rep_staged = K._launch_argmin(rep_d, rep_m, rep_l, ts_full, cfg, clamp=clamp)
    one_hot = torch.zeros_like(rep_d)
    one_hot.view(64, -1)[torch.arange(64, device=dev), pick] = cot[0].reshape(-1)[pick]
    by_idx = K.march_grad_cuda(rep_d, rep_m, rep_l, rep_idx, ts_full, one_hot, cfg, rep_staged)
    by_t = K.march_grad_at_cuda(rep_d, rep_m, rep_l, ts_full[rep_idx.long()], one_hot, cfg, rep_staged)
    check(torch_equal_bits(by_t[0], by_idx[0]) and torch_equal_bits(by_t[1], by_idx[1]), "parallel",
          "march_grad's t-map form differs from its index form")

    # K5 timed at the training shape (3, 256, 256), as --compare-parent times
    # it: the forward, its slice, the combine, the collectives, march_grad; the
    # plain version (the plain argmin march on the slice, the same combine
    # on the plain keys); the unpack kernel and its plain version.
    td, tm, tl, tc = (x[:3].contiguous() for x in (depth, mask, light, cot))
    k5_time = time_k5(K, td, tm, tl, tc, cfg, ts_local, group)

    def plain_k5():
        p_min, p_idx = S.ray_march_argmin_batch(td, tm, tl, cfg, ts_local)
        return S.unpack_march_key(M.all_min(S.pack_march_key(p_min, ts_local[p_idx.long()]), group))

    plain_ms = cuda_time_ms(plain_k5, 2)
    t_key = M.all_min(K._march_key(td, tm, tl, ts_local, cfg, clamp=clamp)[0], group)
    unpack = dict(ms=cuda_time_ms(lambda: K.unpack_march_key(t_key), 20, windows=5),
                  kernel_ms=kernel_device_ms(lambda: K.unpack_march_key(t_key), name="unpack_key_kernel"),
                  plain_ms=cuda_time_ms(lambda: S.unpack_march_key(t_key), 20, windows=5),
                  # the keys read once, the distances and t* written once
                  **bound(0, 16 * t_key.numel()))
    b, h, w = td.shape
    live = b * h * w  # the training march has no cull
    ops = live * (ts_local.numel() * (OPS_PER_SAMPLE[S.resolve_mask_gather(cfg)] + EXTRA_OPS_PER_SAMPLE[
        "march_argmin"]) + OPS_PER_PIXEL)
    # The forward on one rank: depth and mask read, light and the slice, the
    # distances and t* written (the key's exchange is the collective's).
    nbytes = 4 * (2 * b * h * w + 3 * b + ts_local.numel()) + 4 * 2 * b * h * w
    res["k5"] = dict(launches=n, collectives_fwd_bwd=collectives.calls, distances_equal_full_grid=True,
                     t_star_agreement=t_agree, plain_t_star_agreement=plain_t_agree, max_abs_err=k5_err,
                     grad_err=grad_err, plain_ms=plain_ms, samples_per_rank=ts_local.numel(), **k5_time,
                     unpack=unpack, **bound(ops, nbytes))
    del d, lp, d4, lp4, out, full, want_d, rep_d, rep_m, rep_l, one_hot, by_idx, by_t
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
        launches = march_launches()
        step_ms = cuda_time_ms(lambda: step(state, locals_[0], use_skips=skips), 2, warmup=1, windows=3)
        return dict(records=records, launches=launches, step_ms=step_ms)

    grid = M.make_mesh_grid(1, n_s, dev)
    res["grid"] = run_steps(T.make_grid_parallel_step(tcfg, grid), grid, train_batches(seed, 3, 2), 3)
    want = {k: 2 * v for k, v in GRID_STEP_LAUNCHES.items()}
    check(res["grid"]["launches"] == want, "parallel", f"grid steps launched {res['grid']['launches']}")
    res["grid"]["combine_share"] = k5_time["combine_ms"] / res["grid"]["step_ms"]

    # 4. The 2x1 data-parallel step: batch 4, two images per rank.
    res["dp"] = run_steps(T.make_data_parallel_step(tcfg, world), world, train_batches(seed, 4, 1), 4)
    check(res["dp"]["launches"] == TRAIN_STEP_LAUNCHES, "parallel", f"DP step launched {res['dp']['launches']}")
    with open(Path(out_dir) / f"rank{rank}.json", "w") as f:
        json.dump(res, f)


def grid_table(K, dev, cfg) -> tuple:
    """(the config's t table on dev, the keywords K's launches take with it): a tree with the
    clamped taps returns the table's clamp beside it, which its launches require; an earlier
    tree returns the table alone, and its launches take no such keyword."""
    got = K._ts_for(dev, cfg)
    return (got[0], dict(clamp=got[1])) if isinstance(got, tuple) else (got, {})


def time_k5(K, td, tm, tl, tc, cfg, ts_local, group) -> dict:
    """K5 on this rank at (td, tm, tl), through what this tree and its parent share: the forward
    (CUDA events), K2 on the slice with its staging (slice_ms) and the kernel alone (kernel_ms,
    torch.profiler), the combine alone (the MIN of the keys and the unpack; a tree before the key:
    the MIN of the distances, the first-winner MIN of the indices and the gather of the t table),
    the collectives a forward issues and the bytes this rank hands them, one MIN all_reduce of one
    int64 over the group (collective_floor_ms: what a collective costs at least), and march_grad
    at the winner as K5's backward launches it."""
    import torch
    import torch.distributed as dist

    with torch.no_grad():
        def forward():
            return K.RayMarchMinDistanceSP.apply(td, tm, tl, cfg, ts_local, group)

        forward_ms = cuda_time_ms(forward, 10, windows=5)
        with CollectiveCounter() as collectives:
            forward()
        _, kw = grid_table(K, td.device, cfg)  # K5 takes every rank's slice with the grid's taps
        if hasattr(K, "_march_key"):
            def on_slice():
                return K._march_key(td, tm, tl, ts_local, cfg, **kw)

            key, staged = on_slice()

            def combine():
                return K._combine(key, group)

            _, t_star = combine()

            def backward():
                return K._march_grad(tl, None, None, tc, staged, cfg, t_map=t_star, **kw)
        else:
            def on_slice():
                return K._launch_argmin(td, tm, tl, ts_local, cfg, **kw)

            local_min, local_idx, staged = on_slice()

            def combine():
                return K._first_winner(local_min, local_idx, ts_local, group)

            _, idx, table = combine()

            def backward():
                return K._march_grad(tl, idx, table, tc, staged, cfg, **kw)
        one = torch.zeros(1, dtype=torch.int64, device=td.device)
        return dict(ms=forward_ms, slice_ms=cuda_time_ms(on_slice, 20, windows=5), kernel_ms=kernel_device_ms(on_slice),
                    combine_ms=cuda_time_ms(combine, 10, windows=5), backward_ms=cuda_time_ms(backward, 20, windows=5),
                    collectives=collectives.calls, bytes_per_rank=collectives.nbytes,
                    collective_floor_ms=cuda_time_ms(lambda: dist.all_reduce(one, op=dist.ReduceOp.MIN, group=group),
                                                     10, windows=5))


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
    table, clamp = K._ts_for(dev, m_cfg)
    _, idx, _ = K._argmin(m_depth, m_mask, m_light, table, m_cfg, clamp=clamp)
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

    # The draft march's staging pass alone: bit-equal to its plain version,
    # bound by the bytes it must move (depth and mask in; both quads, both
    # resolutions' flags and the light out).
    check(staged_equal(K._stage(depth, mask, light, cfg, draft=True, flags=True), S.stage_inputs(depth, mask, light, cfg)),
          "timing", f"draft staging: batch {batch}")
    hs, ws, chunk = h // sc, w // sc, S.effective_col_chunk(cfg)
    nbytes = (8 * batch * h * w + 8 * batch * ((h + 1) * (w + 1) + (hs + 1) * (ws + 1))
              + batch * (hs // 8) * (ws // S.effective_col_chunk(m_cfg)) + batch * (h // 8) * (w // chunk) + 24 * batch)
    rows["draft_stage"] = timing_row(
        "stage", lambda: K._stage(depth, mask, light, cfg, draft=True, flags=True),
        lambda: S.stage_inputs(depth, mask, light, cfg), POOL_OPS_PER_PIXEL * batch * h * w, nbytes,
        dict(tier="draft", batch=batch, size=h, scale=sc), device_name="stage_kernel",
    )
    rows["draft_stage"]["max_abs_err"] = 0.0

    # The whole draft march, as render() runs it: the staging pass, K2, K3,
    # three device launches and nothing else. Its bound counts the pooling's
    # operations and the two marches' work, and the bytes the function itself
    # must move (depth and mask in, distances out).
    got = shadow_min_distance(depth, mask, light, cfg)
    err = check_equal(got, plain_min_distance(depth, mask, light, cfg), "timing", f"draft march: batch {batch}")
    del got
    activities = device_activities(lambda: shadow_min_distance(depth, mask, light, cfg), 3)
    check(len(activities) == 3 * 5, "timing", f"five draft marches ran {activities}")
    ops = POOL_OPS_PER_PIXEL * batch * h * w + rows["draft_argmin"]["ops"] + rows["draft_refine"]["ops"]
    rows["draft_march"] = timing_row(
        "draft_march", lambda: shadow_min_distance(depth, mask, light, cfg),
        lambda: plain_min_distance(depth, mask, light, cfg), ops, 4 * (3 * batch * h * w + 3 * batch),
        dict(tag, samples=[m_cfg.num_sample_points, n_off], device_activities=len(activities) / 5), device_name=None,
    )
    rows["draft_march"]["device_launches"] = len(activities) / 5
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

    # march_grad on the forward's staged quad, at the training batch and at 64
    # (the intercept is its fixed cost, the slope its cost a pixel), with a
    # seeded random cotangent; beside it the floor no launch goes under, a
    # one-element fill's device time.
    ts, clamp = K._ts_for(dev, cfg)
    for b in (3, batch):
        td, tm, tl = depth[:b].contiguous(), mask[:b].contiguous(), light[:b].contiguous()
        _, idx, staged = K._launch_argmin(td, tm, tl, ts, cfg, clamp=clamp)
        t_star = ts[idx.long()]
        cot = torch.randn((b, h, w), generator=torch.Generator().manual_seed(2)).to(dev)
        grad_fn = functools.partial(K.march_grad_cuda, td, tm, tl, idx, ts, cot, cfg, staged)
        got_dd, got_dl = grad_fn()
        want_dd, want_dl = S.march_vjp(td, tm, tl, t_star, cot, cfg)
        err = (got_dd - want_dd).abs().max().item()
        check(err <= GRAD_BARS["d_depth_rel_to_max"] * want_dd.abs().max().item(), "timing",
              f"train march_grad, batch {b}: d_depth {err}")
        dl_rel = ((got_dl - want_dl).abs() / want_dl.abs().amax(dim=1, keepdim=True).clamp_min(1e-30)).max().item()
        check(dl_rel <= GRAD_BARS["d_light_rel_to_image_max"], "timing", f"train march_grad, batch {b}: d_light {dl_rel}")
        activities = device_activities(grad_fn, 2)
        check(len(activities) == 2 * 5, "timing", f"five march_grad_cuda calls ran {activities}: one zero fill and the kernel each")
        # The work this run's data needs: pixels whose winner is on the face and
        # whose cotangent is nonzero differentiate, vetoed winners stop early.
        vetoed = S.sample_distance_at_batch(td, tm, tl, t_star, cfg, veto="onehot") >= 1e5
        n_grad = int((~vetoed & (cot != 0)).sum().item())
        n_vetoed = int(vetoed.sum().item())
        ops = (n_grad * GRAD_OPS["grad"] + n_vetoed * GRAD_OPS["vetoed"]
               + (b * h * w - n_grad - n_vetoed) * GRAD_OPS["other"])
        nbytes = 4 * (5 * b * h * w + 6 * b + s)  # depth, mask, idx, cotangent, d_depth; light, d_light; ts
        key = "train_grad" if b == 3 else f"train_grad_{b}"
        rows[key] = timing_row(
            "march_grad", grad_fn, lambda: S.march_vjp(td, tm, tl, t_star, cot, cfg), ops, nbytes,
            dict(tier="train", batch=b, size=h, veto=S.resolve_mask_gather(cfg), pixels_with_gradient=n_grad,
                 pixels_vetoed=n_vetoed, d_light_rel_to_image_max=dl_rel, device_activities=len(activities) / 5),
            device_name="march_grad_kernel",
        )
        rows[key]["max_abs_err"] = err
        del want_dd, staged
    rows["train_grad"]["launch_floor_ms"] = device_busy_ms(lambda: torch.zeros(1, device=dev), 20)
    emit("timing", ok=True, kernel="launch_floor", what="a one-element fill (torch.zeros(1))",
         device_ms=rows["train_grad"]["launch_floor_ms"])
    rows["forms"] = time_forms(depth, mask, light, dev)
    return rows


def time_forms(depth, mask, light, dev) -> dict:
    """Each kernel's time beside the main paths' in the forms RenderConfig admits beyond the
    presets': the 'hat' and 'hat_y' vetoes at the main paths' shapes, 240x240 (the draft march
    60x60), 8x4096 (the clamped taps); a time a launch of the wrapper (CUDA events) and of the
    kernel alone (torch.profiler), on the timing inputs cut to each size. Held against the plain
    versions in phase march; the outputs are checked here only to be finite or the sentinel."""
    import dataclasses

    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K

    batch = depth.shape[0]

    def cut(h, w):
        if w > depth.shape[2]:
            reps = w // depth.shape[2]
            return [torch.cat([torch.roll(x, i, 0)[:, 120:120 + h] for i in range(reps)], dim=2).contiguous()
                    for x in (depth, mask)] + [light]
        y0 = (depth.shape[1] - h) // 2
        return [x[:, y0:y0 + h, y0:y0 + w].contiguous() for x in (depth, mask)] + [light]

    def form_ms(fn, name):
        out = fn()
        first = out[0] if isinstance(out, tuple) else out
        check(bool(torch.isfinite(first).all()), "timing", f"{name}: not finite")
        return dict(ms=cuda_time_ms(fn, 10, warmup=2, windows=3),
                    kernel_ms=kernel_device_ms(fn, iters=10, name=name, readings=1))

    sizes = {"256x256": (256, 256, None), "240x240": (240, 240, 48), "8x4096": (8, 4096, 0)}
    forms = {k: {} for k in KERNELS[:4]}
    for size, (h, w, chunk) in sizes.items():
        d, m, lp = cut(h, w) if size != "256x256" else (depth, mask, light)
        for veto in (("hat", "hat_y") if size == "256x256" else ("auto",)):
            label = f"{veto} {size}" if veto != "auto" else size
            over = dict(img_height=h, img_width=w, shadow_mask_gather=veto)
            if chunk is not None:
                over["shadow_col_chunk"] = chunk
            strict = dataclasses.replace(C.apply_precision_tier(C.preset_single_image(), "fast" if veto != "auto"
                                                                else "strict").render, **over)
            forms["march"][f"{label} (64)"] = form_ms(lambda: K.ray_march_min_distance_cuda(d, m, lp, strict),
                                                      "march_kernel<0")
            draft = dataclasses.replace(C.apply_precision_tier(C.preset_single_image(), "draft").render, **over,
                                        shadow_step_pack=1)
            if size != "8x4096":
                draft = dataclasses.replace(draft, shadow_col_chunk=0 if size == "240x240" else 64)
                md, mm, ml, mc = S.scale_march_inputs(d, m, lp, draft)
                forms["march_argmin"][f"draft {label} (64, {md.shape[1]}^2, {mc.num_sample_points})"] = form_ms(
                    lambda: K.ray_march_min_distance_cuda(md, mm, ml, mc, return_argmin_t=True), "march_kernel<1")
                table, clamp = K._ts_for(dev, mc)
                _, idx, _ = K._argmin(md, mm, ml, table, mc, clamp=clamp)
                forms["refine"][f"draft {label} (64, 8)"] = form_ms(
                    lambda: K.refine_around_argmin_cuda(d, m, lp, idx, table, draft), "march_kernel<2")
            else:
                t_map = torch.full_like(d, 0.5)
                forms["refine"][f"{label} (64, 8, around a t_map)"] = form_ms(
                    lambda: K.refine_min_distance_cuda(d, m, lp, t_map, dataclasses.replace(strict, shadow_refine_halfwidth=4)),
                    "march_kernel<2")
            tcfg = dataclasses.replace(C.preset_target_lighting_train().render, **over)
            td, tm, tl = (x[:3].contiguous() for x in (d, m, lp))
            ts, clamp = K._ts_for(dev, tcfg)
            if size == "8x4096":
                forms["march_argmin"][f"training {label} (3, 160)"] = form_ms(
                    lambda: K.ray_march_min_distance_cuda(td, tm, tl, tcfg, return_argmin_t=True), "march_kernel<1")
            _, idx, staged = K._launch_argmin(td, tm, tl, ts, tcfg, clamp=clamp)
            cot = torch.randn(td.shape, generator=torch.Generator().manual_seed(4)).to(dev)
            forms["march_grad"][f"after a {label} forward (3)"] = form_ms(
                lambda: K.march_grad_cuda(td, tm, tl, idx, ts, cot, tcfg, staged), "march_grad_kernel")
            del staged
    emit("timing", ok=True, kernel="forms", forms=forms)
    return forms


def compare_timing(goldens, dev, batch=64) -> dict:
    """The march kernels at the main paths' shapes, through the API this tree and
    its parent share: K1 strict and fast, K2 at draft, at the training shape
    and on one rank's half of training's samples (K5's forward), the whole
    draft march with its staging's, K2's and K3's kernel times in it, the
    draft march of one shard of two as sample parallelism runs it (pooling,
    K2 on the slice, K3 around a t_map) and with the refine off (pooling, K1,
    upsampling), K3 alone around a t_map at 1, 8 and 16 offsets and fully
    culled, K3 fully culled in the draft march, march_grad (K4's backward)
    through autograd at batch 3 and 64 and through its wrapper at batch 3;
    and a one-element fill, the floor no launch goes under. Each row: the
    call's ms (CUDA events), the kernel alone and every kernel the call
    launches (torch.profiler). The march_grad wrapper's host time is also
    read in turns with a one-element fill's (`paired_host_ms`) and, where the
    tree has the unchecked launch the autograd backward runs, with that."""
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
    rows["K2_draft"] = row(lambda: K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True),
                           name="march_kernel<1")
    rows["draft_march"] = row(lambda: shadow_min_distance(depth, mask, light, cfg), name="march_kernel<2",
                              k2_device_ms="march_kernel<1", stage_device_ms="stage_kernel")
    # K3 alone around the upsampled t*, at 1, 8 and 16 offsets and with every
    # cull unit empty (it scans the mask): its time per sample and per pixel
    # apart; then fully culled in the draft march, where it reads flags.
    _, t_star = K.ray_march_min_distance_cuda(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    t_map = S.upsample_tstar_nn(t_star, cfg).contiguous()
    for n in (1, 8, 16):
        offsets = ((np.arange(n) - n // 2) * cfg.t_step).astype(np.float32)
        rows[f"K3_{n}_offsets"] = row(lambda: K.refine_min_distance_cuda(depth, mask, light, t_map, cfg, offsets),
                                      name="march_kernel<2")
    empty = torch.zeros_like(mask)
    rows["K3_all_culled_t_map"] = row(lambda: K.refine_min_distance_cuda(depth, empty, light, t_map, cfg),
                                      name="march_kernel<2")
    rows["K3_all_culled"] = row(lambda: shadow_min_distance(depth, empty, light, cfg), name="march_kernel<2")
    # The draft march of rank 0 of two (Relighter(parallel='samples')), on one
    # process (no group, so no combine), and the draft march without refine.
    ts0 = torch.as_tensor(S.sharded_sample_ts(m_cfg, 2).reshape(2, -1)[0], device=dev)

    def one_shard(d, m, lp, return_argmin_t=False):
        return K.sharded_march(d, m, lp, m_cfg, ts0, None, return_argmin_t)

    one_shard.refine_fn = functools.partial(K.refine_min_distance_cuda, cfg=cfg)
    rows["draft_march_one_shard"] = row(lambda: shadow_min_distance(depth, mask, light, cfg, march_fn=one_shard),
                                        name="march_kernel<2", k2_device_ms="march_kernel<1")
    up_cfg = dataclasses.replace(cfg, shadow_refine_halfwidth=0, shadow_lowres_t_stride=1)
    rows["draft_march_upscale"] = row(lambda: shadow_min_distance(depth, mask, light, up_cfg), name="march_kernel<0")
    tcfg = C.preset_target_lighting_train().render
    td, tm, tl = depth[:3].contiguous(), mask[:3].contiguous(), light[:3].contiguous()
    rows["K2_train"] = row(lambda: K.ray_march_min_distance_cuda(td, tm, tl, tcfg, return_argmin_t=True),
                           name="march_kernel<1")
    ts_half = torch.as_tensor(S.sharded_sample_ts(tcfg, 2).reshape(2, -1)[0], device=dev)
    rows["K2_train_half_samples"] = row(
        lambda: K.ray_march_min_distance_cuda(td, tm, tl, tcfg, ts_half, return_argmin_t=True), name="march_kernel<1")
    # march_grad through its wrapper, as a caller outside autograd calls it:
    # the host's checks and the fill around the kernel. A tree whose kernel
    # reads the forward's staged quad takes it as the last argument.
    ts, kw = grid_table(K, dev, tcfg)
    _, idx3, *staged3 = K._launch_argmin(td, tm, tl, ts, tcfg, **kw)
    cot3 = torch.randn(td.shape, device=dev, generator=torch.Generator(dev).manual_seed(3))
    def wrapper():
        return K.march_grad_cuda(td, tm, tl, idx3, ts, cot3, tcfg, *staged3)

    rows["K4_wrapper_b3"] = row(wrapper, name="march_grad_kernel")
    rows["K4_wrapper_b3"]["vs_fill"] = paired_host_ms(wrapper, lambda: torch.zeros(1, device=dev))
    if hasattr(K, "_march_grad"):
        rows["K4_wrapper_b3"]["vs_unchecked"] = paired_host_ms(
            wrapper, lambda: K._march_grad(tl, idx3, ts, cot3, staged3[0], tcfg, **kw))
    for b in (3, batch):
        d, lp = depth[:b].clone().requires_grad_(), light[:b].clone().requires_grad_()
        out = K.ray_march_min_distance_cuda(d, mask[:b].contiguous(), lp, tcfg)
        cot = torch.randn(out.shape, device=dev, generator=torch.Generator(dev).manual_seed(b))
        rows[f"K4_backward_b{b}"] = row(lambda: torch.autograd.grad(out, (d, lp), cot, retain_graph=True),
                                        name="march_grad_kernel")
        del out
    rows["launch_floor"] = row(lambda: torch.zeros(1, device=dev), name="Fill")

    # End to end, where the host's load moves the numbers between calls: the
    # forward at batch 64 at each tier and the training step at batch 3 (median
    # of five windows, as phases e2e and train time them).
    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet

    images, masks, lights = serving_inputs(goldens, dev, 0, batch)
    for tier in ("strict", "fast", "draft"):
        cfg = C.apply_precision_tier(C.preset_single_image(), tier)
        rl = Relighter(cfg, RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict(), device=dev)
        ms = cuda_time_ms(lambda: rl.forward(images, masks, lights), 8, windows=5)
        rows[f"forward_{tier}"] = dict(ms=ms, img_per_s=batch / (ms / 1e3))
        del rl
    tcfg = C.preset_target_lighting_train()
    state = T.init_state(tcfg, dev, torch.Generator().manual_seed(0))
    step_batch = T.decode_batch(train_batches(0, tcfg.train.batch_size, 1)[0], dev)
    skips = tcfg.model.skip_gates(0)
    ms = cuda_time_ms(lambda: T.train_step(state, step_batch, tcfg, skips), 4, warmup=2, windows=5)
    rows["train_step"] = dict(ms=ms, device_busy_ms=device_busy_ms(lambda: T.train_step(state, step_batch, tcfg, skips), 4))
    return rows


def parallel_timing_rank(dev, out_dir: str, root: str, seed: int) -> None:
    """One of two ranks timing ROOT's sample-sharded paths for --compare-parent, through the API
    this tree and its parent share: K5 at the training shape (time_k5, on the parallel phase's
    inputs), the 1x2 grid train step (batch 3) with the combine's share of it, and the
    sample-parallel draft forward (batch 64). Writes <out_dir>/timing<rank>.json."""
    import torch

    from geomconsistentfr_torch import config as C
    from geomconsistentfr_torch import train as T
    from geomconsistentfr_torch.infer import Relighter
    from geomconsistentfr_torch.models.relightnet import RelightNet
    from geomconsistentfr_torch.ops import shadows as S
    from geomconsistentfr_torch.ops import shadows_cuda as K
    from geomconsistentfr_torch.parallel import mesh as M

    check(Path(K.__file__).resolve().is_relative_to(root), "compare", f"a rank imported {K.__file__}, not {root}'s")
    rank = torch.distributed.get_rank()
    goldens = load_goldens()
    world = M.make_mesh(dev)
    tcfg = C.preset_target_lighting_train()
    td, tm, tl, tc = (x[:3].contiguous() for x in k5_inputs(goldens, dev, seed))
    ts_local = torch.as_tensor(S.sharded_sample_ts(tcfg.render, world.size).reshape(world.size, -1)[rank], device=dev)
    res = dict(rank=rank, k5=time_k5(K, td, tm, tl, tc, tcfg.render, ts_local, world.world_group))

    grid = M.make_mesh_grid(1, world.size, dev)
    step = T.make_grid_parallel_step(tcfg, grid)
    state = T.init_state(tcfg, dev, torch.Generator().manual_seed(seed))
    local = T.decode_batch(train_batches(seed, 3, 1)[0], dev)
    skips = tcfg.model.skip_gates(0)
    step_ms = cuda_time_ms(lambda: step(state, local, use_skips=skips), 2, warmup=1, windows=3)
    res["grid"] = dict(step_ms=step_ms, combine_share=res["k5"]["combine_ms"] / step_ms)
    del state
    torch.cuda.empty_cache()

    images, masks, lights = serving_inputs(goldens, dev, seed)
    cfg = C.apply_precision_tier(C.preset_single_image(), "draft")
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(seed)).state_dict()
    rl = Relighter(cfg, state, mesh=world, parallel="samples")
    res["samples_draft_forward_ms"] = cuda_time_ms(lambda: rl.forward(images, masks, lights), 4, windows=3)
    with open(Path(out_dir) / f"timing{rank}.json", "w") as f:
        json.dump(res, f)


def parallel_timing(root: Path, seed: int = 0) -> list:
    """parallel_timing_rank on PARALLEL_RANKS ranks of ROOT's package; each rank's record."""
    import shutil
    import tempfile

    from geomconsistentfr_torch.parallel import distributed

    tmp = tempfile.mkdtemp(prefix="gcfr_ptiming_")
    try:
        try:
            distributed.spawn(parallel_timing_rank, PARALLEL_RANKS, "cuda", str(Path(tmp) / "rdzv"),
                              args=(tmp, str(root), seed))
        except Exception as e:  # a rank raised: its traceback is in the message
            raise PhaseError(f"compare: a timing rank failed: {e}") from e
        return [json.loads((Path(tmp) / f"timing{r}.json").read_text()) for r in range(PARALLEL_RANKS)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def timing_child(root: Path) -> int:
    """--timing-of ROOT, compare_parent's child: build ROOT's kernels and print one compare_run line
    (the kernels' timing, then the sample-sharded paths' on two ranks)."""
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        emit("compare_run", ok=False, error="torch.cuda.is_available() is false")
        return 1
    from geomconsistentfr_torch.ops import shadows_cuda as K

    check(Path(K.__file__).resolve().is_relative_to(root), "compare", f"imported {K.__file__}, not {root}'s package")
    lib, log = build_library(K.LIBRARY)
    timing = compare_timing(load_goldens(), torch.device("cuda:0"))
    torch.cuda.empty_cache()
    emit("compare_run", ok=True, root=str(root), ptxas=ptxas_registers(log), sass=sass_counts(lib, cuobjdump_path()),
         timing=timing, parallel=parallel_timing(root), nvidia_smi=nvidia_smi_line())
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
    summary = {key: {f"{tree}_{i}": {k: run["timing"][key].get(k) for k in ("ms", "kernel_device_ms")}
                     for i, (tree, run) in enumerate(runs)} for key in runs[0][1]["timing"]}
    # The sample-sharded paths, two ranks on the card: each rank's K5 numbers, grid step and draft forward.
    parallel = {f"{tree}_{i}": [dict(**{k: r["k5"][k] for k in ("ms", "combine_ms", "collectives", "bytes_per_rank",
                                                                 "collective_floor_ms", "slice_ms", "kernel_ms",
                                                                 "backward_ms")},
                                     grid_step_ms=r["grid"]["step_ms"], combine_share=r["grid"]["combine_share"],
                                     samples_draft_forward_ms=r["samples_draft_forward_ms"]) for r in run["parallel"]]
                for i, (tree, run) in enumerate(runs)}
    emit("compare", ok=True, order=[t for t, _ in runs], rows=summary, parallel=parallel)
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
        lib, log = build_library(K.LIBRARY)
        seconds = time.perf_counter() - t0
        regs = ptxas_registers(log)
        check(sorted(regs) == sorted(COMPILED), "build", f"ptxas reported {sorted(regs)}, expected {sorted(COMPILED)}")
        sass = sass_counts(lib, cuobjdump_path())
        check(sorted(sass) == sorted(COMPILED), "build", f"cuobjdump showed {sorted(sass)}, expected {sorted(COMPILED)}")
        emit("build", ok=True, seconds=seconds, kernels=list(COMPILED), ptxas=regs, sass=sass,
             loop_conversions={k: sum(lp[op] for lp in v["loops"] for op in ("F2I", "I2F", "FRND"))
                               for k, v in sass.items() if not k.endswith(".clamp")})
        phase_epilogue(dev)
        phase_conv3x3(dev)
        phase_pack(dev)

        goldens = load_goldens()
        march_err, march_ran = phase_march(goldens, dev)
        phase_golden(goldens, dev)
        launches, e2e, e2e_err = phase_e2e(goldens, dev)
        phase_cudnn(goldens, dev)
        surface_launches = phase_surface(goldens, e2e)
        timing = phase_timing(goldens, dev)
        train_launches, train = phase_train(dev)
        parallel_launches, k5 = phase_parallel(dev)
    except PhaseError as e:
        emit("failed", ok=False, error=str(e))
        emit("profiler", ok=True, **PROFILE_EDGES)
        return 1

    # max_abs_err: the worst kernel-vs-plain |d| of every comparison of that
    # kernel: the march phase (batch 8), the main path's own batches and the
    # timing inputs (batch 64, and batch 3 for training); for march_grad, of
    # d_depth. `ms` (the wrapper, K1-K3's input staging included), kernel_ms
    # (the kernel alone) and the bound are at the main paths' shapes: K1 at the
    # strict tier, K2 and K3 at the draft tier (K2 at the training shape in
    # the train_* keys), march_grad at training, K5 at the training shape on
    # two ranks. `launches` sums the main paths' runs: one forward per tier,
    # the user-facing surface's processes (cli, bench, serve, eval), the six
    # training steps, and the parallel phase's forwards and steps
    # over both ranks. unpack_key is bit-equal to its plain version wherever
    # it is held (max_abs_err 0), at K5's shape.
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
            launches=launches[name] + surface_launches[name] + train_launches[name] + parallel_launches[name],
            max_abs_err=max_err,
            ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"], library_ms=None,
            kernel_ms=t["kernel_device_ms"], vetoes=march_ran[name]["vetoes"], forms=march_ran[name]["forms"],
            forms_ms=timing["forms"][name],
        )
        if name == "march_argmin":
            k2, st = timing["train_argmin"], timing["draft_stage"]
            row.update(train_ms=k2["ms"], train_kernel_ms=k2["kernel_device_ms"], train_plain_ms=k2["plain_ms"],
                       train_bound_ms=k2["bound_ms"],
                       # the staging pass that feeds the draft march (K2 and K3), and every march
                       stage_launches=launches["stage"] + surface_launches["stage"] + train_launches["stage"]
                       + parallel_launches["stage"],
                       draft_stage_ms=st["ms"], draft_stage_kernel_ms=st["kernel_device_ms"],
                       draft_stage_plain_ms=st["plain_ms"], draft_stage_bound_ms=st["bound_ms"],
                       draft_stage_bound_by=st["bound_by"],
                       draft_march_device_ms=timing["draft_march"]["wrapper_device_ms"],
                       draft_march_device_launches=timing["draft_march"]["device_launches"])
        if name == "march_grad":
            g64 = timing["train_grad_64"]
            row.update(b64_ms=g64["ms"], b64_kernel_ms=g64["kernel_device_ms"], b64_plain_ms=g64["plain_ms"],
                       b64_bound_ms=g64["bound_ms"], launch_floor_ms=t["launch_floor_ms"])
        kernels.append(row)
    kernels.append(dict(
        name="march_sp", route="cuda", source="geomconsistentfr_torch/csrc/march.cu",
        replaces="geomconsistentfr_tpu/ops/shadows_pallas.py:815", launches=parallel_launches["march_sp"],
        max_abs_err=k5["max_abs_err"], ms=k5["ms"], plain_ms=k5["plain_ms"], bound_ms=k5["bound_ms"],
        bound_by=k5["bound_by"], library_ms=None, kernel_ms=k5["kernel_ms"], slice_ms=k5["slice_ms"],
        combine_ms=k5["combine_ms"], backward_ms=k5["backward_ms"], collectives=k5["collectives"],
        bytes_per_rank=k5["bytes_per_rank"], collective_floor_ms=k5["collective_floor_ms"], ranks=PARALLEL_RANKS,
    ))
    # The unpack of the MIN-reduced keys replaces the reference's pmin combine
    # (the two pmins of distances and t), as the staging replaces XLA's pooling.
    unpack = k5["unpack"]
    kernels.append(dict(
        name="unpack_key", route="cuda", source="geomconsistentfr_torch/csrc/march.cu",
        replaces="geomconsistentfr_tpu/ops/shadows_pallas.py:851",
        launches=surface_launches["unpack_key"] + parallel_launches["unpack_key"], max_abs_err=0.0,
        ms=unpack["ms"], plain_ms=unpack["plain_ms"], bound_ms=unpack["bound_ms"], bound_by=unpack["bound_by"],
        library_ms=None, kernel_ms=unpack["kernel_ms"],
    ))
    print(json.dumps({"kernels": kernels}), flush=True)
    emit("profiler", ok=True, **PROFILE_EDGES)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
