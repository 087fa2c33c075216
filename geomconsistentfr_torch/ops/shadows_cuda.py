"""Build, bind and launch the CUDA shadow-march kernels (csrc/march.cu).

The wrappers, one per kernel:
  * `ray_march_min_distance_cuda` launches K1 ('march'), or K2
    ('march_argmin') with `return_argmin_t`;
  * `refine_min_distance_cuda` launches K3 ('refine') around a full-
    resolution t_map, `refine_around_argmin_cuda` K3 around K2's winning
    indices (no t_map in memory);
  * `draft_march` is the draft tier's march with the refine on: the pooling,
    K2 at low resolution, then K3 around K2's winners;
  * `march_grad_cuda` launches the backward of K4 ('march_grad').
For a CUDA tensor a wrapper launches its kernel (or raises); for a CPU tensor
it runs the plain version of ops/shadows.py. There is no other fallback.
K1-K3 read depth and mask interleaved and padded, (B, H + 1, W + 1, 2),
which the launch stages first (csrc/march.cu stage_kernel, in scratch the
wrapper allocates), and cull inside the kernel; the
sample offsets t they march must lie in [0, 1] (checked on the host; see
csrc/march.cu), H and W at most 2048.

`RayMarchMinDistance` is the differentiable march K4 (the JAX package's
`ray_march_min_distance_pallas_vjp`): its forward is K2, its backward
march_grad at K2's winning samples; on CPU tensors the plain argmin march and
the plain `shadows.march_vjp`. `ray_march_min_distance_cuda` goes through it
whenever depth or the light point needs a gradient.

The sample-sharded paths, where each rank of a process group marches a
contiguous slice of the t grid (`shadows.sharded_sample_ts`):
  * `sharded_march` serves (`Relighter(parallel='samples'|'grid')`): K1 on
    the slice, or K2 with `return_argmin_t`, then the MIN combine over the
    group and, with K2, the first-winner combine of the indices;
  * `RayMarchMinDistanceSP` is K5, the JAX package's
    `ray_march_min_distance_pallas_vjp_sp` (the grid train step): K2 on the
    slice (counted as 'march_sp'), both combines, then march_grad at the
    global winner, replicated on every rank with no collective of its own.
The combines are collectives of torch.distributed outside the kernels, as
`pmin` is outside the Pallas kernel.

The kernels are compiled by `nvcc` for sm_90a at first use into
`<repo>/build/kernels/` (git-ignored), keyed by a hash of the source and the
flags, and loaded with ctypes; the source has a plain C interface, so a build
takes seconds. `LAUNCHES` counts each kernel's launches, by name.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops import shadows
from geomconsistentfr_torch.parallel.mesh import all_gather_cat, all_min, group_rank

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "march.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches of each kernel since its count was last set to 0.
LAUNCHES = {"march": 0, "march_argmin": 0, "refine": 0, "march_grad": 0, "march_sp": 0}

# The kernel's `form` argument (csrc/march.cu, enum Form).
_FORMS = {"march": 0, "march_argmin": 1, "refine": 2}

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_c_int] + [_c_void_p] * 10 + [_c_int] * 10 + [_c_float] * 7 + [_c_void_p]
_GRAD_ARGTYPES = [_c_void_p] * 9 + [_c_int] * 6 + [_c_void_p]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA march kernel cannot be built")


def build() -> tuple[Path, str]:
    """Compile march.cu unless a build of this source exists; (library, ptxas log)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"march_{key}.so"
    log = BUILD_DIR / f"march_{key}.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed to build {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file
    log.write_text(proc.stdout + proc.stderr)
    return lib, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    lib.gcfr_march_launch.argtypes = _ARGTYPES
    lib.gcfr_march_launch.restype = _c_int
    lib.gcfr_march_grad_launch.argtypes = _GRAD_ARGTYPES
    lib.gcfr_march_grad_launch.restype = _c_int
    return lib


def _check_t_range(lo: float, hi: float, what: str) -> None:
    """The kernels march t in [0, 1], between the pixel and the border (csrc/march.cu)."""
    if not (0.0 <= lo and hi <= 1.0):
        raise ValueError(f"{what} must lie in [0, 1], got [{lo}, {hi}]")


@functools.lru_cache(maxsize=16)
def _ts_on(device: torch.device, t_start: float, t_stop: float, t_step: float, n: int) -> torch.Tensor:
    cfg = RenderConfig(t_start=t_start, t_stop=t_stop, t_step=t_step, num_sample_points=n)
    ts = shadows.sample_ts(cfg).astype(np.float32)
    _check_t_range(float(ts.min()), float(ts.max()), "the sample offsets")
    return torch.as_tensor(ts, device=device)


@functools.lru_cache(maxsize=16)
def _offsets_on(device: torch.device, halfwidth: int, t_step: float) -> torch.Tensor:
    cfg = RenderConfig(t_step=t_step, shadow_refine_halfwidth=halfwidth)
    return torch.as_tensor(shadows.refine_offsets(cfg), device=device)


def _check(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def needs_grad(depth: torch.Tensor, light_point: torch.Tensor) -> bool:
    """True when autograd records and depth or the light point asks for a gradient."""
    return torch.is_grad_enabled() and (depth.requires_grad or light_point.requires_grad)


def _check_inputs(depth, mask, light_point, cfg: RenderConfig, what: str) -> None:
    """Device, the config's shape, float32, contiguous."""
    if depth.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got {depth.device}")
    b, h, w = depth.shape
    if (h, w) != (cfg.img_height, cfg.img_width):
        raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
    if h % 8 or w % 32 or h > 2048 or w > 2048:
        raise ValueError(f"the {what} kernel needs H % 8 == 0, W % 32 == 0 and both <= 2048; got {h}x{w}")
    _check("depth", depth, (b, h, w), depth.device)
    _check("mask", mask, (b, h, w), depth.device)
    _check("light_point", light_point, (b, 3), depth.device)


def _cull_flags(mask, cfg: RenderConfig):
    """march_grad's cull: (uint8 live flags or None, cull blocks per 8-row group or 0, block width)."""
    chunk = shadows.effective_col_chunk(cfg)
    if not cfg.shadow_mask_cull:
        return None, 0, chunk
    live = shadows.cull_live_blocks(mask, chunk).to(torch.uint8).contiguous()
    return live, mask.shape[2] // chunk, chunk


def _ptr(x) -> int:
    return 0 if x is None else x.data_ptr()


def _launch(kernel: str, depth, mask, light_point, ts, cfg: RenderConfig, t_map=None, centre=None, idx=None,
            count_as=None):
    """Launch one form of the march kernel on the current stream; (B, H, W) distances.

    K3's centre is `t_map`, or `centre` = (K2's int32 index (B, H/s, W/s),
    the float32 table it indexes). The launch counts under `count_as`, by
    default the form's own name.
    """
    b, h, w = depth.shape
    dev = depth.device
    bilinear = shadows.resolve_mask_gather(cfg) == "bilinear"
    chunk = shadows.effective_col_chunk(cfg)
    if cfg.shadow_mask_cull and w % chunk:
        raise ValueError(f"cull blocks need W % C == 0; got W={w}, C={chunk}")
    bounds = shadows.gate_bounds(cfg)
    gate_on = bounds is not None
    lo_x, hi_x, lo_y, hi_y = bounds if gate_on else (0.0, 0.0, 0.0, 0.0)
    t_lo, t_hi = shadows.refine_t_range(cfg) if kernel == "refine" else (0.0, 0.0)
    centre_idx, centre_ts = centre if centre is not None else (None, None)

    staged = torch.empty((b, h + 1, w + 1, 2), dtype=torch.float32, device=dev)  # the kernel's padded input
    out = torch.empty_like(depth)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gcfr_march_launch(
            _FORMS[kernel], depth.data_ptr(), mask.data_ptr(), staged.data_ptr(), light_point.data_ptr(),
            ts.data_ptr(), _ptr(t_map),
            _ptr(centre_idx), _ptr(centre_ts), out.data_ptr(), _ptr(idx),
            b, h, w, ts.numel(), int(bilinear), int(cfg.shadow_mask_cull), chunk, int(gate_on),
            cfg.shadow_resolution_scale, 0 if centre_ts is None else centre_ts.numel(),
            lo_x, hi_x, lo_y, hi_y, cfg.shadow_bias, t_lo, t_hi, stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[count_as or kernel] += 1
    return out


def ray_march_min_distance_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    cfg: RenderConfig,
    ts=None,
    return_argmin_t: bool = False,
):
    """(B, H, W) depth and mask, (B, 3) light points -> (B, H, W) min distances.

    Same function as shadows.ray_march_min_distance_batch: kernel K1, or K2
    with `return_argmin_t`, which returns (min distances, t*). `ts` overrides
    the sample offsets (1-D float32, any length); t* then takes its values.
    When depth or the light point needs a gradient, the march over the full
    grid goes through `RayMarchMinDistance` (K2 forward, march_grad backward),
    and a march over given offsets through `RayMarchMinDistanceSP` with no
    group (K5 on one shard).
    """
    if needs_grad(depth, light_point):
        if return_argmin_t:
            raise NotImplementedError("the differentiable march returns distances only")
        if ts is not None:
            return RayMarchMinDistanceSP.apply(depth, mask, light_point, cfg, ts, None)
        return RayMarchMinDistance.apply(depth, mask, light_point, cfg)
    if depth.device.type == "cpu":
        return shadows.ray_march_min_distance_batch(depth, mask, light_point, cfg, ts, return_argmin_t)
    _check_inputs(depth, mask, light_point, cfg, "march")
    ts = _ts_for(depth.device, cfg, ts)
    if not return_argmin_t:
        return _launch("march", depth, mask, light_point, ts, cfg)
    out, idx = _launch_argmin(depth, mask, light_point, ts, cfg)
    # The index addresses the same float32 table the kernel read (shadows_pallas.py:1152-1154).
    return out, ts[idx.long()]


def _ts_for(dev: torch.device, cfg: RenderConfig, ts=None) -> torch.Tensor:
    """The float32 t table on `dev`: the config's grid, or the given offsets (checked to lie in [0, 1])."""
    if ts is None:
        return _ts_on(dev, cfg.t_start, cfg.t_stop, cfg.t_step, cfg.num_sample_points)
    ts = torch.as_tensor(ts, dtype=torch.float32).reshape(-1)
    if ts.numel():
        lo, hi = ts.aminmax()  # on a CUDA tensor this waits for the card
        _check_t_range(lo.item(), hi.item(), "the sample offsets")
    return ts.to(dev).contiguous()


def _launch_argmin(depth, mask, light_point, ts, cfg: RenderConfig, count_as=None):
    """K2: (min distances, int32 index of each pixel's first winning sample in ts)."""
    idx = torch.empty(depth.shape, dtype=torch.int32, device=depth.device)
    return _launch("march_argmin", depth, mask, light_point, ts, cfg, idx=idx, count_as=count_as), idx


def _argmin_march(depth, mask, light_point, ts, cfg: RenderConfig, count_as=None):
    """(min distances, int32 first-winner index into ts): K2 on CUDA tensors, its plain version on the CPU."""
    if depth.device.type == "cpu":
        return shadows.ray_march_argmin_batch(depth, mask, light_point, cfg, ts)
    _check_inputs(depth, mask, light_point, cfg, "march")
    return _launch_argmin(depth, mask, light_point, ts, cfg, count_as)


def march_grad_cuda(depth, mask, light_point, idx, ts, grad, cfg: RenderConfig):
    """(d_depth (B, H, W), d_light (B, 3)): K4's backward at K2's winners.

    Same function as shadows.march_vjp at t* = ts[idx]: idx is K2's int32
    winning index (B, H, W) into the float32 table ts it read, grad the
    (B, H, W) cotangent of the march's output.
    """
    if depth.device.type == "cpu":
        return shadows.march_vjp(depth, mask, light_point, ts[idx.long()], grad, cfg)
    _check_inputs(depth, mask, light_point, cfg, "march_grad")
    b, h, w = depth.shape
    dev = depth.device
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, h, w) or not idx.is_contiguous() or idx.device != dev:
        raise ValueError("idx must be a contiguous int32 (B, H, W) tensor on the depth's device")
    _check("ts", ts, (ts.numel(),), dev)
    grad = grad.contiguous()
    _check("grad", grad, (b, h, w), dev)
    live, live_cols, chunk = _cull_flags(mask, cfg)
    d_depth = torch.zeros_like(depth)
    d_light = torch.zeros((b, 3), dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gcfr_march_grad_launch(
            depth.data_ptr(), mask.data_ptr(), light_point.data_ptr(), ts.data_ptr(), idx.data_ptr(),
            _ptr(live), grad.data_ptr(), d_depth.data_ptr(), d_light.data_ptr(),
            b, h, w, int(shadows.resolve_mask_gather(cfg) == "bilinear"), live_cols, chunk, stream,
        )
    if err != 0:
        raise RuntimeError(f"march_grad kernel launch failed: CUDA error {err}")
    LAUNCHES["march_grad"] += 1
    return d_depth, d_light


class RayMarchMinDistance(torch.autograd.Function):
    """The differentiable full-grid march (B, H, W) -> (B, H, W), kernel K4.

    Forward: the argmin march, which records each pixel's winning sample
    (K2 on the card). Backward: the VJP at that sample (march_grad on the
    card), into depth and the light point; the mask gets none. On CPU
    tensors the same structure runs the plain argmin march and
    shadows.march_vjp. The draft tier has no gradient: its march is
    serving-only, as in the JAX package (render.py:189-193).
    """

    @staticmethod
    def forward(ctx, depth, mask, light_point, cfg: RenderConfig):
        if cfg.shadow_resolution_scale != 1:
            raise NotImplementedError("the draft tier's march has no gradient: it serves only")
        ctx.cfg, ctx.ts = cfg, _ts_for(depth.device, cfg)
        out, idx = _argmin_march(depth, mask, light_point, ctx.ts, cfg)
        ctx.save_for_backward(depth, mask, light_point, idx)
        return out

    @staticmethod
    def backward(ctx, grad):
        depth, mask, light_point, idx = ctx.saved_tensors
        d_depth, d_light = march_grad_cuda(depth, mask, light_point, idx, ctx.ts, grad, ctx.cfg)
        return d_depth, None, d_light, None


_NO_WINNER = torch.iinfo(torch.int32).max


def _first_winner(local_min, local_idx, ts_local, group):
    """Combine the shards' marches: (global min, global first-winner index, the padded global t table).

    A shard whose minimum is not the global one is strictly greater (the
    MIN is one of the shards' values, so the equality test is exact). Among
    the shards that reach it, the smallest index into the concatenated
    slices wins: the slices are contiguous and increasing, so that is the
    smallest t, the full grid's first winner (shadows_pallas.py:851-855).
    """
    if group is None:
        return local_min, local_idx, ts_local
    global_min = all_min(local_min, group)
    offset = group_rank(group) * ts_local.numel()
    candidate = torch.where(local_min == global_min, local_idx + offset, _NO_WINNER)
    return global_min, all_min(candidate, group), all_gather_cat(ts_local, group)


def sharded_march(depth, mask, light_point, cfg: RenderConfig, ts_local, group, return_argmin_t: bool = False):
    """The march over the group's t grid, this rank marching `ts_local`; the same result on every rank.

    Serving form (infer.py:280-307 of the JAX package): K1 on the slice then
    the MIN over the group, or with `return_argmin_t` K2 on the slice, the
    MIN and the first-winner combine -> (min distances, t*). The slices must
    be the group ranks' contiguous rows of `shadows.sharded_sample_ts`, in
    group-rank order. A march that needs a gradient is K5.
    """
    if needs_grad(depth, light_point):
        if return_argmin_t:
            raise NotImplementedError("the differentiable march returns distances only")
        return RayMarchMinDistanceSP.apply(depth, mask, light_point, cfg, ts_local, group)
    ts_local = _ts_for(depth.device, cfg, ts_local)
    if not return_argmin_t:
        return all_min(ray_march_min_distance_cuda(depth, mask, light_point, cfg, ts_local), group)
    local_min, local_idx = _argmin_march(depth, mask, light_point, ts_local, cfg)
    out, idx, table = _first_winner(local_min, local_idx, ts_local, group)
    return out, table[idx.long()]


class RayMarchMinDistanceSP(torch.autograd.Function):
    """The sample-sharded differentiable march, kernel K5 (shadows_pallas.py:814-871).

    apply(depth, mask, light_point, cfg, ts_local, group) -> (B, H, W), the
    same on every rank of `group` (None: one shard, ts_local is the grid).
    Forward: K2 on this rank's slice (counted as 'march_sp'), the MIN combine
    and the first-winner combine of the indices. Backward: march_grad at the
    global winner, from the same residuals on every rank, so with no
    collective; its atomics may order the sums differently on two ranks,
    which is why the train step averages gradients over every rank. On CPU
    tensors: the plain argmin march on the slice and shadows.march_vjp.
    """

    @staticmethod
    def forward(ctx, depth, mask, light_point, cfg: RenderConfig, ts_local, group):
        if cfg.shadow_resolution_scale != 1:
            raise NotImplementedError("the draft tier's march has no gradient: it serves only")
        ctx.cfg = cfg
        ts_local = _ts_for(depth.device, cfg, ts_local)
        local_min, local_idx = _argmin_march(depth, mask, light_point, ts_local, cfg, count_as="march_sp")
        out, idx, ctx.table = _first_winner(local_min, local_idx, ts_local, group)
        ctx.save_for_backward(depth, mask, light_point, idx)
        return out

    @staticmethod
    def backward(ctx, grad):
        depth, mask, light_point, idx = ctx.saved_tensors
        d_depth, d_light = march_grad_cuda(depth, mask, light_point, idx, ctx.table, grad, ctx.cfg)
        return d_depth, None, d_light, None, None, None


def refine_min_distance_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    t_map: torch.Tensor,
    cfg: RenderConfig,
    offsets=None,
) -> torch.Tensor:
    """(B, H, W) depth, mask and t_map, (B, 3) light points -> (B, H, W): kernel K3.

    Same function as shadows.refine_min_distance_batch. `offsets` overrides
    refine_offsets(cfg) (1-D float32, any length). The draft tier serves
    only: a call that needs a gradient raises.
    """
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's refine has no gradient: it serves only")
    if depth.device.type == "cpu":
        return shadows.refine_min_distance_batch(depth, mask, light_point, t_map, cfg, offsets)
    _check_inputs(depth, mask, light_point, cfg, "refine")
    _check("t_map", t_map, tuple(depth.shape), depth.device)
    return _launch("refine", depth, mask, light_point, _refine_offsets(depth.device, cfg, offsets), cfg, t_map=t_map)


def _refine_offsets(dev: torch.device, cfg: RenderConfig, offsets=None) -> torch.Tensor:
    """K3's window offsets on `dev`; its t range, the config's grid, checked to lie in [0, 1]."""
    _check_t_range(*shadows.refine_t_range(cfg), "the refine's t range")
    if offsets is None:
        return _offsets_on(dev, cfg.shadow_refine_halfwidth, cfg.t_step)
    return torch.as_tensor(offsets, dtype=torch.float32, device=dev).reshape(-1).contiguous()


def refine_around_argmin_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    idx: torch.Tensor,
    ts: torch.Tensor,
    cfg: RenderConfig,
    offsets=None,
) -> torch.Tensor:
    """K3 around K2's winners: (B, H, W) depth and mask, (B, 3) light points -> (B, H, W).

    idx is K2's int32 (B, H/s, W/s) winning index into the float32 table
    `ts` it read, s = cfg.shadow_resolution_scale. Same function as
    refine_min_distance_cuda(..., upsample_tstar_nn(ts[idx], cfg), cfg,
    offsets): the kernel reads each pixel's centre ts[idx[b, row/s, col/s]]
    itself, so no full-resolution t_map is made. Serves only, as the refine.
    """
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's refine has no gradient: it serves only")
    if depth.device.type == "cpu":
        t_map = shadows.upsample_tstar_nn(ts[idx.long()], cfg)
        return shadows.refine_min_distance_batch(depth, mask, light_point, t_map, cfg, offsets)
    _check_inputs(depth, mask, light_point, cfg, "refine")
    b, h, w = depth.shape
    s, dev = cfg.shadow_resolution_scale, depth.device
    if h % s or w % s:
        raise ValueError(f"the draft scale {s} does not divide {h}x{w}")
    if idx.dtype != torch.int32 or tuple(idx.shape) != (b, h // s, w // s) or not idx.is_contiguous() \
            or idx.device != dev:
        raise ValueError(f"idx must be a contiguous int32 {(b, h // s, w // s)} tensor on the depth's device")
    _check("ts", ts, (ts.numel(),), dev)
    return _launch("refine", depth, mask, light_point, _refine_offsets(dev, cfg, offsets), cfg, centre=(idx, ts))


def draft_march(depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """The draft tier's march with its refine: (B, H, W) depth and mask, (B, 3) light points -> (B, H, W).

    Pools the inputs (shadows.scale_march_inputs), marches them with K2 for
    each low-resolution pixel's winning index, then refines at full
    resolution with K3 around those winners. Same function as
    refine_min_distance_batch(depth, mask, light_point, upsample_tstar_nn(t*),
    cfg), t* the argmin march of the pooled inputs; on CPU tensors it runs
    those plain versions. Serves only, as the refine.
    """
    if cfg.shadow_resolution_scale == 1 or cfg.shadow_refine_halfwidth == 0:
        raise ValueError("draft_march needs shadow_resolution_scale > 1 and shadow_refine_halfwidth > 0")
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's march has no gradient: it serves only")
    m_depth, m_mask, m_light, m_cfg = shadows.scale_march_inputs(depth, mask, light_point, cfg)
    ts = _ts_for(depth.device, m_cfg)
    _, idx = _argmin_march(m_depth, m_mask, m_light, ts, m_cfg)
    return refine_around_argmin_cuda(depth, mask, light_point, idx, ts, cfg)
