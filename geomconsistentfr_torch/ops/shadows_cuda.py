"""Build, bind and launch the CUDA shadow-march kernels (csrc/march.cu).

The wrappers, one per kernel:
  * `ray_march_min_distance_cuda` launches K1 ('march'), or K2
    ('march_argmin') with `return_argmin_t`;
  * `refine_min_distance_cuda` launches K3 ('refine').
For a CUDA tensor a wrapper launches its kernel (or raises); for a CPU tensor
it runs the plain version of ops/shadows.py. There is no other fallback.

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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "march.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false", "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

# Launches of each kernel since its count was last set to 0.
LAUNCHES = {"march": 0, "march_argmin": 0, "refine": 0}

# The kernel's `form` argument (csrc/march.cu, enum Form).
_FORMS = {"march": 0, "march_argmin": 1, "refine": 2}

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_c_int] + [_c_void_p] * 8 + [_c_int] * 8 + [_c_float] * 7 + [_c_void_p]


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
    return lib


@functools.lru_cache(maxsize=16)
def _ts_on(device: torch.device, t_start: float, t_stop: float, t_step: float, n: int) -> torch.Tensor:
    cfg = RenderConfig(t_start=t_start, t_stop=t_stop, t_step=t_step, num_sample_points=n)
    return torch.as_tensor(shadows.sample_ts(cfg).astype(np.float32), device=device)


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


def _check_inputs(depth, mask, light_point, cfg: RenderConfig, what: str) -> None:
    """Device, no autograd, the config's shape, float32, contiguous."""
    if depth.device.type != "cuda":
        raise ValueError(f"the {what} kernel runs on CUDA tensors, got {depth.device}")
    if torch.is_grad_enabled() and (depth.requires_grad or light_point.requires_grad):
        raise NotImplementedError(
            f"the CUDA {what} has no backward yet (kernel K4 of the training slice)"
        )
    b, h, w = depth.shape
    if (h, w) != (cfg.img_height, cfg.img_width):
        raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
    if h % 8 or w % 32:
        raise ValueError(f"the {what} kernel needs H % 8 == 0 and W % 32 == 0; got {h}x{w}")
    _check("depth", depth, (b, h, w), depth.device)
    _check("mask", mask, (b, h, w), depth.device)
    _check("light_point", light_point, (b, 3), depth.device)


def _launch(kernel: str, depth, mask, light_point, ts, cfg: RenderConfig, t_map=None, idx=None):
    """Launch one form of the march kernel on the current stream; (B, H, W) distances."""
    b, h, w = depth.shape
    dev = depth.device
    bilinear = shadows.resolve_mask_gather(cfg) == "bilinear"
    live, live_cols, chunk = None, 0, shadows.effective_col_chunk(cfg)
    if cfg.shadow_mask_cull:
        live = shadows.cull_live_blocks(mask, chunk).to(torch.uint8).contiguous()
        live_cols = w // chunk
    bounds = shadows.gate_bounds(cfg)
    gate_on = bounds is not None
    lo_x, hi_x, lo_y, hi_y = bounds if gate_on else (0.0, 0.0, 0.0, 0.0)
    t_lo, t_hi = shadows.refine_t_range(cfg) if t_map is not None else (0.0, 0.0)

    def ptr(x):
        return 0 if x is None else x.data_ptr()

    out = torch.empty_like(depth)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gcfr_march_launch(
            _FORMS[kernel], depth.data_ptr(), mask.data_ptr(), light_point.data_ptr(),
            ts.data_ptr(), ptr(t_map), ptr(live), out.data_ptr(), ptr(idx),
            b, h, w, ts.numel(), int(bilinear), live_cols, chunk, int(gate_on),
            lo_x, hi_x, lo_y, hi_y, cfg.shadow_bias, t_lo, t_hi, stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    LAUNCHES[kernel] += 1
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
    """
    if depth.device.type == "cpu":
        return shadows.ray_march_min_distance_batch(depth, mask, light_point, cfg, ts, return_argmin_t)
    _check_inputs(depth, mask, light_point, cfg, "march")
    dev = depth.device
    if ts is None:
        ts = _ts_on(dev, cfg.t_start, cfg.t_stop, cfg.t_step, cfg.num_sample_points)
    else:
        ts = torch.as_tensor(ts, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    if not return_argmin_t:
        return _launch("march", depth, mask, light_point, ts, cfg)
    idx = torch.empty(depth.shape, dtype=torch.int32, device=dev)
    out = _launch("march_argmin", depth, mask, light_point, ts, cfg, idx=idx)
    # The index addresses the same float32 table the kernel read (shadows_pallas.py:1152-1154).
    return out, ts[idx.long()]


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
    refine_offsets(cfg) (1-D float32, any length).
    """
    if depth.device.type == "cpu":
        return shadows.refine_min_distance_batch(depth, mask, light_point, t_map, cfg, offsets)
    _check_inputs(depth, mask, light_point, cfg, "refine")
    _check("t_map", t_map, tuple(depth.shape), depth.device)
    dev = depth.device
    if offsets is None:
        offsets = _offsets_on(dev, cfg.shadow_refine_halfwidth, cfg.t_step)
    else:
        offsets = torch.as_tensor(offsets, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    return _launch("refine", depth, mask, light_point, offsets, cfg, t_map=t_map)
