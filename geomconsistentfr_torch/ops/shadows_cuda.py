"""Build, bind and launch the CUDA shadow-march kernel (csrc/march.cu).

`ray_march_min_distance_cuda` is the wrapper: for a CUDA tensor it launches
the kernel (or raises), for a CPU tensor it runs the plain march of
ops/shadows.py. There is no other fallback.

The kernel is compiled by `nvcc` for sm_90a at first use into
`<repo>/build/kernels/` (git-ignored), keyed by a hash of the source and the
flags, and loaded with ctypes; the source has a plain C interface, so a build
takes seconds. `LAUNCHES` counts the kernel's launches.
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

# Launches of the march kernel since the count was last set to 0.
LAUNCHES = 0

_c_void_p, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_c_void_p] * 6 + [_c_int] * 8 + [_c_float] * 5 + [_c_void_p]


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


def _check(name: str, x: torch.Tensor, shape: tuple, device: torch.device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ray_march_min_distance_cuda(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    cfg: RenderConfig,
    ts=None,
) -> torch.Tensor:
    """(B, H, W) depth and mask, (B, 3) light points -> (B, H, W) min distances.

    Same function as shadows.ray_march_min_distance_batch. `ts` overrides the
    sample offsets (1-D float32, any length).
    """
    if depth.device.type == "cpu":
        return shadows.ray_march_min_distance_batch(depth, mask, light_point, cfg, ts)
    if depth.device.type != "cuda":
        raise ValueError(f"the march kernel runs on CUDA tensors, got {depth.device}")
    if torch.is_grad_enabled() and (depth.requires_grad or light_point.requires_grad):
        raise NotImplementedError(
            "the CUDA march has no backward yet (kernel K4 of the training slice)"
        )
    b, h, w = depth.shape
    dev = depth.device
    if (h, w) != (cfg.img_height, cfg.img_width):
        raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
    if h % 8 or w % 32:
        raise ValueError(f"the march kernel needs H % 8 == 0 and W % 32 == 0; got {h}x{w}")
    _check("depth", depth, (b, h, w), dev)
    _check("mask", mask, (b, h, w), dev)
    _check("light_point", light_point, (b, 3), dev)
    if ts is None:
        ts = _ts_on(dev, cfg.t_start, cfg.t_stop, cfg.t_step, cfg.num_sample_points)
    else:
        ts = torch.as_tensor(ts, dtype=torch.float32, device=dev).reshape(-1).contiguous()
    bilinear = shadows.resolve_mask_gather(cfg) == "bilinear"

    live, live_cols, chunk = None, 0, shadows.effective_col_chunk(cfg)
    if cfg.shadow_mask_cull:
        live = shadows.cull_live_blocks(mask, chunk).to(torch.uint8).contiguous()
        live_cols = w // chunk
    bounds = shadows.gate_bounds(cfg)
    gate_on = bounds is not None
    lo_x, hi_x, lo_y, hi_y = bounds if gate_on else (0.0, 0.0, 0.0, 0.0)

    out = torch.empty_like(depth)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.gcfr_march_launch(
            depth.data_ptr(), mask.data_ptr(), light_point.data_ptr(),
            ts.data_ptr(), 0 if live is None else live.data_ptr(), out.data_ptr(),
            b, h, w, ts.numel(), int(bilinear), live_cols, chunk, int(gate_on),
            lo_x, hi_x, lo_y, hi_y, cfg.shadow_bias, stream,
        )
    if err != 0:
        raise RuntimeError(f"march kernel launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
