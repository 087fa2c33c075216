"""Build, bind and launch the CNN's eval-mode epilogue (csrc/epilogue.cu).

An epilogue is what follows a convolution in RelightNet:
`act(A(u) + r)`, where `A(u) = ((u + b) - mean) * inv * gamma + beta` is
the convolution's bias and its BatchNorm in eval mode (u the output without
the bias), r nothing, a plain tensor or `A'(v)` of a second convolution (a
projection shortcut), and act LeakyReLU or the identity. Two forms:
  * `bn_act` returns it;
  * `join` returns its nearest x2 upsample, plus a skip tensor of the
    upsampled shape where one is given (a decoder stage's end).
Each launches the kernel on CUDA tensors, bit-equal to the eager
composition of models/layers.py, or raises; it takes no CPU tensor (there
the eager composition is the plain version).

`use_fused` is the one predicate by which models/layers.conv_bn_act takes
this path instead of the eager one; `EPILOGUES` counts the epilogues each
way: the kernel's launches, and the eager compositions. An `Affine`
carries u, its (5, C) vectors (`BatchNorm.eval_vectors`) and whether the
bias row is added. The maps are (B, C, H, W), contiguous or channels-last,
all of one epilogue in the same memory order; the output takes it.

The kernel is built as the march kernels are (`shadows_cuda.build`: nvcc,
sm_90a, -fmad=false, `build/kernels/`, hashed by source and flags) and
loaded with ctypes; it launches on torch's current stream.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Union

import torch

from geomconsistentfr_torch.ops import shadows_cuda

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "epilogue.cu"

# Epilogues evaluated since the counts were last set to 0: 'fused' counts
# the kernel's launches that the launcher accepted, 'eager' the eager
# compositions (models/layers.conv_bn_act).
EPILOGUES = {"fused": 0, "eager": 0}

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = ([_c_void_p] * 2 + [_c_int] + [_c_void_p] * 2 + [_c_int] + [_c_void_p] * 2 + [_c_int] * 7
             + [ctypes.c_float, _c_void_p])


class Affine(NamedTuple):
    x: torch.Tensor          # the convolution's output without its bias, (B, C, H, W)
    vec: torch.Tensor        # (5, C) float32: bias, mean, inv, gamma, beta
    has_bias: bool           # whether the bias row is added


Residual = Union[None, torch.Tensor, Affine]


def use_fused(x: torch.Tensor, dtype: torch.dtype, *bns: torch.nn.Module) -> bool:
    """Whether an epilogue of the BatchNorms `bns` on input `x` takes the fused path: x on
    CUDA, activations (`dtype`) float32, every BatchNorm in eval mode, autograd off."""
    return (x.is_cuda and dtype == torch.float32 and not torch.is_grad_enabled()
            and not any(bn.training for bn in bns))


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(shadows_cuda.build(SOURCE)[0]))
    lib.gcfr_epilogue_launch.argtypes, lib.gcfr_epilogue_launch.restype = _ARGTYPES, _c_int
    return lib


# -- the kernel ----------------------------------------------------------------
def _layout(x: torch.Tensor) -> torch.memory_format:
    if x.is_contiguous():
        return torch.contiguous_format
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    raise ValueError(f"the epilogue reads contiguous or channels-last maps, got strides {x.stride()}")


def _check(name: str, t: torch.Tensor, shape: tuple, device: torch.device, fmt: torch.memory_format) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous(memory_format=fmt):
        raise ValueError(f"{name} must be in the memory order of the convolution's output ({fmt})")


def _check_vec(name: str, a: Affine) -> None:
    c = a.x.shape[1]
    if a.vec.device != a.x.device or a.vec.dtype != torch.float32 or tuple(a.vec.shape) != (5, c) \
            or not a.vec.is_contiguous():
        raise ValueError(f"{name} must be a contiguous float32 (5, {c}) tensor on {a.x.device}")


def _launch(a: Affine, r: Residual, slope: Optional[float], join: bool, skip: Optional[torch.Tensor]):
    if a.x.dim() != 4:
        raise ValueError(f"the epilogue reads (B, C, H, W) maps, got {tuple(a.x.shape)}")
    b, c, h, w = a.x.shape
    dev, fmt = a.x.device, _layout(a.x)
    _check("u", a.x, (b, c, h, w), dev, fmt)
    _check_vec("the vectors", a)
    rx = r.x if isinstance(r, Affine) else r
    if rx is not None:
        _check("the residual", rx, (b, c, h, w), dev, fmt)
    if isinstance(r, Affine):
        _check_vec("the residual's vectors", r)
    out_shape = (b, c, 2 * h, 2 * w) if join else (b, c, h, w)
    if skip is not None:
        if not join:
            raise ValueError("a skip is added only by the join")
        _check("the skip", skip, out_shape, dev, fmt)
    if dev.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on CUDA tensors, got {dev}")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev, memory_format=fmt)
    with torch.cuda.device(dev):
        err = _library().gcfr_epilogue_launch(
            a.x.data_ptr(), a.vec.data_ptr(), int(a.has_bias), _ptr(rx),
            _ptr(r.vec if isinstance(r, Affine) else None), int(isinstance(r, Affine) and r.has_bias),
            _ptr(skip), out.data_ptr(), b, c, h, w, int(fmt == torch.channels_last), int(join),
            int(slope is not None), 0.0 if slope is None else float(slope), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"epilogue kernel launch failed: CUDA error {err}")
    EPILOGUES["fused"] += 1
    return out


def _ptr(x: Optional[torch.Tensor]) -> int:
    return 0 if x is None else x.data_ptr()


def bn_act(a: Affine, r: Residual = None, slope: Optional[float] = None) -> torch.Tensor:
    """act(A(u) + r): LeakyReLU(slope), or the identity where slope is None."""
    return _launch(a, r, slope, False, None)


def join(a: Affine, r: Residual, slope: Optional[float], skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """up2(act(A(u) + r)) [+ skip]: the nearest x2 upsample, then the skip where given."""
    return _launch(a, r, slope, True, skip)
