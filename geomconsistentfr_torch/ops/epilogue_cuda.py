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
this path instead of the eager one. `LIBRARY` declares the kernel to
ops/cuda_lib.py, which builds and launches it and counts its launches as
'epilogue'. An `Affine` carries u, its (5, C) vectors
(`BatchNorm.eval_vectors`) and whether the bias row is added. The maps are (B, C, H, W), contiguous or channels-last,
all of one epilogue in the same memory order; the output takes it.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional, Union

import torch

from geomconsistentfr_torch.ops.cuda_lib import Library, check, ptr

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library(Path(__file__).resolve().parents[1] / "csrc" / "epilogue.cu", {
    "epilogue": ("gcfr_epilogue_launch", [_c_void_p] * 2 + [_c_int] + [_c_void_p] * 2 + [_c_int] + [_c_void_p] * 2
                 + [_c_int] * 7 + [ctypes.c_float]),
})


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


# -- the kernel ----------------------------------------------------------------
def _layout(x: torch.Tensor) -> torch.memory_format:
    if x.is_contiguous():
        return torch.contiguous_format
    if x.is_contiguous(memory_format=torch.channels_last):
        return torch.channels_last
    raise ValueError(f"the epilogue reads contiguous or channels-last maps, got strides {x.stride()}")


def _launch(a: Affine, r: Residual, slope: Optional[float], join: bool, skip: Optional[torch.Tensor]):
    if a.x.dim() != 4:
        raise ValueError(f"the epilogue reads (B, C, H, W) maps, got {tuple(a.x.shape)}")
    b, c, h, w = a.x.shape
    dev, fmt = a.x.device, _layout(a.x)
    check("u", a.x, (b, c, h, w), dev, fmt)
    check("the vectors", a.vec, (5, c), dev)
    rx = r.x if isinstance(r, Affine) else r
    if rx is not None:
        check("the residual", rx, (b, c, h, w), dev, fmt)
    if isinstance(r, Affine):
        check("the residual's vectors", r.vec, (5, c), dev)
    out_shape = (b, c, 2 * h, 2 * w) if join else (b, c, h, w)
    if skip is not None:
        if not join:
            raise ValueError("a skip is added only by the join")
        check("the skip", skip, out_shape, dev, fmt)
    if dev.type != "cuda":
        raise ValueError(f"the epilogue kernel runs on CUDA tensors, got {dev}")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev, memory_format=fmt)
    LIBRARY.launch(
        "epilogue", dev, a.x.data_ptr(), a.vec.data_ptr(), int(a.has_bias), ptr(rx),
        ptr(r.vec if isinstance(r, Affine) else None), int(isinstance(r, Affine) and r.has_bias),
        ptr(skip), out.data_ptr(), b, c, h, w, int(fmt == torch.channels_last), int(join),
        int(slope is not None), 0.0 if slope is None else float(slope),
    )
    return out


def bn_act(a: Affine, r: Residual = None, slope: Optional[float] = None) -> torch.Tensor:
    """act(A(u) + r): LeakyReLU(slope), or the identity where slope is None."""
    return _launch(a, r, slope, False, None)


def join(a: Affine, r: Residual, slope: Optional[float], skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """up2(act(A(u) + r)) [+ skip]: the nearest x2 upsample, then the skip where given."""
    return _launch(a, r, slope, True, skip)
