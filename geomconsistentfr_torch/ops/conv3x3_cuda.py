"""Build, bind and launch the direct 3x3 convolution with the eval-mode epilogue in its store (csrc/conv3x3.cu).

The kernel computes `epilogue(conv3x3(x, W))` for a float32, channels-last
(B, 16, H, W) input and a 3x3, stride-1, padding-1 convolution from 16 to
16 channels: the epilogue is any form of ops/epilogue_cuda.py (`bn_act` with
no residual, a plain one or an `Affine` shortcut; `join`, the nearest x2
upsample plus the skip), in its operations and order, on the convolution's
sums before the one store. Each output sums its 144 products in float32 FMAs
in one fixed order (csrc/conv3x3.cu says which), so its bits differ from
cuDNN's in the last places but not from launch to launch or process to
process.

`takes` is the one predicate by which models/layers.conv_bn_act routes a
convolution here instead of to cuDNN followed by epilogue_cuda, where
`epilogue_cuda.use_fused` already holds: it reads the module's weight
shape, stride and padding and the input's dtype, shape and layout alone. A
stride-1, padding-1 `nn.ConvTranspose2d` with (I, O, 3, 3) weights is the
convolution with `W.transpose(0, 1).flip(-2, -1)` (`conv_weight`). `taps`
gives the kernel's weight layout, cached on the module until the weight is
replaced or changed in place (its data_ptr or _version), as
`BatchNorm.eval_vectors` caches its vectors.

`LIBRARY` declares the kernel to ops/cuda_lib.py, which builds and launches
it and counts its launches as 'conv3x3'; the kernel allocates nothing.
`plain` is the same function in plain PyTorch (F.conv2d, then the epilogue
in the kernel's order). The wrapper takes no CPU tensor: there
`conv_bn_act` never routes here.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.ops.cuda_lib import Library, check, ptr
from geomconsistentfr_torch.ops.epilogue_cuda import Affine, Residual

CHANNELS = 16

_c_void_p, _c_int = ctypes.c_void_p, ctypes.c_int
LIBRARY = Library(Path(__file__).resolve().parents[1] / "csrc" / "conv3x3.cu", {
    "conv3x3": ("gcfr_conv3x3_launch", [_c_void_p] * 3 + [_c_int] + [_c_void_p] * 2 + [_c_int] + [_c_void_p] * 2
                + [_c_int] * 5 + [ctypes.c_float]),
})


class Conv(NamedTuple):
    x: torch.Tensor          # the convolution's input, (B, 16, H, W) channels-last
    w: torch.Tensor          # (9, 16, 16) float32 weights, [ky * 3 + kx][ci][co] (`taps`)
    vec: torch.Tensor        # (5, 16) float32: bias, mean, inv, gamma, beta (`BatchNorm.eval_vectors`)
    has_bias: bool           # whether the bias row is added


def takes(conv: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether the kernel computes `conv` on `x` in `dtype`: a 3x3, stride-1, padding-1
    Conv2d or ConvTranspose2d from 16 to 16 channels with float32 weights, on a float32
    (B, 16, H, W) channels-last input whose data is 16-byte aligned."""
    if not isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)):
        return False
    w = conv.weight
    return (tuple(w.shape) == (CHANNELS, CHANNELS, 3, 3) and w.dtype == torch.float32 and conv.groups == 1
            and tuple(conv.stride) == (1, 1) and tuple(conv.padding) == (1, 1) and tuple(conv.dilation) == (1, 1)
            and dtype == torch.float32 and x.dtype == torch.float32 and x.dim() == 4 and x.shape[1] == CHANNELS
            and x.is_contiguous(memory_format=torch.channels_last) and x.data_ptr() % 16 == 0)


def conv_weight(conv: nn.Module) -> torch.Tensor:
    """The (O, I, 3, 3) weight with which F.conv2d computes `conv`: a Conv2d's own, a
    stride-1, padding-1 ConvTranspose2d's transposed and flipped."""
    w = conv.weight.detach()
    return w.transpose(0, 1).flip(-2, -1) if isinstance(conv, nn.ConvTranspose2d) else w


def taps(conv: nn.Module) -> torch.Tensor:
    """`conv_weight` in the kernel's layout, (9, 16, 16) [ky * 3 + kx][ci][co], float32
    and contiguous. Kept until the weight is replaced or changed in place (its data_ptr
    or _version), so a later load_state_dict is followed."""
    w = conv.weight
    if w.is_inference():  # no version counter to follow
        return _taps(conv)
    stamp = (id(w), w.data_ptr(), w._version)
    cached = getattr(conv, "_direct_taps", None)
    if cached is None or cached[0] != stamp:
        # The weight is held with the stamp, so no other tensor takes its id.
        cached = conv._direct_taps = (stamp, w, _taps(conv))
    return cached[2]


def _taps(conv: nn.Module) -> torch.Tensor:
    return conv_weight(conv).permute(2, 3, 1, 0).reshape(9, CHANNELS, CHANNELS).contiguous()


# -- the kernel ----------------------------------------------------------------
def _launch(c: Conv, r: Residual, slope: Optional[float], join: bool, skip: Optional[torch.Tensor]):
    if c.x.dim() != 4:
        raise ValueError(f"the convolution reads (B, 16, H, W) maps, got {tuple(c.x.shape)}")
    b, _, h, w = c.x.shape
    shape, dev, cl = (b, CHANNELS, h, w), c.x.device, torch.channels_last
    check("x", c.x, shape, dev, cl, aligned=True)
    check("the weights", c.w, (9, CHANNELS, CHANNELS), dev, aligned=True)
    check("the vectors", c.vec, (5, CHANNELS), dev, aligned=True)
    rx = r.x if isinstance(r, Affine) else r
    if rx is not None:
        check("the residual", rx, shape, dev, cl, aligned=True)
    if isinstance(r, Affine):
        check("the residual's vectors", r.vec, (5, CHANNELS), dev, aligned=True)
    out_shape = (b, CHANNELS, 2 * h, 2 * w) if join else shape
    if skip is not None:
        if not join:
            raise ValueError("a skip is added only by the join")
        check("the skip", skip, out_shape, dev, cl, aligned=True)
    if dev.type != "cuda":
        raise ValueError(f"the convolution kernel runs on CUDA tensors, got {dev}")
    out = torch.empty(out_shape, dtype=torch.float32, device=dev, memory_format=cl)
    LIBRARY.launch(
        "conv3x3", dev, c.x.data_ptr(), c.w.data_ptr(), c.vec.data_ptr(), int(c.has_bias), ptr(rx),
        ptr(r.vec if isinstance(r, Affine) else None), int(isinstance(r, Affine) and r.has_bias),
        ptr(skip), out.data_ptr(), b, h, w, int(join), int(slope is not None), 0.0 if slope is None else float(slope),
    )
    return out


def bn_act(c: Conv, r: Residual = None, slope: Optional[float] = None) -> torch.Tensor:
    """act(A(conv(x)) + r): LeakyReLU(slope), or the identity where slope is None."""
    return _launch(c, r, slope, False, None)


def join(c: Conv, r: Residual, slope: Optional[float], skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """up2(act(A(conv(x)) + r)) [+ skip]: the nearest x2 upsample, then the skip where given."""
    return _launch(c, r, slope, True, skip)


# -- the plain version ---------------------------------------------------------
def _affine_plain(u: torch.Tensor, vec: torch.Tensor, has_bias: bool) -> torch.Tensor:
    b, mean, inv, gamma, beta = (v.view(1, -1, 1, 1) for v in vec)
    x = u + b if has_bias else u
    return (x - mean) * inv * gamma + beta


def plain(c: Conv, r: Residual = None, slope: Optional[float] = None, join: bool = False,
          skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on any device and dtype: F.conv2d without
    bias, then the epilogue's operations in the kernel's order (the convolution's
    sums in F.conv2d's order)."""
    w = c.w.view(3, 3, CHANNELS, CHANNELS).permute(3, 2, 0, 1).to(c.x.dtype)
    y = _affine_plain(F.conv2d(c.x, w, padding=1), c.vec, c.has_bias)
    if r is not None:
        y = (_affine_plain(r.x, r.vec, r.has_bias) if isinstance(r, Affine) else r) + y
    if slope is not None:
        y = torch.where(y >= 0, y, slope * y)
    if join:
        y = F.interpolate(y, scale_factor=2, mode="nearest")
        if skip is not None:
            y = y + skip
    return y
