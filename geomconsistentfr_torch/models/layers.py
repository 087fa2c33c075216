"""Shared NN building blocks with the JAX package's numerics (NCHW inside).

  * `BatchNorm`: `nn.BatchNorm2d` (same state-dict keys as the reference
    checkpoint) whose forward computes moments, running statistics and the
    affine transform in float32 whatever the activation dtype, and narrows
    only the output: biased variance for normalisation, unbiased for the
    running-var update, running = (1-m)*running + m*batch, eps 1e-5
    (geomconsistentfr_tpu/models/layers.py:51-98).
  * `conv`: a conv or stride-1 transposed conv evaluated in a chosen dtype
    (parameters stay float32 and are cast per call, as flax promotes them).
  * `reset_torch_default`: torch's default init (kaiming-uniform a=sqrt(5),
    i.e. uniform(+-1/sqrt(fan_in)) for weight and bias) drawn from an
    explicit `torch.Generator`.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d in float32 with the output narrowed to `out_dtype`."""

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean_sq = (x * x).mean(dim=(0, 2, 3))
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(1.0 - m).add_(m * mean)
                self.running_var.mul_(1.0 - m).add_(m * var * (n / max(n - 1, 1)))
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        shape = (1, -1, 1, 1)
        y = (x - mean.view(shape)) * inv.view(shape) * self.weight.view(shape) + self.bias.view(shape)
        return y.to(out_dtype)


def conv(module: nn.Module, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Apply a Conv2d / stride-1 ConvTranspose2d with inputs and parameters in `dtype`."""
    w = module.weight.to(dtype)
    b = None if module.bias is None else module.bias.to(dtype)
    x = x.to(dtype)
    if isinstance(module, nn.ConvTranspose2d):
        return F.conv_transpose2d(x, w, b, stride=1, padding=module.padding)
    return F.conv2d(x, w, b, stride=module.stride, padding=module.padding)


@contextlib.contextmanager
def no_tf32():
    """Float32 convs and matmuls in full float32 for the duration of the block.

    PyTorch lets cuDNN convolutions use TF32 by default; the JAX model's
    float32 path does not. The previous settings come back on exit.
    """
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-neighbour x2 upsample (torch nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


@torch.no_grad()
def reset_torch_default(module: nn.Module, generator: torch.Generator) -> None:
    """Torch-default init of every conv/linear/BN below `module`, from `generator`.

    Draws on the CPU so that one seed gives the same weights on any device.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            fan_in, _ = nn.init._calculate_fan_in_and_fan_out(m.weight)
            bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
            for p in (m.weight, m.bias):
                if p is not None:
                    cpu = torch.empty(p.shape).uniform_(-bound, bound, generator=generator)
                    p.copy_(cpu)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
            m.num_batches_tracked.zero_()
