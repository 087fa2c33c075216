"""Shared NN building blocks with the JAX package's numerics (NCHW inside).

  * `BatchNorm`: `nn.BatchNorm2d` (same state-dict keys as the reference
    checkpoint) whose forward computes moments, running statistics and the
    affine transform in float32 whatever the activation dtype, and narrows
    only the output: biased variance for normalisation, unbiased for the
    running-var update, running = (1-m)*running + m*batch, eps 1e-5
    (geomconsistentfr_tpu/models/layers.py:51-98). Given a process group,
    it is cross-replica BatchNorm: the moments are averaged over the group
    and the count is the group's, as JAX's `axis_name` does (:83-89).
  * `conv`: a conv or stride-1 transposed conv evaluated in a chosen dtype
    (parameters stay float32 and are cast per call, as flax promotes them).
  * `conv_bn_act`: conv -> BatchNorm [+ residual] [-> LeakyReLU] [-> nearest
    x2 upsample + skip], one epilogue. Where `epilogue_cuda.use_fused` holds
    (CUDA, float32 activations, eval mode, no autograd) the convolutions run
    without their bias and one launch of csrc/epilogue.cu does the rest, bit
    for bit as the eager composition, which runs everywhere else; there a
    16-channel 3x3 main convolution that `conv3x3_cuda.takes` (stride 1,
    padding 1, a channels-last input) runs instead as one launch of
    csrc/conv3x3.cu, the convolution and the epilogue together (its sums in
    another order than cuDNN's). `cuda_lib.LAUNCHES` counts the launches of
    both kernels ('epilogue', 'conv3x3'); `EAGER_EPILOGUES` counts the eager
    compositions.
  * `reset_torch_default`: torch's default init (kaiming-uniform a=sqrt(5),
    i.e. uniform(+-1/sqrt(fan_in)) for weight and bias) drawn from an
    explicit `torch.Generator`.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.ops import conv3x3_cuda, epilogue_cuda
from geomconsistentfr_torch.parallel.mesh import all_mean, group_size

# Epilogues that conv_bn_act composed eagerly since the count was last set to 0.
EAGER_EPILOGUES = 0


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d in float32 with the output narrowed to `out_dtype`.

    In train mode with a `group` (a process group of the ranks that share
    the batch), the batch moments are those of the group's whole batch: the
    per-rank means and mean squares averaged over it (one all-reduce,
    differentiable), the count times its size. group None is one process.
    """

    def forward(self, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None, group=None) -> torch.Tensor:
        out_dtype = out_dtype or x.dtype
        x = x.float()
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            mean_sq = (x * x).mean(dim=(0, 2, 3))
            n = x.numel() // x.shape[1]
            if group is not None:
                mean, mean_sq = all_mean(torch.cat([mean, mean_sq]), group).chunk(2)
                n *= group_size(group)
            var = torch.clamp(mean_sq - mean * mean, min=0.0)
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

    def eval_vectors(self, conv_bias: Optional[torch.Tensor]) -> torch.Tensor:
        """(5, C) float32: the convolution's bias (zeros without one), the running mean,
        rsqrt(running var + eps), weight and bias, as the eval-mode forward computes
        them. Kept until a source tensor is replaced or changed in place (its
        data_ptr or _version), so a later load_state_dict is followed."""
        sources = (conv_bias, self.running_mean, self.running_var, self.weight, self.bias)
        live = [t for t in sources if t is not None]
        if any(t.is_inference() for t in live):  # no version counter to follow
            return self._eval_vectors(conv_bias)
        stamp = (self.eps,) + tuple((id(t), t.data_ptr(), t._version) for t in live)
        cached = getattr(self, "_vectors", None)
        if cached is None or cached[0] != stamp:
            # The sources are held with the stamp, so no other tensor takes their ids.
            cached = self._vectors = (stamp, live, self._eval_vectors(conv_bias))
        return cached[2]

    def _eval_vectors(self, conv_bias: Optional[torch.Tensor]) -> torch.Tensor:
        b = torch.zeros_like(self.running_mean) if conv_bias is None else conv_bias
        inv = torch.rsqrt(self.running_var + self.eps)
        return torch.stack([b, self.running_mean, inv, self.weight, self.bias])


def conv(module: nn.Module, x: torch.Tensor, dtype: torch.dtype, bias: bool = True) -> torch.Tensor:
    """Apply a Conv2d / stride-1 ConvTranspose2d with inputs and parameters in `dtype`;
    without its bias where `bias` is False."""
    w = module.weight.to(dtype)
    b = None if module.bias is None or not bias else module.bias.to(dtype)
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


@contextlib.contextmanager
def deterministic_convs():
    """cuDNN's deterministic algorithms, chosen without benchmarking, for the block.

    Two processes that run the same convolutions on the same inputs then get
    the same bits, which ranks that replicate one computation (the samples
    axis of a mesh) rely on. The previous settings come back on exit.
    """
    saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def exact_convs():
    """`no_tf32` and `deterministic_convs` together: float32 convolutions in full
    float32 by cuDNN's deterministic algorithms, so that a metric's map or a
    detector's box is the same bits in every process (LPIPS, S3FD)."""
    with no_tf32(), deterministic_convs():
        yield


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def upsample2_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact nearest-neighbour x2 upsample (torch nn.Upsample(scale_factor=2))."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def leaky_relu(x: torch.Tensor, slope: float) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


class Branch(NamedTuple):
    """A convolution and its BatchNorm on input `x`, the convolution in `dtype`."""

    conv: nn.Module
    bn: BatchNorm
    x: torch.Tensor
    dtype: torch.dtype


def conv_bn_act(main: Branch, residual: Union[None, torch.Tensor, Branch] = None, slope: Optional[float] = None,
                *, dtype: torch.dtype, group=None, upsample: bool = False,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One epilogue: act(residual + BN(conv(x))), act LeakyReLU(slope) or the identity
    (slope None), residual nothing, a tensor or another Branch (a projection shortcut);
    with `upsample`, its nearest x2 upsample plus `skip` where given. The BatchNorms
    narrow to `dtype`; `group` is their cross-replica group in train mode."""
    if skip is not None and not upsample:
        raise ValueError("a skip is added only after the upsample")
    branches = (main, residual) if isinstance(residual, Branch) else (main,)
    if epilogue_cuda.use_fused(main.x, dtype, *(br.bn for br in branches)):
        r = _affine(residual) if isinstance(residual, Branch) else residual
        if conv3x3_cuda.takes(main.conv, main.x, main.dtype):
            bias = main.conv.bias
            c = conv3x3_cuda.Conv(main.x, conv3x3_cuda.taps(main.conv), main.bn.eval_vectors(bias), bias is not None)
            return conv3x3_cuda.join(c, r, slope, skip) if upsample else conv3x3_cuda.bn_act(c, r, slope)
        a = _affine(main)
        if upsample:
            return epilogue_cuda.join(a, r, slope, skip)
        return epilogue_cuda.bn_act(a, r, slope)
    global EAGER_EPILOGUES
    EAGER_EPILOGUES += 1
    y = main.bn(conv(main.conv, main.x, main.dtype), dtype, group)
    if isinstance(residual, Branch):
        residual = residual.bn(conv(residual.conv, residual.x, residual.dtype), dtype, group)
    if residual is not None:
        y = residual + y
    if slope is not None:
        y = leaky_relu(y, slope)
    if upsample:
        y = upsample2_nearest(y)
        if skip is not None:
            y = y + skip
    return y


def _affine(br: Branch) -> epilogue_cuda.Affine:
    """The branch's convolution without its bias, with the vectors that add it and its BatchNorm."""
    bias = br.conv.bias
    return epilogue_cuda.Affine(conv(br.conv, br.x, br.dtype, bias=False), br.bn.eval_vectors(bias), bias is not None)


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
