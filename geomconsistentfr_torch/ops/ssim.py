"""SSIM with pytorch_msssim semantics (the reference's DSSIM loss backend).

Port of geomconsistentfr_tpu/ops/ssim.py:22-80. Reference usage
(train_raytracing_relighting_CelebAHQ_DSSIM_8x.py:643):
  ssim(X, Y, data_range=1.0, size_average=True, nonnegative_ssim=True)
  * separable 1D gaussian window, size 11, sigma 1.5, L1-normalised;
  * VALID (no-padding) filtering per channel, rows then columns;
  * K1=0.01, K2=0.03; sigma terms as E[x^2]-mu^2 style differences;
  * per-channel spatial mean, optional relu (nonnegative), batch/channel mean.

The JAX package computes this outside any Pallas kernel, so here it is plain
PyTorch: the separable filter is two `F.conv2d` passes with a (k, 1) and a
(1, k) window. Callers that need float32 convolutions on the card set
`models.layers.no_tf32` around the forward and the backward (the train step
does).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - size // 2
    g = np.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _filter_valid(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """(N, 1, H, W) -> (N, 1, H-k+1, W-k+1): valid separable filtering, rows then columns."""
    k = win.shape[0]
    return F.conv2d(F.conv2d(x, win.view(1, 1, k, 1)), win.view(1, 1, 1, k))


def ssim(
    x: torch.Tensor,
    y: torch.Tensor,
    data_range: float = 1.0,
    win_size: int = 11,
    win_sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
    nonnegative: bool = True,
    size_average: bool = True,
) -> torch.Tensor:
    """SSIM between (B, H, W, C) images; a scalar if size_average else (B, C)."""
    b, h, w, c = x.shape
    win = torch.as_tensor(gaussian_window(win_size, win_sigma), dtype=x.dtype, device=x.device)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def planes(a):
        return a.permute(0, 3, 1, 2).reshape(b * c, 1, h, w)

    x, y = planes(x), planes(y)
    mu1 = _filter_valid(x, win)
    mu2 = _filter_valid(y, win)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = _filter_valid(x * x, win) - mu1_sq
    sigma2_sq = _filter_valid(y * y, win) - mu2_sq
    sigma12 = _filter_valid(x * y, win) - mu1_mu2

    cs_map = (2.0 * sigma12 + c2) / (sigma1_sq + sigma2_sq + c2)
    ssim_map = ((2.0 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1)) * cs_map

    per_channel = ssim_map.mean(dim=(1, 2, 3)).view(b, c)
    if nonnegative:
        per_channel = torch.relu(per_channel)
    return per_channel.mean() if size_average else per_channel


def dssim(x: torch.Tensor, y: torch.Tensor, **kwargs) -> torch.Tensor:
    """(1 - SSIM) / 2."""
    return (1.0 - ssim(x, y, **kwargs)) / 2.0
