"""Evaluation metrics replacing the reference's MATLAB scripts (a copy of
geomconsistentfr_tpu/metrics/image_metrics.py).

  * masked MSE (MSE_MP.m:14-25): the squared masked difference summed over
    3 * sum(mask), images as double / 255.
  * masked DSSIM (DSSIM_MP_RGB.m:14-27): MATLAB `ssim` on the RGB image.
    MATLAB treats an MxNx3 double array as a volume and filters it with an
    11x11x11 Gaussian (sigma 1.5, replicate padding, full-size map; dynamic
    range 1.0 for double). DSSIM = (1 - masked mean of the map) / 2.
  * PSNR.

All numpy, in float64.
"""

from __future__ import annotations

import numpy as np

from geomconsistentfr_torch.ops.ssim import gaussian_window


def psnr(x: np.ndarray, y: np.ndarray, data_range: float = 1.0) -> float:
    mse = float(np.mean((np.asarray(x, np.float64) - np.asarray(y, np.float64)) ** 2))
    return 10.0 * np.log10(data_range ** 2 / max(mse, 1e-12))


def _require_nonempty_mask(mask: np.ndarray) -> None:
    """Masked metrics divide by sum(mask): an all-zero mask would give a NaN
    that poisons the whole aggregate. Fail loudly."""
    if not np.any(np.asarray(mask) > 0):
        raise ValueError("mask is empty (no nonzero pixels); masked metric is undefined")


def masked_mse(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    """MSE_MP.m protocol: images in [0, 1], mask (H, W) in [0, 1]."""
    _require_nonempty_mask(mask)
    m = mask[..., None]
    diff = pred * m - gt * m
    return float(np.sum(np.abs(diff) ** 2) / (3.0 * np.sum(mask)))


def _filter_replicate_1d(x: np.ndarray, win: np.ndarray, axis: int) -> np.ndarray:
    k = win.shape[0]
    r = k // 2
    pad = [(0, 0)] * x.ndim
    pad[axis] = (r, r)
    xp = np.pad(x, pad, mode="edge")
    out = np.zeros_like(x)
    sl = [slice(None)] * x.ndim
    for i in range(k):
        sl[axis] = slice(i, i + x.shape[axis])
        out += win[i] * xp[tuple(sl)]
    return out


def _gauss3(x: np.ndarray) -> np.ndarray:
    """Separable 11x11x11 Gaussian, sigma 1.5, replicate padding (MATLAB ssim)."""
    win = gaussian_window(11, 1.5).astype(np.float64)
    for axis in range(3):
        x = _filter_replicate_1d(x, win, axis)
    return x


def matlab_ssim_map(pred: np.ndarray, gt: np.ndarray, data_range: float = 1.0) -> np.ndarray:
    """Full-size SSIM map with MATLAB `ssim` semantics on an HxWx3 double image."""
    x = np.asarray(pred, np.float64)
    y = np.asarray(gt, np.float64)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = _gauss3(x)
    mu_y = _gauss3(y)
    mu_xx = _gauss3(x * x)
    mu_yy = _gauss3(y * y)
    mu_xy = _gauss3(x * y)
    sigma_x = mu_xx - mu_x * mu_x
    sigma_y = mu_yy - mu_y * mu_y
    sigma_xy = mu_xy - mu_x * mu_y
    return ((2 * mu_x * mu_y + c1) * (2 * sigma_xy + c2)) / ((mu_x ** 2 + mu_y ** 2 + c1) * (sigma_x + sigma_y + c2))


def masked_dssim_matlab(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray) -> float:
    """DSSIM_MP_RGB.m protocol: masked mean of the MATLAB ssim map, (1 - s) / 2."""
    _require_nonempty_mask(mask)
    ssim_map = matlab_ssim_map(pred, gt)
    m3 = np.repeat(mask[..., None], 3, axis=-1)
    avg = float(np.sum(ssim_map * m3) / np.sum(m3))
    return (1.0 - avg) / 2.0
