"""Border-artifact postprocessing (port of fix_border_artifacts_CVPR2022.m).

A copy of geomconsistentfr_tpu/postprocess.py. Rendered pixels on the
face/background seam are median-filtered: where the 7x7 box sum of the
binarised face mask is in (0, 30), a pixel becomes the 3x3 median of the
image (zero-padded, MATLAB medfilt2/imfilter defaults).

MATLAB divides the uint8 mask before the box sum
(``imread(...)/255.0``, fix_border_artifacts_CVPR2022.m:5), and its integer
division rounds to nearest, so the mask entering ``imfilter`` is exactly
{0, 1}. Thresholding the (0..1) mask at 0.5 reproduces that.
"""

from __future__ import annotations

import numpy as np


def _median3x3_zero_pad(channel: np.ndarray) -> np.ndarray:
    h, w = channel.shape
    padded = np.zeros((h + 2, w + 2), channel.dtype)
    padded[1:-1, 1:-1] = channel
    stack = np.stack([padded[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)])
    return np.median(stack, axis=0)


def _boxsum7_zero_pad(mask: np.ndarray) -> np.ndarray:
    h, w = mask.shape
    padded = np.zeros((h + 6, w + 6), np.float64)
    padded[3:-3, 3:-3] = mask
    integral = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    integral = np.pad(integral, ((1, 0), (1, 0)))
    return (
        integral[7 : 7 + h, 7 : 7 + w]
        - integral[:h, 7 : 7 + w]
        - integral[7 : 7 + h, :w]
        + integral[:h, :w]
    )


def fix_border_artifacts(image: np.ndarray, face_mask: np.ndarray) -> np.ndarray:
    """image (H, W, 3) float or uint8; face_mask (H, W) in [0, 1]. Returns the image's dtype."""
    img = np.asarray(image)
    work = img.astype(np.float64)
    filtered = np.stack([_median3x3_zero_pad(work[..., c]) for c in range(work.shape[-1])], axis=-1)
    # >= 0.5 matches MATLAB's round-half-away-from-zero on the 0.5 boundary.
    binarized = (np.asarray(face_mask, np.float64) >= 0.5).astype(np.float64)
    conv = _boxsum7_zero_pad(binarized)
    border = (conv > 0) & (conv < 30)
    out = work.copy()
    out[border] = filtered[border]
    return out.astype(img.dtype)
