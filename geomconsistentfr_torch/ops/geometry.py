"""Camera geometry ops: pixel grids, depth unprojection, surface normals.

Port of geomconsistentfr_tpu/ops/geometry.py, which reproduces kornia 0.4.1's
`depth_to_normals` (the reference's own normals, test_relight_single_image.py
:8, 326): depth is unprojected along the *normalised* camera ray, spatial
gradients use the L1-normalised 3x3 Sobel kernel with replicate padding, and
the normal is the L2-normalised cross product of the x- and y-gradients of the
3D point map. Channels-last, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# L2-normalisation epsilon of torch.nn.functional.normalize.
_TORCH_NORMALIZE_EPS = 1e-12


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = _TORCH_NORMALIZE_EPS) -> torch.Tensor:
    """x / max(||x||_2, eps) along `dim`."""
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def pixel_grid_centered(height: int, width: int, device=None, dtype=torch.float32):
    """(xx, yy) of shape (H, W): xx = column - W/2, yy = H/2 - row."""
    cols = torch.arange(width, device=device, dtype=dtype)
    rows = torch.arange(height, device=device, dtype=dtype)
    xx = cols[None, :].expand(height, width) - width / 2.0
    yy = height / 2.0 - rows[:, None].expand(height, width)
    return xx, yy


def unproject_depth(depth: torch.Tensor, fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """(..., H, W) depth -> (..., H, W, 3) points normalize([(u-cx)/fx, (v-cy)/fy, 1]) * depth."""
    h, w = depth.shape[-2], depth.shape[-1]
    u = torch.arange(w, device=depth.device, dtype=depth.dtype)
    v = torch.arange(h, device=depth.device, dtype=depth.dtype)
    x = ((u[None, :] - cx) / fx).expand(h, w)
    y = ((v[:, None] - cy) / fy).expand(h, w)
    ray = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return l2_normalize(ray, dim=-1) * depth[..., None]


def sobel_gradients(x: torch.Tensor):
    """Replicate-padded, L1-normalised Sobel gradients (gx, gy) of (..., H, W)."""
    lead = x.shape[:-2]
    h, w = x.shape[-2], x.shape[-1]
    xp = F.pad(x.reshape(-1, 1, h, w), (1, 1, 1, 1), mode="replicate")[:, 0]

    def smooth(a, dim):
        n = a.shape[dim]
        return a.narrow(dim, 0, n - 2) + 2.0 * a.narrow(dim, 1, n - 2) + a.narrow(dim, 2, n - 2)

    def diff(a, dim):
        n = a.shape[dim]
        return a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)

    gx = smooth(diff(xp, 2), 1) / 8.0
    gy = diff(smooth(xp, 2), 1) / 8.0
    return gx.reshape(*lead, h, w), gy.reshape(*lead, h, w)


def depth_to_normals(depth: torch.Tensor, fx: float, fy: float, cx: float, cy: float) -> torch.Tensor:
    """(..., H, W) depth -> (..., H, W, 3) unit normals."""
    points = unproject_depth(depth, fx, fy, cx, cy)
    gx, gy = sobel_gradients(torch.movedim(points, -1, -3))
    a = torch.movedim(gx, -3, -1)
    b = torch.movedim(gy, -3, -1)
    return l2_normalize(torch.linalg.cross(a, b, dim=-1), dim=-1)
