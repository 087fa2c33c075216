"""Lambertian shading, shadow weighting and compositing.

Port of geomconsistentfr_tpu/ops/shading.py (reference
test_relight_single_image.py:332-346, 498-503).
"""

from __future__ import annotations

import torch

from geomconsistentfr_torch.ops.geometry import l2_normalize


def directional_shading(
    normals: torch.Tensor,
    points_3d: torch.Tensor,
    light_point: torch.Tensor,
    directional_intensity: float,
) -> torch.Tensor:
    """(..., H, W) `directional_intensity * max(0, n . normalize(L - p))`."""
    incident = l2_normalize(light_point[..., None, None, :] - points_3d, dim=-1)
    ndotl = torch.sum(normals * incident, dim=-1)
    return directional_intensity * torch.clamp(ndotl, min=0.0)


def shadow_weights(min_distance: torch.Tensor) -> torch.Tensor:
    """Soft shadow weight w = 1 - 4*e^{-d}/(1+e^{-d})^2 (reference :498)."""
    e = torch.exp(-min_distance)
    return 1.0 - 4.0 * e / torch.square(1.0 + e)


def composite(albedo, full_shading, ambient, weights):
    """(final_shading (..., H, W), rendered (..., H, W, 3))."""
    final_shading = weights * full_shading + (1.0 - weights) * ambient
    rendered = albedo * final_shading[..., None]
    return final_shading, rendered
