"""Renderer: network outputs -> relit image (port of geomconsistentfr_tpu/render.py).

Reference rendering semantics (test_relight_single_image.py:326-505):
  1. surface normals from (depth + depth_offset) via intrinsics, y negated
  2. 3D point map (xx, yy, depth) on the centred pixel grid
  3. point light at light_distance * unit_direction
  4. clamped Lambertian directional term
  5. ray-marched min distance -> soft shadow weights
  6. final shading blend and albedo composite

The march always goes through the kernels' wrappers (ops/shadows_cuda.py):
CUDA tensors launch the CUDA kernels, CPU tensors take their plain versions.
`use_pallas_shadows=False` is refused on CUDA tensors: the port has no plain
march on the card outside its comparisons.

Strict, high and fast march at full resolution (kernel K1; in training,
where the march needs a gradient, K2 forward and march_grad backward: the
differentiable march K4 of ops/shadows_cuda.RayMarchMinDistance). The draft tier
(shadow_resolution_scale > 1) marches pooled inputs at reduced resolution
(the pooling of ops/shadows.scale_march_inputs) and records each pixel's
winning sample (kernel K2), then re-marches a window of offsets around it at
full resolution (kernel K3, which reads K2's int32 index and t table itself:
no upsampled t* map is made): ops/shadows_cuda.draft_march, three launches,
one staging pass that pools and pads both resolutions' inputs, K2 and K3.
With shadow_refine_halfwidth 0 it upsamples the low-resolution distances
instead (K1, then ops/shadows.upscale_min_distance). There, and where a
`march_fn` marches the pooled inputs, ops/shadows_cuda.pool_march_inputs
pools them with the same staging kernel.

`march_fn` replaces the march, as in the JAX package (render.py:96-113):
sample and grid parallelism pass one that marches this rank's slice of the t
grid and combines over its process group (ops/shadows_cuda.sharded_march,
or K5 in training). It receives the march-resolution inputs (pooled at the
draft tier, where it must close over the scaled config); with the draft
refine on it is called with `return_argmin_t=True` and returns (min
distances, first-winner t*), which is upsampled for the refine, and its
`refine_fn` attribute, if it has one, replaces the full-resolution refine.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops.geometry import depth_to_normals, l2_normalize, pixel_grid_centered
from geomconsistentfr_torch.ops.shading import composite, directional_shading, shadow_weights
from geomconsistentfr_torch.ops.shadows import upsample_tstar_nn, upscale_min_distance
from geomconsistentfr_torch.ops.shadows_cuda import (
    draft_march,
    needs_grad,
    pool_march_inputs,
    ray_march_min_distance_cuda,
    refine_min_distance_cuda,
)


class RenderOutputs(NamedTuple):
    """The 13 render outputs, in the JAX package's fields and layouts."""

    albedo: torch.Tensor                          # (B, H, W, 3)
    depth: torch.Tensor                           # (B, H, W)
    shadow_mask_weights: torch.Tensor             # (B, H, W)
    ambient_light: torch.Tensor                   # (B, H, W) ambient-only shading
    full_shading: torch.Tensor                    # (B, H, W)
    rendered: torch.Tensor                        # (B, H, W, 3)
    unit_light_direction: torch.Tensor            # (B, 3) light used for rendering
    ambient_values: torch.Tensor                  # (B,) ambient used for rendering
    final_shading: torch.Tensor                   # (B, H, W)
    surface_normals: torch.Tensor                 # (B, H, W, 3)
    estimated_unit_light_direction: torch.Tensor  # (B, 3) head estimate (z clamped)
    estimated_ambient: torch.Tensor               # (B,) head ambient estimate
    min_distance: torch.Tensor                    # (B, H, W) ray-march output


def estimated_light(lighting: torch.Tensor, cfg: RenderConfig):
    """Raw head output (B, 4) -> (unit direction (B, 3), ambient (B,)), z clamped."""
    ambient = lighting[:, 0]
    z = torch.clamp(lighting[:, 3], min=cfg.z_clamp_min)
    direction = torch.cat([lighting[:, 1:3], z[:, None]], dim=-1)
    return l2_normalize(direction, dim=-1), ambient


def render(
    albedo: torch.Tensor,
    depth: torch.Tensor,
    lighting: torch.Tensor,
    mask: torch.Tensor,
    cfg: RenderConfig,
    target_light: Optional[torch.Tensor] = None,
    target_ambient: Optional[torch.Tensor] = None,
    march_fn=None,
) -> RenderOutputs:
    """Render a relit image from network outputs.

    albedo (B, H, W, 3) in [0, 1]; depth (B, H, W), already scaled; lighting
    (B, 4) raw head output; mask (B, H, W), exact zeros veto shadow samples;
    target_light (B, 3), need not be unit; target_ambient (B,); march_fn, an
    optional replacement of the march (see the module docstring).
    """
    b, h, w = depth.shape
    f = cfg.focal_length

    est_unit, est_ambient = estimated_light(lighting, cfg)
    if cfg.lighting_mode == "target":
        if target_light is None:
            raise ValueError("lighting_mode='target' requires target_light")
        unit_dir = l2_normalize(target_light, dim=-1)
    elif cfg.lighting_mode == "self_estimated":
        unit_dir = est_unit
    else:
        raise ValueError(f"unknown lighting_mode: {cfg.lighting_mode}")

    if cfg.ambient_mode == "estimated":
        ambient = est_ambient
    elif cfg.ambient_mode == "estimated_minus_0.1":
        ambient = est_ambient - 0.1
    elif cfg.ambient_mode == "target":
        if target_ambient is None:
            raise ValueError("ambient_mode='target' requires target_ambient")
        ambient = target_ambient
    else:
        raise ValueError(f"unknown ambient_mode: {cfg.ambient_mode}")

    # Normals with y negated (reference :327).
    normals = depth_to_normals(depth + cfg.depth_offset, f, f, cfg.half_w, cfg.half_h)
    normals = normals * torch.tensor([1.0, -1.0, 1.0], device=normals.device, dtype=normals.dtype)

    xx, yy = pixel_grid_centered(h, w, device=depth.device, dtype=depth.dtype)
    points_3d = torch.stack([xx.expand_as(depth), yy.expand_as(depth), depth], dim=-1)

    light_point = cfg.light_distance * unit_dir
    directional = directional_shading(normals, points_3d, light_point, cfg.directional_intensity)
    ambient_map = ambient[:, None, None].expand_as(depth)
    full_shading = ambient_map + directional

    if depth.is_cuda and not cfg.use_pallas_shadows:
        raise ValueError("use_pallas_shadows=False: CUDA tensors march only through the CUDA kernels")
    min_distance = shadow_min_distance(
        depth.float().contiguous(), mask.float().contiguous(), light_point.float().contiguous(), cfg, march_fn
    )
    weights = shadow_weights(min_distance)
    final_shading, rendered = composite(albedo, full_shading, ambient_map, weights)

    return RenderOutputs(
        albedo=albedo,
        depth=depth,
        shadow_mask_weights=weights,
        ambient_light=ambient_map,
        full_shading=full_shading,
        rendered=rendered,
        unit_light_direction=unit_dir,
        ambient_values=ambient,
        final_shading=final_shading,
        surface_normals=normals,
        estimated_unit_light_direction=est_unit,
        estimated_ambient=est_ambient,
        min_distance=min_distance,
    )


def shadow_min_distance(depth, mask, light_point, cfg: RenderConfig, march_fn=None) -> torch.Tensor:
    """(B, H, W) min distances of the configured tier's march, through the kernels' wrappers.

    depth and mask (B, H, W) and light_point (B, 3), float32 and contiguous.
    A march that needs a gradient (training) goes through the wrapper into
    RayMarchMinDistance: K2 forward, march_grad backward. The draft tier
    serves only, as in the JAX package (render.py:189-193), and raises on one.
    `march_fn` (and its `refine_fn`) replace the wrappers' march (and refine).
    """
    if cfg.shadow_resolution_scale == 1:
        if march_fn is None:
            return ray_march_min_distance_cuda(depth, mask, light_point, cfg)
        return march_fn(depth, mask, light_point)
    if needs_grad(depth, light_point):
        raise NotImplementedError("the draft tier's march has no gradient: it serves only")
    if march_fn is None and cfg.shadow_refine_halfwidth > 0:
        return draft_march(depth, mask, light_point, cfg)
    m_depth, m_mask, m_light, m_cfg = pool_march_inputs(depth, mask, light_point, cfg)
    if march_fn is None:
        march_fn = functools.partial(ray_march_min_distance_cuda, cfg=m_cfg)
    if cfg.shadow_refine_halfwidth == 0:
        return upscale_min_distance(march_fn(m_depth, m_mask, m_light), cfg)
    _, t_star = march_fn(m_depth, m_mask, m_light, return_argmin_t=True)
    refine_fn = getattr(march_fn, "refine_fn", None) or functools.partial(refine_min_distance_cuda, cfg=cfg)
    return refine_fn(depth, mask, light_point, upsample_tstar_nn(t_star, cfg))
