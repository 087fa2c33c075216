"""Ray-marched hard cast shadows: the plain PyTorch march.

Port of geomconsistentfr_tpu/ops/shadows.py:48-151, 306-515. For every pixel,
march along the 2D segment from the pixel toward the point light (clipped at
the image border), sample the depth map bilinearly at each parametric offset
t, and take the minimum 3D distance between the depth sample and the
pixel->light ray. A small minimum distance means an occluder crosses the ray.

This is the plain version of the CUDA kernel in csrc/march.cu: the CPU path
of the port, and what the kernel is held against on the card. Its arithmetic
is written op by op in the order the kernel evaluates it. Every operation
rounds on its own except the sample coordinates `xx + t * diff`, which round
once, as a fused multiply-add: the JAX package's march evaluates them so on
the CPU, and they decide the veto's rounding and the depth taps' floor/ceil
at exact halves (see csrc/march.cu).

Reference quirks kept as spec (reference test_relight_single_image.py):
  * slopes use a +1e-4 denominator guard (:355); the horizontal-border solve
    divides by (slope + 1e-4) (:372); corner cases test the unclamped x (:374);
  * endpoints clamp to x in [-W/2, W/2-1], y in [1-H/2, H/2] (:439-442);
  * the bilinear depth lookup uses coordinates shifted by -1e-4 (:457-471),
    and the sample's xy in the distance keeps that shift (:473-476);
  * both point-to-line sqrt terms carry a +1e-4 regulariser (:485-486);
  * off-face samples contribute distance 1e6 (:488-490);
  * an optional +5.0 bias when the light xy is inside a gate region (:495-496).

The mask veto has two forms (RenderConfig.shadow_mask_gather):
  * 'onehot': the face indicator at the banker's-rounded sample position
    (:449-454) -- torch.round rounds half to even, like the reference;
  * 'bilinear' (fast tier): the bilinear interpolation of the 0/1 indicator
    at the clipped shifted position, thresholded at > 0.5. In the JAX package
    only the Pallas kernel has it (shadows_pallas.py:481-496).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops.geometry import pixel_grid_centered

OFF_FACE_DISTANCE = 1.0e6
EPS = 1e-4


def sample_ts(cfg: RenderConfig) -> np.ndarray:
    """The parametric march offsets t (float64 arange, reference :445)."""
    ts = np.arange(cfg.t_start, cfg.t_stop, cfg.t_step)
    if ts.shape[0] != cfg.num_sample_points:
        raise ValueError(
            f"t grid size {ts.shape[0]} != num_sample_points {cfg.num_sample_points}"
        )
    return ts


def resolve_mask_gather(cfg: RenderConfig) -> str:
    """'onehot' or 'bilinear': the veto this config asks for ('auto' resolved)."""
    mode = cfg.shadow_mask_gather
    if mode == "auto":
        mode = "bilinear" if cfg.shadow_matmul_precision == "default" else "onehot"
    if mode in ("hat", "hat_y"):
        raise NotImplementedError(
            f"shadow_mask_gather={mode!r} is a TPU-only variant of the JAX kernel"
        )
    if mode not in ("onehot", "bilinear"):
        raise ValueError(f"unknown shadow_mask_gather: {mode!r}")
    return mode


def effective_col_chunk(cfg: RenderConfig) -> int:
    """Cull block width: shadow_col_chunk, or the full width for the row cull."""
    c = cfg.shadow_col_chunk
    return c if 0 < c < cfg.img_width else cfg.img_width


def gate_bounds(cfg: RenderConfig) -> Optional[tuple]:
    """(lo_x, hi_x, lo_y, hi_y) of the +bias gate region, or None without a gate."""
    if cfg.shadow_bias_gate == "none":
        return None
    if cfg.shadow_bias_gate == "inside_image":
        return (-cfg.half_w, cfg.img_width - cfg.half_w - 1.0, 1.0 - cfg.half_h, cfg.half_h)
    if cfg.shadow_bias_gate == "wide":
        return (
            -4.0 * cfg.img_width, 4.0 * cfg.img_width,
            4.0 * (1.0 - cfg.img_height), 4.0 * cfg.img_height,
        )
    raise ValueError(f"unknown shadow_bias_gate: {cfg.shadow_bias_gate}")


def border_endpoints(xx, yy, light_x, light_y, cfg: RenderConfig):
    """Per-pixel march endpoint: the pixel->light line's exit from the image.

    Branchless form of the reference's 9-way case analysis (:363-442).
    xx, yy (H, W); light_x, light_y broadcastable, e.g. (B, 1, 1).
    """
    left = -cfg.half_w
    right = cfg.img_width - cfg.half_w - 1.0
    bottom = 1.0 - cfg.half_h
    top = cfg.half_h

    slopes = (light_y - yy) / (light_x - xx + EPS)
    intercepts = light_y - slopes * light_x

    zx_neg = light_x < left
    zx_pos = light_x > right
    zx_mid = ~(zx_neg | zx_pos)
    zy_neg = light_y < bottom
    zy_pos = light_y > top
    zy_mid = ~(zy_neg | zy_pos)

    xv = torch.where(zx_neg, left, right)
    ex_v = xv.expand_as(slopes)
    ey_v = slopes * xv + intercepts

    yh = torch.where(zy_neg, bottom, top)
    ex_h = (yh - intercepts) / (slopes + EPS)
    ey_h = yh.expand_as(slopes)

    inter = (ex_h >= left) & (ex_h <= right)
    ex_c = torch.where(inter, ex_h, ex_v)
    ey_c = torch.where(inter, ey_h, ey_v)

    inside = zx_mid & zy_mid
    lx = light_x.expand_as(slopes)
    ly = light_y.expand_as(slopes)
    ex = torch.where(inside, lx, torch.where(zy_mid, ex_v, torch.where(zx_mid, ex_h, ex_c)))
    ey = torch.where(inside, ly, torch.where(zy_mid, ey_v, torch.where(zx_mid, ey_h, ey_c)))
    return torch.clamp(ex, left, right), torch.clamp(ey, bottom, top)


def cull_live_blocks(mask: torch.Tensor, col_chunk: int) -> torch.Tensor:
    """(B, H, W) mask -> (B, H/8, W/C) bool: the 8-row x C-column block holds face.

    Blocks are fixed and aligned (shadows.py:306-341 of the JAX package);
    C = W gives the row cull. H must be a multiple of 8 here.
    """
    b, h, w = mask.shape
    if h % 8 or w % col_chunk:
        raise ValueError(f"cull blocks need H % 8 == 0 and W % C == 0; got {h}x{w}, C={col_chunk}")
    on = (mask != 0).view(b, h // 8, 8, w // col_chunk, col_chunk)
    return on.any(dim=4).any(dim=2)


def _live_pixels(mask: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(B, H, W) bool liveness under the configured cull granularity."""
    c = effective_col_chunk(cfg)
    blocks = cull_live_blocks(mask, c)
    return blocks.repeat_interleave(8, dim=1).repeat_interleave(c, dim=2)


def _gather(flat: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """flat (B, H*W) at integer-valued float indices (B, C, H, W), clamped."""
    iy = torch.clamp(iy, 0, h - 1).long()
    ix = torch.clamp(ix, 0, w - 1).long()
    idx = (iy * w + ix).reshape(flat.shape[0], -1)
    return torch.gather(flat, 1, idx).view(iy.shape)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32, as a fused multiply-add rounds it.

    The float64 product of two float32 values is exact; the float64 sum is
    rounded to float32 after one float64 rounding, which differs from a true
    FMA only when the exact sum lies within 2^-53 of a float32 tie.
    """
    return (a.double() * b.double() + c.double()).float()


def ray_march_min_distance_batch(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    cfg: RenderConfig,
    ts=None,
) -> torch.Tensor:
    """(B, H, W) depth and mask, (B, 3) light points -> (B, H, W) min distances.

    `ts` overrides the sample offsets (1-D, any length), for a march over a
    slice of sample_ts(cfg). Distances include the gate bias where it holds;
    culled pixels (cfg.shadow_mask_cull) read the all-vetoed 1e6.
    """
    b, h, w = depth.shape
    if (h, w) != (cfg.img_height, cfg.img_width):
        raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
    veto = resolve_mask_gather(cfg)
    depth = depth.float()
    dev = depth.device
    half_w, half_h = cfg.half_w, cfg.half_h

    xx, yy = pixel_grid_centered(h, w, device=dev)
    lx = light_point[:, 0].float().view(b, 1, 1)
    ly = light_point[:, 1].float().view(b, 1, 1)
    lz = light_point[:, 2].float().view(b, 1, 1)
    ex, ey = border_endpoints(xx, yy, lx, ly, cfg)
    diff_x = (ex - xx)[:, None]
    diff_y = (ey - yy)[:, None]
    bc_x = (lx - xx)[:, None]
    bc_y = (ly - yy)[:, None]
    bc_z = (lz - depth)[:, None]
    denom = torch.sqrt(bc_x * bc_x + bc_y * bc_y + bc_z * bc_z + EPS)
    depth_px = depth[:, None]

    depth_flat = depth.reshape(b, -1)
    ind_flat = (mask != 0).float().reshape(b, -1)
    if ts is None:
        ts = sample_ts(cfg)
    ts = torch.as_tensor(np.asarray(ts, np.float32) if not torch.is_tensor(ts) else ts,
                         dtype=torch.float32, device=dev).reshape(-1)

    best = torch.full((b, h, w), float("inf"), device=dev)
    for t_chunk in ts.split(max(1, cfg.march_chunk)):
        t = t_chunk.view(1, -1, 1, 1)
        sx = _fma(t, diff_x, xx)                  # (B, C, H, W) centred coords
        sy = _fma(t, diff_y, yy)
        xt = sx + half_w - EPS
        yt = (half_h - sy) - EPS

        if veto == "onehot":
            on = _gather(ind_flat, half_h - torch.round(sy), torch.round(sx) + half_w, h, w) != 0
        else:
            xtc = torch.clamp(xt, 0.0, w - 1.0)
            ytc = torch.clamp(yt, 0.0, h - 1.0)
            vx0 = torch.floor(xtc)
            vy0 = torch.floor(ytc)
            # Hat weights max(0, 1 - |tap - coord|) of the two taps.
            wx0 = 1.0 - (xtc - vx0)
            wx1 = 1.0 - ((vx0 + 1.0) - xtc)
            wy0 = 1.0 - (ytc - vy0)
            wy1 = 1.0 - ((vy0 + 1.0) - ytc)
            top = _gather(ind_flat, vy0, vx0, h, w) * wx0 + _gather(ind_flat, vy0, vx0 + 1.0, h, w) * wx1
            bot = _gather(ind_flat, vy0 + 1.0, vx0, h, w) * wx0 + _gather(ind_flat, vy0 + 1.0, vx0 + 1.0, h, w) * wx1
            on = (top * wy0 + bot * wy1) > 0.5

        x0 = torch.floor(xt)
        x1 = torch.ceil(xt)
        y0 = torch.floor(yt)
        y1 = torch.ceil(yt)
        wx0 = x1 - xt
        wx1 = xt - x0
        interp_u = _gather(depth_flat, y0, x0, h, w) * wx0 + _gather(depth_flat, y0, x1, h, w) * wx1
        interp_l = _gather(depth_flat, y1, x0, h, w) * wx0 + _gather(depth_flat, y1, x1, h, w) * wx1
        d_interp = interp_u * (y1 - yt) + interp_l * (yt - y0)

        ba_x = (xt - half_w) - xx
        ba_y = (half_h - yt) - yy
        ba_z = d_interp - depth_px
        cross_x = ba_y * bc_z - ba_z * bc_y
        cross_y = ba_z * bc_x - ba_x * bc_z
        cross_z = ba_x * bc_y - ba_y * bc_x
        numerator = torch.sqrt(cross_x * cross_x + cross_y * cross_y + cross_z * cross_z + EPS)
        dist = torch.where(on, numerator / denom, OFF_FACE_DISTANCE)
        best = torch.minimum(best, dist.amin(dim=1))

    if cfg.shadow_mask_cull:
        best = torch.where(_live_pixels(mask, cfg), best, OFF_FACE_DISTANCE)
    bounds = gate_bounds(cfg)
    if bounds is not None:
        lo_x, hi_x, lo_y, hi_y = bounds
        gate = (lx >= lo_x) & (lx <= hi_x) & (ly >= lo_y) & (ly <= hi_y)
        best = best + torch.where(gate, cfg.shadow_bias, 0.0)
    return best


def ray_march_min_distance(depth, mask, light_point, cfg: RenderConfig, ts=None) -> torch.Tensor:
    """Single image: (H, W), (H, W), (3,) -> (H, W)."""
    return ray_march_min_distance_batch(depth[None], mask[None], light_point[None], cfg, ts)[0]
