"""Ray-marched hard cast shadows: the plain PyTorch march, argmin march and refine.

Port of geomconsistentfr_tpu/ops/shadows.py:48-219, 306-731. For every pixel,
march along the 2D segment from the pixel toward the point light (clipped at
the image border), sample the depth map bilinearly at each parametric offset
t, and take the minimum 3D distance between the depth sample and the
pixel->light ray. A small minimum distance means an occluder crosses the ray.

These are the plain versions of the CUDA kernels in csrc/march.cu: the CPU
path of the port, and what the kernels are held against on the card.
  * `ray_march_min_distance_batch` is kernel K1; with `return_argmin_t` it is
    K2, which also returns the first winning sample's t.
  * `refine_min_distance_batch` is kernel K3, the draft tier's re-march of
    a few offsets around a per-pixel t.
Their arithmetic is written op by op in the order the kernels evaluate it.
Each loop carries the min of the raw cross-product norm^2 (1e30 for a vetoed
sample) and takes sqrt(n2 + 1e-4) / denominator once at the end; both are
monotone, so this equals the min of per-sample distances exactly. The
argmin is taken over norm^2 with a strict `<`, so the first winning sample
wins, as in the kernel (the JAX package's plain march takes it over
distances, which can round two different norm^2 to one distance).

Every operation rounds on its own except the sample coordinates
`xx + t * diff`, which round once, as a fused multiply-add: the JAX
package's compiled march and refine evaluate them so on the CPU, and they
decide the veto's rounding and the depth taps' floor/ceil at exact halves
(see csrc/march.cu).

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
  * 'bilinear' (fast and draft tiers): the bilinear interpolation of the 0/1
    indicator at the clipped shifted position, thresholded at > 0.5. In the
    JAX package only the Pallas kernel has it (shadows_pallas.py:481-496).

The draft tier (RenderConfig.shadow_resolution_scale > 1) marches at reduced
resolution under the scene-scaling identity (JAX package shadows.py:527-551):
shrinking the pixel grid, the depth and the light by 1/s shrinks every
point-to-line distance by 1/s. `scale_march_inputs` pools depth and mask,
the low-resolution march records its argmin t*, `upsample_tstar_nn` repeats
it to full resolution, and `refine_min_distance_batch` re-marches the 2k
offsets around it there. Without the refine, `upscale_min_distance`
interpolates the low-resolution distances instead.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from geomconsistentfr_torch.config import RenderConfig
from geomconsistentfr_torch.ops.geometry import pixel_grid_centered

OFF_FACE_DISTANCE = 1.0e6
OFF_FACE_N2 = 1.0e30  # norm^2 of a vetoed sample; any real norm^2 is far below
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


class _Scene:
    """Per-pixel constants of a march: endpoints, BC and the denominator.

    Tensors are (B, 1, H, W) or broadcast to it, so that a sample axis of
    any length fits between batch and rows.
    """

    def __init__(self, depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig):
        b, h, w = depth.shape
        if (h, w) != (cfg.img_height, cfg.img_width):
            raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
        self.cfg, self.h, self.w = cfg, h, w
        self.veto = resolve_mask_gather(cfg)
        depth = depth.float()
        self.xx, self.yy = pixel_grid_centered(h, w, device=depth.device)
        lx = light_point[:, 0].float().view(b, 1, 1)
        ly = light_point[:, 1].float().view(b, 1, 1)
        lz = light_point[:, 2].float().view(b, 1, 1)
        self.lx, self.ly = lx, ly
        ex, ey = border_endpoints(self.xx, self.yy, lx, ly, cfg)
        self.diff_x = (ex - self.xx)[:, None]
        self.diff_y = (ey - self.yy)[:, None]
        self.bc_x = (lx - self.xx)[:, None]
        self.bc_y = (ly - self.yy)[:, None]
        self.bc_z = (lz - depth)[:, None]
        self.denom = torch.sqrt(self.bc_x * self.bc_x + self.bc_y * self.bc_y + self.bc_z * self.bc_z + EPS)[:, 0]
        self.depth_px = depth[:, None]
        self.depth_flat = depth.reshape(b, -1)
        self.ind_flat = (mask != 0).float().reshape(b, -1)

    def sample_n2(self, t: torch.Tensor) -> torch.Tensor:
        """Cross-product norm^2 at offsets t (1, C, 1, 1) or (B, C, H, W); 1e30 where vetoed."""
        h, w = self.h, self.w
        half_w, half_h = self.cfg.half_w, self.cfg.half_h
        xx, yy = self.xx, self.yy
        sx = _fma(t, self.diff_x, xx)                 # (B, C, H, W) centred coords
        sy = _fma(t, self.diff_y, yy)
        xt = sx + half_w - EPS
        yt = (half_h - sy) - EPS

        ind = self.ind_flat
        if self.veto == "onehot":
            on = _gather(ind, half_h - torch.round(sy), torch.round(sx) + half_w, h, w) != 0
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
            top = _gather(ind, vy0, vx0, h, w) * wx0 + _gather(ind, vy0, vx0 + 1.0, h, w) * wx1
            bot = _gather(ind, vy0 + 1.0, vx0, h, w) * wx0 + _gather(ind, vy0 + 1.0, vx0 + 1.0, h, w) * wx1
            on = (top * wy0 + bot * wy1) > 0.5

        x0 = torch.floor(xt)
        x1 = torch.ceil(xt)
        y0 = torch.floor(yt)
        y1 = torch.ceil(yt)
        wx0 = x1 - xt
        wx1 = xt - x0
        dep = self.depth_flat
        interp_u = _gather(dep, y0, x0, h, w) * wx0 + _gather(dep, y0, x1, h, w) * wx1
        interp_l = _gather(dep, y1, x0, h, w) * wx0 + _gather(dep, y1, x1, h, w) * wx1
        d_interp = interp_u * (y1 - yt) + interp_l * (yt - y0)

        ba_x = (xt - half_w) - xx
        ba_y = (half_h - yt) - yy
        ba_z = d_interp - self.depth_px
        cross_x = ba_y * self.bc_z - ba_z * self.bc_y
        cross_y = ba_z * self.bc_x - ba_x * self.bc_z
        cross_z = ba_x * self.bc_y - ba_y * self.bc_x
        n2 = cross_x * cross_x + cross_y * cross_y + cross_z * cross_z
        return torch.where(on, n2, OFF_FACE_N2)

    def distance(self, best_n2: torch.Tensor) -> torch.Tensor:
        """sqrt(n2 + 1e-4) / denominator; the 1e6 sentinel where every sample was vetoed."""
        min_d = torch.sqrt(best_n2 + EPS) / self.denom
        return torch.where(best_n2 >= OFF_FACE_N2, OFF_FACE_DISTANCE, min_d)

    def finish(self, min_d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """The cull sentinel, then the gate bias."""
        cfg = self.cfg
        if cfg.shadow_mask_cull:
            min_d = torch.where(_live_pixels(mask, cfg), min_d, OFF_FACE_DISTANCE)
        bounds = gate_bounds(cfg)
        if bounds is not None:
            lo_x, hi_x, lo_y, hi_y = bounds
            lx, ly = self.lx, self.ly
            gate = (lx >= lo_x) & (lx <= hi_x) & (ly >= lo_y) & (ly <= hi_y)
            min_d = min_d + torch.where(gate, cfg.shadow_bias, 0.0)
        return min_d


def ray_march_min_distance_batch(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    cfg: RenderConfig,
    ts=None,
    return_argmin_t: bool = False,
):
    """(B, H, W) depth and mask, (B, 3) light points -> (B, H, W) min distances.

    `ts` overrides the sample offsets (1-D, any length), for a march over a
    slice of sample_ts(cfg). Distances include the gate bias where it holds;
    culled pixels (cfg.shadow_mask_cull) read the all-vetoed 1e6.

    With `return_argmin_t`, returns (min distances, t*): t* is the float32
    offset of the first sample reaching the minimum norm^2, taken from the
    given `ts`; culled pixels, and pixels whose every sample is vetoed, read
    the first offset.
    """
    scene = _Scene(depth, mask, light_point, cfg)
    b, h, w = depth.shape
    dev = scene.xx.device
    if ts is None:
        ts = sample_ts(cfg)
    ts = torch.as_tensor(np.asarray(ts, np.float32) if not torch.is_tensor(ts) else ts,
                         dtype=torch.float32, device=dev).reshape(-1)

    best = torch.full((b, h, w), float("inf"), device=dev)
    best_s = torch.zeros((b, h, w), dtype=torch.long, device=dev) if return_argmin_t else None
    start = 0
    for t_chunk in ts.split(max(1, cfg.march_chunk)):
        n2 = scene.sample_n2(t_chunk.view(1, -1, 1, 1))
        chunk_min = n2.amin(dim=1)
        if return_argmin_t:
            # First index of the chunk's min; strict < keeps an earlier chunk's winner.
            s = torch.arange(start, start + t_chunk.numel(), device=dev).view(1, -1, 1, 1)
            first = torch.where(n2 == chunk_min[:, None], s, ts.numel()).amin(dim=1)
            best_s = torch.where(chunk_min < best, first, best_s)
        best = torch.minimum(best, chunk_min)
        start += t_chunk.numel()

    min_d = scene.finish(scene.distance(best), mask)
    if not return_argmin_t:
        return min_d
    if cfg.shadow_mask_cull:
        best_s = torch.where(_live_pixels(mask, cfg), best_s, 0)
    return min_d, ts[best_s]


def ray_march_min_distance(depth, mask, light_point, cfg: RenderConfig, ts=None, return_argmin_t: bool = False):
    """Single image: (H, W), (H, W), (3,) -> (H, W) (and t* with return_argmin_t)."""
    out = ray_march_min_distance_batch(depth[None], mask[None], light_point[None], cfg, ts, return_argmin_t)
    if return_argmin_t:
        return out[0][0], out[1][0]
    return out[0]


def sample_distance_at(depth, mask, light_point, t, cfg: RenderConfig) -> torch.Tensor:
    """Point-to-line distance of the depth sample at offset t (scalar or (H, W)).

    Single image: depth, mask (H, W), light_point (3,) -> (H, W) distances,
    1e6 where the configured veto rejects the sample; no gate bias, no cull.
    """
    scene = _Scene(depth[None], mask[None], light_point[None], cfg)
    t = torch.as_tensor(t, dtype=torch.float32, device=scene.xx.device)
    t = t.expand(scene.h, scene.w)[None, None]
    return scene.distance(scene.sample_n2(t)[:, 0])[0]


# ---------------------------------------------------------------------------
# Draft tier: reduced-resolution march, upsampling and the boundary refine
# ---------------------------------------------------------------------------


def scaled_render_cfg(cfg: RenderConfig) -> RenderConfig:
    """The RenderConfig the inner (low-resolution) march runs under.

    Its t grid is every r-th offset of the full grid (r =
    shadow_lowres_t_stride), its length that of the arange; the gate bias
    rides the rescale as shadow_bias / s.
    """
    s = cfg.shadow_resolution_scale
    t_step = cfg.t_step * cfg.shadow_lowres_t_stride
    n = int(np.arange(cfg.t_start, cfg.t_stop, t_step).shape[0])
    return dataclasses.replace(
        cfg,
        img_height=cfg.img_height // s,
        img_width=cfg.img_width // s,
        shadow_bias=cfg.shadow_bias / s,
        shadow_resolution_scale=1,
        t_step=t_step,
        num_sample_points=n,
        shadow_lowres_t_stride=1,
    )


def scale_march_inputs(depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig):
    """Pool (depth, mask) s x s and scale the light for the draft march.

    Returns (depth/s pooled (B, H/s, W/s), majority-pooled {0,1} mask, the
    scaled light (B, 3), the scaled RenderConfig). The depth is the mean of
    a block's on-face pixels, or of all of them where none is on face. The
    pooled grid's centred coordinates sit (s-1)/(2s) from the scaled scene,
    so the light shifts by that much: minus in x, plus in the flipped y.
    """
    s = cfg.shadow_resolution_scale
    b, h, w = depth.shape
    blocks = depth.reshape(b, h // s, s, w // s, s)
    on = (mask != 0).to(depth.dtype).reshape(b, h // s, s, w // s, s)
    on_count = on.sum(dim=(2, 4))
    face_mean = (blocks * on).sum(dim=(2, 4)) / torch.clamp(on_count, min=1.0)
    depth_h = torch.where(on_count > 0, face_mean, blocks.mean(dim=(2, 4))) / s
    mask_h = (on_count >= (s * s) / 2.0).to(depth.dtype)
    off = (s - 1.0) / (2.0 * s)
    light_h = torch.stack(
        [light_point[:, 0] / s - off, light_point[:, 1] / s + off, light_point[:, 2] / s], dim=-1
    )
    return depth_h, mask_h, light_h, scaled_render_cfg(cfg)


def upscale_min_distance(min_h: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(B, H/s, W/s) low-res min distances -> (B, H, W) full-scale ones.

    Capped at 1e6, bilinearly upsampled with half-pixel centres (the edge
    rows repeat the border texel, as jax.image.resize's renormalised kernel
    does for an integer upscale), multiplied by s and capped again.
    """
    up = F.interpolate(
        torch.clamp(min_h, max=OFF_FACE_DISTANCE)[:, None],
        size=(cfg.img_height, cfg.img_width), mode="bilinear", align_corners=False,
    )[:, 0]
    return torch.clamp(up * float(cfg.shadow_resolution_scale), max=OFF_FACE_DISTANCE)


def upsample_tstar_nn(t_star: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(B, H/s, W/s) low-res argmin offsets -> (B, H, W): each s x s block takes its texel's."""
    s = cfg.shadow_resolution_scale
    return t_star.repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)


def refine_offsets(cfg: RenderConfig) -> np.ndarray:
    """The refine window's relative offsets j * t_step, j in [-k, k-1] (float32)."""
    k = cfg.shadow_refine_halfwidth
    return (np.arange(-k, k) * cfg.t_step).astype(np.float32)


def refine_t_range(cfg: RenderConfig) -> tuple:
    """(t_lo, t_hi): the float32 first and last offsets of the full t grid."""
    ts = sample_ts(cfg).astype(np.float32)
    return float(ts[0]), float(ts[-1])


def refine_min_distance_batch(
    depth: torch.Tensor,
    mask: torch.Tensor,
    light_point: torch.Tensor,
    t_map: torch.Tensor,
    cfg: RenderConfig,
    offsets=None,
) -> torch.Tensor:
    """Full-resolution re-march of a window of offsets around per-pixel t_map.

    (B, H, W) depth, mask and t_map, (B, 3) light points -> (B, H, W): the min
    over `offsets` (default refine_offsets(cfg)) of the distance at
    clip(t_map + offset, t_lo, t_hi), capped at the 1e6 sentinel, with the
    cull and gate of the march. Both vetoes, as the configuration resolves.
    """
    scene = _Scene(depth, mask, light_point, cfg)
    b, h, w = depth.shape
    dev = scene.xx.device
    t_lo, t_hi = refine_t_range(cfg)
    if offsets is None:
        offsets = refine_offsets(cfg)
    offsets = torch.as_tensor(np.asarray(offsets, np.float32) if not torch.is_tensor(offsets) else offsets,
                              dtype=torch.float32, device=dev).reshape(-1)
    t_map = t_map.float()[:, None]

    best = torch.full((b, h, w), OFF_FACE_N2, device=dev)
    for off in offsets.split(max(1, cfg.march_chunk)):
        t = torch.clamp(t_map + off.view(1, -1, 1, 1), t_lo, t_hi)
        best = torch.minimum(best, scene.sample_n2(t).amin(dim=1))
    min_d = torch.clamp(torch.sqrt(best + EPS) / scene.denom, max=OFF_FACE_DISTANCE)
    min_d = torch.where(best >= OFF_FACE_N2, OFF_FACE_DISTANCE, min_d)
    return scene.finish(min_d, mask)


def refine_min_distance(depth, mask, light_point, t_map, cfg: RenderConfig, offsets=None) -> torch.Tensor:
    """Single image: (H, W) depth, mask and t_map, (3,) light point -> (H, W)."""
    return refine_min_distance_batch(depth[None], mask[None], light_point[None], t_map[None], cfg, offsets)[0]
