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
  * `march_vjp` is the backward of the training march K4 (kernel
    march_grad): autograd of `sample_distance_at_batch` at K2's t*.
  * `stage_inputs` is the kernels' input staging (stage_kernel): depth and
    mask padded and interleaved, with the cull's flags, at the draft tier
    the pooled inputs of `scale_march_inputs` too.
  * `pack_march_key` is K2's key form, the 64-bit (distance, t) word the
    sample-sharded marches reduce with one MIN over their ranks, and
    `unpack_march_key` the unpack kernel (unpack_key_kernel).
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

The mask veto has four forms (RenderConfig.shadow_mask_gather):
  * 'onehot': the face indicator at the banker's-rounded sample position
    (:449-454) -- torch.round rounds half to even, like the reference;
  * 'bilinear' (fast and draft tiers): the bilinear interpolation of the 0/1
    indicator at the clipped shifted position, thresholded at > 0.5;
  * 'hat': the banker's-rounded row, and along it the two columns' hat
    weights at the clipped shifted x, summed over the face taps and
    thresholded at > 0.5 (a tie passes only with both taps on the face);
  * 'hat_y': the same with the axes swapped: the banker's-rounded column and
    the two rows' hat weights at the clipped shifted y.
In the JAX package only the Pallas kernel has the last three
(shadows_pallas.py:443-496). The march's backward (`march_vjp`) vetoes its
winning sample one-hot whatever the forward's veto, as the JAX package's
custom VJP does (`_vjp_bwd`, shadows_pallas.py:776-808).

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
from typing import NamedTuple, Optional

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


def sharded_sample_ts(cfg: RenderConfig, n_shards: int) -> np.ndarray:
    """sample_ts as float32, padded to n_shards equal contiguous increasing slices.

    Shard i marches rows [i*chunk, (i+1)*chunk) of the result. The slices
    increase with i, so among the shards that reach a pixel's minimum the
    smallest t (the one MIN of pack_march_key's words takes it) is the first
    winner, as on the full grid. The pad
    repeats the last offset, which cannot change a running minimum, nor win
    over the offset it repeats (strict `<` keeps the first).
    """
    ts = sample_ts(cfg).astype(np.float32)
    chunk = -(-ts.shape[0] // n_shards)
    if n_shards * chunk > ts.shape[0]:
        ts = np.concatenate([ts, np.repeat(ts[-1:], n_shards * chunk - ts.shape[0])])
    return ts


# The vetoes, in the order of their code in csrc/march.cu (enum Veto).
VETOES = ("onehot", "bilinear", "hat", "hat_y")


def resolve_mask_gather(cfg: RenderConfig) -> str:
    """One of VETOES: the veto this config asks for ('auto' resolved)."""
    mode = cfg.shadow_mask_gather
    if mode == "auto":
        mode = "bilinear" if cfg.shadow_matmul_precision == "default" else "onehot"
    if mode not in VETOES:
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
    """(B, H, W) mask -> (B, ceil(H/8), W/C) bool: the 8-row x C-column block holds face.

    Blocks are fixed and aligned (shadows.py:306-341 of the JAX package):
    C = min(col_chunk, W), which must divide W, and C = W gives the row
    cull. A last row group of fewer than 8 rows is padded with rows off the
    face, as JAX's is.
    """
    b, h, w = mask.shape
    c = min(col_chunk, w)
    if w % c:
        raise ValueError(f"cull blocks need W % C == 0; got W={w}, C={c}")
    on = mask != 0
    pad = -h % 8
    if pad:
        on = torch.cat([on, on.new_zeros((b, pad, w))], dim=1)
    return on.view(b, -1, 8, w // c, c).any(dim=4).any(dim=2)


def _live_pixels(mask: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """(B, H, W) bool liveness under the configured cull granularity."""
    c = effective_col_chunk(cfg)
    blocks = cull_live_blocks(mask, c)
    return blocks.repeat_interleave(8, dim=1)[:, :mask.shape[1]].repeat_interleave(c, dim=2)


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

    def __init__(self, depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig,
                 veto: Optional[str] = None):
        b, h, w = depth.shape
        if (h, w) != (cfg.img_height, cfg.img_width):
            raise ValueError(f"depth {tuple(depth.shape)} does not match the config's {cfg.img_height}x{cfg.img_width}")
        if veto is not None and veto not in VETOES:
            raise ValueError(f"unknown veto: {veto!r}")
        self.cfg, self.h, self.w = cfg, h, w
        self.veto = veto or resolve_mask_gather(cfg)
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
        veto = self.veto
        if veto != "bilinear":  # the banker's-rounded row and column (the gather clamps them)
            ry = half_h - torch.round(sy)
            rx = torch.round(sx) + half_w
        if veto == "onehot":
            on = _gather(ind, ry, rx, h, w) != 0
        else:
            xtc = torch.clamp(xt, 0.0, w - 1.0)
            ytc = torch.clamp(yt, 0.0, h - 1.0)
            vx0 = torch.floor(xtc)
            vy0 = torch.floor(ytc)
            # Hat weights max(0, 1 - |tap - coord|) of the two taps.
            ux0 = 1.0 - (xtc - vx0)
            ux1 = 1.0 - ((vx0 + 1.0) - xtc)
            uy0 = 1.0 - (ytc - vy0)
            uy1 = 1.0 - ((vy0 + 1.0) - ytc)
            if veto == "hat":  # the rounded row's two columns
                on = (_gather(ind, ry, vx0, h, w) * ux0 + _gather(ind, ry, vx0 + 1.0, h, w) * ux1) > 0.5
            elif veto == "hat_y":  # the rounded column's two rows
                on = (_gather(ind, vy0, rx, h, w) * uy0 + _gather(ind, vy0 + 1.0, rx, h, w) * uy1) > 0.5
            else:
                top = _gather(ind, vy0, vx0, h, w) * ux0 + _gather(ind, vy0, vx0 + 1.0, h, w) * ux1
                bot = _gather(ind, vy0 + 1.0, vx0, h, w) * ux0 + _gather(ind, vy0 + 1.0, vx0 + 1.0, h, w) * ux1
                on = (top * uy0 + bot * uy1) > 0.5

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
    if not return_argmin_t:
        return _march(depth, mask, light_point, cfg, ts, False)
    min_d, best_s, ts = _march(depth, mask, light_point, cfg, ts, True)
    return min_d, ts[best_s]


def ray_march_argmin_batch(depth, mask, light_point, cfg: RenderConfig, ts=None):
    """(min distances, int32 index of each pixel's first winning sample in `ts`).

    The argmin march as kernel K2 returns it: the index where
    `ray_march_min_distance_batch(..., return_argmin_t=True)` returns its t.
    """
    min_d, best_s, _ = _march(depth, mask, light_point, cfg, ts, True)
    return min_d, best_s.to(torch.int32)


def _march(depth, mask, light_point, cfg: RenderConfig, ts, return_argmin: bool):
    """min distances, or (min distances, first winning index (long), the float32 ts)."""
    scene = _Scene(depth, mask, light_point, cfg)
    b, h, w = depth.shape
    dev = scene.xx.device
    if ts is None:
        ts = sample_ts(cfg)
    ts = torch.as_tensor(np.asarray(ts, np.float32) if not torch.is_tensor(ts) else ts,
                         dtype=torch.float32, device=dev).reshape(-1)

    best = torch.full((b, h, w), float("inf"), device=dev)
    best_s = torch.zeros((b, h, w), dtype=torch.long, device=dev) if return_argmin else None
    start = 0
    for t_chunk in ts.split(max(1, cfg.march_chunk)):
        n2 = scene.sample_n2(t_chunk.view(1, -1, 1, 1))
        chunk_min = n2.amin(dim=1)
        if return_argmin:
            # First index of the chunk's min; strict < keeps an earlier chunk's winner.
            s = torch.arange(start, start + t_chunk.numel(), device=dev).view(1, -1, 1, 1)
            first = torch.where(n2 == chunk_min[:, None], s, ts.numel()).amin(dim=1)
            best_s = torch.where(chunk_min < best, first, best_s)
        best = torch.minimum(best, chunk_min)
        start += t_chunk.numel()

    min_d = scene.finish(scene.distance(best), mask)
    if not return_argmin:
        return min_d
    if cfg.shadow_mask_cull:
        best_s = torch.where(_live_pixels(mask, cfg), best_s, 0)
    return min_d, best_s, ts


_LOW_WORD = 0xFFFFFFFF


def _order_bits(bits: torch.Tensor) -> torch.Tensor:
    """A float32's int32 bits <-> an int32 in the float's order (its own inverse): negative
    floats get their 31 low bits flipped, so that a more negative float is a smaller int."""
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


_SIGN = -0x80000000  # the int32 sign bit


def pack_march_key(min_d: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(distance, t) float32 -> int64 keys whose signed order is (distance, t)'s lexicographic order.

    The high word is the distance's order-preserving int32 (-0 taken as +0,
    so that the two compare equal), the low word t's, its sign bit flipped
    so that the word orders as an unsigned one (a table may hold t < 0). So
    the MIN of a pixel's keys over the ranks of a sample-sharded march is
    the global minimum distance and, among the ranks that reach it, the
    smallest t: the JAX package's two pmins (shadows_pallas.py:851-855). K2's
    key form (csrc/march.cu pack_key) writes the same words.
    """
    d = torch.where(min_d == 0, 0.0, min_d.float())
    t = torch.where(t == 0, 0.0, t.float())
    hi = _order_bits(d.view(torch.int32)).long()
    lo = _order_bits(t.view(torch.int32)) ^ _SIGN
    return (hi << 32) | (lo.long() & _LOW_WORD)


def unpack_march_key(key: torch.Tensor) -> tuple:
    """pack_march_key's inverse: int64 keys -> (distances, t), float32, bit for bit."""
    d = _order_bits((key >> 32).to(torch.int32)).view(torch.float32)
    t = _order_bits((key & _LOW_WORD).to(torch.int32) ^ _SIGN).view(torch.float32)
    return d, t


def ray_march_min_distance(depth, mask, light_point, cfg: RenderConfig, ts=None, return_argmin_t: bool = False):
    """Single image: (H, W), (H, W), (3,) -> (H, W) (and t* with return_argmin_t)."""
    out = ray_march_min_distance_batch(depth[None], mask[None], light_point[None], cfg, ts, return_argmin_t)
    if return_argmin_t:
        return out[0][0], out[1][0]
    return out[0]


def ray_march_min_distance_lights(depth, mask, light_points, cfg: RenderConfig) -> torch.Tensor:
    """One image under a sweep of lights: (H, W) depth and mask, (L, 3) light points -> (L, H, W).

    The JAX package's vmap over lights (shadows.py:518). The image is
    expanded over the L lights and marched as a batch: by kernel K1 on CUDA
    tensors (ops/shadows_cuda; through its differentiable march where a
    gradient is needed), by the plain march on the CPU.
    """
    from geomconsistentfr_torch.ops import shadows_cuda  # it imports this module

    n = light_points.shape[0]
    depth, mask = (x[None].expand(n, *x.shape).contiguous() for x in (depth, mask))
    return shadows_cuda.ray_march_min_distance_cuda(depth, mask, light_points.float().contiguous(), cfg)


def sample_distance_at_batch(depth, mask, light_point, t_map, cfg: RenderConfig,
                            veto: Optional[str] = None) -> torch.Tensor:
    """Point-to-line distance of each pixel's depth sample at its own offset.

    (B, H, W) depth, mask and t_map, (B, 3) light points -> (B, H, W)
    distances, 1e6 where the veto (one of VETOES; by default the config's)
    rejects the sample; no gate bias, no cull. Differentiable in depth and
    light_point.
    """
    scene = _Scene(depth, mask, light_point, cfg, veto)
    return scene.distance(scene.sample_n2(t_map.float()[:, None])[:, 0])


def sample_distance_at(depth, mask, light_point, t, cfg: RenderConfig) -> torch.Tensor:
    """Single image: depth, mask (H, W), light_point (3,), t scalar or (H, W) -> (H, W)."""
    t = torch.as_tensor(t, dtype=torch.float32, device=depth.device).expand(depth.shape)
    return sample_distance_at_batch(depth[None], mask[None], light_point[None], t[None], cfg)[0]


def march_vjp(depth, mask, light_point, t_star, grad, cfg: RenderConfig):
    """(d_depth, d_light): the march's VJP, taken at each pixel's winning sample.

    The gradient of a min is the gradient of its winner, so this is
    torch.autograd.grad of sample_distance_at_batch at t* (the JAX package's
    `_vjp_bwd`, shadows_pallas.py:776-808, in its gather form). It runs
    through the border endpoints into the light point, and through BC and
    the denominator into the pixel's own depth. The winning sample is vetoed
    one-hot whatever veto the forward marched under, as `_vjp_bwd` vetoes it
    (its evaluator `sample_distance_at_matmul`, shadows.py:257-259 of the
    JAX package). A vetoed sample reads the constant 1e6 and gets no
    gradient; nor does a culled pixel, whose output is the constant
    sentinel; the gate bias is a constant too. The mask gets no gradient.
    `grad` is the (B, H, W) cotangent of the march's output.
    """
    if cfg.shadow_mask_cull:
        grad = torch.where(_live_pixels(mask, cfg), grad, 0.0)
    with torch.enable_grad():
        d = depth.detach().float().requires_grad_()
        lp = light_point.detach().float().requires_grad_()
        dist = sample_distance_at_batch(d, mask, lp, t_star, cfg, veto="onehot")
        return torch.autograd.grad(dist, (d, lp), grad)


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


def _block_sum(x: torch.Tensor) -> torch.Tensor:
    """(B, H/s, s, W/s, s) -> (B, H/s, W/s): each block summed in a stated order.

    Row by row, left to right, from the block's first element: s^2 - 1
    elementwise adds, so the CUDA staging (csrc/march.cu stage_kernel) adds
    the same floats in the same order and pools bit for bit (a reduction's
    order is the library's to choose).
    """
    s = x.shape[2]
    acc = x[:, :, 0, :, 0]
    for i in range(s):
        for j in range(s):
            if i or j:
                acc = acc + x[:, :, i, :, j]
    return acc


def scale_march_inputs(depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig):
    """Pool (depth, mask) s x s and scale the light for the draft march.

    Returns (depth/s pooled (B, H/s, W/s), majority-pooled {0,1} mask, the
    scaled light (B, 3), the scaled RenderConfig). The depth is the mean of
    a block's on-face pixels, or of all of them where none is on face; each
    block's sums run in `_block_sum`'s order, then divide as written here.
    The pooled grid's centred coordinates sit (s-1)/(2s) from the scaled
    scene, so the light shifts by that much: minus in x, plus in the flipped
    y. (On CUDA tensors PyTorch divides by a Python number as a product with
    its reciprocal; for the draft scales, powers of two, that is the same
    float as the division the kernel and the CPU make.)
    """
    s = cfg.shadow_resolution_scale
    b, h, w = depth.shape
    blocks = depth.reshape(b, h // s, s, w // s, s)
    on = (mask != 0).to(depth.dtype).reshape(b, h // s, s, w // s, s)
    on_count = _block_sum(on)
    face_mean = _block_sum(blocks * on) / torch.clamp(on_count, min=1.0)
    depth_h = torch.where(on_count > 0, face_mean, _block_sum(blocks) / (s * s)) / s
    mask_h = (on_count >= (s * s) / 2.0).to(depth.dtype)
    off = (s - 1.0) / (2.0 * s)
    light_h = torch.stack(
        [light_point[:, 0] / s - off, light_point[:, 1] / s + off, light_point[:, 2] / s], dim=-1
    )
    return depth_h, mask_h, light_h, scaled_render_cfg(cfg)


class Staged(NamedTuple):
    """A march's staged inputs (csrc/march.cu stage_kernel writes them on the card).

    quad: (B, H/s + 1, W/s + 1, 2) float32, the march's depth and 0/1 mask
    (pooled at s > 1) interleaved and padded with a replicated first row and
    column; flags: uint8 (B, ceil(H/s/8), W/s/C) cull units of the march's
    grid holding face, or None; at s > 1 also full: the same padding at full
    resolution (the refine's input), full_flags: its cull units
    (B, ceil(H/8), W/C_full) or None, light: the scaled light (B, 3). s is
    cfg.shadow_resolution_scale; C and C_full the cull chunks of the scaled
    and the full config.
    """

    quad: torch.Tensor
    flags: Optional[torch.Tensor]
    full: Optional[torch.Tensor] = None
    full_flags: Optional[torch.Tensor] = None
    light: Optional[torch.Tensor] = None


def pad_quad(depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, H, W) depth and mask -> (B, H + 1, W + 1, 2): padded (y, x) holds
    (depth, mask != 0) at (max(y - 1, 0), max(x - 1, 0))."""
    both = torch.stack((depth.float(), (mask != 0).float()), dim=1)
    return F.pad(both, (1, 0, 1, 0), mode="replicate").permute(0, 2, 3, 1).contiguous()


def unpad_quad(quad: torch.Tensor) -> tuple:
    """pad_quad's inverse: (B, H + 1, W + 1, 2) -> (depth, mask), each (B, H, W)
    and contiguous, in one copy."""
    depth, mask = quad[:, 1:, 1:].permute(3, 0, 1, 2).contiguous()
    return depth, mask


def _cull_flags(mask: torch.Tensor, cfg: RenderConfig) -> Optional[torch.Tensor]:
    if not cfg.shadow_mask_cull:
        return None
    return cull_live_blocks(mask, effective_col_chunk(cfg)).to(torch.uint8)


def stage_inputs(depth: torch.Tensor, mask: torch.Tensor, light_point: torch.Tensor, cfg: RenderConfig) -> Staged:
    """The plain version of the kernels' staging: what one march (at s > 1,
    the draft tier's whole march: K2 and K3) reads. Flags where the config
    culls."""
    if cfg.shadow_resolution_scale == 1:
        return Staged(pad_quad(depth, mask), _cull_flags(mask, cfg))
    m_depth, m_mask, m_light, m_cfg = scale_march_inputs(depth, mask, light_point, cfg)
    return Staged(pad_quad(m_depth, m_mask), _cull_flags(m_mask, m_cfg), pad_quad(depth, mask),
                  _cull_flags(mask, cfg), m_light)


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
    cull and gate of the march. Any veto, as the configuration resolves.
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
