"""The renderer of GeomConsistentFR in plain PyTorch (float32; any float dtype runs).

A frozen statement of `test_relight_single_image.py`'s rendering (lines
326-505 of the reference script): normals from the offset depth through the
camera intrinsics (kornia 0.4.1's `depth_to_normals`, y negated), the
clamped Lambertian term toward a point light at `light_distance` along the
unit direction, and a hard cast shadow from a ray march. For each pixel the
march walks the 2-D segment from the pixel toward the light, clipped at the
image border, samples the depth map bilinearly at every t of the config's
grid, and takes the smallest 3-D distance between the sample and the
pixel-to-light ray; a sample whose rounded position is off the face counts
1e6. The soft weight is 1 - 4e^-d / (1 + e^-d)^2, and the render is
albedo * (w * (ambient + directional) + (1 - w) * ambient).

Every pixel is marched (no cull), one operation at a time, in chunks of
samples so that the temporaries fit. `rcfg` is the config file's `render`
group, a dict.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-4
OFF_FACE = 1.0e6


def normalize(x, dim=-1):
    return x / torch.clamp(torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True)), min=1e-12)


def depth_to_normals(depth, f, cx, cy):
    """(B, H, W) depth -> (B, H, W, 3) unit normals (kornia 0.4.1)."""
    b, h, w = depth.shape
    u = torch.arange(w, device=depth.device, dtype=depth.dtype)
    v = torch.arange(h, device=depth.device, dtype=depth.dtype)
    ray = torch.stack(torch.broadcast_tensors((u[None, :] - cx) / f, (v[:, None] - cy) / f,
                                              torch.ones((1, 1), device=depth.device, dtype=depth.dtype)), dim=-1)
    points = (normalize(ray) * depth[..., None]).permute(0, 3, 1, 2).reshape(b * 3, 1, h, w)
    sobel_x = torch.tensor([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]], device=depth.device,
                           dtype=depth.dtype) / 8.0
    kernel = torch.stack([sobel_x, sobel_x.t()])[:, None]
    grads = F.conv2d(F.pad(points, (1, 1, 1, 1), mode="replicate"), kernel).view(b, 3, 2, h, w)
    gx = grads[:, :, 0].permute(0, 2, 3, 1)
    gy = grads[:, :, 1].permute(0, 2, 3, 1)
    return normalize(torch.linalg.cross(gx, gy, dim=-1))


def sample_ts(rcfg) -> np.ndarray:
    ts = np.arange(rcfg["t_start"], rcfg["t_stop"], rcfg["t_step"])
    assert ts.shape[0] == rcfg["num_sample_points"], ts.shape
    return ts.astype(np.float32)


def endpoints(xx, yy, lx, ly, h, w):
    """Where each pixel's ray toward the light leaves the image (reference :363-442)."""
    left, right, bottom, top = -w / 2.0, w - w / 2.0 - 1.0, 1.0 - h / 2.0, h / 2.0
    slope = (ly - yy) / (lx - xx + EPS)
    icpt = ly - slope * lx
    x_side = torch.where(lx < left, left, right)
    y_on_side = slope * x_side + icpt
    y_side = torch.where(ly < bottom, bottom, top)
    x_on_top = (y_side - icpt) / (slope + EPS)
    x_in = (lx >= left) & (lx <= right)
    y_in = (ly >= bottom) & (ly <= top)
    crosses_top = (x_on_top >= left) & (x_on_top <= right)
    ex = torch.where(x_in & y_in, lx, torch.where(y_in, x_side, torch.where(x_in | crosses_top, x_on_top, x_side)))
    ey = torch.where(x_in & y_in, ly, torch.where(y_in, y_on_side, torch.where(x_in | crosses_top, y_side, y_on_side)))
    return torch.clamp(ex, left, right), torch.clamp(ey, bottom, top)


def gate_bias(lx, ly, rcfg, h, w):
    """The +bias of the reference's light gate, per image (B, 1, 1)."""
    gate = rcfg["shadow_bias_gate"]
    if gate == "none":
        return torch.zeros_like(lx)
    if gate == "inside_image":
        lo_x, hi_x, lo_y, hi_y = -w / 2.0, w - w / 2.0 - 1.0, 1.0 - h / 2.0, h / 2.0
    else:  # 'wide'
        lo_x, hi_x, lo_y, hi_y = -4.0 * w, 4.0 * w, 4.0 * (1.0 - h), 4.0 * h
    inside = (lx >= lo_x) & (lx <= hi_x) & (ly >= lo_y) & (ly <= hi_y)
    return torch.where(inside, rcfg["shadow_bias"], 0.0)


def min_distance(depth, mask, light_point, rcfg, chunk: int = 16):
    """(B, H, W) smallest point-to-ray distance over the t grid, plus the gate's bias.

    The face test is the indicator at the banker's-rounded sample (torch.round
    rounds half to even, as the reference's does); the depth is read
    bilinearly at the sample shifted by -1e-4, and the sample's xy keep the
    shift, as in the reference. Differentiable (autograd of the min).
    """
    b, h, w = depth.shape
    hw, hh = w / 2.0, h / 2.0
    dev = depth.device
    xx = (torch.arange(w, device=dev, dtype=depth.dtype) - hw)[None, None, None, :]
    yy = (hh - torch.arange(h, device=dev, dtype=depth.dtype))[None, None, :, None]
    lx, ly, lz = (light_point[:, i].view(b, 1, 1, 1) for i in range(3))
    ex, ey = endpoints(xx, yy, lx, ly, h, w)
    dx, dy = ex - xx, ey - yy
    bc_x, bc_y, bc_z = lx - xx, ly - yy, lz - depth[:, None]
    denom = torch.sqrt(bc_x * bc_x + bc_y * bc_y + bc_z * bc_z + EPS)
    on_face = (mask != 0).float().reshape(b, 1, h * w)
    flat = depth.reshape(b, 1, h * w)

    def gather(src, iy, ix):
        iy = torch.clamp(iy, 0, h - 1).long()
        ix = torch.clamp(ix, 0, w - 1).long()
        idx = (iy * w + ix).expand(b, -1, -1, -1)
        return torch.gather(src.expand(b, idx.shape[1], h * w), 2, idx.reshape(b, idx.shape[1], -1)).view(idx.shape)

    ts = torch.as_tensor(sample_ts(rcfg), device=dev).to(depth.dtype)
    best = None
    for t in ts.split(chunk):
        t = t.view(1, -1, 1, 1)
        sx = xx + t * dx
        sy = yy + t * dy
        face = gather(on_face, hh - torch.round(sy), torch.round(sx) + hw) != 0
        xt = sx + hw - EPS
        yt = (hh - sy) - EPS
        x0, x1, y0, y1 = torch.floor(xt), torch.ceil(xt), torch.floor(yt), torch.ceil(yt)
        top = gather(flat, y0, x0) * (x1 - xt) + gather(flat, y0, x1) * (xt - x0)
        bot = gather(flat, y1, x0) * (x1 - xt) + gather(flat, y1, x1) * (xt - x0)
        d = top * (y1 - yt) + bot * (yt - y0)
        ba_x = (xt - hw) - xx
        ba_y = (hh - yt) - yy
        ba_z = d - depth[:, None]
        cx = ba_y * bc_z - ba_z * bc_y
        cy = ba_z * bc_x - ba_x * bc_z
        cz = ba_x * bc_y - ba_y * bc_x
        dist = torch.sqrt(cx * cx + cy * cy + cz * cz + EPS) / denom
        dist = torch.where(face, dist, OFF_FACE).amin(dim=1)
        best = dist if best is None else torch.minimum(best, dist)
    return best + gate_bias(lx[:, 0], ly[:, 0], rcfg, h, w)


def render(albedo, depth, lighting, mask, rcfg, target_light=None, target_ambient=None):
    """dict of the render's maps: rendered (B, H, W, 3), shadow, final_shading, normals,
    and the light and ambient used (B, 3), (B,)."""
    b, h, w = depth.shape
    f = rcfg["focal_length"]
    z = torch.clamp(lighting[:, 3], min=rcfg["z_clamp_min"])
    est_dir = normalize(torch.stack([lighting[:, 1], lighting[:, 2], z], dim=-1))
    unit = normalize(target_light) if rcfg["lighting_mode"] == "target" else est_dir
    ambient = {"estimated": lighting[:, 0], "estimated_minus_0.1": lighting[:, 0] - 0.1,
               "target": target_ambient}[rcfg["ambient_mode"]]
    normals = depth_to_normals(depth + rcfg["depth_offset"], f, w / 2.0, h / 2.0)
    normals = normals * torch.tensor([1.0, -1.0, 1.0], device=depth.device, dtype=depth.dtype)
    xx = (torch.arange(w, device=depth.device, dtype=depth.dtype) - w / 2.0)[None, None, :]
    yy = (h / 2.0 - torch.arange(h, device=depth.device, dtype=depth.dtype))[None, :, None]
    points = torch.stack(torch.broadcast_tensors(xx, yy, depth), dim=-1)
    light = rcfg["light_distance"] * unit
    incident = normalize(light[:, None, None, :] - points)
    directional = rcfg["directional_intensity"] * torch.clamp((normals * incident).sum(-1), min=0.0)
    amb = ambient[:, None, None].expand(b, h, w)
    md = min_distance(depth, mask, light, rcfg)
    e = torch.exp(-md)
    shadow = 1.0 - 4.0 * e / torch.square(1.0 + e)
    final = shadow * (amb + directional) + (1.0 - shadow) * amb
    return {"rendered": albedo * final[..., None], "shadow": shadow, "final_shading": final,
            "normals": normals, "unit_light": unit, "ambient": ambient}


def to_u8(x):
    """floor(clip(x * 255)) as uint8."""
    return torch.floor(torch.clamp(x * 255.0, 0.0, 255.0)).to(torch.uint8)


def visual_pack(albedo, depth, out, mask):
    """The twelve uint8 channels of a batch job's visuals: rendered, shadow, albedo,
    depth (near bright, min-max over the image), shading, normals; each masked."""
    m = mask[..., None]
    d = -depth
    lo = d.amin(dim=(1, 2), keepdim=True)
    hi = d.amax(dim=(1, 2), keepdim=True)
    depth_vis = (d - lo) / torch.clamp(hi - lo, min=1e-12)
    return to_u8(torch.cat([out["rendered"] * m, (out["shadow"] * mask)[..., None], albedo * m,
                            (depth_vis * mask)[..., None], (out["final_shading"] * mask)[..., None],
                            (out["normals"] + 1.0) / 2.0 * m], dim=-1))
