"""The arithmetic of the march kernels' design (csrc/march.cu), on the CPU.

K1-K3 run only on the card, where tests/test_torch_cuda.py holds them bit for
bit to their plain versions. Their sample evaluator rests on rules that can
be checked here, on a numpy / PyTorch transcription of the kernel's steps:
  * floor, ceil and rint with no conversion-unit instruction: x + 1.5 * 2^23,
    rounded toward -inf, +inf or to nearest, lies on the integer grid, and
    its bit pattern less 0x4B400000 is the integer. The directed adds are
    emulated exactly (the float64 sum, then the float32 neighbour on the
    side the exact residual asks for). Equal to np.floor / np.ceil / np.rint
    on every float32 of a few dense ranges and on +-1 ulp around every
    integer and half of [-1, 257];
  * one tap quad per sample, depth and mask interleaved and padded with a
    replicated first row and column (the kernel's input staging), the quad's
    address computed from the rounding adds' bit patterns modulo 2^32, the
    one-hot veto's tap selected from the quad (no load of its own), the
    bilinear veto's taps the quad's: the kernel's sample evaluator (kernel_sample_n2)
    equals the plain `_Scene.sample_n2` bit for bit, both vetoes, on rays
    that hypothesis draws, with lights on the image border, at integer
    points inside it and far outside, integer spans stepped by t_step 0.005,
    and t at 0 and 1. The quad's indices stay in the image and the one-hot
    tap is always one of its corners;
  * K3 around K2's winners: the centre ts[idx[b, row / s, col / s]] is
    upsample_tstar_nn(ts[idx]); the new wrapper's plain version equals
    refine_min_distance_batch on the upsampled t* bit for bit, and, fed the
    JAX package's low-resolution winners, holds to its draft refine at the
    small draft shape of tests/test_torch_draft.py (its bars);
  * the in-kernel cull (each 8 x 32 block flags the cull units it meets from
    their mask) equals cull_live_blocks at column chunks 16, 32, 64 and the
    row.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.ops import shadows as TS
from geomconsistentfr_torch.ops import shadows_cuda
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.ops import shadows as JS
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

ROUND = 12582912.0  # 1.5 * 2^23
ROUND_BITS = 0x4B400000
BLOCK_ROWS, BLOCK_COLS = 8, 32


# --------------------------------------------------------------------------- rounding adds


def round_add(x: torch.Tensor, mode: str) -> torch.Tensor:
    """float32 x + 1.5 * 2^23 rounded 'down', 'up' or to 'nearest' (even), as __fadd_rd/ru/rn.

    For |x| < 2^22 the exact sum's float32 neighbours are integers. The
    float64 sum may round, but the sign of (candidate - 1.5 * 2^23) - x is
    exact, so the neighbour on the right side is found exactly.
    """
    x64 = x.double()
    r = (x64 + ROUND).float()
    above = (r.double() - ROUND) > x64
    below = (r.double() - ROUND) < x64
    lo = torch.where(above, torch.nextafter(r, torch.tensor(-np.inf)), r)
    hi = torch.where(below, torch.nextafter(r, torch.tensor(np.inf)), r)
    if mode == "down":
        return lo
    if mode == "up":
        return hi
    d_lo = x64 - (lo.double() - ROUND)
    d_hi = (hi.double() - ROUND) - x64
    lo_even = (grid_int(lo) % 2) == 0
    return torch.where(d_lo < d_hi, lo, torch.where(d_hi < d_lo, hi, torch.where(lo_even, lo, hi)))


def grid_int(biased: torch.Tensor) -> torch.Tensor:
    """The integer a rounding add left on the grid: its bit pattern less 0x4B400000."""
    return biased.view(torch.int32).long() - ROUND_BITS


def float32_range(a: float, b: float) -> np.ndarray:
    """Every float32 in [a, b], both of one sign."""
    lo, hi = sorted((abs(a), abs(b)))
    bits = np.arange(np.float32(lo).view(np.int32), np.float32(hi).view(np.int32) + 1, dtype=np.int32)
    v = bits.view(np.float32)
    return v if a >= 0 else -v


def around_integers_and_halves() -> np.ndarray:
    """Every integer and half of [-1, 257] and its two float32 neighbours."""
    c = (np.arange(-2, 515) / 2.0).astype(np.float32)
    return np.concatenate([c, np.nextafter(c, np.float32(-np.inf)), np.nextafter(c, np.float32(np.inf))])


RANGES = {
    "[0.875,1]": (0.875, 1.0),
    "[-1,-0.875]": (-1.0, -0.875),
    "[127.5,128.5]": (127.5, 128.5),
    "[255,257]": (255.0, 257.0),
    "-1e-4": (-1.05e-4, -0.95e-4),
    "+1e-4": (0.95e-4, 1.05e-4),
    "[2^21-2,2^21+2]": (2.0 ** 21 - 2, 2.0 ** 21 + 2),
}


@pytest.mark.parametrize("name", [*RANGES, "integers_and_halves"])
def test_rounding_adds_are_floor_ceil_and_rint(name):
    x = float32_range(*RANGES[name]) if name in RANGES else around_integers_and_halves()
    t = torch.from_numpy(x)
    down, up, near = (round_add(t, m) for m in ("down", "up", "nearest"))
    x64 = x.astype(np.float64)
    for biased, want in ((down, np.floor(x64)), (up, np.ceil(x64)), (near, np.rint(x64))):
        # The float, as the kernel takes it (the sum less the constant), and the integer.
        np.testing.assert_array_equal((biased - ROUND).numpy().astype(np.float64), want)
        np.testing.assert_array_equal(grid_int(biased).numpy(), want.astype(np.int64))
    # rint is banker's rounding, as torch.round is.
    np.testing.assert_array_equal((near - ROUND).numpy(), torch.round(t).numpy())


# --------------------------------------------------------------------------- one tap quad


def stage(depth: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The kernels' input staging: (B, H + 1, W + 1, 2), padded (y, x) holding
    (depth, mask) at (max(y - 1, 0), max(x - 1, 0))."""
    both = torch.stack((depth.float(), mask.float()), dim=1)
    return F.pad(both, (1, 0, 1, 0), mode="replicate").permute(0, 2, 3, 1).contiguous()


U32 = 0xFFFFFFFF


def bits(x: torch.Tensor) -> torch.Tensor:
    """A float32's bit pattern as an unsigned 32-bit value (int64)."""
    return x.view(torch.int32).long() & U32


def kernel_sample_n2(scene: TS._Scene, mask: torch.Tensor, t: torch.Tensor):
    """sample_n2 as csrc/march.cu evaluates it: (norm^2 or 1e30, one-hot taps off the quad, quad indices in range).

    t is (1, C, 1, 1) or (B, C, H, W) in [0, 1]. Depth and mask are read
    from the staged array, four corners a sample: padded rows floor(yt) + 1
    and floor(yt) + 2, columns likewise, the first corner's index
    by * wp + bx + quad_bias modulo 2^32 (bx, by the bits of the rounding
    adds, wp = W + 1).
    """
    cfg, h, w = scene.cfg, scene.h, scene.w
    b = scene.depth_flat.shape[0]
    half_w, half_h = cfg.half_w, cfg.half_h
    sx = TS._fma(t, scene.diff_x, scene.xx)
    sy = TS._fma(t, scene.diff_y, scene.yy)
    xt = sx + half_w - TS.EPS
    yt = (half_h - sy) - TS.EPS

    bx0, by0 = round_add(xt, "down"), round_add(yt, "down")
    x0, y0 = bx0 - ROUND, by0 - ROUND
    x1, y1 = round_add(xt, "up") - ROUND, round_add(yt, "up") - ROUND
    wp = w + 1
    quad_bias = ((1 - ROUND_BITS) * (wp + 1)) & U32
    i00 = (bits(by0) * wp + bits(bx0) + quad_bias) & U32
    ix0, iy0 = grid_int(bx0), grid_int(by0)
    in_range = bool(torch.equal(i00, (iy0 + 1) * wp + ix0 + 1) and (ix0 >= -1).all() and (iy0 >= -1).all()
                    and (ix0 + 1 <= w - 1).all() and (iy0 + 1 <= h - 1).all())
    dm = stage(scene.depth_flat.view(b, h, w), mask).reshape(b, -1, 2)

    def corner(idx):
        idx = idx.clamp(0, (h + 1) * wp - 1)  # in range by the check above; the clamp keeps gather quiet
        flat = idx.reshape(b, -1)
        got = torch.gather(dm, 1, flat[..., None].expand(-1, -1, 2))
        return got[..., 0].view(idx.shape), got[..., 1].view(idx.shape)

    (d00, m00), (d01, m01) = corner(i00), corner(i00 + 1)
    (d10, m10), (d11, m11) = corner(i00 + wp), corner(i00 + wp + 1)

    off_quad = 0
    if scene.veto == "onehot":
        # dx = vx - floor(xt), dy = vy - floor(yt) from the bits, mod 2^32. The
        # kernel selects the tap from the quad and has no other load: the
        # rule needs dx and dy in {0, 1}, which off_quad counts against.
        rx, ry = bits(round_add(sx, "nearest")), bits(round_add(sy, "nearest"))
        dx = (rx - bits(bx0) + w // 2) & U32
        dy = ((h // 2 + 2 * ROUND_BITS) - ry - bits(by0)) & U32
        off_quad = int(((dx | dy) > 1).sum())
        face = torch.where(dy != 0, torch.where(dx != 0, m11, m10), torch.where(dx != 0, m01, m00)) != 0
    else:
        xtc, ytc = torch.clamp(xt, 0.0, w - 1.0), torch.clamp(yt, 0.0, h - 1.0)
        vx0, vy0 = torch.clamp(x0, min=0.0), torch.clamp(y0, min=0.0)
        ux0, ux1 = 1.0 - (xtc - vx0), 1.0 - ((vx0 + 1.0) - xtc)
        uy0, uy1 = 1.0 - (ytc - vy0), 1.0 - ((vy0 + 1.0) - ytc)
        zero = torch.zeros(())
        vtop = torch.where(m00 != 0, ux0, zero) + torch.where(m01 != 0, ux1, zero)
        vbot = torch.where(m10 != 0, ux0, zero) + torch.where(m11 != 0, ux1, zero)
        face = (vtop * uy0 + vbot * uy1) > 0.5

    wx0, wx1 = x1 - xt, xt - x0
    iu = d00 * wx0 + d01 * wx1
    il = d10 * wx0 + d11 * wx1
    d_interp = iu * (y1 - yt) + il * (yt - y0)
    ba_x = (xt - half_w) - scene.xx
    ba_y = (half_h - yt) - scene.yy
    ba_z = d_interp - scene.depth_px
    cx = ba_y * scene.bc_z - ba_z * scene.bc_y
    cy = ba_z * scene.bc_x - ba_x * scene.bc_z
    cz = ba_x * scene.bc_y - ba_y * scene.bc_x
    n2 = cx * cx + cy * cy + cz * cz
    return torch.where(face, n2, TS.OFF_FACE_N2), off_quad, in_range


def draw_scene(seed: int, size: int, b: int = 3):
    rng = np.random.default_rng(seed)
    depth = (rng.normal(size=(b, size, size)) * 25).astype(np.float32)
    depth[:, ::5, ::3] = np.round(depth[:, ::5, ::3])  # some integer depths
    yy, xx = np.mgrid[:size, :size]
    face = ((xx - 0.45 * size) / (0.35 * size)) ** 2 + ((yy - 0.55 * size) / (0.4 * size)) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(b, size, size)) > 0.1)).astype(np.float32)
    mask[:, :, 0] = mask[:, 0, :] = 1.0  # faces on the first column and row, where xt, yt may be < 0
    return torch.from_numpy(depth), torch.from_numpy(mask)


def light_points(kind: str, size: int, rng: np.random.Generator) -> np.ndarray:
    """Three light points of one kind, in the centred frame (x right, y up)."""
    half = size / 2.0
    left, right, bottom, top = -half, size - half - 1.0, 1.0 - half, half
    if kind == "border":
        pts = []
        for _ in range(3):
            if rng.random() < 0.5:
                x, y = rng.choice([left, right]), rng.integers(int(bottom), int(top) + 1)
            else:
                x, y = rng.integers(int(left), int(right) + 1), rng.choice([bottom, top])
            pts.append([x, y, rng.uniform(5.0, 60.0)])
        return np.asarray(pts, np.float32)
    elif kind == "inside_integer":
        xs, ys = rng.integers(int(left), int(right) + 1, 3), rng.integers(int(bottom), int(top) + 1, 3)
    else:
        d = rng.normal(size=(3, 3))
        d[:, 2] = np.abs(d[:, 2]) + 0.3
        return (4013.0 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return np.stack([xs, ys, rng.uniform(5.0, 60.0, 3)], axis=1).astype(np.float32)


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 16), size=st.sampled_from([32, 64]),
       kind=st.sampled_from(["border", "inside_integer", "far"]), veto=st.sampled_from(["onehot", "bilinear"]),
       first=st.integers(0, 177), per_pixel=st.booleans())
def test_quad_and_select_equal_the_direct_taps(seed, size, kind, veto, first, per_pixel):
    rng = np.random.default_rng(seed)
    depth, mask = draw_scene(seed, size)
    light = torch.from_numpy(light_points(kind, size, rng))
    cfg = TC.RenderConfig(img_height=size, img_width=size, shadow_mask_gather=veto)
    scene = TS._Scene(depth, mask, light, cfg)
    if per_pixel:  # K3's per-pixel centres: t anywhere in [0, 1], its ends included
        t = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 4, size, size)).astype(np.float32))
        t[:, 0, ::7] = 0.0
        t[:, 1, ::5] = 1.0
    else:  # the t grid stepped by 0.005: integer spans land on exact halves
        t = torch.from_numpy((0.005 * np.arange(first, first + 24)).astype(np.float32)).view(1, -1, 1, 1)
    got, off_quad, in_range = kernel_sample_n2(scene, mask, t)
    want = scene.sample_n2(t)
    assert in_range
    assert off_quad == 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_quad_covers_the_first_column_and_row():
    """Pixels of the left column and top row marching straight along the border:
    xt (yt) = -1e-4, where floor is -1, the quad's first column (row) is the
    clamped 0 and the bilinear veto's second is 1, with weight 0."""
    depth, mask = draw_scene(3, 32)
    for light in ([-16.0, 5.0, 30.0], [3.0, 16.0, 30.0]):  # on the left border / on the top border
        lp = torch.tensor([light] * 3, dtype=torch.float32)
        for veto in ("onehot", "bilinear"):
            cfg = TC.RenderConfig(img_height=32, img_width=32, shadow_mask_gather=veto)
            scene = TS._Scene(depth, mask, lp, cfg)
            t = torch.from_numpy(TS.sample_ts(cfg).astype(np.float32)).view(1, -1, 1, 1)
            xt = TS._fma(t, scene.diff_x, scene.xx) + cfg.half_w - TS.EPS
            yt = (cfg.half_h - TS._fma(t, scene.diff_y, scene.yy)) - TS.EPS
            assert bool(((xt < 0) | (yt < 0)).any())
            got, off_quad, in_range = kernel_sample_n2(scene, mask, t)
            assert in_range and off_quad == 0
            assert torch.equal(got.view(torch.int32), scene.sample_n2(t).view(torch.int32))


# --------------------------------------------------------------------------- K3 around K2's winners


DRAFT = dict(img_height=64, img_width=64, shadow_resolution_scale=4, shadow_refine_halfwidth=4,
             shadow_lowres_t_stride=2, num_sample_points=32, t_start=0.025, t_stop=0.185, march_chunk=32)
VARIANTS = {
    "plain": dict(),
    "cull_col16_wide": dict(shadow_mask_cull=True, shadow_col_chunk=16, shadow_bias_gate="wide"),
    "cull_row_inside": dict(shadow_mask_cull=True, shadow_bias_gate="inside_image"),
}


def draft_scene(seed):
    depth, mask = draw_scene(seed, 64, b=4)
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(4, 3))
    d[:, 2] = np.abs(d[:, 2]) + 0.4
    light = torch.from_numpy((4013.0 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    return depth, mask, light


def kernel_centre(idx: torch.Tensor, ts: torch.Tensor, h: int, w: int, s: int) -> torch.Tensor:
    """K3's prologue: centre_ts[centre_idx[b * (h/s) * (w/s) + (row/s) * (w/s) + col/s]]."""
    b = idx.shape[0]
    row = torch.arange(h).view(1, h, 1)
    col = torch.arange(w).view(1, 1, w)
    lw = w // s
    flat = torch.arange(b).view(b, 1, 1) * (h // s) * lw + (row // s) * lw + col // s
    return ts[idx.reshape(-1).long()[flat]]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_refine_around_argmin_is_the_refine_on_the_upsampled_tstar(variant):
    depth, mask, light = draft_scene(20)
    cfg = TC.RenderConfig(**DRAFT, **VARIANTS[variant])
    m_depth, m_mask, m_light, m_cfg = TS.scale_march_inputs(depth, mask, light, cfg)
    ts = torch.from_numpy(TS.sample_ts(m_cfg).astype(np.float32))
    _, idx = TS.ray_march_argmin_batch(m_depth, m_mask, m_light, m_cfg, ts)
    t_map = TS.upsample_tstar_nn(ts[idx.long()], cfg)
    assert torch.equal(kernel_centre(idx, ts, 64, 64, 4), t_map)
    want = TS.refine_min_distance_batch(depth, mask, light, t_map, cfg)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, ts, cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    offsets = TS.refine_offsets(cfg)[1:6]
    assert torch.equal(shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, ts, cfg, offsets),
                       TS.refine_min_distance_batch(depth, mask, light, t_map, cfg, offsets))
    assert shadows_cuda.LAUNCHES == before


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_draft_march_is_pool_argmin_and_refine(variant):
    """draft_march, the draft path's pool -> K2 -> K3, on CPU tensors: the plain
    refine around the pooled argmin march's upsampled t*, bit for bit, and
    what render's draft branch returns; it counts no launch."""
    from geomconsistentfr_torch.render import shadow_min_distance

    depth, mask, light = draft_scene(23)
    cfg = TC.RenderConfig(**DRAFT, **VARIANTS[variant])
    m_depth, m_mask, m_light, m_cfg = TS.scale_march_inputs(depth, mask, light, cfg)
    _, t_star = TS.ray_march_min_distance_batch(m_depth, m_mask, m_light, m_cfg, return_argmin_t=True)
    want = TS.refine_min_distance_batch(depth, mask, light, TS.upsample_tstar_nn(t_star, cfg), cfg)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.draft_march(depth, mask, light, cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(shadow_min_distance(depth, mask, light, cfg).view(torch.int32), want.view(torch.int32))
    assert shadows_cuda.LAUNCHES == before
    for bad in (dict(shadow_refine_halfwidth=0), dict(shadow_resolution_scale=1)):
        bad_cfg = dataclasses.replace(cfg, shadow_lowres_t_stride=1, **bad)
        with pytest.raises(ValueError):
            shadows_cuda.draft_march(depth, mask, light, bad_cfg)
    with pytest.raises(NotImplementedError):
        shadows_cuda.draft_march(depth.clone().requires_grad_(), mask, light, cfg)


def assert_march_close(got, want, agree=0.9999):
    big_w, big_g = want >= 1e5, got >= 1e5
    assert (big_w == big_g).mean() >= agree
    diff = np.abs(got - want)[~(big_w | big_g)]
    assert np.quantile(diff, 0.9999) < 1e-3, float(diff.max())
    assert diff.mean() < 1e-4, float(diff.mean())


def smooth_scene(seed, b=4, size=64):
    """tests/test_torch_draft.py's kind of scene: cosine terrain plus noise, an oval face with holes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    depth = np.zeros((b, size, size), np.float32)
    for i in range(b):
        for _ in range(6):
            fx, fy = rng.uniform(0.5, 3.0, 2)
            ph = rng.uniform(0, 2 * np.pi, 2)
            depth[i] += rng.uniform(5, 15) * np.cos(2 * np.pi * fx * xx / size + ph[0]) * np.cos(
                2 * np.pi * fy * yy / size + ph[1])
    depth += rng.normal(size=depth.shape).astype(np.float32)
    face = ((xx - 0.47 * size) / (0.31 * size)) ** 2 + ((yy - 0.53 * size) / (0.4 * size)) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(b, size, size)) > 0.03)).astype(np.float32)
    lights = np.asarray([[0.3, 0.4, 0.866], [-0.55, 0.2, 0.81], [0.7, -0.1, 0.7], [0.05, 0.9, 0.4]], np.float32)
    return depth, mask, lights[:b] * 4013.0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_refine_around_argmin_matches_jax_draft_refine(variant):
    """The refine around K2's index, fed the JAX package's own low-resolution
    winners (as an index into the float32 table), against JAX's draft refine
    around the same winners upsampled, at tests/test_torch_draft.py's bars."""
    depth, mask, lights = smooth_scene(21)
    mask[2, :, 48:] = 0.0
    kw = dict(DRAFT, **VARIANTS[variant])
    tcfg, jcfg = TC.RenderConfig(**kw), JC.RenderConfig(**kw)
    j_in = [jnp.asarray(a) for a in (depth, mask, lights)]
    dh, mh, lh, ch = JS.scale_march_inputs(*j_in, jcfg)
    _, t_star = JS.ray_march_min_distance_batch(dh, mh, lh, ch, return_argmin_t=True)
    want = np.asarray(JS.refine_min_distance_batch(*j_in, JS.upsample_tstar_nn(t_star, jcfg), jcfg))
    ts = JS.sample_ts(ch).astype(np.float32)
    idx = np.searchsorted(ts, np.asarray(t_star)).astype(np.int32)
    np.testing.assert_array_equal(ts[idx], np.asarray(t_star))
    got = shadows_cuda.refine_around_argmin_cuda(*(torch.from_numpy(a) for a in (depth, mask, lights)),
                                                 torch.from_numpy(idx), torch.from_numpy(ts), tcfg)
    assert_march_close(got.numpy(), want)


def test_wrappers_refuse_tables_outside_the_unit_interval():
    depth, mask, light = draft_scene(22)
    cfg = TC.RenderConfig(**DRAFT)
    with pytest.raises(ValueError):
        shadows_cuda._ts_for(torch.device("cpu"), cfg, np.array([0.1, 1.5], np.float32))
    with pytest.raises(ValueError):
        shadows_cuda._ts_for(torch.device("cpu"), cfg, torch.tensor([-0.01, 0.2]))
    with pytest.raises(ValueError):
        shadows_cuda._ts_for(torch.device("cpu"), cfg, torch.tensor([0.1, float("nan")]))
    ts = shadows_cuda._ts_for(torch.device("cpu"), cfg, torch.tensor([0.0, 0.5, 1.0]))
    assert ts.dtype == torch.float32 and ts.tolist() == [0.0, 0.5, 1.0]
    with pytest.raises(NotImplementedError):
        shadows_cuda.refine_around_argmin_cuda(depth.clone().requires_grad_(), mask, light,
                                               torch.zeros((4, 16, 16), dtype=torch.int32), ts, cfg)


# --------------------------------------------------------------------------- the in-kernel cull


def kernel_live(mask: torch.Tensor, chunk: int) -> torch.Tensor:
    """(B, H, W) bool: the kernel's cull, block by block (8 rows x 32 columns).

    A block flags each cull unit it meets (col0 // chunk up to the unit of
    its last column) from that unit's 8 x chunk mask, and a pixel is live
    where its own unit's flag is set.
    """
    b, h, w = mask.shape
    live = torch.zeros((b, h, w), dtype=torch.bool)
    for g in range(h // BLOCK_ROWS):
        rows = mask[:, g * BLOCK_ROWS:(g + 1) * BLOCK_ROWS]
        for col0 in range(0, w, BLOCK_COLS):
            u_first = col0 // chunk
            n_units = (min(col0 + BLOCK_COLS, w) - 1) // chunk + 1 - u_first
            flags = torch.zeros((b, BLOCK_COLS), dtype=torch.bool)
            for u in range(n_units):
                unit = rows[:, :, (u_first + u) * chunk:(u_first + u + 1) * chunk]
                flags[:, u] = (unit != 0).flatten(1).any(dim=1)
            for col in range(col0, min(col0 + BLOCK_COLS, w)):
                live[:, g * BLOCK_ROWS:(g + 1) * BLOCK_ROWS, col] = flags[:, col // chunk - u_first, None]
    return live


@pytest.mark.parametrize("chunk", [16, 32, 64, 0], ids=["col16", "col32", "col64", "row"])
def test_in_kernel_cull_is_cull_live_blocks(chunk):
    rng = np.random.default_rng(chunk)
    size = 128
    mask = np.zeros((3, size, size), np.float32)
    for i in range(3):  # sparse faces: a few small patches, and single pixels on unit edges
        for _ in range(4):
            y, x = rng.integers(0, size - 6, 2)
            mask[i, y:y + rng.integers(1, 6), x:x + rng.integers(1, 6)] = 1.0
        mask[i, rng.integers(0, size), 63] = mask[i, rng.integers(0, size), 64] = 2.5
    mask[2] = 0.0
    mask[2, 17, 127] = -1.0  # any nonzero is face
    cfg = TC.RenderConfig(img_height=size, img_width=size, shadow_mask_cull=True, shadow_col_chunk=chunk)
    c = TS.effective_col_chunk(cfg)
    m = torch.from_numpy(mask)
    want = TS.cull_live_blocks(m, c).repeat_interleave(8, dim=1).repeat_interleave(c, dim=2)
    assert torch.equal(kernel_live(m, c), want)
    assert torch.equal(want, TS._live_pixels(m, cfg))


def test_the_staging_pads_and_interleaves_depth_and_mask():
    """stage_kernel's rule, as the transcription above reads it: padded
    (y, x) is (depth, mask) at (max(y - 1, 0), max(x - 1, 0)); and a t grid
    outside [0, 1] is refused."""
    depth, mask = draw_scene(5, 32)
    staged = stage(depth, mask)
    assert staged.shape == (3, 33, 33, 2) and staged.is_contiguous()
    ys = torch.clamp(torch.arange(33) - 1, min=0)
    assert torch.equal(staged[..., 0], depth[:, ys][:, :, ys]) and torch.equal(staged[..., 1], mask[:, ys][:, :, ys])
    cfg = dataclasses.replace(TC.RenderConfig(img_height=32, img_width=32), t_stop=1.2, num_sample_points=235)
    with pytest.raises(ValueError):
        shadows_cuda._ts_for(torch.device("cpu"), cfg)
