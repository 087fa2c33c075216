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
    bilinear veto's taps the quad's, the 'hat' veto's the one-hot tap's row
    of the quad and 'hat_y''s its column: the kernel's sample evaluator
    (kernel_sample_n2) equals the plain `_Scene.sample_n2` bit for bit, all
    four vetoes, on rays that hypothesis draws, with lights on the image
    border, at integer points inside it and far outside, integer spans
    stepped by t_step 0.005 (the rounding's exact halves), t at 0 and 1, and
    per-pixel t that put the hat weights' coordinate on an exact half (the
    threshold's tie). The quad's indices stay in the image and the one-hot
    tap is always one of its corners; for t outside [0, 1], and from
    W - 1 = 2048 on, they do not, which is where the wrappers launch the
    kernels' clamped taps;
  * K3 around K2's winners: the centre ts[idx[b, row / s, col / s]] is
    upsample_tstar_nn(ts[idx]); the new wrapper's plain version equals
    refine_min_distance_batch on the upsampled t* bit for bit, and, fed the
    JAX package's low-resolution winners, holds to its draft refine at the
    small draft shape of tests/test_torch_draft.py (its bars);
  * march_grad's taps (the forward's quad and veto, the ceil tap taken as
    the floor tap where xt or yt is an integer, the atomics' addresses from
    the rounding adds' bits) are the plain march_vjp's taps, indices, veto
    and position term, on hypothesis-drawn rays and at integer coordinates;
    its derivative of the border endpoint in the light point is float64
    autograd's within 1e-5, also where a far light stands over a column;
  * K2's lanes: interleaved samples of the table, each lane's strict-< first
    winner, combined on (norm^2, index), give the table's first winner,
    ties included;
  * the in-kernel cull (each 8 x 32 block flags the cull units it meets from
    their mask) equals cull_live_blocks at column chunks 16, 32, 64 and the
    row, and at chunks that are no power of two (24, 40, 48) and heights
    that are no multiple of 8 (the last row group short).
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
from geomconsistentfr_torch.ops import cuda_lib, shadows_cuda
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
    """The kernels' input staging at full resolution, its plain version:
    (B, H + 1, W + 1, 2), padded (y, x) holding (depth, mask != 0) at
    (max(y - 1, 0), max(x - 1, 0))."""
    return TS.pad_quad(depth, mask)


U32 = 0xFFFFFFFF


def bits(x: torch.Tensor) -> torch.Tensor:
    """A float32's bit pattern as an unsigned 32-bit value (int64)."""
    return x.view(torch.int32).long() & U32


def kernel_taps(scene: TS._Scene, mask: torch.Tensor, t: torch.Tensor) -> dict:
    """sample_taps as csrc/march.cu evaluates it, for the march and march_grad alike.

    t is (1, C, 1, 1) or (B, C, H, W) in [0, 1]. Depth and mask are read
    from the staged array, four corners a sample: padded rows floor(yt) + 1
    and floor(yt) + 2, columns likewise, the first corner's index
    by * wp + bx + quad_bias modulo 2^32 (bx, by the bits of the rounding
    adds, wp = W + 1). Returns the coordinates, the rounding adds, the
    quad's (depth, mask) corners, the veto, the count of one-hot taps off the
    quad and whether the quad's indices stay in range.
    """
    cfg, h, w = scene.cfg, scene.h, scene.w
    b = scene.depth_flat.shape[0]
    half_w, half_h = cfg.half_w, cfg.half_h
    sx = TS._fma(t, scene.diff_x, scene.xx)
    sy = TS._fma(t, scene.diff_y, scene.yy)
    xt = sx + half_w - TS.EPS
    yt = (half_h - sy) - TS.EPS

    bx0, by0 = round_add(xt, "down"), round_add(yt, "down")
    bx1, by1 = round_add(xt, "up"), round_add(yt, "up")
    x0, y0, x1, y1 = bx0 - ROUND, by0 - ROUND, bx1 - ROUND, by1 - ROUND
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
    zero = torch.zeros(())
    if scene.veto != "bilinear":
        # dx = vx - floor(xt), dy = vy - floor(yt) from the bits, mod 2^32. The
        # kernel selects the one-hot tap (its row for 'hat', its column for
        # 'hat_y') from the quad and has no other load: the rule needs dx and
        # dy in {0, 1}, which off_quad counts against.
        rx, ry = bits(round_add(sx, "nearest")), bits(round_add(sy, "nearest"))
        dx = (rx - bits(bx0) + w // 2) & U32
        dy = ((h // 2 + 2 * ROUND_BITS) - ry - bits(by0)) & U32
        off_quad = int(((dx | dy) > 1).sum())
    if scene.veto == "onehot":
        face = torch.where(dy != 0, torch.where(dx != 0, m11, m10), torch.where(dx != 0, m01, m00)) != 0
    else:
        xtc, ytc = torch.clamp(xt, 0.0, w - 1.0), torch.clamp(yt, 0.0, h - 1.0)
        vx0, vy0 = torch.clamp(x0, min=0.0), torch.clamp(y0, min=0.0)
        ux0, ux1 = 1.0 - (xtc - vx0), 1.0 - ((vx0 + 1.0) - xtc)
        uy0, uy1 = 1.0 - (ytc - vy0), 1.0 - ((vy0 + 1.0) - ytc)

        def hat_face(a, b, u0, u1):  # csrc/march.cu hat_face
            return (torch.where(a != 0, u0, zero) + torch.where(b != 0, u1, zero)) > 0.5

        if scene.veto == "hat":
            face = torch.where(dy != 0, hat_face(m10, m11, ux0, ux1), hat_face(m00, m01, ux0, ux1))
        elif scene.veto == "hat_y":
            face = torch.where(dx != 0, hat_face(m01, m11, uy0, uy1), hat_face(m00, m10, uy0, uy1))
        else:
            vtop = torch.where(m00 != 0, ux0, zero) + torch.where(m01 != 0, ux1, zero)
            vbot = torch.where(m10 != 0, ux0, zero) + torch.where(m11 != 0, ux1, zero)
            face = (vtop * uy0 + vbot * uy1) > 0.5
    return dict(xt=xt, yt=yt, x0=x0, y0=y0, x1=x1, y1=y1, bx0=bx0, by0=by0, bx1=bx1, by1=by1,
                d00=d00, d01=d01, d10=d10, d11=d11, face=face, off_quad=off_quad, in_range=in_range)


def kernel_sample_n2(scene: TS._Scene, mask: torch.Tensor, t: torch.Tensor):
    """sample_n2 as csrc/march.cu evaluates it: (norm^2 or 1e30, one-hot taps off the quad, quad indices in range)."""
    k = kernel_taps(scene, mask, t)
    xt, yt = k["xt"], k["yt"]
    wx0, wx1 = k["x1"] - xt, xt - k["x0"]
    iu = k["d00"] * wx0 + k["d01"] * wx1
    il = k["d10"] * wx0 + k["d11"] * wx1
    d_interp = iu * (k["y1"] - yt) + il * (yt - k["y0"])
    ba_x = (xt - scene.cfg.half_w) - scene.xx
    ba_y = (scene.cfg.half_h - yt) - scene.yy
    ba_z = d_interp - scene.depth_px
    cx = ba_y * scene.bc_z - ba_z * scene.bc_y
    cy = ba_z * scene.bc_x - ba_x * scene.bc_z
    cz = ba_x * scene.bc_y - ba_y * scene.bc_x
    n2 = cx * cx + cy * cy + cz * cz
    return torch.where(k["face"], n2, TS.OFF_FACE_N2), k["off_quad"], k["in_range"]


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


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 16), size=st.sampled_from([32, 64]),
       kind=st.sampled_from(["border", "inside_integer", "far"]), veto=st.sampled_from(TS.VETOES),
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
        for veto in TS.VETOES:
            cfg = TC.RenderConfig(img_height=32, img_width=32, shadow_mask_gather=veto)
            scene = TS._Scene(depth, mask, lp, cfg)
            t = torch.from_numpy(TS.sample_ts(cfg).astype(np.float32)).view(1, -1, 1, 1)
            xt = TS._fma(t, scene.diff_x, scene.xx) + cfg.half_w - TS.EPS
            yt = (cfg.half_h - TS._fma(t, scene.diff_y, scene.yy)) - TS.EPS
            assert bool(((xt < 0) | (yt < 0)).any())
            got, off_quad, in_range = kernel_sample_n2(scene, mask, t)
            assert in_range and off_quad == 0
            assert torch.equal(got.view(torch.int32), scene.sample_n2(t).view(torch.int32))


@pytest.mark.parametrize("veto", ["hat", "hat_y"])
def test_hat_vetoes_at_the_thresholds_tie(veto):
    """Samples whose hat coordinate (xt for 'hat', yt for 'hat_y') is an exact
    half: the two taps' weights are 0.5 each, so the threshold passes only
    where both taps are on the face (shadows_pallas.py:443-480). The quad's
    selection equals the plain veto there, bit for bit."""
    depth, mask = draw_scene(8, 32)
    lights = torch.tensor([[3.0, -4.0, 20.0], [2500.0, 1400.0, 3000.0], [-3000.0, -700.0, 2000.0]])
    cfg = TC.RenderConfig(img_height=32, img_width=32, shadow_mask_gather=veto)
    scene = TS._Scene(depth, mask, lights, cfg)
    t = integer_offsets(scene, "x" if veto == "hat" else "y", frac=0.5)
    got, off_quad, in_range = kernel_sample_n2(scene, mask, t)
    assert in_range and off_quad == 0
    assert torch.equal(got.view(torch.int32), scene.sample_n2(t).view(torch.int32))
    sx, sy = TS._fma(t, scene.diff_x, scene.xx), TS._fma(t, scene.diff_y, scene.yy)
    coord = sx + cfg.half_w - TS.EPS if veto == "hat" else (cfg.half_h - sy) - TS.EPS
    tie = coord - torch.floor(coord) == 0.5
    assert int(tie.sum()) >= 200, int(tie.sum())
    # At the tie the sample passes exactly where both taps are on the face.
    ind = (mask != 0).float().reshape(3, -1)
    lo = torch.floor(coord)
    if veto == "hat":
        row = cfg.half_h - torch.round(sy)
        both = (TS._gather(ind, row, lo, 32, 32) * TS._gather(ind, row, lo + 1, 32, 32)) != 0
    else:
        col = torch.round(sx) + cfg.half_w
        both = (TS._gather(ind, lo, col, 32, 32) * TS._gather(ind, lo + 1, col, 32, 32)) != 0
    passed = got < TS.OFF_FACE_N2
    assert torch.equal(passed[tie], both[tie])
    assert bool((both[tie]).any()) and bool((~both[tie]).any())


def test_the_quad_leaves_the_image_only_where_the_wrappers_clamp():
    """The header's range: for t in [0, 1] and W up to 2048 the quad stays in
    the padded plane; a table to 1.02, or W - 1 = 2048 and more (where
    W - 1 - 1e-4 rounds to W - 1), takes it out, and there the wrappers
    launch the clamped taps (shadows_cuda._clamp)."""
    depth, mask = draw_scene(9, 32)
    lights = torch.tensor([[2500.0, 1400.0, 3000.0], [-3000.0, -700.0, 2000.0], [400.0, -3800.0, 1500.0]])
    cfg = TC.RenderConfig(img_height=32, img_width=32, num_sample_points=200, t_stop=1.025)
    scene = TS._Scene(depth, mask, lights, cfg)
    ts, clamp = shadows_cuda._ts_for(torch.device("cpu"), cfg)
    assert float(ts.max()) > 1.0 and clamp and shadows_cuda._clamp(32, 32, False)
    assert not kernel_sample_n2(scene, mask, ts.view(1, -1, 1, 1))[2]
    assert kernel_sample_n2(scene, mask, ts[ts <= 1.0].view(1, -1, 1, 1))[2]
    wide = torch.zeros((1, 2, 4096)), torch.ones((1, 2, 4096))
    scene = TS._Scene(*wide, torch.tensor([[3000.0, 0.0, 50.0]]), TC.RenderConfig(img_height=2, img_width=4096))
    assert not kernel_sample_n2(scene, wide[1], torch.ones((1, 1, 1, 1)))[2]
    assert shadows_cuda._clamp(2, 4096, True) and not shadows_cuda._clamp(2048, 2048, True)


# --------------------------------------------------------------------------- march_grad's taps


def kernel_grad_taps(scene: TS._Scene, mask: torch.Tensor, t: torch.Tensor) -> dict:
    """march_grad_kernel's taps (csrc/march.cu pixel_grad): the forward's quad
    and veto, with the ceil tap taken as the floor tap on an integer axis;
    the taps' (H, W) addresses from the rounding adds' bits; the position
    term's factors d(d_interp)/dxt and d(d_interp)/dyt as the kernel forms
    them, and the x factor as the quad's columns alone would give it."""
    k = kernel_taps(scene, mask, t)
    w = scene.w
    xint, yint = k["x1"] == k["x0"], k["y1"] == k["y0"]
    d_ul = k["d00"]
    d_ur = torch.where(xint, k["d00"], k["d01"])
    d_ll = torch.where(yint, k["d00"], k["d10"])
    d_lr = torch.where(xint, d_ll, torch.where(yint, k["d01"], k["d11"]))
    ix0, ix1 = grid_int(k["bx0"]).clamp(min=0), grid_int(k["bx1"])
    iy0, iy1 = grid_int(k["by0"]).clamp(min=0), grid_int(k["by1"])
    wx0, wx1 = k["x1"] - k["xt"], k["xt"] - k["x0"]
    wy0, wy1 = k["y1"] - k["yt"], k["yt"] - k["y0"]
    iu, il = d_ul * wx0 + d_ur * wx1, d_ll * wx0 + d_lr * wx1
    return dict(taps=(d_ul, d_ur, d_ll, d_lr), index=(iy0 * w + ix0, iy0 * w + ix1, iy1 * w + ix0, iy1 * w + ix1),
                dx=(d_ur - d_ul) * wy0 + (d_lr - d_ll) * wy1, dy=il - iu, face=k["face"],
                quad_dx=(k["d01"] - k["d00"]) * wy0 + (k["d11"] - k["d10"]) * wy1, xint=xint, integer=xint | yint)


def plain_grad_taps(scene: TS._Scene, t: torch.Tensor) -> dict:
    """What march_vjp (autograd of _Scene.sample_n2) differentiates: the
    reference's clamped floor/ceil taps, their flat indices, the veto, and
    autograd's d(d_interp)/dxt and d(d_interp)/dyt (floor and ceil pass none)."""
    cfg, h, w = scene.cfg, scene.h, scene.w
    xt = TS._fma(t, scene.diff_x, scene.xx) + cfg.half_w - TS.EPS
    yt = (cfg.half_h - TS._fma(t, scene.diff_y, scene.yy)) - TS.EPS
    x0, x1, y0, y1 = torch.floor(xt), torch.ceil(xt), torch.floor(yt), torch.ceil(yt)
    dep = scene.depth_flat
    taps = tuple(TS._gather(dep, iy, ix, h, w) for iy, ix in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    index = tuple((torch.clamp(iy, 0, h - 1).long() * w + torch.clamp(ix, 0, w - 1).long())
                  for iy, ix in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    with torch.enable_grad():
        xg, yg = xt.clone().requires_grad_(), yt.clone().requires_grad_()
        iu = taps[0] * (x1 - xg) + taps[1] * (xg - x0)
        il = taps[2] * (x1 - xg) + taps[3] * (xg - x0)
        d_interp = iu * (y1 - yg) + il * (yg - y0)
        dx, dy = torch.autograd.grad(d_interp.sum(), (xg, yg))
    return dict(taps=taps, index=index, dx=dx, dy=dy, face=scene.sample_n2(t) < TS.OFF_FACE_N2)


def assert_grad_taps_match(scene, mask, t):
    got, want = kernel_grad_taps(scene, mask, t), plain_grad_taps(scene, t)
    for g, w in zip(got["taps"], want["taps"]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    for g, w in zip(got["index"], want["index"]):
        assert torch.equal(g, w)
    assert torch.equal(got["face"], want["face"])
    # d/dyt is (il - iu) in both, bit for bit; d/dxt sums the same two
    # products in another rounding, and is exactly 0 on both sides wherever
    # xt is an integer.
    assert torch.equal(got["dy"].view(torch.int32), want["dy"].view(torch.int32))
    scale = want["taps"][0].abs().max().item()
    torch.testing.assert_close(got["dx"], want["dx"], rtol=0.0, atol=4e-7 * scale)
    return got, want


@settings(max_examples=30, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 16), size=st.sampled_from([32, 64]),
       kind=st.sampled_from(["border", "inside_integer", "far"]), veto=st.sampled_from(["onehot", "bilinear"]),
       first=st.integers(0, 177), per_pixel=st.booleans())
def test_march_grad_taps_are_the_plain_vjps(seed, size, kind, veto, first, per_pixel):
    """march_grad's tap selection on hypothesis-drawn rays (lights on the
    border, at integer points inside and far outside; integer spans stepped
    by 0.005, and per-pixel t with its ends): the reference's taps, their
    addresses, the veto and the position term of the plain march_vjp."""
    rng = np.random.default_rng(seed)
    depth, mask = draw_scene(seed, size)
    light = torch.from_numpy(light_points(kind, size, rng))
    scene = TS._Scene(depth, mask, light, TC.RenderConfig(img_height=size, img_width=size, shadow_mask_gather=veto))
    if per_pixel:
        t = torch.from_numpy(rng.uniform(0.0, 1.0, (3, 4, size, size)).astype(np.float32))
        t[:, 0, ::7] = 0.0
        t[:, 1, ::5] = 1.0
    else:
        t = torch.from_numpy((0.005 * np.arange(first, first + 24)).astype(np.float32)).view(1, -1, 1, 1)
    assert_grad_taps_match(scene, mask, t)


def integer_offsets(scene: TS._Scene, axis: str, frac: float = 0.0) -> torch.Tensor:
    """A per-pixel t in [0, 1] (B, 1, H, W) that puts xt (or yt) on an integer
    plus `frac` (0 or 0.5) where one lies within 64 ulps of the solution for
    the one nearest the sample at t = 0.5; t = 0.5 elsewhere. The march meets
    such samples rarely (one winner in ~16k pixels), so the test makes them."""
    cfg = scene.cfg
    diff, base, half = ((scene.diff_x, scene.xx, cfg.half_w) if axis == "x" else (scene.diff_y, scene.yy, cfg.half_h))
    sign = 1.0 if axis == "x" else -1.0
    mid = sign * TS._fma(torch.full_like(diff, 0.5), diff, base) + half - TS.EPS
    goal = torch.round(mid - frac) + frac
    target = (goal.double() - half + TS.EPS) * sign  # the s coordinate that lands on it
    t0 = ((target - base.double()) / diff.double()).clamp(0.0, 1.0).float()
    best = torch.full_like(t0, 0.5)
    cand = t0
    for _ in range(64):
        for c in (cand, t0 - (cand - t0)):
            c = c.clamp(0.0, 1.0)
            v = sign * TS._fma(c, diff, base) + half - TS.EPS
            best = torch.where((v - frac == torch.floor(v - frac)) & (v - torch.floor(v) == frac) & (best == 0.5),
                               c, best)
        cand = torch.nextafter(cand, torch.tensor(2.0))
    return best


def test_march_grad_takes_the_floor_tap_at_integer_coordinates():
    """The trap at integer coordinates, and the first row and column: where
    xt or yt is an integer the quad's second column (row) is another pixel,
    and the position term read from it would differ from the reference's,
    whose ceil tap is its floor tap. The kernel's selection equals the
    reference there, in both vetoes; rays along the left and top border
    (xt or yt in [-1e-4, 0)) read the pad."""
    depth, mask = draw_scene(4, 32)
    lights = {"inside_integer": [[3.0, -4.0, 20.0], [-7.0, 9.0, 30.0], [0.0, 0.0, 25.0]],
              "far": [[2500.0, 1400.0, 3000.0], [-3000.0, -700.0, 2000.0], [400.0, -3800.0, 1500.0]],
              "border": [[-16.0, 5.0, 30.0], [3.0, 16.0, 30.0], [-16.0, 16.0, 40.0]]}
    for kind, pts in lights.items():
        for veto in ("onehot", "bilinear"):
            cfg = TC.RenderConfig(img_height=32, img_width=32, shadow_mask_gather=veto)
            scene = TS._Scene(depth, mask, torch.tensor(pts, dtype=torch.float32), cfg)
            if kind == "border":
                t = torch.from_numpy(TS.sample_ts(cfg).astype(np.float32)).view(1, -1, 1, 1)
                assert_grad_taps_match(scene, mask, t)
                xt = TS._fma(t, scene.diff_x, scene.xx) + cfg.half_w - TS.EPS
                yt = (cfg.half_h - TS._fma(t, scene.diff_y, scene.yy)) - TS.EPS
                assert bool(((xt < 0) | (yt < 0)).any())
                continue
            for axis in ("x", "y"):
                t = integer_offsets(scene, axis)
                got, _ = assert_grad_taps_match(scene, mask, t)
                on = got["integer"] & got["face"]
                assert int(on.sum()) >= 100, int(on.sum())
                on = got["xint"] & got["face"]
                if axis == "x":
                    assert bool((got["dx"][on] == 0).all())
                    assert bool((got["quad_dx"][on] != 0).any())  # the quad alone would move the light gradient


def kernel_endpoint_jacobian(xx, yy, lx, ly, cfg):
    """march_grad's d(ex, ey)/d(lx, ly) (pixel_grad in csrc/march.cu), transcribed in float32:
    (d ex/d lx, d ex/d ly, d ey/d lx, d ey/d ly), each the exact derivative of the endpoint's
    arithmetic in the form that does not cancel, on the branch the endpoint took, zero where its
    clamp binds; and the float32 endpoint's (inter, ex_raw, ey_raw)."""
    eps = TS.EPS
    left, right = -cfg.half_w, cfg.img_width - cfg.half_w - 1.0
    bottom, top = 1.0 - cfg.half_h, cfg.half_h
    den = (lx - xx) + eps
    slope = (ly - yy) / den
    icpt = ly - slope * lx
    zx_neg, zx_pos, zy_neg, zy_pos = lx < left, lx > right, ly < bottom, ly > top
    zx_mid, zy_mid = ~(zx_neg | zx_pos), ~(zy_neg | zy_pos)
    xv = torch.where(zx_neg, left, right)
    yh = torch.where(zy_neg, bottom, top)
    se = slope + eps
    ex_h = (yh - icpt) / se
    inter = (ex_h >= left) & (ex_h <= right)
    inside = zx_mid & zy_mid
    ex_raw = torch.where(inside, lx, torch.where(zy_mid, xv, torch.where(zx_mid | inter, ex_h, xv)))
    ey_raw = torch.where(inside, ly, torch.where(zy_mid | ~(zx_mid | inter), slope * xv + icpt, yh))
    jxy = -(((yh - yy) - eps * (xx - eps)) / se) / (den * se)
    jyy = ((xv - xx) + eps) / den
    on_h = ~inside & ~zy_mid & (zx_mid | inter)
    on_v = ~inside & (zy_mid | ~(zx_mid | inter))
    zero = torch.zeros_like(slope)
    jxx, jxy = torch.where(on_h, -slope * jxy, zero), torch.where(on_h, jxy, zero)
    jyx, jyy = torch.where(on_v, -slope * jyy, zero), torch.where(on_v, jyy, zero)
    jxx, jyy = torch.where(inside, 1.0, jxx), torch.where(inside, 1.0, jyy)
    x_in, y_in = (ex_raw >= left) & (ex_raw <= right), (ey_raw >= bottom) & (ey_raw <= top)
    return (torch.where(x_in, jxx, 0.0), torch.where(x_in, jxy, 0.0), torch.where(y_in, jyx, 0.0),
            torch.where(y_in, jyy, 0.0)), (inter, ex_raw, ey_raw)


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(seed=st.integers(0, 2 ** 16), kind=st.sampled_from(["over_a_column", "far", "beside", "inside"]))
def test_march_grad_endpoint_jacobian_is_the_float64_derivative(seed, kind):
    """march_grad's derivative of the border endpoint in the light point, float32 as the kernel
    computes it, against float64 autograd of shadows.border_endpoints at 8 x 4096: within 1e-5 of
    each entry (and 1e-12), with far lights that stand over a pixel column (|lx - xx| < 1, where
    the chain rule's own form cancels), anywhere, beside the image and inside it. Pixels whose
    float32 and float64 endpoints take another branch or clamp are left out (at most 1%)."""
    rng = np.random.default_rng(seed)
    cfg = TC.RenderConfig(img_height=8, img_width=4096)
    xx, yy = TS.pixel_grid_centered(8, 4096)
    b = 4
    far = rng.uniform(300.0, 4000.0, b) * rng.choice([-1.0, 1.0], b)
    lx = {"over_a_column": rng.integers(-2048, 2048, b) + rng.choice([0.1, -0.1, 0.5, 1e-3], b)
                           + rng.uniform(-0.05, 0.05, b),
          "far": rng.uniform(-4000.0, 4000.0, b), "beside": rng.choice([-1.0, 1.0], b) * rng.uniform(2100, 4000, b),
          "inside": rng.uniform(-2040.0, 2040.0, b)}[kind]
    ly = rng.uniform(-3.0, 4.0, b) if kind in ("beside", "inside") else far
    lx, ly = (torch.from_numpy(a.astype(np.float32)).view(b, 1, 1).expand(b, 8, 4096) for a in (lx, ly))
    got, (inter, ex_raw, ey_raw) = kernel_endpoint_jacobian(xx, yy, lx, ly, cfg)
    lx64, ly64 = lx.double().requires_grad_(), ly.double().requires_grad_()
    ex, ey = TS.border_endpoints(xx.double(), yy.double(), lx64, ly64, cfg)
    want = [*torch.autograd.grad(ex.sum(), (lx64, ly64), retain_graph=True),
            *torch.autograd.grad(ey.sum(), (lx64, ly64))]
    _, (inter64, ex_raw64, ey_raw64) = kernel_endpoint_jacobian(xx.double(), yy.double(), lx64.detach(),
                                                                ly64.detach(), cfg)
    left, right = -cfg.half_w, cfg.img_width - cfg.half_w - 1.0
    bottom, top = 1.0 - cfg.half_h, cfg.half_h
    same = ((inter == inter64) & (((ex_raw >= left) & (ex_raw <= right)) == ((ex_raw64 >= left) & (ex_raw64 <= right)))
            & (((ey_raw >= bottom) & (ey_raw <= top)) == ((ey_raw64 >= bottom) & (ey_raw64 <= top))))
    assert same.float().mean().item() >= 0.99
    for g, w in zip(got, want):
        err = (g.double() - w).abs()[same]
        assert bool((err <= 1e-5 * w.abs()[same] + 1e-12).all()), float((err / w.abs()[same].clamp_min(1e-30)).max())


# --------------------------------------------------------------------------- K2's lanes


def lane_first_winner(n2: np.ndarray, lanes: int):
    """K2's sample split (csrc/march.cu march_kernel<kArgmin>): lane l of
    `lanes` takes samples l, l + lanes, ... and their strict-< first winner
    from inf (index: l), then the xor butterfly keeps the smaller norm^2, on
    a tie the smaller index. (P, n) float32 -> per lane (best, index) after
    the combine, (lanes, P) each."""
    p, n = n2.shape
    best = np.full((lanes, p), np.inf, np.float32)
    idx = np.zeros((lanes, p), np.int64)
    for lane in range(lanes):
        idx[lane] = lane
        for s in range(lane, n, lanes):
            better = n2[:, s] < best[lane]
            best[lane] = np.where(better, n2[:, s], best[lane])
            idx[lane] = np.where(better, s, idx[lane])
    off = lanes // 2
    while off:
        ob, oi = best[np.arange(lanes) ^ off], idx[np.arange(lanes) ^ off]
        take = (ob < best) | ((ob == best) & (oi < idx))
        best, idx = np.where(take, ob, best), np.where(take, oi, idx)
        off //= 2
    return best, idx


@settings(max_examples=60, deadline=None, derandomize=True, database=None)
@given(n=st.integers(1, 170), lanes=st.sampled_from([1, 2, 4, 8]), seed=st.integers(0, 2 ** 16),
       pool=st.sampled_from([(1.0, 2.0), (0.5, 1.0, 1e30), (1e30,), (3.0, 3.0000002, 7.0)]))
def test_lane_combine_is_the_first_winner(n, lanes, seed, pool):
    """The lane combine, ties included (values drawn from a few floats, all
    vetoed, tables shorter than the lanes): every lane ends on the
    table's min and its first index, the plain march's strict-< winner."""
    rng = np.random.default_rng(seed)
    n2 = rng.choice(np.asarray(pool, np.float32), size=(16, n))
    best, idx = lane_first_winner(n2, lanes)
    assert (best == n2.min(axis=1)).all() and (idx == n2.argmin(axis=1)).all()
    # The plain version's own first winner over the same values, in chunks as it marches.
    want, s = torch.full((16,), float("inf")), torch.zeros(16, dtype=torch.long)
    for start in range(0, n, 7):
        chunk = torch.from_numpy(n2[:, start:start + 7])
        cmin = chunk.amin(dim=1)
        first = torch.where(chunk == cmin[:, None], torch.arange(start, start + chunk.shape[1]), n).amin(dim=1)
        s = torch.where(cmin < want, first, s)
        want = torch.minimum(want, cmin)
    assert (idx == s.numpy()).all()


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
    before = dict(cuda_lib.LAUNCHES)
    got = shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, ts, cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    offsets = TS.refine_offsets(cfg)[1:6]
    assert torch.equal(shadows_cuda.refine_around_argmin_cuda(depth, mask, light, idx, ts, cfg, offsets),
                       TS.refine_min_distance_batch(depth, mask, light, t_map, cfg, offsets))
    assert cuda_lib.LAUNCHES == before


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
    before = dict(cuda_lib.LAUNCHES)
    got = shadows_cuda.draft_march(depth, mask, light, cfg)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(shadow_min_distance(depth, mask, light, cfg).view(torch.int32), want.view(torch.int32))
    assert cuda_lib.LAUNCHES == before
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


def test_sharded_slices_take_the_grid_clamp_and_launches_need_one():
    """K5 with a group takes every rank's slice with the config's grid's taps, since t* may be any
    rank's offset: _grid_slice gives the grid's clamp, also where the slice alone would take the
    quad's, and refuses a slice outside the grid's range; a K1 or K2 launch given no clamp fails
    before it reads anything back."""
    cpu = torch.device("cpu")
    for cfg in (TC.RenderConfig(**DRAFT), TC.RenderConfig(img_height=32, img_width=32, num_sample_points=200,
                                                          t_stop=1.025)):
        grid = TS.sharded_sample_ts(cfg, 2)
        for part in np.split(grid, 2):
            ts, clamp = shadows_cuda._grid_slice(cpu, cfg, part)
            assert torch.equal(ts, torch.from_numpy(part)) and clamp == shadows_cuda._ts_for(cpu, cfg)[1]
        for outside in (np.array([0.1, 1.5], np.float32), np.array([-0.01, 0.2], np.float32),
                        np.array([0.1, np.nan], np.float32)):
            with pytest.raises(ValueError, match="grid's range"):
                shadows_cuda._grid_slice(cpu, cfg, outside)
    assert shadows_cuda._grid_slice(cpu, cfg, grid[:8])[1] and not shadows_cuda._ts_for(cpu, cfg, grid[:8])[1]
    depth, mask, light = draft_scene(23)
    cfg = TC.RenderConfig(**DRAFT)
    staged = TS.Staged(torch.zeros((4, 65, 65, 2)), None)
    with pytest.raises(TypeError, match="clamp"):
        shadows_cuda._launch("march", staged, mask, light, shadows_cuda._ts_for(cpu, cfg)[0], cfg)
    with pytest.raises(TypeError):
        shadows_cuda._launch_argmin(depth, mask, light, shadows_cuda._ts_for(cpu, cfg)[0], cfg)


def test_wrappers_tell_tables_outside_the_unit_interval():
    """A given table is read once: whether it lies in [0, 1] chooses the kernels' taps."""
    depth, mask, light = draft_scene(22)
    cfg = TC.RenderConfig(**DRAFT)
    for table in (np.array([0.1, 1.5], np.float32), torch.tensor([-0.01, 0.2]), torch.tensor([0.1, float("nan")])):
        assert shadows_cuda._ts_for(torch.device("cpu"), cfg, table)[1]
    ts, clamp = shadows_cuda._ts_for(torch.device("cpu"), cfg, torch.tensor([0.0, 0.5, 1.0]))
    assert not clamp and ts.dtype == torch.float32 and ts.tolist() == [0.0, 0.5, 1.0]
    assert not shadows_cuda._ts_for(torch.device("cpu"), cfg)[1]
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
    for g in range(-(-h // BLOCK_ROWS)):
        # A thread past the last row reads the last row (min(row, h - 1)).
        rows = mask[:, [min(g * BLOCK_ROWS + y, h - 1) for y in range(BLOCK_ROWS)]]
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


@pytest.mark.parametrize("h, w, chunk", [(128, 128, 16), (128, 128, 32), (128, 128, 64), (128, 128, 0),
                                         (60, 96, 24), (62, 120, 40), (36, 96, 48), (60, 60, 0)],
                         ids=["col16", "col32", "col64", "row", "60x96_col24", "62x120_col40", "36x96_col48",
                              "60x60_row"])
def test_in_kernel_cull_is_cull_live_blocks(h, w, chunk):
    rng = np.random.default_rng(chunk + h)
    mask = np.zeros((3, h, w), np.float32)
    for i in range(3):  # sparse faces: a few small patches, and single pixels on unit edges
        for _ in range(4):
            y, x = rng.integers(0, h - 6), rng.integers(0, w - 6)
            mask[i, y:y + rng.integers(1, 6), x:x + rng.integers(1, 6)] = 1.0
        mask[i, rng.integers(0, h), w // 2 - 1] = mask[i, rng.integers(0, h), w // 2] = 2.5
        mask[i, h - 1, rng.integers(0, w)] = 1.0  # the last (short) row group
    mask[2] = 0.0
    mask[2, 17, w - 1] = -1.0  # any nonzero is face
    cfg = TC.RenderConfig(img_height=h, img_width=w, shadow_mask_cull=True, shadow_col_chunk=chunk)
    c = TS.effective_col_chunk(cfg)
    m = torch.from_numpy(mask)
    want = TS.cull_live_blocks(m, c).repeat_interleave(8, dim=1)[:, :h].repeat_interleave(c, dim=2)
    assert torch.equal(kernel_live(m, c), want)
    assert torch.equal(want, TS._live_pixels(m, cfg))
    # The JAX package's cull, block by block.
    np.testing.assert_array_equal(want.numpy(), np.stack([np.asarray(JS.cull_live_blocks(jnp.asarray(x), c))
                                                          for x in mask]))


def test_the_staging_pads_and_interleaves_depth_and_mask():
    """stage_kernel's rule, as the transcription above reads it: padded
    (y, x) is (depth, mask) at (max(y - 1, 0), max(x - 1, 0)); and a t grid
    outside [0, 1] is told apart (the kernels take their clamped taps)."""
    depth, mask = draw_scene(5, 32)
    staged = stage(depth, mask)
    assert staged.shape == (3, 33, 33, 2) and staged.is_contiguous()
    ys = torch.clamp(torch.arange(33) - 1, min=0)
    assert torch.equal(staged[..., 0], depth[:, ys][:, :, ys]) and torch.equal(staged[..., 1], mask[:, ys][:, :, ys])
    cfg = dataclasses.replace(TC.RenderConfig(img_height=32, img_width=32), t_stop=1.2, num_sample_points=235)
    assert shadows_cuda._ts_for(torch.device("cpu"), cfg)[1]
