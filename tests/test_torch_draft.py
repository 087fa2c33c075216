"""The port's draft tier vs the JAX package's (CPU).

Inputs are drawn with numpy at 64x64 (16x16 low-res at scale 4, 32x32 at
scale 2) with a 32-sample full grid (16 low-res samples at stride 2), except
the golden fixtures (256x256, the presets' own grids). Each helper goes
through the JAX function and its port:
  * scaled_render_cfg, refine_offsets, upsample_tstar_nn: equal;
  * scale_march_inputs: depth max |d| <= 1e-6 * max |depth| (the pooling
    sums in another order), mask and light equal;
  * upscale_min_distance: rtol 1e-5, edges included;
  * the plain argmin march and plain refine, one-hot veto, against JAX's plain
    march and refine fed the same inputs and the same t_map; the bilinear
    veto against the Pallas kernel in interpret mode, leaving out the pixels
    where its hat taps and the reference's floor/ceil taps part by design
    (zero_weight_corners, at most 0.1% of pixels). Bars are the repo's
    kernel-test bars (tests/test_shadows_pallas.py:44-51): sentinel agreement
    >= 0.9999, 0.9999-quantile |d| < 1e-3, mean |d| < 1e-4; t* equal on
    >= 0.999 of the pixels both sides march. The port takes the argmin over
    norm^2 as its kernel does, JAX's plain march over distances, so a tie in
    rounded distance may pick another sample;
  * render() at draft with the one-hot veto forced on both sides, on the three
    transfer goldens: face-visible rendered PSNR >= 80 dB, face-masked mean
    shadow-weight |d| <= 1e-4;
  * the draft tier (bilinear veto, the port's own) on the ten goldens against
    the reference's stored outputs, at the tier's bars: face-visible PSNR
    >= 45 dB on the transfer fixtures (tests/test_shadows_draft.py:423-462),
    face-masked mean shadow-weight |d| <= 1e-2 on the target fixtures (the
    JAX package's plain draft scores <= 5.3e-3 there).
The kernels K2 and K3 are held against these plain versions on the card by
tests/test_torch_cuda.py.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.ops import shadows as TS
from geomconsistentfr_torch.ops import cuda_lib, shadows_cuda
from geomconsistentfr_torch.render import render as t_render
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.ops import shadows as JS
from geomconsistentfr_tpu.ops import shadows_pallas as JSP
from geomconsistentfr_tpu.render import render as j_render
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).resolve().parent / "golden"
FIXTURES = sorted(p.name for p in GOLDEN.glob("ref_*.npz"))
GRID = dict(num_sample_points=32, t_start=0.025, t_stop=0.185, march_chunk=32)
DRAFT = dict(img_height=64, img_width=64, shadow_resolution_scale=4, shadow_refine_halfwidth=4,
             shadow_lowres_t_stride=2, **GRID)
LIGHTS = np.asarray([[0.3, 0.4, 0.866], [-0.55, 0.2, 0.81], [0.7, -0.1, 0.7], [0.05, 0.9, 0.4]], np.float32) * 4013.0
VARIANTS = {
    "plain": dict(),
    "cull_col16_wide": dict(shadow_mask_cull=True, shadow_col_chunk=16, shadow_bias_gate="wide"),
    "cull_row_inside": dict(shadow_mask_cull=True, shadow_bias_gate="inside_image"),
}


def cfgs(**kw):
    return JC.RenderConfig(**kw), TC.RenderConfig(**kw)


def scene(b=4, seed=0, size=64):
    """Smooth cosine terrain plus noise, and an oval face mask with holes."""
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
    return depth, mask, LIGHTS[:b].copy()


def T(*arrays):
    return [torch.from_numpy(np.array(a, dtype=np.float32)) for a in arrays]


def assert_march_close(got, want, agree=0.9999):
    big_w, big_g = want >= 1e5, got >= 1e5
    assert (big_w == big_g).mean() >= agree
    diff = np.abs(got - want)[~(big_w | big_g)]
    assert np.quantile(diff, 0.9999) < 1e-3, float(diff.max())
    assert diff.mean() < 1e-4, float(diff.mean())


def assert_tstar_agree(got_t, want_t, got_d, want_d):
    marched = (got_d < 1e5) & (want_d < 1e5)
    assert (got_t == want_t)[marched].mean() >= 0.999


# --------------------------------------------------------------------------- helpers


@pytest.mark.parametrize("tier", [None, "draft"])
@pytest.mark.parametrize("preset", ["preset_single_image", "preset_lighting_transfer"])
def test_scaled_render_cfg_matches_jax(preset, tier):
    jcfg, tcfg = getattr(JC, preset)().render, getattr(TC, preset)().render
    if tier is None:
        jcfg = dataclasses.replace(jcfg, shadow_resolution_scale=2, shadow_refine_halfwidth=2,
                                   shadow_lowres_t_stride=2)
        tcfg = TC.RenderConfig(**dataclasses.asdict(jcfg))
    else:
        jcfg = JC.apply_precision_tier(getattr(JC, preset)(), tier).render
        tcfg = TC.apply_precision_tier(getattr(TC, preset)(), tier).render
    want, got = JS.scaled_render_cfg(jcfg), TS.scaled_render_cfg(tcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    np.testing.assert_array_equal(TS.sample_ts(got), JS.sample_ts(want))
    assert got.num_sample_points == 80


@pytest.mark.parametrize("scale", [2, 4])
def test_scale_march_inputs_matches_jax(scale):
    depth, mask, lights = scene(seed=1)
    mask[0, :8] = 0.0  # whole off-face blocks take the plain mean
    jcfg, tcfg = cfgs(**dict(DRAFT, shadow_resolution_scale=scale))
    want = JS.scale_march_inputs(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg)
    got = TS.scale_march_inputs(*T(depth, mask, lights), tcfg)
    assert np.abs(got[0].numpy() - np.asarray(want[0])).max() <= 1e-6 * np.abs(depth).max()
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert dataclasses.asdict(got[3]) == dataclasses.asdict(want[3])


def sequential_block_sums(x: np.ndarray, s: int) -> np.ndarray:
    """Each s x s block of (B, H, W) float32 summed row by row, left to right, from its first element."""
    b, h, w = x.shape
    blocks = x.reshape(b, h // s, s, w // s, s)
    acc = blocks[:, :, 0, :, 0].copy()
    for i in range(s):
        for j in range(s):
            if i or j:
                acc = (acc + blocks[:, :, i, :, j]).astype(np.float32)
    return acc


@pytest.mark.parametrize("scale", [2, 4])
def test_pooling_sums_each_block_in_the_stated_order(scale):
    """The plain pooling (which the CUDA staging follows bit for bit) adds each
    block row by row, left to right: equal to numpy's float32 adds in that
    order, bit for bit; on all-off, all-on and single-pixel blocks, and on
    blocks at the majority's edge (exactly half on face)."""
    depth, mask, lights = scene(seed=13)
    mask[0, :8] = 0.0                                 # all-off blocks: the plain mean
    mask[1, :8] = 1.0                                 # all-on blocks
    mask[2, :8] = 0.0
    mask[2, 1:8:scale, 1:64:scale] = 2.0              # one face pixel a block, nonzero but not 1
    mask[3, :8] = 0.0
    mask[3, :8:2] = 1.0                               # half of each block's rows: on_count = s^2 / 2
    cfg = TC.RenderConfig(**dict(DRAFT, shadow_resolution_scale=scale))
    got_d, got_m, _, _ = TS.scale_march_inputs(*T(depth, mask, lights), cfg)
    on = (mask != 0).astype(np.float32)
    count = sequential_block_sums(on, scale)
    face = sequential_block_sums((depth * on).astype(np.float32), scale) / np.maximum(count, np.float32(1))
    plain = sequential_block_sums(depth, scale) / np.float32(scale * scale)
    want_d = (np.where(count > 0, face, plain) / np.float32(scale)).astype(np.float32)
    np.testing.assert_array_equal(got_d.numpy().view(np.int32), want_d.view(np.int32))
    np.testing.assert_array_equal(got_m.numpy(), (count >= scale * scale / 2.0).astype(np.float32))
    r = 8 // scale
    assert (got_m.numpy()[1, :r] == 1).all() and (got_m.numpy()[[0, 2], :r] == 0).all()
    assert (got_m.numpy()[3, :r] == 1).all()          # half on face is the majority
    single = depth[2, 1:8:scale, 1:64:scale] / np.float32(scale)
    np.testing.assert_array_equal(got_d.numpy()[2, :r], single.astype(np.float32))


@pytest.mark.parametrize("cull", [0, 64], ids=["cull_row", "cull_col64"])
@pytest.mark.parametrize("scale", [2, 4])
def test_stage_inputs_are_the_draft_march_inputs(scale, cull):
    """stage_inputs, the plain version of the draft march's one staging pass:
    its pooled values match JAX's scale_march_inputs (at that test's bar,
    the mask and light exactly), its quads are the padding of the plain
    pooled and full-resolution arrays, and its flags are cull_live_blocks
    of each resolution's mask (row cull, or 8 x 64 at full resolution)."""
    depth, mask, lights = scene(seed=14, size=128)
    mask[0, :32] = 0.0                                # whole units off face at both resolutions
    mask[1, :, 64:] = 0.0
    mask[1, 40, 100] = 1.0                            # a unit with one face pixel
    kw = dict(DRAFT, img_height=128, img_width=128, shadow_resolution_scale=scale,
              shadow_mask_cull=True, shadow_col_chunk=cull)
    jcfg, tcfg = cfgs(**kw)
    want = JS.scale_march_inputs(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg)
    st = TS.stage_inputs(*T(depth, mask, lights), tcfg)
    m_depth, m_mask, m_light, m_cfg = TS.scale_march_inputs(*T(depth, mask, lights), tcfg)
    assert np.abs(st.quad[:, 1:, 1:, 0].numpy() - np.asarray(want[0])).max() <= 1e-6 * np.abs(depth).max()
    np.testing.assert_array_equal(st.quad[:, 1:, 1:, 1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(st.light.numpy(), np.asarray(want[2]))
    assert torch.equal(st.quad, TS.pad_quad(m_depth, m_mask)) and torch.equal(st.light, m_light)
    assert torch.equal(st.full, TS.pad_quad(*T(depth, mask)))
    assert st.quad.shape == (4, 128 // scale + 1, 128 // scale + 1, 2) and st.full.shape == (4, 129, 129, 2)
    low = TS.cull_live_blocks(m_mask, TS.effective_col_chunk(m_cfg))
    full = TS.cull_live_blocks(torch.from_numpy(mask), TS.effective_col_chunk(tcfg))
    assert st.flags.dtype == st.full_flags.dtype == torch.uint8
    assert torch.equal(st.flags.bool(), low) and torch.equal(st.full_flags.bool(), full)
    assert not full[0, :4].any()
    if cull:  # the right half's units are off face, but for the one holding a single face pixel
        assert bool(full[1, 5, 1]) and not full[1, 4, 1]
    # Without the cull there are no flags.
    uncut = TS.stage_inputs(*T(depth, mask, lights), dataclasses.replace(tcfg, shadow_mask_cull=False))
    assert uncut.flags is None and uncut.full_flags is None and torch.equal(uncut.quad, st.quad)


@pytest.mark.parametrize("scale", [2, 4])
def test_pool_march_inputs_reads_the_staged_quad(scale):
    """pool_march_inputs, the draft pooling where another march takes the
    pooled inputs: on the card it copies them out of the staging's quad with
    unpad_quad, which on the plain staging gives scale_march_inputs' arrays
    bit for bit, each contiguous (and inverts pad_quad); on CPU tensors it is
    the plain pooling, at scale_march_inputs' bar against JAX's."""
    depth, mask, lights = scene(seed=15, size=64)
    jcfg, tcfg = cfgs(**dict(DRAFT, shadow_resolution_scale=scale))
    want = TS.scale_march_inputs(*T(depth, mask, lights), tcfg)
    got = TS.unpad_quad(TS.stage_inputs(*T(depth, mask, lights), tcfg).quad)
    for g, w in zip(got, want[:2]):
        assert g.is_contiguous() and g.shape == (4, 64 // scale, 64 // scale)
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))
    back = TS.unpad_quad(TS.pad_quad(*T(depth, mask)))
    assert torch.equal(back[0], torch.from_numpy(depth)) and torch.equal(back[1], torch.from_numpy(mask))
    pooled = shadows_cuda.pool_march_inputs(*T(depth, mask, lights), tcfg)
    assert all(torch.equal(a, b) for a, b in zip(pooled[:3], want[:3])) and pooled[3] == want[3]
    j = JS.scale_march_inputs(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg)
    assert np.abs(pooled[0].numpy() - np.asarray(j[0])).max() <= 1e-6 * np.abs(depth).max()
    np.testing.assert_array_equal(pooled[1].numpy(), np.asarray(j[1]))


@pytest.mark.parametrize("scale", [2, 4])
def test_upscale_min_distance_matches_jax(scale):
    rng = np.random.default_rng(2)
    low = rng.uniform(0.0, 40.0, size=(3, 64 // scale, 64 // scale)).astype(np.float32)
    low[0, :3] = 1e6          # an off-face band against the top edge
    low[1, :, -2:] = 1e6 + 5.0  # gated sentinel against the right edge
    low[2, 5, 5] = 1e6        # an interior off-face texel
    jcfg, tcfg = cfgs(**dict(DRAFT, shadow_resolution_scale=scale))
    want = np.asarray(JS.upscale_min_distance(jnp.asarray(low), jcfg))
    got = TS.upscale_min_distance(torch.from_numpy(low), tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    # The border rows and columns read the edge texels times s.
    np.testing.assert_allclose(got[2, 0, 0], low[2, 0, 0] * scale, rtol=1e-6)
    np.testing.assert_allclose(got[2, -1, -1], low[2, -1, -1] * scale, rtol=1e-6)


def test_upsample_tstar_nn_and_refine_offsets_match_jax():
    t = np.random.default_rng(3).uniform(0, 1, (2, 16, 16)).astype(np.float32)
    jcfg, tcfg = cfgs(**DRAFT)
    np.testing.assert_array_equal(
        TS.upsample_tstar_nn(torch.from_numpy(t), tcfg).numpy(), np.asarray(JS.upsample_tstar_nn(jnp.asarray(t), jcfg))
    )
    for k, step in ((4, 0.005), (2, 0.005), (3, 0.01)):
        jc, tc = cfgs(t_step=step, shadow_refine_halfwidth=k)
        got, want = TS.refine_offsets(tc), JS.refine_offsets(jc)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_sample_distance_at_matches_jax():
    depth, mask, lights = scene(b=1, seed=4)
    jcfg, tcfg = cfgs(img_height=64, img_width=64, **GRID)
    t = np.random.default_rng(4).uniform(0.025, 0.18, (64, 64)).astype(np.float32)
    jit = jax.jit(JS.sample_distance_at, static_argnums=4)
    for tt in (t, np.float32(0.1)):
        want = np.asarray(jit(jnp.asarray(depth[0]), jnp.asarray(mask[0]), jnp.asarray(lights[0]), jnp.asarray(tt), jcfg))
        got = TS.sample_distance_at(*T(depth[0], mask[0], lights[0], tt), tcfg).numpy()
        assert_march_close(got, want)


# --------------------------------------------------------------------------- plain K2 and K3


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_argmin_march_matches_jax(variant):
    depth, mask, lights = scene(seed=5)
    mask[1, :16] = 0.0
    jcfg, tcfg = cfgs(img_height=64, img_width=64, **GRID, **VARIANTS[variant])
    want_d, want_t = JS.ray_march_min_distance_batch(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg, return_argmin_t=True)
    got_d, got_t = TS.ray_march_min_distance_batch(*T(depth, mask, lights), tcfg, return_argmin_t=True)
    assert_march_close(got_d.numpy(), np.asarray(want_d))
    assert_tstar_agree(got_t.numpy(), np.asarray(want_t), got_d.numpy(), np.asarray(want_d))
    if tcfg.shadow_mask_cull:
        # Culled pixels read the first offset, as in the JAX package.
        np.testing.assert_array_equal(got_t.numpy()[1, :16], np.float32(TS.sample_ts(tcfg)[0]))
    # The argmin form returns the same distances as the plain march.
    np.testing.assert_array_equal(got_d.numpy(), TS.ray_march_min_distance_batch(*T(depth, mask, lights), tcfg).numpy())


def test_plain_argmin_march_on_pooled_inputs_and_ts_slice():
    depth, mask, lights = scene(seed=6)
    jcfg, tcfg = cfgs(**DRAFT)
    dh, mh, lh, ch = JS.scale_march_inputs(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg)
    tch = TS.scaled_render_cfg(tcfg)
    for ts in (None, JS.sample_ts(ch).astype(np.float32)[3:11]):
        want_d, want_t = JS.ray_march_min_distance_batch(dh, mh, lh, ch, ts=ts, return_argmin_t=True)
        got_d, got_t = TS.ray_march_min_distance_batch(*T(np.asarray(dh), np.asarray(mh), np.asarray(lh)), tch,
                                                       ts=ts, return_argmin_t=True)
        assert_march_close(got_d.numpy(), np.asarray(want_d))
        assert_tstar_agree(got_t.numpy(), np.asarray(want_t), got_d.numpy(), np.asarray(want_d))
        if ts is not None:
            assert set(np.unique(got_t.numpy())) <= set(ts.tolist())


def draft_t_map(depth, mask, lights, jcfg):
    """JAX's own low-res argmin, upsampled: the t_map both refines are fed."""
    dh, mh, lh, ch = JS.scale_march_inputs(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg)
    _, t_star = JS.ray_march_min_distance_batch(dh, mh, lh, ch, return_argmin_t=True)
    return np.array(JS.upsample_tstar_nn(t_star, jcfg))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_plain_refine_matches_jax(variant):
    depth, mask, lights = scene(seed=7)
    mask[2, :, 48:] = 0.0
    jcfg, tcfg = cfgs(**DRAFT, **VARIANTS[variant])
    t_map = draft_t_map(depth, mask, lights, jcfg)
    want = np.asarray(JS.refine_min_distance_batch(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jnp.asarray(t_map), jcfg))
    got = TS.refine_min_distance_batch(*T(depth, mask, lights, t_map), tcfg).numpy()
    assert_march_close(got, want)
    single = TS.refine_min_distance(*T(depth[0], mask[0], lights[0], t_map[0]), tcfg).numpy()
    np.testing.assert_array_equal(single, got[0])


def test_plain_refine_offsets_override_matches_jax():
    depth, mask, lights = scene(seed=8)
    jcfg, tcfg = cfgs(**DRAFT)
    t_map = draft_t_map(depth, mask, lights, jcfg)
    offsets = JS.refine_offsets(jcfg)[2:7]
    want = np.asarray(JS.refine_min_distance_batch(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jnp.asarray(t_map), jcfg, offsets))
    got = TS.refine_min_distance_batch(*T(depth, mask, lights, t_map), tcfg, offsets).numpy()
    assert_march_close(got, want)


# The vetoes only the Pallas kernel has (shadows_pallas.py:443-496), by the two variants
# of the comparisons below; the bilinear cases keep the variant's name alone.
PALLAS_CASES = [(v, c) for v in ("bilinear", "hat", "hat_y") for c in ("plain", "cull_col16_wide")]
PALLAS_IDS = [c if v == "bilinear" else f"{v}-{c}" for v, c in PALLAS_CASES]


def zero_weight_corners(depth, mask, lights, cfg, t):
    """(B, H, W) bool: a sample of the pixel lands its shifted x or y on an integer.

    There the reference's floor/ceil taps (kept by the port and by JAX's plain
    march) both get weight 0, while the Pallas kernel's hat taps interpolate
    (shadows_pallas.py:188-193); seed 9 has one such winning sample, at
    x = 23.0, t = 0.16, 1.15 apart. The Pallas comparisons leave these pixels
    out. t is (1, S, 1, 1) or (B, S, H, W).
    """
    scene = TS._Scene(*T(depth, mask, lights), cfg)
    xt = TS._fma(t, scene.diff_x, scene.xx) + cfg.half_w - TS.EPS
    yt = (cfg.half_h - TS._fma(t, scene.diff_y, scene.yy)) - TS.EPS
    hit = (xt == torch.floor(xt)) | (yt == torch.floor(yt))
    corners = hit.any(dim=1).numpy()
    assert corners.mean() <= 1e-3
    return corners


@pytest.mark.parametrize("veto, variant", PALLAS_CASES, ids=PALLAS_IDS)
def test_bilinear_argmin_matches_pallas_interpret(veto, variant):
    depth, mask, lights = scene(seed=9)
    mask[3, :16] = 0.0
    jcfg, tcfg = cfgs(img_height=64, img_width=64, **GRID, **VARIANTS[variant],
                      shadow_matmul_precision="highest", shadow_mask_gather=veto)
    want_d, want_t = JSP.ray_march_min_distance_pallas(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jcfg, interpret=True, return_argmin_t=True)
    got_d, got_t = TS.ray_march_min_distance_batch(*T(depth, mask, lights), tcfg, return_argmin_t=True)
    ts = torch.from_numpy(TS.sample_ts(tcfg).astype(np.float32)).view(1, -1, 1, 1)
    keep = ~zero_weight_corners(depth, mask, lights, tcfg, ts)
    got_d, want_d = got_d.numpy()[keep], np.asarray(want_d)[keep]
    assert_march_close(got_d, want_d)
    assert_tstar_agree(got_t.numpy()[keep], np.asarray(want_t)[keep], got_d, want_d)


@pytest.mark.parametrize("veto, variant", PALLAS_CASES, ids=PALLAS_IDS)
def test_bilinear_refine_matches_pallas_interpret(veto, variant):
    depth, mask, lights = scene(seed=10)
    jcfg, tcfg = cfgs(**DRAFT, **VARIANTS[variant], shadow_matmul_precision="highest", shadow_mask_gather=veto)
    t_map = draft_t_map(depth, mask, lights, jcfg)
    want = np.asarray(JSP.refine_min_distance_pallas(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), jnp.asarray(t_map), jcfg, interpret=True))
    got = TS.refine_min_distance_batch(*T(depth, mask, lights, t_map), tcfg).numpy()
    offsets = torch.from_numpy(TS.refine_offsets(tcfg)).view(1, -1, 1, 1)
    t = torch.clamp(torch.from_numpy(t_map)[:, None] + offsets, *TS.refine_t_range(tcfg))
    keep = ~zero_weight_corners(depth, mask, lights, tcfg, t)
    assert_march_close(got[keep], want[keep])


def test_wrappers_on_cpu_tensors_are_the_plain_versions():
    depth, mask, lights = scene(seed=11)
    tcfg = TC.RenderConfig(**DRAFT, shadow_mask_cull=True)
    inputs = T(depth, mask, lights)
    before = dict(cuda_lib.LAUNCHES)
    got_d, got_t = shadows_cuda.ray_march_min_distance_cuda(*inputs, tcfg, return_argmin_t=True)
    want_d, want_t = TS.ray_march_min_distance_batch(*inputs, tcfg, return_argmin_t=True)
    np.testing.assert_array_equal(got_d.numpy(), want_d.numpy())
    np.testing.assert_array_equal(got_t.numpy(), want_t.numpy())
    t_map = torch.from_numpy(draft_t_map(depth, mask, lights, JC.RenderConfig(**DRAFT)))
    np.testing.assert_array_equal(
        shadows_cuda.refine_min_distance_cuda(*inputs, t_map, tcfg).numpy(),
        TS.refine_min_distance_batch(*inputs, t_map, tcfg).numpy(),
    )
    assert cuda_lib.LAUNCHES == before


# --------------------------------------------------------------------------- render()


def small_render_inputs(seed=12):
    depth, mask, lights = scene(b=2, seed=seed)
    rng = np.random.default_rng(seed)
    albedo = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return albedo, depth, np.zeros((2, 4), np.float32), mask, lights / 4013.0, np.full((2,), 0.4, np.float32)


@pytest.mark.parametrize("halfwidth", [4, 0], ids=["refine", "upscale"])
def test_draft_render_composes_the_plain_steps(halfwidth):
    albedo, depth, lighting, mask, light, ambient = small_render_inputs()
    cfg = TC.RenderConfig(**dict(DRAFT, shadow_refine_halfwidth=halfwidth, shadow_lowres_t_stride=1),
                          ambient_mode="target", shadow_mask_cull=True, shadow_col_chunk=64)
    out = t_render(*T(albedo, depth, lighting, mask), cfg, *T(light, ambient))
    lp = out.unit_light_direction * cfg.light_distance
    dh, mh, lh, ch = TS.scale_march_inputs(torch.from_numpy(depth), torch.from_numpy(mask), lp, cfg)
    if halfwidth:
        _, t_star = TS.ray_march_min_distance_batch(dh, mh, lh, ch, return_argmin_t=True)
        want = TS.refine_min_distance_batch(torch.from_numpy(depth), torch.from_numpy(mask), lp,
                                            TS.upsample_tstar_nn(t_star, cfg), cfg)
    else:
        want = TS.upscale_min_distance(TS.ray_march_min_distance_batch(dh, mh, lh, ch), cfg)
    np.testing.assert_array_equal(out.min_distance.numpy(), want.numpy())
    assert out.rendered.shape == (2, 64, 64, 3) and torch.isfinite(out.rendered).all()


def golden_inputs(fx, transfer):
    albedo = np.ascontiguousarray(np.moveaxis(fx["albedo"], 1, -1))
    depth = np.ascontiguousarray(fx["depth"][:, 0])
    ambient = fx["target_ambient"] if transfer else np.zeros((1,), np.float32)
    return albedo, depth, np.zeros((1, 4), np.float32), fx["mask"][None], fx["target_light"], ambient


def face_visible_psnr(got, want, mask):
    sq = (got - want) ** 2
    mse = float(np.sum(sq * mask[None, :, :, None]) / (3.0 * max(np.sum(mask), 1.0)))
    return 10.0 * np.log10(1.0 / max(mse, 1e-30))


def draft_cfg(module, transfer, **overrides):
    preset = module.preset_lighting_transfer() if transfer else module.preset_single_image()
    cfg = module.apply_precision_tier(preset, "draft").render
    return dataclasses.replace(cfg, **overrides)


TRANSFER = [f for f in FIXTURES if "transfer" in f]


@pytest.mark.parametrize("name", TRANSFER)
def test_draft_render_matches_jax_onehot(name):
    fx = np.load(GOLDEN / name)
    args = golden_inputs(fx, True)
    onehot = dict(shadow_mask_gather="onehot", shadow_step_pack=1)
    want = j_render(*[jnp.asarray(a) for a in args[:4]], draft_cfg(JC, True, **onehot),
                    target_light=jnp.asarray(args[4]), target_ambient=jnp.asarray(args[5]))
    got = t_render(*T(*args[:4]), draft_cfg(TC, True, **onehot), *T(*args[4:]))
    face = fx["mask"] > 0
    assert face_visible_psnr(got.rendered.numpy(), np.asarray(want.rendered), fx["mask"]) >= 80.0
    sw = np.abs(got.shadow_mask_weights.numpy() - np.asarray(want.shadow_mask_weights))[0][face]
    assert sw.mean() <= 1e-4


@pytest.mark.parametrize("name", FIXTURES)
def test_draft_goldens_match_reference(name):
    assert len(FIXTURES) == 10
    fx = np.load(GOLDEN / name)
    transfer = "transfer" in name
    args = golden_inputs(fx, transfer)
    out = t_render(*T(*args[:4]), draft_cfg(TC, transfer), *T(*args[4:]))
    for field in out._fields:
        assert torch.isfinite(getattr(out, field)).all(), field
    face = fx["mask"] > 0
    if transfer:
        assert face_visible_psnr(out.rendered.numpy(), np.moveaxis(fx["rendered"], 1, -1), fx["mask"]) >= 45.0
    else:
        assert np.abs(out.shadow_mask_weights.numpy()[0] - fx["shadow_weights"][0])[face].mean() <= 1e-2
