"""The port's shadow march vs the JAX package's (64x64, 32 samples).

CPU: the plain march against JAX's pure march (`ray_march_min_distance_batch`,
one-hot veto) and, for the bilinear, 'hat' and 'hat_y' vetoes, against the
Pallas kernel in interpret mode; at the sizes RenderConfig admits beyond the
presets' (rows no 8-row group fills, cull chunks that are no power of two)
and a t table past 1, against JAX's pure march, cull and draft render. Bars are the repo's own kernel-test bars
(tests/test_shadows_pallas.py:44-51): sentinel agreement on >= 0.9999 of
pixels, 0.9999-quantile |d| < 1e-3, mean |d| < 1e-4. The kernel itself is
held against the plain march on the card by tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomconsistentfr_torch.config import RenderConfig as TRenderConfig
from geomconsistentfr_torch.ops import shadows as TS
from geomconsistentfr_torch.ops import cuda_lib, shadows_cuda
from geomconsistentfr_tpu.config import RenderConfig as JRenderConfig
from geomconsistentfr_tpu.ops import shadows as JS
from geomconsistentfr_tpu.ops import shadows_pallas as JSP
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

SMALL = dict(img_height=64, img_width=64, num_sample_points=32, t_start=0.025, t_stop=0.185, march_chunk=32)
FAR_LIGHTS = np.asarray([[0.3, 0.4, 0.866], [-0.6, 0.1, 0.79]], np.float32) * 4013.0


def scene(b, seed=0, face_box=False):
    rng = np.random.default_rng(seed)
    depth = (rng.normal(size=(b, 64, 64)) * 30).astype(np.float32)
    mask = (rng.uniform(size=(b, 64, 64)) > 0.1).astype(np.float32)
    if face_box:
        # A face-like blob: whole off-face 8-row groups and column blocks.
        mask[:, :16] = 0
        mask[:, :, 48:] = 0
    return depth, mask


def assert_march_close(got, want, agree=0.9999):
    big_w, big_g = want >= 1e5, got >= 1e5
    assert (big_w == big_g).mean() >= agree
    diff = np.abs(got - want)[~(big_w | big_g)]
    assert np.quantile(diff, 0.9999) < 1e-3, float(diff.max())
    assert diff.mean() < 1e-4, float(diff.mean())


def port_march(depth, mask, lights, cfg, ts=None):
    return TS.ray_march_min_distance_batch(
        torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(lights), cfg, ts
    ).numpy()


CASES = {
    "plain": dict(),
    "cull_row": dict(shadow_mask_cull=True),
    "cull_col16": dict(shadow_mask_cull=True, shadow_col_chunk=16),
    "gate_inside_image": dict(shadow_bias_gate="inside_image"),
    "gate_wide": dict(shadow_bias_gate="wide"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_march_matches_jax(case):
    depth, mask = scene(2, face_box=True)
    lights = np.concatenate([FAR_LIGHTS, [[0.0, 0.0, 10.0], [4000.0, 0.0, 600.0]]]).astype(np.float32)
    depth = np.concatenate([depth, depth[::-1]])
    mask = np.concatenate([mask, mask[::-1]])
    want = np.asarray(
        JS.ray_march_min_distance_batch(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), JRenderConfig(**SMALL, **CASES[case])
        )
    )
    got = port_march(depth, mask, lights, TRenderConfig(**SMALL, **CASES[case]))
    assert_march_close(got, want)
    if CASES[case].get("shadow_bias_gate"):
        # Lights 2 and 3 sit inside the gate region: culled and vetoed pixels read 1e6 + 5.
        assert got[2].max() == 1e6 + 5.0


def test_plain_march_light_inside_image():
    depth, mask = scene(1, seed=2)
    lights = np.asarray([[5.0, -3.0, 20.0]], np.float32)
    want = np.asarray(
        JS.ray_march_min_distance_batch(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights), JRenderConfig(**SMALL)
        )
    )
    got = port_march(depth, mask, lights, TRenderConfig(**SMALL))
    assert_march_close(got, want)
    single = TS.ray_march_min_distance(
        torch.from_numpy(depth[0]), torch.from_numpy(mask[0]), torch.from_numpy(lights[0]), TRenderConfig(**SMALL)
    )
    np.testing.assert_array_equal(single.numpy(), got[0])


def test_march_over_lights_matches_jax():
    """shadows.ray_march_min_distance_lights, one image under a sweep of lights (L, H, W), against
    the JAX package's vmap over lights (shadows.py:518) at 32x32, 12 samples, at the bars of
    test_plain_march_matches_jax; and bit-equal to the batch march of the image repeated."""
    cfg = dict(img_height=32, img_width=32, num_sample_points=12, t_start=0.025, t_stop=0.085, march_chunk=12,
               shadow_mask_cull=True, shadow_col_chunk=16)
    rng = np.random.default_rng(11)
    depth = (rng.normal(size=(32, 32)) * 20).astype(np.float32)
    mask = (rng.uniform(size=(32, 32)) > 0.1).astype(np.float32)
    mask[:8] = 0.0
    lights = np.concatenate([FAR_LIGHTS, [[0.0, 0.0, 10.0], [4000.0, 0.0, 600.0], [5.0, -3.0, 20.0]]])
    lights = lights.astype(np.float32)
    want = np.asarray(JS.ray_march_min_distance_lights(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(lights),
                                                       JRenderConfig(**cfg)))
    got = TS.ray_march_min_distance_lights(torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(lights),
                                           TRenderConfig(**cfg)).numpy()
    assert got.shape == (5, 32, 32)
    assert_march_close(got, want)
    batch = port_march(np.repeat(depth[None], 5, 0), np.repeat(mask[None], 5, 0), lights, TRenderConfig(**cfg))
    np.testing.assert_array_equal(got, batch)


def test_plain_march_ts_slice():
    depth, mask = scene(2, seed=3)
    ts = JS.sample_ts(JRenderConfig(**SMALL)).astype(np.float32)[5:21]
    want = np.asarray(
        JS.ray_march_min_distance_batch(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(FAR_LIGHTS), JRenderConfig(**SMALL),
            ts=jnp.asarray(ts),
        )
    )
    assert_march_close(port_march(depth, mask, FAR_LIGHTS, TRenderConfig(**SMALL), ts), want)


EXTRAS = {"extra0": dict(), "extra1": dict(shadow_mask_cull=True, shadow_col_chunk=32, shadow_bias_gate="inside_image")}


@pytest.mark.parametrize("veto, extra", [(v, e) for v in ("bilinear", "hat", "hat_y") for e in EXTRAS],
                         ids=[e if v == "bilinear" else f"{v}-{e}" for v in ("bilinear", "hat", "hat_y") for e in EXTRAS])
def test_bilinear_veto_matches_pallas_interpret(veto, extra):
    """K1 under the three vetoes only the Pallas kernel has (shadows_pallas.py:443-496), in
    interpret mode, on noisy terrain with holes at the mask's edges. K2's t* and K3's refine
    under the same vetoes: tests/test_torch_draft.py test_bilinear_argmin_matches_pallas_interpret
    and test_bilinear_refine_matches_pallas_interpret."""
    depth, mask = scene(2, seed=4, face_box=True)
    jcfg = JRenderConfig(**SMALL, shadow_matmul_precision="highest", shadow_mask_gather=veto, **EXTRAS[extra])
    want = np.asarray(
        JSP.ray_march_min_distance_pallas(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(FAR_LIGHTS), jcfg, interpret=True
        )
    )
    got = port_march(depth, mask, FAR_LIGHTS, TRenderConfig(**SMALL, shadow_mask_gather=veto, **EXTRAS[extra]))
    assert_march_close(got, want)


@pytest.mark.parametrize(
    "precision, gather, want",
    [("highest", "auto", "onehot"), ("high", "auto", "onehot"), ("default", "auto", "bilinear"),
     ("default", "onehot", "onehot"), ("highest", "bilinear", "bilinear"), ("highest", "hat", "hat"),
     ("default", "hat_y", "hat_y")],
)
def test_mask_gather_resolution(precision, gather, want):
    cfg = TRenderConfig(shadow_matmul_precision=precision, shadow_mask_gather=gather)
    assert TS.resolve_mask_gather(cfg) == want


def test_wrapper_on_cpu_tensors_is_the_plain_march():
    depth, mask = scene(2, seed=5)
    cfg = TRenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=32)
    before = dict(cuda_lib.LAUNCHES)
    got = shadows_cuda.ray_march_min_distance_cuda(
        torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(FAR_LIGHTS), cfg
    )
    assert cuda_lib.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), port_march(depth, mask, FAR_LIGHTS, cfg))


def test_culled_blocks_read_the_sentinel():
    depth, mask = scene(1, seed=6, face_box=True)
    cfg = TRenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=16)
    got = port_march(depth, mask, FAR_LIGHTS[:1], cfg)
    assert (got[0, :16] == 1e6).all() and (got[0, :, 48:] == 1e6).all()


# Sizes RenderConfig admits beyond the presets': rows that no 8-row cull
# group fills, cull chunks that are no power of two (H, W, shadow_col_chunk).
ADMITTED = {"60x60_row": (60, 60, 0), "40x72_col24": (40, 72, 24), "36x48_col16": (36, 48, 16)}
GRID16 = dict(num_sample_points=16, t_start=0.025, t_stop=0.105, march_chunk=16)


def sized_scene(h, w, seed):
    """Cosine terrain plus noise, an oval face with holes, and lights far, inside and on the border."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    depth = (rng.normal(size=(3, h, w)) + 12 * np.cos(xx / 6.0) * np.sin(yy / 5.0)).astype(np.float32)
    face = ((xx - 0.47 * w) / (0.35 * w)) ** 2 + ((yy - 0.53 * h) / (0.45 * h)) ** 2 <= 1.0
    mask = (face & (rng.uniform(size=(3, h, w)) > 0.05)).astype(np.float32)
    mask[2, : h // 3] = 0.0
    lights = np.asarray([[1203.9, 1605.2, 3475.3], [3.3, -2.7, 20.0], [-w / 2.0, 5.0, 30.0]], np.float32)
    return depth, mask, lights


@pytest.mark.parametrize("shape", list(ADMITTED))
def test_plain_march_and_cull_at_the_sizes_the_config_admits(shape):
    """The plain march (distances and t*) and the cull against JAX's pure march and cull_live_blocks."""
    h, w, chunk = ADMITTED[shape]
    depth, mask, lights = sized_scene(h, w, seed=h + w)
    kw = dict(img_height=h, img_width=w, **GRID16, shadow_mask_cull=True, shadow_col_chunk=chunk,
              shadow_bias_gate="inside_image")
    j_in = [jnp.asarray(a) for a in (depth, mask, lights)]
    want_d, want_t = JS.ray_march_min_distance_batch(*j_in, JRenderConfig(**kw), return_argmin_t=True)
    got_d, got_t = TS.ray_march_min_distance_batch(*map(torch.from_numpy, (depth, mask, lights)),
                                                   TRenderConfig(**kw), return_argmin_t=True)
    assert_march_close(got_d.numpy(), np.asarray(want_d))
    assert (got_t.numpy() == np.asarray(want_t)).mean() >= 0.999
    c = TS.effective_col_chunk(TRenderConfig(**kw))
    blocks = TS.cull_live_blocks(torch.from_numpy(mask), c)
    assert tuple(blocks.shape) == (3, -(-h // 8), w // c)
    want = np.stack([np.asarray(JS.cull_live_blocks(jnp.asarray(m), c)) for m in mask])
    np.testing.assert_array_equal(TS._live_pixels(torch.from_numpy(mask), TRenderConfig(**kw)).numpy(), want)
    assert not want[2, :8].any() and want[2, -1].any()


@pytest.mark.parametrize("shape", list(ADMITTED))
def test_draft_render_at_the_sizes_the_config_admits(shape):
    """render() at the draft scale 2 (a low-resolution march of 30x30, 20x36, 18x24: no 8-row
    group filled) with the refine, one-hot veto, against JAX's draft render (its pure march)."""
    from geomconsistentfr_torch.render import render as t_render
    from geomconsistentfr_tpu.render import render as j_render

    h, w, _ = ADMITTED[shape]
    depth, mask, lights = sized_scene(h, w, seed=h * w)
    rng = np.random.default_rng(h)
    albedo = rng.uniform(size=(3, h, w, 3)).astype(np.float32)
    unit = (lights / np.linalg.norm(lights, axis=1, keepdims=True)).astype(np.float32)
    ambient = np.full((3,), 0.4, np.float32)
    kw = dict(img_height=h, img_width=w, num_sample_points=32, t_start=0.025, t_stop=0.185, march_chunk=32,
              shadow_resolution_scale=2, shadow_refine_halfwidth=4, shadow_lowres_t_stride=2,
              shadow_mask_cull=True, ambient_mode="target")
    args = (albedo, depth, np.zeros((3, 4), np.float32), mask)
    want = j_render(*map(jnp.asarray, args), JRenderConfig(**kw), target_light=jnp.asarray(unit),
                    target_ambient=jnp.asarray(ambient))
    got = t_render(*map(torch.from_numpy, args), TRenderConfig(**kw), torch.from_numpy(unit), torch.from_numpy(ambient))
    # The bars of tests/test_torch_draft.py test_draft_render_matches_jax_onehot: the pooled depth's
    # summation order may move a low-resolution winner, and the refine then searches elsewhere.
    face = mask > 0
    sq = (got.rendered.numpy() - np.asarray(want.rendered)) ** 2
    assert 10.0 * np.log10(1.0 / max(float(np.sum(sq * face[..., None]) / (3.0 * face.sum())), 1e-30)) >= 80.0
    sw = np.abs(got.shadow_mask_weights.numpy() - np.asarray(want.shadow_mask_weights))[face]
    assert sw.mean() <= 1e-4
    # Around JAX's own low-resolution winners, the refine at the march's bars.
    jcfg, tcfg = JRenderConfig(**kw), TRenderConfig(**kw)
    lp = unit * np.float32(jcfg.light_distance)
    j_in = [jnp.asarray(a) for a in (depth, mask, lp)]
    dh, mh, lh, ch = JS.scale_march_inputs(*j_in, jcfg)
    _, t_star = JS.ray_march_min_distance_batch(dh, mh, lh, ch, return_argmin_t=True)
    t_map = np.array(JS.upsample_tstar_nn(t_star, jcfg))
    want_d = np.asarray(JS.refine_min_distance_batch(*j_in, jnp.asarray(t_map), jcfg))
    got_d = TS.refine_min_distance_batch(*map(torch.from_numpy, (depth, mask, lp, t_map)), tcfg)
    assert_march_close(got_d.numpy(), want_d)


def test_plain_march_with_a_table_past_one_matches_jax():
    """A t grid to 1.02 (200 samples): the samples leave the segment and both packages clamp the taps."""
    depth, mask, lights = sized_scene(32, 32, seed=5)
    kw = dict(img_height=32, img_width=32, num_sample_points=200, t_stop=1.025, march_chunk=50,
              shadow_mask_cull=True, shadow_col_chunk=16)
    assert TS.sample_ts(TRenderConfig(**kw)).max() > 1.0
    j_in = [jnp.asarray(a) for a in (depth, mask, lights)]
    want_d, want_t = JS.ray_march_min_distance_batch(*j_in, JRenderConfig(**kw), return_argmin_t=True)
    got_d, got_t = TS.ray_march_min_distance_batch(*map(torch.from_numpy, (depth, mask, lights)),
                                                   TRenderConfig(**kw), return_argmin_t=True)
    assert_march_close(got_d.numpy(), np.asarray(want_d))
    assert (got_t.numpy() == np.asarray(want_t)).mean() >= 0.999
    assert (got_t.numpy() > 1.0).any()
