"""The port's shadow march vs the JAX package's (64x64, 32 samples).

CPU: the plain march against JAX's pure march (`ray_march_min_distance_batch`,
one-hot veto) and, for the bilinear veto, against the Pallas kernel in
interpret mode. Bars are the repo's own kernel-test bars
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
from geomconsistentfr_torch.ops import shadows_cuda
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


@pytest.mark.parametrize("extra", [dict(), dict(shadow_mask_cull=True, shadow_col_chunk=32, shadow_bias_gate="inside_image")])
def test_bilinear_veto_matches_pallas_interpret(extra):
    depth, mask = scene(2, seed=4, face_box=True)
    jcfg = JRenderConfig(**SMALL, shadow_matmul_precision="highest", shadow_mask_gather="bilinear", **extra)
    want = np.asarray(
        JSP.ray_march_min_distance_pallas(
            jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(FAR_LIGHTS), jcfg, interpret=True
        )
    )
    got = port_march(depth, mask, FAR_LIGHTS, TRenderConfig(**SMALL, shadow_mask_gather="bilinear", **extra))
    assert_march_close(got, want)


@pytest.mark.parametrize(
    "precision, gather, want",
    [("highest", "auto", "onehot"), ("high", "auto", "onehot"), ("default", "auto", "bilinear"),
     ("default", "onehot", "onehot"), ("highest", "bilinear", "bilinear")],
)
def test_mask_gather_resolution(precision, gather, want):
    cfg = TRenderConfig(shadow_matmul_precision=precision, shadow_mask_gather=gather)
    assert TS.resolve_mask_gather(cfg) == want


def test_tpu_only_veto_modes_raise():
    with pytest.raises(NotImplementedError):
        TS.resolve_mask_gather(TRenderConfig(shadow_mask_gather="hat"))


def test_wrapper_on_cpu_tensors_is_the_plain_march():
    depth, mask = scene(2, seed=5)
    cfg = TRenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=32)
    before = dict(shadows_cuda.LAUNCHES)
    got = shadows_cuda.ray_march_min_distance_cuda(
        torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(FAR_LIGHTS), cfg
    )
    assert shadows_cuda.LAUNCHES == before
    np.testing.assert_array_equal(got.numpy(), port_march(depth, mask, FAR_LIGHTS, cfg))


def test_culled_blocks_read_the_sentinel():
    depth, mask = scene(1, seed=6, face_box=True)
    cfg = TRenderConfig(**SMALL, shadow_mask_cull=True, shadow_col_chunk=16)
    got = port_march(depth, mask, FAR_LIGHTS[:1], cfg)
    assert (got[0, :16] == 1e6).all() and (got[0, :, 48:] == 1e6).all()
