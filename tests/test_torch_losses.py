"""The port's SSIM, losses and PatchGAN against the JAX package (CPU, small shapes).

The same numpy arrays (seeded) go through both. Bars: scalars and maps at
rtol 1e-5 (float32 summation order; SSIM's valid filtering sums 121 taps in
two passes on both sides), PatchGAN logits and BatchNorm statistics at
rtol = atol = 1e-4 (four convolutions deep, as tests/test_torch_model.py
holds RelightNet).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch import losses as TL
from geomconsistentfr_torch.config import LossConfig as TLossConfig
from geomconsistentfr_torch.convert import state_dict_from_jax_variables
from geomconsistentfr_torch.models.patchgan import PatchGAN as TPatchGAN
from geomconsistentfr_torch.ops import ssim as TS
from geomconsistentfr_tpu import losses as JL
from geomconsistentfr_tpu.config import LossConfig as JLossConfig
from geomconsistentfr_tpu.models.patchgan import PatchGAN as JPatchGAN
from geomconsistentfr_tpu.ops import ssim as JS
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

RTOL = 1e-5


def pair(seed, shape=(2, 32, 32, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + 0.2 * rng.normal(size=shape), 0.0, 1.0).astype(np.float32)
    return x, y


def test_gaussian_window_matches_jax():
    np.testing.assert_array_equal(TS.gaussian_window(), JS.gaussian_window())
    np.testing.assert_array_equal(TS.gaussian_window(7, 1.0), JS.gaussian_window(7, 1.0))


@pytest.mark.parametrize("size_average", [True, False])
@pytest.mark.parametrize("nonnegative", [True, False])
def test_ssim_matches_jax(nonnegative, size_average):
    x, y = pair(0)
    y[1] = 1.0 - x[1]  # an anti-correlated image: its SSIM is negative before the relu
    want = np.asarray(JS.ssim(jnp.asarray(x), jnp.asarray(y), nonnegative=nonnegative, size_average=size_average))
    got = TS.ssim(torch.from_numpy(x), torch.from_numpy(y), nonnegative=nonnegative, size_average=size_average)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-6)
    if not size_average:
        assert (want[1] < 0).any() != nonnegative


def test_dssim_matches_jax():
    x, y = pair(1, (3, 24, 40, 3))
    want = float(JS.dssim(jnp.asarray(x), jnp.asarray(y), data_range=1.0))
    got = float(TS.dssim(torch.from_numpy(x), torch.from_numpy(y), data_range=1.0))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def test_ssim_gradient_matches_jax():
    x, y = pair(2)
    want = np.asarray(jax.grad(lambda a: JS.ssim(a, jnp.asarray(y)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    TS.ssim(xt, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_with_logits_matches_jax(target):
    logits = np.random.default_rng(3).normal(scale=4.0, size=(2, 7, 7, 1)).astype(np.float32)
    want = float(JL.bce_with_logits(jnp.asarray(logits), jnp.full(logits.shape, target)))
    got = float(TL.bce_with_logits(torch.from_numpy(logits), torch.full(logits.shape, target)))
    np.testing.assert_allclose(got, want, rtol=RTOL)


def loss_inputs(seed=4, b=2, s=32):
    rng = np.random.default_rng(seed)
    unit = rng.normal(size=(b, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    face = (rng.uniform(size=(b, s, s)) > 0.3).astype(np.float32)
    return dict(
        rendered=rng.uniform(size=(b, s, s, 3)).astype(np.float32),
        images=rng.uniform(size=(b, s, s, 3)).astype(np.float32),
        depth=rng.normal(scale=30.0, size=(b, s, s)).astype(np.float32),
        depth_gt=rng.normal(scale=30.0, size=(b, s, s)).astype(np.float32),
        depth_mask=(rng.uniform(size=(b, s, s)) > 0.2).astype(np.float32),
        albedo=rng.uniform(size=(b, s, s, 3)).astype(np.float32),
        albedo_gt=rng.uniform(size=(b, s, s)).astype(np.float32),
        face_mask=face,
        est_ambient=rng.uniform(size=(b,)).astype(np.float32),
        est_unit_dir=unit,
        light_gt=np.tile(np.asarray([[0.0, 0.7071, 0.7071]], np.float32), (b, 1)),
        fake_logits=rng.normal(size=(b, 3, 3, 1)).astype(np.float32),
    )


def test_generator_losses_match_jax():
    inputs = loss_inputs()
    want = JL.generator_losses(**{k: jnp.asarray(v) for k, v in inputs.items()}, cfg=JLossConfig())
    got = TL.generator_losses(**{k: torch.from_numpy(v) for k, v in inputs.items()}, cfg=TLossConfig())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)


def test_discriminator_losses_match_jax():
    rng = np.random.default_rng(5)
    fake, real = (rng.normal(size=(2, 3, 3, 1)).astype(np.float32) for _ in range(2))
    want = JL.discriminator_losses(jnp.asarray(fake), jnp.asarray(real), JLossConfig())
    got = TL.discriminator_losses(torch.from_numpy(fake), torch.from_numpy(real), TLossConfig())
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL, err_msg=k)


def test_composite_and_psnr_match_jax():
    inputs = loss_inputs(seed=6)
    r, i, m = (inputs[k] for k in ("rendered", "images", "face_mask"))
    want = np.asarray(JL.masked_composite(jnp.asarray(r), jnp.asarray(i), jnp.asarray(m)))
    got = TL.masked_composite(*map(torch.from_numpy, (r, i, m)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(float(TL.psnr(torch.from_numpy(r), torch.from_numpy(i))),
                               float(JL.psnr(jnp.asarray(r), jnp.asarray(i))), rtol=RTOL)


@pytest.fixture(scope="module")
def patchgan_pair():
    """Flax PatchGAN variables with numpy-drawn weights and BN statistics, and the port's copy."""
    model = JPatchGAN()
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    rng = np.random.default_rng(7)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        bound = 1.0 / np.sqrt(int(np.prod(leaf.shape[:-1])))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    port = TPatchGAN()
    port.load_state_dict(state_dict_from_jax_variables(variables))
    images = np.random.default_rng(8).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    return model, variables, port, images


def test_patchgan_eval_forward_matches_flax(patchgan_pair):
    model, variables, port, images = patchgan_pair
    want = np.asarray(model.apply(variables, jnp.asarray(images), train=False))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(images))
    assert got.shape == want.shape == (2, 3, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_patchgan_train_forward_and_batch_stats_match_flax(patchgan_pair):
    model, variables, port, images = patchgan_pair
    port = TPatchGAN()
    port.load_state_dict(state_dict_from_jax_variables(variables))
    want, mutated = model.apply(variables, jnp.asarray(images), train=True, mutable=["batch_stats"])
    got = port.train()(torch.from_numpy(images))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    want_stats = state_dict_from_jax_variables({"params": variables["params"], **mutated})
    for name, value in port.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(value.numpy(), want_stats[name].numpy(), rtol=1e-4, atol=1e-4, err_msg=name)
