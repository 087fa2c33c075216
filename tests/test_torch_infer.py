"""The port's Relighter vs the JAX Relighter (64x64, 32 samples, CPU).

Both run the same numpy-drawn weights (carried by
`state_dict_from_jax_variables`) on the same numpy inputs. Bars:
  * strict: rendered PSNR >= 80 dB; the uint8 visual packs differ by at most
    1 on at most 0.1% of bytes;
  * fast and draft (bf16 CNN activations round differently in the two
    frameworks): rendered PSNR >= 40 dB, the bar README.md states for the fast
    path. On the CPU the JAX render takes its pure march and refine with the
    one-hot veto, so this also spans the port's bilinear veto.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.convert import state_dict_from_jax_variables, variables_from_state_dict
from geomconsistentfr_torch.infer import Relighter as TRelighter
from geomconsistentfr_torch.infer import load_relighter
from geomconsistentfr_torch.utils.checkpoint import save_variables
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.infer import Relighter as JRelighter
from geomconsistentfr_tpu.infer import pack_visuals as j_pack_visuals
from geomconsistentfr_tpu.models.relightnet import RelightNet as JRelightNet
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

SMALL = dict(img_height=64, img_width=64, num_sample_points=32, t_stop=0.185, march_chunk=32)
BARS = {"strict": 80.0, "fast": 40.0, "draft": 40.0}


def small_cfg(module, tier, preset="preset_single_image"):
    cfg = module.apply_precision_tier(getattr(module, preset)(), tier)
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL))


def random_variables(variant, seed=0):
    """Flax RelightNet variables with numpy-drawn weights and BN statistics."""
    model = JRelightNet(cfg=JC.ModelConfig(variant=variant))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
        bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
        return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def face_inputs(b, seed=1):
    rng = np.random.default_rng(seed)
    images = rng.uniform(size=(b, 64, 64, 3)).astype(np.float32)
    yy, xx = np.mgrid[:64, :64]
    ellipse = ((xx - 32) / 20.0) ** 2 + ((yy - 34) / 26.0) ** 2 <= 1.0
    masks = np.broadcast_to(ellipse, (b, 64, 64)).astype(np.float32).copy()
    lights = rng.normal(size=(b, 3)).astype(np.float32)
    lights[:, 2] = np.abs(lights[:, 2]) + 0.5
    ambients = rng.uniform(0.3, 0.7, size=(b,)).astype(np.float32)
    return images, masks, lights, ambients


def psnr(a, b):
    mse = float(np.mean((np.asarray(a) - np.asarray(b)) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-30))


@pytest.fixture(scope="module")
def variables():
    return random_variables("target")


@pytest.fixture(scope="module")
def pair(variables):
    """tier -> (JAX Relighter, port Relighter), built once per module so JAX compiles once."""
    built = {}

    def get(tier):
        if tier not in built:
            built[tier] = (
                JRelighter(small_cfg(JC, tier), variables),
                TRelighter(small_cfg(TC, tier), state_dict_from_jax_variables(variables), device="cpu"),
            )
        return built[tier]

    return get


@pytest.mark.parametrize("tier", ["strict", "fast", "draft"])
def test_forward_and_visuals_match_jax(pair, tier):
    jrl, trl = pair(tier)
    images, masks, lights, ambients = face_inputs(3)
    want = jrl.forward(images, masks, lights, ambients)
    got = trl.forward(images, masks, lights, ambients)
    assert psnr(got.rendered.numpy(), want.rendered) >= BARS[tier]
    for field in got._fields:
        assert tuple(getattr(got, field).shape) == tuple(getattr(want, field).shape), field
        assert torch.isfinite(getattr(got, field)).all(), field

    packed = trl.forward_visuals(images, masks, lights, ambients).numpy()
    want_packed = np.asarray(j_pack_visuals(want, jnp.asarray(masks)))
    assert packed.dtype == np.uint8 and packed.shape == (3, 64, 64, 12)
    diff = np.abs(packed.astype(np.int16) - want_packed.astype(np.int16))
    if tier == "strict":
        assert diff.max() <= 1
        assert (diff > 0).mean() <= 1e-3
    # The pack of the port's own outputs equals its float path, byte for byte.
    own = np.floor(np.clip(got.rendered.numpy() * masks[..., None] * 255.0, 0, 255)).astype(np.uint8)
    np.testing.assert_array_equal(packed[..., :3], own)


@pytest.mark.parametrize("tier", ["strict", "fast", "draft"])
def test_sweep_and_transfer_match_jax(pair, tier):
    jrl, trl = pair(tier)
    images, masks, lights, ambients = face_inputs(4, seed=2)
    want = jrl.relight_sweep(images[0], masks[0], lights, ambients)
    got = trl.relight_sweep(images[0], masks[0], lights, ambients)
    assert got.rendered.shape == (4, 64, 64, 3)
    assert psnr(got.rendered.numpy(), want.rendered) >= BARS[tier]
    u8 = trl.relight_sweep_rendered_u8(images[0], masks[0], lights, ambients)
    assert u8.dtype == torch.uint8 and u8.shape == (4, 64, 64, 3)

    want_t = jrl.transfer_lighting(images[:2], images[2:], masks[:2])
    got_t = trl.transfer_lighting(images[:2], images[2:], masks[:2])
    assert psnr(got_t.rendered.numpy(), want_t.rendered) >= BARS[tier]
    unit, amb = trl.estimate_lighting(images[2:])
    j_unit, j_amb = jrl.estimate_lighting(images[2:])
    np.testing.assert_allclose(unit.numpy(), j_unit, atol=1e-4 if tier == "strict" else 2e-2)
    np.testing.assert_allclose(amb.numpy(), j_amb, atol=1e-4 if tier == "strict" else 2e-2)


def test_uint8_inputs_match_float_inputs(pair):
    _, trl = pair("strict")
    images, masks, lights, ambients = face_inputs(2, seed=3)
    images_u8 = (images * 255).astype(np.uint8)
    masks_u8 = (masks * 255).astype(np.uint8)
    a = trl.forward(images_u8, masks_u8, lights, ambients)
    b = trl.forward(images_u8.astype(np.float32) / 255.0, masks, lights, ambients)
    np.testing.assert_array_equal(a.rendered.numpy(), b.rendered.numpy())


def test_load_relighter_embeds_transfer_weights(tmp_path):
    """A transfer-variant .pth drives the target-variant pipeline unchanged."""
    state = state_dict_from_jax_variables(random_variables("transfer", seed=4))
    path = tmp_path / "model.pth"
    torch.save(state, path)
    cfg = small_cfg(TC, "strict")
    loaded = load_relighter(str(path), cfg=cfg, device="cpu")
    assert loaded.model.conv_shortcut_h1_out.weight.shape[2:] == (3, 3)
    direct = TRelighter(
        dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, variant="transfer")), state, device="cpu"
    )
    images, masks, lights, ambients = face_inputs(2, seed=5)
    a = loaded.forward(images, masks, lights, ambients)
    b = direct.forward(images, masks, lights, ambients)
    assert psnr(a.rendered.numpy(), b.rendered.numpy()) >= 100.0
    transfer_cfg = small_cfg(TC, "strict", preset="preset_lighting_transfer")
    same = load_relighter(str(path), cfg=transfer_cfg, device="cpu")
    assert same.model.conv_shortcut_h1_out.weight.shape[2:] == (1, 1)
    # The same weights as an orbax checkpoint directory load to the same function.
    save_variables(str(tmp_path / "ckpt"), variables_from_state_dict(state))
    from_dir = load_relighter(str(tmp_path / "ckpt"), cfg=cfg, device="cpu")
    c = from_dir.forward(images, masks, lights, ambients)
    assert torch.equal(c.rendered, a.rendered) and torch.equal(c.min_distance, a.min_distance)
