"""The port's renderer on the ten golden fixtures (256x256, real presets, CPU).

Each fixture stores the original PyTorch reference's albedo, depth, mask,
light and outputs. The port's `render` (plain march on the CPU) is held
against the stored outputs and against the JAX package's `render` on the
same inputs:
  * shadow-weight mean |d| <= 1e-5 against the reference on every fixture;
  * rendered PSNR >= 100 dB against the reference on the three transfer
    fixtures (the target fixtures were rendered with the reference's own
    estimated ambient, which is not stored, so only shadow weights compare);
  * shadow-weight mean |d| <= 1e-5 against JAX. The two need not agree more
    tightly than each agrees with the reference.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.render import RenderOutputs, render as t_render
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu.render import render as j_render
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).resolve().parent / "golden"
FIXTURES = sorted(p.name for p in GOLDEN.glob("ref_*.npz"))


def inputs(fx, transfer):
    albedo = np.ascontiguousarray(np.moveaxis(fx["albedo"], 1, -1))
    depth = np.ascontiguousarray(fx["depth"][:, 0])
    mask = fx["mask"][None]
    light = fx["target_light"]
    ambient = fx["target_ambient"] if transfer else np.zeros((1,), np.float32)
    lighting = np.zeros((1, 4), np.float32)
    return albedo, depth, lighting, mask, light, ambient


def psnr(a, b):
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-30))


@pytest.mark.parametrize("name", FIXTURES)
def test_render_matches_reference_and_jax(name):
    assert len(FIXTURES) == 10
    fx = np.load(GOLDEN / name)
    transfer = "transfer" in name
    preset = "preset_lighting_transfer" if transfer else "preset_single_image"
    args = inputs(fx, transfer)

    out = t_render(*[torch.from_numpy(a) for a in args[:4]], getattr(TC, preset)().render,
                   target_light=torch.from_numpy(args[4]), target_ambient=torch.from_numpy(args[5]))
    weights = out.shadow_mask_weights.numpy()
    assert np.abs(weights - fx["shadow_weights"]).mean() <= 1e-5
    if transfer:
        assert psnr(out.rendered.numpy(), np.moveaxis(fx["rendered"], 1, -1)) >= 100.0

    want = j_render(*[jnp.asarray(a) for a in args[:4]], getattr(JC, preset)().render,
                    target_light=jnp.asarray(args[4]), target_ambient=jnp.asarray(args[5]))
    assert np.abs(weights - np.asarray(want.shadow_mask_weights)).mean() <= 1e-5
    for field in RenderOutputs._fields:
        assert tuple(getattr(out, field).shape) == tuple(np.shape(getattr(want, field))), field


def test_render_outputs_have_the_jax_fields():
    from geomconsistentfr_tpu.render import RenderOutputs as JOutputs

    assert RenderOutputs._fields == JOutputs._fields
