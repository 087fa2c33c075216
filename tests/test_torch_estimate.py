"""The estimate pass: `Relighter.estimate_lighting` runs RelightNet's encoder and
lighting head alone (`RelightNet.estimate`).

Its (unit, ambient) is bit-equal to `estimated_light` of the full forward's
lighting, in both variants and at every tier, and no decoder module runs
and no decoder span opens. CPU, seeded random weights, 32x32 images.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models import layers, relightnet
from geomconsistentfr_torch.models.layers import deterministic_convs
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.render import estimated_light
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

S = 32
PRESETS = {"target": TC.preset_single_image, "transfer": TC.preset_lighting_transfer}
# Every module of the two decoders: their deconvs, skip and output convs and BatchNorms.
DECODER_MODULE = re.compile(r"^(deconv|conv|bn)_(albedo|depth)_|_c2_")


def relighter(variant, tier, seed=0):
    cfg = TC.apply_precision_tier(PRESETS[variant](), tier)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, img_height=S, img_width=S))
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(seed)).state_dict()
    # BatchNorm statistics away from (0, 1), so that every BatchNorm moves the lighting.
    gen = torch.Generator().manual_seed(seed + 1)
    for key, value in state.items():
        if key.endswith("running_mean"):
            state[key] = 0.1 * torch.randn(value.shape, generator=gen)
        elif key.endswith("running_var"):
            state[key] = 0.5 + torch.rand(value.shape, generator=gen)
    return Relighter(cfg, state, device="cpu")


def images(b, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (b, S, S, 3), dtype=np.uint8)


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("tier", TC.PRECISION_TIERS)
@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_estimate_is_bit_equal_to_the_full_forward(variant, tier, batch):
    rl = relighter(variant, tier)
    imgs = images(batch)
    unit, ambient = rl.estimate_lighting(imgs)
    with torch.no_grad(), deterministic_convs():
        lighting = rl.model(rl._as_input(imgs), rl.use_skips).lighting
    want_unit, want_ambient = estimated_light(lighting, rl.cfg.render)
    assert unit.shape == (batch, 3) and ambient.shape == (batch,)
    assert torch.equal(unit, want_unit) and torch.equal(ambient, want_ambient)


def decoder_runs(model, monkeypatch):
    """The list of decoder modules run, by name: forward hooks on each (the eager
    epilogue calls its BatchNorms) and each convolution applied through `layers.conv`."""
    names = {module: name for name, module in model.named_modules() if DECODER_MODULE.search(name)}
    ran = []
    for module, name in names.items():
        module.register_forward_hook(lambda _m, _i, _o, name=name: ran.append(name))
    real_conv = layers.conv

    def conv(module, *args, **kwargs):
        if module in names:
            ran.append(names[module])
        return real_conv(module, *args, **kwargs)

    monkeypatch.setattr(layers, "conv", conv)
    monkeypatch.setattr(relightnet, "conv", conv)
    return set(names.values()), ran


def gcfr_span_names(prof):
    return [ev.name for ev in prof.events() if ev.name.startswith("gcfr.")]


@pytest.mark.parametrize("variant", ["target", "transfer"])
def test_estimate_runs_no_decoder_module_and_opens_no_decoder_span(variant, monkeypatch):
    rl = relighter(variant, "strict")
    imgs = images(2)
    every, ran = decoder_runs(rl.model, monkeypatch)
    # A decoder: 4 stages' two deconvs, 3 shortcut deconvs, 8 skip convs and 3 head convs, each
    # with a BatchNorm (44 modules), and the output conv.
    assert len(every) == 2 * 45
    # The witness sees the decoders: the full forward runs each of their modules.
    with torch.no_grad():
        rl.model(rl._as_input(imgs))
    assert set(ran) == every
    ran.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        rl.estimate_lighting(imgs)
    assert ran == []
    spans = gcfr_span_names(prof)
    assert sorted(spans) == ["gcfr.cnn", "gcfr.cnn.encoder", "gcfr.cnn.lighting_head", "gcfr.upload"]
