"""The port's config copy equals the JAX package's, field by field."""

import dataclasses

import pytest

from geomconsistentfr_torch import config as T
from geomconsistentfr_tpu import config as J

TIERS = (None,) + J.PRECISION_TIERS


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("preset", sorted(J.PRESETS))
def test_presets_and_tiers_match(preset, tier):
    want = J.PRESETS[preset]()
    got = T.PRESETS[preset]()
    if tier is not None:
        want = J.apply_precision_tier(want, tier)
        got = T.apply_precision_tier(got, tier)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize(
    "cls", ["RenderConfig", "ModelConfig", "PatchGANConfig", "LossConfig", "TrainConfig", "PipelineConfig"]
)
def test_dataclass_fields_match(cls):
    want = [(f.name, f.type) for f in dataclasses.fields(getattr(J, cls))]
    got = [(f.name, f.type) for f in dataclasses.fields(getattr(T, cls))]
    assert got == want
    assert dataclasses.asdict(getattr(T, cls)()) == dataclasses.asdict(getattr(J, cls)())


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(img_height=63),
        dict(shadow_resolution_scale=3),
        dict(shadow_resolution_scale=4, img_height=76),
        dict(shadow_lowres_t_stride=2),
        dict(shadow_col_chunk=12),
        dict(shadow_col_chunk=48),
        dict(shadow_step_pack=3),
        dict(shadow_step_pack=2, shadow_mask_gather="onehot"),
    ],
)
def test_render_config_validation_matches(kwargs):
    with pytest.raises(ValueError) as want:
        J.RenderConfig(**kwargs)
    with pytest.raises(ValueError) as got:
        T.RenderConfig(**kwargs)
    assert str(got.value) == str(want.value)


def test_unknown_tier_raises():
    with pytest.raises(ValueError):
        T.apply_precision_tier(T.PipelineConfig(), "turbo")
