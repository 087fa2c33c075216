"""The port's `gcfr.*` spans (utils/profiling.span) on the relight path and in the training step.

Under torch.profiler each entry point opens its spans once a call, nested as
the profiling module lists them; with the profiler off `span` hands back one
shared null context and no `record_function` is made. The spans change no
output. CPU, 32x32 images, 16 samples.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch.data.celebahq import SyntheticFaceData
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.train import Trainer
from geomconsistentfr_torch.utils import profiling
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

S = 32
SMALL = dict(img_height=S, img_width=S, num_sample_points=16, t_stop=0.105, march_chunk=16)

# Each relight span and the innermost gcfr.* span around it (None: none).
RELIGHT_NESTING = {
    "gcfr.upload": None,
    "gcfr.cnn": None,
    "gcfr.cnn.encoder": "gcfr.cnn",
    "gcfr.cnn.lighting_head": "gcfr.cnn",
    "gcfr.cnn.decoder_albedo": "gcfr.cnn",
    "gcfr.cnn.decoder_depth": "gcfr.cnn",
    "gcfr.render": None,
    "gcfr.render.march": "gcfr.render",
    "gcfr.pack": None,
}
TRAIN_SPANS = ("gcfr.train.batch", "gcfr.train.forward", "gcfr.train.backward", "gcfr.train.optimizer")


def small_cfg(preset):
    cfg = preset()
    return dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL))


@pytest.fixture(scope="module")
def relighter():
    cfg = small_cfg(TC.preset_single_image)
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    return Relighter(cfg, state, device="cpu")


def inputs(b=2):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (b, S, S, 3), dtype=np.uint8)
    yy, xx = np.mgrid[:S, :S]
    mask = (((xx - 16) / 10.0) ** 2 + ((yy - 17) / 13.0) ** 2 <= 1.0).astype(np.uint8) * 255
    lights = np.tile(np.array([[0.3, 0.4, 0.87]], np.float32), (b, 1))
    return images, np.broadcast_to(mask, (b, S, S)).copy(), lights


def gcfr_spans(prof):
    """{name: [name of the innermost gcfr.* span around each occurrence]} of the trace's gcfr.* spans."""
    found = {}
    for ev in prof.events():
        if not ev.name.startswith("gcfr."):
            continue
        parent = ev.cpu_parent
        while parent is not None and not parent.name.startswith("gcfr."):
            parent = parent.cpu_parent
        found.setdefault(ev.name, []).append(None if parent is None else parent.name)
    return found


def test_forward_visuals_opens_each_span_once_nested(relighter):
    images, masks, lights = inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        relighter.forward_visuals(images, masks, target_light=lights)
    assert gcfr_spans(prof) == {name: [parent] for name, parent in RELIGHT_NESTING.items()}


def test_sweep_opens_upload_cnn_render_and_pack(relighter):
    images, masks, lights = inputs(3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        relighter.relight_sweep_rendered_u8(images[0], masks[0], lights)
    found = gcfr_spans(prof)
    for name in ("gcfr.upload", "gcfr.cnn", "gcfr.render", "gcfr.pack"):
        assert found[name] == [None], name
    assert found["gcfr.render.march"] == ["gcfr.render"]
    assert found["gcfr.cnn.encoder"] == ["gcfr.cnn"]


def test_estimate_opens_upload_cnn_encoder_and_head_only(relighter):
    images, _, _ = inputs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        relighter.estimate_lighting(images)
    assert gcfr_spans(prof) == {"gcfr.upload": [None], "gcfr.cnn": [None],
                                "gcfr.cnn.encoder": ["gcfr.cnn"], "gcfr.cnn.lighting_head": ["gcfr.cnn"]}


def test_span_is_one_shared_null_context_with_the_profiler_off(relighter, monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) made with the profiler off")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("gcfr.upload") is profiling.span("gcfr.pack")
    assert profiling.span("gcfr.upload") is profiling._NO_SPAN
    images, masks, lights = inputs()
    relighter.forward_visuals(images, masks, target_light=lights)
    relighter.relight_sweep_rendered_u8(images[0], masks[0], lights)
    relighter.estimate_lighting(images)


def test_span_is_a_record_function_under_the_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("gcfr.pack"), torch.profiler.record_function)
    assert profiling.span("gcfr.pack") is profiling._NO_SPAN


def test_forward_visuals_bytes_equal_with_the_profiler_on_and_off(relighter):
    images, masks, lights = inputs()
    off = relighter.forward_visuals(images, masks, target_light=lights)
    with profile(activities=[ProfilerActivity.CPU]):
        on = relighter.forward_visuals(images, masks, target_light=lights)
    assert off.dtype == torch.uint8 and torch.equal(on, off)


def test_training_spans_open_once_a_step(tmp_path):
    cfg = small_cfg(TC.preset_target_lighting_train)
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, use_pallas_shadows=False),
                              train=dataclasses.replace(cfg.train, batch_size=2, batches_per_epoch=2))
    trainer = Trainer(cfg, SyntheticFaceData(num_samples=4, size=S), workdir=str(tmp_path), device="cpu")
    state = trainer.init_or_resume(torch.Generator().manual_seed(0))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run_epoch(state, 0)
    found = gcfr_spans(prof)
    for name in TRAIN_SPANS:
        assert found[name] == [None, None], name
    # The relight path's spans open inside the step's forward.
    assert found["gcfr.render"] == ["gcfr.train.forward"] * 2
    assert found["gcfr.cnn.encoder"] == ["gcfr.train.forward"] * 2
