"""The Trainer's residency, trace and visuals (32x32, 16 samples, on the CPU).

  * data_residency 'device' gives the streamed batches bit for bit, from a
    uint8 cache (the u8 -> f32 division on both sides) and from float
    synthetic data, and an epoch's losses equal streaming's;
  * 'device' raises over its budget, without whole-set access and on a
    two-rank mesh; 'auto' streams there; 'stream' never uploads the set;
  * profile=True writes a Chrome trace into <workdir>/profile;
  * visualize writes the probe's five PNGs within one level of the JAX
    Trainer.visualize's on the same weights, and index.html lists them;
  * utils/profiling.debug_nans stops at a module's NaN output.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch import train as TT
from geomconsistentfr_torch.convert import state_dict_from_jax_variables
from geomconsistentfr_torch.data import celebahq as TD
from geomconsistentfr_torch.parallel.mesh import Mesh
from geomconsistentfr_torch.utils import profiling
from geomconsistentfr_torch.utils.io import imread
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu import train as JT
from geomconsistentfr_tpu.data import celebahq as JD
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

S = 32


def tiny(cfg, **train):
    return dataclasses.replace(
        cfg,
        render=dataclasses.replace(cfg.render, img_height=S, img_width=S, num_sample_points=16, t_stop=0.105,
                                   march_chunk=16, use_pallas_shadows=False),
        train=dataclasses.replace(cfg.train, **{"batch_size": 2, "batches_per_epoch": 3, **train}),
    )


@pytest.fixture(scope="module")
def u8_cache(tmp_path_factory):
    """A packed cache of 10 samples at 32x32 (uint8 images and masks, float32 depth and light)."""
    cache = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(4)
    for name, (dt, shape) in TD.FIELDS.items():
        shape = tuple(S if d == 256 else d for d in shape)
        arr = (rng.integers(0, 256, (10, *shape)) if dt == np.uint8 else rng.normal(size=(10, *shape))).astype(dt)
        np.save(cache / f"{name}.npy", arr)
    (cache / "meta.json").write_text(json.dumps({"num_samples": 10}))
    return str(cache)


def sources(u8_cache):
    return {"cache": TD.CelebAHQRelightingData(u8_cache), "synthetic": TD.SyntheticFaceData(num_samples=6, size=S)}


def epoch_batches(trainer, epoch=1, start=0):
    rng = np.random.default_rng([trainer.cfg.train.seed, epoch])
    return list(trainer._batches(rng, start))


@pytest.mark.parametrize("source", ["cache", "synthetic"])
def test_resident_batches_are_the_streamed_batches_bit_for_bit(u8_cache, tmp_path, source):
    data = sources(u8_cache)[source]
    dev = TT.Trainer(tiny(TC.preset_target_lighting_train(), data_residency="device"), data,
                     workdir=str(tmp_path / "d"), device="cpu")
    stream = TT.Trainer(tiny(TC.preset_target_lighting_train(), data_residency="stream"), data,
                        workdir=str(tmp_path / "s"), device="cpu")
    resident = dev._resident()
    assert isinstance(resident, TT.DeviceResidentBatches) and stream._resident() is None
    if source == "cache":  # the stored bytes went up, not their float expansion
        assert resident.dataset["image"].dtype == torch.uint8
    for start in (0, 1):
        got, want = epoch_batches(dev, start=start), epoch_batches(stream, start=start)
        assert len(got) == len(want) == 3 - start
        for g, w in zip(got, want):
            assert set(g) == set(w) == set(TD.FIELDS)
            for k in w:
                assert g[k].dtype == w[k].dtype == torch.float32, k
                assert torch.equal(g[k], w[k]), k


def test_a_resident_epoch_trains_as_the_streamed_epoch(u8_cache, tmp_path):
    data = TD.CelebAHQRelightingData(u8_cache)
    metrics = {}
    for residency in ("device", "stream"):
        trainer = TT.Trainer(tiny(TC.preset_target_lighting_train(), data_residency=residency), data,
                             workdir=str(tmp_path / residency), device="cpu")
        _, metrics[residency] = trainer.run_epoch(trainer.init_or_resume(), 0)
    for k in metrics["stream"]:
        if k != "seconds":
            assert metrics["device"][k] == metrics["stream"][k], k


class NoWholeSet:
    """A provider with sample_batch only (no whole-set access)."""

    num_samples = 4

    def __init__(self):
        self.inner = TD.SyntheticFaceData(num_samples=4, size=S)

    def sample_batch(self, rng, batch_size):
        return self.inner.sample_batch(rng, batch_size)


def two_rank_mesh() -> Mesh:
    """Rank 0 of a 1-D mesh of two ranks (no process group is needed to build a Trainer)."""
    return Mesh(("data",), (2,), 0, (0,), (None,), None, torch.device("cpu"))


def test_device_residency_raises_where_it_cannot_and_auto_streams(u8_cache, tmp_path):
    data = TD.CelebAHQRelightingData(u8_cache)
    over = tiny(TC.preset_target_lighting_train(), data_residency="device", device_data_budget_mb=0)
    with pytest.raises(ValueError, match="device_data_budget_mb=0"):
        TT.Trainer(over, data, workdir=str(tmp_path), device="cpu")._resident()
    with pytest.raises(ValueError, match="whole-set access"):
        TT.Trainer(tiny(TC.preset_target_lighting_train(), data_residency="device"), NoWholeSet(),
                   workdir=str(tmp_path), device="cpu")._resident()
    # A mesh of several ranks streams under 'device' too, as the JAX package's Trainer does.
    assert TT.Trainer(tiny(TC.preset_target_lighting_train(), data_residency="device"), data, workdir=str(tmp_path),
                      mesh=two_rank_mesh())._resident() is None
    with pytest.raises(ValueError, match="data_residency must be"):
        TT.Trainer(tiny(TC.preset_target_lighting_train(), data_residency="host"), data, device="cpu")
    auto = tiny(TC.preset_target_lighting_train(), data_residency="auto")
    assert TT.Trainer(dataclasses.replace(auto, train=dataclasses.replace(auto.train, device_data_budget_mb=0)),
                      data, device="cpu")._resident() is None
    assert TT.Trainer(auto, NoWholeSet(), device="cpu")._resident() is None
    assert TT.Trainer(auto, data, mesh=two_rank_mesh())._resident() is None
    assert isinstance(TT.Trainer(auto, data, device="cpu")._resident(), TT.DeviceResidentBatches)
    # A provider without whole-set access still trains, streaming.
    trainer = TT.Trainer(auto, NoWholeSet(), workdir=str(tmp_path / "nw"), device="cpu")
    state, avg = trainer.run_epoch(trainer.init_or_resume(), 0)
    assert state.step == 3 and np.isfinite(avg["total"])


def test_profile_writes_a_chrome_trace(tmp_path):
    cfg = tiny(TC.preset_target_lighting_train(), batches_per_epoch=1)
    trainer = TT.Trainer(cfg, TD.SyntheticFaceData(num_samples=4, size=S), workdir=str(tmp_path), device="cpu",
                         profile=True)
    trainer.run_epoch(trainer.init_or_resume(), 0)
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")
    events = json.loads((tmp_path / "profile" / traces[0]).read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("conv" in n for n in names), sorted(names)[:20]


@pytest.mark.parametrize("epoch", [0, 7])
def test_visualize_matches_jax_within_one_level(tmp_path, epoch):
    jcfg, tcfg = tiny(JC.preset_target_lighting_train()), tiny(TC.preset_target_lighting_train())
    j_trainer = JT.Trainer(jcfg, data=JD.SyntheticFaceData(4, S), workdir=str(tmp_path / "jax"))
    j_state = JT.init_state(jcfg, jax.random.PRNGKey(2))
    t_trainer = TT.Trainer(tcfg, TD.SyntheticFaceData(num_samples=4, size=S), workdir=str(tmp_path / "port"),
                           device="cpu")
    state = TT.init_state(tcfg, device="cpu")
    host = jax.device_get(j_state)
    state.g.load_state_dict(state_dict_from_jax_variables({"params": host.params_g,
                                                           "batch_stats": host.batch_stats_g}))
    j_trainer.visualize(j_state, epoch)
    index = t_trainer.visualize(state, epoch)
    assert state.g.training  # visualize puts the generator back in train mode
    sub = f"epoch_{epoch:04d}"
    for kind in ("input", "albedo", "depth", "shadow", "rendered"):
        got = imread(str(tmp_path / "port" / "visuals" / sub / f"{kind}.png")).astype(int)
        want = imread(str(tmp_path / "jax" / "visuals" / sub / f"{kind}.png")).astype(int)
        assert got.shape == want.shape, kind
        assert np.abs(got - want).max() <= 1, kind
    html = open(index).read()
    for kind in ("input", "albedo", "depth", "shadow", "rendered"):
        assert f"{sub}/{kind}.png" in html
    # A second epoch appends a row; a new Trainer on the same workdir rebuilds the rows from disk.
    t_trainer.visualize(state, epoch + 1)
    fresh = TT.Trainer(tcfg, TD.SyntheticFaceData(num_samples=4, size=S), workdir=str(tmp_path / "port"),
                       device="cpu")
    html = open(fresh.visualize(state, epoch + 2)).read()
    assert all(f"epoch_{e:04d}/rendered.png" in html for e in (epoch, epoch + 1, epoch + 2))


def test_debug_nans_stops_at_the_first_nan_module_output():
    net = torch.nn.Sequential(torch.nn.Linear(3, 3), torch.nn.ReLU())
    x = torch.tensor([[1.0, float("nan"), 0.0]])
    net(x)  # off: no check
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled()
        with pytest.raises(FloatingPointError, match="Linear"):
            net(x)
        net(torch.ones(1, 3))
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()
    net(x)
