"""The port's training step and Trainer against the JAX package (CPU, tiny shapes).

`train_step` runs six steps from the JAX state's weights on the batches of
tests/test_train.py (32x32, 16 samples, batch 2), against JAX's
`make_single_device_step`, in both RelightNet variants; step 0 and step 5
update D (gd_ratio 5). The run uses a learning rate of 1e-6, not the preset's
1e-4: Adam turns the float32 rounding in near-zero gradients (conv biases
feeding a train-mode BatchNorm get nothing but rounding) into +-lr updates,
and the BatchNorm variance E[x^2] - E[x]^2 amplifies them, so at 1e-4 the
reference's own trajectory, from weights perturbed by 1e-6 relative, parts
from the unperturbed one by percents within six steps. At 1e-6 the
trajectories stay together and the comparison can be tight. Bars, each
about ten times the largest value this test gives on the target variant:
  * each loss term, every step: rtol 1e-3 (measured 1.1e-4);
  * the parameter updates after six steps, sum |dp_port - dp_jax| / sum
    |dp_jax|: G 4e-2, D 5e-3 (measured 4.0e-3, 3.5e-4);
  * BatchNorm running statistics: max |d| <= 1e-3 * max |stat| per tensor
    (measured 1.9e-5 G, 9.7e-5 D);
  * Adam's moments, sum |d| / sum |ref| over all parameters: G 1e-1, D 1e-2
    (measured 1.4e-2 / 7.4e-3 G, 1.0e-3 / 1.2e-3 D; a tensor whose gradient
    is rounding alone differs wholly, but weighs little in the sum);
  * Adam's step counts: equal (6 for G, 2 for D), every parameter.
The rest holds the Trainer to the JAX Trainer's semantics (tests/test_train.py
:121-311): determinism, resume at an epoch and inside one, retention, the
metrics export; and the data sources to JAX's bit for bit.
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
from geomconsistentfr_torch.convert import adam_moments_from_optax, state_dict_from_jax_variables
from geomconsistentfr_torch.data import celebahq as TD
from geomconsistentfr_torch.parallel.mesh import Mesh
from geomconsistentfr_torch.utils import checkpoint as ckpt
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu import train as JT
from geomconsistentfr_tpu.data import celebahq as JD
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

STEPS = 6
LR = 1e-6


def tiny(cfg, batch=2, lr=None):
    """tests/test_train.py's _tiny_cfg, on either package's config."""
    train = dataclasses.replace(cfg.train, batch_size=batch)
    if lr is not None:
        train = dataclasses.replace(train, learning_rate=lr)
    return dataclasses.replace(
        cfg,
        render=dataclasses.replace(cfg.render, img_height=32, img_width=32, num_sample_points=16, t_stop=0.105,
                                   march_chunk=16, use_pallas_shadows=False),
        train=train,
    )


def batch(rng, b, s):
    """tests/test_train.py's _batch."""
    return {
        "image": rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32),
        "face_mask": np.ones((b, s, s), np.float32),
        "depth_gt": rng.normal(size=(b, s, s)).astype(np.float32),
        "depth_mask": np.ones((b, s, s), np.float32),
        "albedo_gt": rng.uniform(0, 1, (b, s, s)).astype(np.float32),
        "light_gt": np.tile(np.asarray([[0.0, 0.7071, 0.7071]], np.float32), (b, 1)),
    }


PRESETS = {"target": "preset_target_lighting_train", "transfer": "preset_transfer_train"}


@pytest.fixture(scope="module", params=["target", "transfer"])
def six_steps(request):
    """Six JAX steps and six port steps from the same weights and batches."""
    variant = request.param
    jcfg = tiny(getattr(JC, PRESETS[variant])(), lr=LR)
    tcfg = tiny(getattr(TC, PRESETS[variant])(), lr=LR)
    use_skips = (False,) * 4 if variant == "target" else (True,) * 4
    rng = np.random.default_rng(0)
    batches = [batch(rng, 2, 32) for _ in range(STEPS)]

    j0 = JT.init_state(jcfg, jax.random.PRNGKey(0))
    step = JT.make_single_device_step(jcfg)
    js, j_losses = j0, []
    for b in batches:
        js, m = step(js, b, use_skips)
        j_losses.append({k: float(v) for k, v in m.items()})

    host0 = jax.device_get(j0)
    state = TT.init_state(tcfg, device="cpu")
    state.g.load_state_dict(state_dict_from_jax_variables({"params": host0.params_g,
                                                           "batch_stats": host0.batch_stats_g}))
    state.d.load_state_dict(state_dict_from_jax_variables({"params": host0.params_d,
                                                           "batch_stats": host0.batch_stats_d}))
    t_losses = [{k: float(v) for k, v in TT.train_step(state, TT.decode_batch(b, "cpu"), tcfg, use_skips).items()}
                for b in batches]
    return dict(host0=host0, js=jax.device_get(js), j_losses=j_losses, state=state, t_losses=t_losses)


def sum_rel(got: dict, want: dict) -> float:
    return sum(float((got[k] - want[k]).abs().sum()) for k in want) / sum(float(want[k].abs().sum()) for k in want)


def modules(run):
    js, h0, st = run["js"], run["host0"], run["state"]
    return (("g", st.g, st.opt_g, js.params_g, js.batch_stats_g, js.opt_g, h0.params_g),
            ("d", st.d, st.opt_d, js.params_d, js.batch_stats_d, js.opt_d, h0.params_d))


def test_six_steps_losses_match_jax(six_steps):
    assert len(six_steps["t_losses"]) == STEPS
    for i, (got, want) in enumerate(zip(six_steps["t_losses"], six_steps["j_losses"])):
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=f"step {i} {k}")


def test_six_steps_parameter_updates_match_jax(six_steps):
    bars = {"g": 4e-2, "d": 5e-3}
    for name, module, _, params, _, _, params0 in modules(six_steps):
        start = state_dict_from_jax_variables({"params": params0})
        want = state_dict_from_jax_variables({"params": params})
        got = {k: v.detach() for k, v in module.named_parameters()}
        moved = {k: got[k] - start[k] for k in start}
        assert sum_rel(moved, {k: want[k] - start[k] for k in start}) <= bars[name], name
    # D stepped twice (steps 0 and 5); a port that stepped it every time would be far off.
    assert six_steps["state"].step == STEPS


def test_six_steps_batch_stats_match_jax(six_steps):
    for name, module, _, params, stats, _, _ in modules(six_steps):
        want = state_dict_from_jax_variables({"params": params, "batch_stats": stats})
        for k, v in module.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                assert (v - want[k]).abs().max().item() <= 1e-3 * want[k].abs().max().item(), (name, k)


def test_six_steps_adam_moments_and_counts_match_jax(six_steps):
    bars = {"g": 1e-1, "d": 1e-2}
    counts = {"g": STEPS, "d": 2}
    for name, module, opt, _, _, opt_state, _ in modules(six_steps):
        adam = opt_state[0]
        assert int(adam.count) == counts[name]
        mu, nu = adam_moments_from_optax(adam.mu, adam.nu)
        t_mu, t_nu = TT.adam_moments(opt, module)
        assert set(t_mu) == set(mu)
        assert sum_rel(t_mu, mu) <= bars[name] and sum_rel(t_nu, nu) <= bars[name], name
        for p in module.parameters():
            assert int(opt.state[p]["step"]) == counts[name]


# ---------------------------------------------------------------------------
# Trainer semantics (port only), as tests/test_train.py:121-311 holds JAX's
# ---------------------------------------------------------------------------


def trainer_cfg(**train):
    cfg = tiny(TC.preset_target_lighting_train())
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train))


def states_equal(a: TT.TrainState, b: TT.TrainState) -> None:
    assert a.step == b.step
    for x, y in ((a.g, b.g), (a.d, b.d)):
        for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(v, w), k
    for x, y in ((a.opt_g, b.opt_g), (a.opt_d, b.opt_d)):
        for s, t in zip(x.state_dict()["state"].values(), y.state_dict()["state"].values()):
            for k in s:
                assert torch.equal(torch.as_tensor(s[k]), torch.as_tensor(t[k])), k


def test_training_is_deterministic():
    cfg = trainer_cfg(batch_size=1)
    b = TT.decode_batch(batch(np.random.default_rng(3), 1, 32), "cpu")

    def run():
        state = TT.init_state(cfg, "cpu", torch.Generator().manual_seed(7))
        for _ in range(2):
            TT.train_step(state, b, cfg, (False,) * 4)
        return state

    states_equal(run(), run())


def test_save_restore_mid_run_equivalence(tmp_path):
    cfg = trainer_cfg(batch_size=1)
    rng = np.random.default_rng(4)
    b1, b2 = (TT.decode_batch(batch(rng, 1, 32), "cpu") for _ in range(2))
    us = (False,) * 4

    straight = TT.init_state(cfg, "cpu", torch.Generator().manual_seed(9))
    TT.train_step(straight, b1, cfg, us)
    trainer = TT.Trainer(cfg, workdir=str(tmp_path), device="cpu")
    path = trainer.save(straight)
    assert os.path.basename(path) == "step_00000001"
    TT.train_step(straight, b2, cfg, us)

    resumed = trainer.init_or_resume(torch.Generator().manual_seed(1))  # other weights, replaced by the checkpoint
    assert resumed.step == 1
    TT.train_step(resumed, b2, cfg, us)
    states_equal(straight, resumed)


def test_resume_replays_uninterrupted_batch_order(tmp_path):
    cfg = trainer_cfg(batches_per_epoch=3, log_every_steps=1, checkpoint_every_steps=0)
    data = TD.SyntheticFaceData(num_samples=8, size=32)

    a = TT.Trainer(cfg, data=data, workdir=str(tmp_path / "straight"), device="cpu")
    state = a.init_or_resume()
    state, _ = a.run_epoch(state, 0)
    a.save(state)
    state, m1_a = a.run_epoch(state, 1)

    b = TT.Trainer(cfg, data=data, workdir=str(tmp_path / "resumed"), device="cpu")
    state_b = b.init_or_resume()
    state_b, _ = b.run_epoch(state_b, 0)
    b.save(state_b)
    c = TT.Trainer(cfg, data=data, workdir=str(tmp_path / "resumed"), device="cpu")
    state_c = c.init_or_resume()
    start_epoch = state_c.step // cfg.train.batches_per_epoch
    assert start_epoch == 1
    state_c, m1_c = c.run_epoch(state_c, start_epoch)
    for k in m1_a:
        if k != "seconds":
            assert m1_a[k] == m1_c[k], k
    states_equal(state, state_c)


class _CrashAfter:
    """Data wrapper that simulates a crash on the n+1-th batch draw."""

    def __init__(self, inner, n_calls: int):
        self.inner, self.n, self.calls = inner, n_calls, 0

    def sample_batch(self, rng, batch_size):
        self.calls += 1
        if self.calls > self.n:
            raise RuntimeError("simulated crash")
        return self.inner.sample_batch(rng, batch_size)


def test_mid_epoch_resume_matches_uninterrupted(tmp_path):
    cfg = trainer_cfg(batches_per_epoch=4, log_every_steps=1, checkpoint_every_steps=2)
    data = TD.SyntheticFaceData(num_samples=8, size=32)

    a = TT.Trainer(cfg, data=data, workdir=str(tmp_path / "straight"), device="cpu")
    state_a = a.init_or_resume()
    state_a, _ = a.run_epoch(state_a, 0)
    state_a, m1_a = a.run_epoch(state_a, 1)

    b = TT.Trainer(cfg, data=_CrashAfter(data, 3), workdir=str(tmp_path / "crashed"), device="cpu")
    state_b = b.init_or_resume()
    with pytest.raises(RuntimeError, match="simulated crash"):
        b.run_epoch(state_b, 0)

    c = TT.Trainer(cfg, data=data, workdir=str(tmp_path / "crashed"), device="cpu")
    state_c = c.init_or_resume()
    start_epoch, start_batch = divmod(state_c.step, cfg.train.batches_per_epoch)
    assert (start_epoch, start_batch) == (0, 2)
    state_c, _ = c.run_epoch(state_c, 0, start_batch=start_batch)
    assert state_c.step == 4
    state_c, m1_c = c.run_epoch(state_c, 1)
    for k in m1_a:
        if k != "seconds":
            assert m1_a[k] == m1_c[k], k
    states_equal(state_a, state_c)


def test_retention_keeps_the_newest_checkpoints(tmp_path):
    cfg = trainer_cfg(keep_checkpoints=2)
    trainer = TT.Trainer(cfg, workdir=str(tmp_path), device="cpu")
    state = TT.init_state(cfg, "cpu")
    for step in (3, 1, 7, 5):
        state.step = step
        trainer.save(state)
    root = trainer.checkpoint_root
    assert sorted(os.listdir(root)) == ["step_00000005", "step_00000007"]
    assert ckpt.latest_step_dir(root) == os.path.join(root, "step_00000007")
    assert ckpt.prune_step_dirs(root, 0) == []
    assert trainer.init_or_resume().step == 7


def test_run_epoch_exports_metrics(tmp_path):
    cfg = trainer_cfg(batches_per_epoch=2, log_every_steps=1, checkpoint_every_steps=0)
    trainer = TT.Trainer(cfg, data=TD.SyntheticFaceData(num_samples=4, size=32), workdir=str(tmp_path), device="cpu")
    state, avg = trainer.run_epoch(trainer.init_or_resume(), 0)
    assert state.step == 2 and all(np.isfinite(v) for v in avg.values())
    lines = (tmp_path / "losses" / "metrics.csv").read_text().splitlines()
    assert lines[0].split(",") == sorted(avg) and len(lines) == 2
    import scipy.io

    mat = scipy.io.loadmat(str(tmp_path / "losses" / "losses_epoch0.mat"))
    np.testing.assert_allclose(mat["total"].item(), avg["total"], rtol=1e-6)


def test_trainer_refuses_what_it_does_not_do():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TT.Trainer(trainer_cfg())  # no CUDA device here, and no device asked for
    # The whole set on the device runs on one rank (tests/test_torch_train_surface.py runs it);
    # on a mesh of several ranks 'device' streams, as the JAX package's Trainer does
    # (tests/test_torch_parallel.py runs it on two ranks).
    two_ranks = Mesh(("data",), (2,), 0, (0,), (None,), None, torch.device("cpu"))
    assert TT.Trainer(trainer_cfg(data_residency="device"), data=TD.SyntheticFaceData(4, size=32),
                      mesh=two_ranks)._resident() is None
    assert isinstance(TT.Trainer(trainer_cfg(data_residency="device"), data=TD.SyntheticFaceData(4, size=32),
                                 device="cpu")._resident(), TT.DeviceResidentBatches)


# ---------------------------------------------------------------------------
# Data: the port's numpy copies against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_faces_equal_jax_bit_for_bit(seed):
    port, ref = TD.SyntheticFaceData(num_samples=4, size=32, seed=seed), JD.SyntheticFaceData(4, 32, seed)
    got = port.sample_batch(np.random.default_rng(1), 3)
    want = ref.sample_batch(np.random.default_rng(1), 3)
    assert set(got) == set(want) == set(TD.FIELDS)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_cache_reader_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    n, s = 7, 8
    arrays = {
        "image": rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8),
        "depth_gt": rng.normal(size=(n, s, s)).astype(np.float32),
        "depth_mask": rng.integers(0, 2, (n, s, s), dtype=np.uint8) * 255,
        "albedo_gt": rng.integers(0, 256, (n, s, s), dtype=np.uint8),
        "face_mask": rng.integers(0, 2, (n, s, s), dtype=np.uint8) * 255,
        "light_gt": rng.normal(size=(n, 3)).astype(np.float32),
    }
    for k, v in arrays.items():
        np.save(tmp_path / f"{k}.npy", v)
    (tmp_path / "meta.json").write_text(json.dumps({"num_samples": n}))
    port, ref = TD.CelebAHQRelightingData(str(tmp_path)), JD.CelebAHQRelightingData(str(tmp_path))
    idx = np.asarray([4, 0, 6])
    for got, want in ((port.get_batch(idx), ref.get_batch(idx)), (port.get_batch_raw(idx), ref.get_batch_raw(idx)),
                      (port.sample_batch(np.random.default_rng(5), 2), ref.sample_batch(np.random.default_rng(5), 2))):
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = list(port.epoch_batch_indices(np.random.default_rng(6), 2, 2))
    want = list(ref.epoch_batch_indices(np.random.default_rng(6), 2, 2))
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_decode_batch_matches_host_scaling():
    u8 = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    f32 = np.random.default_rng(0).normal(size=(1, 16, 16)).astype(np.float32)
    out = TT.decode_batch({"m": u8, "d": f32}, "cpu")
    assert out["m"].dtype == torch.float32
    np.testing.assert_array_equal(out["m"].numpy(), u8.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(out["d"].numpy(), f32)
