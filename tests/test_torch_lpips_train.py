"""LPIPS's 2AFC training, the BAPPS directories and the perceptual scores against the JAX package (CPU).

  * TwoAFCDirectory and JNDDirectory read a BAPPS-style tree written here
    (64x64 patches, and 48x48 ones resized to 64) as the JAX readers do;
  * Dist2Logit, bce_ranking_loss and compute_accuracy on the same numbers;
  * three LPIPS2AFCTrainer steps from the JAX trainer's weights: losses,
    accuracies and the clamped heads within 1e-5; save_lin_weights files
    load in both packages;
  * l2_distance, dssim_distance, score_2afc and score_jnd, and the directory
    scorers, equal to JAX's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch.convert import dist2logit_state_dict_from_jax, lpips_state_dict_from_jax
from geomconsistentfr_torch.data import bapps as TB
from geomconsistentfr_torch.metrics import lpips_train as TT
from geomconsistentfr_torch.metrics import perceptual as TP
from geomconsistentfr_torch.models import lpips as TL
from geomconsistentfr_torch.utils.png import encode_png
from geomconsistentfr_tpu.data import bapps as JB
from geomconsistentfr_tpu.metrics import lpips_train as JT
from geomconsistentfr_tpu.metrics import perceptual as JP
from geomconsistentfr_tpu.models import lpips as JL
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)


def write_png(path, pixels):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(pixels))


def write_bapps(root, n: int, jnd: bool = False, size: int = 64, seed: int = 0) -> str:
    """A 2AFC (ref/ p0/ p1/ judge/) or JND (p0/ p1/ same/) tree of n random patches."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        ref = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        for d in (("p0", "p1") if jnd else ("ref", "p0", "p1")):
            noise = rng.integers(-60, 60, ref.shape) * (1 if d == "p0" else 2)
            write_png(os.path.join(root, d, f"{i:06d}.png"), ref if d == "ref" else
                      np.clip(ref.astype(int) + noise, 0, 255).astype(np.uint8))
        os.makedirs(os.path.join(root, "same" if jnd else "judge"), exist_ok=True)
        np.save(os.path.join(root, "same" if jnd else "judge", f"{i:06d}.npy"), rng.uniform(0, 1, (1,)))
    return str(root)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("bapps")
    return {"a": write_bapps(root / "a", 6), "b": write_bapps(root / "b", 3, size=48, seed=1),
            "jnd": write_bapps(root / "jnd", 5, jnd=True, seed=2)}


def test_directories_read_as_jax_reads_them(trees):
    port, ref = TB.TwoAFCDirectory([trees["a"], trees["b"]]), JB.TwoAFCDirectory([trees["a"], trees["b"]])
    assert len(port) == len(ref) == 9
    for i in (0, 5, 8):  # 8 is a resized 48x48 patch
        got, want = port[i], ref[i]
        for k in want:
            assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got = list(port.batches(4, shuffle=True, seed=3, drop_remainder=True))
    want = list(ref.batches(4, shuffle=True, seed=3, drop_remainder=True))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    jp, jr = TB.JNDDirectory(trees["jnd"]), JB.JNDDirectory(trees["jnd"])
    assert len(jp) == len(jr) == 5
    for k in jr[2]:
        np.testing.assert_array_equal(jp[2][k], jr[2][k])


def test_directories_refuse_mismatched_counts(trees, tmp_path):
    bad = write_bapps(tmp_path / "bad", 2)
    os.remove(os.path.join(bad, "p1", "000001.png"))
    with pytest.raises(ValueError, match="count mismatch"):
        TB.TwoAFCDirectory(bad)
    with pytest.raises(FileNotFoundError, match="missing dataset directory"):
        TB.JNDDirectory(str(tmp_path / "nowhere"))


def test_ranking_net_loss_and_accuracy_match_jax():
    rng = np.random.default_rng(0)
    d0, d1 = rng.uniform(0, 2, 16).astype(np.float32), rng.uniform(0, 2, 16).astype(np.float32)
    judge = rng.uniform(0, 1, 16).astype(np.float32)
    net = JT.Dist2Logit()
    params = jax.tree.map(np.asarray, net.init(jax.random.PRNGKey(4), jnp.zeros((1,)), jnp.zeros((1,)))["params"])
    want = np.asarray(net.apply({"params": params}, d0, d1))
    port = TT.Dist2Logit()
    port.load_state_dict(dist2logit_state_dict_from_jax(params))
    with torch.no_grad():
        got = port(torch.from_numpy(d0), torch.from_numpy(d1)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    for prob in (np.array(want), np.array([0.0, 1.0, 0.5] * 5 + [1e-9], np.float32)):
        np.testing.assert_allclose(float(TT.bce_ranking_loss(torch.from_numpy(prob), torch.from_numpy(judge))),
                                   float(JT.bce_ranking_loss(jnp.asarray(prob), jnp.asarray(judge))), rtol=1e-6)
    assert float(TT.compute_accuracy(torch.from_numpy(d0), torch.from_numpy(d1), torch.from_numpy(judge))) == \
        pytest.approx(float(JT.compute_accuracy(jnp.asarray(d0), jnp.asarray(d1), jnp.asarray(judge))), rel=1e-6)


@pytest.mark.parametrize("net", ["alex", "squeeze"])
def test_three_trainer_steps_match_jax(trees, tmp_path, net):
    jt = JT.LPIPS2AFCTrainer(allow_random_trunk=True, net=net, seed=1, lr=1e-3)
    tt = TT.LPIPS2AFCTrainer(allow_random_trunk=True, net=net, seed=1, lr=1e-3, device="cpu")
    host = jax.device_get({"trunk": jt.trunk, **jt.params["lin"]})
    tt.lpips.load_state_dict(lpips_state_dict_from_jax(host, net))
    tt.ranknet.load_state_dict(dist2logit_state_dict_from_jax(jax.device_get(jt.params["rank"])))
    data = TB.TwoAFCDirectory(trees["a"])
    batches = list(data.batches(3, shuffle=True, seed=0)) + [next(data.batches(3))]
    assert len(batches) == 3
    for b in batches:
        got, want = tt.train_step(b), jt.train_step(b)
        assert got["loss_total"] == pytest.approx(want["loss_total"], abs=1e-5)
        assert got["acc_r"] == pytest.approx(want["acc_r"], abs=1e-5)
    heads = tt.lin_state()
    for i, lin in enumerate(sorted(jt.params["lin"], key=lambda k: int(k[3:]))):
        want = np.asarray(jt.params["lin"][lin]["kernel"]).transpose(3, 2, 0, 1)
        assert np.abs(heads[f"lin{i}.model.1.weight"] - want).max() <= 1e-5
        assert heads[f"lin{i}.model.1.weight"].min() >= 0.0  # clamped
    ev_got, ev_want = tt.evaluate(batches[0]), jt.evaluate(batches[0])
    for k in ev_want:
        assert ev_got[k] == pytest.approx(ev_want[k], rel=1e-5, abs=1e-7), k
    assert tt.decay_learning_rate(4) == pytest.approx(jt.decay_learning_rate(4))
    for name in ("heads.npz", "heads.pth"):
        tt.save_lin_weights(str(tmp_path / name))
        for i, w in enumerate(JL.load_lin_weights(str(tmp_path / name)).values()):
            np.testing.assert_array_equal(w["kernel"].transpose(3, 2, 0, 1), heads[f"lin{i}.model.1.weight"])
        assert TL.load_lin_weights(str(tmp_path / name)).keys() == heads.keys()


def test_scores_match_jax(trees):
    rng = np.random.default_rng(5)
    a, b = rng.uniform(0, 1, (32, 32, 3)), rng.uniform(0, 1, (32, 32, 3))
    assert TP.l2_distance(a, b) == JP.l2_distance(a, b)
    assert TP.dssim_distance(a, b) == JP.dssim_distance(a, b)
    imgs = [rng.uniform(0, 1, (16, 16, 3)) for _ in range(12)]
    judges = list(rng.uniform(0, 1, 4)) + [0.5]
    refs, p0s, p1s = imgs[0:5], imgs[5:10], imgs[6:11]
    p1s[4] = p0s[4]  # a tie scores 0.5
    assert TP.score_2afc(refs, p0s, p1s, judges, TP.l2_distance) == \
        JP.score_2afc(refs, p0s, p1s, judges, JP.l2_distance)
    same = rng.uniform(0, 1, 6)
    assert TP.score_jnd(imgs[:6], imgs[6:], same, TP.l2_distance) == \
        JP.score_jnd(imgs[:6], imgs[6:], same, JP.l2_distance)
    for dist_t, dist_j in ((TP.l2_distance, JP.l2_distance), (TP.dssim_distance, JP.dssim_distance)):
        assert TB.score_2afc_directory([trees["a"], trees["b"]], dist_t) == \
            JB.score_2afc_directory([trees["a"], trees["b"]], dist_j)
        assert TB.score_jnd_directory(trees["jnd"], dist_t) == JB.score_jnd_directory(trees["jnd"], dist_j)


def test_html_gallery_matches_jax(tmp_path):
    rows = [{"epoch": 0, "input": str(tmp_path / "v" / "e0" / "input.png"), "total_loss": 1.25},
            {"epoch": 1, "rendered": str(tmp_path / "v" / "e1" / "rendered.png")}]
    TP.write_html_gallery(str(tmp_path / "v" / "port.html"), rows, title="t <1>")
    JP.write_html_gallery(str(tmp_path / "v" / "jax.html"), rows, title="t <1>")
    assert (tmp_path / "v" / "port.html").read_text() == (tmp_path / "v" / "jax.html").read_text()
