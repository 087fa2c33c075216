"""The port's LPIPS against the JAX package's, on the same random weights (CPU).

  * the three trunks (alex, vgg, squeeze) at 64x64 and 65x65 (odd tap sizes,
    SqueezeNet's ceil-mode pools), spatial and not, within 1e-5 of the map's
    largest value, the weights carried across with
    convert.lpips_state_dict_from_jax;
  * load_trunk_state (torchvision's layout, bare or nested under
    'state_dict', classifier keys dropped, missing keys named) and
    load_lin_weights (.pth and .npz) on files written here, and LPIPSMetric
    built from them against the JAX LPIPSMetric built from the same files;
  * evaluate_output_dir(lpips_fn=...) against the JAX package's.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch.convert import lpips_state_dict_from_jax
from geomconsistentfr_torch.metrics import eval_multipie as TE
from geomconsistentfr_torch.models import lpips as TL
from geomconsistentfr_torch.utils.png import encode_png
from geomconsistentfr_tpu.metrics import eval_multipie as JE
from geomconsistentfr_tpu.models import lpips as JL
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

NETS = ("alex", "vgg", "squeeze")
BAR = 1e-5  # of the map's (or the distances') largest value


@pytest.fixture(scope="module")
def jax_params():
    """Random JAX LPIPS parameters per net (flax init, seeded)."""
    out = {}
    for i, net in enumerate(NETS):
        model = JL.LPIPS(spatial=True, net=net)
        v = model.init(jax.random.PRNGKey(i + 1), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1, 64, 64, 3)))
        out[net] = jax.tree.map(np.asarray, v["params"])
    return out


@pytest.mark.parametrize("spatial", [True, False])
@pytest.mark.parametrize("size", [64, 65])
@pytest.mark.parametrize("net", NETS)
def test_lpips_matches_jax(jax_params, net, size, spatial):
    rng = np.random.default_rng(size)
    x = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    y = np.clip(x + rng.normal(scale=0.3, size=x.shape), -1, 1).astype(np.float32)
    want = np.asarray(JL.LPIPS(spatial=spatial, net=net).apply({"params": jax_params[net]}, x, y))
    model = TL.LPIPS(net, spatial)
    model.load_state_dict(lpips_state_dict_from_jax(jax_params[net], net))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape == ((2, size, size) if spatial else (2,))
    assert np.abs(got - want).max() <= BAR * np.abs(want).max()


def test_trunk_taps_have_torchvisions_sizes():
    shapes = {}
    for net in NETS:
        with torch.no_grad():
            shapes[net] = [tuple(t.shape[1:]) for t in TL.Trunk(net)(torch.zeros(1, 3, 256, 256))]
    assert shapes["alex"] == [(64, 63, 63), (192, 31, 31), (384, 15, 15), (256, 15, 15), (256, 15, 15)]
    assert [s[1] for s in shapes["vgg"]] == [256, 128, 64, 32, 16]
    assert [s[1] for s in shapes["squeeze"]] == [127, 63, 31, 15, 15, 15, 15]


def torchvision_state(net: str, seed: int) -> dict:
    """A torchvision-layout state dict of the trunk (features.*) plus classifier keys."""
    trunk = TL.Trunk(net)
    TL.reset_torch_default(trunk, torch.Generator().manual_seed(seed))
    state = dict(trunk.state_dict())
    state["classifier.1.weight"] = torch.zeros(4, 4)
    return state


def lin_state(net: str, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) * 0.1
            for i, c in enumerate(TL.TRUNKS[net][2])}


@pytest.mark.parametrize("net", NETS)
def test_weight_files_load_as_jax_loads_them(tmp_path, net):
    state = torchvision_state(net, 3)
    torch.save(state, tmp_path / "bare.pth")
    torch.save({"state_dict": state, "epoch": 9}, tmp_path / "nested.pth")
    np.savez(tmp_path / "trunk.npz", **{k: v.numpy() for k, v in state.items()})
    for name in ("bare.pth", "nested.pth", "trunk.npz"):
        got = TL.load_trunk_state(str(tmp_path / name), net)
        want = JL.load_trunk_state(str(tmp_path / name), net)
        assert sorted(got) == sorted(k for k in want if k.startswith("features."))
        for k in got:
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    broken = {k: v for k, v in state.items() if not k.endswith("features.0.bias")}
    torch.save(broken, tmp_path / "broken.pth")
    with pytest.raises(ValueError, match="features.0.bias"):
        TL.load_trunk_state(str(tmp_path / "broken.pth"), net)

    lins = lin_state(net, 4)
    torch.save(lins, tmp_path / "lin.pth")
    np.savez(tmp_path / "lin.npz", **{k: v.numpy() for k, v in lins.items()})
    for name in ("lin.pth", "lin.npz"):
        got = TL.load_lin_weights(str(tmp_path / name))
        want = JL.load_lin_weights(str(tmp_path / name))
        assert len(got) == len(want) == len(TL.TRUNKS[net][2])
        for i in range(len(want)):
            np.testing.assert_array_equal(got[f"lin{i}.model.1.weight"].numpy().transpose(2, 3, 1, 0),
                                          want[f"lin{i}"]["kernel"])
    torch.save({"nothing": torch.zeros(1)}, tmp_path / "empty.pth")
    with pytest.raises(ValueError, match="no lin-head keys"):
        TL.load_lin_weights(str(tmp_path / "empty.pth"))


@pytest.fixture(scope="module")
def weight_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("lpips_weights")
    torch.save(torchvision_state("alex", 5), root / "alex.pth")
    torch.save(lin_state("alex", 6), root / "alex_lin.pth")
    return str(root / "alex.pth"), str(root / "alex_lin.pth")


def test_lpips_metric_from_files_matches_jax(weight_files):
    trunk, lin = weight_files
    port = TL.LPIPSMetric(lin_weights_path=lin, trunk_state=TL.load_trunk_state(trunk), device="cpu")
    ref = JL.LPIPSMetric(lin_weights_path=lin, trunk_state=JL.load_trunk_state(trunk))
    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (64, 64, 3))
    pred = np.clip(gt + rng.normal(scale=0.1, size=gt.shape), 0, 1)
    got, want = port(gt, pred), ref(gt, pred)
    assert got.shape == want.shape == (64, 64)
    assert np.abs(got - want).max() <= BAR * np.abs(want).max()
    with pytest.raises(RuntimeError, match="trunk weights"):
        TL.LPIPSMetric(lin_weights_path=lin, device="cpu")
    with pytest.raises(RuntimeError, match="linear heads"):
        TL.LPIPSMetric(trunk_state=TL.load_trunk_state(trunk), device="cpu")
    with pytest.raises(ValueError, match="unknown LPIPS net"):
        TL.LPIPSMetric(allow_random_trunk=True, net="resnet", device="cpu")
    smoke = TL.LPIPSMetric(allow_random_trunk=True, device="cpu")(gt, pred)
    assert smoke.shape == (64, 64) and np.isfinite(smoke).all()


def write_eval_dirs(root, n: int = 3, size: int = 64):
    """A dump of `n` rendered images, their GT and masks (the MP layout's names)."""
    rng = np.random.default_rng(8)
    dirs = [os.path.join(root, d) for d in ("out", "gt", "mask")]
    for d in dirs:
        os.makedirs(d)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        gt = rng.integers(0, 256, (size, size, 3)).astype(np.uint8)
        pred = np.clip(gt.astype(int) + rng.integers(-40, 40, gt.shape), 0, 255).astype(np.uint8)
        mask = (((xx - size / 2) ** 2 + (yy - size / 2) ** 2) < (size * (0.3 + 0.05 * i)) ** 2) * 255
        for d, name, px in ((dirs[0], f"{i:03d}_rendered_image.png", pred), (dirs[1], f"{i:03d}_{i + 1}.png", gt),
                            (dirs[2], f"{i:03d}.png", mask.astype(np.uint8))):
            with open(os.path.join(d, name), "wb") as f:
                f.write(encode_png(px))
    return dirs


def test_evaluate_output_dir_with_lpips_matches_jax(weight_files, tmp_path):
    trunk, lin = weight_files
    dirs = write_eval_dirs(str(tmp_path))
    got = TE.evaluate_output_dir(*dirs, lpips_fn=TL.LPIPSMetric(lin, TL.load_trunk_state(trunk), device="cpu"))
    want = JE.evaluate_output_dir(*dirs, lpips_fn=JL.LPIPSMetric(lin, JL.load_trunk_state(trunk)))
    assert set(got) == set(want) and "masked_lpips_mean" in got
    for k in want:
        if "lpips" in k:  # the mean and the spread, against the mean's size
            assert abs(got[k] - want[k]) <= BAR * abs(want["masked_lpips_mean"]), k
        else:
            assert got[k] == want[k], k
    assert "masked_lpips_mean" not in TE.evaluate_output_dir(*dirs)
