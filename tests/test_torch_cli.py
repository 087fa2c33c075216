"""The port's CLI on the CPU (`main([...])` in process, `--device cpu`).

  * `config` prints the JAX CLI's JSON for every preset, with and without a
    partial --config file;
  * `fix-border` writes the JAX CLI's pixels;
  * `relight` (strict and draft), `sweep` and `transfer` at 256x256 (16
    samples, by a --config file) write files that decode to the port's own
    `forward_visuals` / `relight_sweep_rendered_u8` / `estimate_lighting` at
    batch 1, bit for bit (tests/test_torch_infer.py holds those against JAX);
  * `build-cache` writes the JAX CLI's cache byte for byte; `train` (32x32,
    the set resident on the device, traced, with visuals) prints an epoch's
    losses equal to an in-process Trainer's that streams, and resumes at its
    checkpoint; `crop` (a box, a mask, the port's S3FD) writes the JAX CLI's
    or crop_largest_face's pixels; `eval-multipie --lpips-*` scores the JAX
    CLI's LPIPS; `visualize-lighting` and `lpips-score` print and write what
    the JAX CLI does; `lpips-train` writes heads both packages load;
  * `convert` writes the JAX CLI's variables (tests/test_torch_orbax.py holds
    the tree bit for bit); `--sample-parallel` and `--data-parallel` in one
    process (a mesh of one rank) write what no flag writes, and together they
    conflict (tests/test_torch_launch.py runs them under torchrun);
  * the bench reads its knobs from the environment and refuses the CPU;
  * one subprocess runs `--help`.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from geomconsistentfr_torch import bench as tbench
from geomconsistentfr_torch import cli as tcli
from geomconsistentfr_torch.config import PRESETS, apply_precision_tier, load_config
from geomconsistentfr_torch.infer import load_relighter
from geomconsistentfr_torch.lighting_presets import DEFAULT_AMBIENT, LIGHT_PRESETS
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.utils.io import imread, read_image, read_mask, write_image_u8
from geomconsistentfr_tpu import cli as jcli
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"render": {"num_sample_points": 16, "t_start": 0.025, "t_stop": 0.105}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Random transfer-variant weights as a .pth, the golden 00104 image and mask and a
    second golden image as PNGs, and the 16-sample config."""
    from geomconsistentfr_torch.config import preset_lighting_transfer

    root = tmp_path_factory.mktemp("cli")
    model = RelightNet(preset_lighting_transfer().model, generator=torch.Generator().manual_seed(3))
    torch.save(model.state_dict(), root / "w.pth")
    for name, stem in (("ref_transfer_00104.npz", "face"), ("ref_target_00295.npz", "ref")):
        fx = np.load(ROOT / "tests" / "golden" / name)
        write_image_u8(str(root / f"{stem}.png"), (fx["image"] * 255).astype(np.uint8))
        write_image_u8(str(root / f"{stem}_mask.png"), (fx["mask"] * 255).astype(np.uint8))
    (root / "small.json").write_text(json.dumps(SMALL))
    return {k: str(root / v) for k, v in dict(root="", pth="w.pth", image="face.png", mask="face_mask.png",
                                                 ref="ref.png", config="small.json").items()}


def model_args(files, out, tier):
    return ["--checkpoint", files["pth"], "--config", files["config"], "--precision", tier,
            "--device", "cpu", "--out", str(out)]


def relighter(files, preset, tier):
    cfg = apply_precision_tier(load_config(files["config"], preset=preset), tier)
    return load_relighter(files["pth"], cfg=cfg, device="cpu")


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("overrides", [False, True])
def test_config_prints_the_jax_json(preset, overrides, files, capsys):
    argv = ["config", "--preset", preset] + (["--config", files["config"]] if overrides else [])
    assert jcli.main(argv) == 0
    want = capsys.readouterr().out
    assert tcli.main(argv) == 0
    assert capsys.readouterr().out == want


def test_fix_border_writes_the_jax_pixels(files, tmp_path, capsys):
    out_j, out_t = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jcli.main(["fix-border", "--image", files["image"], "--mask", files["mask"], "--out-image", out_j]) == 0
    assert tcli.main(["fix-border", "--image", files["image"], "--mask", files["mask"], "--out-image", out_t]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == {"out": out_t}
    got = imread(out_t)
    assert np.array_equal(got, imread(out_j))
    assert not np.array_equal(got, imread(files["image"]))  # the seam did change


@pytest.mark.parametrize("tier", ["strict", "draft"])
def test_relight_writes_forward_visuals(files, tmp_path, tier, capsys):
    argv = ["relight", *model_args(files, tmp_path, tier), "--image", files["image"], "--mask", files["mask"],
            "--light-preset", "multipie_14", "--ambient", "0.4"]
    assert tcli.main(argv) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    rl = relighter(files, "single_image", tier)
    img, mask = read_image(files["image"]), read_mask(files["mask"])
    pack = rl.forward_visuals(img[None], mask[None], np.asarray([LIGHT_PRESETS["multipie_14"]], np.float32),
                              np.asarray([0.4], np.float32))[0].numpy()
    c = 0
    for kind, width in (("rendered_image", 3), ("shadow_mask", 1), ("albedo", 3), ("depth", 1), ("shading", 1),
                        ("surface_normals", 3)):
        want = pack[..., c : c + width] if width == 3 else pack[..., c]
        assert np.array_equal(imread(report["outputs"][kind]), want), kind
        c += width
    composited = imread(str(tmp_path / report["composited"]))
    mask3 = np.repeat(mask[..., None], 3, axis=-1)
    want = np.where(mask3 > 0, pack[..., 0:3] / 255.0, img)
    assert np.array_equal(composited, np.clip(want.astype(np.float32) * 255.0, 0, 255).astype(np.uint8))


def test_sweep_writes_the_sweep_renders(files, tmp_path, capsys):
    argv = ["sweep", *model_args(files, tmp_path, "high"), "--image", files["image"], "--mask", files["mask"]]
    assert tcli.main(argv) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert report["num_lights"] == len(LIGHT_PRESETS)
    rl = relighter(files, "single_image", "high")
    lights = np.asarray(list(LIGHT_PRESETS.values()), np.float32)
    tiles = rl.relight_sweep_rendered_u8(read_image(files["image"]), read_mask(files["mask"]), lights,
                                         np.full((len(lights),), DEFAULT_AMBIENT, np.float32)).numpy()
    for i, name in enumerate(LIGHT_PRESETS):
        assert np.array_equal(imread(str(tmp_path / f"face_{name}.png")), tiles[i]), name
    sheet = imread(str(tmp_path / report["montage"]))
    assert sheet.shape == (6 * 256, 4 * 256, 3)
    assert np.array_equal(sheet[256:512, 512:768], tiles[6])


def test_transfer_writes_the_estimated_relight(files, tmp_path, capsys):
    argv = ["transfer", *model_args(files, tmp_path, "fast"), files["image"], files["ref"], files["mask"]]
    assert tcli.main(argv) == 0
    report = json.loads(capsys.readouterr().out.splitlines()[-1])
    rl = relighter(files, "lighting_transfer", "fast")
    unit, ambient = rl.estimate_lighting(read_image(files["ref"])[None])
    assert report["estimated_direction"] == [float(v) for v in unit[0]]
    assert report["estimated_ambient"] == float(ambient[0])
    pack = rl.forward_visuals(read_image(files["image"])[None], read_mask(files["mask"])[None], unit, ambient)[0]
    assert np.array_equal(imread(report["outputs"]["rendered_image"]), pack[..., 0:3].numpy())
    assert np.array_equal(imread(report["outputs"]["shadow_mask"]), pack[..., 3].numpy())


def test_data_parallel_conflicts_with_sample_parallel(files):
    argv = ["eval-multipie", "--data-parallel", "--sample-parallel", "--checkpoint", files["pth"], "--device", "cpu",
            "--data-root", files["root"]]
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert e.value.code == "--data-parallel conflicts with --sample-parallel"


# ---------------------------------------------------------------------------
# The commands and flags ported since the CLI refused them: each runs, held
# against the JAX CLI or the port's own in-process calls.
# ---------------------------------------------------------------------------

TRAIN_CONFIG = {
    "render": {"img_height": 32, "img_width": 32, "num_sample_points": 16, "t_start": 0.025, "t_stop": 0.105},
    "train": {"batch_size": 2, "batches_per_epoch": 2, "data_residency": "device"},
}


def last_json_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.splitlines()[-1])


def run_build_cache(files, tmp_path, capsys):
    from test_torch_data_cache import write_mp_data

    src = write_mp_data(str(tmp_path / "MP_data"), 3)
    assert tcli.main(["build-cache", "--src", src, "--out", str(tmp_path / "port")]) == 0
    report = last_json_line(capsys)
    assert report["num_samples"] == 3 and report["decoder"] == "native-libjpeg" and report["samples_per_s"] > 0
    assert jcli.main(["build-cache", "--src", src, "--out", str(tmp_path / "jax"), "--limit", "3"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name


def run_train(files, tmp_path, capsys):
    from geomconsistentfr_torch.data import SyntheticFaceData
    from geomconsistentfr_torch.train import Trainer

    (tmp_path / "train.json").write_text(json.dumps(TRAIN_CONFIG))
    argv = ["train", "--config", str(tmp_path / "train.json"), "--data", "synthetic", "--synthetic-samples", "4",
            "--profile", "--visualize-every", "1", "--device", "cpu", "--out", str(tmp_path / "run")]
    assert tcli.main(argv + ["--epochs", "2"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [m["epoch"] for m in lines] == [0, 1]
    cfg = load_config(str(tmp_path / "train.json"), preset="target_lighting_train")
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, data_residency="stream"))
    trainer = Trainer(cfg, SyntheticFaceData(num_samples=4, size=32), workdir=str(tmp_path / "ref"), device="cpu")
    state, want = trainer.run_epoch(trainer.init_or_resume(), 0)
    for k in want:
        if k != "seconds":
            assert lines[0][k] == want[k], k
    assert len(os.listdir(tmp_path / "run" / "profile")) == 2  # a trace an epoch
    index = (tmp_path / "run" / "visuals" / "index.html").read_text()
    assert lines[1]["visuals"] == str(tmp_path / "run" / "visuals" / "index.html")
    assert "epoch_0000/rendered.png" in index and "epoch_0001/shadow.png" in index
    # Resumed: divmod(step 4, 2 batches an epoch) starts at epoch 2.
    assert tcli.main(argv + ["--epochs", "3"]) == 0
    assert [json.loads(x)["epoch"] for x in capsys.readouterr().out.splitlines()] == [2]


def run_crop(files, tmp_path, capsys):
    from geomconsistentfr_torch.models.s3fd import S3FD
    from geomconsistentfr_torch.preprocess import crop_largest_face, detect_faces_s3fd

    image, mask = files["image"], files["mask"]
    for flag, value in (("--box", "40,30,220,240"), ("--mask", mask)):
        out_t, out_j = str(tmp_path / f"port{flag}.png"), str(tmp_path / f"jax{flag}.png")
        assert tcli.main(["crop", "--image", image, flag, value, "--out-image", out_t]) == 0
        assert last_json_line(capsys) == {"out": out_t}
        assert jcli.main(["crop", "--image", image, flag, value, "--out-image", out_j]) == 0
        assert np.array_equal(imread(out_t), imread(out_j)), flag
    model = S3FD(generator=torch.Generator().manual_seed(1))
    torch.save(model.state_dict(), tmp_path / "s3fd.pth")
    out = str(tmp_path / "s3fd_crop.png")
    assert tcli.main(["crop", "--image", image, "--s3fd-weights", str(tmp_path / "s3fd.pth"), "--device", "cpu",
                      "--out-image", out]) == 0
    report = last_json_line(capsys)
    img = imread(image)
    detections = detect_faces_s3fd(img, model=model.eval())
    assert report["detections"] == len(detections) > 0
    want = crop_largest_face(img, [tuple(d[:4]) for d in detections])
    assert np.array_equal(imread(out), want)
    assert tcli.main(["crop", "--image", image, "--box", "0,0,50,50", "--out-image", out]) == 1
    assert "200px" in last_json_line(capsys)["error"]


def eval_root(files, tmp_path):
    """A Multi-PIE root of two GT images and masks, and a dump of their renders (for --eval-only)."""
    root, dump = tmp_path / "mp", tmp_path / "dump"
    for d in ("groundtruth_images_MP_18_lightings", "MP_depth_masks_fill_nose"):
        (root / d).mkdir(parents=True)
    dump.mkdir()
    img, mask = imread(files["image"]), imread(files["mask"])
    rng = np.random.default_rng(0)
    for i in range(2):
        noisy = np.clip(img.astype(int) + rng.integers(-30, 30, img.shape), 0, 255).astype(np.uint8)
        write_image_u8(str(root / "groundtruth_images_MP_18_lightings" / f"{i:03d}_{i + 3}.png"), img)
        write_image_u8(str(root / "MP_depth_masks_fill_nose" / f"{i:03d}.png"), mask)
        write_image_u8(str(dump / f"{i:03d}_rendered_image.png"), noisy)
    return str(root), str(dump)


def run_eval_lpips(files, tmp_path, capsys, random_trunk: bool):
    from geomconsistentfr_torch.metrics.eval_multipie import evaluate_output_dir
    from geomconsistentfr_torch.models.lpips import LPIPSMetric, Trunk

    root, dump = eval_root(files, tmp_path)
    base = ["eval-multipie", "--checkpoint", files["pth"], "--data-root", root, "--out", dump, "--eval-only"]
    if random_trunk:
        assert tcli.main(base + ["--lpips-random-trunk", "--device", "cpu"]) == 0
        got = last_json_line(capsys)
        metric = LPIPSMetric(allow_random_trunk=True, device="cpu")
        want = evaluate_output_dir(dump, os.path.join(root, "groundtruth_images_MP_18_lightings"),
                                   os.path.join(root, "MP_depth_masks_fill_nose"), lpips_fn=metric)
        assert got == {**want, "num_inferred": 0}
        return
    trunk = Trunk("alex")
    torch.save({f"features.{k}" if not k.startswith("features.") else k: v for k, v in trunk.state_dict().items()},
               tmp_path / "alex.pth")
    g = torch.Generator().manual_seed(2)
    torch.save({f"lin{i}.model.1.weight": torch.rand(1, c, 1, 1, generator=g) * 0.1
                for i, c in enumerate((64, 192, 384, 256, 256))}, tmp_path / "lin.pth")
    flags = ["--lpips-trunk", str(tmp_path / "alex.pth"), "--lpips-lin", str(tmp_path / "lin.pth")]
    assert tcli.main(base + flags + ["--device", "cpu"]) == 0
    got = last_json_line(capsys)
    assert jcli.main(base + flags) == 0
    want = last_json_line(capsys)
    assert set(got) == set(want) and "masked_lpips_mean" in got
    for k in want:
        if "lpips" in k:
            assert abs(got[k] - want[k]) <= 1e-5 * abs(want["masked_lpips_mean"]), k
        else:
            assert got[k] == want[k], k


def run_convert(files, tmp_path, capsys):
    from geomconsistentfr_torch.convert import load_checkpoint, state_dict_from_jax_variables
    from geomconsistentfr_torch.utils.checkpoint import restore_variables

    assert tcli.main(["convert", "--pth", files["pth"], "--out", str(tmp_path / "port")]) == 0
    got = last_json_line(capsys)
    assert jcli.main(["convert", "--pth", files["pth"], "--out", str(tmp_path / "jax")]) == 0
    assert got == dict(last_json_line(capsys), out=str(tmp_path / "port"))
    state, back = load_checkpoint(files["pth"]), state_dict_from_jax_variables(restore_variables(got["out"]))
    assert sorted(back) == sorted(state) and all(torch.equal(back[k], state[k]) for k in state)


def run_sample_parallel_one_process(files, tmp_path, capsys):
    for flags, out in (([], "plain"), (["--sample-parallel"], "sharded")):
        assert tcli.main(["relight"] + model_args(files, tmp_path / out, "draft") + flags + [
            "--image", files["image"], "--mask", files["mask"], "--light-preset", "multipie_14"]) == 0
    names = sorted(os.listdir(tmp_path / "plain"))
    assert len(names) == 7 and sorted(os.listdir(tmp_path / "sharded")) == names
    for name in names:
        assert (tmp_path / "plain" / name).read_bytes() == (tmp_path / "sharded" / name).read_bytes(), name


def run_data_parallel_one_process(files, tmp_path, capsys):
    from test_torch_eval import make_dataset

    root = make_dataset(tmp_path / "mp", n=3, size=32)
    (tmp_path / "c32.json").write_text(json.dumps({"render": dict(TRAIN_CONFIG["render"])}))
    base = ["eval-multipie", "--checkpoint", files["pth"], "--config", str(tmp_path / "c32.json"), "--device", "cpu",
            "--data-root", root, "--batch-size", "2"]
    assert tcli.main(base + ["--out", str(tmp_path / "plain")]) == 0
    plain = last_json_line(capsys)
    assert tcli.main(base + ["--data-parallel", "--out", str(tmp_path / "sharded")]) == 0
    assert last_json_line(capsys) == plain and plain["num_inferred"] == 3
    for name in sorted(os.listdir(tmp_path / "plain")):
        assert (tmp_path / "plain" / name).read_bytes() == (tmp_path / "sharded" / name).read_bytes(), name


PORTED = {
    "build-cache": run_build_cache,
    "convert": run_convert,
    "sample-parallel": run_sample_parallel_one_process,
    "data-parallel": run_data_parallel_one_process,
    "train": run_train,
    "crop": run_crop,
    "lpips-trunk": functools.partial(run_eval_lpips, random_trunk=False),
    "lpips-random-trunk": functools.partial(run_eval_lpips, random_trunk=True),
}


@pytest.mark.parametrize("case", sorted(PORTED))
def test_ported_commands_run(files, tmp_path, capsys, case):
    PORTED[case](files, tmp_path, capsys)


def test_train_with_debug_nans_trains_the_same_and_switches_it_off(tmp_path, capsys):
    """--debug-nans (anomaly mode and the module-output NaN check) changes no number and is off after."""
    (tmp_path / "train.json").write_text(json.dumps(TRAIN_CONFIG))
    lines = {}
    for flag in ([], ["--debug-nans"]):
        argv = ["train", "--config", str(tmp_path / "train.json"), "--synthetic-samples", "4", "--epochs", "1",
                "--device", "cpu", "--out", str(tmp_path / f"run{len(flag)}"), *flag]
        assert tcli.main(argv) == 0
        lines[bool(flag)] = {k: v for k, v in last_json_line(capsys).items() if k != "seconds"}
        assert not torch.is_anomaly_enabled()
    assert lines[True] == lines[False]


def test_visualize_lighting_writes_the_jax_spheres(tmp_path, capsys):
    for extra in ([], ["--azimuth", "30", "--elevation", "-15", "--clamp", "--size", "64"]):
        assert tcli.main(["visualize-lighting", "--out", str(tmp_path / "port"), *extra]) == 0
        got = last_json_line(capsys)
        assert jcli.main(["visualize-lighting", "--out", str(tmp_path / "jax"), *extra]) == 0
        assert got["count"] == last_json_line(capsys)["count"] == (1 if extra else len(LIGHT_PRESETS))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and "A30E-15.png" in names
    for name in names:
        assert np.array_equal(imread(str(tmp_path / "port" / name)), imread(str(tmp_path / "jax" / name))), name


@pytest.fixture(scope="module")
def bapps(tmp_path_factory):
    from test_torch_lpips_train import write_bapps

    root = tmp_path_factory.mktemp("bapps_cli")
    return write_bapps(root / "2afc", 6), write_bapps(root / "jnd", 5, jnd=True, seed=1), root


@pytest.mark.parametrize("metric", ["l2", "dssim", "lpips"])
@pytest.mark.parametrize("mode", ["2afc", "jnd"])
def test_lpips_score_prints_the_jax_score(bapps, capsys, metric, mode):
    twoafc, jnd, root = bapps
    argv = ["lpips-score", "--mode", mode, "--metric", metric, "--data-root", twoafc if mode == "2afc" else jnd]
    if metric == "lpips":
        from test_torch_lpips import lin_state, torchvision_state

        if not (root / "alex.pth").exists():
            torch.save(torchvision_state("alex", 7), root / "alex.pth")
            torch.save(lin_state("alex", 8), root / "lin.pth")
        argv += ["--trunk", str(root / "alex.pth"), "--lin", str(root / "lin.pth")]
    assert jcli.main(argv) == 0
    want = last_json_line(capsys)
    assert tcli.main(argv + (["--device", "cpu"] if metric == "lpips" else [])) == 0
    assert last_json_line(capsys) == want


def test_lpips_train_writes_heads_both_packages_load(bapps, tmp_path, capsys):
    from geomconsistentfr_torch.models.lpips import load_lin_weights
    from geomconsistentfr_tpu.models.lpips import load_lin_weights as jax_load_lin_weights

    twoafc, _, _ = bapps
    out = str(tmp_path / "heads.npz")
    assert tcli.main(["lpips-train", "--data-root", twoafc, "--out", out, "--random-trunk", "--epochs", "1",
                      "--epochs-decay", "1", "--batch-size", "4", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [r.get("epoch") for r in lines[:2]] == [0, 1] and lines[1]["lr"] == pytest.approx(0.0)
    assert lines[-1] == {"lin_weights": out, "net": "alex"}
    assert all(np.isfinite(r["loss_total"]) for r in lines[:2])
    heads = load_lin_weights(out)
    assert len(heads) == len(jax_load_lin_weights(out)) == 5
    assert all(float(v.min()) >= 0.0 for v in heads.values())


def test_bench_reads_its_knobs_and_refuses_the_cpu(monkeypatch):
    monkeypatch.setenv("BENCH_PRECISION", "draft")
    monkeypatch.setenv("BENCH_COL_CHUNK", "32")
    tier, cfg = tbench.bench_config()
    assert (tier, cfg.render.shadow_resolution_scale, cfg.render.shadow_col_chunk) == ("draft", 4, 32)
    monkeypatch.setenv("BENCH_STRICT", "1")
    assert tbench.bench_config()[0] == "strict"
    monkeypatch.setenv("BENCH_COL_CHUNK", "12")
    with pytest.raises(ValueError, match="shadow_col_chunk"):
        tbench.bench_config()
    with pytest.raises(RuntimeError, match="times the card"):
        tbench.run(device="cpu")


def test_help_lists_the_commands():
    proc = subprocess.run([sys.executable, "-m", "geomconsistentfr_torch.cli", "--help"], cwd=ROOT,
                          capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    for cmd in ("relight", "sweep", "transfer", "eval-multipie", "fix-border", "config", "bench", "train", "crop",
                "build-cache", "lpips-train", "lpips-score", "visualize-lighting"):
        assert cmd in proc.stdout
