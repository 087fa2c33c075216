"""The port's CLI on the CPU (`main([...])` in process, `--device cpu`).

  * `config` prints the JAX CLI's JSON for every preset, with and without a
    partial --config file;
  * `fix-border` writes the JAX CLI's pixels;
  * `relight` (strict and draft), `sweep` and `transfer` at 256x256 (16
    samples, by a --config file) write files that decode to the port's own
    `forward_visuals` / `relight_sweep_rendered_u8` / `estimate_lighting` at
    batch 1, bit for bit (tests/test_torch_infer.py holds those against JAX);
  * every flag and command not ported exits non-zero naming its ROADMAP item;
  * the bench reads its knobs from the environment and refuses the CPU;
  * one subprocess runs `--help`.
"""

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


REFUSED = {
    "train": (["train", "--epochs", "1"], "item 5"),
    "build-cache": (["build-cache", "--src", "a", "--out", "b"], "item 5"),
    "crop": (["crop", "--image", "a", "--out-image", "b"], "item 6"),
    "convert": (["convert", "--pth", "a", "--out", "b"], "needs JAX"),
    "lpips-trunk": (["eval-multipie", "--lpips-trunk", "t.pth"], "item 6"),
    "lpips-random-trunk": (["eval-multipie", "--lpips-random-trunk"], "item 6"),
    "data-parallel": (["eval-multipie", "--data-parallel"], "item 8"),
    "sample-parallel": (["relight", "--sample-parallel", "--image", "a", "--mask", "b"], "item 8"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refused_flags_name_their_roadmap_item(files, case):
    argv, item = REFUSED[case]
    if argv[0] in ("eval-multipie", "relight"):
        argv = argv + ["--checkpoint", files["pth"], "--device", "cpu"]
        if argv[0] == "eval-multipie":
            argv += ["--data-root", files["root"]]
    with pytest.raises(SystemExit) as e:
        tcli.main(argv)
    assert isinstance(e.value.code, str) and "not ported" in e.value.code and item in e.value.code, e.value.code


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
    for cmd in ("relight", "sweep", "transfer", "eval-multipie", "fix-border", "config", "bench", "train", "crop"):
        assert cmd in proc.stdout
