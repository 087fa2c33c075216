"""The port's Multi-PIE evaluation against the JAX package's, on the CPU.

On a synthetic Multi-PIE directory (64x64, four triples, a seeded
MP_lighting_directions.mat):
  * `evaluate_output_dir` on the same dump gives JAX's metrics within 1e-12;
  * `run_inference` (batch 3, so the tail pads) writes PNGs that decode to
    the port's own `forward_visuals` of the same batches, bit for bit, and
    `cli eval-multipie --device cpu` prints `evaluate_output_dir` of its dump;
  * a mispaired triple raises in both packages, in both functions;
  * `MultiPIEEvalData` yields JAX's items.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import scipy.io
import torch

from geomconsistentfr_torch import cli as tcli
from geomconsistentfr_torch.config import preset_multipie_eval
from geomconsistentfr_torch.data.multipie import MultiPIEEvalData as TData
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.metrics.eval_multipie import evaluate_output_dir as t_evaluate
from geomconsistentfr_torch.metrics.eval_multipie import run_inference as t_run_inference
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.utils.io import imread, read_image_u8, read_mask_u8, write_image_u8
from geomconsistentfr_tpu.data.multipie import MultiPIEEvalData as JData
from geomconsistentfr_tpu.metrics.eval_multipie import evaluate_output_dir as j_evaluate
from geomconsistentfr_tpu.metrics.eval_multipie import run_inference as j_run_inference
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

N, SIZE = 4, 64
SMALL = dict(img_height=SIZE, img_width=SIZE, num_sample_points=16, t_stop=0.105)
DIRS = ("input_images_MP_18_lightings", "groundtruth_images_MP_18_lightings", "MP_depth_masks_fill_nose",
        "MP_depth_masks", "MP_face_masks")
METRIC_TOL = 1e-12


def make_dataset(root, n=N, size=SIZE, seed=0):
    rng = np.random.default_rng(seed)
    for d in DIRS:
        os.makedirs(root / d, exist_ok=True)
    directions = rng.normal(size=(18, 3))
    directions[:, 2] = np.abs(directions[:, 2]) + 0.3
    directions /= np.linalg.norm(directions, axis=1, keepdims=True)
    scipy.io.savemat(root / "MP_lighting_directions.mat", {"lighting_directions": directions})
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        write_image_u8(str(root / DIRS[0] / f"img{i:03d}.png"), rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
        write_image_u8(str(root / DIRS[1] / f"img{i:03d}_{(5 * i) % 18 + 1}.png"),
                       rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
        ellipse = ((xx - size / 2) / (0.3 + 0.02 * i) / size) ** 2 + ((yy - size / 2) / 0.4 / size) ** 2 <= 1.0
        for d in DIRS[2:]:
            noise = rng.integers(100, 160, (size, size))
            pixels = np.where(ellipse, 255, noise * (d == DIRS[4])).astype(np.uint8)
            write_image_u8(str(root / d / f"img{i:03d}.png"), pixels)
    return str(root)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return make_dataset(tmp_path_factory.mktemp("mp"))


def small_relighter():
    cfg = preset_multipie_eval()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, **SMALL))
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(2)).state_dict()
    return Relighter(cfg, state, device="cpu")


def paths(root):
    return dict(input_dir=os.path.join(root, DIRS[0]), gt_dir=os.path.join(root, DIRS[1]),
                lighting_mat=os.path.join(root, "MP_lighting_directions.mat"),
                mask_fill_nose_dir=os.path.join(root, DIRS[2]))


def test_run_inference_writes_forward_visuals(dataset, tmp_path):
    rl = small_relighter()
    out = str(tmp_path / "dump")
    assert t_run_inference(rl, **paths(dataset), output_dir=out, batch_size=3) == N
    assert len(os.listdir(out)) == 6 * N
    p = paths(dataset)
    names = sorted(os.listdir(p["input_dir"]))
    gts = sorted(os.listdir(p["gt_dir"]))
    directions = scipy.io.loadmat(p["lighting_mat"])["lighting_directions"]
    for start in (0, 3):
        rows = list(range(start, min(start + 3, N)))
        rows += [rows[-1]] * (3 - len(rows))  # the padded tail
        imgs = np.stack([read_image_u8(os.path.join(p["input_dir"], names[i]), SIZE) for i in rows])
        msks = np.stack([read_mask_u8(os.path.join(p["mask_fill_nose_dir"], names[i]), SIZE) for i in rows])
        lights = np.asarray([directions[int(gts[i].split(".")[0].split("_")[-1]) - 1] for i in rows], np.float32)
        pack = rl.forward_visuals(imgs, msks, target_light=lights).numpy()
        for k, i in enumerate(sorted(set(rows))):
            stem = names[i].split(".")[0]
            assert np.array_equal(imread(os.path.join(out, f"{stem}_rendered_image.png")), pack[k, ..., 0:3])
            assert np.array_equal(imread(os.path.join(out, f"{stem}_surface_normals.png")), pack[k, ..., 9:12])
            assert np.array_equal(imread(os.path.join(out, f"{stem}_depth.png")), pack[k, ..., 7])
    got = t_evaluate(out, p["gt_dir"], p["mask_fill_nose_dir"])
    want = j_evaluate(out, p["gt_dir"], p["mask_fill_nose_dir"])
    assert set(got) == set(want) and got["num_images"] == N
    for key in got:
        assert abs(got[key] - want[key]) <= METRIC_TOL, key


def test_cli_eval_multipie_prints_the_dump_metrics(dataset, tmp_path, capsys):
    pth = tmp_path / "w.pth"
    torch.save(RelightNet(preset_multipie_eval().model, generator=torch.Generator().manual_seed(2)).state_dict(), pth)
    (tmp_path / "small.json").write_text(json.dumps({"render": SMALL}))
    out = str(tmp_path / "dump")
    argv = ["eval-multipie", "--checkpoint", str(pth), "--config", str(tmp_path / "small.json"), "--device", "cpu",
            "--data-root", dataset, "--limit", "3", "--batch-size", "2", "--out", out]
    with pytest.raises(ValueError, match="count mismatch"):  # 3 dumped against 4 GT files
        tcli.main(argv)
    argv[argv.index("--limit") + 1] = str(N)
    assert tcli.main(argv) == 0
    captured = capsys.readouterr()
    assert "LPIPS skipped" in captured.err
    metrics = json.loads(captured.out.splitlines()[-1])
    assert metrics.pop("num_inferred") == N
    assert metrics == t_evaluate(out, os.path.join(dataset, DIRS[1]), os.path.join(dataset, DIRS[2]))
    assert tcli.main(argv + ["--eval-only"]) == 0  # re-scores without the device
    rescored = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rescored.pop("num_inferred") == 0 and rescored == metrics


def test_evaluate_equals_jax_on_a_random_dump(dataset, tmp_path):
    """Six files an image, the rendered ones random: the metrics alone, on both sides."""
    rng = np.random.default_rng(7)
    out = tmp_path / "dump"
    for i in range(N):
        for kind in ("albedo", "depth", "rendered_image", "shading", "shadow_mask", "surface_normals"):
            write_image_u8(str(out / f"img{i:03d}_{kind}.png"), rng.integers(0, 256, (SIZE, SIZE, 3)).astype(np.uint8))
    args = (str(out), os.path.join(dataset, DIRS[1]), os.path.join(dataset, DIRS[4]))
    got, want = t_evaluate(*args), j_evaluate(*args)
    assert set(got) == set(want)
    for key in got:
        assert abs(got[key] - want[key]) <= METRIC_TOL, key


def test_mispaired_triples_raise_in_both(tmp_path):
    root = tmp_path / "mp"
    make_dataset(root, n=2, size=16)
    os.rename(root / DIRS[2] / "img001.png", root / DIRS[2] / "img007.png")
    p = paths(str(root))
    for run in (j_run_inference, t_run_inference):
        with pytest.raises(ValueError, match="mispaired inference triple"):
            run(None, **p, output_dir=str(tmp_path / "x"))
    dump = tmp_path / "dump"
    for i in range(2):
        write_image_u8(str(dump / f"img{i:03d}_rendered_image.png"), np.zeros((16, 16, 3), np.uint8))
    for evaluate in (j_evaluate, t_evaluate):
        with pytest.raises(ValueError, match="mispaired eval triple"):
            evaluate(str(dump), p["gt_dir"], p["mask_fill_nose_dir"])


def test_multipie_eval_data_equals_jax(tmp_path):
    root = make_dataset(tmp_path / "mp", n=2, size=256)
    got, want = TData(root), JData(root)
    assert len(got) == len(want) == 2
    assert np.array_equal(got.lighting_directions, want.lighting_directions)
    for a, b in zip(got, want):
        assert set(a) == set(b)
        for key in a:
            assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
            assert np.array_equal(a[key], b[key]), key
