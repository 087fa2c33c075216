"""The detect-crop-relight cell's own pieces: S3FD's work count, the plain reference's
detector, NMS and crop against the program's on the same inputs, its near ties, the traffic's
frames, the calibration's crops on the faces and the check's count of crops without one, and
the driver's refusal of a program without the batched path."""

import time

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gcfr_bench import core, run, work_s3fd
from gcfr_bench.drivers import frames as drv_frames
from gcfr_bench.reference import s3fd as ref_s3fd
from gcfr_bench.tests.conftest import sizes

CELL = "s3fd_crop_relight.frames16"
VGG16_CONV_MACS_224 = 15_346_630_656  # VGG16's 13 convolutions at 224x224 (15.35 GMAC)


def test_vgg16_trunk_at_224_is_15_35_gmac():
    convs = [layer for layer in work_s3fd.s3fd_layers(224, 224) if layer[0][:5] in
             ("conv1", "conv2", "conv3", "conv4", "conv5") and "mbox" not in layer[0]]
    assert len(convs) == 13
    assert sum(cin * cout * k * k * oh * ow for _, cin, cout, k, oh, ow in convs) == VGG16_CONV_MACS_224


@pytest.mark.parametrize("side", [1124, 340, 203])
def test_s3fd_table_is_flopcounter(side):
    """The table against torch's FlopCounterMode on the reference's forward, at the cell's padded
    frame and at sizes whose maps round down."""
    with torch.device("meta"):
        state = ref_s3fd.S3FD().state_dict()
        x = torch.empty(1, 3, side, side + 8)
        with FlopCounterMode(display=False) as fc:
            ref_s3fd.heads(state, x)
    assert fc.get_total_flops() == work_s3fd.s3fd_flops(side, side + 8)


def test_reference_crop_is_the_programs_on_the_same_boxes():
    """The reference's crop (its own geometry, the whole frame padded) and the program's window
    gather agree byte for byte, and on the geometry, over boxes inside, across and off the frame."""
    from geomconsistentfr_torch import preprocess

    rng = np.random.default_rng(3)
    image = rng.integers(0, 256, (260, 300, 3), dtype=np.uint8)
    for _ in range(40):
        x1, y1 = rng.uniform(-80, 280, 2)
        w, h = rng.uniform(120, 400, 2)
        box = (float(x1), float(y1), float(x1 + w), float(y1 + h))
        g = ref_s3fd.crop_geometry(box)
        assert g == preprocess.crop_geometry(box)
        if g is not None:
            assert np.array_equal(ref_s3fd.crop(image, g, 64), preprocess.crop_face(image, box, 64))
            assert np.array_equal(ref_s3fd.crop(image[..., 1], g, 64), preprocess.crop_face(image[..., 1], box, 64))


def test_reference_nms_keeps_the_best_and_drops_overlaps():
    cands = np.array([[0, 0, 100, 100, 0.9], [5, 5, 105, 105, 0.95], [300, 300, 400, 400, 0.6],
                      [0, 0, 100, 100, 0.4]], np.float64)
    kept = ref_s3fd.kept(cands)
    assert kept[:, 4].tolist() == [0.95, 0.6]
    assert not ref_s3fd.near_tie(cands, 1e-5)
    assert ref_s3fd.near_tie(np.vstack([cands, [[600, 600, 700, 700, 0.500001]]]), 1e-5)  # a score at 0.5
    twins = np.array([[0, 0, 100, 100, 0.8], [10, 0, 110, 100, 0.800001]], np.float64)  # NMS meets them in either order
    assert ref_s3fd.near_tie(twins, 1e-5)


def test_reference_nms_is_the_programs_on_the_same_candidates():
    """face_alignment's NMS in the reference and the program's `select` keep the same rows, bit
    for bit, on float32 candidates whose scores tie often (as random weights make them)."""
    from geomconsistentfr_torch.models import s3fd

    rng = np.random.default_rng(4)
    xy = rng.uniform(0, 900, (500, 2))
    side = rng.choice([256.0, 512.0], 500)[:, None] * rng.uniform(0.8, 1.2, (500, 2))
    score = np.round(rng.uniform(0.45, 0.55, 500), 3)
    cands = np.concatenate([xy, xy + side, score[:, None]], axis=1).astype(np.float32)
    assert np.array_equal(ref_s3fd.kept(cands), s3fd.select(cands)) and len(s3fd.select(cands)) > 3


def test_driver_fails_at_once_without_the_batched_path(monkeypatch):
    """A program without preprocess.detect_faces_s3fd_batch (the parent's) cannot run the cell:
    the driver raises before it builds anything."""
    from geomconsistentfr_torch import preprocess

    monkeypatch.delattr(preprocess, "detect_faces_s3fd_batch")
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError, match="detect_faces_s3fd_batch"):
        run.run_cell(CELL, 2 ** 31 + 7, 0.1, False, device="cpu", overrides=sizes(CELL)["small"])
    assert time.perf_counter() - t0 < 10.0


def test_same_seed_same_frames():
    wl, cfg = core.workload(CELL), core.config(core.workload(CELL)["config"])
    small = sizes(CELL)["small"]
    run.merge(wl, small["workload"])
    run.merge(cfg, small["config"])

    def frames(seed):
        d = drv_frames.Driver(wl, cfg, seed, "cpu")
        d.gen = torch.Generator().manual_seed(seed)
        d.pcfg = None
        d._make_inputs()
        return d.inputs

    a, b, c = frames(2 ** 31 + 3), frames(2 ** 31 + 3), frames(5)
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], c[0][0])
    f, m, lights = a[0]
    assert f.dtype == torch.uint8 and f.shape[1:] == (240, 240, 3) and m.shape[1:] == (240, 240)
    assert f.is_contiguous() and m.is_contiguous()  # the host's crops read (B, H, W, 3) rows
    assert int((m != 0).sum()) > 0 and bool((lights[:, 2] >= 0.5).all())


def small_driver():
    wl, cfg = core.workload(CELL), core.config(core.workload(CELL)["config"])
    small = sizes(CELL)["small"]
    run.merge(wl, small["workload"])
    run.merge(cfg, small["config"])
    return drv_frames.Driver(wl, cfg, 2 ** 31 + 11, "cpu")


def test_calibration_crops_every_pool_frame_on_its_face():
    """Every pool frame keeps a box, and the crop of its largest holds face pixels of its mask
    frame, by the reference's own detection on the calibrated weights."""
    d = small_driver()
    d.gen = torch.Generator().manual_seed(3)
    d._make_inputs()
    d._calibrated_s3fd()
    cal = d.calibration
    assert len(cal["face_cover_per_frame"]) == d.batch * d.n_inputs
    assert min(cal["kept_per_frame"]) >= 1 and min(cal["face_cover_per_frame"]) > 0.25


def test_crops_without_a_face_are_counted():
    """A sound run compares the packs on every checked frame's face; with the mask frames
    blanked, every checked frame counts as off the face and the run is not correct."""
    d = small_driver()
    d.traced = False
    d.setup()
    d.window(0.2)
    d.free()
    assert d.check().correct and d.gaps["frames_off_face"] == 0
    assert d.gaps["crops_with_face"] == d.kept.k * d.batch
    for _, masks, _ in d.inputs:
        masks.zero_()
    d._ref = None
    assert not d.check().correct
    assert d.gaps["frames_off_face"] == d.kept.k * d.batch
