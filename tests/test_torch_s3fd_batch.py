"""S3FD at batch on the port's path (CPU): preprocess.detect_faces_s3fd_batch,
s3fd.decode_batch, Relighter.relight_frames, their spans and counters, and the
window crop.

  * the batch's boxes against s3fd.detect_faces frame by frame, and the vectorised
    decode against decode_detections row for row;
  * the heads against the benchmark's plain reference (gcfr_bench/reference/s3fd.py);
  * relight_frames' crops byte-equal to crop_largest_face's and its visuals equal to
    forward_visuals on those crops; a frame with no box gives no row;
  * each detect-crop span opened once a call, and the counters' values;
  * crop_face's window, gathered by index, against the padded canvas and the oracle.

Frames of 200-320 px with faces drawn as bright ellipses; S3FD's seeded weights
calibrated in the manner of the benchmark's cell (the four finer heads' face bias at
-100, one shift of the two coarse heads'), the coarse heads' score weights scaled up so
that no two scores nor a score and 0.5 lie within rounding of each other.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gcfr_bench.reference import s3fd as REF
from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch import preprocess as P
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models import s3fd as TS
from geomconsistentfr_torch.models.relightnet import RelightNet
from geomconsistentfr_torch.utils import profiling
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

H, W, B = 232, 248, 3
DETECT_SPANS = ("gcfr.detect.prep", "gcfr.detect.trunk", "gcfr.detect.decode", "gcfr.detect.nms", "gcfr.crop")


def face_frames(n=B, h=H, w=W, seed=0):
    """n RGB frames with a bright ellipse each on a smooth background, and its mask frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = np.empty((n, h, w, 3), np.uint8)
    masks = np.empty((n, h, w), np.uint8)
    for i in range(n):
        base = rng.integers(30, 110, 3)
        frames[i] = (base + 40 * np.sin(xx / 37.0 + i)[..., None] + rng.integers(0, 8, (h, w, 3))).clip(0, 255)
        cx, cy = rng.uniform(0.4, 0.6) * w, rng.uniform(0.4, 0.6) * h
        face = ((xx - cx) / 70.0) ** 2 + ((yy - cy) / 90.0) ** 2 < 1
        frames[i][face] = (np.array([215, 175, 150]) + rng.integers(-10, 10, (face.sum(), 3))).astype(np.uint8)
        masks[i] = face * 255
    return frames, masks


def calibrate(model, frames, gain=1000.0, margin=2.0):
    """The cell's calibration on the port's heads, the coarse heads' score weights times `gain`."""
    with torch.no_grad():
        for i, (src, _) in enumerate(TS.SOURCES):
            conf = getattr(model, f"{src}_mbox_conf")
            if i < 4:
                conf.bias[3 if i == 0 else 1] -= 100.0
            else:
                conf.weight.mul_(gain)
                conf.bias.mul_(gain)
    outs = P.s3fd_heads_batch(frames, model)
    best = min(max(float((outs[2 * i][b, ..., 1] - outs[2 * i][b, ..., 0]).max()) for i in (4, 5))
               for b in range(len(frames)))
    with torch.no_grad():
        for src, _ in TS.SOURCES[4:]:
            getattr(model, f"{src}_mbox_conf").bias[1] += margin - best
    return model


@pytest.fixture(scope="module")
def data():
    return face_frames()


@pytest.fixture(scope="module")
def frames(data):
    return data[0]


@pytest.fixture(scope="module")
def detector(frames):
    return calibrate(TS.S3FD(generator=torch.Generator().manual_seed(0)).eval(), frames)


def padded_bgr(frame):
    return np.ascontiguousarray(np.pad(frame, ((P.PAD, P.PAD), (P.PAD, P.PAD), (0, 0)), mode="reflect")[..., ::-1])


def test_detector_input_is_preprocess_bgr_of_the_padded_frame(frames):
    got = P.detector_input(torch.from_numpy(frames))
    want = np.concatenate([TS.preprocess_bgr(padded_bgr(f)) for f in frames])
    assert got.is_contiguous() and got.shape == want.shape
    assert torch.equal(got, torch.from_numpy(want))


def test_batch_detection_is_detect_faces_frame_by_frame(frames, detector):
    """Boxes equal: the same count and order; coordinates within 1e-3 px and scores within
    2e-5, since oneDNN's convolutions at batch 3 and at batch 1 differ by ~1e-8 of a map's
    magnitude (times the calibration's gain of 1000 on the scored logits) and torch's float32
    exp differs from NumPy's in the last place."""
    got = P.detect_faces_s3fd_batch(frames, detector)
    assert len(got) == B
    for frame, det in zip(frames, got):
        want = TS.detect_faces(padded_bgr(frame), detector)
        want[:, :4] -= P.PAD
        assert len(want) > 0 and det.shape == want.shape and det.dtype == np.float32
        np.testing.assert_allclose(det[:, :4], want[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(det[:, 4], want[:, 4], rtol=0, atol=2e-5)
        single = P.detect_faces_s3fd(frame, model=detector)
        np.testing.assert_allclose(single[:, :4], want[:, :4], rtol=0, atol=1e-3)
        np.testing.assert_allclose(single[:, 4], want[:, 4], rtol=0, atol=2e-5)


def ulps(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("threshold", [0.05, 0.5, 0.99])
def test_vectorised_decode_is_decode_detections_row_for_row(frames, threshold):
    """On the same heads (random, uncalibrated weights: every anchor a candidate at 0.05): the
    same rows in the same order a frame, each value within 4 float32 ulps of the row's largest
    corner (or of the score), what torch's and NumPy's float32 exp differ by."""
    model = TS.S3FD(generator=torch.Generator().manual_seed(1)).eval()
    outs = P.s3fd_heads_batch(frames, model)
    with torch.no_grad():
        outs = [o * 200.0 if i % 2 == 0 else o * 50.0 for i, o in enumerate(outs)]  # spread scores and offsets
    rows = TS.decode_batch(outs, threshold).numpy()
    assert rows.dtype == np.float32 and rows.shape[1] == 6
    assert set(np.unique(rows[:, 0])) <= set(range(B))
    total = 0
    for b in range(B):
        want = TS.decode_detections([o[b:b + 1].numpy() for o in outs], threshold)
        got = rows[rows[:, 0] == b, 1:]
        assert got.shape == want.shape
        total += len(want)
        if not len(want):
            continue
        scale = ulps(np.abs(want[:, :4]).max(axis=1, keepdims=True))
        assert np.all(np.abs(got[:, :4] - want[:, :4]) <= 4 * scale)
        assert np.all(np.abs(got[:, 4] - want[:, 4]) <= 4 * ulps(want[:, 4]))
    assert total == len(rows) and (threshold > 0.5 or total > 100)
    assert TS.decode_batch(outs, 1.1).shape == (0, 6)


@pytest.mark.parametrize("seed", range(4))
def test_select_is_nms_then_the_threshold(seed):
    """select's greedy pass over the rows above 0.5 alone keeps what nms over every row, then the
    threshold, keeps, bit for bit: hundreds of overlapping candidates, scores quantised so that
    many tie, some at and around 0.5."""
    rng = np.random.default_rng(seed)
    n = 500
    xy = rng.uniform(0, 900, (n, 2))
    side = rng.choice([256.0, 512.0], n)[:, None] * rng.uniform(0.8, 1.2, (n, 2))
    score = np.round(rng.uniform(0.45, 0.55, n), 3)
    cands = np.concatenate([xy, xy + side, score[:, None]], axis=1).astype(np.float32)
    boxes = cands[TS.nms(cands)]
    boxes = boxes[boxes[:, 4] > 0.5]
    want = boxes[np.argsort(-boxes[:, 4])]
    got = TS.select(cands)
    assert len(want) > 3 and np.array_equal(got, want)


def test_heads_match_the_plain_reference(frames, detector):
    """The port's heads at batch 3 against gcfr_bench/reference/s3fd.py frame by frame, within
    2e-5 of each head's largest magnitude: two float32 convolution orders (the port's
    channels-last input, the reference's NCHW) over up to 4608 terms."""
    outs = P.s3fd_heads_batch(frames, detector)
    for b, frame in enumerate(frames):
        ref = REF.heads(detector.state_dict(), REF.detector_input(frame, "cpu"))
        assert len(ref) == len(outs) == 12
        for i, (g, w) in enumerate(zip(outs, ref)):
            assert g[b:b + 1].shape == w.shape, i
            assert float((g[b:b + 1] - w).abs().max()) <= 2e-5 * float(w.abs().max()), i


@pytest.fixture(scope="module")
def relighter():
    cfg = TC.preset_single_image()
    cfg = dataclasses.replace(cfg, render=dataclasses.replace(cfg.render, img_height=64, img_width=64,
                                                              num_sample_points=16, t_stop=0.105, march_chunk=16))
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    return Relighter(cfg, state, device="cpu")


def test_relight_frames_crops_and_visuals(monkeypatch, data, detector, relighter):
    frames_, masks = data
    lights = np.array([[0.3, 0.4, 0.87], [-0.2, 0.1, 0.97], [0.5, -0.3, 0.81]], np.float32)
    seen = {}
    forward_visuals = Relighter.forward_visuals

    def recording(self, images, m, target_light=None, target_ambient=None):
        seen.update(images=images, masks=m, light=target_light, ambient=target_ambient)
        return forward_visuals(self, images, m, target_light, target_ambient)

    monkeypatch.setattr(Relighter, "forward_visuals", recording)
    out = relighter.relight_frames(torch.from_numpy(frames_), torch.from_numpy(masks), detector, lights)
    boxes = P.detect_faces_s3fd_batch(frames_, detector)
    assert len(out.boxes) == B and all(np.array_equal(a, b) for a, b in zip(out.boxes, boxes))
    assert np.array_equal(out.candidates, P.detect_s3fd_batch(frames_, detector).candidates)
    assert list(out.frame_index) == [b for b in range(B) if P.crop_largest_face(frames_[b], [
        tuple(float(v) for v in d[:4]) for d in boxes[b]], 64) is not None]
    assert len(out.frame_index) > 0
    for j, b in enumerate(out.frame_index):
        listed = [tuple(float(v) for v in d[:4]) for d in boxes[b]]
        assert np.array_equal(seen["images"][j], P.crop_largest_face(frames_[b], listed, 64))
        assert np.array_equal(seen["masks"][j], P.crop_face(masks[b], P.largest_box(listed), 64))
    assert torch.equal(seen["light"], torch.from_numpy(lights[out.frame_index])) and seen["ambient"] is None
    monkeypatch.setattr(Relighter, "forward_visuals", forward_visuals)
    want = relighter.forward_visuals(seen["images"], seen["masks"], target_light=seen["light"])
    assert out.visuals.dtype == torch.uint8 and torch.equal(out.visuals, want)


def test_batch_candidates_are_the_decoded_rows_the_boxes_come_from(data, detector):
    """detect_s3fd_batch's candidates are decode_batch's rows of the batch's heads as the host
    received them, and each frame's boxes are `select` of its own rows, moved back by PAD."""
    frames_, _ = data
    got = P.detect_s3fd_batch(frames_, detector)
    rows = TS.decode_batch(P.s3fd_heads_batch(frames_, detector)).numpy()
    assert got.candidates.dtype == np.float32 and np.array_equal(got.candidates, rows)
    for b in range(B):
        want = TS.select(rows[rows[:, 0] == b, 1:])
        want[:, :4] -= P.PAD
        assert np.array_equal(got.boxes[b], want)
    assert any(len(d) for d in got.boxes)


def test_a_frame_without_a_box_gives_no_row(data, detector, relighter):
    frames_, masks = data
    blind = TS.S3FD().eval()
    blind.load_state_dict(detector.state_dict())
    with torch.no_grad():
        for src, _ in TS.SOURCES[4:]:
            getattr(blind, f"{src}_mbox_conf").bias[1] -= 1000.0
    before = dict(profiling.COUNTS)
    out = relighter.relight_frames(frames_, masks, blind, np.zeros((B, 3), np.float32) + [0, 0, 1])
    assert out.visuals.shape == (0, 64, 64, 12) and len(out.frame_index) == 0
    assert all(len(b) == 0 for b in out.boxes)
    assert profiling.COUNTS["crop.skipped"] - before["crop.skipped"] == B


@pytest.mark.parametrize("profiled", [False, True])
def test_spans_once_a_call_and_the_counters(data, detector, relighter, profiled):
    frames_, masks = data
    lights = np.tile(np.array([[0.3, 0.4, 0.87]], np.float32), (B, 1))
    before = dict(profiling.COUNTS)
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = relighter.relight_frames(frames_, masks, detector, lights)
        names = [e.name for e in prof.events()]
        for name in DETECT_SPANS:
            assert names.count(name) == 1, name
    else:
        out = relighter.relight_frames(frames_, masks, detector, lights)
    delta = {k: v - before[k] for k, v in profiling.COUNTS.items()}
    rows = TS.decode_batch(P.s3fd_heads_batch(frames_, detector))
    assert delta == {"detect.frames": B, "detect.candidates": len(rows), "detect.kept": sum(map(len, out.boxes)),
                     "detect.d2h_bytes": rows.numel() * 4, "crop.skipped": B - len(out.frame_index)}


@pytest.mark.parametrize("n", [1, 3, 20, 60, 240])
def test_crop_window_is_the_padded_canvas(n):
    """The window gathered by index against np.pad's reflect-101 canvas, zeros off it, on
    frames smaller and larger than the pad, for windows inside, across and outside the canvas."""
    rng = np.random.default_rng(n)
    image = rng.integers(0, 256, (n, n + 7, 3), dtype=np.uint8)
    canvas = np.pad(image, ((P.PAD, P.PAD), (P.PAD, P.PAD), (0, 0)), mode="reflect")
    for _ in range(30):
        side = int(rng.integers(1, 2 * n + 160))
        left, top = (int(v) for v in rng.integers(-side - 10, n + 2 * P.PAD + 10, 2))
        want = np.zeros((side, side, 3), np.uint8)
        y0, x0 = max(top, 0), max(left, 0)
        y1, x1 = min(top + side, canvas.shape[0]), min(left + side, canvas.shape[1])
        if y1 > y0 and x1 > x0:
            want[y0 - top:y1 - top, x0 - left:x1 - left] = canvas[y0:y1, x0:x1]
        assert np.array_equal(P.crop_window(image, left, top, side), want), (left, top, side)
        assert np.array_equal(P.crop_window(image[..., 0], left, top, side), want[..., 0])


def test_crop_face_matches_the_oracle_on_frames_and_masks():
    from tests.oracles.crop_oracle import reference_crop

    rng = np.random.default_rng(5)
    image = rng.integers(0, 256, (300, 320, 3), dtype=np.uint8)
    mask = (rng.integers(0, 2, (300, 320)) * 255).astype(np.uint8)
    for _ in range(40):
        x1, y1 = rng.uniform(-60, 300, 2)
        w, h = rng.uniform(100, 420, 2)
        box = (float(x1), float(y1), float(x1 + w), float(y1 + h))
        want = reference_crop(image, box)
        got = P.crop_face(image, box)
        if want is None:
            assert got is None and P.crop_face(mask, box) is None
            continue
        assert np.array_equal(got, want), box
        assert np.array_equal(P.crop_face(mask, box), reference_crop(np.repeat(mask[..., None], 3, -1), box)[..., 0])
