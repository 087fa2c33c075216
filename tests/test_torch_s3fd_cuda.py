"""S3FD at batch on the card, at CelebA-HQ's 1024x1024 frames (1124x1124 as the detector sees them).

  * preprocess.detect_faces_s3fd_batch at batch 16 against the same path at batch 1, frame
    by frame (cuDNN's deterministic algorithms may differ between the two batch sizes);
  * the heads at batch 16 against gcfr_bench/reference/s3fd.py (plain float32, TF32 off);
  * Relighter.relight_frames at batch 16: its crops' visuals against forward_visuals on
    crop_largest_face's crops.

Frames and the calibrated weights as tests/test_torch_s3fd_batch.py makes them. Every
test needs an NVIDIA GPU (marker `cuda`) and skips without one. On the card:

    python -m pytest --noconftest -m cuda tests/test_torch_s3fd_cuda.py
"""

import numpy as np
import pytest
import torch

from gcfr_bench.reference import precision
from gcfr_bench.reference import s3fd as REF
from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch import preprocess as P
from geomconsistentfr_torch.infer import Relighter
from geomconsistentfr_torch.models import s3fd as TS
from geomconsistentfr_torch.models.relightnet import RelightNet
from test_torch_s3fd_batch import calibrate, face_frames

pytestmark = pytest.mark.cuda

N, SIZE = 16, 1024


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the batched detect-crop-relight path is measured there")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def data(dev):
    return face_frames(N, SIZE, SIZE, seed=16)


@pytest.fixture(scope="module")
def detector(dev, data):
    model = TS.S3FD(generator=torch.Generator().manual_seed(0)).to(dev).eval()
    return calibrate(model, torch.from_numpy(data[0]).pin_memory())


def test_batch_16_is_batch_1(data, detector):
    """The heads within 1e-5 of each head's largest magnitude and the candidates (every anchor
    past 0.05) the same rows within 1e-2 px and 1e-5 in score: cuDNN's algorithms at batch 16
    and 1 may sum in other orders (and the calibration scales the scored logits by 1000). The
    kept boxes are compared on one set of candidates, the batch's: with random weights scores
    a rounding apart decide NMS, so two sets of candidates a rounding apart keep other boxes."""
    frames = torch.from_numpy(data[0]).pin_memory()
    heads = P.s3fd_heads_batch(frames, detector)
    rows = TS.decode_batch(heads).cpu().numpy()
    kept = P.detect_faces_s3fd_batch(frames, detector)
    for b in range(N):
        one = P.s3fd_heads_batch(frames[b:b + 1], detector)
        for i, (h16, h1) in enumerate(zip(heads, one)):
            assert float((h16[b:b + 1] - h1).abs().max()) <= 1e-5 * float(h1.abs().max()), (b, i)
        want = TS.decode_batch(one).cpu().numpy()[:, 1:]
        got = rows[rows[:, 0] == b, 1:]
        assert got.shape == want.shape and len(got) > 0, b
        np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-2)
        np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)
        sel = TS.select(got.copy())
        sel[:, :4] -= P.PAD
        assert len(kept[b]) > 0 and np.array_equal(kept[b], sel), b


def test_heads_match_the_plain_reference(dev, data, detector):
    """Within 2e-5 of each head's largest magnitude: float32 on both sides, TF32 off, two
    convolution orders over up to 4608 terms."""
    outs = P.s3fd_heads_batch(data[0], detector)
    state = detector.state_dict()
    worst = [0.0] * 12
    with torch.no_grad(), precision(False):
        for b in range(0, N, 5):
            ref = REF.heads(state, REF.detector_input(data[0][b], dev))
            for i, (g, w) in enumerate(zip(outs, ref)):
                assert g[b:b + 1].shape == w.shape
                worst[i] = max(worst[i], float((g[b:b + 1] - w).abs().max() / w.abs().max()))
    assert max(worst) <= 2e-5, worst


def test_relight_frames_at_batch_16(dev, data, detector):
    frames, masks = data
    cfg = TC.apply_precision_tier(TC.preset_single_image(), "high")
    state = RelightNet(cfg.model, generator=torch.Generator().manual_seed(0)).state_dict()
    rl = Relighter(cfg, state, device=dev)
    lights = np.tile(np.array([[0.3, 0.4, 0.87]], np.float32), (N, 1))
    out = rl.relight_frames(torch.from_numpy(frames).pin_memory(), torch.from_numpy(masks).pin_memory(), detector,
                            lights)
    assert len(out.frame_index) > 0 and out.visuals.shape == (len(out.frame_index), 256, 256, 12)
    crops, mcrops = [], []
    for b in out.frame_index:
        listed = [tuple(float(v) for v in d[:4]) for d in out.boxes[b]]
        crops.append(P.crop_largest_face(frames[b], listed))
        mcrops.append(P.crop_face(masks[b], P.largest_box(listed)))
    want = rl.forward_visuals(np.stack(crops), np.stack(mcrops), target_light=lights[out.frame_index])
    assert torch.equal(out.visuals, want)
