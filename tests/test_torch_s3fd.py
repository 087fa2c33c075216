"""The port's S3FD and face crop against the JAX package's (CPU).

  * the twelve heads at 128x128 (and a 100x140 frame) within 1e-4 of each
    head's largest value, the weights carried across with
    convert.s3fd_state_dict_from_jax; load_s3fd_weights reads face_alignment's
    s3fd.pth keys as the JAX loader does;
  * decode_detections and nms identical on the same head outputs;
  * detect_faces_s3fd's boxes within 1e-3 px of JAX's, and box_from_mask,
    crop_face and crop_largest_face byte-equal to JAX's on the same boxes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geomconsistentfr_torch import preprocess as TPRE
from geomconsistentfr_torch.convert import s3fd_state_dict_from_jax
from geomconsistentfr_torch.models import s3fd as TS
from geomconsistentfr_tpu import preprocess as JPRE
from geomconsistentfr_tpu.models import s3fd as JS
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def weights():
    variables = jax.tree.map(np.asarray, JS.init_s3fd(0))
    model = TS.S3FD()
    model.load_state_dict(s3fd_state_dict_from_jax(variables))
    return variables, model.eval()


@pytest.fixture(scope="module")
def apply_fn():
    return jax.jit(JS.S3FD().apply)


@pytest.mark.parametrize("shape", [(128, 128), (100, 140)])
def test_heads_match_jax(weights, apply_fn, shape):
    variables, model = weights
    img = np.random.default_rng(shape[0]).integers(0, 256, (*shape, 3)).astype(np.uint8)
    want = [np.asarray(o) for o in apply_fn(variables, jnp.asarray(JS.preprocess_bgr(img)))]
    got = TS.heads(model, img)
    assert len(got) == len(want) == 12
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), i
    assert got[0].shape[-1] == 2 and got[1].shape[-1] == 4  # conf1's max-out applied


def test_decode_and_nms_are_jaxs(weights, apply_fn):
    variables, _ = weights
    img = np.random.default_rng(1).integers(0, 256, (128, 128, 3)).astype(np.uint8)
    outs = [np.asarray(o) for o in apply_fn(variables, jnp.asarray(JS.preprocess_bgr(img)))]
    for threshold in (0.05, 0.5, 0.99):
        got, want = TS.decode_detections(outs, threshold), JS.decode_detections(outs, threshold)
        np.testing.assert_array_equal(got, want)
    boxes = JS.decode_detections(outs)
    assert len(boxes) > 100
    for iou in (0.3, 0.6):
        assert TS.nms(boxes, iou) == JS.nms(boxes, iou)
    assert TS.nms(np.zeros((0, 5), np.float32)) == [] and len(TS.decode_detections(outs, 1.1)) == 0


def test_load_s3fd_weights_reads_face_alignments_keys(weights, tmp_path):
    _, model = weights
    state = model.state_dict()
    assert "conv3_3_norm.weight" in state and "fc6.weight" in state and tuple(state["fc6.weight"].shape[2:]) == (3, 3)
    torch.save(state, tmp_path / "s3fd.pth")
    loaded = TS.load_s3fd_weights(str(tmp_path / "s3fd.pth"))
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, state[k]), k
    jv = JS.load_s3fd_weights(str(tmp_path / "s3fd.pth"))
    back = s3fd_state_dict_from_jax(jax.tree.map(np.asarray, jv))
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k


@pytest.fixture(scope="module")
def frame():
    """A 160x200 frame with a bright ellipse (a face) on a textured background."""
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:160, 0:200]
    img = rng.integers(0, 120, (160, 200, 3)).astype(np.uint8)
    face = ((xx - 110) / 45.0) ** 2 + ((yy - 80) / 60.0) ** 2 < 1
    img[face] = (np.array([220, 180, 160]) + rng.integers(-10, 10, (face.sum(), 3))).astype(np.uint8)
    return img, (face * 255).astype(np.uint8)


def test_detect_faces_s3fd_matches_jax(weights, apply_fn, frame):
    variables, model = weights
    img, _ = frame
    want = JPRE.detect_faces_s3fd(img, variables,
                                  _detect_fn=lambda bgr, v: JS.detect_faces(bgr, v, apply_fn=apply_fn))
    got = TPRE.detect_faces_s3fd(img, model=model)
    assert len(want) > 0 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-5)
    boxes = [tuple(float(v) for v in b[:4]) for b in want]
    assert np.array_equal(TPRE.crop_largest_face(img, boxes), JPRE.crop_largest_face(img, boxes))


def test_crops_are_byte_equal_to_jax(frame):
    img, mask = frame
    box = TPRE.box_from_mask(mask)
    assert box == JPRE.box_from_mask(mask) and TPRE.box_from_mask(mask / 255.0) == box
    for b in (box, (10.0, -30.0, 190.0, 150.0), (-40.5, 20.25, 120.75, 230.0), (50.0, 40.0, 160.0, 130.0)):
        got, want = TPRE.crop_face(img, b), JPRE.crop_face(img, b)
        if want is None:
            assert got is None
        else:
            assert got.dtype == np.uint8 and got.shape == (256, 256, 3)
            assert np.array_equal(got, want), b
    assert TPRE.crop_face(img, (0.0, 0.0, 100.0, 100.0)) is None  # 1.2 * 100 < 200
    boxes = [(0.0, 0.0, 100.0, 100.0), (10.0, -30.0, 190.0, 150.0), (5.0, 5.0, 60.0, 60.0)]
    assert np.array_equal(TPRE.crop_largest_face(img, boxes), JPRE.crop_largest_face(img, boxes))
    assert TPRE.crop_largest_face(img, []) is None
    with pytest.raises(ValueError, match="empty"):
        TPRE.box_from_mask(np.zeros((8, 8)))
    with pytest.raises(RuntimeError, match="face_alignment"):
        TPRE.detect_faces_sfd(img)
