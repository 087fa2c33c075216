"""Face-crop preprocessing (reference recrop_CelebA-HQ_images.py:15-63).

Port of geomconsistentfr_tpu/preprocess.py. The reference runs the SFD
detector (the face_alignment package), then fixed crop geometry, reproduced
here to the pixel:
  * the image padded by 50 px on every side with cv2.BORDER_DEFAULT, i.e.
    reflect-101 (:17-24; boxes shift by +50);
  * faces whose scaled side l = 1.2 * max(w, h) is under 200 px skipped
    (:37-39: the guard tests l, not the raw side);
  * the centre is the box centre moved down by 0.06 * h, each component
    truncated by int(); the half side int(l / 2), so the crop side is the
    even 2 * int(l / 2) (:33-36, :40-43);
  * a PIL-style crop (zeros outside the padded canvas, :48);
  * cv2.resize of the uint8 crop to 256x256, bilinear (:49).

The detector: `detect_faces_s3fd_batch` runs the port's S3FD (models/s3fd.py)
on a batch of frames as the reference's detector sees each (the pad, the flip
to BGR and the mean on the device, one copy of the candidates to the host a
batch), and `detect_faces_s3fd` is that path at batch 1; `detect_faces_sfd`
wraps face_alignment where it imports; or pass boxes (`box_from_mask` derives
one from a face mask). `crop_face` copies only its window of the padded
canvas (`crop_window`): no padded copy of a frame wider than PAD is made.
The resize is OpenCV's where it imports, else utils/io.resize_linear (within
one level of OpenCV's fixed-point rounding).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from geomconsistentfr_torch.models.layers import exact_convs
from geomconsistentfr_torch.utils.profiling import count, span

Box = Tuple[float, float, float, float]

PAD = 50
MIN_FACE = 200
SCALE = 1.2
CENTER_SHIFT = 0.06
OUT_SIZE = 256


def detect_faces_sfd(image: np.ndarray):
    """face_alignment's SFD detector, where that package imports; raises otherwise."""
    try:
        import face_alignment
        from face_alignment.detection.sfd import FaceDetector  # noqa: F401
    except Exception as e:
        raise RuntimeError("face_alignment (SFD) is not installed here; pass --s3fd-weights (the port's S3FD), "
                           "a box or a mask") from e
    fa = face_alignment.FaceAlignment(face_alignment.LandmarksType.TWO_D, face_detector="sfd", device="cpu")
    return fa.face_detector.detect_from_image(image)


def detect_faces_s3fd(image_rgb: np.ndarray, model=None, weights_path: Optional[str] = None,
                      device=None) -> np.ndarray:
    """S3FD detections in the original image's coordinates: (N, 5) [x1, y1, x2, y2, score].

    `detect_faces_s3fd_batch` at batch 1. Pass an S3FD `model` (on its
    device), or `weights_path` to an s3fd.pth (loaded onto `device`: CUDA
    unless told otherwise).
    """
    from geomconsistentfr_torch.models import s3fd

    if model is None:
        if weights_path is None:
            raise ValueError("need an S3FD model or weights_path")
        from geomconsistentfr_torch.infer import resolve_device

        model = s3fd.load_s3fd_weights(weights_path, device=resolve_device(device))
    return detect_faces_s3fd_batch(np.ascontiguousarray(image_rgb)[None], model)[0]


def detector_input(frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) RGB frames on the device -> the frames S3FD sees, (B, H + 2 PAD, W + 2 PAD, 3)
    float32: padded by PAD reflect-101 (recrop_CelebA-HQ_images.py:17-24), flipped to BGR, minus
    s3fd.BGR_MEAN. The values are those of `s3fd.preprocess_bgr` on the padded frame, and so is
    the layout (NHWC, contiguous): the trunk's convolutions see the same tensor at any batch."""
    from geomconsistentfr_torch.models.s3fd import BGR_MEAN

    x = F.pad(frames.permute(0, 3, 1, 2).float(), (PAD, PAD, PAD, PAD), mode="reflect")
    mean = torch.tensor(BGR_MEAN, dtype=torch.float32, device=x.device).view(1, 3, 1, 1)
    return (x.flip(1) - mean).permute(0, 2, 3, 1).contiguous()


def s3fd_heads_batch(frames, model) -> List[torch.Tensor]:
    """S3FD's 12 raw head outputs (NHWC, on the model's device) for (B, H, W, 3) RGB frames
    (numpy, or a tensor on the host, pinned or not, or on the device): the upload and
    `detector_input` (span gcfr.detect.prep), then the trunk, the extras, L2Norm and the heads
    at batch B without TF32 and with cuDNN's deterministic algorithms (gcfr.detect.trunk)."""
    device = next(model.parameters()).device
    with span("gcfr.detect.prep"):
        if not isinstance(frames, torch.Tensor):
            frames = torch.from_numpy(np.ascontiguousarray(frames))
        x = detector_input(frames.to(device, non_blocking=True))
    with span("gcfr.detect.trunk"), torch.no_grad(), exact_convs():
        return model.eval()(x)


class S3FDBatch(NamedTuple):
    """`detect_s3fd_batch`'s result: per frame the (N, 5) [x1, y1, x2, y2, score] kept boxes in
    the frame's own coordinates, by descending score, and the batch's candidate rows as the
    host received them, (M, 6) float32 [frame, x1, y1, x2, y2, score] in the padded frames'
    coordinates (`s3fd.decode_batch`)."""

    boxes: List[np.ndarray]
    candidates: np.ndarray


def detect_s3fd_batch(frames, model) -> S3FDBatch:
    """S3FD detections of each of a batch of same-sized RGB frames (B, H, W, 3): per frame the
    kept boxes as `s3fd.detect_faces` gives them on the PAD-padded BGR frame, moved back by
    PAD, and the candidates they came from.

    On the device: `s3fd_heads_batch`, then `s3fd.decode_batch` (the softmax, the candidate
    threshold and the anchor decode of every head, vectorised) and the candidates' one copy
    to the host (span gcfr.detect.decode); on the host, per frame, `s3fd.select` (NMS and the
    score threshold; gcfr.detect.nms). Counts detect.frames, detect.candidates, detect.kept
    and detect.d2h_bytes (the candidates' copy) in `profiling.COUNTS`.
    """
    from geomconsistentfr_torch.models import s3fd

    outputs = s3fd_heads_batch(frames, model)
    with span("gcfr.detect.decode"):
        rows = s3fd.decode_batch(outputs).cpu().numpy()
    n = outputs[0].shape[0]
    count("detect.frames", n)
    count("detect.candidates", len(rows))
    count("detect.d2h_bytes", rows.nbytes)
    with span("gcfr.detect.nms"):
        kept = []
        for b in range(n):
            det = s3fd.select(rows[rows[:, 0] == b, 1:])
            det[:, :4] -= PAD
            kept.append(det)
    count("detect.kept", sum(len(d) for d in kept))
    return S3FDBatch(kept, rows)


def detect_faces_s3fd_batch(frames, model) -> List[np.ndarray]:
    """`detect_s3fd_batch`'s kept boxes: per frame (N, 5) [x1, y1, x2, y2, score] in the frame's
    own coordinates, by descending score."""
    return detect_s3fd_batch(frames, model).boxes


def box_from_mask(mask: np.ndarray, threshold: Optional[float] = None) -> Box:
    """The tight box of mask > threshold (default half the mask's maximum, so 0/255,
    0/1 and float masks all work): a face box without a detector."""
    m = np.asarray(mask)
    if m.ndim == 3:
        m = m[..., 0]
    if threshold is None:
        threshold = float(m.max()) / 2.0
    ys, xs = np.nonzero(m > threshold)
    if ys.size == 0:
        raise ValueError("mask is empty; cannot derive a face box")
    return (float(xs.min()), float(ys.min()), float(xs.max()), float(ys.max()))


def _resize(crop: np.ndarray, size: int) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        from geomconsistentfr_torch.utils.io import resize_linear

        return resize_linear(crop, size)
    return cv2.resize(crop, (size, size))


def crop_geometry(box: Box) -> Optional[Tuple[int, int, int]]:
    """(left, top, side) of the reference crop of `box` on the PAD-padded canvas, or None
    where the scaled side is below MIN_FACE (recrop_CelebA-HQ_images.py:33-43)."""
    x1, y1, x2, y2 = [v + PAD for v in box]
    w, h = x2 - x1, y2 - y1
    side = SCALE * max(w, h)
    if side < MIN_FACE:
        return None
    cy = int(y1 + h / 2.0 + CENTER_SHIFT * h)
    cx = int(x1 + w / 2.0)
    half = int(side / 2.0)
    return cx - half, cy - half, 2 * half


def _runs(start: int, size: int, n: int) -> List[Tuple[int, int, slice]]:
    """The window's positions along one axis of n > PAD pixels as runs, each (first, end, the
    frame's slice): the stretches of canvas positions that reflect-101 by PAD maps to
    consecutive frame indices (one reflection a side: descending, the frame, descending).
    Positions off the canvas lie in no run."""
    runs = []
    for lo, hi, offset, step in ((-PAD, 0, 0, -1), (0, n, 0, 1), (n, n + PAD, 2 * (n - 1), -1)):
        a, b = max(start - PAD, lo), min(start - PAD + size, hi)
        if a < b:
            q0, stop = offset + step * a, offset + step * b
            runs.append((a - start + PAD, b - start + PAD, slice(q0, stop if stop >= 0 else None, step)))
    return runs


def crop_window(image: np.ndarray, left: int, top: int, side: int) -> np.ndarray:
    """The (side, side) window at (left, top) of `image` padded by PAD reflect-101, with zeros
    off that canvas: a view where the window lies inside the frame, else copied block by block
    from the frame's slices that reflect-101 puts there (a few slices a side), with no padded
    copy of the frame; a frame of PAD pixels or fewer a side, whose reflections repeat, is
    padded whole. `image` is (H, W) or (H, W, C)."""
    h, w = image.shape[:2]
    if PAD <= top and top + side <= h + PAD and PAD <= left and left + side <= w + PAD:
        return image[top - PAD : top - PAD + side, left - PAD : left - PAD + side]
    out = np.zeros((side, side) + image.shape[2:], image.dtype)
    if min(h, w) <= PAD:
        canvas = np.pad(image, ((PAD, PAD), (PAD, PAD)) + ((0, 0),) * (image.ndim - 2), mode="reflect")
        y0, x0 = max(top, 0), max(left, 0)
        y1, x1 = min(top + side, canvas.shape[0]), min(left + side, canvas.shape[1])
        if y1 > y0 and x1 > x0:
            out[y0 - top : y1 - top, x0 - left : x1 - left] = canvas[y0:y1, x0:x1]
        return out
    cols = _runs(left, side, w)
    for r0, r1, rs in _runs(top, side, h):
        for c0, c1, cs in cols:
            out[r0:r1, c0:c1] = image[rs, cs]
    return out


def crop_face(image: np.ndarray, box: Box, out_size: int = OUT_SIZE) -> Optional[np.ndarray]:
    """The reference crop of one face box: (out_size, out_size, 3), or None below MIN_FACE.

    image: (H, W, 3), unpadded, or (H, W) (a mask, cropped alike); box: (x1, y1, x2, y2) in
    its coordinates.
    """
    geometry = crop_geometry(box)
    if geometry is None:
        return None
    crop = crop_window(image, *geometry)
    # uint8 fixed-point bilinear: the reference resizes before its float cast (:49).
    return _resize(np.ascontiguousarray(crop), out_size)


def largest_box(boxes: Sequence[Box]) -> Optional[Box]:
    """The box of the largest area, (x1, y1, x2, y2) (the reference keeps one face per image), or None."""
    if not len(boxes):
        return None
    areas = [max(0, b[2] - b[0]) * max(0, b[3] - b[1]) for b in boxes]
    return tuple(boxes[int(np.argmax(areas))][:4])


def crop_largest_face(image: np.ndarray, boxes: Sequence[Box], out_size: int = OUT_SIZE) -> Optional[np.ndarray]:
    """The crop of the largest box (the reference keeps one face per image), or None."""
    box = largest_box(boxes)
    return None if box is None else crop_face(image, box, out_size)
