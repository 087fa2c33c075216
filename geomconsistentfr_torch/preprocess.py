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

The detector: `detect_faces_s3fd` runs the port's S3FD (models/s3fd.py) on
the frame the reference's detector sees; `detect_faces_sfd` wraps
face_alignment where it imports; or pass boxes (`box_from_mask` derives one
from a face mask). The resize is OpenCV's where it imports, else
utils/io.resize_linear (within one level of OpenCV's fixed-point rounding).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

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

    The detector sees the 50 px reflect-101 padded frame flipped to BGR, the
    frame the reference's detector sees (recrop_CelebA-HQ_images.py:17-29);
    the boxes then move back by PAD, so they compose with `crop_face`. Pass
    an S3FD `model` (on its device), or `weights_path` to an s3fd.pth (loaded
    onto `device`: CUDA unless told otherwise).
    """
    from geomconsistentfr_torch.models import s3fd

    if model is None:
        if weights_path is None:
            raise ValueError("need an S3FD model or weights_path")
        from geomconsistentfr_torch.infer import resolve_device

        model = s3fd.load_s3fd_weights(weights_path, device=resolve_device(device))
    padded = np.pad(np.asarray(image_rgb), ((PAD, PAD), (PAD, PAD), (0, 0)), mode="reflect")
    det = s3fd.detect_faces(np.ascontiguousarray(padded[..., ::-1]), model)
    if len(det):
        det = det.copy()
        det[:, :4] -= PAD
    return det


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


def crop_face(image: np.ndarray, box: Box, out_size: int = OUT_SIZE) -> Optional[np.ndarray]:
    """The reference crop of one face box: (out_size, out_size, 3), or None below MIN_FACE.

    image: (H, W, 3), unpadded; box: (x1, y1, x2, y2) in its coordinates.
    """
    padded = np.pad(image, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="reflect")
    x1, y1, x2, y2 = [v + PAD for v in box]
    w, h = x2 - x1, y2 - y1
    side = SCALE * max(w, h)
    if side < MIN_FACE:
        return None
    cy = int(y1 + h / 2.0 + CENTER_SHIFT * h)
    cx = int(x1 + w / 2.0)
    half = int(side / 2.0)
    left, top = cx - half, cy - half
    side_i = 2 * half
    ph, pw = padded.shape[:2]
    pad_l, pad_t = max(0, -left), max(0, -top)
    pad_r, pad_b = max(0, left + side_i - pw), max(0, top + side_i - ph)
    if pad_l or pad_t or pad_r or pad_b:
        padded = np.pad(padded, ((pad_t, pad_b), (pad_l, pad_r), (0, 0)), mode="constant")
        left += pad_l
        top += pad_t
    crop = padded[top : top + side_i, left : left + side_i]
    # uint8 fixed-point bilinear: the reference resizes before its float cast (:49).
    return _resize(np.ascontiguousarray(crop), out_size)


def crop_largest_face(image: np.ndarray, boxes: Sequence[Box], out_size: int = OUT_SIZE) -> Optional[np.ndarray]:
    """The crop of the largest box (the reference keeps one face per image), or None."""
    if not len(boxes):
        return None
    areas = [max(0, b[2] - b[0]) * max(0, b[3] - b[1]) for b in boxes]
    return crop_face(image, tuple(boxes[int(np.argmax(areas))][:4]), out_size)
