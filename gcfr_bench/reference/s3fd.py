"""S3FD and the reference's face crop in plain PyTorch and numpy, float32, for the
detect-crop-relight cell's `correct`.

S3FD (Zhang et al., "S3FD: Single Shot Scale-invariant Face Detector", ICCV 2017,
arXiv:1708.05237), as the SFD detector of the `face_alignment` package runs it in
GeomConsistentFR's `recrop_CelebA-HQ_images.py` (:9-10, :29), under that package's
`s3fd.pth` parameter names, so one state dict loads here and into the program alike:

  * VGG16's conv1_1 - conv5_3 (3x3, padding 1, ReLU; 2x2 max pooling after each
    stage), fc6 and fc7 as convolutions (3x3 512 -> 1024 and 1x1 1024 -> 1024), the
    extra layers conv6_1/6_2 (1x1 1024 -> 256, 3x3 stride 2 256 -> 512) and conv7_1/7_2
    (1x1 512 -> 128, 3x3 stride 2 128 -> 256), each with ReLU;
  * L2Norm (x over its L2 norm across channels, plus 1e-10, times a learned scale a
    channel; initial scales 10, 8 and 5) on conv3_3, conv4_3 and conv5_3;
  * six detection layers on conv3_3, conv4_3, conv5_3, fc7, conv6_2 and conv7_2 (strides
    4 to 128), each a 3x3 convolution to the face/background scores and one to the
    four offsets; the first scores 3 background labels and the face and keeps the
    largest background label (the paper's max-out background label, Nm = 3);
  * one square anchor a location, of side 4 x the stride (the paper's scale-equitable
    tiling), decoded as SSD does with variances 0.1 (centre) and 0.2 (size).

Departures from the paper, each what the published weights and the reference script
expect: fc6 has padding 3 and no dilation (the paper converts VGG16's fc6 as SSD does,
dilated; `s3fd.pth`'s fc6 is a plain 3x3 whose map grows by 4); the frame is padded by
50 px reflect-101 and fed as BGR minus (104, 117, 123) (`recrop_CelebA-HQ_images.py`
:17-24 and face_alignment's detect_from_image); the candidates are the anchors whose
softmax face score exceeds 0.05, then face_alignment's greedy NMS at IoU 0.3 with
+1-inclusive areas, then the boxes above 0.5.

The crop (`recrop_CelebA-HQ_images.py` :33-49): the centre (y2 - h/2 + 0.06 h, x2 - w/2)
of the padded box, each component truncated by int(); no crop where l = 1.2 max(w, h)
is under 200; the window of side 2 int(l/2) at the centre, zeros off the padded frame (a
PIL crop); OpenCV's bilinear resize of the uint8 window.

Nothing here is imported from the program; the decode runs in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

PAD = 50
BGR_MEAN = (104.0, 117.0, 123.0)
VARIANCES = (0.1, 0.2)
CANDIDATE = 0.05
NMS_IOU = 0.3
KEEP = 0.5
MIN_SIDE = 200
SCALE = 1.2
CENTRE_SHIFT = 0.06

# (name, in, out, kernel, stride, padding), in forward order; "pool" after a stage.
LAYERS = (
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1), "pool",
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1), "pool",
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1), ("conv3_3", 256, 256, 3, 1, 1), "pool",
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1), ("conv4_3", 512, 512, 3, 1, 1), "pool",
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1), ("conv5_3", 512, 512, 3, 1, 1), "pool",
    ("fc6", 512, 1024, 3, 1, 3), ("fc7", 1024, 1024, 1, 1, 0),
    ("conv6_1", 1024, 256, 1, 1, 0), ("conv6_2", 256, 512, 3, 2, 1),
    ("conv7_1", 512, 128, 1, 1, 0), ("conv7_2", 128, 256, 3, 2, 1),
)
# The detection layers: (source, its channels, stride, L2Norm's initial scale or None).
HEADS = (("conv3_3", 256, 4, 10.0), ("conv4_3", 512, 8, 8.0), ("conv5_3", 512, 16, 5.0),
         ("fc7", 1024, 32, None), ("conv6_2", 512, 64, None), ("conv7_2", 256, 128, None))


def head_name(source: str, scale) -> str:
    return f"{source}_norm" if scale is not None else source


class Scale(nn.Module):
    """L2Norm's learned scale a channel."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), scale))


class S3FD(nn.Module):
    """The network's parameters under `s3fd.pth`'s names; `forward` is `heads`."""

    def __init__(self):
        super().__init__()
        for layer in LAYERS:
            if layer != "pool":
                name, cin, cout, k, _, _ = layer
                self.add_module(name, nn.Conv2d(cin, cout, k))
        for i, (src, c, _, scale) in enumerate(HEADS):
            name = head_name(src, scale)
            if scale is not None:
                self.add_module(name, Scale(c, scale))
            self.add_module(f"{name}_mbox_conf", nn.Conv2d(c, 4 if i == 0 else 2, 3))
            self.add_module(f"{name}_mbox_loc", nn.Conv2d(c, 4, 3))

    def forward(self, x):
        return heads(self.state_dict(), x)


def l2norm_keys() -> dict:
    """`s3fd.pth`'s L2Norm names and their initial scales."""
    return {f"{head_name(s, scale)}.weight": (c, scale) for s, c, _, scale in HEADS if scale is not None}


def heads(p: dict, x: torch.Tensor) -> list:
    """The 12 raw detection outputs [scores 1, offsets 1, ..., scores 6, offsets 6], each
    (1, H_i, W_i, C) with C 2 (background, face) or 4, for x (1, 3, H, W) BGR minus the mean.
    `p` is a state dict under `s3fd.pth`'s names."""
    return head_outputs(p, features(p, x))


def head_outputs(p: dict, feats: dict) -> list:
    """`heads` of the layers' outputs `feats` (`features`)."""
    out = []
    for i, (src, _, _, scale) in enumerate(HEADS):
        f, name = feats[src], head_name(src, scale)
        if scale is not None:
            norm = torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + 1e-10
            f = f / norm * p[f"{name}.weight"].view(1, -1, 1, 1)
        conf = scores(p, name, f)
        if i == 0:  # max-out background: the largest of three background labels, then the face
            conf = torch.cat([conf[..., :3].max(dim=-1, keepdim=True).values, conf[..., 3:]], dim=-1)
        out += [conf, offsets(p, name, f)]
    return out


def features(p: dict, x: torch.Tensor) -> dict:
    """Each layer's output after its ReLU, by name, for x (1, 3, H, W) BGR minus the mean."""
    feats, h = {}, x
    for layer in LAYERS:
        if layer == "pool":
            h = F.max_pool2d(h, 2, 2)
            continue
        name, _, _, _, stride, pad = layer
        h = F.relu(F.conv2d(h, p[f"{name}.weight"], p[f"{name}.bias"], stride=stride, padding=pad))
        feats[name] = h
    return feats


def scores(p: dict, name: str, f: torch.Tensor) -> torch.Tensor:
    """The detection layer `name`'s raw scores (1, H, W, C) of its source's features f (after
    L2Norm), before the first layer's max-out."""
    return F.conv2d(f, p[f"{name}_mbox_conf.weight"], p[f"{name}_mbox_conf.bias"], padding=1).permute(0, 2, 3, 1)


def offsets(p: dict, name: str, f: torch.Tensor) -> torch.Tensor:
    """The detection layer `name`'s four offsets (1, H, W, 4) of its source's features f (after L2Norm)."""
    return F.conv2d(f, p[f"{name}_mbox_loc.weight"], p[f"{name}_mbox_loc.bias"], padding=1).permute(0, 2, 3, 1)


def detector_input(frame_rgb: np.ndarray, device) -> torch.Tensor:
    """(H, W, 3) uint8 RGB -> (1, 3, H + 100, W + 100) float32: reflect-101 padded, BGR, minus the mean."""
    padded = np.pad(frame_rgb, ((PAD, PAD), (PAD, PAD), (0, 0)), mode="reflect")[..., ::-1].astype(np.float32)
    x = torch.from_numpy(np.ascontiguousarray(padded - np.float32(BGR_MEAN)))
    return x.permute(2, 0, 1)[None].to(device)


def candidates(outs) -> np.ndarray:
    """(N, 5) float64 [x1, y1, x2, y2, score] in the padded frame's coordinates: the anchors
    whose face score exceeds CANDIDATE, head by head, row-major within a head."""
    rows = []
    for i in range(len(outs) // 2):
        conf = outs[2 * i][0].double().cpu().numpy()
        loc = outs[2 * i + 1][0].double().cpu().numpy()
        stride = float(HEADS[i][2])
        e = np.exp(conf - conf.max(axis=-1, keepdims=True))
        score = e[..., 1] / e.sum(axis=-1)
        hs, ws = np.nonzero(score > CANDIDATE)
        l = loc[hs, ws]
        side = 4.0 * stride
        cx = (ws + 0.5) * stride + l[:, 0] * VARIANCES[0] * side
        cy = (hs + 0.5) * stride + l[:, 1] * VARIANCES[0] * side
        bw = side * np.exp(l[:, 2] * VARIANCES[1])
        bh = side * np.exp(l[:, 3] * VARIANCES[1])
        rows.append(np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2, score[hs, ws]], axis=1))
    return np.concatenate(rows) if rows else np.zeros((0, 5))


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of box a against each row of b, with +1-inclusive areas."""
    w = np.maximum(0.0, np.minimum(a[2], b[:, 2]) - np.maximum(a[0], b[:, 0]) + 1)
    h = np.maximum(0.0, np.minimum(a[3], b[:, 3]) - np.maximum(a[1], b[:, 1]) + 1)
    inter = w * h
    area = (a[2] - a[0] + 1) * (a[3] - a[1] + 1)
    return inter / (area + (b[:, 2] - b[:, 0] + 1) * (b[:, 3] - b[:, 1] + 1) - inter)


def kept(cands: np.ndarray) -> np.ndarray:
    """face_alignment's NMS at NMS_IOU as published (rows by descending score as
    `argsort()[::-1]` orders them, so ties fall as there; the arithmetic in the rows' own
    dtype), then the boxes above KEEP, by descending score."""
    x1, y1, x2, y2, s = (cands[:, i] for i in range(5))
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = s.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1, yy1 = np.maximum(x1[i], x1[order[1:]]), np.maximum(y1[i], y1[order[1:]])
        xx2, yy2 = np.minimum(x2[i], x2[order[1:]]), np.minimum(y2[i], y2[order[1:]])
        w, h = np.maximum(0.0, xx2 - xx1 + 1), np.maximum(0.0, yy2 - yy1 + 1)
        ovr = w * h / (areas[i] + areas[order[1:]] - w * h)
        order = order[np.where(ovr <= NMS_IOU)[0] + 1]
    out = cands[keep]
    out = out[out[:, 4] > KEEP]
    return out[np.argsort(-out[:, 4])]


def near_tie(cands: np.ndarray, delta: float) -> bool:
    """Whether rounding of size `delta` could change `kept`'s answer: a candidate's score within
    delta of KEEP, or two candidates above KEEP - delta whose IoU lies within delta of NMS_IOU, or
    whose scores lie within delta of each other where their IoU exceeds NMS_IOU - delta (the
    order in which NMS meets them decides which one it keeps)."""
    s = cands[:, 4]
    if np.any(np.abs(s - KEEP) < delta):
        return True
    top = cands[s > KEEP - delta]
    for i in range(len(top)):
        rest = top[i + 1:]
        o = iou(top[i], rest)
        if np.any(np.abs(o - NMS_IOU) < delta) or np.any((np.abs(rest[:, 4] - top[i, 4]) < delta) & (o > NMS_IOU - delta)):
            return True
    return False


def crop_geometry(box):
    """(left, top, side) of the crop of `box` (x1, y1, x2, y2, frame coordinates) on the
    padded frame, or None below MIN_SIDE."""
    x1, y1, x2, y2 = (float(v) + PAD for v in box[:4])
    cy = y2 - (y2 - y1) / 2.0 + (y2 - y1) * CENTRE_SHIFT
    cx = x2 - (x2 - x1) / 2.0
    cy, cx = int(cy), int(cx)
    side = max(x2 - x1, y2 - y1) * SCALE
    if side < MIN_SIDE:
        return None
    half = int(side / 2)
    return cx - half, cy - half, 2 * half


def crop(image: np.ndarray, geometry, size: int) -> np.ndarray:
    """The window of `geometry` on the reflect-101 padded image, zeros off it, resized to
    (size, size) by OpenCV. `image` is (H, W) or (H, W, 3) uint8."""
    import cv2

    widths = ((PAD, PAD), (PAD, PAD)) + ((0, 0),) * (image.ndim - 2)
    padded = np.pad(image, widths, mode="reflect")
    left, top, side = geometry
    out = np.zeros((side, side) + image.shape[2:], np.uint8)
    y0, x0 = max(top, 0), max(left, 0)
    y1, x1 = min(top + side, padded.shape[0]), min(left + side, padded.shape[1])
    if y1 > y0 and x1 > x0:
        out[y0 - top:y1 - top, x0 - left:x1 - left] = padded[y0:y1, x0:x1]
    return cv2.resize(out, (size, size))


def largest(boxes: np.ndarray):
    """The row of the largest box area, or None."""
    if not len(boxes):
        return None
    areas = np.maximum(0, boxes[:, 2] - boxes[:, 0]) * np.maximum(0, boxes[:, 3] - boxes[:, 1])
    return boxes[int(np.argmax(areas))]
