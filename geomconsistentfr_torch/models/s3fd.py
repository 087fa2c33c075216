"""The S3FD face detector (the reference's crop-preprocessing detector).

Port of geomconsistentfr_tpu/models/s3fd.py. The reference crops CelebA-HQ
with the SFD detector of the `face_alignment` package
(recrop_CelebA-HQ_images.py:9-10, 29): S3FD (Zhang et al., ICCV 2017), a
VGG16 trunk with L2Norm-scaled side heads, a max-out background label on the
stride-4 head, SSD anchor decoding (variances 0.1 / 0.2, anchor side 4x the
stride) and greedy IoU NMS.

  * `S3FD`: the network, its modules named as face_alignment's `s3fd.pth`
    keys, so `load_s3fd_weights` loads that file directly. fc6 is a 3x3
    convolution with padding 3 (no dilation): the map grows by 4, as the
    published weights expect. Takes NHWC, returns the 12 head outputs NHWC.
  * `decode_detections`, `nms`: the anchor decode and NMS, in numpy as the
    JAX package has them (variable-length host-side postprocessing).
  * `preprocess_bgr` and `detect_faces`: detect_from_image's pipeline: BGR
    minus [104, 117, 123], the network, a softmax per head, candidates above
    0.05, decode, NMS at IoU 0.3, the kept boxes above 0.5.

The convolutions are torch's (cuDNN on the card); `detect_faces` runs them
without TF32 and with cuDNN's deterministic algorithms, so a box does not
move between processes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geomconsistentfr_torch.models.layers import exact_convs, reset_torch_default

BGR_MEAN = (104.0, 117.0, 123.0)
STRIDES = (4, 8, 16, 32, 64, 128)
VARIANCES = (0.1, 0.2)
CANDIDATE_THRESHOLD = 0.05
NMS_IOU = 0.3
SCORE_THRESHOLD = 0.5

# (name, in, out, kernel, stride, padding), in forward order.
VGG_CONVS = (
    ("conv1_1", 3, 64, 3, 1, 1), ("conv1_2", 64, 64, 3, 1, 1),
    ("conv2_1", 64, 128, 3, 1, 1), ("conv2_2", 128, 128, 3, 1, 1),
    ("conv3_1", 128, 256, 3, 1, 1), ("conv3_2", 256, 256, 3, 1, 1), ("conv3_3", 256, 256, 3, 1, 1),
    ("conv4_1", 256, 512, 3, 1, 1), ("conv4_2", 512, 512, 3, 1, 1), ("conv4_3", 512, 512, 3, 1, 1),
    ("conv5_1", 512, 512, 3, 1, 1), ("conv5_2", 512, 512, 3, 1, 1), ("conv5_3", 512, 512, 3, 1, 1),
    ("fc6", 512, 1024, 3, 1, 3), ("fc7", 1024, 1024, 1, 1, 0),
    ("conv6_1", 1024, 256, 1, 1, 0), ("conv6_2", 256, 512, 3, 2, 1),
    ("conv7_1", 512, 128, 1, 1, 0), ("conv7_2", 128, 256, 3, 2, 1),
)
# The six sources of the heads, with their input channels; conf1 has 4
# channels (3 background competitors max-out to one), every other conf 2.
SOURCES = (("conv3_3_norm", 256), ("conv4_3_norm", 512), ("conv5_3_norm", 512), ("fc7", 1024),
           ("conv6_2", 512), ("conv7_2", 256))
L2NORM_SCALES = {"conv3_3_norm": 10.0, "conv4_3_norm": 8.0, "conv5_3_norm": 5.0}


class L2Norm(nn.Module):
    """SSD's L2Norm: x over its L2 norm across channels (+1e-10), times a learned scale per channel."""

    def __init__(self, channels: int, scale: float):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + 1e-10
        return x / norm * self.weight.view(1, -1, 1, 1)


class S3FD(nn.Module):
    """S3FD: (B, H, W, 3) mean-subtracted BGR -> [cls1, reg1, ..., cls6, reg6], each NHWC.

    cls1 has the max-out background applied (two channels, like every other
    conf head); no softmax (decode_detections applies it). The weights are
    torch's default init drawn from `generator` (seed 0 by default).
    """

    def __init__(self, generator: Optional[torch.Generator] = None):
        super().__init__()
        for name, c_in, c_out, k, s, p in VGG_CONVS:
            self.add_module(name, nn.Conv2d(c_in, c_out, k, stride=s, padding=p))
        for name, scale in L2NORM_SCALES.items():
            self.add_module(name, L2Norm(dict(SOURCES)[name], scale))
        for i, (src, c_in) in enumerate(SOURCES):
            self.add_module(f"{src}_mbox_conf", nn.Conv2d(c_in, 4 if i == 0 else 2, 3, padding=1))
            self.add_module(f"{src}_mbox_loc", nn.Conv2d(c_in, 4, 3, padding=1))
        reset_torch_default(self, generator if generator is not None else torch.Generator().manual_seed(0))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        def cr(*names):
            nonlocal h
            for name in names:
                h = F.relu(getattr(self, name)(h))
            return h

        h = x.permute(0, 3, 1, 2)
        cr("conv1_1", "conv1_2")
        h = F.max_pool2d(h, 2, 2)
        cr("conv2_1", "conv2_2")
        h = F.max_pool2d(h, 2, 2)
        f3 = cr("conv3_1", "conv3_2", "conv3_3")
        h = F.max_pool2d(h, 2, 2)
        f4 = cr("conv4_1", "conv4_2", "conv4_3")
        h = F.max_pool2d(h, 2, 2)
        f5 = cr("conv5_1", "conv5_2", "conv5_3")
        h = F.max_pool2d(h, 2, 2)
        ffc7 = cr("fc6", "fc7")
        f6 = cr("conv6_1", "conv6_2")
        f7 = cr("conv7_1", "conv7_2")
        feats = {"conv3_3_norm": self.conv3_3_norm(f3), "conv4_3_norm": self.conv4_3_norm(f4),
                 "conv5_3_norm": self.conv5_3_norm(f5), "fc7": ffc7, "conv6_2": f6, "conv7_2": f7}
        outputs = []
        for i, (src, _) in enumerate(SOURCES):
            cls = getattr(self, f"{src}_mbox_conf")(feats[src])
            reg = getattr(self, f"{src}_mbox_loc")(feats[src])
            if i == 0:  # max-out background: three competitors, channel 3 the face
                cls = torch.cat([cls[:, 0:3].amax(dim=1, keepdim=True), cls[:, 3:4]], dim=1)
            outputs += [cls.permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1)]
        return outputs


def load_s3fd_weights(path: str, device=None) -> S3FD:
    """An S3FD with face_alignment's `s3fd.pth` (or a state dict nested under 'state_dict')."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    model = S3FD()
    model.load_state_dict(state)
    return model.to(device) if device is not None else model


def nms(boxes: np.ndarray, iou_threshold: float = NMS_IOU) -> List[int]:
    """Greedy IoU NMS over (N, 5) [x1, y1, x2, y2, score] rows (+1-inclusive areas, SFD's convention)."""
    if len(boxes) == 0:
        return []
    x1, y1, x2, y2, s = (boxes[:, i] for i in range(5))
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = s.argsort()[::-1]
    keep: List[int] = []
    while order.size > 0:
        i = int(order[0])
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0.0, xx2 - xx1 + 1) * np.maximum(0.0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= iou_threshold]
    return keep


def decode_detections(outputs: Sequence[np.ndarray], candidate_threshold: float = CANDIDATE_THRESHOLD) -> np.ndarray:
    """The SSD anchor decode of the 12 outputs ((1, H_i, W_i, C) raw logits) -> (N, 5) candidates.

    Head i has stride 2**(i+2) and a square anchor of side 4 * stride centred
    at ((w + 0.5) * stride, (h + 0.5) * stride); variances (0.1, 0.2).
    """
    rows: List[List[float]] = []
    for i in range(len(outputs) // 2):
        cls = np.asarray(outputs[2 * i], np.float32)[0]
        reg = np.asarray(outputs[2 * i + 1], np.float32)[0]
        e = np.exp(cls - cls.max(axis=-1, keepdims=True))
        prob = (e / e.sum(axis=-1, keepdims=True))[..., 1]
        stride = float(STRIDES[i])
        hs, ws = np.where(prob > candidate_threshold)
        for hh, ww in zip(hs, ws):
            axc = stride / 2 + ww * stride
            ayc = stride / 2 + hh * stride
            side = stride * 4
            loc = reg[hh, ww]
            cx = axc + loc[0] * VARIANCES[0] * side
            cy = ayc + loc[1] * VARIANCES[0] * side
            bw = side * np.exp(loc[2] * VARIANCES[1])
            bh = side * np.exp(loc[3] * VARIANCES[1])
            rows.append([cx - bw / 2, cy - bh / 2, cx - bw / 2 + bw, cy - bh / 2 + bh, float(prob[hh, ww])])
    if not rows:
        return np.zeros((0, 5), np.float32)
    return np.asarray(rows, np.float32)


def preprocess_bgr(image_bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) BGR -> (1, H, W, 3) float32 minus BGR_MEAN."""
    return (np.asarray(image_bgr, np.float32) - np.asarray(BGR_MEAN, np.float32))[None]


def heads(model: S3FD, image_bgr: np.ndarray) -> List[np.ndarray]:
    """The 12 raw head outputs on the host for one BGR frame, computed on the model's device
    without TF32 and with cuDNN's deterministic algorithms."""
    device = next(model.parameters()).device
    x = torch.from_numpy(preprocess_bgr(image_bgr)).to(device)
    with torch.no_grad(), exact_convs():
        return [o.cpu().numpy() for o in model.eval()(x)]


def detect_faces(image_bgr: np.ndarray, model: S3FD, score_threshold: float = SCORE_THRESHOLD) -> np.ndarray:
    """face_alignment's detect_from_image: (N, 5) [x1, y1, x2, y2, score] kept boxes, by descending score."""
    boxes = decode_detections(heads(model, image_bgr))
    if len(boxes) == 0:
        return boxes
    boxes = boxes[nms(boxes, NMS_IOU)]
    boxes = boxes[boxes[:, 4] > score_threshold]
    return boxes[np.argsort(-boxes[:, 4])]

