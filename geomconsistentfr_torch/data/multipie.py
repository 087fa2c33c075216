"""The Multi-PIE-relit CelebA-HQ evaluation set (port of geomconsistentfr_tpu/data/multipie.py).

Reference protocol (test_raytracing_relighting_CelebAHQ_DSSIM_8x.py:507-540):
862 input images under 18 Multi-PIE lightings; the target lighting index is
parsed from the GT filename suffix (`*_<idx>.png`, 1-based) into
MP_lighting_directions.mat; masks are depth masks plus a binarised
"fill nose" union with the face mask (:534-538); the pseudo-GT ambient is 0.5.
Items are read lazily, through utils/io's codec.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator

import numpy as np

from geomconsistentfr_torch.utils.io import imread


def lighting_index(gt_name: str) -> int:
    """The 0-based row of MP_lighting_directions.mat a GT filename names (`*_<idx>.png`)."""
    return int(gt_name.split(".")[0].split("_")[-1]) - 1


def load_lighting_directions(path: str) -> np.ndarray:
    import scipy.io

    return scipy.io.loadmat(path)["lighting_directions"]


class MultiPIEEvalData:
    def __init__(self, root: str):
        self.root = root
        self.inputs = sorted(os.listdir(os.path.join(root, "input_images_MP_18_lightings")))
        self.gts = sorted(os.listdir(os.path.join(root, "groundtruth_images_MP_18_lightings")))
        self.masks = sorted(os.listdir(os.path.join(root, "MP_depth_masks")))
        self.masks_fill_nose = sorted(os.listdir(os.path.join(root, "MP_depth_masks_fill_nose")))
        self.face_masks = sorted(os.listdir(os.path.join(root, "MP_face_masks")))
        self.lighting_directions = load_lighting_directions(
            os.path.join(root, "MP_lighting_directions.mat")
        ).astype(np.float32)

    def __len__(self) -> int:
        return len(self.inputs)

    def target_lighting(self, i: int) -> np.ndarray:
        return self.lighting_directions[lighting_index(self.gts[i])]

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        def read(folder, name):
            return np.asarray(imread(os.path.join(self.root, folder, name)), np.float32)

        image = read("input_images_MP_18_lightings", self.inputs[i]) / 255.0
        depth_mask = read("MP_depth_masks", self.masks[i]).reshape(256, 256)
        fill = read("MP_depth_masks_fill_nose", self.masks_fill_nose[i]).reshape(256, 256)
        face = read("MP_face_masks", self.face_masks[i]).reshape(256, 256)
        # :534-538, the binarised union for the "fill nose" mask.
        fill_union = np.where(np.maximum(face, fill) > 128, 255.0, 0.0)
        return {
            "image": image,
            "mask": depth_mask / 255.0,
            "mask_fill_nose": fill_union / 255.0,
            "light_gt": self.target_lighting(i),
            "ambient_gt": np.float32(0.5),
            "name": self.inputs[i],
        }

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for i in range(len(self)):
            yield self[i]
