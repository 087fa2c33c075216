"""BAPPS-style 2AFC and JND dataset directories (port of geomconsistentfr_tpu/data/bapps.py).

The layout the reference's perceptual-similarity harness reads
(PerceptualSimilarity/data/dataset/twoafc_dataset.py:1-65, jnd_dataset.py:1-53):

  2AFC root(s):  ref/ p0/ p1/ (images) and judge/*.npy (the fraction of
                 humans who preferred p1, one scalar per triple, in [0, 1])
  JND root:      p0/ p1/ (images) and same/*.npy (the fraction who said
                 "same", one scalar per pair)

Images are resized to `load_size` (BAPPS ships 64x64 patches) and returned
as float32 in [0, 1]. Files pair by sorted order within each directory; the
counts must agree, else a ValueError (not zip's silent truncation).
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Sequence, Union

import numpy as np

from geomconsistentfr_torch.metrics.perceptual import score_2afc, score_jnd
from geomconsistentfr_torch.utils.io import _resize, imread

IMG_EXTS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp")  # data/image_folder.py IMG_EXTENSIONS


def _list(directory: str, exts) -> List[str]:
    if not os.path.isdir(directory):
        raise FileNotFoundError(f"missing dataset directory: {directory}")
    return [os.path.join(directory, f) for f in sorted(os.listdir(directory)) if f.lower().endswith(exts)]


def _read_image01(path: str, load_size: int) -> np.ndarray:
    img = np.asarray(imread(path))
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    img = img.astype(np.float32) / 255.0
    if img.shape[0] != load_size or img.shape[1] != load_size:
        img = _resize(img, load_size)
    return img


def _read_scalar(path: str) -> float:
    return float(np.load(path).reshape(-1)[0])


class TwoAFCDirectory:
    """ref/p0/p1 images and judge/*.npy, over one or several roots (the reference
    trains on e.g. train/traditional and train/cnn together)."""

    def __init__(self, roots: Union[Sequence[str], str], load_size: int = 64):
        if isinstance(roots, str):
            roots = [roots]
        self.load_size = load_size
        self.ref_paths: List[str] = []
        self.p0_paths: List[str] = []
        self.p1_paths: List[str] = []
        self.judge_paths: List[str] = []
        for root in roots:
            ref, p0, p1 = (_list(os.path.join(root, d), IMG_EXTS) for d in ("ref", "p0", "p1"))
            judge = _list(os.path.join(root, "judge"), (".npy",))
            if not (len(ref) == len(p0) == len(p1) == len(judge)):
                raise ValueError(f"2AFC root {root}: count mismatch "
                                 f"(ref {len(ref)}, p0 {len(p0)}, p1 {len(p1)}, judge {len(judge)})")
            self.ref_paths += ref
            self.p0_paths += p0
            self.p1_paths += p1
            self.judge_paths += judge

    def __len__(self) -> int:
        return len(self.ref_paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {
            "ref": _read_image01(self.ref_paths[i], self.load_size),
            "p0": _read_image01(self.p0_paths[i], self.load_size),
            "p1": _read_image01(self.p1_paths[i], self.load_size),
            "judge": np.float32(_read_scalar(self.judge_paths[i])),
        }

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_remainder: bool = False) -> Iterator[Dict[str, np.ndarray]]:
        """Stacked batches for LPIPS2AFCTrainer.train_step."""
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_remainder and len(idx) < batch_size:
                return
            items = [self[int(i)] for i in idx]
            yield {
                "ref": np.stack([it["ref"] for it in items]),
                "p0": np.stack([it["p0"] for it in items]),
                "p1": np.stack([it["p1"] for it in items]),
                "judge": np.asarray([it["judge"] for it in items], np.float32),
            }


class JNDDirectory:
    """p0/p1 images and same/*.npy (jnd_dataset.py:1-53)."""

    def __init__(self, root: str, load_size: int = 64):
        self.load_size = load_size
        self.p0_paths = _list(os.path.join(root, "p0"), IMG_EXTS)
        self.p1_paths = _list(os.path.join(root, "p1"), IMG_EXTS)
        self.same_paths = _list(os.path.join(root, "same"), (".npy",))
        if not (len(self.p0_paths) == len(self.p1_paths) == len(self.same_paths)):
            raise ValueError(f"JND root {root}: count mismatch (p0 {len(self.p0_paths)}, "
                             f"p1 {len(self.p1_paths)}, same {len(self.same_paths)})")

    def __len__(self) -> int:
        return len(self.p0_paths)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return {
            "p0": _read_image01(self.p0_paths[i], self.load_size),
            "p1": _read_image01(self.p1_paths[i], self.load_size),
            "same": np.float32(_read_scalar(self.same_paths[i])),
        }


def score_2afc_directory(roots: Union[Sequence[str], str], distance, load_size: int = 64) -> float:
    """The 2AFC agreement of `distance` over an on-disk dataset (metrics.perceptual.score_2afc)."""
    ds = TwoAFCDirectory(roots, load_size=load_size)
    items = [ds[i] for i in range(len(ds))]
    return score_2afc([it["ref"] for it in items], [it["p0"] for it in items], [it["p1"] for it in items],
                      [float(it["judge"]) for it in items], distance)


def score_jnd_directory(root: str, distance, load_size: int = 64) -> float:
    """The JND score of `distance` over an on-disk dataset (metrics.perceptual.score_jnd)."""
    ds = JNDDirectory(root, load_size=load_size)
    items = [ds[i] for i in range(len(ds))]
    return score_jnd([it["p0"] for it in items], [it["p1"] for it in items], [float(it["same"]) for it in items],
                     distance)
