"""Training data: the packed CelebA-HQ cache reader and a synthetic stand-in.

A numpy-only copy of geomconsistentfr_tpu/data/celebahq.py:28-35, 120-231
(the port imports nothing of the JAX package). The cache holds uint8
images and masks, float32 depth and light, packed once by the JAX package's
`build_cache` (its counterpart here, and the native JPEG loader, come in a
later slice). `SyntheticFaceData` emits procedural faces (ellipsoid depth,
smooth albedo, random lighting) with the same batch schema, equal to the JAX
package's bit for bit for the same seed.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

FIELDS = {
    "image": (np.uint8, (256, 256, 3)),
    "depth_gt": (np.float32, (256, 256)),
    "depth_mask": (np.uint8, (256, 256)),
    "albedo_gt": (np.uint8, (256, 256)),
    "face_mask": (np.uint8, (256, 256)),
    "light_gt": (np.float32, (3,)),
}


class CelebAHQRelightingData:
    """Batches streamed from a packed cache (memmaps plus meta.json)."""

    def __init__(self, cache_dir: str):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.num_samples = json.load(f)["num_samples"]
        self._maps = {
            k: np.load(os.path.join(cache_dir, f"{k}.npy"), mmap_mode="r")
            for k in FIELDS
        }

    def get_batch(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        m = self._maps
        return {
            "image": m["image"][indices].astype(np.float32) / 255.0,
            "depth_gt": np.asarray(m["depth_gt"][indices], np.float32),
            "depth_mask": m["depth_mask"][indices].astype(np.float32) / 255.0,
            "albedo_gt": m["albedo_gt"][indices].astype(np.float32) / 255.0,
            "face_mask": m["face_mask"][indices].astype(np.float32) / 255.0,
            "light_gt": np.asarray(m["light_gt"][indices], np.float32),
        }

    def get_batch_raw(self, indices: np.ndarray) -> Dict[str, np.ndarray]:
        """Stored-dtype batch (uint8 images and masks, float32 depth and light).

        Moves 2.8x fewer bytes to the device than get_batch's float32 schema;
        train.decode_batch divides the uint8 fields by 255 there.
        """
        return {k: np.asarray(self._maps[k][indices]) for k in FIELDS}

    def sample_indices(self, rng: np.random.Generator, batch_size: int):
        """One batch's indices; consumes the rng exactly like sample_batch."""
        return np.sort(rng.integers(0, self.num_samples, size=batch_size))

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        return self.get_batch(self.sample_indices(rng, batch_size))

    def sample_batch_raw(self, rng: np.random.Generator, batch_size: int):
        """Raw-dtype twin of sample_batch (the same index stream per rng)."""
        return self.get_batch_raw(self.sample_indices(rng, batch_size))

    def epoch_batch_indices(self, rng: np.random.Generator, batch_size: int, batches_per_epoch: int):
        """Reference epoch structure: shuffle contiguous batch slots, visit the
        first `batches_per_epoch` (train_*.py:578,593,606)."""
        slots = np.arange(self.num_samples // batch_size)
        rng.shuffle(slots)
        for slot in slots[:batches_per_epoch]:
            yield np.arange(slot * batch_size, (slot + 1) * batch_size)


class SyntheticFaceData:
    """Procedural stand-in with the training batch schema (no dataset needed)."""

    def __init__(self, num_samples: int = 64, size: int = 256, seed: int = 0):
        self.num_samples = num_samples
        self.size = size
        rng = np.random.default_rng(seed)
        s = size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        cx = cy = s / 2.0
        r2 = ((xx - cx) / (0.38 * s)) ** 2 + ((yy - cy) / (0.46 * s)) ** 2
        inside = r2 < 1.0
        dome = np.where(inside, np.sqrt(np.clip(1.0 - r2, 0.0, 1.0)), 0.0)

        self._samples = []
        for _ in range(num_samples):
            jitter = rng.normal(scale=0.05, size=(s, s)).astype(np.float32)
            depth = (-60.0 * dome + 10.0 + 5.0 * jitter * inside).astype(np.float32)
            base = rng.uniform(0.25, 0.8, size=(1, 1, 3)).astype(np.float32)
            albedo = np.clip(base + 0.1 * rng.normal(size=(s, s, 3)).astype(np.float32), 0.05, 1.0)
            direction = rng.normal(size=3).astype(np.float32)
            direction[2] = abs(direction[2]) + 0.3
            direction /= np.linalg.norm(direction)
            shading = np.clip(
                0.5 + 0.5 * dome * direction[2]
                + 0.3 * ((xx - cx) / s) * direction[0]
                + 0.3 * ((cy - yy) / s) * direction[1],
                0.0,
                1.2,
            ).astype(np.float32)
            image = np.clip(albedo * shading[..., None], 0.0, 1.0)
            mask = inside.astype(np.float32)
            self._samples.append(
                {
                    "image": image,
                    "depth_gt": depth,
                    "depth_mask": mask,
                    "albedo_gt": albedo.mean(-1),
                    "face_mask": mask,
                    "light_gt": direction,
                }
            )

    def get_batch(self, indices) -> Dict[str, np.ndarray]:
        return {k: np.stack([self._samples[int(i)][k] for i in indices]) for k in FIELDS}

    def sample_indices(self, rng: np.random.Generator, batch_size: int):
        """One batch's indices (the same rng consumption as sample_batch)."""
        return rng.integers(0, self.num_samples, size=batch_size)

    def sample_batch(self, rng: np.random.Generator, batch_size: int):
        return self.get_batch(self.sample_indices(rng, batch_size))
