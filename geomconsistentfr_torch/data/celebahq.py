"""Training data: the CelebA-HQ cache builder and reader, and a synthetic stand-in.

A numpy-only copy of geomconsistentfr_tpu/data/celebahq.py (the port imports
nothing of the JAX package). `build_cache` packs the reference's MP_data
layout once into memmaps: uint8 images and masks, float32 depth and light
(`FIELDS`), the preprocessing of train_raytracing_..._8x.py:527-558 done
once: the "fill nose and mouth" face mask is max(face mask, depth mask)
binarised at 128, the light is the per-image .mat's direction.
`CelebAHQRelightingData` streams batches from the cache. `SyntheticFaceData`
emits procedural faces (ellipsoid depth, smooth albedo, random lighting)
with the same batch schema, equal to the JAX package's bit for bit for the
same seed.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Tuple

import numpy as np

FIELDS = {
    "image": (np.uint8, (256, 256, 3)),
    "depth_gt": (np.float32, (256, 256)),
    "depth_mask": (np.uint8, (256, 256)),
    "albedo_gt": (np.uint8, (256, 256)),
    "face_mask": (np.uint8, (256, 256)),
    "light_gt": (np.float32, (3,)),
}


SIZE = 256


def jpeg_reader() -> Tuple[str, Callable[[str, int], np.ndarray]]:
    """(name, read(path, channels)) of the first JPEG decoder that works here.

    The port's libjpeg loader (data/native_loader.py) where it built with
    libjpeg, else OpenCV, else Pillow (the JAX package's order is native,
    then imageio; the card's machine has no imageio). read() gives (256, 256,
    3) RGB for 3 channels and (256, 256) grey for 1, and raises on any other
    size. Raises where none of the three is available.
    """
    from geomconsistentfr_torch.data import native_loader

    if native_loader.has_native_jpeg():
        return "native-libjpeg", lambda path, channels: native_loader.decode_jpeg(path, SIZE, SIZE, channels)

    def sized(img, path, channels):
        want = (SIZE, SIZE, 3) if channels == 3 else (SIZE, SIZE)
        if img is None or img.shape != want:
            raise ValueError(f"JPEG {path} did not decode to {want}")
        return np.ascontiguousarray(img)

    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        def read_cv2(path, channels):
            img = cv2.imread(path, cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE)
            return sized(None if img is None else (img[..., ::-1] if channels == 3 else img), path, channels)

        return "opencv", read_cv2
    try:
        from PIL import Image
    except ImportError:
        raise RuntimeError("no JPEG decoder: the native loader has no libjpeg, and neither cv2 nor PIL "
                           "imports") from None

    def read_pil(path, channels):
        with Image.open(path) as im:
            return sized(np.asarray(im.convert("RGB" if channels == 3 else "L")), path, channels)

    return "pillow", read_pil


def build_cache(src_root: str, cache_dir: str, limit: Optional[int] = None) -> int:
    """Pack the reference MP_data layout into memmaps under `cache_dir`; the sample count.

    Expects the directories of train_raytracing_...py:535-539:
      CelebA-HQ_DFNRMVS_cropped/   lighting_directions_CelebAHQ_DFNRMVS/
      depth_maps_CelebA-HQ/        depth_masks_CelebA-HQ_DFNRMVS/
      CelebA-HQ_albedo_grayscale/  CelebAHQ_face_masks/
    Samples follow the sorted depth-map names (the first `limit`). JPEGs go
    through `jpeg_reader()`, the .mat files through scipy.io, the PNG depth
    masks through utils/io.
    """
    import scipy.io

    from geomconsistentfr_torch.utils.io import imread

    _, read_jpg = jpeg_reader()
    depths = sorted(os.listdir(os.path.join(src_root, "depth_maps_CelebA-HQ")))
    if limit:
        depths = depths[:limit]
    n = len(depths)
    os.makedirs(cache_dir, exist_ok=True)
    maps = {
        k: np.lib.format.open_memmap(os.path.join(cache_dir, f"{k}.npy"), mode="w+", dtype=dt, shape=(n, *shape))
        for k, (dt, shape) in FIELDS.items()
    }
    for i, depth_name in enumerate(depths):
        stem = depth_name.split("_")[0]
        mat = scipy.io.loadmat(os.path.join(src_root, "depth_maps_CelebA-HQ", depth_name))
        maps["depth_gt"][i] = np.reshape(mat["depth_img"], (SIZE, SIZE)).astype(np.float32)
        depth_mask = np.reshape(
            imread(os.path.join(src_root, "depth_masks_CelebA-HQ_DFNRMVS", depth_name.replace(".mat", ".png"))),
            (SIZE, SIZE),
        )
        maps["depth_mask"][i] = depth_mask
        maps["image"][i] = read_jpg(os.path.join(src_root, "CelebA-HQ_DFNRMVS_cropped", stem + ".jpg"), 3)
        maps["albedo_gt"][i] = read_jpg(os.path.join(src_root, "CelebA-HQ_albedo_grayscale", stem + ".jpg"), 1)
        face = read_jpg(os.path.join(src_root, "CelebAHQ_face_masks", stem + ".jpg"), 1)
        fill = np.maximum(face, depth_mask)
        maps["face_mask"][i] = np.where(fill > 128, 255, 0).astype(np.uint8)
        light = scipy.io.loadmat(os.path.join(src_root, "lighting_directions_CelebAHQ_DFNRMVS", stem + ".jpg.mat"))
        maps["light_gt"][i] = light["lighting_direction"].reshape(3)
    for m in maps.values():
        m.flush()
    with open(os.path.join(cache_dir, "meta.json"), "w") as f:
        json.dump({"num_samples": n}, f)
    return n


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
