"""ctypes binding of the port's native loader and libjpeg codec (csrc/dataloader.cc).

The port's own copy of geomconsistentfr_tpu/data/native_loader.py: the same
C interface, built the same way, but from geomconsistentfr_torch/csrc/ and
into `<repo>/build/native/` (git-ignored). It provides:

  * `has_native_jpeg()`: whether the library was built with libjpeg;
  * `decode_jpeg`, `decode_jpegs` (threaded) and `encode_jpeg`, libjpeg's
    codec (build_cache reads the dataset's JPEGs with it; the server answers
    "format": "jpeg" with it);
  * `NativeCelebAHQLoader`: batches of the packed cache (data/celebahq.py
    build_cache) assembled by background threads into a bounded queue.

The library is built at first use with
`g++ -O3 -march=native -std=c++17 -shared -fPIC -pthread`, first with
`-ljpeg` and, where that fails (no libjpeg headers or library), again with
`-DGCFR_NO_JPEG`, which compiles the codec out: `has_native_jpeg()` then
says False and the codec functions raise. The file name holds a hash of
the source, the flags and the host CPU (-march=native code may not run on
another CPU). A build goes to a temporary name and is renamed into place,
so processes that build at once never load half a file; a failed build
leaves its compiler output as `<name>.failed` and is not tried again (delete
it, e.g. after installing libjpeg, to retry). This is host code:
nothing here runs on the GPU.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import json
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "dataloader.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread")
JPEG_FLAGS, NO_JPEG_FLAGS = ("-ljpeg",), ("-DGCFR_NO_JPEG",)


def _host_cpu() -> str:
    """The host CPU's model and feature flags (what -march=native compiles for)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [ln for ln in f if ln.startswith(("model name", "flags"))]
        return "".join(sorted(set(lines)))
    except OSError:
        return platform.processor() or platform.machine()


def _compile(extra) -> Optional[Path]:
    """The library built with `extra` flags (built now unless it exists); None if g++ fails,
    now or at an earlier attempt (its stderr is kept beside, as <name>.failed)."""
    src = SOURCE.read_bytes()
    key = hashlib.sha256(src + " ".join(GXX_FLAGS + tuple(extra)).encode() + _host_cpu().encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"gcfr_dataloader_{key}.so"
    failed = BUILD_DIR / f"gcfr_dataloader_{key}.failed"
    if lib.exists():
        return lib
    if failed.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", tmp, *extra], capture_output=True, text=True,
                          stdin=subprocess.DEVNULL)
    if proc.returncode != 0:
        with contextlib.suppress(FileNotFoundError):  # the linker removes its output when it fails
            os.unlink(tmp)
        failed.write_text(proc.stderr)  # one attempt per source, flags and CPU, not one per call
        return None
    os.replace(tmp, lib)  # atomic: a concurrent build sees a whole file
    return lib


def build_library(jpeg: bool = True) -> Path:
    """The library's path, built if needed: with libjpeg where it links, else without."""
    lib = _compile(JPEG_FLAGS) if jpeg else None
    if lib is None:
        lib = _compile(NO_JPEG_FLAGS)
    if lib is None:
        raise RuntimeError(f"g++ failed to build {SOURCE.name} (see {BUILD_DIR}/*.failed)")
    return lib


def load(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    fp = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.gcfr_loader_create.restype = ctypes.c_void_p
    lib.gcfr_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gcfr_loader_next.argtypes = [ctypes.c_void_p] + [fp] * 6
    lib.gcfr_loader_next_raw.argtypes = [ctypes.c_void_p, u8p, fp, u8p, u8p, u8p, fp]
    lib.gcfr_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.gcfr_has_jpeg.restype = ctypes.c_int
    lib.gcfr_decode_jpeg.restype = ctypes.c_int
    lib.gcfr_decode_jpeg.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.gcfr_decode_jpegs.restype = ctypes.c_int
    lib.gcfr_decode_jpegs.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.gcfr_encode_jpeg.restype = ctypes.c_ulong
    lib.gcfr_encode_jpeg.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(u8p)]
    lib.gcfr_free.argtypes = [u8p]
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    return load(build_library())


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def has_native_jpeg() -> bool:
    """True when the library built with libjpeg (False also where g++ cannot build it)."""
    try:
        return bool(_lib().gcfr_has_jpeg())
    except (RuntimeError, OSError):
        return False


def decode_jpeg(path: str, height: int, width: int, channels: int) -> np.ndarray:
    """Decode one JPEG into (H, W, C) uint8 ((H, W) for C = 1, libjpeg's grey conversion).

    Raises on a missing, corrupt or differently sized file (a silent resize
    would hide a corrupt dataset), and where libjpeg was compiled out.
    """
    out = np.empty((height, width, channels), np.uint8)
    rc = _lib().gcfr_decode_jpeg(path.encode(), _u8(out), height, width, channels)
    if rc != 0:
        raise ValueError(f"native JPEG decode failed (code {rc}): {path}")
    return out[..., 0] if channels == 1 else out


def decode_jpegs(paths, height: int, width: int, channels: int, workers: int = 4) -> np.ndarray:
    """Threaded decode of many JPEGs -> (N, H, W, C) uint8; raises if any file fails."""
    paths = list(paths)
    out = np.empty((len(paths), height, width, channels), np.uint8)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    failures = _lib().gcfr_decode_jpegs(arr, len(paths), _u8(out), height, width, channels, workers)
    if failures:
        raise ValueError(f"native JPEG batch decode: {failures} file(s) failed")
    return out[..., 0] if channels == 1 else out


def encode_jpeg(img: np.ndarray, quality: int = 90) -> bytes:
    """libjpeg's in-memory JPEG of (H, W, 3) or (H, W) uint8; raises where libjpeg was compiled out."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg needs uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_uint8)()
    size = lib.gcfr_encode_jpeg(_u8(img), h, w, c, int(quality), ctypes.byref(out))
    if not size:
        raise ValueError(f"native JPEG encode failed (shape {img.shape}, q={quality})")
    try:
        return ctypes.string_at(out, size)
    finally:
        lib.gcfr_free(out)


_FLOAT_SCHEMA = ("image", "depth_gt", "depth_mask", "albedo_gt", "face_mask", "light_gt")


class NativeCelebAHQLoader:
    """A batch source on the C++ prefetching loader (the JAX package's, with its schema).

    `next_batch` gives float32 batches (uint8 fields / 255 on the host),
    `next_batch_raw` the stored dtypes (train.decode_batch divides on the
    device). The batch order is the C++ loader's own shuffle from `seed`.
    """

    def __init__(self, cache_dir: str, batch_size: int, seed: int = 0, workers: int = 2,
                 queue_capacity: int = 4, raw: bool = False):
        with open(os.path.join(cache_dir, "meta.json")) as f:
            self.num_samples = json.load(f)["num_samples"]
        self.batch_size = batch_size
        self.raw = raw
        self._lib = _lib()
        self._handle = self._lib.gcfr_loader_create(cache_dir.encode(), self.num_samples, batch_size, seed,
                                                    workers, queue_capacity, int(raw))
        if not self._handle:
            raise RuntimeError(f"native loader failed to open cache {cache_dir}")

    def _empty(self, raw: bool) -> Dict[str, np.ndarray]:
        b, s = self.batch_size, 256
        u8 = np.uint8 if raw else np.float32
        return {
            "image": np.empty((b, s, s, 3), u8),
            "depth_gt": np.empty((b, s, s), np.float32),
            "depth_mask": np.empty((b, s, s), u8),
            "albedo_gt": np.empty((b, s, s), u8),
            "face_mask": np.empty((b, s, s), u8),
            "light_gt": np.empty((b, 3), np.float32),
        }

    def next_batch(self) -> Dict[str, np.ndarray]:
        if self.raw:
            raise RuntimeError("loader created with raw=True; use next_batch_raw")
        out = self._empty(raw=False)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.gcfr_loader_next(self._handle, *[out[k].ctypes.data_as(fp) for k in _FLOAT_SCHEMA])
        return out

    def next_batch_raw(self) -> Dict[str, np.ndarray]:
        """Stored-dtype batch: uint8 image, masks and albedo, float32 depth and light."""
        if not self.raw:
            raise RuntimeError("loader created with raw=False; use next_batch")
        out = self._empty(raw=True)
        fp = ctypes.POINTER(ctypes.c_float)
        self._lib.gcfr_loader_next_raw(
            self._handle, _u8(out["image"]), out["depth_gt"].ctypes.data_as(fp), _u8(out["depth_mask"]),
            _u8(out["albedo_gt"]), _u8(out["face_mask"]), out["light_gt"].ctypes.data_as(fp),
        )
        return out

    def sample_batch(self, rng=None, batch_size=None) -> Dict[str, np.ndarray]:
        """The Trainer's signature; the loader's own queue ignores `rng`."""
        if batch_size is not None and batch_size != self.batch_size:
            raise ValueError(f"this loader serves batches of {self.batch_size}, not {batch_size}")
        return self.next_batch_raw() if self.raw else self.next_batch()

    def close(self) -> None:
        if self._handle:
            self._lib.gcfr_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
