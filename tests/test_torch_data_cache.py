"""The port's build_cache against the JAX package's, on an MP_data tree made here.

  * Every .npy and meta.json of the port's cache is byte-equal to the JAX
    build_cache's of the same 8-sample tree (the JPEGs through the same
    libjpeg here), also with `limit`;
  * the cache reads back through CelebAHQRelightingData as the JAX reader
    reads it, the fill mask binarised;
  * without the native decoder the JPEGs go through OpenCV, then Pillow
    (within a few levels of libjpeg's pixels), and with none it raises.
"""

import json
import os
import sys

import numpy as np
import pytest
import scipy.io

from geomconsistentfr_torch.data import celebahq as TD
from geomconsistentfr_torch.data import native_loader as TN
from geomconsistentfr_torch.utils.png import encode_png
from geomconsistentfr_tpu.data import celebahq as JD
from geomconsistentfr_tpu.data import native_loader as JN
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

DIRS = ("CelebA-HQ_DFNRMVS_cropped", "lighting_directions_CelebAHQ_DFNRMVS", "depth_maps_CelebA-HQ",
        "depth_masks_CelebA-HQ_DFNRMVS", "CelebA-HQ_albedo_grayscale", "CelebAHQ_face_masks")


def write_mp_data(root, n: int, seed: int = 0) -> str:
    """An MP_data tree of n random samples in the reference's six directories."""
    for d in DIRS:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:256, 0:256]
    for i in range(n):
        stem = f"{i * 7 + 3:05d}"
        face = ((xx - 128) ** 2 / 90.0**2 + (yy - 128) ** 2 / 110.0**2 < 1).astype(np.uint8) * 255
        blobs = (rng.uniform(size=(256, 256)) > 0.6).astype(np.uint8) * 255
        j = lambda d, name: os.path.join(root, d, name)  # noqa: E731
        with open(j(DIRS[0], stem + ".jpg"), "wb") as f:
            f.write(JN.encode_jpeg(rng.integers(0, 256, (256, 256, 3)).astype(np.uint8), 90))
        with open(j(DIRS[4], stem + ".jpg"), "wb") as f:
            f.write(JN.encode_jpeg(rng.integers(0, 256, (256, 256)).astype(np.uint8), 90))
        with open(j(DIRS[5], stem + ".jpg"), "wb") as f:
            f.write(JN.encode_jpeg(np.maximum(face, blobs // 2), 95))
        with open(j(DIRS[3], f"{stem}_depth.png"), "wb") as f:
            f.write(encode_png(blobs))
        scipy.io.savemat(j(DIRS[2], f"{stem}_depth.mat"), {"depth_img": rng.normal(size=(256, 256)) * 20.0})
        scipy.io.savemat(j(DIRS[1], f"{stem}.jpg.mat"), {"lighting_direction": rng.normal(size=(1, 3))})
    return str(root)


@pytest.fixture(scope="module")
def mp_data(tmp_path_factory):
    return write_mp_data(tmp_path_factory.mktemp("MP_data"), 8)


def cache_files(cache: str) -> dict:
    return {name: open(os.path.join(cache, name), "rb").read() for name in sorted(os.listdir(cache))}


@pytest.mark.parametrize("limit", [None, 5])
def test_build_cache_is_byte_equal_to_jax(mp_data, tmp_path, limit):
    assert TN.has_native_jpeg() and JN.has_native_jpeg()
    n_port = TD.build_cache(mp_data, str(tmp_path / "port"), limit=limit)
    n_jax = JD.build_cache(mp_data, str(tmp_path / "jax"), limit=limit)
    assert n_port == n_jax == (limit or 8)
    got, want = cache_files(str(tmp_path / "port")), cache_files(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want) == sorted([f"{k}.npy" for k in TD.FIELDS] + ["meta.json"])
    for name in want:
        assert got[name] == want[name], name


def test_the_cache_reads_back_as_jax_reads_it(mp_data, tmp_path):
    TD.build_cache(mp_data, str(tmp_path / "c"))
    port, ref = TD.CelebAHQRelightingData(str(tmp_path / "c")), JD.CelebAHQRelightingData(str(tmp_path / "c"))
    idx = np.array([6, 1, 3])
    got, want = port.get_batch(idx), ref.get_batch(idx)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert set(np.unique(got["face_mask"])) <= {0.0, 1.0}
    assert json.loads((tmp_path / "c" / "meta.json").read_text()) == {"num_samples": 8}
    mat = scipy.io.loadmat(os.path.join(mp_data, DIRS[2], "00010_depth.mat"))["depth_img"]
    np.testing.assert_array_equal(got["depth_gt"][1], mat.astype(np.float32))


@pytest.mark.parametrize("blocked, name", [((), "opencv"), (("cv2",), "pillow")])
def test_without_the_native_decoder_jpegs_go_through_opencv_then_pillow(mp_data, tmp_path, monkeypatch,
                                                                        blocked, name):
    monkeypatch.setattr(TN, "has_native_jpeg", lambda: False)
    for package in blocked:
        monkeypatch.setitem(sys.modules, package, None)
    decoder, read = TD.jpeg_reader()
    assert decoder == name
    path = os.path.join(mp_data, DIRS[0], "00003.jpg")
    rgb, grey = read(path, 3), read(os.path.join(mp_data, DIRS[4], "00003.jpg"), 1)
    assert rgb.shape == (256, 256, 3) and grey.shape == (256, 256)
    assert np.abs(rgb.astype(int) - JN.decode_jpeg(path, 256, 256, 3)).max() <= 4
    TD.build_cache(mp_data, str(tmp_path / "c"), limit=2)
    assert TD.CelebAHQRelightingData(str(tmp_path / "c")).num_samples == 2
    small = tmp_path / "small.jpg"
    small.write_bytes(JN.encode_jpeg(np.zeros((64, 64, 3), np.uint8)))
    with pytest.raises(ValueError, match="did not decode"):
        read(str(small), 3)


def test_without_any_jpeg_decoder_it_raises(mp_data, tmp_path, monkeypatch):
    monkeypatch.setattr(TN, "has_native_jpeg", lambda: False)
    for package in ("cv2", "PIL"):
        monkeypatch.setitem(sys.modules, package, None)
    with pytest.raises(RuntimeError, match="no JPEG decoder"):
        TD.build_cache(mp_data, str(tmp_path / "c"))
