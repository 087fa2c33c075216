"""The port's native loader (geomconsistentfr_torch/csrc/dataloader.cc) against the JAX package's.

Both link the same libjpeg here, so the codec's bytes are equal, not close:
  * decode_jpeg / decode_jpegs (RGB and grey) and encode_jpeg (at several
    qualities) give JAX's native_loader's bytes, and the server's JPEG
    answer (utils/io.encode_jpeg, serve._encode_image) is those bytes;
  * NativeCelebAHQLoader serves the JAX loader's batches for the same cache
    and seed, float and raw;
  * the library is built from csrc/ into build/native/, never native/;
  * a -DGCFR_NO_JPEG build says has_native_jpeg() is False, and its codec raises.
"""

import base64
import json
from pathlib import Path

import numpy as np
import pytest

from geomconsistentfr_torch import serve as tserve
from geomconsistentfr_torch.data import native_loader as TN
from geomconsistentfr_torch.utils import io as tio
from geomconsistentfr_tpu.data import native_loader as JN
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Five RGB and three grey 256x256 JPEGs written by the JAX package's encoder."""
    root = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    paths = {3: [], 1: []}
    for channels, n in ((3, 5), (1, 3)):
        for i in range(n):
            shape = (256, 256, 3) if channels == 3 else (256, 256)
            img = rng.integers(0, 256, shape).astype(np.uint8)
            p = root / f"c{channels}_{i}.jpg"
            p.write_bytes(JN.encode_jpeg(img, quality=85))
            paths[channels].append(str(p))
    return paths


@pytest.fixture(scope="module")
def tiny_cache(tmp_path_factory):
    """A packed cache of 8 random samples in data/celebahq.py's FIELDS layout."""
    from geomconsistentfr_torch.data.celebahq import FIELDS

    cache = tmp_path_factory.mktemp("cache")
    rng = np.random.default_rng(1)
    for name, (dt, shape) in FIELDS.items():
        if dt == np.uint8:
            arr = rng.integers(0, 256, size=(8, *shape)).astype(np.uint8)
        else:
            arr = rng.normal(size=(8, *shape)).astype(np.float32)
        np.save(cache / f"{name}.npy", arr)
    (cache / "meta.json").write_text(json.dumps({"num_samples": 8}))
    return str(cache)


def test_the_library_builds_from_the_ports_source_into_build_native():
    lib = TN.build_library()
    assert lib.parent == ROOT / "build" / "native" and lib.suffix == ".so"
    assert TN.SOURCE == ROOT / "geomconsistentfr_torch" / "csrc" / "dataloader.cc"
    assert TN.has_native_jpeg()  # g++ and libjpeg are here


@pytest.mark.parametrize("channels", [3, 1])
def test_decode_jpeg_equals_jax(jpegs, channels):
    for path in jpegs[channels]:
        got, want = TN.decode_jpeg(path, 256, 256, channels), JN.decode_jpeg(path, 256, 256, channels)
        assert got.shape == want.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channels", [3, 1])
def test_decode_jpegs_equals_jax(jpegs, channels):
    got = TN.decode_jpegs(jpegs[channels], 256, 256, channels, workers=3)
    np.testing.assert_array_equal(got, JN.decode_jpegs(jpegs[channels], 256, 256, channels, workers=2))


@pytest.mark.parametrize("quality", [50, 90, 100])
@pytest.mark.parametrize("shape", [(256, 256, 3), (64, 48), (17, 31, 3)])
def test_encode_jpeg_equals_jax(shape, quality):
    img = np.random.default_rng(quality).integers(0, 256, shape).astype(np.uint8)
    assert TN.encode_jpeg(img, quality) == JN.encode_jpeg(img, quality)


def test_the_servers_jpeg_is_the_native_encoders():
    img = np.random.default_rng(5).integers(0, 256, (256, 256, 3)).astype(np.uint8)
    want = JN.encode_jpeg(img, 92)
    assert tio.encode_jpeg(img, 92) == want
    assert base64.b64decode(tserve._encode_image(img, "jpeg", 92)) == want


def test_decode_errors_name_their_code(jpegs, tmp_path):
    small = tmp_path / "small.jpg"
    small.write_bytes(TN.encode_jpeg(np.zeros((64, 64, 3), np.uint8)))
    with pytest.raises(ValueError, match="code 4"):
        TN.decode_jpeg(str(small), 256, 256, 3)
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg at all")
    with pytest.raises(ValueError, match="code 3"):
        TN.decode_jpeg(str(bad), 256, 256, 3)
    with pytest.raises(ValueError, match="code 2"):
        TN.decode_jpeg(str(tmp_path / "missing.jpg"), 256, 256, 3)
    with pytest.raises(ValueError, match="failed"):
        TN.decode_jpegs([jpegs[3][0], str(bad)], 256, 256, 3)
    with pytest.raises(ValueError, match="uint8"):
        TN.encode_jpeg(np.zeros((8, 8, 3), np.float32))


@pytest.mark.parametrize("raw", [False, True])
def test_loader_batches_equal_jax(tiny_cache, raw):
    port = TN.NativeCelebAHQLoader(tiny_cache, batch_size=2, seed=3, workers=1, raw=raw)
    ref = JN.NativeCelebAHQLoader(tiny_cache, batch_size=2, seed=3, workers=1, raw=raw)
    try:
        for _ in range(6):  # more than an epoch of 4 batches
            got = port.sample_batch(None, 2)
            want = ref.next_batch_raw() if raw else ref.next_batch()
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        with pytest.raises(RuntimeError, match="raw"):
            port.next_batch() if raw else port.next_batch_raw()
        with pytest.raises(ValueError, match="batches of 2"):
            port.sample_batch(None, 3)
    finally:
        port.close()
        ref.close()


def test_without_libjpeg_to_link_the_build_falls_back_once(monkeypatch, tmp_path):
    """Where -ljpeg does not link (the linker then removes its output), the library builds
    with -DGCFR_NO_JPEG, and the failed attempt is recorded, not repeated on every call."""
    monkeypatch.setattr(TN, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(TN, "JPEG_FLAGS", ("-lno_such_jpeg_library",))
    path = TN.build_library()
    assert path == TN._compile(TN.NO_JPEG_FLAGS) and TN.load(path).gcfr_has_jpeg() == 0
    failed = list(tmp_path.glob("*.failed"))
    assert len(failed) == 1 and "no_such_jpeg_library" in failed[0].read_text()
    monkeypatch.setattr(TN.subprocess, "run", lambda *a, **k: pytest.fail("g++ ran again"))
    assert TN.build_library() == path
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".failed", ".so"]  # no temporary left behind


def test_a_build_without_libjpeg_says_so_and_its_codec_raises(monkeypatch, jpegs):
    path = TN.build_library(jpeg=False)
    assert path != TN.build_library()  # its own file, keyed by its flags
    monkeypatch.setattr(TN, "_lib", lambda: TN.load(path))
    assert TN.has_native_jpeg() is False
    with pytest.raises(ValueError, match="code -1"):
        TN.decode_jpeg(jpegs[3][0], 256, 256, 3)
    with pytest.raises(ValueError, match="failed"):
        TN.decode_jpegs(jpegs[3][:2], 256, 256, 3)
    with pytest.raises(ValueError, match="encode failed"):
        TN.encode_jpeg(np.zeros((8, 8, 3), np.uint8))
    # The server then encodes with OpenCV or Pillow (both here): still a JPEG.
    assert tio.encode_jpeg(np.zeros((8, 8, 3), np.uint8))[:2] == b"\xff\xd8"

