"""The port's host helpers against the JAX package's, on the CPU.

  * utils/png.py: round trips for colour types 0, 2, 4 and 6; files written
    by OpenCV (compression 0 and 9), Pillow (optimize=True, palettes of 1-8
    bits among them) and imageio, so that all five row filters occur, and
    1, 2 and 4-bit grey, decode to exactly OpenCV's bytes; 16-bit,
    interlaced and corrupt files raise, and image data that inflates past
    its size is refused without inflating it all.
  * utils/io.py: every reader equals JAX's bit for bit on the goldens (as
    PNG) and on random images, at native size and resized; with OpenCV,
    imageio and Pillow blocked, the port's own codec gives the same pixels
    and its numpy resize stays within the stated bars of OpenCV's (float
    images 1e-6, uint8 one level, masks exact); the visual pack and the
    render outputs decode to JAX's pixels.
  * lighting_presets, postprocess.fix_border_artifacts: bit-equal.
  * metrics.image_metrics: within 1e-12 of JAX's.
  * config.to_dict / from_dict / load_config: the same dicts as JAX's.
"""

import dataclasses
import io
import json
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from geomconsistentfr_torch import config as TC
from geomconsistentfr_torch import lighting_presets as TL
from geomconsistentfr_torch import postprocess as TP
from geomconsistentfr_torch.data import native_loader
from geomconsistentfr_torch.metrics import image_metrics as TM
from geomconsistentfr_torch.render import RenderOutputs
from geomconsistentfr_torch.utils import io as TIO
from geomconsistentfr_torch.utils.png import decode_png, encode_png
from geomconsistentfr_tpu import config as JC
from geomconsistentfr_tpu import lighting_presets as JL
from geomconsistentfr_tpu import postprocess as JP
from geomconsistentfr_tpu.metrics import image_metrics as JM
from geomconsistentfr_tpu.utils import io as JIO
from torch_cpu_threads import one_warm_intra_op_thread  # noqa: F401 (autouse fixture)

GOLDEN = Path(__file__).resolve().parent / "golden"
CODEC_PACKAGES = ("cv2", "imageio", "imageio.v2", "PIL", "PIL.Image")
METRIC_TOL = 1e-12


def block_codecs(monkeypatch):
    """Make `import cv2`, `import imageio` and `import PIL` raise, as on a machine without them."""
    for name in CODEC_PACKAGES:
        monkeypatch.setitem(sys.modules, name, None)


def cv2_decode(data: bytes) -> np.ndarray:
    import cv2

    arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if arr.ndim == 3 and arr.shape[-1] >= 3:
        arr = arr[..., [2, 1, 0] + list(range(3, arr.shape[-1]))]
    return arr


def row_filters(data: bytes) -> set:
    pos, idat, header = 8, b"", None
    while pos < len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        header = body if kind == b"IHDR" else header
        idat += body if kind == b"IDAT" else b""
        pos += 12 + length
    w, h, depth, colour = struct.unpack(">IIBB", header[:10])
    stride = (w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[colour] * depth + 7) // 8
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, stride + 1)
    return set(raw[:, 0].tolist())


def golden_u8(name="ref_transfer_00104.npz"):
    fx = np.load(GOLDEN / name)
    return (fx["image"] * 255).astype(np.uint8), (fx["mask"] * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# utils/png.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_round_trip(channels):
    rng = np.random.default_rng(channels)
    a = rng.integers(0, 256, (33, 47, channels)).astype(np.uint8)
    if channels == 1:
        a = a[..., 0]
    data = encode_png(a)
    want = cv2_decode(data)  # grey+alpha: OpenCV gives RGBA, the grey repeated
    got = decode_png(data)
    assert np.array_equal(got, want)
    if channels == 2:
        assert np.array_equal(got[..., [0, 3]], a)
    else:
        assert np.array_equal(got, a)


FOREIGN = sorted(
    [f"{enc}-{name}" for enc in ("cv2-0", "cv2-9", "pil", "imageio") for name in ("face", "mask", "noise")]
    + ["pil-palette", "pil-grey-alpha", "pil-rgba", "pil-palette-trns"]
)


def foreign_files():
    """The golden face, its mask and noise, written by four encoders and five settings."""
    import cv2
    import imageio.v2 as imageio
    from PIL import Image

    img, mask = golden_u8()
    rng = np.random.default_rng(5)
    noise = rng.integers(0, 256, (48, 40, 3)).astype(np.uint8)
    files = {}
    for name, arr in (("face", img), ("mask", mask), ("noise", noise)):
        bgr = arr[..., ::-1] if arr.ndim == 3 else arr
        for level in (0, 9):
            files[f"cv2-{level}-{name}"] = cv2.imencode(".png", np.ascontiguousarray(bgr),
                                                        [cv2.IMWRITE_PNG_COMPRESSION, level])[1].tobytes()
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="png", optimize=True)
        files[f"pil-{name}"] = buf.getvalue()
        buf = io.BytesIO()
        imageio.imwrite(buf, arr, format="png")
        files[f"imageio-{name}"] = buf.getvalue()
    for name, mode in (("palette", "P"), ("grey-alpha", "LA"), ("rgba", "RGBA")):
        buf = io.BytesIO()
        pil = Image.fromarray(img)
        pil = pil.quantize(64) if mode == "P" else pil.convert(mode)
        pil.save(buf, format="png")
        files[f"pil-{name}"] = buf.getvalue()
    buf = io.BytesIO()
    Image.fromarray(img).quantize(16).save(buf, format="png", transparency=3)
    files["pil-palette-trns"] = buf.getvalue()
    return files


@pytest.fixture(scope="module")
def foreign():
    files = foreign_files()
    assert sorted(files) == FOREIGN
    return files


def test_foreign_files_use_every_row_filter(foreign):
    used = set().union(*(row_filters(data) for data in foreign.values()))
    assert used == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", FOREIGN)
def test_png_decodes_what_opencv_decodes(foreign, name):
    data = foreign[name]
    assert np.array_equal(decode_png(data), cv2_decode(data))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_png_decodes_sub_byte_grey(depth):
    """1, 2 and 4-bit grey (built here: no encoder at hand writes them), Up-filtered rows."""
    from geomconsistentfr_torch.utils.png import SIGNATURE, _chunk

    h, w = 11, 21
    v = np.random.default_rng(depth).integers(0, 2 ** depth, (h, w)).astype(np.uint8)
    per = 8 // depth
    padded = np.zeros((h, -(-w // per) * per), np.uint8)
    padded[:, :w] = v
    packed = np.packbits(((padded[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1).astype(np.uint8),
                         axis=1)
    up = packed - np.vstack([np.zeros((1, packed.shape[1]), np.uint8), packed[:-1]])
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)
    data = (SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))
    got = decode_png(data)
    assert np.array_equal(got, cv2_decode(data))
    assert np.array_equal(got, v * np.uint8(255 // (2 ** depth - 1)))


def test_png_refuses_16_bit_interlaced_and_corrupt():
    import cv2

    deep = cv2.imencode(".png", np.full((8, 8), 40000, np.uint16))[1].tobytes()
    with pytest.raises(ValueError, match="16-bit"):
        decode_png(deep)
    data = bytearray(encode_png(np.zeros((8, 8, 3), np.uint8)))
    ihdr = bytes(data[12:29])  # IHDR's type and body
    laced = ihdr[:-1] + b"\x01"
    data[12:29] = laced
    data[29:33] = struct.pack(">I", zlib.crc32(laced))
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(bytes(data))
    data[20] ^= 1  # the width, with the CRC left as it was
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0 a JPEG")
    from geomconsistentfr_torch.utils.png import SIGNATURE, _chunk

    header = _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 0, 0, 0, 0))
    for body in (bytes(10_000_000), bytes(10)):  # a 4x4 grey image holds 20 bytes: inflating stops past them
        with pytest.raises(ValueError, match="does not hold the 20 bytes"):
            decode_png(SIGNATURE + header + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# utils/io.py
# ---------------------------------------------------------------------------

READERS = ("read_image", "read_image_u8", "read_mask", "read_mask_u8")


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """PNGs of the goldens (native 256) and of random images at 256, 300 and 200, RGB, RGBA and grey."""
    import imageio.v2 as imageio

    root = tmp_path_factory.mktemp("images")
    files = {}
    for name in ("ref_transfer_00104.npz", "ref_target_00295.npz"):
        img, mask = golden_u8(name)
        for kind, arr in (("image", img), ("mask", mask)):
            files[f"{name[:-4]}-{kind}"] = p = str(root / f"{name[:-4]}_{kind}.png")
            imageio.imwrite(p, arr)
    rng = np.random.default_rng(11)
    for size in (256, 300, 200):
        for kind, shape in (("rgb", (size, size, 3)), ("rgba", (size, size, 4)), ("grey", (size, size))):
            files[f"random-{size}-{kind}"] = p = str(root / f"random_{size}_{kind}.png")
            imageio.imwrite(p, rng.integers(0, 256, shape).astype(np.uint8))
    return files


@pytest.mark.parametrize("reader", READERS)
def test_readers_equal_jax(image_files, reader):
    for name, path in image_files.items():
        got = getattr(TIO, reader)(path, 256)
        want = getattr(JIO, reader)(path, 256)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


@pytest.mark.parametrize("reader", READERS)
def test_readers_without_codec_packages(image_files, reader, monkeypatch):
    """On a machine without OpenCV, imageio or Pillow the port's own PNG
    codec gives JAX's pixels, and its numpy resize the stated bars."""
    want = {name: getattr(JIO, reader)(path, 256) for name, path in image_files.items()}
    block_codecs(monkeypatch)
    for name, path in image_files.items():
        got = getattr(TIO, reader)(path, 256)
        assert got.dtype == want[name].dtype and got.shape == want[name].shape, name
        if "random-256" in name or "ref_" in name or reader.startswith("read_mask"):
            assert np.array_equal(got, want[name]), name  # native size, or nearest: exact
        elif reader == "read_image_u8":
            assert np.abs(got.astype(np.int16) - want[name]).max() <= 1, name
        else:
            assert np.abs(got - want[name]).max() <= 1e-6, name


@pytest.mark.parametrize("src", [(300, 300), (100, 100), (512, 512), (64, 80), (257, 255), (37, 53)])
@pytest.mark.parametrize("size", [256, 64])
def test_numpy_resize_against_opencv(src, size):
    import cv2

    rng = np.random.default_rng(src[0] * 7 + size)
    f = rng.uniform(size=(*src, 3))
    u = rng.integers(0, 256, (*src, 3)).astype(np.uint8)
    m = rng.integers(0, 256, src).astype(np.uint8)
    assert np.abs(TIO.resize_linear(f, size) - cv2.resize(f, (size, size))).max() <= 1e-6
    assert np.abs(TIO.resize_linear(u, size).astype(np.int16) - cv2.resize(u, (size, size))).max() <= 1
    for mask in (m, m.astype(np.float32)):
        want = cv2.resize(mask, (size, size), interpolation=cv2.INTER_NEAREST)
        assert np.array_equal(TIO.resize_nearest(mask, size), want)


def random_pack(seed=3, size=64):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 12)).astype(np.uint8)


@pytest.mark.parametrize("blocked", [False, True], ids=["codecs", "own-png"])
def test_save_visual_pack_equals_jax(tmp_path, blocked, monkeypatch):
    pack = random_pack()
    want = JIO.save_visual_pack(str(tmp_path / "jax"), "x", pack)
    want = {k: JIO._imread(p) for k, p in want.items()}
    if blocked:
        block_codecs(monkeypatch)
    got = TIO.save_visual_pack(str(tmp_path / "port"), "x", pack)
    assert sorted(got) == sorted(want)
    for kind, path in got.items():
        assert np.array_equal(TIO.imread(path), want[kind]), kind


def test_save_render_outputs_equals_jax(tmp_path):
    rng = np.random.default_rng(4)
    h = w = 48
    arrays = dict(
        rendered=rng.uniform(size=(1, h, w, 3)), albedo=rng.uniform(size=(1, h, w, 3)),
        depth=rng.normal(size=(1, h, w)), final_shading=rng.uniform(size=(1, h, w)),
        shadow_mask_weights=rng.uniform(size=(1, h, w)), surface_normals=rng.uniform(-1, 1, (1, h, w, 3)),
    )
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    mask = (rng.uniform(size=(h, w)) > 0.3).astype(np.float32)
    fields = {f: torch.zeros(1) for f in RenderOutputs._fields}
    outputs = RenderOutputs(**{**fields, **{k: torch.from_numpy(v) for k, v in arrays.items()}})
    want = JIO.save_render_outputs(str(tmp_path / "jax"), "x", type("O", (), arrays), mask)
    got = TIO.save_render_outputs(str(tmp_path / "port"), "x", outputs, torch.from_numpy(mask))
    assert sorted(got) == sorted(want)
    for kind, path in got.items():
        assert np.array_equal(TIO.imread(path), JIO._imread(want[kind])), kind


def test_visualisation_transforms_equal_jax():
    rng = np.random.default_rng(6)
    depth, mask = rng.normal(size=(32, 32)), (rng.uniform(size=(32, 32)) > 0.5).astype(np.float32)
    normals, img = rng.uniform(-1, 1, (32, 32, 3)), rng.uniform(size=(32, 32, 3))
    assert np.array_equal(TIO.depth_visualization(depth, mask), JIO.depth_visualization(depth, mask))
    assert np.array_equal(TIO.normals_visualization(normals, mask), JIO.normals_visualization(normals, mask))
    rendered = rng.uniform(size=(32, 32, 3))
    assert np.array_equal(TIO.composite_into_original(img, rendered, mask),
                          JIO.composite_into_original(img, rendered, mask))


@pytest.mark.parametrize("blocked", [False, True], ids=["codecs", "own-png"])
def test_write_image_truncates_as_jax(tmp_path, blocked, monkeypatch):
    img = np.random.default_rng(8).uniform(-0.1, 1.1, (40, 24, 3)).astype(np.float32)
    JIO.write_image(str(tmp_path / "jax.png"), img)
    want = JIO._imread(str(tmp_path / "jax.png"))
    if blocked:
        block_codecs(monkeypatch)
    TIO.write_image(str(tmp_path / "port.png"), img)
    assert np.array_equal(TIO.imread(str(tmp_path / "port.png")), want)
    assert np.array_equal(want, np.clip(img * 255.0, 0, 255).astype(np.uint8))  # truncated, not rounded


def test_jpeg_encoder_is_named_when_missing(monkeypatch):
    img = np.zeros((16, 16, 3), np.uint8)
    assert TIO.encode_jpeg(img)[:2] == b"\xff\xd8"
    block_codecs(monkeypatch)
    assert TIO.encode_jpeg(img)[:2] == b"\xff\xd8"  # libjpeg, through the port's native loader
    monkeypatch.setattr(native_loader, "has_native_jpeg", lambda: False)
    with pytest.raises(TIO.NoJpegEncoder, match="no JPEG encoder"):
        TIO.encode_jpeg(img)


# ---------------------------------------------------------------------------
# lighting presets, postprocess, metrics, config serialisation
# ---------------------------------------------------------------------------


def test_lighting_presets_equal_jax():
    assert TL.LIGHT_PRESETS == JL.LIGHT_PRESETS
    assert list(TL.LIGHT_PRESETS) == list(JL.LIGHT_PRESETS)
    assert TL.DEFAULT_AMBIENT == JL.DEFAULT_AMBIENT
    assert TL.MULTIPIE_FLASH_ORDER == JL.MULTIPIE_FLASH_ORDER
    assert TL.GOLDEN_FFHQ_PRESETS == JL.GOLDEN_FFHQ_PRESETS
    for az, el in ((0, 0), (30, -20), (-60, 45), (123.5, 7.25)):
        assert TL.azimuth_elevation(az, el) == JL.azimuth_elevation(az, el)


@pytest.mark.parametrize("name", ["multipie_14", "A-60E-20", "multipie_07"])
@pytest.mark.parametrize("clamp", [False, True])
def test_lighting_sphere_equals_jax(name, clamp):
    d = TL.LIGHT_PRESETS[name]
    kw = dict(size=96, clamp=clamp)
    assert np.array_equal(TL.lighting_sphere(d, **kw), JL.lighting_sphere(d, **kw))


@pytest.mark.parametrize("case", ["float", "uint8", "golden"])
def test_fix_border_artifacts_equals_jax(case):
    rng = np.random.default_rng(9)
    if case == "golden":
        fx = np.load(GOLDEN / "ref_transfer_00104.npz")
        img, mask = fx["image"], fx["mask"]
    else:
        img = rng.uniform(size=(64, 64, 3))
        img = (img * 255).astype(np.uint8) if case == "uint8" else img
        yy, xx = np.mgrid[:64, :64]
        mask = (((xx - 32) / 20.0) ** 2 + ((yy - 30) / 24.0) ** 2 <= 1.0) * rng.uniform(0.4, 1.0, (64, 64))
    got, want = TP.fix_border_artifacts(img, mask), JP.fix_border_artifacts(img, mask)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_image_metrics_equal_jax(seed):
    rng = np.random.default_rng(seed)
    pred, gt = rng.uniform(size=(2, 40, 36, 3))
    mask = (rng.uniform(size=(40, 36)) > 0.4) * rng.uniform(size=(40, 36))
    assert abs(TM.psnr(pred, gt) - JM.psnr(pred, gt)) <= METRIC_TOL
    assert abs(TM.masked_mse(pred, gt, mask) - JM.masked_mse(pred, gt, mask)) <= METRIC_TOL
    assert abs(TM.masked_dssim_matlab(pred, gt, mask) - JM.masked_dssim_matlab(pred, gt, mask)) <= METRIC_TOL
    assert np.abs(TM.matlab_ssim_map(pred, gt) - JM.matlab_ssim_map(pred, gt)).max() <= METRIC_TOL
    with pytest.raises(ValueError, match="mask is empty"):
        TM.masked_mse(pred, gt, np.zeros((40, 36)))


@pytest.mark.parametrize("preset", sorted(JC.PRESETS))
def test_config_serialisation_equals_jax(preset, tmp_path):
    d = TC.to_dict(TC.PRESETS[preset]())
    assert d == JC.to_dict(JC.PRESETS[preset]())
    assert TC.from_dict(d) == TC.PRESETS[preset]()
    assert TC.to_dict(TC.from_dict(json.loads(json.dumps(d)))) == d  # tuples come back from JSON lists
    partial = {"render": {"img_height": 128, "img_width": 128, "num_sample_points": 40}, "model": {"variant": "target"}}
    path = tmp_path / "partial.json"
    path.write_text(json.dumps(partial))
    assert TC.to_dict(TC.load_config(str(path), preset=preset)) == JC.to_dict(JC.load_config(str(path), preset=preset))
    assert TC.to_dict(TC.load_config(str(path))) == JC.to_dict(JC.load_config(str(path)))
    with pytest.raises(KeyError, match="RenderConfig.no_such_field"):
        TC.from_dict({"render": {"no_such_field": 1}})
    assert dataclasses.asdict(TC.from_dict({})) == JC.to_dict(JC.from_dict({}))
