"""Image I/O and the visualisation transforms of the inference outputs.

Port of geomconsistentfr_tpu/utils/io.py. The reference writes six PNGs per
relit image (test_raytracing_...py:603-608, test_..._lighting_transfer.py:
574-579) with particular visualisation transforms; these helpers reproduce
them in RGB order.

The codec is chosen per call from what imports, in the JAX module's order:
OpenCV, then imageio, then the port's own PNG codec (utils/png.py, zlib and
numpy), which is all a machine without either has. PNG is lossless, so every
path gives the same pixels. A resize (only when a file's size differs from
the one asked for) is OpenCV's where it imports, else `resize_linear` /
`resize_nearest` below: OpenCV's INTER_LINEAR (half-pixel centres) and
INTER_NEAREST in numpy. OpenCV rounds uint8 through fixed-point weights,
so there the two may differ by one level.

The readers return C-contiguous arrays, whatever layout a decoder left (a
strided tensor takes other kernels, which may round apart). No codec
package is imported at module level, and none is required.
"""

from __future__ import annotations

import io
import os

import numpy as np

from geomconsistentfr_torch.utils import png


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _imageio():
    try:
        import imageio.v2 as imageio
    except ImportError:
        return None
    return imageio


class NoJpegEncoder(RuntimeError):
    """No libjpeg in the native loader, and neither OpenCV nor Pillow imports: nothing here can write a JPEG."""


def _rgb(arr: np.ndarray) -> np.ndarray:
    """OpenCV's BGR(A) -> RGB(A), C-contiguous (the index alone can leave the
    channels outermost in memory, and a strided input takes other kernels)."""
    if arr.ndim == 3 and arr.shape[-1] >= 3:
        return np.ascontiguousarray(arr[..., [2, 1, 0] + list(range(3, arr.shape[-1]))])
    return arr


def _bgr(arr: np.ndarray) -> np.ndarray:
    return arr[..., ::-1] if arr.ndim == 3 and arr.shape[-1] == 3 else arr


def imread(path: str) -> np.ndarray:
    """Read an image file as stored: RGB(A) or grey, uint8 for 8-bit files."""
    cv2 = _cv2()
    if cv2 is not None:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is not None:
            return _rgb(arr)
    imageio = _imageio()
    if imageio is not None:
        return np.asarray(imageio.imread(path))
    with open(path, "rb") as f:
        return png.decode_png(f.read())


def decode_image(data: bytes) -> np.ndarray:
    """`imread` of encoded bytes (PNG anywhere; JPEG and others where OpenCV or imageio imports)."""
    cv2 = _cv2()
    if cv2 is not None:
        arr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
        if arr is not None:
            return _rgb(arr)
    imageio = _imageio()
    if imageio is not None:
        return np.asarray(imageio.imread(io.BytesIO(data)))
    return png.decode_png(data)


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W[, C]) as PNG bytes."""
    cv2 = _cv2()
    if cv2 is not None:
        ok, buf = cv2.imencode(".png", np.ascontiguousarray(_bgr(arr)))
        if ok:
            return buf.tobytes()
    imageio = _imageio()
    if imageio is not None:
        buf = io.BytesIO()
        imageio.imwrite(buf, arr, format="png")
        return buf.getvalue()
    return png.encode_png(arr)


def encode_jpeg(arr: np.ndarray, quality: int = 90) -> bytes:
    """uint8 (H, W[, 3]) as JPEG bytes: libjpeg through the port's native loader
    (data/native_loader.py, the JAX server's encoder) where it built with libjpeg,
    else OpenCV, else Pillow; raises NoJpegEncoder where none of them works."""
    from geomconsistentfr_torch.data import native_loader

    if native_loader.has_native_jpeg():
        return native_loader.encode_jpeg(np.asarray(arr, np.uint8), quality)
    cv2 = _cv2()
    if cv2 is not None:
        ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(_bgr(arr)), [cv2.IMWRITE_JPEG_QUALITY, int(quality)])
        if ok:
            return buf.tobytes()
    try:
        from PIL import Image
    except ImportError:
        raise NoJpegEncoder(
            "no JPEG encoder is available (no libjpeg for the native loader, and neither cv2 nor PIL imports); "
            "ask for 'format': 'png'"
        ) from None
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr)).save(buf, format="JPEG", quality=int(quality))
    return buf.getvalue()


def _linear_taps(n_src: int, n_dst: int):
    """Source indices and weights of OpenCV's INTER_LINEAR along one axis."""
    x = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    x = np.clip(x, 0.0, n_src - 1)
    i0 = np.floor(x).astype(np.int64)
    return i0, np.minimum(i0 + 1, n_src - 1), x - i0


def resize_linear(img: np.ndarray, size: int) -> np.ndarray:
    """OpenCV's cv2.resize(img, (size, size)): bilinear, half-pixel centres,
    edges clamped, in the input's dtype (uint8 rounded to nearest)."""
    y0, y1, wy = _linear_taps(img.shape[0], size)
    x0, x1, wx = _linear_taps(img.shape[1], size)
    src = np.asarray(img, np.float64)
    wy = wy.reshape((-1, 1) + (1,) * (src.ndim - 2))
    wx = wx.reshape((1, -1) + (1,) * (src.ndim - 2))
    rows = src[y0] * (1.0 - wy) + src[y1] * wy
    out = rows[:, x0] * (1.0 - wx) + rows[:, x1] * wx
    if img.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def resize_nearest(img: np.ndarray, size: int) -> np.ndarray:
    """OpenCV's INTER_NEAREST: source index floor(dst / (size / src)), clamped."""

    def index(n_src):
        return np.minimum(np.floor(np.arange(size) * (1.0 / (size / n_src))).astype(np.int64), n_src - 1)

    return img[index(img.shape[0])][:, index(img.shape[1])]


def _resize(img: np.ndarray, size: int, nearest: bool = False) -> np.ndarray:
    cv2 = _cv2()
    if cv2 is None:
        return resize_nearest(img, size) if nearest else resize_linear(img, size)
    if nearest:
        return cv2.resize(img, (size, size), interpolation=cv2.INTER_NEAREST)
    return cv2.resize(img, (size, size))


def read_image(path: str, size: int = 256) -> np.ndarray:
    """Read an image as float32 RGB in [0, 1], resized to (size, size)."""
    img = np.asarray(imread(path), dtype=np.float64) / 255.0
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if img.shape[0] != size or img.shape[1] != size:
        img = _resize(img, size)
    return np.ascontiguousarray(img, dtype=np.float32)


def as_rgb_u8(img: np.ndarray, size: int) -> np.ndarray:
    """Decoded pixels as uint8 RGB (H, W, 3), resized to (size, size)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
    if img.shape[-1] == 4:
        img = img[..., :3]
    if img.shape[0] != size or img.shape[1] != size:
        img = _resize(img, size)
    return np.ascontiguousarray(img)


def read_image_u8(path: str, size: int = 256) -> np.ndarray:
    """Read an image as uint8 RGB (H, W, 3), resized to (size, size).

    For the device pipelines (Relighter divides uint8 by 255 on the device).
    At native size the values are exactly the decoded bytes; a resize
    interpolates in uint8."""
    return as_rgb_u8(imread(path), size)


def read_mask_u8(path: str, size: int = 256) -> np.ndarray:
    """Read a face mask as uint8 (H, W) (device pipelines divide by 255)."""
    m = np.asarray(imread(path))
    if m.dtype != np.uint8:
        m = np.clip(m, 0, 255).astype(np.uint8)
    if m.ndim == 3:
        m = m[..., 0]
    if m.shape[0] != size or m.shape[1] != size:
        m = _resize(m, size, nearest=True)
    return np.ascontiguousarray(m)


def read_mask(path: str, size: int = 256) -> np.ndarray:
    """Read a face mask as float32 in [0, 1] (values / 255, reference :586)."""
    m = np.asarray(imread(path), dtype=np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    if m.shape[0] != size or m.shape[1] != size:
        m = _resize(m, size, nearest=True)
    return np.ascontiguousarray(m) / 255.0


def write_image_u8(path: str, arr: np.ndarray) -> None:
    """Write an already-quantized uint8 image (H, W[, C]) as a PNG."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    cv2 = _cv2()
    if cv2 is not None and cv2.imwrite(path, np.ascontiguousarray(_bgr(arr))):
        return
    imageio = _imageio()
    if imageio is not None:
        imageio.imwrite(path, arr)
        return
    if not path.lower().endswith(".png"):
        raise ValueError(f"without OpenCV or imageio only PNG files can be written, not {path!r}")
    with open(path, "wb") as f:
        f.write(png.encode_png(arr))


def write_image(path: str, img01: np.ndarray) -> None:
    """Write a float image in [0, 1] (H, W[, C]) as an 8-bit PNG: clip(x * 255), truncated."""
    arr = np.clip(np.asarray(img01, np.float32) * 255.0, 0.0, 255.0).astype(np.uint8)
    write_image_u8(path, arr)


def composite_into_original(original: np.ndarray, rendered: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Paste the relit face into the original image through the mask.

    Reference semantics (test_relight_single_image.py:618-619): where the mask
    is nonzero the output is `rendered * mask` (fractional masks attenuate).
    """
    mask3 = np.repeat(mask[..., None], 3, axis=-1)
    return np.where(mask3 > 0, rendered * mask3, original)


def depth_visualization(depth: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """-depth min-max normalised, masked (reference :594-597, :577)."""
    d = -np.asarray(depth, np.float64)
    d = (d - d.min()) / max(d.max() - d.min(), 1e-12)
    return d * mask


def normals_visualization(normals: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """(n + 1) / 2, masked (reference :599-601, :579)."""
    return (np.asarray(normals) + 1.0) / 2.0 * mask[..., None]


def save_visual_pack(out_dir: str, stem: str, pack_u8: np.ndarray) -> dict:
    """Write the six per-image PNGs from a packed uint8 (H, W, 12) array.

    The counterpart of `save_render_outputs` for the device-quantized path
    (`infer.pack_visuals`); the channel layout is `infer.VISUAL_PACK_LAYOUT`.
    """
    from geomconsistentfr_torch.infer import VISUAL_PACK_LAYOUT

    paths = {}
    c = 0
    for kind, width in VISUAL_PACK_LAYOUT:
        img = pack_u8[..., c : c + width]
        if width == 1:
            img = img[..., 0]
        path = os.path.join(out_dir, f"{stem}_{kind}.png")
        write_image_u8(path, img)
        paths[kind] = path
        c += width
    return paths


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def save_render_outputs(out_dir: str, stem: str, outputs, mask: np.ndarray) -> dict:
    """Write the reference's six per-image outputs; returns {kind: path}.

    `outputs` is a RenderOutputs (tensors on any device, or arrays) with a
    leading batch axis of 1, or none.
    """

    def first(x):
        x = _host(x)
        return x[0] if x.ndim and x.shape[0] == 1 and x.ndim > 2 else x

    rendered = first(outputs.rendered)
    albedo = first(outputs.albedo)
    depth = first(outputs.depth)
    shading = first(outputs.final_shading)
    weights = first(outputs.shadow_mask_weights)
    normals = first(outputs.surface_normals)

    mask = np.asarray(_host(mask), np.float32)
    mask3 = mask[..., None]
    paths = {}

    def emit(kind, img):
        path = os.path.join(out_dir, f"{stem}_{kind}.png")
        write_image(path, img)
        paths[kind] = path

    emit("rendered_image", rendered * mask3)
    emit("shadow_mask", weights * mask)
    emit("albedo", albedo * mask3)
    emit("depth", depth_visualization(depth, mask))
    emit("shading", shading * mask)
    emit("surface_normals", normals_visualization(normals, mask))
    return paths
