"""A PNG reader and writer on the standard library's zlib and numpy alone.

The port's last resort for image files and request bodies where neither
OpenCV nor imageio imports (utils/io.py tries those first). PNG is lossless,
so the pixels it decodes are the bytes any other decoder gives.

  * `encode_png`: 8-bit, non-interlaced, grey, grey+alpha, RGB or RGBA (by
    the channel count), every row with filter 1 (Sub), one zlib stream.
  * `decode_png`: non-interlaced, 8-bit colour types 0, 2, 3 (palette), 4
    and 6 (and 1, 2 or 4-bit grey and palette, which Pillow's optimize
    writes for masks), all five row filters, the chunk CRCs checked; its
    pixels are OpenCV's (grey+alpha and a palette with transparency become
    RGBA). Anything else (16-bit, Adam7 interlacing, an unknown critical
    chunk) raises a ValueError that names what it met.

Sub and Up are vectorised over the row (Sub is a running sum mod 256 per
channel). Average and Paeth are not: each byte depends on its reconstructed
left neighbour through a floor or a selection, which no prefix sum
expresses, so they run along the row in Python integers.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel
_COLOUR_OF = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> colour type
# zlib level 1, OpenCV's default too: on a 256x256 RGB face, level 6 takes
# 2.6x the time for 2% fewer bytes.
_LEVEL = 1


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png(arr: np.ndarray) -> bytes:
    """uint8 (H, W) or (H, W, C), C in 1-4, as PNG bytes."""
    a = np.asarray(arr)
    if a.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 pixels, got {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOUR_OF or 0 in a.shape:
        raise ValueError(f"encode_png takes (H, W) or (H, W, 1-4) pixels, got shape {a.shape}")
    h, w, ch = a.shape
    rows = np.ascontiguousarray(a).reshape(h, w * ch)
    raw = np.empty((h, 1 + w * ch), np.uint8)
    raw[:, 0] = 1  # Sub: each byte minus the one a pixel to its left, mod 256
    raw[:, 1:] = rows
    raw[:, 1 + ch :] -= rows[:, :-ch]
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_OF[ch], 0, 0, 0)
    idat = zlib.compress(raw.tobytes(), _LEVEL)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", idat) + _chunk(b"IEND", b"")


def _chunks(data: bytes):
    """(kind, body) of each chunk, CRC checked, up to and including IEND."""
    pos = len(SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG: no IEND chunk")
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"truncated PNG: chunk {kind!r} runs past the end")
        body = data[pos + 8 : end]
        if zlib.crc32(kind + body) != struct.unpack(">I", data[end : end + 4])[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4


def _average(f: bytes, b: bytes, ch: int) -> bytearray:
    r = bytearray(len(f))
    for i in range(ch):
        r[i] = (f[i] + (b[i] >> 1)) & 255
    for i in range(ch, len(f)):
        r[i] = (f[i] + ((r[i - ch] + b[i]) >> 1)) & 255
    return r


def _paeth(f: bytes, b: bytes, ch: int) -> bytearray:
    r = bytearray(len(f))
    for i in range(ch):  # a = c = 0: the predictor is b
        r[i] = (f[i] + b[i]) & 255
    for i in range(ch, len(f)):
        a, up, c = r[i - ch], b[i], b[i - ch]
        pa, pb, pc = abs(up - c), abs(a - c), abs(a + up - 2 * c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = up
        else:
            pred = c
        r[i] = (f[i] + pred) & 255
    return r


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 pixels in RGB order, as OpenCV's IMREAD_UNCHANGED gives them.

    Grey is (H, W); RGB and palette (H, W, 3); RGBA, grey+alpha (the grey
    repeated) and palette with a tRNS chunk (H, W, 4).
    """
    data = bytes(data)
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG file (bad signature)")
    header = palette = alpha = None
    idat = []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = body
        elif kind == b"PLTE":
            palette = body
        elif kind == b"tRNS":
            alpha = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind != b"IEND" and kind[:1].isupper():
            raise ValueError(f"unsupported critical PNG chunk {kind!r}")
    if header is None or len(header) != 13:
        raise ValueError("PNG without a valid IHDR chunk")
    w, h, depth, colour, method, filter_method, interlace = struct.unpack(">IIBBBBB", header)
    if colour not in _CHANNELS:
        raise ValueError(f"invalid PNG colour type {colour}")
    if depth != 8 and not (colour in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{depth}-bit PNG of colour type {colour} is not supported "
                         "(8-bit, or 1, 2 or 4-bit grey or palette)")
    if interlace:
        raise ValueError("interlaced (Adam7) PNG is not supported")
    if method or filter_method:
        raise ValueError(f"unknown PNG compression {method} or filter method {filter_method}")
    ch = _CHANNELS[colour] if depth == 8 else 1  # bytes a pixel for the filters (at least one)
    stride = (w * _CHANNELS[colour] * depth + 7) // 8
    expected = h * (stride + 1)
    inflate = zlib.decompressobj()  # bounded: a stream that inflates past the image is refused, not inflated
    raw = inflate.decompress(b"".join(idat), expected + 1)
    if len(raw) != expected or inflate.unconsumed_tail:
        raise ValueError(f"PNG image data does not hold the {expected} bytes of a {w}x{h} image")
    raw = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = raw[y, 0], raw[y, 1:]
        if kind == 0:
            out[y] = f
        elif kind == 1:
            out[y] = np.cumsum(f.reshape(-1, ch), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:
            out[y] = f + prev
        elif kind == 3:
            out[y] = np.frombuffer(_average(f.tobytes(), prev.tobytes(), ch), np.uint8)
        elif kind == 4:
            out[y] = np.frombuffer(_paeth(f.tobytes(), prev.tobytes(), ch), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind} in row {y}")
        prev = out[y]
    if depth < 8:  # pixels packed from the high bits; grey is scaled to 0-255 as libpng does
        bits = np.unpackbits(out, axis=1).reshape(h, -1, depth)[:, :w]
        out = (bits << np.arange(depth - 1, -1, -1, dtype=np.uint8)).sum(axis=-1, dtype=np.uint8)
        if colour == 0:
            out *= np.uint8(255 // (2 ** depth - 1))
    if colour == 3:
        if palette is None or len(palette) % 3:
            raise ValueError("palette PNG without a valid PLTE chunk")
        table = np.frombuffer(palette, np.uint8).reshape(-1, 3)
        if alpha is not None:
            a = np.full((len(table), 1), 255, np.uint8)
            a[: len(alpha), 0] = np.frombuffer(alpha, np.uint8)[: len(table)]
            table = np.concatenate([table, a], axis=1)
        if int(out.max(initial=0)) >= len(table):
            raise ValueError("palette PNG indexes past its palette")
        return table[out.reshape(h, w)]
    if colour == 4:  # grey+alpha expands to RGBA, as OpenCV decodes it
        return out.reshape(h, w, 2)[..., [0, 0, 0, 1]]
    return out.reshape(h, w) if ch == 1 else out.reshape(h, w, ch)
