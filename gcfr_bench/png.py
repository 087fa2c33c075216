"""A minimal PNG writer and reader (zlib and numpy) for the serving cell's requests and replies.

`encode` writes 8-bit, non-interlaced grey, RGB or RGBA with every row under
filter 0, one zlib stream. `decode` reads 8-bit, non-interlaced colour types
0, 2, 4 and 6 under all five row filters (Sub and Up vectorised; Average and
Paeth run along the row, each byte needing its reconstructed left neighbour).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
COLOUR = {1: 0, 3: 2, 2: 4, 4: 6}


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * ch)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, COLOUR[ch], 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) \
        + _chunk(b"IEND", b"")


def decode(data: bytes) -> np.ndarray:
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    at, idat, header = 8, [], None
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        kind, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        at += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or interlace or colour not in CHANNELS:
        raise ValueError(f"unsupported PNG: depth {depth}, colour {colour}, interlace {interlace}")
    ch = CHANNELS[colour]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, f = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = f.copy()
        elif kind == 1:
            row = np.cumsum(f.reshape(w, ch).astype(np.int64), axis=0).astype(np.uint8).reshape(stride)
        elif kind == 2:
            row = f + prev
        elif kind in (3, 4):
            row = bytearray(stride)
            fb, pb = f.tolist(), prev.tolist()
            for x in range(stride):
                a = row[x - ch] if x >= ch else 0
                b = pb[x]
                if kind == 3:
                    row[x] = (fb[x] + ((a + b) >> 1)) & 255
                else:
                    c = pb[x - ch] if x >= ch else 0
                    p = a + b - c
                    pa, pbb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pbb and pa <= pc else (b if pbb <= pc else c)
                    row[x] = (fb[x] + pred) & 255
            row = np.frombuffer(bytes(row), np.uint8)
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = row
        prev = out[y]
    return out.reshape(h, w, ch) if ch > 1 else out.reshape(h, w)
