"""Zstandard frames through the system's libzstd, by ctypes.

    decompress(data, size=None) -> bytes
    compress(data, level=1) -> bytes

The orbax checkpoints of the JAX package compress their OCDBT manifests and
B-tree nodes and every zarr chunk with zstd. libzstd is in Debian's and
Ubuntu's required set (`libzstd.so.1`); where it is absent the first call
raises an error that names it. A zarr chunk's frame carries no content size,
so `decompress` takes the size the caller knows (from the zarr metadata);
an OCDBT node's frame may carry none either (tensorstore compresses larger
nodes as a stream), and without a size from anywhere the frame is streamed
(`ZSTD_decompressStream`).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Optional

# ZSTD_getFrameContentSize's answers that are not a size.
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_STREAM_CHUNK = 1 << 20


class ZstdError(RuntimeError):
    """libzstd is missing, or it refused a frame."""


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The system's libzstd (`libzstd.so.1`), its functions typed; raises ZstdError without it."""
    names = ["libzstd.so.1"]
    found = ctypes.util.find_library("zstd")
    if found and found not in names:
        names.append(found)
    errors = []
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError as e:
            errors.append(f"{name}: {e}")
    else:
        raise ZstdError("the zstd library libzstd.so.1 is not on this machine (orbax checkpoints compress every "
                        "node and chunk with zstd; install libzstd1): " + "; ".join(errors))
    size_t, vp = ctypes.c_size_t, ctypes.c_void_p
    for fn, res, args in (
        ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
        ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
        ("ZSTD_compressBound", size_t, [size_t]),
        ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
        ("ZSTD_isError", ctypes.c_uint, [size_t]),
        ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
        ("ZSTD_createDStream", vp, []),
        ("ZSTD_freeDStream", size_t, [vp]),
        ("ZSTD_initDStream", size_t, [vp]),
        ("ZSTD_decompressStream", size_t, [vp, ctypes.POINTER(_OutBuffer), ctypes.POINTER(_InBuffer)]),
        ("ZSTD_versionNumber", ctypes.c_uint, []),
    ):
        f = getattr(lib, fn)
        f.restype, f.argtypes = res, args
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ZstdError(f"{what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def version() -> str:
    """libzstd's version, e.g. '1.5.4'."""
    n = library().ZSTD_versionNumber()
    return f"{n // 10000}.{n // 100 % 100}.{n % 100}"


def decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """The content of one zstd frame. `size` is the content's length where the
    caller knows it (checked); else the frame's own, else the frame is streamed."""
    lib = library()
    data = bytes(data)
    if size is None:
        declared = lib.ZSTD_getFrameContentSize(data, len(data))
        if declared == _CONTENTSIZE_ERROR:
            raise ZstdError("not a zstd frame")
        if declared == _CONTENTSIZE_UNKNOWN:
            return _stream(lib, data)
        size = int(declared)
    out = ctypes.create_string_buffer(max(size, 1))
    n = _check(lib, lib.ZSTD_decompress(out, size, data, len(data)), "ZSTD_decompress")
    if n != size:
        raise ZstdError(f"ZSTD_decompress gave {n} bytes where {size} were expected")
    return out.raw[:size]


def _stream(lib, data: bytes) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise ZstdError("ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "ZSTD_initDStream")
        src = ctypes.create_string_buffer(data, len(data))  # referenced until the loop ends
        inbuf = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        chunk = ctypes.create_string_buffer(_STREAM_CHUNK)
        parts = []
        while True:
            outbuf = _OutBuffer(ctypes.cast(chunk, ctypes.c_void_p), _STREAM_CHUNK, 0)
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(outbuf), ctypes.byref(inbuf)),
                          "ZSTD_decompressStream")
            parts.append(chunk.raw[:outbuf.pos])
            if left == 0:  # the frame is complete
                break
            if inbuf.pos == inbuf.size and outbuf.pos < outbuf.size:
                raise ZstdError("the zstd frame is truncated")
        if inbuf.pos != inbuf.size:
            raise ZstdError(f"{inbuf.size - inbuf.pos} bytes follow the zstd frame")
        return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(stream)


def compress(data: bytes, level: int = 1) -> bytes:
    """One zstd frame of `data` at `level` (its content size in the header)."""
    lib = library()
    data = bytes(data)
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = _check(lib, lib.ZSTD_compress(out, cap, data, len(data), level), "ZSTD_compress")
    return out.raw[:n]
