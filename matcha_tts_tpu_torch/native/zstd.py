"""Zstandard decompression through the system's libzstd (ctypes).

The Orbax reader (`params/orbax.py`) needs it for OCDBT nodes and zarr
chunks.  The library is `ctypes.util.find_library("zstd")`, else
`libzstd.so.1`; without it `decompress` raises an error that names it (there
is no decoder of our own to fall back on).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_lib: Optional[ctypes.CDLL] = None

# ZSTD_getFrameContentSize's two sentinels: (0ULL - 1) and (0ULL - 2)
_CONTENTSIZE_UNKNOWN = 2**64 - 1
_CONTENTSIZE_ERROR = 2**64 - 2


class _Buffer(ctypes.Structure):
    """ZSTD_inBuffer / ZSTD_outBuffer: {pointer, size, pos}."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def library_name() -> str:
    return ctypes.util.find_library("zstd") or "libzstd.so.1"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        name = library_name()
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise OSError(f"the zstd library ({name}) is not available: {e}; install libzstd "
                          f"to read zstd-compressed Orbax checkpoints") from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [vp, size_t]
        lib.ZSTD_decompress.restype = size_t
        lib.ZSTD_decompress.argtypes = [vp, size_t, vp, size_t]
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [size_t]
        lib.ZSTD_getErrorName.restype = ctypes.c_char_p
        lib.ZSTD_getErrorName.argtypes = [size_t]
        lib.ZSTD_createDCtx.restype = vp
        lib.ZSTD_createDCtx.argtypes = []
        lib.ZSTD_freeDCtx.restype = size_t
        lib.ZSTD_freeDCtx.argtypes = [vp]
        lib.ZSTD_DStreamOutSize.restype = size_t
        lib.ZSTD_DStreamOutSize.argtypes = []
        lib.ZSTD_decompressStream.restype = size_t
        lib.ZSTD_decompressStream.argtypes = [vp, ctypes.POINTER(_Buffer),
                                              ctypes.POINTER(_Buffer)]
        _lib = lib
    return _lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytes:
    """One zstd frame -> its content.  A frame that states its size is
    decoded in one call, one that does not through a stream."""
    lib = _load()
    src = ctypes.create_string_buffer(bytes(data), len(data))
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size != _CONTENTSIZE_UNKNOWN:
        dst = ctypes.create_string_buffer(max(size, 1))
        n = _check(lib, lib.ZSTD_decompress(dst, size, src, len(data)), "decompress")
        if n != size:
            raise ValueError(f"zstd: the frame holds {n} bytes, its header says {size}")
        return dst.raw[:n]
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("zstd: ZSTD_createDCtx failed")
    try:
        chunk = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(chunk)
        inp = _Buffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        parts = []
        while True:
            out = _Buffer(ctypes.cast(dst, ctypes.c_void_p), chunk, 0)
            left = _check(lib, lib.ZSTD_decompressStream(dctx, ctypes.byref(out),
                                                          ctypes.byref(inp)), "stream")
            parts.append(dst.raw[:out.pos])
            if left == 0 and inp.pos == inp.size:
                return b"".join(parts)
            if inp.pos == inp.size and out.pos < chunk:
                raise ValueError("zstd: truncated frame")
    finally:
        lib.ZSTD_freeDCtx(dctx)
