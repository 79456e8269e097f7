"""zstd frames through ctypes on the system's libzstd, the one codec of the
orbax checkpoint format: tensorstore compresses OCDBT nodes and manifests
with it, and every zarr chunk orbax writes is a zstd frame
(`"compressor": {"id": "zstd"}`). The machine with the card has neither
`zstandard` nor tensorstore, but it has `libzstd.so.1`.

The library is `$DEVIT_LIBZSTD` where that is set (a path or a soname),
else `libzstd.so.1` through the dynamic loader's search path. It is loaded
at the first call, never at import; a missing library raises a
RuntimeError that names it. ctypes releases the GIL for the length of each
call, so chunks compress and decompress in parallel threads.

Frames written by tensorstore's streaming encoder do not record their
content size: `decompress` then takes the streaming decoder, and
`decompress_into` the size the caller knows (a zarr chunk's shape and
dtype).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_CONTENTSIZE_UNKNOWN = 2 ** 64 - 1
_CONTENTSIZE_ERROR = 2 ** 64 - 2
_LIB = None
_LOCK = threading.Lock()


class _Buffer(ctypes.Structure):  # ZSTD_inBuffer and ZSTD_outBuffer
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def library() -> ctypes.CDLL:
    """The loaded libzstd, its C signatures declared."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            name = os.environ.get("DEVIT_LIBZSTD") or "libzstd.so.1"
            try:
                lib = ctypes.CDLL(name)
            except OSError as e:
                raise RuntimeError(
                    f"zstd: cannot load {name!r} ({e}); orbax checkpoints need the system's "
                    "libzstd.so.1 (set DEVIT_LIBZSTD to its path)") from e
            size_t, vp = ctypes.c_size_t, ctypes.c_void_p
            for fn, res, args in (
                    ("ZSTD_versionNumber", ctypes.c_uint, []),
                    ("ZSTD_compressBound", size_t, [size_t]),
                    ("ZSTD_compress", size_t, [vp, size_t, vp, size_t, ctypes.c_int]),
                    ("ZSTD_decompress", size_t, [vp, size_t, vp, size_t]),
                    ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [vp, size_t]),
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t]),
                    ("ZSTD_createDStream", vp, []),
                    ("ZSTD_freeDStream", size_t, [vp]),
                    ("ZSTD_DStreamOutSize", size_t, []),
                    ("ZSTD_decompressStream", size_t,
                     [vp, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)])):
                f = getattr(lib, fn)
                f.restype, f.argtypes = res, args
            if lib.ZSTD_versionNumber() < 10400:
                raise RuntimeError(f"zstd: {name!r} is version {lib.ZSTD_versionNumber()}; "
                                   "1.4.0 or later is needed")
            _LIB = lib
    return _LIB


def _check(lib, r: int) -> int:
    if lib.ZSTD_isError(r):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(r).decode()}")
    return r


def _bytes_view(data) -> np.ndarray:
    """A C-contiguous uint8 view of a bytes-like object or array (no copy)."""
    if isinstance(data, np.ndarray):
        return np.require(data, requirements="C").reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def compress(data, level: int = 1) -> bytes:
    """One zstd frame of `data` (bytes-like or a numpy array's bytes), its
    content size recorded."""
    lib = library()
    src = _bytes_view(data)
    cap = lib.ZSTD_compressBound(src.size)
    dst = np.empty(cap, np.uint8)
    n = _check(lib, lib.ZSTD_compress(dst.ctypes.data, cap, src.ctypes.data, src.size, level))
    return dst[:n].tobytes()


def decompress(data) -> bytes:
    """The content of one or more concatenated frames: by the frame's
    recorded content size, or by the streaming decoder where it has none."""
    lib = library()
    src = _bytes_view(data)
    fcs = lib.ZSTD_getFrameContentSize(src.ctypes.data, src.size)
    if fcs == _CONTENTSIZE_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if fcs == _CONTENTSIZE_UNKNOWN:
        return _decompress_stream(lib, src)
    out = np.empty(int(fcs), np.uint8)
    decompress_into(src, out)
    return out.tobytes()


def decompress_into(data, out: np.ndarray) -> None:
    """Decode the frame(s) in `data` into the C-contiguous array `out`,
    whose byte size must be the content's exactly."""
    lib = library()
    src = _bytes_view(data)
    if not out.flags.c_contiguous:
        raise ValueError("zstd: decompress_into needs a C-contiguous output array")
    n = _check(lib, lib.ZSTD_decompress(out.ctypes.data, out.nbytes, src.ctypes.data, src.size))
    if n != out.nbytes:
        raise ValueError(f"zstd: frame holds {n} bytes, {out.nbytes} expected")


def _decompress_stream(lib, src: np.ndarray) -> bytes:
    ds = lib.ZSTD_createDStream()
    if not ds:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        inb = _Buffer(src.ctypes.data, src.size, 0)
        step = max(int(lib.ZSTD_DStreamOutSize()), 4 * src.size)
        parts = []
        while True:
            dst = np.empty(step, np.uint8)
            outb = _Buffer(dst.ctypes.data, step, 0)
            r = _check(lib, lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb)))
            parts.append(dst[:outb.pos].tobytes())
            if inb.pos == inb.size and outb.pos < step:
                if r != 0:
                    raise ValueError("zstd: truncated frame")
                return b"".join(parts)
    finally:
        lib.ZSTD_freeDStream(ds)
