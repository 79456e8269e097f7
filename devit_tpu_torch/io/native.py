"""ctypes binding for the native host gather (io/csrc/devit_host.cpp;
counterpart of devit_tpu/io/native.py).

The library is built at first use with g++ (-O3 -shared -fPIC) into
build/devit_tpu_torch_host/ at the root of the checkout, beside the CUDA
kernels, named by the hash of its source and flags; never next to the
source. A failed build raises (the JAX package falls back to numpy fancy
indexing with a line on stderr; the port does not, so a run shows the C++
gather ran). `gather_rows(src, idx)` is a multithreaded `src[idx]` for
C-contiguous uint8 arrays, counted in `gather_rows.launches`; other arrays
(another dtype, a non-contiguous view) take numpy's fancy indexing, as in
the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "devit_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "devit_tpu_torch_host"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode() + b"\0" + SOURCE.read_bytes())
    return BUILD_DIR / f"devit_host-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless an up-to-date one exists (a per-process
    temporary name, then an atomic rename, so concurrent first uses never
    load a half-written file). Raises RuntimeError if g++ fails."""
    out = _lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        res = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                             capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the native gather needs g++ to build {SOURCE.name}: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{res.stdout}{res.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    lib.devit_gather_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
    lib.devit_gather_u8.restype = None
    return lib


def gather_rows(src: np.ndarray, idx: np.ndarray, n_threads: int = 0) -> np.ndarray:
    """dst[i] = src[idx[i]]. Negative or out-of-range indices raise
    IndexError (the C memcpy loop is unchecked, and numpy would wrap a
    negative one; -1 is the padded-label sentinel and must never reach a
    gather)."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= src.shape[0]):
        raise IndexError(f"gather_rows: index out of range [0, {src.shape[0]}): "
                         f"min {int(idx.min())}, max {int(idx.max())}")
    if not src.flags["C_CONTIGUOUS"] or src.dtype != np.uint8:
        return src[idx]
    n = idx.shape[0]
    dst = np.empty((n,) + src.shape[1:], dtype=src.dtype)
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 16)
    library().devit_gather_u8(src.ctypes.data, idx.ctypes.data, n, src.strides[0],
                              dst.ctypes.data, n_threads)
    gather_rows.launches += 1
    return dst


gather_rows.launches = 0
