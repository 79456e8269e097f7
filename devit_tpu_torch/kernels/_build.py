"""Build the port's CUDA kernel library with nvcc and load it with ctypes.

Every kernels/csrc/*.cu compiles, in one nvcc call, into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), for
sm_90a, into build/devit_tpu_torch_kernels/ at the root of the checkout, at
first use. The library is named by the hash of every source and header in
csrc/ and of the flags, so an edited file is never served by a stale build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = tuple(sorted(CSRC.glob("*.cu")))
HEADERS = tuple(sorted(CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "devit_tpu_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernel "
                           "is built from source at first use")
    return found


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return BUILD_DIR / f"attention-{h.hexdigest()[:16]}.so"


def build() -> Tuple[float, str]:
    """Compile the library unless an up-to-date one exists. Returns the wall
    seconds spent and nvcc's output (registers, shared memory, spills)."""
    out = _lib_path()
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {[f.name for f in SOURCES]}:\n{proc.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, proc.stdout


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed. The kernel module loads it
    once and declares its C signatures on it."""
    build()
    return ctypes.CDLL(str(_lib_path()))
