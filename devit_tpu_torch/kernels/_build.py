"""Build the port's CUDA kernel library with nvcc and load it with ctypes.

Every kernels/csrc/*.cu compiles into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for sm_90a, into
build/devit_tpu_torch_kernels/ at the root of the checkout, at first use: one
nvcc process a source, all started together, then one link. The library is named by the hash of every source and header in
csrc/ and of the flags, so an edited file is never served by a stale build.

Ranks that start together (one process a card, or ranks that share one)
build once: a build holds an exclusive lock on a file beside the library
(fcntl.flock, released by the kernel when its process ends, so a killed
build leaves no stale lock), and a process that waited for it finds the
library built.

`library()` loads it once with every kernel's C signature declared; the
kernel modules (attention.py, quant.py, gelu.py, moe.py) launch through it and raise
through `check_launch`. No flag relaxes IEEE arithmetic: the int8 kernel's
quantization divides and rounds as its plain version does, and the GELU
forward's expf and reciprocal are PyTorch's own.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C entry points of the library: name -> (argument types, result type). The
# attention entries take the logits' scale before the stream (the true head
# width's dh^-0.5 where the wrapper zero-pads narrower heads)
SIGNATURES = {
    "devit_fused_attention": ([_VP, _VP, _I, _I, _I, _I, _I, _F, _VP], _I),
    # the three backwards take a (B, H, N, 3) f32 scratch where they walk key
    # chunks (devit_attention_bwd_long_path), else NULL
    "devit_attention_bwd": ([_VP, _VP, _VP, _VP, _I, _I, _I, _I, _I, _F, _VP], _I),
    "devit_attention_bwd_dv": ([_VP, _VP, _VP, _LL, _VP, _I, _I, _I, _I, _I, _F, _VP], _I),
    "devit_attention_bwd_dqdk": ([_VP, _VP, _VP, _LL, _VP, _I, _I, _I, _I, _I, _F, _VP], _I),
    # x, w_nk, w_scale, bias (or NULL), x_q and x_scale scratch, out, M, K,
    # Kp, N, x dtype, out dtype, stream
    "devit_quant_matmul": ([_VP] * 7 + [_LL, _I, _I, _I, _I, _I, _VP], _I),
    # t, norm scale, norm bias, qkv kernel, qkv bias (or NULL), proj kernel,
    # proj bias, scratch (the chunked route, every f32 call: qkv and o; the
    # bf16 whole-row route: o), an unused pointer (NULL), out, B, N, C, H,
    # head_dim, eps, dtype, scale, stream
    "devit_block_attention": ([_VP] * 10 + [_I] * 5 + [_F, _I, _F, _VP], _I),
    # every query takes the device: which design a launch takes (a whole head
    # in one block, or key chunks) depends on its opt-in shared memory
    "devit_attention_smem_bytes": ([_I, _I, _I, _I], _LL),
    "devit_attention_path": ([_I, _I, _I, _I], _I),
    "devit_attention_bwd_smem_bytes": ([_I, _I, _I, _I], _LL),
    "devit_attention_bwd_dv_smem_bytes": ([_I, _I, _I, _I], _LL),
    "devit_attention_bwd_dqdk_smem_bytes": ([_I, _I, _I, _I], _LL),
    "devit_attention_bwd_long_path": ([_I, _I, _I, _I], _I),
    "devit_block_attention_smem_bytes": ([_I, _I, _I, _I], _LL),
    "devit_block_attention_chunked": ([_I, _I, _I, _I], _I),
    # x, (dy,) out, number of values, dtype (0 f32, 1 bf16, 2 f16), stream
    "devit_gelu_fwd": ([_VP, _VP, _LL, _I, _VP], _I),
    "devit_gelu_bwd": ([_VP, _VP, _VP, _LL, _I, _VP], _I),
    # the MoE dispatch and combine (csrc/moe.cu): x, slot_tok, tok_slot (or
    # NULL), w (or NULL), out, S, K, C, dtype, stream; buf, tok_slot, w (or
    # NULL), dy (or NULL), y (or NULL), dw (or NULL), T, K, C, dtype, stream
    "devit_moe_gather": ([_VP] * 5 + [_I] * 4 + [_VP], _I),
    "devit_moe_combine": ([_VP] * 6 + [_I] * 4 + [_VP], _I),
    "devit_max_smem_optin": ([_I], _LL),
    "devit_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "are built from source at first use")
    return found


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in SOURCES + HEADERS:
        h.update(f.name.encode() + b"\0" + f.read_bytes() + b"\0")
    return BUILD_DIR / f"kernels-{h.hexdigest()[:16]}.so"


def build() -> Tuple[float, str]:
    """Compile the library unless an up-to-date one exists: every source to
    an object in parallel, then one link. Returns the wall seconds spent and
    nvcc's output (registers, shared memory, spills). Concurrent callers
    build once (module docstring)."""
    out = _lib_path()
    if out.exists():
        return 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built while this process waited
            return 0.0, ""
        return _build_locked(out)


def _build_locked(out: Path) -> Tuple[float, str]:
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{f.stem}.o" for f in SOURCES]
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(f)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for f, o in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f.name for f, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))
        link = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc failed to link {[o.name for o in objs]}:\n{link.stdout}")
    os.replace(tmp, out)
    return time.perf_counter() - t0, "\n".join(logs + [link.stdout])


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded library, built first if needed, with every C signature in
    SIGNATURES declared."""
    build()
    lib = ctypes.CDLL(str(_lib_path()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check_launch(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (0 = launched)."""
    if err != 0:
        raise RuntimeError(f"{name} launch failed: "
                           + library().devit_error_string(err).decode())


def check_smem(need: int, what: str, device: int) -> None:
    """Raise if `need` bytes of shared memory per block (a *_smem_bytes
    answer for `what`) exceed what `device` lets a block opt in to."""
    limit = library().devit_max_smem_optin(device)
    if need > limit:
        raise ValueError(f"{what} needs {need} bytes of shared memory per block; "
                         f"the device allows {limit}")
