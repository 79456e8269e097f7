"""Fused multi-head self-attention (counterpart of
devit_tpu/kernels/attention.py:30-121).

`fused_attention` consumes the raw fused-qkv activations (B, N, 3C), ordered
[q | k | v] and head-major inside each third, and returns the proj-ready
(B, N, C). On a CUDA tensor it launches the hand-written kernel in
csrc/attention.cu; on a CPU tensor it takes `reference_attention`, the plain
PyTorch version with the same numerics (f32 logits and softmax, probabilities
rounded to v's dtype, f32 accumulation). Any other device raises; nothing
falls back.

The head gate is applied outside the kernel, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

HEAD_DIMS = (64,)  # head_dim values the CUDA kernel is instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _split_heads(qkv: torch.Tensor, num_heads: int):
    B, N, threeC = qkv.shape
    if threeC % (3 * num_heads) != 0:
        raise ValueError(f"num_heads={num_heads} must divide C={threeC // 3} "
                         f"(qkv last dim {threeC})")
    return B, N, threeC // 3, threeC // (3 * num_heads)


def _apply_gate(out: torch.Tensor, head_gate: Optional[torch.Tensor],
                dh: int) -> torch.Tensor:
    if head_gate is None:
        return out
    gate = torch.as_tensor(head_gate, device=out.device).to(out.dtype)
    return out * gate.repeat_interleave(dh)[None, None, :]


def reference_attention(qkv: torch.Tensor, head_gate: Optional[torch.Tensor] = None,
                        *, num_heads: int) -> torch.Tensor:
    """Plain PyTorch attention with the kernel's layout and numerics."""
    B, N, C, dh = _split_heads(qkv, num_heads)
    x = qkv.reshape(B, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = x[0], x[1], x[2]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(v.dtype)
    o = o.permute(0, 2, 1, 3).reshape(B, N, C)
    return _apply_gate(o, head_gate, dh)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from devit_tpu_torch.kernels import _build

    lib = _build.load()
    vp, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.devit_fused_attention.argtypes = [vp, vp, i, i, i, i, i, vp]
    lib.devit_fused_attention.restype = i
    lib.devit_attention_smem_bytes.argtypes = [i, i, i]
    lib.devit_attention_smem_bytes.restype = ll
    lib.devit_max_smem_optin.argtypes = [i]
    lib.devit_max_smem_optin.restype = ll
    lib.devit_error_string.argtypes = [i]
    lib.devit_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _check_smem(N: int, dh: int, elem: int, device: int) -> None:
    """Raise if one block at sequence length N does not fit shared memory."""
    lib = _library()
    need = lib.devit_attention_smem_bytes(N, dh, elem)
    limit = lib.devit_max_smem_optin(device)
    if need > limit:
        raise ValueError(f"sequence length N={N} needs {need} bytes of shared "
                         f"memory per block; the device allows {limit}")


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    B, N, C, dh = _split_heads(qkv, num_heads)
    if dh not in HEAD_DIMS:
        raise ValueError(f"the CUDA attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {dh}")
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA attention kernel takes float32 or bfloat16, "
                        f"got {qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("the CUDA attention kernel needs a contiguous qkv")
    _check_smem(N, dh, qkv.element_size(), qkv.device.index)
    lib = _library()
    out = torch.empty((B, N, C), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return out
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.devit_fused_attention(qkv.data_ptr(), out.data_ptr(), B, N,
                                        num_heads, dh, _DTYPE_CODES[qkv.dtype],
                                        stream)
    if err != 0:
        raise RuntimeError("fused_attention launch failed: "
                           + lib.devit_error_string(err).decode())
    fused_attention.launches += 1
    return out


def fused_attention(qkv: torch.Tensor, head_gate: Optional[torch.Tensor] = None,
                    *, num_heads: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(dh)) v * head_gate over (B, N, 3C) -> (B, N, C).

    CUDA tensor: the hand-written kernel (counted in
    `fused_attention.launches`). CPU tensor: `reference_attention`.
    """
    if qkv.device.type == "cpu":
        return reference_attention(qkv, head_gate, num_heads=num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_attention runs on cuda (kernel) or cpu "
                         f"(plain version), not {qkv.device}")
    out = _launch(qkv, num_heads)
    return _apply_gate(out, head_gate, out.shape[-1] // num_heads)


fused_attention.launches = 0
