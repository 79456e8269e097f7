"""Int8 serving path: per-output-channel weight quantization and dynamic
per-row activation quantization (counterpart of devit_tpu/kernels/quant.py).

`dynamic_int8_matmul` is the plain PyTorch version: per row, amax in f32,
x_scale = max(amax, 1e-8) / 127, x_q = clip(round_half_even(x / x_scale),
+-127) with a true division; the int8 products summed exactly (in float64:
CUDA torch has no int32 matmul, and |acc| <= K * 127^2 < 2^53 for any K the
models use), rounded to f32 as the JAX package's int32 -> f32 cast rounds;
then acc * x_scale * w_scale + bias in f32 in that order, and the cast.
`fused_int8_matmul` computes the same function: on a CUDA tensor it launches
the hand-written kernels in csrc/quant_matmul.cu (the row quantization, then
the int8 tensor-core GEMM; bit for bit the plain version's output), on a CPU
tensor it takes `dynamic_int8_matmul`. Any other device raises; nothing
falls back.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from devit_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


class QuantizedLinear(nn.Module):
    """w_q (K, N) int8, w_scale (N,) f32 per output channel, bias (N,) f32 or
    None; buffers, so .to(device) carries them. w_nk (N, Kp) is the weight in
    the layout the CUDA kernel's tensor cores take, made once here: row n is
    column n of w_q, zero-padded to Kp, K rounded up to a multiple of 32 (a
    buffer derived from w_q, left out of the state dict: to change the weight,
    build a new QuantizedLinear)."""

    def __init__(self, w_q: torch.Tensor, w_scale: torch.Tensor,
                 bias: Optional[torch.Tensor] = None):
        super().__init__()
        self.register_buffer("w_q", w_q)
        self.register_buffer("w_scale", w_scale)
        self.register_buffer("bias", bias)
        K, N = w_q.shape
        w_nk = torch.zeros((N, -(-K // 32) * 32), dtype=w_q.dtype, device=w_q.device)
        w_nk[:, :K] = w_q.t()
        self.register_buffer("w_nk", w_nk, persistent=False)


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-8) / 127 as an IEEE division on every device: on CUDA,
    torch divides by a Python scalar as a product with its reciprocal, which
    can differ by an ulp, so the divisor is a 0-d tensor on amax's device."""
    return torch.clamp_min(amax, 1e-8) / torch.full((), 127.0, device=amax.device)


def quantize_weight(w: torch.Tensor, bias: Optional[torch.Tensor] = None) -> QuantizedLinear:
    """Symmetric per-output-channel int8 quantization of a (K, N) kernel,
    into contiguous (K, N) row-major buffers whatever w's strides."""
    w = w.detach().float().contiguous()
    scale = _scale(w.abs().amax(dim=0))
    w_q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return QuantizedLinear(w_q, scale, None if bias is None else bias.detach().float().clone())


def _quantize_rows(x2: torch.Tensor):
    """(M, K) -> (x_q (M, K) as float64 integers in [-127, 127], x_scale (M, 1) f32)."""
    x_scale = _scale(x2.abs().amax(dim=1, keepdim=True))
    return torch.clamp(torch.round(x2 / x_scale), -127, 127).double(), x_scale


def dynamic_int8_matmul(x: torch.Tensor, q: QuantizedLinear,
                        out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ W + b with dynamic symmetric per-row activation quantization.
    x: (..., K) float; returns (..., N) out_dtype."""
    shape = x.shape
    K = shape[-1]
    x_q, x_scale = _quantize_rows(x.reshape(-1, K).float())
    acc = torch.matmul(x_q, q.w_q.double()).float()  # exact sums, one rounding
    y = acc * x_scale * q.w_scale[None, :]
    if q.bias is not None:
        y = y + q.bias.float()[None, :]
    return y.to(out_dtype).reshape(*shape[:-1], q.w_q.shape[1])


def _check(x: torch.Tensor, q: QuantizedLinear, out_dtype: torch.dtype) -> None:
    K, N = q.w_q.shape
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA int8 kernel takes float32 or bfloat16 input and output, "
                        f"got {x.dtype} -> {out_dtype}")
    if x.shape[-1] != K:
        raise ValueError(f"x's last dim {x.shape[-1]} != the weight's depth {K}")
    if K % 4:
        raise ValueError(f"the CUDA int8 kernel takes a depth K that is a multiple of 4, got {K}")
    if q.w_q.dtype != torch.int8 or q.w_scale.dtype != torch.float32 or (
            q.bias is not None and q.bias.dtype != torch.float32):
        raise TypeError("the CUDA int8 kernel takes an int8 w_q and f32 scales and bias")
    for name, t in (("w_nk", q.w_nk), ("w_scale", q.w_scale), ("bias", q.bias)):
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {x.device}")


def fused_int8_matmul(x: torch.Tensor, q: QuantizedLinear, *,
                      out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """dynamic_int8_matmul's function, fused. CUDA tensor: the kernels in
    csrc/quant_matmul.cu, the row quantization into an (M, Kp) int8 scratch
    and the GEMM (one call, counted once in `fused_int8_matmul.launches`).
    CPU tensor: `dynamic_int8_matmul`."""
    if x.device.type == "cpu":
        return dynamic_int8_matmul(x, q, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_int8_matmul runs on cuda (kernel) or cpu (plain version), "
                         f"not {x.device}")
    _check(x, q, out_dtype)
    K, N = q.w_q.shape
    Kp = q.w_nk.shape[1]
    x2 = x.reshape(-1, K).contiguous()
    if x2.data_ptr() % (4 * x2.element_size()):  # the kernel reads 4 values at a time
        x2 = x2.clone()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    if M:
        # one scratch: the (M, Kp) int8 codes, then the (M,) f32 row scales
        scratch = torch.empty((M * (Kp + 4),), dtype=torch.int8, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = _build.library().devit_quant_matmul(
                x2.data_ptr(), q.w_nk.data_ptr(), q.w_scale.data_ptr(),
                None if q.bias is None else q.bias.data_ptr(), scratch.data_ptr(),
                scratch.data_ptr() + M * Kp, out.data_ptr(), M, K, Kp, N,
                _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream)
        _build.check_launch(err, "fused_int8_matmul")
        fused_int8_matmul.launches += 1
    return out.reshape(*x.shape[:-1], N)


fused_int8_matmul.launches = 0
