"""The exact-erf GELU with the Abramowitz-Stegun erf (counterpart of
devit_tpu/models/vit.py fast_erf/fast_gelu), as one kernel forward and one
backward (csrc/gelu.cu).

`reference_gelu` is the plain chain: the A&S 7.1.26 erf and the GELU around
it written out as eager f32 ops, the same constants and rounding as the JAX
package. `fused_gelu` computes it as the dispatcher op `devit_torch::fused_gelu`
(`fused_gelu_op`): on a CUDA tensor of dtype float32, bfloat16 or float16 one
launch of `gelu_as_fwd`, bit for bit the chain as PyTorch's CUDA ops compute
it (counted in `fused_gelu.launches`); on a CPU tensor the chain itself. Its
gradient saves only x: `fused_gelu_bwd` launches `gelu_as_bwd` on a CUDA
tensor (counted in `fused_gelu_bwd.launches`) and takes `gelu_as_grad`, its
plain twin, on a CPU tensor. Both compute dy * g'(x) with g' the derivative of
the A&S expression as written (`gelu_as_slope`), what autograd of the chain
and jax.grad of the JAX package's fast_gelu compute, in f32, rounded once to
x's dtype. The kernel evaluates the polynomial in 1 - t and takes dy into its
last FMA, which halves the f32 error near x = 0 (csrc/gelu.cu).

Under torch.utils.checkpoint the op is recomputed like any op that no remat
policy saves (models/vit.py REMAT_POLICIES lists none of it).
"""

from __future__ import annotations

import numpy as np
import torch

from devit_tpu_torch.kernels import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
KERNEL_DTYPES = tuple(_DTYPE_CODES)

# fast_erf's constants as f32 values (the kernels' and the chain's operands)
_RSQRT2, _P, _A1, _A2, _A3, _A4, _A5 = (float(np.float32(c)) for c in (
    0.7071067811865476, 0.3275911, 0.254829592, -0.284496736, 1.421413741,
    -1.453152027, 1.061405429))


def fast_erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz–Stegun 7.1.26 (max abs error 1.5e-7), computed in
    f32 and cast back to the input dtype — the same constants and rounding
    as the JAX package, so both packages agree on the exact-erf GELU."""
    xf = x.to(torch.float32)
    z = xf.abs()
    t = 1.0 / (1.0 + 0.3275911 * z)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (1.421413741
           + t * (-1.453152027 + t * 1.061405429))))
    e = 1.0 - poly * torch.exp(-z * z)
    return (torch.sign(xf) * e).to(x.dtype)


def reference_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU with the A&S erf (see fast_erf): the plain chain."""
    xf = x.to(torch.float32)
    return (0.5 * xf * (1.0 + fast_erf(xf * 0.7071067811865476))).to(x.dtype)


def gelu_as_slope(xf: torch.Tensor) -> torch.Tensor:
    """g'(x) of reference_gelu's expression, in xf's dtype (f32 for the plain
    backward; f64 gives the tests its exact value), the formula csrc/gelu.cu
    evaluates (there with P(t) as a polynomial in 1 - t).
    With u = x/sqrt(2), t = 1/(1 + p|u|), e = exp(-u^2), P the A&S polynomial
    and E(u) = sign(u) (1 - P(t) e):
        g' = (1 + E)/2 + u/2 dE/du,  dE/du = e (p t^2 P'(t) + 2|u| P(t)),
    dE/du taken as 0 at u = 0 (abs's derivative there), so g'(0) = 1/2. The
    large part of 1 + E is added last: g' = 1 + (u dE/du - P e)/2 above 0 and
    (u dE/du + P e)/2 below, so the sum rounds once at its own size."""
    u = xf * _RSQRT2
    z = u.abs()
    t = (_P * z + 1.0).reciprocal()
    poly = t * (_A1 + t * (_A2 + t * (_A3 + t * (_A4 + t * _A5))))
    dpoly = _A1 + t * (2 * _A2 + t * (3 * _A3 + t * (4 * _A4 + t * (5 * _A5))))
    e = torch.exp(-z * z)
    pe = poly * e
    uderf = u * (e * (_P * t * t * dpoly) + 2.0 * z * pe)
    return torch.where(u == 0, torch.full_like(pe, 0.5),
                       torch.where(u < 0, 0.5 * (uderf + pe), 0.5 * (uderf - pe) + 1.0))


def gelu_as_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx of reference_gelu at x for the cotangent dy: dy * g'(x) in f32,
    rounded once to x's dtype (the plain twin of gelu_as_bwd)."""
    return (dy.float() * gelu_as_slope(x.float())).to(x.dtype)


def _operand(t: torch.Tensor) -> torch.Tensor:
    """t as the kernels take it: a dtype they know, contiguous, 16-byte
    aligned (a slice that starts mid-vector is copied)."""
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA GELU kernels take {KERNEL_DTYPES}, got {t.dtype}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(counted, name: str, *operands: torch.Tensor) -> torch.Tensor:
    """One launch of the C entry `name` over the operands (x first) into a
    new tensor like x, counted in `counted.launches`; none for an empty x."""
    x = operands[0]
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(x.device):
            err = getattr(_build.library(), name)(
                *(t.data_ptr() for t in operands), out.data_ptr(), x.numel(),
                _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
        _build.check_launch(err, name)
        counted.launches += 1
    return out


def fused_gelu_bwd(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dx of fused_gelu at x for the cotangent dy (x's shape and dtype).
    CUDA tensor: one launch of gelu_as_bwd (counted in
    `fused_gelu_bwd.launches`). CPU tensor: gelu_as_grad."""
    if x.device.type == "cpu":
        return gelu_as_grad(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"fused_gelu_bwd runs on cuda (kernel) or cpu (plain version), "
                         f"not {x.device}")
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    return _launch(fused_gelu_bwd, "devit_gelu_bwd", _operand(x), _operand(dy))


fused_gelu_bwd.launches = 0


@torch.library.custom_op("devit_torch::fused_gelu", mutates_args=(),
                         device_types=("cuda", "cpu"))
def _fused_gelu(x: torch.Tensor) -> torch.Tensor:
    """reference_gelu as a dispatcher op: gelu_as_fwd on a CUDA tensor, the
    chain on a CPU tensor. Its gradient saves only x."""
    if x.device.type == "cpu":
        return reference_gelu(x)
    return _launch(fused_gelu, "devit_gelu_fwd", _operand(x))


@_fused_gelu.register_fake
def _(x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x)


def _setup(ctx, inputs, output) -> None:
    ctx.save_for_backward(inputs[0])


def _backward(ctx, dy: torch.Tensor) -> torch.Tensor:
    (x,) = ctx.saved_tensors
    return fused_gelu_bwd(x, dy)


_fused_gelu.register_autograd(_backward, setup_context=_setup)
fused_gelu_op = torch.ops.devit_torch.fused_gelu.default


def fused_gelu(x: torch.Tensor) -> torch.Tensor:
    """reference_gelu(x), differentiable, through the op: on a CUDA tensor
    one kernel forward (counted in `fused_gelu.launches`) and one backward
    (`fused_gelu_bwd.launches`), x made contiguous first; on a CPU tensor the
    chain forward and gelu_as_grad backward."""
    return _fused_gelu(x.contiguous())


fused_gelu.launches = 0
