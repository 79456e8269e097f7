"""Fused multi-head self-attention and its backward (counterpart of
devit_tpu/kernels/attention.py:30-121 and :238-295, :391-433).

`fused_attention` consumes the raw fused-qkv activations (B, N, 3C), ordered
[q | k | v] and head-major inside each third, and returns the proj-ready
(B, N, C). On a CUDA tensor it launches the hand-written kernel in
csrc/attention.cu; on a CPU tensor it takes `reference_attention`, the plain
PyTorch version with the same numerics (f32 logits and softmax, probabilities
rounded to v's dtype, f32 accumulation). Any other device raises; nothing
falls back.

The head gate is applied outside the kernel, as in the JAX package.

At bf16 the forward, the backwards and `fused_block_attention` compute every
product on the tensor cores (mma.sync m16n8k16). At f32 they do too, as
3xTF32 (mma.sync m16n8k8): each operand is split into two TF32 halves and
each product takes three passes (small big + big small + big big), which
keeps f32 accuracy where one TF32 pass (11 significant bits an operand)
misses the f32 tolerance by ~10x (tests/test_torch_tf32x3.py holds that
decision on the CPU, for the attention and for the block half's GEMMs).
Every kernel is instantiated for head_dim 32, 64
and 128 (HEAD_DIMS); the wrappers take any head_dim up to 128 by
zero-padding each head's q, k, v (and g) to the next instantiation, launching
with the true head width's scale and slicing the outputs back. Zero columns
add exact zeros to every logit and product, so the result is the unpadded
computation. A head_dim past 128 is padded the same way to the next multiple
of 64 and runs on the wide tensor-core kernels (csrc/wide.cuh: every score
product walks the head in 64-dim pieces at bf16, 32-dim at f32, and each
output is made in slabs of at most 128 dims), in both dtypes.

Every kernel takes any N. The forward picks its design on the C side
(`attention_path`): at bf16 past 256 keys, and at f32 at every N, it walks K
and V in chunks through a ring of two shared-memory buffers (attn_long_mma,
attn_long_tf32; tensor cores), and past head_dim 128 also the head's pieces
(attn_wide_mma). The backwards walk key chunks (csrc/attention_bwd_long.cu:
a rows kernel, then a keys kernel; on the tensor cores, past head_dim 128
over head pieces and output slabs) at f32, at bf16 past 256 keys or where a
block of the monolithic kernel would not fit shared memory (head_dim 128
from N 209), and past head_dim 128, with a (B, H, N, 3) f32 scratch of row
statistics that the wrapper allocates.
`fused_block_attention` takes a chunked route of three launches (LayerNorm +
qkv, the forward, proj; tensor-core GEMMs) at f32, and at bf16 where its
whole-head block would not fit or past head_dim 128.

`make_trainable_attention` is the differentiable form the training path
uses: its forward is `fused_attention`, registered as the dispatcher op
`devit_torch::trainable_attention` (`trainable_attention_op`) so that
selective checkpointing can save its output; it saves only qkv, and its
backward recomputes the probabilities. The backward mode comes from
DEVIT_ATTN_BWD (default "monolithic"), as in the JAX package:
- "monolithic": `attention_bwd`, the kernel in csrc/attention_bwd.cu;
- "split": `attention_bwd_split`, two kernels in csrc/attention_bwd_split.cu,
  `attention_bwd_dqdk` ([dq | dk]) and `attention_bwd_dv` (dv), which equal
  the monolithic kernel bit for bit.
Each takes its plain version (`reference_attention_bwd`,
`reference_attention_bwd_dqdk`, `reference_attention_bwd_dv`, the TPU
kernels' numerics) on a CPU tensor.
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from devit_tpu_torch.kernels import _build

HEAD_DIMS = (32, 64, 128)  # head_dim values the CUDA kernels are instantiated for
# Past this width a head runs on the wide kernels; each wrapper counts those
# launches apart too, in `<wrapper>.wide_launches` (also in `launches`).
WIDE = HEAD_DIMS[-1]
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_head_dim(dh: int) -> int:
    """The width a head of width dh runs at: the narrowest of HEAD_DIMS that
    holds it, or past 128 the next multiple of 64 (the wide kernels walk the
    head in 64-dim pieces; the wrappers zero-pad each head to that width and
    launch with dh's own logit_scale, so the padding adds exact zeros)."""
    if dh < 1:
        raise ValueError(f"head_dim must be positive, got {dh}")
    return next((width for width in HEAD_DIMS if dh <= width), -(-dh // 64) * 64)


def logit_scale(dh: int) -> float:
    """dh^-0.5 as the kernels computed it from their template's width: an
    f32 reciprocal of an f32 square root (exact in the C float it is passed
    as)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dh)))


def pad_heads(x: torch.Tensor, parts: int, num_heads: int, dh: int, width: int) -> torch.Tensor:
    """(B, N, parts * num_heads * dh) -> (B, N, parts * num_heads * width),
    each head's dh values followed by zeros (contiguous)."""
    if dh == width:
        return x.contiguous()
    B, N, _ = x.shape
    x = x.reshape(B, N, parts, num_heads, dh)
    return F.pad(x, (0, width - dh)).reshape(B, N, parts * num_heads * width)


def unpad_heads(x: torch.Tensor, parts: int, num_heads: int, dh: int,
                width: int) -> torch.Tensor:
    """The inverse of pad_heads: each head's first dh values (contiguous)."""
    if dh == width:
        return x
    B, N, _ = x.shape
    x = x.reshape(B, N, parts, num_heads, width)[..., :dh]
    return x.reshape(B, N, parts * num_heads * dh)


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


def reference_attention_bwd(qkv: torch.Tensor, g: torch.Tensor,
                            num_heads: int) -> torch.Tensor:
    """Plain PyTorch backward with the kernel's layout and numerics, line
    for line the TPU kernel's: f32 p, p rounded to v's dtype for dv, f32 dp,
    ds rounded to v's dtype, every product accumulated in f32. Returns dqkv
    of qkv's shape and dtype."""
    B, N, C, dh = _split_heads(qkv, num_heads)
    scale = dh ** -0.5
    x = qkv.reshape(B, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    q, k, v = x[0].float(), x[1].float(), x[2]
    gh = g.reshape(B, N, num_heads, dh).permute(0, 2, 1, 3).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)  # f32 (B, H, N, N)
    pb = p.to(v.dtype).float()
    dv = torch.matmul(pb.transpose(-1, -2), gh)
    dp = torch.matmul(gh, v.float().transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = (ds * scale).to(v.dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    out = torch.stack([dq, dk, dv]).to(qkv.dtype)  # (3, B, H, N, dh)
    return out.permute(1, 3, 0, 2, 4).reshape(B, N, 3 * C)


def _bwd_operands(qkv: torch.Tensor, g: torch.Tensor, num_heads: int):
    B, N, C, dh = _split_heads(qkv, num_heads)
    x = qkv.reshape(B, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    gh = g.reshape(B, N, num_heads, dh).permute(0, 2, 1, 3).float()
    s = torch.matmul(x[0].float(), x[1].float().transpose(-1, -2)) * (dh ** -0.5)
    return x, gh, torch.softmax(s, dim=-1), (B, N, C, dh)  # p in f32 (B, H, N, N)


def _merge_heads(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(k, B, H, N, dh) f32 -> (B, N, k * H * dh) of `dtype`."""
    t = t.to(dtype)
    k, B, H, N, dh = t.shape
    return t.permute(1, 3, 0, 2, 4).reshape(B, N, k * H * dh)


def reference_attention_bwd_dv(qkv: torch.Tensor, g: torch.Tensor,
                               num_heads: int) -> torch.Tensor:
    """dv (B, N, C) line for line as the TPU dv kernel computes it: f32 p
    rounded to qkv's dtype, then p^T g accumulated in f32."""
    _, gh, p, _ = _bwd_operands(qkv, g, num_heads)
    pb = p.to(qkv.dtype).float()
    return _merge_heads(torch.matmul(pb.transpose(-1, -2), gh)[None], qkv.dtype)


def reference_attention_bwd_dqdk(qkv: torch.Tensor, g: torch.Tensor,
                                 num_heads: int) -> torch.Tensor:
    """[dq | dk] (B, N, 2C) line for line as the TPU dq/dk kernel computes
    them: f32 p, f32 dp, ds rounded to v's dtype, products in f32."""
    x, gh, p, (_, _, _, dh) = _bwd_operands(qkv, g, num_heads)
    q, k, v = x[0].float(), x[1].float(), x[2]
    dp = torch.matmul(gh, v.float().transpose(-1, -2))
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    ds = (ds * dh ** -0.5).to(v.dtype).float()
    dq = torch.matmul(ds, k)
    dk = torch.matmul(ds.transpose(-1, -2), q)
    return _merge_heads(torch.stack([dq, dk]), qkv.dtype)


_SMEM_QUERIES = {"fwd": "devit_attention_smem_bytes", "bwd": "devit_attention_bwd_smem_bytes",
                 "dv": "devit_attention_bwd_dv_smem_bytes",
                 "dqdk": "devit_attention_bwd_dqdk_smem_bytes",
                 "block": "devit_block_attention_smem_bytes"}


@functools.lru_cache(maxsize=None)
def _check_smem(kernel: str, N: int, dh: int, elem: int, device: int) -> None:
    """Raise if one block of `kernel` (a key of _SMEM_QUERIES) at sequence
    length N and head_dim dh does not fit shared memory, on the design the
    C side picks for `device`."""
    need = getattr(_build.library(), _SMEM_QUERIES[kernel])(N, dh, elem, device)
    _build.check_smem(need, f"sequence length N={N} at head_dim {dh} in the {kernel} kernel",
                      device)


ATTENTION_PATHS = ("whole-row", "key-chunked mma", "wide-head mma")


def attention_path(N: int, dh: int, dtype: torch.dtype, device: int = 0) -> str:
    """The design `fused_attention` launches at sequence length N and head
    width dh (before padding) on CUDA device `device`: one block holds the
    head's keys (bf16 to 256 keys); a tensor-core kernel over key chunks
    (bf16 past 256 keys, f32 at every N); or, past head width 128, the
    tensor-core kernel over key chunks, head pieces and output slabs."""
    code = _build.library().devit_attention_path(N, kernel_head_dim(dh),
                                                 torch.tensor([], dtype=dtype).element_size(),
                                                 device)
    return ATTENTION_PATHS[code]


def _check_kernel_input(qkv: torch.Tensor, num_heads: int, kernel: str):
    """Returns (B, N, C, dh, width): width the instantiation dh runs in."""
    B, N, C, dh = _split_heads(qkv, num_heads)
    width = kernel_head_dim(dh)
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA attention kernels take float32 or bfloat16, "
                        f"got {qkv.dtype}")
    _check_smem(kernel, N, width, qkv.element_size(), qkv.device.index)
    return B, N, C, dh, width


def _check_aligned(*tensors: torch.Tensor) -> None:
    """The tensor-core kernels (bf16, and f32 on the forward and the
    backwards) stage head rows with 16-byte copies."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the CUDA attention kernels need 16-byte aligned operands")


def _launch(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    if not qkv.is_contiguous():
        raise ValueError("the CUDA attention kernel needs a contiguous qkv")
    B, N, C, dh, width = _check_kernel_input(qkv, num_heads, "fwd")
    x = pad_heads(qkv, 3, num_heads, dh, width)
    _check_aligned(x)
    lib = _build.library()
    out = torch.empty((B, N, num_heads * width), dtype=qkv.dtype, device=qkv.device)
    if B == 0:
        return unpad_heads(out, 1, num_heads, dh, width)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.devit_fused_attention(x.data_ptr(), out.data_ptr(), B, N,
                                        num_heads, width, _DTYPE_CODES[qkv.dtype],
                                        logit_scale(dh), stream)
    _build.check_launch(err, "fused_attention")
    fused_attention.launches += 1
    if width > WIDE:
        fused_attention.wide_launches += 1
    return unpad_heads(out, 1, num_heads, dh, width)


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
fused_attention.wide_launches = 0


def _check_bwd_input(qkv: torch.Tensor, g: torch.Tensor, num_heads: int, kernel: str):
    """Returns qkv and g contiguous with their heads padded to the
    instantiation's width, and (B, N, C, dh, width) of the caller's qkv."""
    B, N, C, dh, width = _check_kernel_input(qkv, num_heads, kernel)
    if g.shape != (B, N, C) or g.dtype != qkv.dtype or g.device != qkv.device:
        raise ValueError(f"g must be {(B, N, C)} {qkv.dtype} on {qkv.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    return (pad_heads(qkv, 3, num_heads, dh, width), pad_heads(g, 1, num_heads, dh, width),
            (B, N, C, dh, width))


@functools.lru_cache(maxsize=None)
def _bwd_long_path(N: int, dh: int, elem: int, device: int) -> bool:
    """Whether the backwards walk key chunks (csrc/bwd_mma.cuh use_long_path:
    at f32, past 256 keys, where the monolithic kernel's block does not fit,
    past head_dim 128)."""
    return bool(_build.library().devit_attention_bwd_long_path(N, dh, elem, device))


# Past this N the bf16 backwards always walk key chunks (csrc/bwd_common.cuh
# kShortN); at or below it only where the monolithic block does not fit. The
# f32 backwards walk key chunks at every N.
_SHORT_N = 256


def _bwd_stats(qkv: torch.Tensor, num_heads: int) -> Optional[torch.Tensor]:
    """The long path's (B, H, N, 3) f32 scratch of each row's softmax max,
    sum and rowsum(dp * p), or None where one block owns a (row, head)."""
    B, N, C3 = qkv.shape
    if (qkv.dtype != torch.float32 and N <= _SHORT_N and not (qkv.is_cuda and _bwd_long_path(
            N, C3 // (3 * num_heads), qkv.element_size(), qkv.device.index))):
        return None
    return torch.empty((B, num_heads, N, 3), dtype=torch.float32, device=qkv.device)


def _launch_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    qkv, g, (B, N, C, dh, width) = _check_bwd_input(qkv, g, num_heads, "bwd")
    _check_aligned(qkv, g)
    dqkv = torch.empty_like(qkv)
    if B == 0:
        return unpad_heads(dqkv, 3, num_heads, dh, width)
    lib = _build.library()
    stats = _bwd_stats(qkv, num_heads)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = lib.devit_attention_bwd(qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(),
                                      None if stats is None else stats.data_ptr(), B, N,
                                      num_heads, width, _DTYPE_CODES[qkv.dtype],
                                      logit_scale(dh), stream)
    _build.check_launch(err, "attention_bwd")
    attention_bwd.launches += 1
    if width > WIDE:
        attention_bwd.wide_launches += 1
    return unpad_heads(dqkv, 3, num_heads, dh, width)


def attention_bwd(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """dqkv of `fused_attention` (no gate) at qkv for the output gradient g.

    CUDA tensor: the hand-written kernel (counted in `attention_bwd.launches`).
    CPU tensor: `reference_attention_bwd`. g may be a non-contiguous view."""
    if qkv.device.type == "cpu":
        return reference_attention_bwd(qkv, g, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_bwd runs on cuda (kernel) or cpu "
                         f"(plain version), not {qkv.device}")
    return _launch_bwd(qkv, g, num_heads)


attention_bwd.launches = 0
attention_bwd.wide_launches = 0


def _launch_half(kernel: str, qkv: torch.Tensor, g: torch.Tensor, num_heads: int,
                 out: torch.Tensor, offset: int, stats: Optional[torch.Tensor],
                 scale: float) -> None:
    """Launch the split kernel `kernel` ("dv" or "dqdk") on contiguous,
    checked and padded qkv and g, writing token rows of `out` (contiguous,
    last dim its row stride) from element `offset` of each row on; `stats`
    is _bwd_stats(qkv); `scale` the true head width's logit_scale."""
    B, N, C, dh = _split_heads(qkv, num_heads)
    if B == 0:
        return
    _check_aligned(qkv, g)
    lib = _build.library()
    fn = lib.devit_attention_bwd_dv if kernel == "dv" else lib.devit_attention_bwd_dqdk
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = fn(qkv.data_ptr(), g.data_ptr(), out.data_ptr() + offset * out.element_size(),
                 out.shape[-1], None if stats is None else stats.data_ptr(), B, N, num_heads,
                 dh, _DTYPE_CODES[qkv.dtype], scale, stream)
    wrapper = attention_bwd_dv if kernel == "dv" else attention_bwd_dqdk
    _build.check_launch(err, wrapper.__name__)
    wrapper.launches += 1
    if dh > WIDE:
        wrapper.wide_launches += 1


def _split_half(kernel: str, plain, qkv: torch.Tensor, g: torch.Tensor,
                num_heads: int) -> torch.Tensor:
    if qkv.device.type == "cpu":
        return plain(qkv, g, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_bwd_{kernel} runs on cuda (kernel) or cpu (plain "
                         f"version), not {qkv.device}")
    qkv, g, (B, N, C, dh, width) = _check_bwd_input(qkv, g, num_heads, kernel)
    parts = 1 if kernel == "dv" else 2
    out = torch.empty((B, N, parts * num_heads * width), dtype=qkv.dtype, device=qkv.device)
    _launch_half(kernel, qkv, g, num_heads, out, 0, _bwd_stats(qkv, num_heads),
                 logit_scale(dh))
    return unpad_heads(out, parts, num_heads, dh, width)


def attention_bwd_dv(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """dv (B, N, C) of `fused_attention` (no gate) at qkv for the output
    gradient g. CUDA tensor: the kernel in csrc/attention_bwd_split.cu
    (counted in `attention_bwd_dv.launches`); CPU tensor:
    `reference_attention_bwd_dv`."""
    return _split_half("dv", reference_attention_bwd_dv, qkv, g, num_heads)


def attention_bwd_dqdk(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[dq | dk] (B, N, 2C), as attention_bwd_dv (counted in
    `attention_bwd_dqdk.launches`; plain version
    `reference_attention_bwd_dqdk`)."""
    return _split_half("dqdk", reference_attention_bwd_dqdk, qkv, g, num_heads)


attention_bwd_dv.launches = 0
attention_bwd_dqdk.launches = 0
attention_bwd_dv.wide_launches = 0
attention_bwd_dqdk.wide_launches = 0


def attention_bwd_split(qkv: torch.Tensor, g: torch.Tensor, num_heads: int) -> torch.Tensor:
    """dqkv of `fused_attention` (no gate) through the two split kernels,
    [dq | dk | dv] as the JAX package's _attention_bwd_split_impl
    concatenates them. CUDA tensor: the dqdk kernel, then the dv kernel,
    each writing its slice of one dqkv buffer (one launch each, counted on
    attention_bwd_dqdk and attention_bwd_dv). CPU tensor: the plain
    versions, concatenated."""
    if qkv.device.type == "cpu":
        return torch.cat([reference_attention_bwd_dqdk(qkv, g, num_heads),
                          reference_attention_bwd_dv(qkv, g, num_heads)], dim=-1)
    if qkv.device.type != "cuda":
        raise ValueError(f"attention_bwd_split runs on cuda (kernels) or cpu (plain "
                         f"versions), not {qkv.device}")
    qkv, g, (_, _, _, dh, width) = _check_bwd_input(qkv, g, num_heads, "dqdk")
    _check_smem("dv", qkv.shape[1], width, qkv.element_size(), qkv.device.index)
    dqkv = torch.empty_like(qkv)
    stats = _bwd_stats(qkv, num_heads)  # one scratch: the two launches share a stream
    scale = logit_scale(dh)
    _launch_half("dqdk", qkv, g, num_heads, dqkv, 0, stats, scale)
    _launch_half("dv", qkv, g, num_heads, dqkv, 2 * num_heads * width, stats, scale)
    return unpad_heads(dqkv, 3, num_heads, dh, width)


_BWD = {"monolithic": attention_bwd, "split": attention_bwd_split}


@torch.library.custom_op("devit_torch::trainable_attention", mutates_args=(),
                         device_types=("cuda", "cpu"))
def _trainable_attention(qkv: torch.Tensor, num_heads: int, bwd_mode: str) -> torch.Tensor:
    """fused_attention as a dispatcher op, so that selective checkpointing
    (models/vit.py remat_policy) sees it and can save its output: the
    kernel on a CUDA tensor, the plain version on a CPU tensor, as
    fused_attention picks them. The gradient is `bwd_mode`'s backward,
    which saves only qkv and recomputes the probabilities."""
    return fused_attention(qkv, None, num_heads=num_heads)


@_trainable_attention.register_fake
def _(qkv: torch.Tensor, num_heads: int, bwd_mode: str) -> torch.Tensor:
    B, N, C3 = qkv.shape
    return qkv.new_empty((B, N, C3 // 3))


def _trainable_setup(ctx, inputs, output) -> None:
    qkv, ctx.num_heads, ctx.bwd_mode = inputs
    ctx.save_for_backward(qkv)


def _trainable_backward(ctx, g: torch.Tensor):
    (qkv,) = ctx.saved_tensors
    return _BWD[ctx.bwd_mode](qkv, g, ctx.num_heads), None, None


_trainable_attention.register_autograd(_trainable_backward, setup_context=_trainable_setup)
# the op a checkpoint policy names to save the attention output
trainable_attention_op = torch.ops.devit_torch.trainable_attention.default


def make_trainable_attention(num_heads: int, bwd_mode: Optional[str] = None):
    """Differentiable fused attention (no gate, no dropout): qkv (B, N, 3C)
    -> (B, N, C). bwd_mode "monolithic" (one backward kernel) or "split" (a
    dq/dk kernel and a dv kernel); None takes DEVIT_ATTN_BWD, default
    "monolithic", as the JAX package's make_trainable_attention does."""
    if bwd_mode is None:
        bwd_mode = os.environ.get("DEVIT_ATTN_BWD", "monolithic")
    if bwd_mode not in _BWD:
        raise ValueError(f"unknown bwd_mode {bwd_mode!r}")

    def attention(qkv: torch.Tensor) -> torch.Tensor:
        return _trainable_attention(qkv.contiguous(), num_heads, bwd_mode)

    return attention


# ---- the attention half of a compact layer (csrc/block_attention.cu)


def reference_block_attention(t: torch.Tensor, norm_scale: torch.Tensor,
                              norm_bias: torch.Tensor, qkv_kernel: torch.Tensor,
                              qkv_bias: Optional[torch.Tensor], proj_kernel: torch.Tensor,
                              proj_bias: torch.Tensor, *, num_heads: int,
                              eps: float = 1e-6) -> torch.Tensor:
    """t + proj(attention(qkv(LayerNorm(t)))), line for line as the TPU
    kernel (devit_tpu/kernels/attention.py:_block_attn_kernel) computes it:
    LayerNorm statistics in f32 whatever t's dtype; h rounded to t's dtype;
    qkv in f32 plus the bias, rounded; the per-head f32 softmax with p and o
    rounded to v's dtype; each head's o . proj[head rows] added in f32 onto
    an f32 copy of t, then proj_bias and one rounding. Not compact_forward's
    split arithmetic, which rounds after each product."""
    B, N, C = t.shape
    K = qkv_kernel.shape[1] // 3
    dh = K // num_heads
    tf = t.float()
    mu = tf.mean(dim=-1, keepdim=True)
    var = (tf - mu).square().mean(dim=-1, keepdim=True)
    h = (tf - mu) * torch.rsqrt(var + eps)
    h = (h * norm_scale.float() + norm_bias.float()).to(t.dtype)
    qkv = torch.matmul(h.float(), qkv_kernel.float())
    if qkv_bias is not None:
        qkv = qkv + qkv_bias.float()
    q, k, v = qkv.to(t.dtype).reshape(B, N, 3, num_heads, dh).permute(2, 0, 3, 1, 4)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (dh ** -0.5)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(p.float(), v.float()).to(v.dtype)  # (B, H, N, dh)
    pw = proj_kernel.float().reshape(num_heads, dh, C)
    acc = tf
    for hd in range(num_heads):
        acc = acc + torch.matmul(o[:, hd].float(), pw[hd])
    return (acc + proj_bias.float()).to(t.dtype)


def _launch_block(t, norm_scale, norm_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias,
                  num_heads: int, eps: float) -> torch.Tensor:
    B, N, C = t.shape
    threeK = qkv_kernel.shape[-1]
    if threeK % (3 * num_heads):
        raise ValueError(f"num_heads={num_heads} must divide K={threeK // 3}")
    K = threeK // 3
    dh = K // num_heads
    width = kernel_head_dim(dh)
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA block-attention kernel takes float32 or bfloat16, got {t.dtype}")
    if qkv_kernel.dtype != t.dtype or proj_kernel.dtype != t.dtype:
        raise TypeError(f"the CUDA block-attention kernel takes qkv and proj kernels of t's "
                        f"dtype {t.dtype}, got {qkv_kernel.dtype} and {proj_kernel.dtype}")
    if tuple(qkv_kernel.shape) != (C, threeK) or tuple(proj_kernel.shape) != (K, C):
        raise ValueError(f"qkv_kernel {tuple(qkv_kernel.shape)} and proj_kernel "
                         f"{tuple(proj_kernel.shape)} do not fit t {tuple(t.shape)}")
    if C % 32:
        raise ValueError(f"the CUDA block-attention kernel takes a width C that is a multiple "
                         f"of 32, got {C}")
    if not (t.is_contiguous() and qkv_kernel.is_contiguous() and proj_kernel.is_contiguous()):
        raise ValueError("the CUDA block-attention kernel needs contiguous t, qkv and proj "
                         "kernels")
    vecs = [norm_scale, norm_bias, qkv_bias, proj_bias]
    for v, n in zip(vecs, (C, C, threeK, C)):
        if v is not None and v.numel() != n:
            raise ValueError(f"a bias or LayerNorm vector has {v.numel()} values, expected {n}")
    if any(x is not None and x.device != t.device
           for x in [qkv_kernel, proj_kernel] + vecs):
        raise ValueError(f"every operand must be on {t.device}")
    _check_smem("block", N, width, t.element_size(), t.device.index)
    chunked = bool(_build.library().devit_block_attention_chunked(
        N, width, t.element_size(), t.device.index))
    if width != dh:  # zero qkv columns and proj rows per head: exact zeros in every product
        qkv_kernel = pad_heads(qkv_kernel[None], 3, num_heads, dh, width)[0]
        proj_kernel = F.pad(proj_kernel.reshape(num_heads, dh, C), (0, 0, 0, width - dh))
        proj_kernel = proj_kernel.reshape(num_heads * width, C)
        if vecs[2] is not None:
            vecs[2] = pad_heads(vecs[2].reshape(1, 1, threeK), 3, num_heads, dh, width)
    _check_aligned(t, qkv_kernel, proj_kernel)  # staged with 16-byte loads
    # the vectors too (a view may start anywhere: such a one is copied)
    ns, nb, qb, pb = (None if v is None else _aligned16(v.float().contiguous()) for v in vecs)
    out = torch.empty_like(t)
    if B == 0:
        return out
    # chunked: qkv and o of every head, (B N, 3 K) then (B N, K); else o for
    # the proj kernel
    scratch = torch.empty((B, N, (4 if chunked else 1) * num_heads * width), dtype=t.dtype,
                          device=t.device)
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream(t.device).cuda_stream
        err = _build.library().devit_block_attention(
            t.data_ptr(), ns.data_ptr(), nb.data_ptr(), qkv_kernel.data_ptr(),
            None if qb is None else qb.data_ptr(), proj_kernel.data_ptr(), pb.data_ptr(),
            scratch.data_ptr(), None, out.data_ptr(), B, N, C, num_heads, width, eps,
            _DTYPE_CODES[t.dtype], logit_scale(dh), stream)
    _build.check_launch(err, "fused_block_attention")
    fused_block_attention.launches += 1
    if chunked:
        fused_block_attention.chunked_launches += 1
    return out


def _aligned16(v: torch.Tensor) -> torch.Tensor:
    return v if v.data_ptr() % 16 == 0 else v.clone()


def fused_block_attention(t: torch.Tensor, norm_scale: torch.Tensor, norm_bias: torch.Tensor,
                          qkv_kernel: torch.Tensor, qkv_bias: Optional[torch.Tensor],
                          proj_kernel: torch.Tensor, proj_bias: torch.Tensor, *,
                          num_heads: int, eps: float = 1e-6) -> torch.Tensor:
    """t + proj(attention(qkv(LayerNorm(t)))) in one kernel: t (B, N, C),
    qkv_kernel (C, 3K) and proj_kernel (K, C) in the compact ragged layout
    (K = num_heads * head_dim). Replaces compact_forward's LN1 -> qkv ->
    attention -> proj -> residual sequence, with the TPU kernel's numerics
    (see reference_block_attention). CUDA tensor: the kernels in
    csrc/block_attention.cu (one call counted once in
    `fused_block_attention.launches`; bf16 two launches; at f32, and at
    bf16 where the whole head does not fit one block or past head_dim 128,
    three: LayerNorm + qkv, the forward's kernels, proj; those calls are
    counted in `fused_block_attention.chunked_launches` too), every product
    on the tensor cores (3xTF32 at f32), which take the two weight kernels
    in t's dtype. CPU tensor: `reference_block_attention`."""
    args = (t, norm_scale, norm_bias, qkv_kernel, qkv_bias, proj_kernel, proj_bias)
    if t.device.type == "cpu":
        return reference_block_attention(*args, num_heads=num_heads, eps=eps)
    if t.device.type != "cuda":
        raise ValueError(f"fused_block_attention runs on cuda (kernel) or cpu (plain version), "
                         f"not {t.device}")
    return _launch_block(*args, num_heads, eps)


fused_block_attention.launches = 0
fused_block_attention.chunked_launches = 0
