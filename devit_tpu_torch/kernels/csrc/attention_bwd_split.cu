// Split backward of the fused multi-head self-attention: dv in one kernel,
// dq and dk in another, from qkv and the output's gradient g.
//
// Replaces devit_tpu/kernels/attention.py:_attn_bwd_dv_kernel and
// _attn_bwd_dqdk_kernel (the pair _attention_bwd_split_impl launches when
// DEVIT_ATTN_BWD=split). Same contract: qkv is the raw (B, N, 3C) input,
// ordered [q | k | v] and head-major inside each third, g is (B, N, C); the
// dv kernel writes dv (C wide a token), the dqdk kernel [dq | dk] (2C wide).
// Each writes through a row stride, so the two can fill their slices of one
// (B, N, 3C) dqkv buffer: the same function as the TPU code's
// concatenate([dqk, dv], -1).
//
// Numerics follow the two TPU kernels: s = (q . k^T) * dh^-0.5 and p =
// softmax(s) in f32; dv = round(p)^T g with p rounded to qkv's dtype; dp =
// g v^T in f32, ds = round((p * (dp - rowsum(dp * p))) * scale) over the
// unrounded p, dq = ds k, dk = ds^T q. Every product accumulates in f32 and
// is rounded once, when it is written. Each kernel runs the monolithic
// kernel's (attention_bwd.cu) steps on the same operands in the same order,
// at bf16 and at f32 alike, so the pair equals the monolithic kernel bit for
// bit at both dtypes. As in the JAX design, s is computed in both kernels.
//
// What bounds them on an H100: the dv kernel reads q, k (2C) and g (C) and
// writes dv (C) a token, 4 * B * N * C elements, against 4 * B * N^2 * C
// FLOPs (s, dv); the dqdk kernel reads qkv and g (4C) and writes dq, dk (2C),
// 6 * B * N * C elements, against 8 * B * N^2 * C FLOPs (s, dp, dq, dk). Both
// are under the ~295 FLOP per byte at which bf16 tensor cores would be the
// limit, so memory bandwidth bounds them; chip_smoke.py prints both.
//
// Each output has one writer and nothing is summed with atomics, so the
// results are the same on every run. By dtype and length:
// - bf16, N <= 256: attn_bwd_kernel_mma<false, true> (dv) and <true, false>
//   (dq/dk) from bwd_mma.cuh, on the tensor cores, one block a (batch row,
//   head): the dv kernel computes s by mma once and round(p) with the
//   monolithic kernel's softmax row step, and sums dv in the warps'
//   accumulators; it stages neither V nor dp nor ds. The dq/dk kernel is the
//   monolithic kernel without the dv product and its accumulators.
// - f32 at every N, bf16 past 256 keys or where the monolithic kernel's
//   block would not fit shared memory (use_long_path): the chunked long path
//   (attention_bwd_long.cu, on the tensor cores at dh <= 128), as the
//   monolithic wrapper routes.
// Head widths 32, 64 and 128, as the monolithic kernel.

#include "bwd_common.cuh"
#include "bwd_mma.cuh"

namespace {

using namespace devit::bwd;

// The dv (DV) or dq/dk kernel: the long path where use_long_path says so.
template <bool DV>
int launch_half(const void* qkv, const void* g, void* out, long long out_stride, void* stats,
                int B, int N, int H, int head_dim, int dtype, float scale, cudaStream_t s) {
  if (head_dim <= 128 && head_dim != 32 && head_dim != 64 && head_dim != 128)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (use_long_path(N, head_dim, dtype == 1 ? 2 : 4, devit::device_optin(dev)))
    return (int)launch_long(qkv, g, out, out_stride, static_cast<float*>(stats), B, N, H,
                            head_dim, dtype, !DV, DV, scale, s);
  // bf16 to 256 keys: the monolithic template's dv or dq/dk instantiation
  if (head_dim == 32)
    return (int)launch_bwd_mma<!DV, DV, 32>(qkv, g, out, out_stride, B, N, H, scale, s);
  if (head_dim == 64)
    return (int)launch_bwd_mma<!DV, DV, 64>(qkv, g, out, out_stride, B, N, H, scale, s);
  return (int)launch_bwd_mma<!DV, DV, 128>(qkv, g, out, out_stride, B, N, H, scale, s);
}

// Shared memory one block of the dv (DV) or dq/dk kernel needs on `device`.
long long half_smem_bytes(bool dv, int n, int dh, int elem, int device) {
  if (use_long_path(n, dh, elem, devit::device_optin(device)))
    return (long long)long_smem_bytes(dh, elem);
  return (long long)(dv ? mma_smem_bytes<false, true>(n, dh) : mma_smem_bytes<true, false>(n, dh));
}

}  // namespace

extern "C" {

// Dynamic shared memory one dv block needs at sequence length n on `device`.
long long devit_attention_bwd_dv_smem_bytes(int n, int head_dim, int elem_bytes, int device) {
  return half_smem_bytes(true, n, head_dim, elem_bytes, device);
}

// Dynamic shared memory one dqdk block needs at sequence length n on `device`.
long long devit_attention_bwd_dqdk_smem_bytes(int n, int head_dim, int elem_bytes, int device) {
  return half_smem_bytes(false, n, head_dim, elem_bytes, device);
}

// qkv: (B, N, 3*H*head_dim), g: (B, N, H*head_dim), contiguous, one dtype
// (0 = float32, 1 = bfloat16), head_dim 32, 64, 128 or any multiple of 64 past 128.
// dv: token n of batch
// row b starts at dv + (b * N + n) * out_stride and takes H*head_dim
// elements. stats: B*H*N*3 floats of scratch, used (and needed) only where
// devit_attention_bwd_long_path says so. scale: as devit_fused_attention's.
// Returns a cudaError_t (0 = launched).
int devit_attention_bwd_dv(const void* qkv, const void* g, void* dv, long long out_stride,
                           void* stats, int B, int N, int H, int head_dim, int dtype,
                           float scale, void* stream) {
  return launch_half<true>(qkv, g, dv, out_stride, stats, B, N, H, head_dim, dtype,
                           scale, static_cast<cudaStream_t>(stream));
}

// As devit_attention_bwd_dv, writing [dq | dk] (2*H*head_dim elements from
// dqk + (b * N + n) * out_stride).
int devit_attention_bwd_dqdk(const void* qkv, const void* g, void* dqk, long long out_stride,
                             void* stats, int B, int N, int H, int head_dim, int dtype,
                             float scale, void* stream) {
  return launch_half<false>(qkv, g, dqk, out_stride, stats, B, N, H, head_dim, dtype,
                            scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
