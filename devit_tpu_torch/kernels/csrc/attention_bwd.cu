// Backward of the fused multi-head self-attention: dqkv from qkv and the
// output's gradient g.
//
// Replaces devit_tpu/kernels/attention.py:_attn_bwd_kernel (the monolithic
// Pallas backward behind make_trainable_attention). Same contract: the inputs
// are the raw (B, N, 3C) qkv, ordered [q | k | v] and head-major inside each
// third, and g of shape (B, N, C); the output dqkv has qkv's shape and dtype.
// Only qkv is saved by the forward, so the probabilities are recomputed here.
//
// Numerics follow the TPU kernel: s = (q . k^T) * dh^-0.5 and p = softmax(s)
// in f32; dv = round(p)^T g, with p rounded to v's dtype; dp = g v^T in f32;
// ds = round((p * (dp - rowsum(dp * p))) * scale), with the rowsum over the
// unrounded f32 p; dq = ds k and dk = ds^T q. Every product accumulates in
// f32 and is rounded to the input dtype once, when it is written.
//
// What bounds it on an H100: one launch reads qkv and g once and writes dqkv
// once, 7 * B * N * C elements, against about 10 * B * N^2 * C FLOPs (s, dv,
// dp, dq, dk), i.e. ~140 FLOP per byte in bf16 at N = 198: under the ~295 at
// which the tensor cores would be the limit, so the bound is memory bandwidth
// (B = 256, 6 heads: 272.5 MB, ~0.081 ms at 3.35 TB/s).
//
// bf16, N <= 256 (kShortN): dk and dv sum over all N queries of one (batch
// row, head), so one block owns a whole (batch row, head) and walks its
// queries in 32-row tiles: no two blocks write the same output, nothing is
// summed with atomics, and the result is the same on every run. K and V of
// the head stay in shared memory for the whole block; the tile's f32 s and dp
// (32 x N each) sit beside them. Past 256 keys the warps' registers cannot
// hold dk and dv of every key and a block cannot hold the rows, so the
// backward walks key chunks (attention_bwd_long.cu: a row-statistics and
// dq kernel, then a dk/dv kernel); so it does where the block would not fit
// shared memory (use_long_path in bwd_mma.cuh: dh 128 at the larger N).
//
// f32, every N: the same two kernels on the tensor cores as 3xTF32
// mma.sync.m16n8k8 (attn_bwd_long_rows_tf32, attn_bwd_long_keys_tf32; the
// source note of attention_bwd_long.cu says why three TF32 passes keep f32
// accuracy where one does not). At N 198 they ran 1.4-1.7x faster than the
// CUDA-core whole-head kernel they replaced, at every head width.
//
// Head widths 32, 64 and 128: the tensor-core kernels are templated on dh
// (see bwd_mma.cuh, long_mma.cuh, long_tf32.cuh).
//
// bf16: attn_bwd_kernel_mma<true, true> (bwd_mma.cuh), all five products on
// the tensor cores in one pass, dk and dv in the warps' accumulators. The
// split pair (attention_bwd_split.cu) runs the same template's <false, true>
// and <true, false>, so at bf16 the pair equals this kernel bit for bit. What
// bounds it: one 512-thread block an SM (dk and dv of 16 warps fill the
// register file), so the three block barriers a tile leave the SM waiting on
// the slowest warp. At B 256, kh 6 on the H100 (0.57 ms a launch), builds
// that skip one step each ran faster by 0.17 ms without the softmax/ds rows,
// 0.17 without s and dp, 0.09 without dq and 0.09 without dk/dv; the staging
// and barriers alone took 0.18 ms.

#include "bwd_common.cuh"
#include "bwd_mma.cuh"

namespace {

using namespace devit::bwd;

// Shared memory of one block at sequence length n on `device`.
long long smem_bytes(int n, int dh, int elem, int device) {
  if (use_long_path(n, dh, elem, devit::device_optin(device)))
    return (long long)long_smem_bytes(dh, elem);
  return (long long)mma_smem_bytes<true, true>(n, dh);
}

}  // namespace

extern "C" {

// Dynamic shared memory one backward block needs at sequence length n on
// `device` (the path use_long_path picks).
long long devit_attention_bwd_smem_bytes(int n, int head_dim, int elem_bytes, int device) {
  return smem_bytes(n, head_dim, elem_bytes, device);
}

// 1 when the backwards (monolithic and split alike) walk key chunks at (n,
// head_dim, elem_bytes) on `device` and so need the (B, H, N, 3) f32
// scratch, 0 when one block owns a (batch row, head).
int devit_attention_bwd_long_path(int n, int head_dim, int elem_bytes, int device) {
  return use_long_path(n, head_dim, elem_bytes, devit::device_optin(device)) ? 1 : 0;
}

// qkv: (B, N, 3*H*head_dim), g: (B, N, H*head_dim), dqkv: like qkv; all
// contiguous and of one dtype (0 = float32, 1 = bfloat16); head_dim 32, 64,
// 128 or any multiple of 64 past 128 (the long path). stats: B*H*N*3 floats of scratch, used (and needed) only where
// devit_attention_bwd_long_path says so. scale: as devit_fused_attention's.
// Returns a cudaError_t (0 = launched).
int devit_attention_bwd(const void* qkv, const void* g, void* dqkv, void* stats, int B, int N,
                        int H, int head_dim, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim <= 128 && head_dim != 32 && head_dim != 64 && head_dim != 128)
    return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  const long long row3 = 3LL * H * head_dim;
  if (use_long_path(N, head_dim, dtype == 1 ? 2 : 4, devit::device_optin(dev)))
    return (int)launch_long(qkv, g, dqkv, row3, static_cast<float*>(stats), B, N, H, head_dim,
                            dtype, true, true, scale, s);
  if (head_dim == 32) return (int)launch_bwd_mma<true, true, 32>(qkv, g, dqkv, row3, B, N, H,
      scale, s);
  if (head_dim == 64) return (int)launch_bwd_mma<true, true, 64>(qkv, g, dqkv, row3, B, N, H,
      scale, s);
  return (int)launch_bwd_mma<true, true, 128>(qkv, g, dqkv, row3, B, N, H, scale, s);
}

}  // extern "C"
