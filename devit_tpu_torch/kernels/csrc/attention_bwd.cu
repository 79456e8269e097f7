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
// N <= 256 (kShortN), both dtypes: dk and dv sum over all N queries of one
// (batch row, head), so one block owns a whole (batch row, head) and walks its
// queries in 32-row tiles: no two blocks write the same output, nothing is
// summed with atomics, and the result is the same on every run. K and V of
// the head stay in shared memory for the whole block; the tile's f32 s and dp
// (32 x N each) sit beside them. Past 256 keys the warps' registers cannot
// hold dk and dv of every key and a block cannot hold the rows, so the
// backward walks key chunks (attention_bwd_long.cu: a row-statistics and
// dq kernel, then a dk/dv kernel); so it does where the block would not fit
// shared memory (use_long_path in bwd_mma.cuh: dh 128 at the larger N).
//
// Head widths 32, 64 and 128: the tensor-core kernel is templated on dh (see
// bwd_mma.cuh); in the f32 kernel a lane owns dims l + 32 j, j < dh / 32.
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
//
// f32 (attn_bwd_kernel): the PR-1 design on the CUDA cores, kept because the
// f32 tolerance is 1e-4 and a TF32 mma keeps ~10 mantissa bits of each
// operand, too few. Thread (warp w, lane l) holds dk or dv of key rows
// c = w + 16 i, dims l and l + 32; holding both would double those
// registers, so the block makes two passes over the query tiles: pass 1
// recomputes p and sums dv; pass 2 recomputes p, forms dp and ds, writes each
// tile's dq and sums dk. Its steps live in bwd_common.cuh, shared with the
// f32 split kernels, which run the two passes as two kernels, so at f32 too
// the split pair equals this kernel bit for bit. The passes stay one loop
// here: written as two inlined functions they ran 5% slower on the H100 (4.55
// against 4.31 ms at B 256, bf16, before the tensor-core path).

#include "bwd_common.cuh"
#include "bwd_mma.cuh"

namespace {

using namespace devit::bwd;

constexpr int kMaxCPerWarp = kShortN / kWarps;  // key rows of dk/dv a warp holds

// Shared memory of one block at sequence length n on `device`.
long long smem_bytes(int n, int dh, int elem, int device) {
  if (use_long_path(n, dh, elem, devit::device_optin(device)))
    return (long long)long_smem_bytes(dh, elem);
  return (long long)(elem == 2 ? mma_smem_bytes<true, true>(n, dh)
                               : dqdk_smem_bytes<float>(n, dh));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                int N, int H, float scale) {
  constexpr int KS = kv_stride<T>(DH);
  constexpr int DJ = DH / 32;  // dims a lane owns

  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = devit::score_stride(N);
  float* P = reinterpret_cast<float*>(smem);  // p of the tile (f32)
  float* D = P + kBQ * SP;                    // dp, then ds, of the tile
  T* Ks = reinterpret_cast<T*>(D + kBQ * SP);
  T* Vs = Ks + N * KS;
  T* Qs = Vs + N * KS;    // the tile's q rows, zero past N
  T* Gs = Qs + kBQ * DH;  // the tile's g rows, zero past N

  const int C = H * DH;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  T* obase = dqkv + (int64_t)b * N * row3 + h * DH;

  load_keys<T, DH>(base, Ks, Vs, N, row3, C);
  const int warp = threadIdx.x / 32;
  for (int pass = 0; pass < 2; ++pass) {
    float acc[kMaxCPerWarp][DJ];  // dv (pass 1), then dk (pass 2)
#pragma unroll
    for (int i = 0; i < kMaxCPerWarp; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    for (int q0 = 0; q0 < N; q0 += kBQ) {
      const int rows = min(kBQ, N - q0);
      __syncthreads();  // the previous tile's readers of Q, G, P, D are done
      load_query_tile<T, DH>(base, gbase, Qs, Gs, q0, rows, row3, C);
      __syncthreads();
      rows_times_keys<T, DH>(Qs, Ks, P, N, SP, scale);
      if (pass == 1) rows_times_keys<T, DH>(Gs, Vs, D, N, SP, 1.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r >= rows) continue;  // rows past N: never read below
        softmax_row(P + r * SP, N);
        if (pass == 1) ds_row<T>(P + r * SP, D + r * SP, N, scale);
      }
      __syncthreads();
      if (pass == 0) {
        accumulate_keys<T, DH, true, kMaxCPerWarp, DJ>(acc, P, Gs, 0, N, SP, rows);  // dv
        continue;
      }
      accumulate_keys<T, DH, false, kMaxCPerWarp, DJ>(acc, D, Qs, 0, N, SP, rows);  // dk
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r < rows) dq_row<T, DH>(D + r * SP, Ks, obase + (int64_t)(q0 + r) * row3, N);
      }
    }
    store_keys<T, kMaxCPerWarp, DJ>(acc, obase + (pass == 0 ? 2 : 1) * C, row3, 0, N);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, int B, int N, int H,
                   float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  if (N > kShortN) return cudaErrorInvalidValue;
  attn_bwd_kernel<T, DH><<<(unsigned)B * H, kThreads, dqdk_smem_bytes<T>(N, DH), stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv), N, H,
      scale);
  return cudaGetLastError();
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
// 128 or any width past 128 (the long path). stats: B*H*N*3 floats of scratch, used (and needed) only where
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
  if (dtype == 0) {
    if (head_dim == 32) return (int)launch<float, 32>(qkv, g, dqkv, B, N, H, scale, s);
    if (head_dim == 64) return (int)launch<float, 64>(qkv, g, dqkv, B, N, H, scale, s);
    return (int)launch<float, 128>(qkv, g, dqkv, B, N, H, scale, s);
  }
  if (head_dim == 32) return (int)launch_bwd_mma<true, true, 32>(qkv, g, dqkv, row3, B, N, H,
      scale, s);
  if (head_dim == 64) return (int)launch_bwd_mma<true, true, 64>(qkv, g, dqkv, row3, B, N, H,
      scale, s);
  return (int)launch_bwd_mma<true, true, 128>(qkv, g, dqkv, row3, B, N, H, scale, s);
}

}  // extern "C"
