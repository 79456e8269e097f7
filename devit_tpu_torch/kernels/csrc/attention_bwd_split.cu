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
// - f32, N <= 256: the CUDA-core steps of bwd_common.cuh (the f32 tolerance
//   is 1e-4, finer than TF32). A dv block owns (batch row, head, 64-key
//   tile) and loops over the 32-query tiles, recomputing each tile's full
//   score rows and summing its 64 keys' dv in registers (4 rows a warp); a
//   dqdk block owns a whole (batch row, head): it is the f32 monolithic
//   kernel's second pass alone (dq written per query tile, dk summed in
//   registers).
// - N > 256, or where the monolithic kernel's block would not fit shared
//   memory (use_long_path), both dtypes: the chunked long path
//   (attention_bwd_long.cu), as the monolithic wrapper routes.
// Head widths 32, 64 and 128, as the monolithic kernel (a lane owns dims l +
// 32 j in the f32 kernels; bwd_mma.cuh's template at bf16).

#include "bwd_common.cuh"
#include "bwd_mma.cuh"

namespace {

using namespace devit::bwd;

constexpr int kKeyTile = 64;                       // key rows of dv a dv block owns
constexpr int kDvRowsPerWarp = kKeyTile / kWarps;
constexpr int kMaxCPerWarp = kShortN / kWarps;     // key rows of dk a warp holds
static_assert(kKeyTile % kWarps == 0, "a key tile splits evenly over the warps");

// P [kBQ][SP] f32 | K [N][kv_stride] T | Q, G [kBQ][dh] T
template <typename T>
size_t dv_smem_bytes(int n, int dh) {
  return sizeof(float) * (size_t)kBQ * devit::score_stride(n) +
         sizeof(T) * ((size_t)n * kv_stride<T>(dh) + 2 * (size_t)kBQ * dh);
}

// dv rows [c0, c0 + kKeyTile) of one (batch row, head), summed over all N
// queries: dv[c] = sum_r round(p[r][c]) g[r].
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dv_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dv,
                   long long out_stride, int N, int H, int n_key_tiles, float scale) {
  constexpr int KS = kv_stride<T>(DH);
  constexpr int DJ = DH / 32;  // dims a lane owns

  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = devit::score_stride(N);
  float* P = reinterpret_cast<float*>(smem);  // p of the tile (f32)
  T* Ks = reinterpret_cast<T*>(P + kBQ * SP);
  T* Qs = Ks + N * KS;    // the tile's q rows, zero past N
  T* Gs = Qs + kBQ * DH;  // the tile's g rows, zero past N

  // blocks of one (batch row, head) are neighbours, so their K reads meet in L2
  const int kt = blockIdx.x % n_key_tiles;
  const int bh = blockIdx.x / n_key_tiles;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  T* obase = dv + (int64_t)b * N * out_stride + h * DH;
  const int c0 = kt * kKeyTile, c_end = min(N, c0 + kKeyTile);
  const int warp = threadIdx.x / 32;

  load_keys<T, DH>(base, Ks, nullptr, N, row3, C);
  float acc[kDvRowsPerWarp][DJ];
#pragma unroll
  for (int i = 0; i < kDvRowsPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int q0 = 0; q0 < N; q0 += kBQ) {
    const int rows = min(kBQ, N - q0);
    __syncthreads();  // the previous tile's readers of Q, G and P are done
    load_query_tile<T, DH>(base, gbase, Qs, Gs, q0, rows, row3, C);
    __syncthreads();
    rows_times_keys<T, DH>(Qs, Ks, P, N, SP, scale);
    // each warp finishes its own two rows; a lane reads only the columns it
    // wrote, so no barrier is needed between the product and this step
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r < rows) softmax_row(P + r * SP, N);  // rows past N: never read
    }
    __syncthreads();
    accumulate_keys<T, DH, true, kDvRowsPerWarp, DJ>(acc, P, Gs, c0, c_end, SP, rows);
  }
  store_keys<T, kDvRowsPerWarp, DJ>(acc, obase, out_stride, c0, c_end);
}

// dq and dk of one (batch row, head): each tile's dq rows are written as the
// tile finishes; dk, summed over all N queries, at the end.
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_dqdk_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqk,
                     long long out_stride, int N, int H, float scale) {
  constexpr int KS = kv_stride<T>(DH);
  constexpr int DJ = DH / 32;  // dims a lane owns

  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = devit::score_stride(N);
  float* P = reinterpret_cast<float*>(smem);  // p of the tile (f32)
  float* D = P + kBQ * SP;                    // dp, then ds, of the tile
  T* Ks = reinterpret_cast<T*>(D + kBQ * SP);
  T* Vs = Ks + N * KS;
  T* Qs = Vs + N * KS;
  T* Gs = Qs + kBQ * DH;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  T* obase = dqk + (int64_t)b * N * out_stride + h * DH;  // dq here, dk C further
  const int warp = threadIdx.x / 32;

  load_keys<T, DH>(base, Ks, Vs, N, row3, C);
  float acc[kMaxCPerWarp][DJ];
#pragma unroll
  for (int i = 0; i < kMaxCPerWarp; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int q0 = 0; q0 < N; q0 += kBQ) {
    const int rows = min(kBQ, N - q0);
    __syncthreads();  // the previous tile's readers of Q, G, P and D are done
    load_query_tile<T, DH>(base, gbase, Qs, Gs, q0, rows, row3, C);
    __syncthreads();
    rows_times_keys<T, DH>(Qs, Ks, P, N, SP, scale);
    rows_times_keys<T, DH>(Gs, Vs, D, N, SP, 1.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r >= rows) continue;
      softmax_row(P + r * SP, N);
      ds_row<T>(P + r * SP, D + r * SP, N, scale);
    }
    __syncthreads();
    accumulate_keys<T, DH, false, kMaxCPerWarp, DJ>(acc, D, Qs, 0, N, SP, rows);  // dk += ds^T q
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r < rows) dq_row<T, DH>(D + r * SP, Ks, obase + (int64_t)(q0 + r) * out_stride, N);
    }
  }
  store_keys<T, kMaxCPerWarp, DJ>(acc, obase + C, out_stride, 0, N);
}

template <typename T, int DH>
cudaError_t launch_dv(const void* qkv, const void* g, void* dv, long long out_stride, int B,
                      int N, int H, float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_dv_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  const int n_key_tiles = (N + kKeyTile - 1) / kKeyTile;
  attn_bwd_dv_kernel<T, DH><<<(unsigned)B * H * n_key_tiles, kThreads, dv_smem_bytes<T>(N, DH),
                              stream>>>(static_cast<const T*>(qkv), static_cast<const T*>(g),
                                        static_cast<T*>(dv), out_stride, N, H, n_key_tiles,
                                        scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dqdk(const void* qkv, const void* g, void* dqk, long long out_stride, int B,
                        int N, int H, float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_dqdk_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  if (N > kShortN) return cudaErrorInvalidValue;
  attn_bwd_dqdk_kernel<T, DH><<<(unsigned)B * H, kThreads, dqdk_smem_bytes<T>(N, DH), stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqk), out_stride, N,
      H, scale);
  return cudaGetLastError();
}

// The short-path launch of the dv (DV) or dq/dk kernel at one head width.
template <bool DV, int DH>
cudaError_t launch_short(const void* qkv, const void* g, void* out, long long out_stride, int B,
                         int N, int H, int dtype, float scale, cudaStream_t s) {
  if (dtype == 0)
    return DV ? launch_dv<float, DH>(qkv, g, out, out_stride, B, N, H, scale, s)
              : launch_dqdk<float, DH>(qkv, g, out, out_stride, B, N, H, scale, s);
  return launch_bwd_mma<!DV, DV, DH>(qkv, g, out, out_stride, B, N, H, scale, s);
}

// The dv (DV) or dq/dk kernel: the long path where use_long_path says so.
template <bool DV>
int launch_half(const void* qkv, const void* g, void* out, long long out_stride, void* stats,
                int B, int N, int H, int head_dim, int dtype, float scale, cudaStream_t s) {
  if (head_dim != 32 && head_dim != 64 && head_dim != 128) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (use_long_path(N, head_dim, dtype == 1 ? 2 : 4, devit::device_optin(dev)))
    return (int)launch_long(qkv, g, out, out_stride, static_cast<float*>(stats), B, N, H,
                            head_dim, dtype, !DV, DV, scale, s);
  if (head_dim == 32) return (int)launch_short<DV, 32>(qkv, g, out, out_stride, B, N, H, dtype,
      scale, s);
  if (head_dim == 64) return (int)launch_short<DV, 64>(qkv, g, out, out_stride, B, N, H, dtype,
      scale, s);
  return (int)launch_short<DV, 128>(qkv, g, out, out_stride, B, N, H, dtype, scale, s);
}

// Shared memory one block of the dv (DV) or dq/dk kernel needs on `device`.
long long half_smem_bytes(bool dv, int n, int dh, int elem, int device) {
  if (use_long_path(n, dh, elem, devit::device_optin(device)))
    return (long long)long_smem_bytes(dh, elem);
  if (elem == 2)
    return (long long)(dv ? mma_smem_bytes<false, true>(n, dh)
                          : mma_smem_bytes<true, false>(n, dh));
  return (long long)(dv ? dv_smem_bytes<float>(n, dh) : dqdk_smem_bytes<float>(n, dh));
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
// (0 = float32, 1 = bfloat16), head_dim 32, 64 or 128. dv: token n of batch
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
