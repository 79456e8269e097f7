// The CUDA-core steps of the attention backward, shared by the f32 monolithic
// kernel (attention_bwd.cu), the f32 split pair (attention_bwd_split.cu) and
// the path past kShortN keys at both dtypes (attention_bwd_long.cu).
//
// Every kernel that uses them runs kThreads threads and walks queries in
// kBQ-row tiles: warp w owns the tile's rows 2w and 2w + 1. K (and V) sit in
// shared memory, padded by one 32-bit word a row (kv_stride); the tile's f32
// score rows P (and D) have the odd stride score_stride(N). For each tile a
// kernel recomputes s = q k^T * scale and p = softmax(s) in f32
// (rows_times_keys, softmax_row); dp = g v^T and ds = round((p * (dp -
// rowsum(dp * p))) * scale) (rows_times_keys, ds_row); the tile's dq = ds k
// (dq_row); and adds the tile to the key-side sums dv += round(p)^T g or
// dk += ds^T q (accumulate_keys). Those sums live in registers: thread (warp
// w, lane l) owns key rows c0 + w + kWarps * i (i < NC) of dims l + 32 j (j <
// DH / 32: one dim at dh 32, two at 64, four at 128).

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace devit {
namespace bwd {

constexpr int kBQ = 32;        // query rows per tile
constexpr int kThreads = 512;  // 16 warps; warp w owns tile rows 2w and 2w+1
constexpr int kWarps = kThreads / 32;
static_assert(kBQ == 2 * kWarps, "each warp owns two rows of a tile");
// The kernels that give one block a whole (batch row, head) hold dk and dv of
// 16 key rows a warp in registers, so they take N <= kShortN; past it the
// backward walks kShortN-key chunks (attention_bwd_long.cu).
constexpr int kShortN = 16 * kWarps;

// K and V rows are padded by one 32-bit word, so that the 32 lanes of a warp
// reading one dim of 32 consecutive rows hit 32 different banks.
template <typename T> __host__ __device__ constexpr int kv_stride(int dh) {
  return dh + (int)(4 / sizeof(T));
}

// out[r][c] = scale * sum_d A[r][d] * B[c][d] for the tile's kBQ rows and the
// sequence's N columns (s = q k^T with A = Q, B = K; dp = g v^T with A = G,
// B = V). Warp w computes rows 2w, 2w+1; lane l columns c0 + l + 32 j.
template <typename T, int DH>
__device__ __forceinline__ void rows_times_keys(const T* A, const T* Bm, float* out,
                                                int N, int SP, float scale) {
  constexpr int KS = kv_stride<T>(DH);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = 2 * warp;
  for (int c0 = 0; c0 < N; c0 += 128) {
    float acc[2][4];
    int col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j] = c0 + lane + 32 * j;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float a0 = to_f(A[r0 * DH + d]), a1 = to_f(A[(r0 + 1) * DH + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bv = col[j] < N ? to_f(Bm[col[j] * KS + d]) : 0.f;
        acc[0][j] = fmaf(a0, bv, acc[0][j]);
        acc[1][j] = fmaf(a1, bv, acc[1][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col[j] < N) out[(r0 + i) * SP + col[j]] = acc[i][j] * scale;
  }
}

// Row r of P: f32 softmax in place (the unrounded p). Run by the warp that
// owns row r; lane l touches columns l + 32 k only.
__device__ __forceinline__ void softmax_row(float* row, int N) {
  const int lane = threadIdx.x % 32;
  float m = -INFINITY;
  for (int c = lane; c < N; c += 32) m = fmaxf(m, row[c]);
  m = warp_max(m);
  float sum = 0.f;
  for (int c = lane; c < N; c += 32) {
    const float e = expf(row[c] - m);
    row[c] = e;
    sum += e;
  }
  sum = warp_sum(sum);
  for (int c = lane; c < N; c += 32) row[c] = row[c] / sum;
}

// Row r of D, in place: dp -> round((p * (dp - rowsum(dp * p))) * scale),
// with the rowsum over the unrounded f32 p of prow. Run by the row's warp.
template <typename T>
__device__ __forceinline__ void ds_row(const float* prow, float* drow, int N, float scale) {
  const int lane = threadIdx.x % 32;
  float rs = 0.f;
  for (int c = lane; c < N; c += 32) rs = fmaf(drow[c], prow[c], rs);
  rs = warp_sum(rs);
  for (int c = lane; c < N; c += 32) drow[c] = round_to<T>((prow[c] * (drow[c] - rs)) * scale);
}

// One query row of dq = ds k, dims lane + 32 j, written to out.
template <typename T, int DH>
__device__ __forceinline__ void dq_row(const float* drow, const T* Ks, T* out, int N) {
  static_assert(DH % 32 == 0, "a lane owns dims l + 32 j");
  constexpr int KS = kv_stride<T>(DH);
  const int lane = threadIdx.x % 32;
  float acc[DH / 32];
#pragma unroll
  for (int j = 0; j < DH / 32; ++j) acc[j] = 0.f;
  for (int c = 0; c < N; ++c) {
    const float ds = drow[c];
#pragma unroll
    for (int j = 0; j < DH / 32; ++j) acc[j] = fmaf(ds, to_f(Ks[c * KS + lane + 32 * j]), acc[j]);
  }
#pragma unroll
  for (int j = 0; j < DH / 32; ++j) out[lane + 32 * j] = from_f<T>(acc[j]);
}

// acc[i][j] += sum_{r < rows} W[r][c] * X[r][d] for the thread's key rows
// c = c0 + warp + kWarps i (c < c_end) and dims d = lane + 32 j, j < DJ =
// DH / 32 (dv += round(p)^T g with W = P, X = G, rounding W to T; dk += ds^T
// q with W = D, X = Q). A warp reads one W value per c (a broadcast) and DJ X
// values per r.
template <typename T, int DH, bool kRoundW, int NC, int DJ>
__device__ __forceinline__ void accumulate_keys(float (&acc)[NC][DJ], const float* W,
                                                const T* X, int c0, int c_end, int SP,
                                                int rows) {
  static_assert(DJ * 32 == DH, "a lane owns dims l + 32 j");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = 0; r < rows; ++r) {
    float x[DJ];
#pragma unroll
    for (int j = 0; j < DJ; ++j) x[j] = to_f(X[r * DH + lane + 32 * j]);
    const float* wrow = W + r * SP;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int c = c0 + warp + kWarps * i;
      if (c < c_end) {
        const float w = kRoundW ? round_to<T>(wrow[c]) : wrow[c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(w, x[j], acc[i][j]);
      }
    }
  }
}

// Writes the thread's key rows of acc to out + c * stride, rounded once.
template <typename T, int NC, int DJ>
__device__ __forceinline__ void store_keys(const float (&acc)[NC][DJ], T* out, int64_t stride,
                                           int c0, int c_end) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = c0 + warp + kWarps * i;
    if (c >= c_end) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) out[(int64_t)c * stride + lane + 32 * j] = from_f<T>(acc[i][j]);
  }
}

// Rows q0 .. q0 + rows of the head's q (into Qs) and g (into Gs), zero past
// the sequence. `q` steps row3 elements a token, `g` C.
template <typename T, int DH>
__device__ __forceinline__ void load_query_tile(const T* q, const T* g, T* Qs, T* Gs, int q0,
                                                int rows, int64_t row3, int C) {
  for (int i = threadIdx.x; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const bool in = r < rows;
    Qs[i] = in ? q[(int64_t)(q0 + r) * row3 + d] : from_f<T>(0.f);
    Gs[i] = in ? g[(int64_t)(q0 + r) * C + d] : from_f<T>(0.f);
  }
}

// Loads the head's N rows of K (and V, where Vs is not null) into shared
// memory. The caller's first tile barrier orders it before any reader.
template <typename T, int DH>
__device__ __forceinline__ void load_keys(const T* q, T* Ks, T* Vs, int N, int64_t row3, int C) {
  constexpr int KS = kv_stride<T>(DH);
  for (int i = threadIdx.x; i < N * DH; i += kThreads) {
    const int n = i / DH, d = i % DH;
    const T* row = q + (int64_t)n * row3;
    Ks[n * KS + d] = row[C + d];
    if (Vs != nullptr) Vs[n * KS + d] = row[2 * C + d];
  }
}

// Shared memory of one block that holds P and D (kBQ x SP f32 each), K and
// V (N x kv_stride) and the Q and G tiles (kBQ x dh): the monolithic kernel
// and the dq/dk kernel.
template <typename T>
size_t dqdk_smem_bytes(int n, int dh) {
  return sizeof(float) * 2 * (size_t)kBQ * score_stride(n) +
         sizeof(T) * (2 * (size_t)n * kv_stride<T>(dh) + 2 * (size_t)kBQ * dh);
}

// ---- the path past kShortN keys (attention_bwd_long.cu), both dtypes

// Keys a chunk of the long path: kShortN, or 128 at dh 128 (so that an f32
// block's K and V chunk fits beside the score rows).
__host__ __device__ constexpr int long_chunk(int dh) { return dh > 64 ? 128 : kShortN; }

// Shared memory of one block of the long path (the same at every N).
size_t long_smem_bytes(int dh, int elem);

// dq and dk (dqdk) and/or dv (dv) of (B, N, 3C) qkv and (B, N, C) g, any N,
// dtype 0 = float32, 1 = bfloat16, head_dim 32, 64 or 128. Token n of batch row b writes
// from out + (b N + n) out_stride: dq there, dk C further, dv 2C further with
// dqdk and at the start without. stats: B * H * N * 3 floats of scratch (each
// row's softmax max, sum and rowsum(dp * p)).
cudaError_t launch_long(const void* qkv, const void* g, void* out, long long out_stride,
                        float* stats, int B, int N, int H, int head_dim, int dtype, bool dqdk,
                        bool dv, float scale, cudaStream_t stream);

}  // namespace bwd
}  // namespace devit
