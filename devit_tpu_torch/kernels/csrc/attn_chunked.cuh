// The CUDA-core steps of the key-chunked attention paths that take any head
// width and any sequence length, at both dtypes: the forward
// (attention.cu, attn_chunked_kernel) where the whole-row f32 design does
// not fit shared memory or the head is wider than 128, the backward past
// 128 head dims (attention_bwd_long.cu, attn_wide_bwd_rows/_keys), and the
// attention step of the block half's chunked route (block_attention.cu).
//
// Nothing here holds a whole head row: a block takes a kT-row query tile
// (or a kT-key chunk) and walks the other side in kT-key (or kT-query)
// chunks; each score product walks the head's dims kD at a time, staging
// both operands' pieces in shared memory, so shared memory and registers do
// not grow with N or dh. An output (o, dq, dk or dv) is produced kT dims at
// a time, one piece a block: the blocks of the other pieces recompute the
// scores. So s is computed three times (forward: max, sum, p . v) for each
// output piece, which is what bounds these paths; they are the "right, not
// fast" route, timed in chip_smoke.py's [attn-long].
//
// Numerics are the TPU kernels': every product bf16 x bf16 (or f32 x f32)
// is exact in f32 and summed in f32; s = (q . k^T) * scale in f32; the exact
// two-pass softmax (the row max over all keys, then the sum of exp(s - m),
// then p = exp(s - m) / sum, the IEEE quotient) with p rounded to v's dtype
// before p . v; each output rounded once. A score is recomputed in the same
// order each time, so the passes see the same bits.
//
// Thread (ty = tid / 16, tx = tid % 16) of kThreads owns the tile's rows 4 ty
// + i and its columns (keys, or dims of a piece) tx + 16 j, i, j < 4; a row's
// 16 lanes are one half of a warp, so row reductions shuffle within it.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace devit {
namespace chunked {

constexpr int kT = 64;           // query rows a tile, keys a chunk, dims an output piece
constexpr int kD = 32;           // head dims a score product stages at a time
constexpr int kThreads = 256;    // 16 row groups x 16 column lanes
constexpr int kStride = kT + 1;  // a staged row, padded against bank conflicts

// Bytes of the two staged operand pieces of a score product ([kD][kStride]
// each), of an f32 tile and of a T tile ([kT][kStride]).
template <typename T> __host__ __device__ constexpr size_t stage_bytes() {
  return 2 * sizeof(T) * kD * kStride;
}
__host__ __device__ constexpr size_t f32_tile_bytes() { return sizeof(float) * kT * kStride; }
template <typename T> __host__ __device__ constexpr size_t tile_bytes() {
  return sizeof(T) * kT * kStride;
}

// max and sum over the 16 lanes of a row (xor offsets < 16 stay in the half
// warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[d][r] = src[r * stride + d0 + d] for r < rows and d0 + d < dh, else 0:
// a kT-row, kD-dim piece, transposed.
template <typename T>
__device__ __forceinline__ void stage_piece(T* dst, const T* src, int64_t stride, int rows,
                                            int d0, int dh) {
  for (int i = threadIdx.x; i < kT * kD; i += kThreads) {
    const int r = i / kD, d = i % kD;
    const bool in = r < rows && d0 + d < dh;
    dst[d * kStride + r] = in ? src[(int64_t)r * stride + d0 + d] : from_f<T>(0.f);
  }
}

// dst[r][e] = src[r * stride + e0 + e] for r < rows and e0 + e < dh, else 0:
// kT rows of the output piece's dims.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int64_t stride, int rows,
                                           int e0, int dh) {
  for (int i = threadIdx.x; i < kT * kT; i += kThreads) {
    const int r = i / kT, e = i % kT;
    const bool in = r < rows && e0 + e < dh;
    dst[r * kStride + e] = in ? src[(int64_t)r * stride + e0 + e] : from_f<T>(0.f);
  }
}

// acc[i][j] = sum_d a[4 ty + i][d] b[tx + 16 j][d] over the head's dh dims:
// rows of `a` (a_rows of them, row stride a_stride) against rows of `b`;
// rows past a_rows or b_rows count as zeros. As and Bs are the staging
// pieces; it begins with a barrier, so the caller need not order its own
// earlier readers of As and Bs, but must not reuse them before its next one.
template <typename T>
__device__ __forceinline__ void scores(float (&acc)[4][4], const T* a, int64_t a_stride,
                                       int a_rows, const T* b, int64_t b_stride, int b_rows,
                                       int dh, T* As, T* Bs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d0 = 0; d0 < dh; d0 += kD) {
    __syncthreads();  // the previous piece's readers are done
    stage_piece(As, a, a_stride, a_rows, d0, dh);
    stage_piece(Bs, b, b_stride, b_rows, d0, dh);
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = to_f(As[d * kStride + 4 * ty + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = to_f(Bs[d * kStride + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The tile row a thread's i-th row is.
__device__ __forceinline__ int row_of(int i) { return 4 * (threadIdx.x / 16) + i; }

// acc[i][j] += sum_c W[4 ty + i][c] X[c][tx + 16 j] over the tile's kT
// columns: o += p . v, dq += ds . k (W a row-major f32 tile, X T rows).
template <typename T>
__device__ __forceinline__ void rows_times(float (&acc)[4][4], const float* W, const T* X) {
  const int tx = threadIdx.x % 16;
#pragma unroll 4
  for (int c = 0; c < kT; ++c) {
    float w[4], x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) w[i] = W[row_of(i) * kStride + c];
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = to_f(X[c * kStride + tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r W[r][4 ty + i] X[r][tx + 16 j] over the tile's kT rows
// (W rounded to T first with kRound): dv += round(p)^T g, dk += ds^T q.
template <typename T, bool kRound>
__device__ __forceinline__ void cols_times(float (&acc)[4][4], const float* W, const T* X) {
  const int tx = threadIdx.x % 16;
#pragma unroll 4
  for (int r = 0; r < kT; ++r) {
    float w[4], x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = W[r * kStride + row_of(i)];
      w[i] = kRound ? round_to<T>(v) : v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) x[j] = to_f(X[r * kStride + tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(w[i], x[j], acc[i][j]);
  }
}

// Writes acc rounded to T: row 4 ty + i of the tile at out + row * stride,
// dims e0 + tx + 16 j, rows before `rows`, dims before dh.
template <typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[4][4], T* out, int64_t stride,
                                           int rows, int e0, int dh) {
  const int tx = threadIdx.x % 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row_of(i) >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = e0 + tx + 16 * j;
      if (e < dh) out[(int64_t)row_of(i) * stride + e] = from_f<T>(acc[i][j]);
    }
  }
}

// The row max m[i] of the tile's rows over all N keys (keys at c0 + tx + 16
// j of each kT chunk), then their sums l[i] of exp(s - m): the first two
// passes of every chunked kernel. q: the tile's first q row; k: the head's
// first k row; both step row3 a token.
template <typename T>
__device__ __forceinline__ void row_stats(float (&m)[4], float (&l)[4], const T* q, int rows,
                                          const T* k, int64_t row3, int N, int dh, float scale,
                                          T* As, T* Bs) {
  const int tx = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;
  for (int c0 = 0; c0 < N; c0 += kT) {
    scores(acc, q, row3, rows, k + (int64_t)c0 * row3, row3, N - c0, dh, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + tx + 16 * j < N) m[i] = fmaxf(m[i], acc[i][j] * scale);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = row_max(m[i]);
  for (int c0 = 0; c0 < N; c0 += kT) {
    scores(acc, q, row3, rows, k + (int64_t)c0 * row3, row3, N - c0, dh, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + tx + 16 * j < N) l[i] += expf(acc[i][j] * scale - m[i]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) l[i] = row_sum(l[i]);
}

}  // namespace chunked
}  // namespace devit
