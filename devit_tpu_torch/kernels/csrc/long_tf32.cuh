// Tensor-core steps of the f32 attention kernels: the forward attn_long_tf32
// (attention.cu) and the backward pair attn_bwd_long_rows_tf32 /
// attn_bwd_long_keys_tf32 (attention_bwd_long.cu), every product as 3xTF32
// mma.sync.m16n8k8 (mma_3xtf32 in mma_common.cuh) with f32 accumulators.
//
// The blocks are long_mma.cuh's, 4 warps with chunks of keys (or queries)
// through ring_walk's two cp.async buffers, and so are the row statistics of
// the backward (online_step, finish_stats, stats_step, prob: every step
// through the _rn intrinsics, so the instantiations with and without dp get
// the same bits). What differs at f32:
// - Tiles. An f32 row of DH values is padded to DH + 4 (one 16-byte chunk):
//   eight rows of one 16-byte column hit eight bank groups, so ldmatrix reads
//   A fragments (rows g, g + 8 at k t, t + 4) and the B fragments of a
//   product whose B columns are the tile's rows without conflicts; and 32-bit
//   loads of rows 2t and 2t + 1 at column g hit 32 banks (8t + g + const).
// - Operands in registers. The A fragment of a product whose A is an
//   accumulator (p . v, ds . k, p^T . g, ds^T . q) is (c0, c2, c1, c3) of an
//   n8 tile: the mma's k slots t and t + 4 then hold the tile's columns 2t
//   and 2t + 1. The sum over k does not care which k slot holds which key, so
//   B takes the same order: b0, b1 = rows 2t, 2t + 1 of the staged tile at
//   column g, two 32-bit loads (ldmatrix.trans moves 16-bit elements and
//   cannot transpose f32). No shuffle, no trip through shared memory.
// - Splits. Every operand is split into (big, small) TF32 halves in registers
//   where it is read (five instructions an element); three passes per
//   product, the small terms first, in one order in every instantiation
//   (the keys kernel's transposed products in the mirrored order).
//   What bounds these kernels is the instructions a warp issues, not the
//   tensor cores: the splits, the loads and their addresses, the softmax. So
//   a warp owns MT m16 tiles of rows (kernels' choice): each B element, read
//   and split once, serves MT products. Splitting the staged chunks once in
//   shared memory instead (a block-wide pass, big and small tiles) ran
//   slower on the H100: twice the shared-memory reads, a second barrier.

#pragma once

#include <math.h>

#include "long_mma.cuh"
#include "mma_common.cuh"

namespace devit {
namespace longtf32 {

using longmma::kThreads;
using mma::ldmatrix_x4;
using mma::mma_3xtf32;
using mma::split4;
using mma::split_tf32;

// Row stride of a staged f32 tile: DH values and one 16-byte pad.
template <int DH>
__host__ __device__ constexpr int stride() {
  return DH + 4;
}

// Offset (in floats) of 16-byte chunk c (4 f32) of row r.
template <int DH>
__device__ __forceinline__ int off(int r, int c) {
  return r * stride<DH>() + 4 * c;
}

// Keys of a staged chunk (the forward, the rows kernel) and queries of a
// staged tile (the keys kernel), by head width: each buffer of the ring
// holds two [chunk][DH + 4] f32 tiles.
template <int DH>
__host__ __device__ constexpr int chunk_keys() {
  return DH == 32 ? 64 : DH == 64 ? 32 : 16;
}

// Floats of one staged [rows][DH + 4] tile.
template <int DH>
__host__ __device__ constexpr int tile_floats(int rows) {
  return rows * stride<DH>();
}

// Rows [0, rows) of a DH-wide f32 head slice (row r at src + r * stride,
// 16-byte aligned) into the padded tile dst by 16-byte cp.async, rows at or
// past `valid` zero-filled. Issued by threads tid, tid + nthreads, ...
template <int DH>
__device__ __forceinline__ void load_rows(float* dst, const float* src, int64_t row_stride,
                                          int rows, int valid, int tid, int nthreads) {
  constexpr int kChunks = DH / 4;
  for (int i = tid; i < rows * kChunks; i += nthreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid;
    mma::cp_async16(dst + off<DH>(r, c), ok ? src + (int64_t)r * row_stride + 4 * c : src, ok);
  }
}

// s[m][t] = A . B^T: the warp's MT m16 tiles of tile At (rows a0 + 16m ..)
// against the NT * 8 rows of tile Bt from row b0 (n8 tile t: B rows b0 + 8t
// ..), f32, unscaled. 16-row steps from b_end on are not multiplied (left 0).
// Each A fragment is read and split once per k8 step and serves the NT n8
// tiles; each B fragment serves the MT m16 tiles. Transposed (the keys
// kernel's k q^T and v g^T against the rows kernel's q k^T and g v^T), the
// products add their small terms in mma_3xtf32's other order and so give
// the rows kernel's bits: at N 1 ds is then exactly 0, as the plain version's.
template <int MT, int NT, int DH, bool Transposed = false>
__device__ __forceinline__ void times_rows(float (&s)[MT][NT][4], const float* At, int a0,
                                           const float* Bt, int b0, int b_end, int lane) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs (one ldmatrix_x4)");
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[m][t][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 8; ++ks) {
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      uint32_t a[4];
      ldmatrix_x4(a, At + off<DH>(a0 + 16 * m + (lane & 15), 2 * ks + (lane >> 4)));
      split4(a, ab[m], as[m]);
    }
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (b0 + 16 * j >= b_end) break;  // warp-uniform
      uint32_t b[4], bb[4], bs[4];  // n8 tile 2j: {b0, b1}; 2j + 1: {b2, b3}
      ldmatrix_x4(b, Bt + off<DH>(b0 + 16 * j + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1)));
      split4(b, bb, bs);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma_3xtf32<Transposed>(s[m][2 * j], ab[m], as[m], bb[0], bb[1], bs[0], bs[1]);
        mma_3xtf32<Transposed>(s[m][2 * j + 1], ab[m], as[m], bb[2], bb[3], bs[2], bs[3]);
      }
    }
  }
}

// The A fragment, split, of the k8 step over n8 tile t of the accumulators
// x: (c0, c2, c1, c3), so k slot t' holds column 2t' and slot t' + 4 column
// 2t' + 1 of the tile.
template <int NT>
__device__ __forceinline__ void acc_a(uint32_t (&ab)[4], uint32_t (&as)[4],
                                      const float (&x)[NT][4], int t) {
  const uint32_t a[4] = {__float_as_uint(x[t][0]), __float_as_uint(x[t][2]),
                         __float_as_uint(x[t][1]), __float_as_uint(x[t][3])};
  split4(a, ab, as);
}

// acc[m] += x[m] . T for the chunk's values x from key (or query) c0 on (n8
// tiles of the accumulator layout, MT m16 tiles) and T the chunk's staged
// rows Tt, 8 rows a step up to n (past it x is 0): k = T's rows in acc_a's
// order, b0, b1 = rows 2t, 2t + 1 at column g, split once for the MT tiles.
// These sums run over every key (or query), N / 8 k8 steps. The tensor
// core's own f32 sums lose more than round-to-nearest would: fed one
// accumulator for all of them, the outputs strayed from the f32 reference in
// proportion to N (1.4e-5 at N 1026 on the H100, against SDPA's 2.6e-6). So
// each k8 step's three passes start from zero and are added to acc by an
// f32 add (__fadd_rn): 3.0e-6 at N 1026, for 5-7% of the time.
template <int MT, int NT, int DH>
__device__ __forceinline__ void chunk_times_cols(float (&acc)[MT][DH / 8][4],
                                                 const float (&x)[MT][NT][4], const float* Tt,
                                                 int c0, int n, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    if (c0 + 8 * t >= n) break;  // warp-uniform
    uint32_t ab[MT][4], as[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) acc_a<NT>(ab[m], as[m], x[m], t);
    const uint32_t* row = reinterpret_cast<const uint32_t*>(Tt) +
                          (8 * t + 2 * (lane & 3)) * stride<DH>() + (lane >> 2);
#pragma unroll
    for (int d = 0; d < DH / 8; ++d) {
      uint32_t bb0, bs0, bb1, bs1;
      split_tf32(row[8 * d], bb0, bs0);
      split_tf32(row[stride<DH>() + 8 * d], bb1, bs1);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};  // this k8 step's three passes, apart
        mma_3xtf32(part, ab[m], as[m], bb0, bb1, bs0, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][d][e] = __fadd_rn(acc[m][d][e], part[e]);
      }
    }
  }
}

// One chunk of the forward's single walk over the lane's two rows (row
// lane/4: e = 0, 1; row lane/4 + 8: e = 2, 3): the running row max m, taken
// over the quad so that the four lanes of a row rescale its o alike; s ->
// exp(s - m) in place; the lane's running sum l of it; o and l rescaled by
// exp(m_old - m) (0 on the first chunk, where m_old is -inf). The first
// chunk holds key 0, so m is finite from it on.
template <int NT, int DH>
__device__ __forceinline__ void softmax_step(float (&s)[NT][4], float (&m)[2], float (&l)[2],
                                             float (&o)[DH / 8][4]) {
  float mn[2] = {m[0], m[1]}, alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    mn[0] = fmaxf(mn[0], fmaxf(s[t][0], s[t][1]));
    mn[1] = fmaxf(mn[1], fmaxf(s[t][2], s[t][3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mn[i] = mma::quad_max(mn[i]);
    alpha[i] = expf(__fsub_rn(m[i], mn[i]));
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = expf(__fsub_rn(s[t][e], mn[e >> 1]));
      sum[e >> 1] = __fadd_rn(sum[e >> 1], s[t][e]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = __fmaf_rn(l[i], alpha[i], sum[i]);
    m[i] = mn[i];
  }
#pragma unroll
  for (int d = 0; d < DH / 8; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[d][e] = __fmul_rn(o[d][e], alpha[e >> 1]);
}

// fetch(i) of the rows kernel: step i's chunk (key c0) of K (from kbase,
// rows row3 apart) and, with V, of V (kbase + C) into buffer i & 1 of the
// ring [2][K, V][CK][DH + 4].
template <int DH>
__device__ __forceinline__ void fetch_chunk(float* ring, int i, int c0, const float* kbase,
                                            int C, int64_t row3, int N, bool V, int tid) {
  constexpr int CK = chunk_keys<DH>();
  float* Kb = ring + (i & 1) * 2 * tile_floats<DH>(CK);
  load_rows<DH>(Kb, kbase + (int64_t)c0 * row3, row3, CK, N - c0, tid, kThreads);
  if (V)
    load_rows<DH>(Kb + tile_floats<DH>(CK), kbase + C + (int64_t)c0 * row3, row3, CK, N - c0,
                  tid, kThreads);
  mma::cp_async_commit();
}

// Writes the lane's two rows of m16n8 accumulators (rows r0 + lane/4 and + 8,
// columns 8d + 2(lane % 4) and + 1) to rows out + row * stride that lie
// before `rows`, 8 bytes a store.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 8][4], float* out,
                                           int64_t row_stride, int r0, int rows, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + 8 * half;
    if (r >= rows) continue;
    float* dst = out + (int64_t)r * row_stride + 2 * (lane & 3);
#pragma unroll
    for (int d = 0; d < DH / 8; ++d)
      *reinterpret_cast<float2*>(dst + 8 * d) = make_float2(acc[d][2 * half], acc[d][2 * half + 1]);
  }
}

}  // namespace longtf32
}  // namespace devit
