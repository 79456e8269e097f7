// Tensor-core steps of the bf16 attention kernels past 256 keys: the forward
// attn_long_mma (attention.cu) and the backward pair attn_bwd_long_rows_mma /
// attn_bwd_long_keys_mma (attention_bwd_long.cu).
//
// A block has 4 warps (kThreads). In the forward and the rows kernel each
// warp owns 16 query rows of a 64-row tile and walks the head's keys in
// chunks of chunk_keys<DH> (64, or 32 at dh 128 so that the scores of a
// chunk and the dh-128 accumulators share a lane's registers), staged by
// cp.async into a ring of two buffers: the copy of chunk i + 1 runs while
// chunk i computes, with one block barrier a chunk. The scores of a chunk stay
// in the warp's mma accumulators; the row max and sum are kept per lane, online
// (rescaled when the lane's max grows), and reduced over the quad once the
// walk ends (finish_stats). The keys kernel streams its query tiles through the
// same ring; ring_walk holds the ring's barrier logic for all three. Every step that the row statistics go through is
// written with the _rn intrinsics, so no instantiation can contract it into
// another FMA: the kernels that compute (m, l) with and without dp (the
// monolithic backward and the dv kernel) get the same bits.

#pragma once

#include <math.h>

#include "mma_common.cuh"

namespace devit {
namespace longmma {

using mma::bf16;
using mma::ldmatrix_x4;
using mma::ldmatrix_x4_trans;
using mma::mma_bf16;
using mma::pack_bf16;
using mma::swz_dh;

constexpr int kThreads = 128;  // 4 warps
constexpr int kRows = 64;      // query rows of a tile (16 a warp); keys of a keys-kernel block

// Keys of a staged chunk (the forward, the rows kernel) and queries of a
// staged tile (the keys kernel), by head width.
template <int DH>
__host__ __device__ constexpr int chunk_keys() {
  return DH <= 64 ? 64 : 32;
}

// 4 bytes from global to shared memory, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(mma::smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

// The warp's A fragments of 16 rows (from row r0) of a swizzled [rows][DH] tile.
template <int DH>
__device__ __forceinline__ void load_a(uint32_t (&a)[DH / 16][4], const bf16* tile, int r0,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks)
    ldmatrix_x4(a[ks], tile + swz_dh<DH>(r0 + (lane & 15), 2 * ks + (lane >> 4)));
}

// s[t] = a . B^T for the 8 NT rows of the swizzled tile B from row b0 on (n8
// tile t: B rows b0 + 8t ..): the warp's 16 rows against NT * 8 rows of B,
// f32, unscaled. 16-row steps from b_end on are not multiplied (left 0).
template <int NT, int DH>
__device__ __forceinline__ void times_rows(float (&s)[NT][4], const uint32_t (&a)[DH / 16][4],
                                           const bf16* Bt, int b0, int b_end, int lane) {
  static_assert(NT % 2 == 0, "n8 tiles come in pairs (one ldmatrix_x4)");
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    if (b0 + 16 * j >= b_end) break;  // warp-uniform
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t b[4];  // n8 tile 2j: {b0, b1}; 2j + 1: {b2, b3}
      ldmatrix_x4(b, Bt + swz_dh<DH>(b0 + 16 * j + (lane & 7) + ((lane >> 4) << 3),
                                     2 * ks + ((lane >> 3) & 1)));
      mma_bf16(s[2 * j], a[ks], b[0], b[1]);
      mma_bf16(s[2 * j + 1], a[ks], b[2], b[3]);
    }
  }
}

// As times_rows, with the warp's 16 A rows read from the swizzled tile At
// (rows a0 ..) one k16 step at a time instead of held in registers.
template <int NT, int DH>
__device__ __forceinline__ void tile_times_rows(float (&s)[NT][4], const bf16* At, int a0,
                                                const bf16* Bt, int b0, int b_end, int lane) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, At + swz_dh<DH>(a0 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (b0 + 16 * j >= b_end) break;  // warp-uniform
      uint32_t b[4];
      ldmatrix_x4(b, Bt + swz_dh<DH>(b0 + 16 * j + (lane & 7) + ((lane >> 4) << 3),
                                     2 * ks + ((lane >> 3) & 1)));
      mma_bf16(s[2 * j], a, b[0], b[1]);
      mma_bf16(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}

// The A fragment of a k16 step from the f32 accumulators of n8 tiles 2j and
// 2j + 1, rounded to bf16.
template <int NT>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&x)[NT][4], int j) {
  a[0] = pack_bf16(x[2 * j][0], x[2 * j][1]);
  a[1] = pack_bf16(x[2 * j][2], x[2 * j][3]);
  a[2] = pack_bf16(x[2 * j + 1][0], x[2 * j + 1][1]);
  a[3] = pack_bf16(x[2 * j + 1][2], x[2 * j + 1][3]);
}

// o += a . V[v0 .. v0 + 15][:]: a's k16 step against 16 rows of the swizzled
// tile V (k = V's rows, through ldmatrix.trans), all DH columns.
template <int DH>
__device__ __forceinline__ void times_cols(float (&o)[DH / 8][4], const uint32_t (&a)[4],
                                           const bf16* Vt, int v0, int lane) {
#pragma unroll
  for (int d = 0; d < DH / 16; ++d) {
    uint32_t b[4];  // columns 16d ..: {b0, b1}; 16d + 8 ..: {b2, b3}
    ldmatrix_x4_trans(b, Vt + swz_dh<DH>(v0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                         2 * d + (lane >> 4)));
    mma_bf16(o[2 * d], a, b[0], b[1]);
    mma_bf16(o[2 * d + 1], a, b[2], b[3]);
  }
}

// Scores of a chunk: s *= scale, and -inf at keys at or past N (key of n8
// tile t, element e: k0 + 8t + 2(lane % 4) + (e & 1)).
template <int NT>
__device__ __forceinline__ void scale_mask(float (&s)[NT][4], int k0, int N, float scale,
                                           int lane) {
  if (k0 + 8 * NT <= N) {  // no key past N (warp-uniform)
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = __fmul_rn(s[t][e], scale);
    return;
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + 8 * t + 2 * (lane & 3) + (e & 1);
      s[t][e] = key < N ? __fmul_rn(s[t][e], scale) : -INFINITY;
    }
}

// One chunk of the online walk over the lane's two rows (row lane/4: e = 0,
// 1; row lane/4 + 8: e = 2, 3): the running max m and sum l of exp(s - m)
// and, with DP, the running sum d of dp * exp(s - m), each rescaled by
// exp(m_old - m_new) when the lane's max grows. A lane that has seen only
// masked keys keeps m = -inf and l = d = 0.
template <int NT, bool DP>
__device__ __forceinline__ void online_step(const float (&s)[NT][4], const float (&dp)[NT][4],
                                            float (&m)[2], float (&l)[2], float (&d)[2]) {
  float mn[2] = {m[0], m[1]};
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    mn[0] = fmaxf(mn[0], fmaxf(s[t][0], s[t][1]));
    mn[1] = fmaxf(mn[1], fmaxf(s[t][2], s[t][3]));
  }
  float base[2], sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) base[i] = mn[i] == -INFINITY ? 0.f : mn[i];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = expf(__fsub_rn(s[t][e], base[e >> 1]));
      sum[e >> 1] = __fadd_rn(sum[e >> 1], x);
      if (DP) dsum[e >> 1] = __fmaf_rn(dp[t][e], x, dsum[e >> 1]);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float alpha = expf(__fsub_rn(m[i], base[i]));  // 0 while m is -inf
    l[i] = __fmaf_rn(l[i], alpha, sum[i]);
    if (DP) d[i] = __fmaf_rn(d[i], alpha, dsum[i]);
    m[i] = mn[i];
  }
}

// The row statistics from the lanes' online ones: m the row max, l the sum of
// exp(s - m) over the row and, with DP, d = rowsum(dp * exp(s - m)) / l (the
// rowsum of dp * p). Every lane of the quad ends with its rows' values.
template <bool DP>
__device__ __forceinline__ void finish_stats(float (&m)[2], float (&l)[2], float (&d)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mr = mma::quad_max(m[i]);
    const float w = expf(__fsub_rn(m[i], mr));  // 0 for a lane that saw only masked keys
    l[i] = mma::quad_sum(__fmul_rn(l[i], w));
    if (DP) d[i] = __fdiv_rn(mma::quad_sum(__fmul_rn(d[i], w)), l[i]);
    m[i] = mr;
  }
}

// p = exp(s - m) / l (the IEEE quotient from rl = 1 / l: mma::div_rn).
__device__ __forceinline__ float prob(float s, float m, float l, float rl) {
  return mma::div_rn(expf(__fsub_rn(s, m)), l, rl);
}

// The ring of two buffers over `steps` steps: fetch(i) stages step i into
// buffer i & 1 with cp.async and commits one group; step i + 1's copy runs
// while step i computes, with one block barrier a step. body(i) runs on the
// warps that have rows (active) once step i has landed. Loads the caller
// committed before have landed by body(0).
template <typename Fetch, typename Body>
__device__ __forceinline__ void ring_walk(int steps, bool active, Fetch fetch, Body body) {
  fetch(0);
  for (int i = 0; i < steps; ++i) {
    mma::cp_async_wait<0>();
    __syncthreads();  // step i landed; every warp is done with step i - 1's buffer
    if (i + 1 < steps) fetch(i + 1);
    if (active) body(i);
  }
}

// The first key of step i's chunk in the forward and the rows kernel: walk 1
// takes steps 0 .. n_chunks - 1, walk 2 the next n_chunks.
template <int DH>
__device__ __forceinline__ int chunk_key0(int i, int n_chunks) {
  return (i < n_chunks ? i : i - n_chunks) * chunk_keys<DH>();
}

// fetch(i) of the forward and the rows kernel: step i's chunk of K (from
// kbase, rows row3 apart) and, with V, of V (kbase + C) into buffer i & 1 of
// the ring [2][K, V][CK][DH].
template <int DH>
__device__ __forceinline__ void fetch_chunk(bf16* ring, int i, int n_chunks, const bf16* kbase,
                                            int C, int64_t row3, int N, bool V, int tid) {
  constexpr int CK = chunk_keys<DH>();
  const int c0 = chunk_key0<DH>(i, n_chunks);
  bf16* Kb = ring + (i & 1) * 2 * CK * DH;
  mma::load_rows<DH>(Kb, kbase + (int64_t)c0 * row3, row3, CK, N - c0, tid, kThreads);
  if (V)
    mma::load_rows<DH>(Kb + CK * DH, kbase + C + (int64_t)c0 * row3, row3, CK, N - c0, tid,
                       kThreads);
  mma::cp_async_commit();
}

// Walk 1's step: the online statistics of a chunk; after the last chunk, the
// rows' (finish_stats) and rl = 1 / l.
template <int NT, bool DP>
__device__ __forceinline__ void stats_step(const float (&s)[NT][4], const float (&dp)[NT][4],
                                           float (&m)[2], float (&l)[2], float (&d)[2],
                                           float (&rl)[2], bool last) {
  online_step<NT, DP>(s, dp, m, l, d);
  if (last) {
    finish_stats<DP>(m, l, d);
    rl[0] = __frcp_rn(l[0]);
    rl[1] = __frcp_rn(l[1]);
  }
}

// Walk 2's product: acc += round(x) . Bt, x the chunk's values from key c0
// on (n8 tiles of the accumulator layout) and Bt the chunk's staged rows
// (K or V; k = keys, through ldmatrix.trans), 16 keys a step up to N.
template <int NT, int DH>
__device__ __forceinline__ void chunk_times_cols(float (&acc)[DH / 8][4], const float (&x)[NT][4],
                                                 const bf16* Bt, int c0, int N, int lane) {
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    if (c0 + 16 * j >= N) break;  // keys past N: x is 0 (warp-uniform)
    uint32_t a[4];
    pack_a<NT>(a, x, j);
    times_cols<DH>(acc, a, Bt, 16 * j, lane);
  }
}

}  // namespace longmma
}  // namespace devit
