// The bf16 attention steps on the tensor cores that the forward kernel
// (attention.cu, attn_kernel_mma) and the block-attention kernel
// (block_attention.cu, block_qkv_attn_kernel) share: a warp's 16 query rows
// against a head's K and V in XOR-swizzled shared tiles (rows zero-filled
// to a multiple of 16; rows of DH = 32, 64 or 128 bf16, swz_dh<DH>). s =
// (q . k^T) * scale in f32 by mma.sync; the f32
// softmax over the keys with the row max and sum reduced over the 4 lanes of
// a quad; p = e / sum the IEEE quotient (div_rn), rounded to bf16; o = p . v
// in f32 by mma.sync with p straight from the registers. Past 16 * KC keys
// the keys come in chunks and s is recomputed per chunk (attend_rows).

#pragma once

#include <math.h>

#include "mma_common.cuh"

namespace devit {
namespace mma {

// s = (q . k^T) * scale for the warp's 16 query rows and the 16 * KC keys
// from c0 on (n8 tile t holds keys c0 + 8t ..), keys at or past N set to
// -inf. Key steps at or past NP are not computed (their keys are all masked).
template <int KC, int DH>
__device__ __forceinline__ void chunk_scores(float (&s)[2 * KC][4],
                                             const uint32_t (&qa)[DH / 16][4],
                                             const bf16* Ks, int c0, int N, int NP, float scale,
                                             int lane) {
#pragma unroll
  for (int j = 0; j < KC; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[2 * j][e] = s[2 * j + 1][e] = 0.f;
    const int k0 = c0 + 16 * j;
    if (k0 < NP) {
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t kb[4];  // n8 tile 2j: {kb0, kb1}; 2j + 1: {kb2, kb3}
        ldmatrix_x4(kb, Ks + swz_dh<DH>(k0 + (lane & 7) + ((lane >> 4) << 3),
                                        2 * ks + ((lane >> 3) & 1)));
        mma_bf16(s[2 * j], qa[ks], kb[0], kb[1]);
        mma_bf16(s[2 * j + 1], qa[ks], kb[2], kb[3]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t) {
    if (c0 + 8 * t + 8 <= N) {  // the whole n8 tile lies before N (warp-uniform)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] *= scale;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 8 * t + 2 * (lane & 3) + (e & 1);
        s[t][e] = col < N ? s[t][e] * scale : -INFINITY;
      }
    }
  }
}

// The lane's partial max of its two rows (row lane/4: e = 0, 1; row lane/4
// + 8: e = 2, 3) over the chunk.
template <int KC>
__device__ __forceinline__ void chunk_max(const float (&s)[2 * KC][4], float (&m)[2]) {
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t) {
    m[0] = fmaxf(m[0], fmaxf(s[t][0], s[t][1]));
    m[1] = fmaxf(m[1], fmaxf(s[t][2], s[t][3]));
  }
}

// s -> exp(s - m) in place, added to the lane's partial sums l.
template <int KC>
__device__ __forceinline__ void chunk_exp(float (&s)[2 * KC][4], const float (&m)[2],
                                          float (&l)[2]) {
#pragma unroll
  for (int t = 0; t < 2 * KC; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[t][e] = expf(s[t][e] - m[e >> 1]);
      l[e >> 1] += s[t][e];
    }
}

// o += round(e / l) . v over the chunk's keys: the rounded accumulators of
// n8 tiles 2j and 2j + 1 are the A fragment of key step j; V comes through
// ldmatrix.trans (keys are the k dimension).
template <int KC, int DH>
__device__ __forceinline__ void chunk_pv(float (&o)[DH / 8][4], const float (&s)[2 * KC][4],
                                         const float (&l)[2], const bf16* Vs, int c0, int NP,
                                         int lane) {
  const float r0 = __frcp_rn(l[0]), r1 = __frcp_rn(l[1]);
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k0 = c0 + 16 * j;
    if (k0 >= NP) continue;
    const uint32_t a[4] = {
        pack_bf16(div_rn(s[2 * j][0], l[0], r0), div_rn(s[2 * j][1], l[0], r0)),
        pack_bf16(div_rn(s[2 * j][2], l[1], r1), div_rn(s[2 * j][3], l[1], r1)),
        pack_bf16(div_rn(s[2 * j + 1][0], l[0], r0), div_rn(s[2 * j + 1][1], l[0], r0)),
        pack_bf16(div_rn(s[2 * j + 1][2], l[1], r1), div_rn(s[2 * j + 1][3], l[1], r1))};
#pragma unroll
    for (int d = 0; d < DH / 16; ++d) {
      uint32_t vb[4];  // dims 16d .. 16d + 7: {vb0, vb1}; 16d + 8 ..: {vb2, vb3}
      ldmatrix_x4_trans(vb, Vs + swz_dh<DH>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                            2 * d + (lane >> 4)));
      mma_bf16(o[2 * d], a, vb[0], vb[1]);
      mma_bf16(o[2 * d + 1], a, vb[2], vb[3]);
    }
  }
}

// The warp's 16 rows of o for the q rows whose A fragments are qa.
template <int KC, int DH>
__device__ __forceinline__ void attend_rows(float (&o)[DH / 8][4], const uint32_t (&qa)[DH / 16][4],
                                            const bf16* Ks, const bf16* Vs, int N, float scale,
                                            int lane) {
  const int NP = (N + 15) & ~15;
  constexpr int kChunk = 16 * KC;
  float s[2 * KC][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  if (NP <= kChunk) {
    chunk_scores<KC, DH>(s, qa, Ks, 0, N, NP, scale, lane);
    chunk_max<KC>(s, m);
    m[0] = devit::mma::quad_max(m[0]);
    m[1] = devit::mma::quad_max(m[1]);
    chunk_exp<KC>(s, m, l);
    l[0] = devit::mma::quad_sum(l[0]);
    l[1] = devit::mma::quad_sum(l[1]);
    chunk_pv<KC, DH>(o, s, l, Vs, 0, NP, lane);
    return;
  }
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    chunk_scores<KC, DH>(s, qa, Ks, c0, N, NP, scale, lane);
    chunk_max<KC>(s, m);
  }
  m[0] = devit::mma::quad_max(m[0]);
  m[1] = devit::mma::quad_max(m[1]);
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    chunk_scores<KC, DH>(s, qa, Ks, c0, N, NP, scale, lane);
    chunk_exp<KC>(s, m, l);
  }
  l[0] = devit::mma::quad_sum(l[0]);
  l[1] = devit::mma::quad_sum(l[1]);
  for (int c0 = 0; c0 < NP; c0 += kChunk) {
    chunk_scores<KC, DH>(s, qa, Ks, c0, N, NP, scale, lane);
    float unused[2] = {0.f, 0.f};
    chunk_exp<KC>(s, m, unused);
    chunk_pv<KC, DH>(o, s, l, Vs, c0, NP, lane);
  }
}

}  // namespace mma
}  // namespace devit
