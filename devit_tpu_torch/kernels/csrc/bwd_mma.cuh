// The bf16 attention backward on the tensor cores, one template for the
// monolithic kernel (attention_bwd.cu) and the split pair
// (attention_bwd_split.cu): attn_bwd_kernel_mma<DQDK, DV>.
//
// <true, true> is the monolithic kernel (dq, dk and dv); <false, true> the
// dv kernel (s and round(p) only: no V, dp or ds); <true, false> the dq/dk
// kernel (no dv product and no dv accumulators). Each instantiation runs the
// same steps on the same operands in the same order, so the pair's outputs
// equal the monolithic kernel's bit for bit.
//
// Numerics (the TPU kernels'): s = (q . k^T) * dh^-0.5 and p = softmax(s) in
// f32; dv = round(p)^T g with p rounded to bf16; dp = g v^T in f32; ds =
// round((p * (dp - rowsum(dp * p))) * scale) with the rowsum over the
// unrounded p; dq = ds k, dk = ds^T q. Every product accumulates in f32 on
// mma.sync.m16n8k16 and is rounded once, when it is written.
//
// One block owns a whole (batch row, head), N <= kShortN, 16 warps, and walks
// its queries in 32-row tiles: dk and dv sum over all queries, and warp w
// keeps them for key rows 16w .. 16w + 15 in its accumulators (32 f32
// registers a lane each) for the whole block, so one pass suffices, no two
// blocks write the same output and nothing is summed with atomics. K (and V)
// and the tiles' q and g rows are staged with 16-byte cp.async into
// XOR-swizzled tiles, the next tile's q and g arriving while the current one
// computes. For each query tile: s = Q K^T (and dp = G V^T) by mma, 16 x 16
// blocks dealt to the warps; the f32 softmax (and ds) rows (softmax_ds_rows:
// softmax_row's and ds_row's arithmetic, each lane holding its columns of two
// rows in registers); round(p) (and ds) stored as bf16 tiles (rows padded by
// 16 bytes, so ldmatrix has no bank conflicts; zero past N); the tile's
// dq = ds K by mma (K through ldmatrix.trans), written once; and dv +=
// round(p)^T G (and dk += ds^T Q) by mma with A through ldmatrix.trans of the
// bf16 tiles.
//
// Head widths 32, 64 and 128 (DH). Warp w's dk and dv accumulators hold 16
// keys x 64 dims (16 x 32 at dh 32); at dh 128 the 16 x 128 of both would
// take 128 registers a lane, the whole budget of a 512-thread block, so the
// block walks its queries twice, each pass summing dk and dv for one 64-dim
// half (s, p, dp and ds recomputed; dq written in the first pass only).
// Where the monolithic kernel's tiles do not fit shared memory (dh 128 past
// N 208), every backward wrapper takes the chunked path of
// attention_bwd_long.cu instead (use_long_path), as it does at f32, so the
// split pair still equals the monolithic kernel bit for bit.
//
// Every instantiation keeps one 512-thread block an SM: the dv kernel with
// __launch_bounds__(512, 2) (two blocks, ~84 KB of shared memory each at N
// 198) got 64 registers, spilled 144 bytes and ran no faster on the H100
// (0.0770 against 0.0753 ms a launch at B 64, kh 6).

#pragma once

#include "bwd_common.cuh"
#include "mma_common.cuh"

namespace {

using devit::bwd::kBQ;
using devit::bwd::kShortN;
using devit::bwd::kThreads;
using devit::bwd::kWarps;
using devit::mma::bf16;
using devit::mma::div_rn;
using devit::mma::ldmatrix_x2_trans;
using devit::mma::ldmatrix_x4;
using devit::mma::ldmatrix_x4_trans;
using devit::mma::mma_bf16;
using devit::mma::pack_bf16;
using devit::mma::store_rows;
using devit::mma::swz_dh;

static_assert(kBQ == 32 && kWarps == 16, "the tile steps below deal 32-row tiles to 16 warps");
constexpr int kCols = kShortN / 32;  // columns a lane holds of one row

// s (and dp) f32 [kBQ][NP + 8] | K (and V) [NP][dh] | two q, g buffers
// [2][2][kBQ][dh] | round(p) (DV) and ds (DQDK) bf16 [kBQ][NP + 8], NP = n
// rounded up to 16.
template <bool DQDK, bool DV>
size_t mma_smem_bytes(int n, int dh) {
  const size_t np = (size_t)((n + 15) & ~15), row = np + 8;
  const size_t mats = DQDK ? 2 : 1, bf16_tiles = (DQDK ? 1 : 0) + (DV ? 1 : 0);
  return sizeof(float) * mats * kBQ * row +
         2 * (mats * np * dh + 4 * (size_t)kBQ * dh + bf16_tiles * kBQ * row);
}

// Whether every backward (the monolithic kernel and both split kernels) walks
// key chunks (attention_bwd_long.cu) at (n, dh, elem bytes) on a device that
// lets a block opt in to `optin` bytes of shared memory: at f32 (the 3xTF32
// pair), past kShortN keys, where a bf16 block of the monolithic kernel would
// not fit, and at every head width past 128. One rule for all three keeps the
// split pair bit for bit equal to the monolithic kernel.
inline bool use_long_path(int n, int dh, int elem, long long optin) {
  if (n > kShortN || dh > 128 || elem == 4) return true;  // f32: the 3xTF32 pair at every N
  return (long long)mma_smem_bytes<true, true>(n, dh) > optin;
}

// Tile rows r0 .. r0 + R - 1: s (in P) -> round(p) into Pb (DV) and, with
// dp (in D), ds into Sb (DS), bf16, zero past N and in rows past the
// sequence, with the arithmetic of an f32 softmax row and its ds row: row
// max, expf, sum, the IEEE quotient (div_rn), the fmaf rowsum over the
// unrounded p, ds = round((p (dp - rs)) scale). Lane l holds the column pairs
// 2l + 64k in registers (float2 loads, bf16x2 stores); R rows go through at
// once for independent chains. p comes out with the same bits whatever DS and
// DV are.
template <int R, bool DS, bool DV>
__device__ __forceinline__ void softmax_ds_rows(const float* P, const float* D, bf16* Pb,
                                                bf16* Sb, int r0, int rows, int N, int NP,
                                                int SP, int PB, float scale, int lane) {
  constexpr int kPairs = kCols / 2;
  float x[R][kPairs][2], y[R][kPairs][2], m[R], sum[R], rs[R], rsum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    sum[i] = rs[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int c = 2 * lane + 64 * k;
      // dp is loaded beside s, before x is formed: in that order <true, true>
      // compiles to the same SASS as the monolithic kernel did before it
      // became a template. (Loading it after x cut ptxas's spill from 48 to
      // 4 bytes and ran ~4% faster at B 256, kh 6 on the H100: left for a
      // redesign of that kernel.)
      const float2 sv = c < NP ? *reinterpret_cast<const float2*>(P + (r0 + i) * SP + c)
                               : make_float2(0.f, 0.f);
      float2 dv = make_float2(0.f, 0.f);
      if (DS && c < NP) dv = *reinterpret_cast<const float2*>(D + (r0 + i) * SP + c);
      x[i][k][0] = c < N ? sv.x : -INFINITY;
      x[i][k][1] = c + 1 < N ? sv.y : -INFINITY;
      if (DS) {
        y[i][k][0] = dv.x;
        y[i][k][1] = dv.y;
      }
      m[i] = fmaxf(m[i], fmaxf(x[i][k][0], x[i][k][1]));
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = devit::warp_max(m[i]);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[i][k][j] = expf(x[i][k][j] - m[i]);  // 0 past N
        sum[i] += x[i][k][j];
      }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    sum[i] = devit::warp_sum(sum[i]);
    rsum[i] = __frcp_rn(sum[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[i][k][j] = div_rn(x[i][k][j], sum[i], rsum[i]);  // the unrounded f32 p
        if (DS) rs[i] = fmaf(y[i][k][j], x[i][k][j], rs[i]);
      }
  if (DS) {
#pragma unroll
    for (int i = 0; i < R; ++i) rs[i] = devit::warp_sum(rs[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float keep = r0 + i < rows ? 1.f : 0.f;  // rows past the sequence: zero
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int c = 2 * lane + 64 * k;
      if (c >= NP) continue;
      const float p0 = keep * x[i][k][0], p1 = keep * x[i][k][1];
      if (DV) *reinterpret_cast<uint32_t*>(Pb + (r0 + i) * PB + c) = pack_bf16(p0, p1);
      if (DS)
        *reinterpret_cast<uint32_t*>(Sb + (r0 + i) * PB + c) =
            pack_bf16((p0 * (y[i][k][0] - rs[i])) * scale, (p1 * (y[i][k][1] - rs[i])) * scale);
    }
  }
}

// dq rows 16 mi .. 16 mi + 15, dims 8 nt .. 8 nt + 7 of the tile = ds K, by
// mma with K through ldmatrix.trans; two accumulators (even and odd key
// steps) for independent mma chains; written rounded to out (the tile's first
// row), rows before `rows`.
template <int DH>
__device__ __forceinline__ void dq_tile(const bf16* Sb, const bf16* Ks, bf16* out,
                                        int64_t ostride, int mi, int nt, int rows, int NP,
                                        int PB, int lane) {
  float acc[2][4] = {};
  const bf16* arow = Sb + (16 * mi + (lane & 15)) * PB + ((lane >> 4) << 3);
  const int krow = (lane & 7) + (((lane >> 3) & 1) << 3);
  for (int k0 = 0; k0 < NP; k0 += 32) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (j == 1 && k0 + 16 >= NP) break;
      uint32_t a[4], kb[2];
      ldmatrix_x4(a, arow + k0 + 16 * j);
      ldmatrix_x2_trans(kb, Ks + swz_dh<DH>(k0 + 16 * j + krow, nt));
      mma_bf16(acc[j], a, kb[0], kb[1]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[0][e] += acc[1][e];
  store_rows(acc[0], out, ostride, 16 * mi, rows, 8 * nt, lane);
}

// One block: (batch row, head), 16 warps, 32-query tiles, the next tile's q
// and g rows arriving (cp.async) while the current tile computes. Warp w
// keeps dk and/or dv of key rows 16w .. 16w + 15 in its accumulators (at dh
// 128 for one 64-dim half a pass). Token n of batch row b writes from out +
// (b N + n) out_stride + h dh: dq there, dk C further (DQDK), dv 2C further
// with DQDK and at the start without.
template <bool DQDK, bool DV, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                    bf16* __restrict__ out, long long out_stride, int N, int H, float scale) {
  static_assert(DQDK || DV, "an instantiation computes dq/dk, dv or both");
  constexpr int kDA = DH < 64 ? DH : 64;     // dims of dk and dv a pass sums
  constexpr int kPasses = DH / kDA;          // 2 at dh 128
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = (N + 15) & ~15;
  const int SP = NP + 8;  // f32 row: 8 mod 16 words, so float2 stores of 4 rows miss no bank
  const int PB = NP + 8;  // bf16 row: an odd number of 16-byte chunks
  float* P = reinterpret_cast<float*>(smem);  // s of the tile (f32)
  float* D = P + kBQ * SP;                    // dp of the tile (f32; DQDK)
  bf16* Ks = reinterpret_cast<bf16*>(D + (DQDK ? kBQ * SP : 0));
  bf16* Vs = Ks + NP * DH;                    // DQDK
  bf16* QG = Vs + (DQDK ? NP * DH : 0);       // two buffers of the tile's q and g rows, zero past N
  bf16* Pb = QG + 4 * kBQ * DH;               // round(p) [kBQ][PB] (DV)
  bf16* Sb = Pb + (DV ? kBQ * PB : 0);        // ds [kBQ][PB] (DQDK)

  const int C = H * DH;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t row3 = 3LL * C;
  // the monolithic kernel writes dqkv in qkv's layout
  const int64_t ostride = DQDK && DV ? row3 : (int64_t)out_stride;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  const bf16* gbase = g + (int64_t)b * N * C + h * DH;
  bf16* obase = out + (int64_t)b * N * ostride + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  auto load_tile = [&](int q0, bf16* dst) {
    const int rows = min(kBQ, N - q0);
    devit::mma::load_rows<DH>(dst, base + (int64_t)q0 * row3, row3, kBQ, rows, tid, kThreads);
    devit::mma::load_rows<DH>(dst + kBQ * DH, gbase + (int64_t)q0 * C, C, kBQ, rows, tid,
                              kThreads);
  };
  devit::mma::load_rows<DH>(Ks, base + C, row3, NP, N, tid, kThreads);
  if (DQDK) devit::mma::load_rows<DH>(Vs, base + 2 * C, row3, NP, N, tid, kThreads);
  load_tile(0, QG);

  constexpr int kDT = DH / 8;                // n8 tiles of a head row (dq's jobs)
  const int kr = 16 * warp;  // the warp's key rows of dk and dv
  const int nb = NP / 16;    // 16-key blocks
  const int n_tiles = (N + kBQ - 1) / kBQ;  // query tiles a pass (the q, g buffer in turn)
  for (int pass = 0; pass < kPasses; ++pass) {
    float dk[kDA / 8][4], dv[kDA / 8][4];
#pragma unroll
    for (int t = 0; t < kDA / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

    for (int q0 = 0, it = pass * n_tiles; q0 < N; q0 += kBQ, ++it) {
      const int rows = min(kBQ, N - q0);
      bf16* Qs = QG + (it & 1) * 2 * kBQ * DH;
      bf16* Gs = Qs + kBQ * DH;
      devit::mma::cp_async_wait_all();
      __syncthreads();  // this tile's q, g landed; the previous tile's readers are done
      if (q0 + kBQ < N) load_tile(q0 + kBQ, QG + ((it + 1) & 1) * 2 * kBQ * DH);
      else if (pass + 1 < kPasses) load_tile(0, QG + ((it + 1) & 1) * 2 * kBQ * DH);

      // s = q k^T * scale into P (and dp = g v^T into D): 16 x 16 blocks
      // (which, query half mi, key block nj) dealt to the warps
      for (int job = warp; job < (DQDK ? 4 : 2) * nb; job += kWarps) {
        const int which = job / (2 * nb), mi = (job / nb) & 1, nj = job % nb;
        const bf16* A = which ? Gs : Qs;
        const bf16* Bm = which ? Vs : Ks;
        float* dst = which ? D : P;
        const float sc = which ? 1.f : scale;
        float acc[2][4] = {};
#pragma unroll
        for (int ks = 0; ks < DH / 16; ++ks) {
          uint32_t a[4], kb[4];
          ldmatrix_x4(a, A + swz_dh<DH>(16 * mi + (lane & 15), 2 * ks + (lane >> 4)));
          ldmatrix_x4(kb, Bm + swz_dh<DH>(16 * nj + (lane & 7) + ((lane >> 4) << 3),
                                          2 * ks + ((lane >> 3) & 1)));
          mma_bf16(acc[0], a, kb[0], kb[1]);
          mma_bf16(acc[1], a, kb[2], kb[3]);
        }
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = 16 * mi + (lane >> 2) + 8 * half;
            const int c = 16 * nj + 8 * t + 2 * (lane & 3);
            *reinterpret_cast<float2*>(dst + r * SP + c) =
                make_float2(acc[t][2 * half] * sc, acc[t][2 * half + 1] * sc);
          }
      }
      __syncthreads();

      // the f32 softmax (and ds) rows (warp w: rows 2w, 2w + 1) into bf16 tiles
      softmax_ds_rows<2, DQDK, DV>(P, D, Pb, Sb, 2 * warp, rows, N, NP, SP, PB, scale, lane);
      __syncthreads();

      // the tile's dq = ds k (first pass): dq_tile jobs of 16 rows x 8 dims
      if (DQDK && pass == 0) {
        if constexpr (2 * kDT == kWarps) {
          // dh 64: one job a warp, written out here: through dq_tile the
          // monolithic and dq/dk kernels compile to other SASS (the same bits)
          const int mi = warp >> 3, nt = warp & 7;
          float acc[2][4] = {};
          const bf16* arow = Sb + (16 * mi + (lane & 15)) * PB + ((lane >> 4) << 3);
          const int krow = (lane & 7) + (((lane >> 3) & 1) << 3);
          for (int k0 = 0; k0 < NP; k0 += 32) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (j == 1 && k0 + 16 >= NP) break;
              uint32_t a[4], kb[2];
              ldmatrix_x4(a, arow + k0 + 16 * j);
              ldmatrix_x2_trans(kb, Ks + swz_dh<DH>(k0 + 16 * j + krow, nt));
              mma_bf16(acc[j], a, kb[0], kb[1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[0][e] += acc[1][e];
          store_rows(acc[0], obase + (int64_t)q0 * ostride, ostride, 16 * mi, rows, 8 * nt, lane);
        } else {
          bf16* qout = obase + (int64_t)q0 * ostride;
          for (int job = warp; job < 2 * kDT; job += kWarps)
            dq_tile<DH>(Sb, Ks, qout, ostride, job / kDT, job % kDT, rows, NP, PB, lane);
        }
      }

      // dv += round(p)^T g and dk += ds^T q for the warp's 16 keys and the
      // pass's dims: A through ldmatrix.trans of the bf16 tiles, B (g, q)
      // through ldmatrix.trans
      if (kr < NP) {
#pragma unroll
        for (int ks = 0; ks < kBQ / 16; ++ks) {
          uint32_t ap[4], as[4];
          const int qrow = 16 * ks + (lane & 7) + ((lane >> 4) << 3);
          const int kcol = kr + (((lane >> 3) & 1) << 3);
          if (DV) ldmatrix_x4_trans(ap, Pb + qrow * PB + kcol);
          if (DQDK) ldmatrix_x4_trans(as, Sb + qrow * PB + kcol);
#pragma unroll
          for (int d = 0; d < kDA / 16; ++d) {
            uint32_t gb[4], qb[4];
            const int off = swz_dh<DH>(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                       2 * (d + pass * (kDA / 16)) + (lane >> 4));
            if (DV) ldmatrix_x4_trans(gb, Gs + off);
            if (DQDK) ldmatrix_x4_trans(qb, Qs + off);
            if (DV) {
              mma_bf16(dv[2 * d], ap, gb[0], gb[1]);
              mma_bf16(dv[2 * d + 1], ap, gb[2], gb[3]);
            }
            if (DQDK) {
              mma_bf16(dk[2 * d], as, qb[0], qb[1]);
              mma_bf16(dk[2 * d + 1], as, qb[2], qb[3]);
            }
          }
        }
      }
    }

    // dk and dv of the warp's keys and the pass's dims, rounded once
#pragma unroll
    for (int t = 0; t < kDA / 8; ++t) {
      const int d0 = 8 * t + pass * kDA;
      if (DQDK) store_rows(dk[t], obase + C + kr * ostride, ostride, 0, N - kr, d0, lane);
      if (DV)
        store_rows(dv[t], obase + (DQDK ? 2 * C : 0) + kr * ostride, ostride, 0, N - kr, d0,
                   lane);
    }
  }
}

// Launches attn_bwd_kernel_mma<DQDK, DV, DH> over B x H blocks (the short
// path: use_long_path is false).
template <bool DQDK, bool DV, int DH>
cudaError_t launch_bwd_mma(const void* qkv, const void* g, void* out, long long out_stride,
                           int B, int N, int H, float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err =
      devit::opt_in_smem((const void*)attn_bwd_kernel_mma<DQDK, DV, DH>, opted_in);
  if (err != cudaSuccess) return err;
  if (N > kShortN) return cudaErrorInvalidValue;
  attn_bwd_kernel_mma<DQDK, DV, DH><<<(unsigned)B * H, kThreads,
                                      mma_smem_bytes<DQDK, DV>(N, DH), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(out),
      out_stride, N, H, scale);
  return cudaGetLastError();
}

}  // namespace
