// The chunked attention backward: what the monolithic kernel
// (attention_bwd.cu) and the split pair (attention_bwd_split.cu) launch at
// f32 at every N, and at bf16 when N > kShortN (256) (and at dh 128 from N
// 209, where the monolithic block does not fit: use_long_path).
//
// Replaces, for long sequences and at f32, devit_tpu/kernels/attention.py:
// _attn_bwd_kernel and the split pair _attn_bwd_dv_kernel /
// _attn_bwd_dqdk_kernel, which hold whole rows and so take any N. Numerics
// follow the TPU kernels: s = (q . k^T) * dh^-0.5 and p = softmax(s) in f32,
// dv = round(p)^T g with p rounded to the input dtype after it is normalised
// by the row's sum, dp = g v^T in f32, ds = round((p * (dp - rowsum(dp *
// p))) * scale) over the unrounded p, dq = ds k, dk = ds^T q; every product
// accumulates in f32 and is rounded once.
//
// Why a second design: a short-path block owns a whole (batch row, head), and
// its softmax needs the whole score row. Past 256 keys a block cannot hold
// the score rows beside K and V, nor a warp's registers dk and dv of every
// key. So the long path is two kernels, which is what gives every output one
// writer without atomics: a rows kernel writes each row's (m, l, delta) to
// the caller's (B, H, N, 3) f32 scratch and its dq; a keys kernel, one block
// a key chunk, sums dk and dv of its keys over every query from those
// statistics. The monolithic backward is rows<DQ> + keys<DK, DV>, the dv
// kernel rows + keys<DV>, the dq/dk kernel rows<DQ> + keys<DK>: each output
// comes from the same instantiation's arithmetic in either mode, so the pair
// equals the monolithic backward bit for bit, and repeat launches are
// bit-identical.
//
// bf16, dh 32, 64 and 128 (attn_bwd_long_rows_mma, attn_bwd_long_keys_mma,
// with the tensor-core steps of long_mma.cuh): every product on
// mma.sync.m16n8k16, 4-warp blocks.
// 1. Rows: a block takes a (batch row, head, 64-query tile), a warp 16 rows,
//    q and g held as A fragments. The key chunks (64 keys, 32 at dh 128)
//    come through a ring of two cp.async buffers, one barrier a chunk. Walk 1
//    computes s = q k^T and dp = g v^T a chunk at a time and keeps the row's
//    max, sum and rowsum(dp * e) online per lane (rescaled as the max grows;
//    delta = that rowsum / l), reduced over the quad at the end. Walk 2 (DQ)
//    recomputes s and dp, forms ds and packs it straight from the
//    accumulators into the A fragments of dq += ds k (K through
//    ldmatrix.trans). Two walks where the CUDA-core design took four.
// 2. Keys: a block takes a (batch row, head, 64-key chunk), the chunk's K
//    and V resident, a warp 16 keys. Query tiles (64, 32 at dh 128), their g
//    rows and their statistics stream through a ring of two buffers. s^T = k
//    q^T and dp^T = v g^T come out with keys as rows, so round(p)^T and ds^T
//    pack straight into the A fragments of dv += round(p)^T g and dk += ds^T
//    q (g and q through ldmatrix.trans): no trip through shared memory. A
//    warp's dk and dv stay in its accumulators and are written once.
// The online (m, l, delta) sum in another order than the short path's row
// reductions, so this path no longer equals the N <= 256 kernels bit for
// bit (the bf16 tolerance holds); it runs only where they do not. The
// statistics go through the _rn intrinsics (long_mma.cuh), so rows<true>
// and rows<false> give (m, l) the same bits. What bounds it: at B 64, N 578,
// kh 6 the bound is the operations (0.083 ms at 989 TFLOP/s); the design
// runs nine products where the minimum is five (s twice and dp twice for
// the statistics and dq, again in the keys kernel) and three expf a score,
// at 12 warps an SM (168 registers a thread, 3 blocks at dh <= 64, 2 at dh
// 128); the rows<true> and keys<true, true> launches took 1.17 ms together
// on the H100, 1.05-1.08 with a path without the key and query masks for
// whole chunks. Launch bounds of two blocks an SM ran at 1.25 ms (206
// registers), of four at 1.41 (128 registers, spills), two for the rows
// kernel and three for the keys kernel at 1.17.
//
// f32, dh 32, 64 and 128 (attn_bwd_long_rows_tf32, attn_bwd_long_keys_tf32,
// with the steps of long_tf32.cuh): the bf16 pair's walks, blocks and
// statistics with every product as 3xTF32 mma.sync.m16n8k8. One TF32 pass
// keeps 11 significant bits of each operand, too few for the f32 tolerance
// of 1e-4 (a numpy emulation of one pass misses the f32 reference by ~1e-3);
// three passes (small big + big small + big big of each operand's TF32 split)
// drop only the small small term, ~2^-22 of each product, and stay at f32
// accuracy (the sums over every key or query, dq, dk and dv, add each k8
// step to their accumulators in f32: long_tf32.cuh chunk_times_cols). ds is
// not rounded at f32, and p^T and ds^T become A fragments straight from the
// accumulators (long_tf32.cuh acc_a). A warp owns two m16
// tiles at dh 64 (128 rows or keys a block, two blocks an SM), one at dh 32
// and 128. What bounds it on the H100: not the tensor cores (0.498 ms at 165
// TFLOP/s, three TF32 passes at 495, for the monolithic backward at B 64, N
// 578, kh 6, against ~3.7 ms) but the instructions a warp issues: nine
// products where five would do, each operand split where it is read, and
// three expf and a division a score. It replaced, past 256 keys, a CUDA-core
// pair that took 13.07 ms there, and below them the whole-head CUDA-core
// kernels.
//
// Head widths past 128 (attn_bwd_wide_rows_mma, attn_bwd_wide_keys_mma), both
// dtypes, on the tensor cores (steps in wide.cuh): the wrapper pads the head
// to W, a multiple of 64. A lane cannot own an output row of W dims, nor a
// block a tile and two chunks of W-wide rows at every W, so the pair above
// is written over head pieces and output slabs: every score product (s, dp;
// s^T, dp^T) walks the head 64 dims (bf16) or 32 dims (f32) at a time
// through the ring, both operands' pieces staged each step, and each output
// is made in slabs (dq 128 dims; dk and dv 64, 128 in the split pair), a
// block's slabs one after the other. The rows kernel takes its statistics in walk 0 and writes them
// once, then one walk a dq slab; the keys kernel one walk a slab. The
// numerics and the fragment steps are the pairs' above (pack_a and
// ldmatrix.trans at bf16, acc_a and the Transposed 3xTF32 order at f32), so
// the split pair stays bit for bit the monolithic backward. They replaced
// key-chunked CUDA-core kernels (attn_chunked.cuh), which took 63.88 ms
// (bf16) and 53.94 ms (f32) for the monolithic backward at B 64, N 578, kh
// 4, dh 192.

#include <algorithm>
#include <type_traits>

#include "bwd_common.cuh"
#include "long_mma.cuh"
#include "long_tf32.cuh"
#include "wide.cuh"

namespace {

using namespace devit::bwd;

// ---- bf16 at head widths 32, 64 and 128: the tensor-core pair (long_mma.cuh)

namespace lm = devit::longmma;
using devit::mma::bf16;

// The rows kernel: the q and g tiles [2][64][dh] | two buffers of a K and a V
// chunk [2][2][chunk_keys][dh], bf16.
template <int DH>
constexpr size_t rows_mma_smem_bytes() {
  return (size_t)2 * DH * (2 * lm::kRows + 4 * lm::chunk_keys<DH>());
}

// The keys kernel: the chunk's K and V [2][64][dh] | two buffers of a q and a
// g tile [2][2][chunk_keys][dh], bf16, and of its rows' statistics
// [2][chunk_keys][3], f32.
template <int DH>
constexpr size_t keys_mma_smem_bytes() {
  return (size_t)2 * DH * (2 * lm::kRows + 4 * lm::chunk_keys<DH>()) +
         sizeof(float) * 2 * 3 * lm::chunk_keys<DH>();
}

size_t long_mma_smem_bytes(int dh) {
  const size_t r = dh == 32 ? rows_mma_smem_bytes<32>()
                   : dh == 64 ? rows_mma_smem_bytes<64>() : rows_mma_smem_bytes<128>();
  const size_t k = dh == 32 ? keys_mma_smem_bytes<32>()
                   : dh == 64 ? keys_mma_smem_bytes<64>() : keys_mma_smem_bytes<128>();
  return r > k ? r : k;
}

// Block (batch row, head, 64-query tile), 4 warps of 16 rows: the rows' (m,
// l) and, with DQ, delta and dq. q and g stay in registers as A fragments;
// the key chunks come through the ring. Walk 1 (every chunk): s = q k^T
// (and, with DQ, dp = g v^T) by mma, the online (m, l) and rowsum(dp * e)
// (online_step); then the statistics go to stats[(bh N + n) 3 + {0, 1, 2}]
// (delta 0 without DQ). Walk 2 (DQ): s and dp again, p = exp(s - m) / l, ds =
// round((p (dp - delta)) scale) packed straight into the A fragments of dq +=
// ds k (K through ldmatrix.trans); dq written once. rows<false> runs walk 1 as
// rows<true> does, so (m, l) have the same bits in both.
template <int DH, bool DQ>
__global__ void __launch_bounds__(lm::kThreads, DH == 128 ? 2 : 3)
attn_bwd_long_rows_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                       bf16* __restrict__ dq, long long out_stride, float* __restrict__ stats,
                       int N, int H, int n_tiles, float scale) {
  constexpr int CK = lm::chunk_keys<DH>(), NT = CK / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Gs = Qs + lm::kRows * DH;
  bf16* ring = Gs + lm::kRows * DH;  // buffer i & 1: K chunk, then V chunk

  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * lm::kRows, r0 = 16 * warp;
  const bool active = q0 + r0 < N;
  const int n_chunks = (N + CK - 1) / CK;

  devit::mma::load_rows<DH>(Qs, base + (int64_t)q0 * row3, row3, lm::kRows, N - q0, tid,
                            lm::kThreads);
  if (DQ)
    devit::mma::load_rows<DH>(Gs, g + ((int64_t)b * N + q0) * C + h * DH, C, lm::kRows, N - q0,
                              tid, lm::kThreads);
  uint32_t qa[DH / 16][4], ga[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f}, rl[2];
  float acc[DH / 8][4];
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[t][e] = 0.f;
  // step i: chunk i % n_chunks, K (and V with DQ) into buffer i & 1
  lm::ring_walk(
      DQ ? 2 * n_chunks : n_chunks, active,
      [&](int i) { lm::fetch_chunk<DH>(ring, i, n_chunks, base + C, C, row3, N, DQ, tid); },
      [&](int i) {
        if (i == 0) {
          lm::load_a<DH>(qa, Qs, r0, lane);
          if (DQ) lm::load_a<DH>(ga, Gs, r0, lane);
        }
        const bf16* Kb = ring + (i & 1) * 2 * CK * DH;
        const int c0 = lm::chunk_key0<DH>(i, n_chunks);
        float s[NT][4], dp[NT][4];
        lm::times_rows<NT, DH>(s, qa, Kb, 0, N - c0, lane);
        lm::scale_mask<NT>(s, c0, N, scale, lane);
        if (DQ) lm::times_rows<NT, DH>(dp, ga, Kb + CK * DH, 0, N - c0, lane);
        if (i < n_chunks) {
          lm::stats_step<NT, DQ>(s, dp, m, l, dl, rl, i == n_chunks - 1);
          return;
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = lm::prob(s[t][e], m[r], l[r], rl[r]);
            s[t][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[t][e], dl[r])), scale);  // ds
          }
        lm::chunk_times_cols<NT, DH>(acc, s, Kb, c0, N, lane);
      });
  if (!active) return;
  if (DQ) {
    bf16* qout = dq + ((int64_t)b * N + q0) * out_stride + h * DH;
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
      devit::mma::store_rows(acc[t], qout, out_stride, r0, N - q0, 8 * t, lane);
  }
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int n = q0 + r0 + (lane >> 2) + 8 * i;
      if (n >= N) continue;
      float* st = stats + ((int64_t)bh * N + n) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = DQ ? dl[i] : 0.f;
    }
  }
}

// Block (batch row, head, 64-key chunk), 4 warps of 16 keys: dk (DK) and dv
// (DV) of the chunk's keys, summed over every query. The chunk's K (and V)
// stay resident, the warp's 16 keys as A fragments (in registers up to dh 64,
// read again at dh 128); the query tiles, their g rows and their statistics
// come through the ring. For each 32 queries: s^T = k q^T (and dp^T = v g^T)
// by mma, keys as rows and queries as columns; p = exp(s - m) / l and ds =
// round((p (dp - delta)) scale) from the columns' statistics (0 for queries
// at or past N); then dv += round(p)^T g and dk += ds^T q by mma, with
// round(p)^T and ds^T packed straight from the accumulators into A fragments
// and g, q through ldmatrix.trans. Each warp's dk and dv stay in its
// accumulators and are written once. Every instantiation runs these steps on
// the same operands in the same order, so the split pair equals the
// monolithic <true, true> bit for bit.
template <int DH, bool DK, bool DV>
__global__ void __launch_bounds__(lm::kThreads, DH == 128 ? 2 : 3)
attn_bwd_long_keys_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                       bf16* __restrict__ out, long long out_stride,
                       const float* __restrict__ stats, int N, int H, int n_chunks, float scale) {
  static_assert(DK || DV, "an instantiation computes dk, dv or both");
  constexpr int QT = lm::chunk_keys<DH>();  // queries of a staged tile
  constexpr bool kHold = DH <= 64;          // the key fragments held in registers
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + lm::kRows * DH;
  bf16* ring = Vs + lm::kRows * DH;  // buffer i & 1: q tile, then g tile
  float* St = reinterpret_cast<float*>(ring + 4 * QT * DH);  // [2][QT][3]

  const int chunk = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  const bf16* gbase = g + (int64_t)b * N * C + h * DH;
  const float* sbase = stats + (int64_t)bh * N * 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = chunk * lm::kRows, len = min(lm::kRows, N - c0), kr = 16 * warp;
  const bool active = kr < len;
  const int n_tiles = (N + QT - 1) / QT;

  auto fetch = [&](int i) {
    const int t0 = i * QT;
    bf16* Qb = ring + (i & 1) * 2 * QT * DH;
    devit::mma::load_rows<DH>(Qb, base + (int64_t)t0 * row3, row3, QT, N - t0, tid,
                              lm::kThreads);
    devit::mma::load_rows<DH>(Qb + QT * DH, gbase + (int64_t)t0 * C, C, QT, N - t0, tid,
                              lm::kThreads);
    float* sb = St + (i & 1) * 3 * QT;
    for (int k = tid; k < 3 * QT; k += lm::kThreads) {
      const bool ok = t0 + k / 3 < N;
      lm::cp_async4(sb + k, ok ? sbase + (int64_t)t0 * 3 + k : sbase, ok);
    }
    devit::mma::cp_async_commit();
  };
  devit::mma::load_rows<DH>(Ks, base + C + (int64_t)c0 * row3, row3, lm::kRows, len, tid,
                            lm::kThreads);
  if (DK)
    devit::mma::load_rows<DH>(Vs, base + 2 * C + (int64_t)c0 * row3, row3, lm::kRows, len, tid,
                              lm::kThreads);

  uint32_t ka[kHold ? DH / 16 : 1][4], va[kHold ? DH / 16 : 1][4];
  float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;
  // step i: query tile i, its g rows and statistics into buffer i & 1
  lm::ring_walk(n_tiles, active, fetch, [&](int i) {
    if constexpr (kHold) {
      if (i == 0) {
        lm::load_a<DH>(ka, Ks, kr, lane);
        if (DK) lm::load_a<DH>(va, Vs, kr, lane);
      }
    }
    const bf16* Qb = ring + (i & 1) * 2 * QT * DH;
    const bf16* Gb = Qb + QT * DH;
    const float* sb = St + (i & 1) * 3 * QT;
    const int t0 = i * QT;
    const bool full = t0 + QT <= N;  // no query past N in the tile
#pragma unroll
    for (int j0 = 0; j0 < QT; j0 += 32) {
      if (t0 + j0 >= N) break;  // warp-uniform
      float s[4][4], dp[4][4];
      if constexpr (kHold) {
        lm::times_rows<4, DH>(s, ka, Qb, j0, N - t0, lane);
        if (DK) lm::times_rows<4, DH>(dp, va, Gb, j0, N - t0, lane);
      } else {
        lm::tile_times_rows<4, DH>(s, Ks, kr, Qb, j0, N - t0, lane);
        if (DK) lm::tile_times_rows<4, DH>(dp, Vs, kr, Gb, j0, N - t0, lane);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int q = j0 + 8 * t + 2 * (lane & 3) + c;  // the column's query in the tile
          const float mq = sb[3 * q], lq = sb[3 * q + 1], rq = __frcp_rn(lq);
          const bool in = full || t0 + q < N;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + c;
            const float p = in ? lm::prob(__fmul_rn(s[t][e], scale), mq, lq, rq) : 0.f;
            s[t][e] = p;
            if (DK) dp[t][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[t][e], sb[3 * q + 2])), scale);
          }
        }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (t0 + j0 + 16 * j >= N) break;  // queries past N: p and ds are 0 (warp-uniform)
        uint32_t a[4];
        if (DV) {
          lm::pack_a<4>(a, s, j);
          lm::times_cols<DH>(dv, a, Gb, j0 + 16 * j, lane);
        }
        if (DK) {
          lm::pack_a<4>(a, dp, j);
          lm::times_cols<DH>(dk, a, Qb, j0 + 16 * j, lane);
        }
      }
    }
  });
  if (!active) return;
  bf16* obase = out + ((int64_t)b * N + c0) * out_stride + h * DH;
#pragma unroll
  for (int t = 0; t < DH / 8; ++t) {
    if (DK) devit::mma::store_rows(dk[t], obase + C, out_stride, kr, len, 8 * t, lane);
    if (DV)
      devit::mma::store_rows(dv[t], obase + (DK ? 2 * C : 0), out_stride, kr, len, 8 * t, lane);
  }
}

template <typename K, typename... A>
cudaError_t launch_mma_kernel(K fn, std::atomic<bool>* opted, unsigned grid, size_t smem,
                              cudaStream_t s, A... args) {
  cudaError_t err = devit::opt_in_smem((const void*)fn, opted);
  if (err != cudaSuccess) return err;
  fn<<<grid, lm::kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// rows<dqdk>, then keys<dqdk, dv>: the monolithic backward (both), the dq/dk
// kernel (dqdk) or the dv kernel (dv).
template <int DH>
cudaError_t launch_long_mma(const void* qkv, const void* g, void* out, long long out_stride,
                            float* stats, int B, int N, int H, bool dqdk, bool dv, float scale,
                            cudaStream_t s) {
  static std::atomic<bool> opted[5][devit::kMaxDevices];
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* gt = static_cast<const bf16*>(g);
  bf16* o = static_cast<bf16*>(out);
  const unsigned bh = (unsigned)(B * H);
  const int tiles = (N + lm::kRows - 1) / lm::kRows;  // query tiles, and key chunks
  const size_t rs = rows_mma_smem_bytes<DH>(), ks = keys_mma_smem_bytes<DH>();
  cudaError_t err =
      dqdk ? launch_mma_kernel(attn_bwd_long_rows_mma<DH, true>, opted[0], bh * tiles, rs, s, x,
                               gt, o, out_stride, stats, N, H, tiles, scale)
           : launch_mma_kernel(attn_bwd_long_rows_mma<DH, false>, opted[1], bh * tiles, rs, s, x,
                               gt, o, out_stride, stats, N, H, tiles, scale);
  if (err != cudaSuccess) return err;
  const float* st = stats;
  if (dqdk && dv)
    return launch_mma_kernel(attn_bwd_long_keys_mma<DH, true, true>, opted[2], bh * tiles, ks, s,
                             x, gt, o, out_stride, st, N, H, tiles, scale);
  if (dqdk)
    return launch_mma_kernel(attn_bwd_long_keys_mma<DH, true, false>, opted[3], bh * tiles, ks,
                             s, x, gt, o, out_stride, st, N, H, tiles, scale);
  return launch_mma_kernel(attn_bwd_long_keys_mma<DH, false, true>, opted[4], bh * tiles, ks, s,
                           x, gt, o, out_stride, st, N, H, tiles, scale);
}

// ---- f32 at head widths 32, 64 and 128: the 3xTF32 pair (long_tf32.cuh)

namespace lt = devit::longtf32;

// m16 tiles a warp, the same in both kernels: a rows block takes 64 MT query
// rows, a keys block 64 MT keys. Two at dh 64 (rows 213 registers, keys 255
// with a 4-byte spill; two blocks an SM); one at dh 32 and 128, where two
// spilled (the score tiles of 64-key chunks; dh 128's accumulators) or gained
// nothing.
template <int DH>
__host__ __device__ constexpr int pair_mt() {
  return DH == 64 ? 2 : 1;
}

// The rows kernel: the q and g tiles [2][64 MT][dh + 4] | two buffers of a K
// and a V chunk [2][2][chunk_keys][dh + 4], f32.
template <int DH>
constexpr size_t rows_tf32_smem_bytes() {
  return sizeof(float) * (size_t)(2 * lt::tile_floats<DH>(64 * pair_mt<DH>()) +
                                  4 * lt::tile_floats<DH>(lt::chunk_keys<DH>()));
}

// The keys kernel: the chunk's K and V [2][64 MT][dh + 4] | two buffers of a
// q and a g tile [2][2][chunk_keys][dh + 4] and of the tile's rows'
// statistics [2][chunk_keys][3], f32.
template <int DH>
constexpr size_t keys_tf32_smem_bytes() {
  return sizeof(float) * (size_t)(2 * lt::tile_floats<DH>(64 * pair_mt<DH>()) +
                                  4 * lt::tile_floats<DH>(lt::chunk_keys<DH>()) +
                                  2 * 3 * lt::chunk_keys<DH>());
}

size_t long_tf32_smem_bytes(int dh) {
  const size_t r = dh == 32 ? rows_tf32_smem_bytes<32>()
                   : dh == 64 ? rows_tf32_smem_bytes<64>() : rows_tf32_smem_bytes<128>();
  const size_t k = dh == 32 ? keys_tf32_smem_bytes<32>()
                   : dh == 64 ? keys_tf32_smem_bytes<64>() : keys_tf32_smem_bytes<128>();
  return r > k ? r : k;
}

// attn_bwd_long_rows_mma's walks at f32 (3xTF32 products), a block (batch
// row, head, 64 MT query rows), 4 warps of MT m16 tiles (pair_mt): the rows'
// (m, l) and, with DQ, delta and dq. q and g stay in their staged tiles, read
// and split once a k8 step of each chunk; ds = (p (dp - delta)) scale (f32,
// unrounded) is the A fragment of dq += ds k straight from the accumulators
// (long_tf32.cuh acc_a), K's rows 2t and 2t + 1 its B.
template <int DH, bool DQ>
__global__ void __launch_bounds__(lm::kThreads, DH == 32 ? 3 : 2)
attn_bwd_long_rows_tf32(const float* __restrict__ qkv, const float* __restrict__ g,
                        float* __restrict__ dq, long long out_stride, float* __restrict__ stats,
                        int N, int H, int n_tiles, float scale) {
  constexpr int MT = pair_mt<DH>(), TQ = 64 * MT;
  constexpr int CK = lt::chunk_keys<DH>(), NT = CK / 8, KT = lt::tile_floats<DH>(CK);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Gs = Qs + lt::tile_floats<DH>(TQ);
  float* ring = Gs + lt::tile_floats<DH>(TQ);  // buffer i & 1: K chunk, then V chunk

  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const float* base = qkv + (int64_t)b * N * row3 + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * TQ, r0 = 16 * MT * warp;
  const bool active = q0 + r0 < N;
  const int n_chunks = (N + CK - 1) / CK;

  lt::load_rows<DH>(Qs, base + (int64_t)q0 * row3, row3, TQ, N - q0, tid, lm::kThreads);
  if (DQ)
    lt::load_rows<DH>(Gs, g + ((int64_t)b * N + q0) * C + h * DH, C, TQ, N - q0, tid,
                      lm::kThreads);
  float m[MT][2], l[MT][2], dl[MT][2], rl[MT][2], acc[MT][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = dl[mt][0] = dl[mt][1] = 0.f;
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][t][e] = 0.f;
  }
  // step i: chunk i % n_chunks, K (and V with DQ) into buffer i & 1
  lm::ring_walk(
      DQ ? 2 * n_chunks : n_chunks, active,
      [&](int i) {
        lt::fetch_chunk<DH>(ring, i, (i < n_chunks ? i : i - n_chunks) * CK, base + C, C, row3,
                            N, DQ, tid);
      },
      [&](int i) {
        const float* Kb = ring + (i & 1) * 2 * KT;
        const int c0 = (i < n_chunks ? i : i - n_chunks) * CK;
        float s[MT][NT][4], dp[MT][NT][4];
        lt::times_rows<MT, NT, DH>(s, Qs, r0, Kb, 0, N - c0, lane);
        if (DQ) lt::times_rows<MT, NT, DH>(dp, Gs, r0, Kb + KT, 0, N - c0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) lm::scale_mask<NT>(s[mt], c0, N, scale, lane);
        if (i < n_chunks) {
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            lm::stats_step<NT, DQ>(s[mt], dp[mt], m[mt], l[mt], dl[mt], rl[mt],
                                   i == n_chunks - 1);
          return;
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e >> 1;
              const float p = lm::prob(s[mt][t][e], m[mt][r], l[mt][r], rl[mt][r]);
              s[mt][t][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[mt][t][e], dl[mt][r])), scale);
            }
        lt::chunk_times_cols<MT, NT, DH>(acc, s, Kb, c0, N, lane);  // dq += ds k
      });
  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int rt = r0 + 16 * mt;
    if (DQ)
      lt::store_rows<DH>(acc[mt], dq + ((int64_t)b * N + q0) * out_stride + h * DH, out_stride,
                         rt, N - q0, lane);
    if ((lane & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = q0 + rt + (lane >> 2) + 8 * i;
        if (n >= N) continue;
        float* st = stats + ((int64_t)bh * N + n) * 3;
        st[0] = m[mt][i];
        st[1] = l[mt][i];
        st[2] = DQ ? dl[mt][i] : 0.f;
      }
    }
  }
}

// attn_bwd_long_keys_mma's block at f32 (3xTF32 products): dk (DK) and dv
// (DV) of 64 MT keys, 4 warps of MT m16 tiles of keys (pair_mt), the keys'
// K (and V) staged once and read as A fragments; query tiles of chunk_keys,
// their g rows and statistics through the ring. s^T = k q^T (and dp^T = v
// g^T) with keys as rows; p and ds from the columns' statistics (0 past N);
// then dv += p^T g and dk += ds^T q with p^T and ds^T the A fragments
// straight from the accumulators and g, q rows 2t and 2t + 1 as B. Every
// instantiation runs these steps on the same operands in the same order, so
// the split pair equals the monolithic <true, true> bit for bit.
template <int DH, bool DK, bool DV>
__global__ void __launch_bounds__(lm::kThreads, DH == 32 ? 3 : 2)
attn_bwd_long_keys_tf32(const float* __restrict__ qkv, const float* __restrict__ g,
                        float* __restrict__ out, long long out_stride,
                        const float* __restrict__ stats, int N, int H, int n_chunks,
                        float scale) {
  static_assert(DK || DV, "an instantiation computes dk, dv or both");
  constexpr int MT = pair_mt<DH>(), TK = 64 * MT;
  constexpr int QT = lt::chunk_keys<DH>(), NT = QT / 8, QF = lt::tile_floats<DH>(QT);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + lt::tile_floats<DH>(TK);
  float* ring = Vs + lt::tile_floats<DH>(TK);  // buffer i & 1: q tile, then g tile
  float* St = ring + 4 * QF;                   // [2][QT][3]

  const int chunk = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const float* base = qkv + (int64_t)b * N * row3 + h * DH;
  const float* gbase = g + (int64_t)b * N * C + h * DH;
  const float* sbase = stats + (int64_t)bh * N * 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = chunk * TK, len = min(TK, N - c0), kr = 16 * MT * warp;
  const bool active = kr < len;
  const int n_tiles = (N + QT - 1) / QT;

  auto fetch = [&](int i) {
    const int t0 = i * QT;
    float* Qb = ring + (i & 1) * 2 * QF;
    lt::load_rows<DH>(Qb, base + (int64_t)t0 * row3, row3, QT, N - t0, tid, lm::kThreads);
    lt::load_rows<DH>(Qb + QF, gbase + (int64_t)t0 * C, C, QT, N - t0, tid, lm::kThreads);
    float* sb = St + (i & 1) * 3 * QT;
    for (int k = tid; k < 3 * QT; k += lm::kThreads) {
      const bool ok = t0 + k / 3 < N;
      lm::cp_async4(sb + k, ok ? sbase + (int64_t)t0 * 3 + k : sbase, ok);
    }
    devit::mma::cp_async_commit();
  };
  lt::load_rows<DH>(Ks, base + C + (int64_t)c0 * row3, row3, TK, len, tid, lm::kThreads);
  if (DK)
    lt::load_rows<DH>(Vs, base + 2 * C + (int64_t)c0 * row3, row3, TK, len, tid, lm::kThreads);

  float dk[DK ? MT : 1][DH / 8][4], dv[DV ? MT : 1][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (DK) dk[mt][t][e] = 0.f;
        if (DV) dv[mt][t][e] = 0.f;
      }
  // step i: query tile i, its g rows and statistics into buffer i & 1
  lm::ring_walk(n_tiles, active, fetch, [&](int i) {
    const float* Qb = ring + (i & 1) * 2 * QF;
    const float* Gb = Qb + QF;
    const float* sb = St + (i & 1) * 3 * QT;
    const int t0 = i * QT;
    const bool full = t0 + QT <= N;  // no query past N in the tile
    float s[MT][NT][4], dp[MT][NT][4];
    lt::times_rows<MT, NT, DH, true>(s, Ks, kr, Qb, 0, N - t0, lane);
    if (DK) lt::times_rows<MT, NT, DH, true>(dp, Vs, kr, Gb, 0, N - t0, lane);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int q = 8 * t + 2 * (lane & 3) + c;  // the column's query in the tile
        const float mq = sb[3 * q], lq = sb[3 * q + 1], rq = __frcp_rn(lq), dq_ = sb[3 * q + 2];
        const bool in = full || t0 + q < N;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int e = 2 * half + c;
            const float p = in ? lm::prob(__fmul_rn(s[mt][t][e], scale), mq, lq, rq) : 0.f;
            s[mt][t][e] = p;
            if (DK) dp[mt][t][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[mt][t][e], dq_)), scale);
          }
      }
    if constexpr (DV) lt::chunk_times_cols<MT, NT, DH>(dv, s, Gb, t0, N, lane);   // dv += p^T g
    if constexpr (DK) lt::chunk_times_cols<MT, NT, DH>(dk, dp, Qb, t0, N, lane);  // dk += ds^T q
  });
  if (!active) return;
  float* obase = out + ((int64_t)b * N + c0) * out_stride + h * DH;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    if constexpr (DK) lt::store_rows<DH>(dk[mt], obase + C, out_stride, kr + 16 * mt, len, lane);
    if constexpr (DV)
      lt::store_rows<DH>(dv[mt], obase + (DK ? 2 * C : 0), out_stride, kr + 16 * mt, len, lane);
  }
}

// rows<dqdk>, then keys<dqdk, dv>, as launch_long_mma.
template <int DH>
cudaError_t launch_long_tf32(const void* qkv, const void* g, void* out, long long out_stride,
                             float* stats, int B, int N, int H, bool dqdk, bool dv, float scale,
                             cudaStream_t s) {
  static std::atomic<bool> opted[5][devit::kMaxDevices];
  const float* x = static_cast<const float*>(qkv);
  const float* gt = static_cast<const float*>(g);
  float* o = static_cast<float*>(out);
  const unsigned bh = (unsigned)(B * H);
  constexpr int TQ = 64 * pair_mt<DH>();  // query rows of a rows block, keys of a keys block
  const int tiles = (N + TQ - 1) / TQ;
  const size_t rs = rows_tf32_smem_bytes<DH>(), ks = keys_tf32_smem_bytes<DH>();
  cudaError_t err =
      dqdk ? launch_mma_kernel(attn_bwd_long_rows_tf32<DH, true>, opted[0], bh * tiles, rs, s, x,
                               gt, o, out_stride, stats, N, H, tiles, scale)
           : launch_mma_kernel(attn_bwd_long_rows_tf32<DH, false>, opted[1], bh * tiles, rs, s,
                               x, gt, o, out_stride, stats, N, H, tiles, scale);
  if (err != cudaSuccess) return err;
  const float* st = stats;
  if (dqdk && dv)
    return launch_mma_kernel(attn_bwd_long_keys_tf32<DH, true, true>, opted[2], bh * tiles, ks,
                             s, x, gt, o, out_stride, st, N, H, tiles, scale);
  if (dqdk)
    return launch_mma_kernel(attn_bwd_long_keys_tf32<DH, true, false>, opted[3], bh * tiles, ks,
                             s, x, gt, o, out_stride, st, N, H, tiles, scale);
  return launch_mma_kernel(attn_bwd_long_keys_tf32<DH, false, true>, opted[4], bh * tiles, ks, s,
                           x, gt, o, out_stride, st, N, H, tiles, scale);
}

// ---- head widths past 128: head pieces and output slabs (wide.cuh), both dtypes

namespace wd = devit::wide;

// The rows kernel's ring buffer, elements: the q tile's piece | with DQ the g
// tile's piece | the K chunk's piece | with DQ the V chunk's piece and the K
// chunk's dq slab.
template <typename T, bool DQ>
__host__ __device__ constexpr int wide_rows_buffer() {
  using O = wd::Ops<T>;
  constexpr int P = O::template tile<O::kPiece>(wd::kRows);
  constexpr int K = O::template tile<O::kPiece>(O::kChunk);
  return DQ ? 2 * P + 2 * K + O::template tile<wd::kRowsSlab>(O::kChunk) : P + K;
}

// The keys kernel's slab (kKeysSlab in the monolithic backward, kHalfSlab
// in either half of the split pair; each output column sums the same terms
// in the same order at any slab width, so the bits agree) and its ring
// buffer, bytes: the block's K piece | with DK its V piece | the query tile's
// q piece | with DK its g piece | the tile's q slab (DK) and g slab (DV) |
// the tile's rows' statistics [kChunk][3] f32.
template <typename T, bool DK, bool DV>
struct WideKeysBuffer {
  using O = wd::Ops<T>;
  static constexpr int slab = DK && DV ? wd::kKeysSlab : wd::kHalfSlab;
  static constexpr int kK = O::template tile<O::kPiece>(wd::kRows);
  static constexpr int kQ = O::template tile<O::kPiece>(O::kChunk);
  static constexpr int kS = O::template tile<slab>(O::kChunk);
  static constexpr int v = kK, q = v + (DK ? kK : 0), g = q + kQ, qs = g + (DK ? kQ : 0),
                       gs = qs + (DK ? kS : 0), stats = gs + (DV ? kS : 0);  // elements
  static constexpr size_t bytes =
      (sizeof(T) * stats + sizeof(float) * 3 * O::kChunk + 15) / 16 * 16;
};

template <typename T>
size_t wide_smem_bytes() {
  const size_t r = 2 * sizeof(T) * (size_t)wide_rows_buffer<T, true>();
  const size_t k = 2 * std::max({WideKeysBuffer<T, true, true>::bytes,
                                 WideKeysBuffer<T, true, false>::bytes,
                                 WideKeysBuffer<T, false, true>::bytes});
  return r > k ? r : k;
}

// Block (batch row, head, 64-query tile), 4 warps of 16 rows: the rows' (m,
// l) and, with DQ, delta and dq. Each ring step stages a piece of the q tile
// and of a K chunk (with DQ also of the g tile and the V chunk); s = q k^T
// and dp = g v^T gather their pieces in the warps' accumulators. Walk 0: the
// online (m, l) and rowsum(dp * e) (stats_step, as attn_bwd_long_rows_mma),
// written to stats[(bh N + n) 3 + {0, 1, 2}] after the last chunk (delta 0
// without DQ). Then, with DQ, one walk a kRowsSlab-dim slab of dq: s and dp
// again, ds = (p (dp - delta)) scale (rounded at bf16) times the chunk's
// staged K slab, the slab written after the last chunk. rows<false> runs
// walk 0 as rows<true> does, so (m, l) have the same bits in both.
template <typename T, bool DQ>
__global__ void __launch_bounds__(wd::kThreads, 2)
attn_bwd_wide_rows_mma(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dq,
                       long long out_stride, float* __restrict__ stats, int N, int H, int W,
                       int n_tiles, float scale) {
  using O = wd::Ops<T>;
  constexpr int SW = wd::kRowsSlab, CK = O::kChunk, NT = CK / 8;
  constexpr int PE = O::template tile<O::kPiece>(wd::kRows), KE = O::template tile<O::kPiece>(CK);
  constexpr int kG = PE, kK = DQ ? 2 * PE : PE, kV = kK + KE, kKS = kV + KE;  // buffer offsets
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int C = H * W;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + (int64_t)h * W;
  const T* gbase = g + (int64_t)b * N * C + (int64_t)h * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * wd::kRows, r0 = 16 * warp;
  const bool active = q0 + r0 < N;
  const wd::Steps steps(N, W, CK, O::kPiece);
  const int n_slabs = DQ ? (W + SW - 1) / SW : 0;

  float s[NT][4], dp[NT][4], acc[SW / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f}, rl[2];
  lm::ring_walk(
      (1 + n_slabs) * steps.per_walk, active,
      [&](int i) {
        int w, c0, d;
        steps.at(i, CK, w, c0, d);
        T* buf = ring + (i & 1) * wide_rows_buffer<T, DQ>();
        const int64_t qd = (int64_t)q0 * row3 + d * O::kPiece;
        const int64_t kd = (int64_t)c0 * row3 + d * O::kPiece;
        O::template stage<O::kPiece>(buf, base + qd, row3, wd::kRows, N - q0, O::kPiece, tid);
        O::template stage<O::kPiece>(buf + kK, base + C + kd, row3, CK, N - c0, O::kPiece, tid);
        if constexpr (DQ) {
          O::template stage<O::kPiece>(buf + kG, gbase + (int64_t)q0 * C + d * O::kPiece, C,
                                       wd::kRows, N - q0, O::kPiece, tid);
          O::template stage<O::kPiece>(buf + kV, base + 2 * C + kd, row3, CK, N - c0, O::kPiece,
                                       tid);
          if (w > 0 && d == steps.pieces - 1) {
            const int e0 = (w - 1) * SW;
            O::template stage<SW>(buf + kKS, base + C + (int64_t)c0 * row3 + e0, row3, CK, N - c0,
                                  W - e0, tid);
          }
        }
        devit::mma::cp_async_commit();
      },
      [&](int i) {
        int w, c0, d;
        steps.at(i, CK, w, c0, d);
        const T* buf = ring + (i & 1) * wide_rows_buffer<T, DQ>();
        if (d == 0) {
          wd::zero(s);
          wd::zero(dp);
        }
        O::template piece_product<NT, false>(s, buf, r0, buf + kK, 0, N - c0, lane);
        if constexpr (DQ)
          O::template piece_product<NT, false>(dp, buf + kG, r0, buf + kV, 0, N - c0, lane);
        if (d < steps.pieces - 1) return;
        lm::scale_mask<NT>(s, c0, N, scale, lane);
        const bool last = c0 + CK >= N;
        if (w == 0) {
          lm::stats_step<NT, DQ>(s, dp, m, l, dl, rl, last);
          if (last && (lane & 3) == 0) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int n = q0 + r0 + (lane >> 2) + 8 * r;
              if (n >= N) continue;
              float* st = stats + ((int64_t)bh * N + n) * 3;
              st[0] = m[r];
              st[1] = l[r];
              st[2] = DQ ? dl[r] : 0.f;
            }
          }
          return;
        }
        const int e0 = (w - 1) * SW;
        if (c0 == 0) wd::zero(acc);
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = lm::prob(s[t][e], m[r], l[r], rl[r]);
            s[t][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[t][e], dl[r])), scale);  // ds
          }
        O::template slab_product<NT, SW>(acc, s, buf + kKS, c0, N, W - e0, lane);  // dq += ds k
        if (last)
          O::template store<SW>(acc, dq + ((int64_t)b * N + q0) * out_stride + (int64_t)h * W + e0,
                                out_stride, r0, N - q0, W - e0, lane);
      });
}

// Block (batch row, head, 64-key chunk), 4 warps of 16 keys: dk (DK) and dv
// (DV) of the chunk's keys, summed over every query, one slab after the
// other (WideKeysBuffer::slab dims). Each ring step stages a piece of the block's K (with DK
// also V) and of a query tile's q (with DK also g); s^T = k q^T and dp^T = v
// g^T gather their pieces, keys as rows (the Transposed order at f32). At the
// tile's last piece the step also stages the tile's q slab (DK), g slab (DV)
// and its rows' statistics; p = exp(s - m) / l and ds = (p (dp - delta))
// scale from the columns' statistics (0 for queries at or past N), then dv +=
// round(p)^T g and dk += ds^T q with p^T and ds^T the A fragments straight
// from the accumulators. Every instantiation runs these steps on the same
// operands in the same order, so the split pair equals the monolithic <true,
// true> bit for bit.
template <typename T, bool DK, bool DV>
__global__ void __launch_bounds__(wd::kThreads, 2)
attn_bwd_wide_keys_mma(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ out,
                       long long out_stride, const float* __restrict__ stats, int N, int H, int W,
                       int n_chunks, float scale) {
  static_assert(DK || DV, "an instantiation computes dk, dv or both");
  using O = wd::Ops<T>;
  using Buf = WideKeysBuffer<T, DK, DV>;
  constexpr int SW = Buf::slab, QT = O::kChunk, NT = QT / 8;
  extern __shared__ __align__(16) unsigned char smem[];

  const int chunk = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int C = H * W;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + (int64_t)h * W;
  const T* gbase = g + (int64_t)b * N * C + (int64_t)h * W;
  const float* sbase = stats + (int64_t)bh * N * 3;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int c0 = chunk * wd::kRows, len = min(wd::kRows, N - c0), kr = 16 * warp;
  const bool active = kr < len;
  const wd::Steps steps(N, W, QT, O::kPiece);
  const int n_slabs = (W + SW - 1) / SW;

  float s[NT][4], dp[NT][4], dk[DK ? SW / 8 : 1][4], dv[DV ? SW / 8 : 1][4];
  lm::ring_walk(
      n_slabs * steps.per_walk, active,
      [&](int i) {
        int w, t0, d;
        steps.at(i, QT, w, t0, d);
        T* buf = reinterpret_cast<T*>(smem + (i & 1) * Buf::bytes);
        const int64_t kd = (int64_t)c0 * row3 + d * O::kPiece;
        const int64_t qd = (int64_t)t0 * row3 + d * O::kPiece;
        O::template stage<O::kPiece>(buf, base + C + kd, row3, wd::kRows, len, O::kPiece, tid);
        O::template stage<O::kPiece>(buf + Buf::q, base + qd, row3, QT, N - t0, O::kPiece, tid);
        if constexpr (DK) {
          O::template stage<O::kPiece>(buf + Buf::v, base + 2 * C + kd, row3, wd::kRows, len,
                                       O::kPiece, tid);
          O::template stage<O::kPiece>(buf + Buf::g, gbase + (int64_t)t0 * C + d * O::kPiece, C,
                                       QT, N - t0, O::kPiece, tid);
        }
        if (d == steps.pieces - 1) {
          const int e0 = w * SW;
          if constexpr (DK)
            O::template stage<SW>(buf + Buf::qs, base + (int64_t)t0 * row3 + e0, row3, QT, N - t0,
                                  W - e0, tid);
          if constexpr (DV)
            O::template stage<SW>(buf + Buf::gs, gbase + (int64_t)t0 * C + e0, C, QT, N - t0,
                                  W - e0, tid);
          float* sb = reinterpret_cast<float*>(buf + Buf::stats);
          for (int k = tid; k < 3 * QT; k += wd::kThreads) {
            const bool ok = t0 + k / 3 < N;
            lm::cp_async4(sb + k, ok ? sbase + (int64_t)t0 * 3 + k : sbase, ok);
          }
        }
        devit::mma::cp_async_commit();
      },
      [&](int i) {
        int w, t0, d;
        steps.at(i, QT, w, t0, d);
        const T* buf = reinterpret_cast<const T*>(smem + (i & 1) * Buf::bytes);
        if (d == 0) {
          wd::zero(s);
          wd::zero(dp);
        }
        O::template piece_product<NT, true>(s, buf, kr, buf + Buf::q, 0, N - t0, lane);
        if constexpr (DK)
          O::template piece_product<NT, true>(dp, buf + Buf::v, kr, buf + Buf::g, 0, N - t0, lane);
        if (d < steps.pieces - 1) return;
        const int e0 = w * SW;
        if (t0 == 0) {
          if constexpr (DK) wd::zero(dk);
          if constexpr (DV) wd::zero(dv);
        }
        const float* sb = reinterpret_cast<const float*>(buf + Buf::stats);
        const bool full = t0 + QT <= N;  // no query past N in the tile
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int q = 8 * t + 2 * (lane & 3) + c;  // the column's query in the tile
            const float mq = sb[3 * q], lq = sb[3 * q + 1], rq = __frcp_rn(lq), dq_ = sb[3 * q + 2];
            const bool in = full || t0 + q < N;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int e = 2 * half + c;
              const float p = in ? lm::prob(__fmul_rn(s[t][e], scale), mq, lq, rq) : 0.f;
              s[t][e] = p;
              if (DK) dp[t][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[t][e], dq_)), scale);
            }
          }
        if constexpr (DV)  // dv += round(p)^T g
          O::template slab_product<NT, SW>(dv, s, buf + Buf::gs, t0, N, W - e0, lane);
        if constexpr (DK)  // dk += ds^T q
          O::template slab_product<NT, SW>(dk, dp, buf + Buf::qs, t0, N, W - e0, lane);
        if (t0 + QT < N) return;  // not the last query tile
        T* obase = out + ((int64_t)b * N + c0) * out_stride + (int64_t)h * W + e0;
        if constexpr (DK) O::template store<SW>(dk, obase + C, out_stride, kr, len, W - e0, lane);
        if constexpr (DV)
          O::template store<SW>(dv, obase + (DK ? 2 * C : 0), out_stride, kr, len, W - e0, lane);
      });
}

// rows<dqdk>, then keys<dqdk, dv>, as launch_long_mma, at a head width W
// that is a multiple of 64.
template <typename T>
cudaError_t launch_wide(const void* qkv, const void* g, void* out, long long out_stride,
                        float* stats, int B, int N, int H, int W, bool dqdk, bool dv, float scale,
                        cudaStream_t s) {
  if (W % 64) return cudaErrorInvalidValue;
  static std::atomic<bool> opted[5][devit::kMaxDevices];
  const T* x = static_cast<const T*>(qkv);
  const T* gt = static_cast<const T*>(g);
  T* o = static_cast<T*>(out);
  const unsigned bh = (unsigned)(B * H);
  const int tiles = (N + wd::kRows - 1) / wd::kRows;  // query tiles, and key chunks
  cudaError_t err =
      dqdk ? launch_mma_kernel(attn_bwd_wide_rows_mma<T, true>, opted[0], bh * tiles,
                               2 * sizeof(T) * wide_rows_buffer<T, true>(), s, x, gt, o,
                               out_stride, stats, N, H, W, tiles, scale)
           : launch_mma_kernel(attn_bwd_wide_rows_mma<T, false>, opted[1], bh * tiles,
                               2 * sizeof(T) * wide_rows_buffer<T, false>(), s, x, gt, o,
                               out_stride, stats, N, H, W, tiles, scale);
  if (err != cudaSuccess) return err;
  const float* st = stats;
  if (dqdk && dv)
    return launch_mma_kernel(attn_bwd_wide_keys_mma<T, true, true>, opted[2], bh * tiles,
                             2 * WideKeysBuffer<T, true, true>::bytes, s, x, gt, o, out_stride,
                             st, N, H, W, tiles, scale);
  if (dqdk)
    return launch_mma_kernel(attn_bwd_wide_keys_mma<T, true, false>, opted[3], bh * tiles,
                             2 * WideKeysBuffer<T, true, false>::bytes, s, x, gt, o, out_stride,
                             st, N, H, W, tiles, scale);
  return launch_mma_kernel(attn_bwd_wide_keys_mma<T, false, true>, opted[4], bh * tiles,
                           2 * WideKeysBuffer<T, false, true>::bytes, s, x, gt, o, out_stride, st,
                           N, H, W, tiles, scale);
}

template <typename T>
cudaError_t launch_long_dh(const void* qkv, const void* g, void* out, long long out_stride,
                           float* stats, int B, int N, int H, int head_dim, bool dqdk, bool dv,
                           float scale, cudaStream_t s) {
  if (head_dim > 128)
    return launch_wide<T>(qkv, g, out, out_stride, stats, B, N, H, head_dim, dqdk, dv, scale, s);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (head_dim == 32)
      return launch_long_mma<32>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
    if (head_dim == 64)
      return launch_long_mma<64>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
    if (head_dim == 128)
      return launch_long_mma<128>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
  } else {  // f32: the 3xTF32 pair
    if (head_dim == 32)
      return launch_long_tf32<32>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
    if (head_dim == 64)
      return launch_long_tf32<64>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
    if (head_dim == 128)
      return launch_long_tf32<128>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

namespace devit {
namespace bwd {

size_t long_smem_bytes(int dh, int elem) {
  if (dh > 128)  // the larger of the two kernels'
    return elem == 2 ? wide_smem_bytes<__nv_bfloat16>() : wide_smem_bytes<float>();
  return elem == 2 ? long_mma_smem_bytes(dh) : long_tf32_smem_bytes(dh);
}

cudaError_t launch_long(const void* qkv, const void* g, void* out, long long out_stride,
                        float* stats, int B, int N, int H, int head_dim, int dtype, bool dqdk,
                        bool dv, float scale, cudaStream_t stream) {
  if (stats == nullptr || !(dqdk || dv)) return cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_long_dh<float>(qkv, g, out, out_stride, stats, B, N, H, head_dim, dqdk, dv,
                                 scale, stream);
  if (dtype == 1)
    return launch_long_dh<__nv_bfloat16>(qkv, g, out, out_stride, stats, B, N, H, head_dim,
                                         dqdk, dv, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace bwd
}  // namespace devit
