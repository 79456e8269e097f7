// The attention backward past kShortN (256) keys, at both dtypes: what the
// monolithic kernel (attention_bwd.cu) and the split pair
// (attention_bwd_split.cu) launch when N > 256 (and at bf16, dh 128, from N
// 209, where the monolithic block does not fit: use_long_path).
//
// Replaces, for long sequences, devit_tpu/kernels/attention.py:
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
// f32, dh 32, 64 and 128 (attn_bwd_long_rows, attn_bwd_long_keys): the same
// two kernels on the CUDA-core steps of bwd_common.cuh (the f32 tolerance is
// 1e-4, finer than TF32), 512-thread blocks over 256-key chunks (128 at dh
// 128), a lane owning dims l + 32 j. The rows kernel walks the chunks once
// for each row's max, once for its sum, and (DQ) once for delta and once
// more for dq; the keys kernel recomputes s and dp for every 32-query tile.
// A lane's partial max, sum and rowsum run over its columns l + 32 j in
// softmax_row's and ds_row's order, so at f32 this path computes what the
// one-block-a-head steps would if their registers held the row. Right, not
// fast (13.4 ms at B 64, N 578, kh 6): a later redesign's.
//
// Head widths past 128 (attn_wide_bwd_rows, attn_wide_bwd_keys), both
// dtypes: a lane cannot own a whole row's dims in registers, nor a block a
// chunk's K and V rows, so the same two kernels are written over the
// any-width CUDA-core steps of attn_chunked.cuh: 64-query tiles, 64-key
// chunks, each score product staged 32 dims at a time, each output (dq, dk,
// dv) made 64 dims a block. The rows kernel's every output piece recomputes
// the statistics; its first piece writes them. The numerics are those above,
// so the split pair stays bit for bit the monolithic backward.

#include <type_traits>

#include "attn_chunked.cuh"
#include "bwd_common.cuh"
#include "long_mma.cuh"

namespace {

using namespace devit::bwd;
using devit::from_f;
using devit::round_to;
using devit::to_f;

// Keys a chunk (long_chunk), the key rows of a warp in the key-side sums,
// and the score rows' stride (score_stride of the chunk), by head width.
template <int DH> constexpr int chunk_keys = long_chunk(DH);
template <int DH> constexpr int chunk_keys_per_warp = chunk_keys<DH> / kWarps;
template <int DH> constexpr int chunk_stride = chunk_keys<DH> | 1;

// Walks the key chunks of one (batch row, head): for each chunk, stages its K
// (and V, when Vs is not null) and computes the tile's scores into P (and
// dp into D), then calls row_step(r, i, chunk_start, len) for each of the
// warp's rows r = 2w + i before the sequence's end. A lane reads only the
// P and D columns it wrote, so row_step needs no barrier before it.
template <typename T, int DH, typename F>
__device__ __forceinline__ void walk_chunks(const T* base, T* Ks, T* Vs, const T* Qs,
                                            const T* Gs, float* P, float* D, int N, int rows,
                                            int64_t row3, int C, float scale, F row_step) {
  constexpr int kC = chunk_keys<DH>;
  const int warp = threadIdx.x / 32;
  for (int c0 = 0; c0 < N; c0 += kC) {
    const int len = min(kC, N - c0);
    __syncthreads();  // the previous chunk's readers of Ks, Vs are done
    load_keys<T, DH>(base + (int64_t)c0 * row3, Ks, Vs, len, row3, C);
    __syncthreads();
    rows_times_keys<T, DH>(Qs, Ks, P, len, chunk_stride<DH>, scale);
    if (Vs != nullptr) rows_times_keys<T, DH>(Gs, Vs, D, len, chunk_stride<DH>, 1.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r < rows) row_step(r, i, c0, len);
    }
  }
}

// Block (batch row, head, 32-query tile): the tile's rows' softmax statistics
// and, with DQ, their dq. stats[(bh N + n) 3 + {0, 1, 2}] = m, l, delta.
template <typename T, int DH, bool DQ>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_long_rows(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dq,
                   long long out_stride, float* __restrict__ stats, int N, int H, int n_tiles,
                   float scale) {
  constexpr int KS = kv_stride<T>(DH);
  constexpr int DJ = DH / 32;  // dims a lane owns
  constexpr int kSP = chunk_stride<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);  // s of the tile and chunk (f32)
  float* D = P + kBQ * kSP;                   // dp, then ds
  T* Ks = reinterpret_cast<T*>(D + kBQ * kSP);
  T* Vs = Ks + chunk_keys<DH> * KS;
  T* Qs = Vs + chunk_keys<DH> * KS;  // the tile's q rows, zero past N
  T* Gs = Qs + kBQ * DH;         // the tile's g rows, zero past N

  const int tile = blockIdx.x % n_tiles, bh = blockIdx.x / n_tiles;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  const int q0 = tile * kBQ, rows = min(kBQ, N - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_query_tile<T, DH>(base, gbase, Qs, Gs, q0, rows, row3, C);
  // the lane's partials of the warp's two rows (lane l: columns l + 32 j)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rs[2] = {0.f, 0.f};
  walk_chunks<T, DH>(base, Ks, (T*)nullptr, Qs, Gs, P, D, N, rows, row3, C, scale,
                     [&](int r, int i, int, int len) {
                       for (int c = lane; c < len; c += 32) m[i] = fmaxf(m[i], P[r * kSP + c]);
                     });
  m[0] = devit::warp_max(m[0]);
  m[1] = devit::warp_max(m[1]);
  walk_chunks<T, DH>(base, Ks, (T*)nullptr, Qs, Gs, P, D, N, rows, row3, C, scale,
                     [&](int r, int i, int, int len) {
                       for (int c = lane; c < len; c += 32) l[i] += expf(P[r * kSP + c] - m[i]);
                     });
  l[0] = devit::warp_sum(l[0]);
  l[1] = devit::warp_sum(l[1]);
  if (DQ) {
    walk_chunks<T, DH>(base, Ks, Vs, Qs, Gs, P, D, N, rows, row3, C, scale,
                       [&](int r, int i, int, int len) {
                         for (int c = lane; c < len; c += 32) {
                           const float p = expf(P[r * kSP + c] - m[i]) / l[i];
                           rs[i] = fmaf(D[r * kSP + c], p, rs[i]);
                         }
                       });
    rs[0] = devit::warp_sum(rs[0]);
    rs[1] = devit::warp_sum(rs[1]);
    // dq = sum over the chunks of ds K: lane l sums dims l + 32 j over all
    // of the row's columns, so each row's ds is complete (warp barrier)
    // before its lanes read it
    float acc[2][DJ] = {};
    walk_chunks<T, DH>(base, Ks, Vs, Qs, Gs, P, D, N, rows, row3, C, scale,
                       [&](int r, int i, int, int len) {
                         float* drow = D + r * kSP;
                         for (int c = lane; c < len; c += 32) {
                           const float p = expf(P[r * kSP + c] - m[i]) / l[i];
                           drow[c] = round_to<T>((p * (drow[c] - rs[i])) * scale);
                         }
                         __syncwarp();
                         for (int c = 0; c < len; ++c) {
#pragma unroll
                           for (int j = 0; j < DJ; ++j)
                             acc[i][j] = fmaf(drow[c], to_f(Ks[c * KS + lane + 32 * j]), acc[i][j]);
                         }
                       });
    T* obase = dq + ((int64_t)b * N + q0) * out_stride + h * DH;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < DJ; ++j)
        obase[(int64_t)r * out_stride + lane + 32 * j] = from_f<T>(acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * warp + i;
    if (r < rows && lane == 0) {
      float* st = stats + ((int64_t)bh * N + q0 + r) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = rs[i];
    }
  }
}

// Block (batch row, head, 256-key chunk): dk (DK) and dv (DV) of the chunk's
// keys, summed over all queries with p (and ds) formed from the statistics.
template <typename T, int DH, bool DK, bool DV>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_long_keys(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ out,
                   long long out_stride, const float* __restrict__ stats, int N, int H,
                   int n_chunks, float scale) {
  constexpr int KS = kv_stride<T>(DH);
  constexpr int DJ = DH / 32;  // dims a lane owns
  constexpr int kSP = chunk_stride<DH>;
  constexpr int kKW = chunk_keys_per_warp<DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);  // p of the tile and chunk (f32)
  float* D = P + kBQ * kSP;                   // dp, then ds
  T* Ks = reinterpret_cast<T*>(D + kBQ * kSP);
  T* Vs = Ks + chunk_keys<DH> * KS;
  T* Qs = Vs + chunk_keys<DH> * KS;
  T* Gs = Qs + kBQ * DH;

  const int chunk = blockIdx.x % n_chunks, bh = blockIdx.x / n_chunks;
  const int b = bh / H, h = bh % H;
  const int C = H * DH;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  const int c0 = chunk * chunk_keys<DH>, len = min(chunk_keys<DH>, N - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_keys<T, DH>(base + (int64_t)c0 * row3, Ks, DK ? Vs : nullptr, len, row3, C);
  float dk[kKW][DJ], dv[kKW][DJ];
#pragma unroll
  for (int i = 0; i < kKW; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int q0 = 0; q0 < N; q0 += kBQ) {
    const int rows = min(kBQ, N - q0);
    __syncthreads();  // the previous tile's readers of Qs, Gs, P, D are done
    load_query_tile<T, DH>(base, gbase, Qs, Gs, q0, rows, row3, C);
    __syncthreads();
    rows_times_keys<T, DH>(Qs, Ks, P, len, kSP, scale);
    if (DK) rows_times_keys<T, DH>(Gs, Vs, D, len, kSP, 1.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * warp + i;
      if (r >= rows) continue;  // rows past N: never read below
      const float* st = stats + ((int64_t)bh * N + q0 + r) * 3;
      const float m = st[0], l = st[1], rs = st[2];
      for (int c = lane; c < len; c += 32) {
        const float p = expf(P[r * kSP + c] - m) / l;
        P[r * kSP + c] = p;
        if (DK) D[r * kSP + c] = round_to<T>((p * (D[r * kSP + c] - rs)) * scale);
      }
    }
    __syncthreads();
    if (DV) accumulate_keys<T, DH, true, kKW, DJ>(dv, P, Gs, 0, len, kSP, rows);
    if (DK) accumulate_keys<T, DH, false, kKW, DJ>(dk, D, Qs, 0, len, kSP, rows);
  }
  T* obase = out + ((int64_t)b * N + c0) * out_stride + h * DH;
  if (DK) store_keys<T, kKW, DJ>(dk, obase + C, out_stride, 0, len);
  if (DV) store_keys<T, kKW, DJ>(dv, obase + (DK ? 2 * C : 0), out_stride, 0, len);
}

template <typename T, int DH, bool DQ>
cudaError_t launch_rows(const void* qkv, const void* g, void* out, long long out_stride,
                        float* stats, int B, int N, int H, float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_long_rows<T, DH, DQ>, opted_in);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + kBQ - 1) / kBQ;
  attn_bwd_long_rows<T, DH, DQ><<<(unsigned)(B * H * n_tiles), kThreads,
                                  dqdk_smem_bytes<T>(chunk_keys<DH>, DH), stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(out), out_stride,
      stats, N, H, n_tiles, scale);
  return cudaGetLastError();
}

template <typename T, int DH, bool DK, bool DV>
cudaError_t launch_keys(const void* qkv, const void* g, void* out, long long out_stride,
                        const float* stats, int B, int N, int H, float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_long_keys<T, DH, DK, DV>, opted_in);
  if (err != cudaSuccess) return err;
  const int n_chunks = (N + chunk_keys<DH> - 1) / chunk_keys<DH>;
  attn_bwd_long_keys<T, DH, DK, DV><<<(unsigned)(B * H * n_chunks), kThreads,
                                      dqdk_smem_bytes<T>(chunk_keys<DH>, DH), stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(out), out_stride,
      stats, N, H, n_chunks, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_long_t(const void* qkv, const void* g, void* out, long long out_stride,
                          float* stats, int B, int N, int H, bool dqdk, bool dv,
                          float scale, cudaStream_t s) {
  cudaError_t err =
      dqdk ? launch_rows<T, DH, true>(qkv, g, out, out_stride, stats, B, N, H, scale, s)
           : launch_rows<T, DH, false>(qkv, g, out, out_stride, stats, B, N, H, scale, s);
  if (err != cudaSuccess) return err;
  if (dqdk && dv)
    return launch_keys<T, DH, true, true>(qkv, g, out, out_stride, stats, B, N, H, scale, s);
  if (dqdk)
    return launch_keys<T, DH, true, false>(qkv, g, out, out_stride, stats, B, N, H, scale, s);
  return launch_keys<T, DH, false, true>(qkv, g, out, out_stride, stats, B, N, H, scale, s);
}

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

// ---- head widths past 128 (attn_chunked.cuh's steps)

namespace ch = devit::chunked;

template <typename T>
size_t wide_rows_smem_bytes() {
  // ds [kT][kStride] f32 | the score products' staged pieces | K rows of a piece
  return ch::f32_tile_bytes() + ch::stage_bytes<T>() + ch::tile_bytes<T>();
}

template <typename T>
size_t wide_keys_smem_bytes() {
  // p, ds [kT][kStride] f32 | staged pieces | g and q rows of a piece
  return 2 * ch::f32_tile_bytes() + ch::stage_bytes<T>() + 2 * ch::tile_bytes<T>();
}

// Block (batch row, head, 64-query tile, 64-dim piece of dq): the tile's
// rows' m and l (ch::row_stats) and, with DQ, delta = rowsum(dp * p) and the
// piece of dq = sum ds K. The first piece writes (m, l, delta) to stats.
template <typename T, bool DQ>
__global__ void __launch_bounds__(ch::kThreads)
attn_wide_bwd_rows(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dq,
                   long long out_stride, float* __restrict__ stats, int N, int H, int dh,
                   int n_tiles, int n_pieces, float scale) {
  using ch::kStride;
  using ch::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ds = reinterpret_cast<float*>(smem);
  T* As = reinterpret_cast<T*>(smem + ch::f32_tile_bytes());
  T* Bs = As + ch::kD * kStride;
  T* Ks = Bs + ch::kD * kStride;

  const int piece = blockIdx.x % n_pieces;
  const int tile = (blockIdx.x / n_pieces) % n_tiles;
  const int bh = blockIdx.x / (n_pieces * n_tiles);
  const int b = bh / H, h = bh % H;
  const int C = H * dh;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + (int64_t)h * dh;
  const int q0 = tile * kT, rows = min(kT, N - q0), e0 = piece * kT;
  const T* q = base + (int64_t)q0 * row3;
  const T* gq = g + ((int64_t)b * N + q0) * C + (int64_t)h * dh;
  const int tx = threadIdx.x % 16;

  float m[4], l[4], rs[4] = {0.f, 0.f, 0.f, 0.f};
  ch::row_stats(m, l, q, rows, base + C, row3, N, dh, scale, As, Bs);
  if (DQ) {
    float s[4][4], dp[4][4], acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int pass = 0; pass < 2; ++pass) {  // delta, then dq
      for (int c0 = 0; c0 < N; c0 += kT) {
        const T* k = base + C + (int64_t)c0 * row3;
        ch::scores(s, q, row3, rows, k, row3, N - c0, dh, As, Bs);
        ch::scores(dp, gq, C, rows, k + C, row3, N - c0, dh, As, Bs);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = tx + 16 * j;
            const bool in = c0 + c < N;
            const float p = in ? expf(s[i][j] * scale - m[i]) / l[i] : 0.f;
            if (pass == 0)
              rs[i] = fmaf(dp[i][j], p, rs[i]);
            else
              Ds[ch::row_of(i) * kStride + c] =
                  in ? round_to<T>((p * (dp[i][j] - rs[i])) * scale) : 0.f;
          }
        if (pass == 0) continue;
        ch::stage_rows(Ks, k, row3, N - c0, e0, dh);
        __syncthreads();
        ch::rows_times(acc, Ds, Ks);
        __syncthreads();
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) rs[i] = ch::row_sum(rs[i]);
      }
    }
    ch::store_tile(acc, dq + ((int64_t)b * N + q0) * out_stride + (int64_t)h * dh, out_stride,
                   rows, e0, dh);
  }
  if (piece == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ch::row_of(i);
      if (r >= rows) continue;
      float* st = stats + ((int64_t)bh * N + q0 + r) * 3;
      st[0] = m[i];
      st[1] = l[i];
      st[2] = rs[i];
    }
  }
}

// Block (batch row, head, 64-key chunk, 64-dim piece): that piece of dk (DK)
// and dv (DV) of the chunk's keys, summed over every query tile with p (and
// ds) formed from the statistics.
template <typename T, bool DK, bool DV>
__global__ void __launch_bounds__(ch::kThreads)
attn_wide_bwd_keys(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ out,
                   long long out_stride, const float* __restrict__ stats, int N, int H, int dh,
                   int n_chunks, int n_pieces, float scale) {
  using ch::kStride;
  using ch::kT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* P = reinterpret_cast<float*>(smem);
  float* D = P + kT * kStride;
  T* As = reinterpret_cast<T*>(smem + 2 * ch::f32_tile_bytes());
  T* Bs = As + ch::kD * kStride;
  T* Gs = Bs + ch::kD * kStride;
  T* Qs = Gs + kT * kStride;

  const int piece = blockIdx.x % n_pieces;
  const int chunk = (blockIdx.x / n_pieces) % n_chunks;
  const int bh = blockIdx.x / (n_pieces * n_chunks);
  const int b = bh / H, h = bh % H;
  const int C = H * dh;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + (int64_t)h * dh;
  const T* gbase = g + (int64_t)b * N * C + (int64_t)h * dh;
  const int c0 = chunk * kT, len = min(kT, N - c0), e0 = piece * kT;
  const T* k = base + C + (int64_t)c0 * row3;
  const int tx = threadIdx.x % 16;

  float s[4][4], dp[4][4], dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;
  for (int q0 = 0; q0 < N; q0 += kT) {
    const int rows = min(kT, N - q0);
    const T* q = base + (int64_t)q0 * row3;
    const T* gq = gbase + (int64_t)q0 * C;
    ch::scores(s, q, row3, rows, k, row3, len, dh, As, Bs);
    if (DK) ch::scores(dp, gq, C, rows, k + C, row3, len, dh, As, Bs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ch::row_of(i);
      float mi = 0.f, li = 1.f, ri = 0.f;
      if (r < rows) {
        const float* st = stats + ((int64_t)bh * N + q0 + r) * 3;
        mi = st[0];
        li = st[1];
        ri = st[2];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool in = r < rows && c < len;
        const float p = in ? expf(s[i][j] * scale - mi) / li : 0.f;
        P[r * kStride + c] = p;
        if (DK) D[r * kStride + c] = in ? round_to<T>((p * (dp[i][j] - ri)) * scale) : 0.f;
      }
    }
    if (DV) ch::stage_rows(Gs, gq, C, rows, e0, dh);
    if (DK) ch::stage_rows(Qs, q, row3, rows, e0, dh);
    __syncthreads();
    if (DV) ch::cols_times<T, true>(dv, P, Gs);
    if (DK) ch::cols_times<T, false>(dk, D, Qs);
    __syncthreads();
  }
  T* obase = out + ((int64_t)b * N + c0) * out_stride + (int64_t)h * dh;
  if (DK) ch::store_tile(dk, obase + C, out_stride, len, e0, dh);
  if (DV) ch::store_tile(dv, obase + (DK ? 2 * C : 0), out_stride, len, e0, dh);
}

// Launches kernel `fn` on `grid` blocks of ch::kThreads with `smem` bytes,
// after its opt-in to the device's whole shared memory (`opted`, the
// kernel's own flags).
template <typename K, typename... A>
cudaError_t launch_wide_kernel(K fn, std::atomic<bool>* opted, unsigned grid, size_t smem,
                               cudaStream_t s, A... args) {
  cudaError_t err = devit::opt_in_smem((const void*)fn, opted);
  if (err != cudaSuccess) return err;
  fn<<<grid, ch::kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* qkv, const void* g, void* out, long long out_stride,
                        float* stats, int B, int N, int H, int dh, bool dqdk, bool dv,
                        float scale, cudaStream_t s) {
  static std::atomic<bool> opted[5][devit::kMaxDevices];
  const T* x = static_cast<const T*>(qkv);
  const T* gt = static_cast<const T*>(g);
  T* o = static_cast<T*>(out);
  const long long bh = (long long)B * H;
  const int tiles = (N + ch::kT - 1) / ch::kT, pieces = (dh + ch::kT - 1) / ch::kT;
  const size_t rows_smem = wide_rows_smem_bytes<T>(), keys_smem = wide_keys_smem_bytes<T>();
  cudaError_t err =
      dqdk ? launch_wide_kernel(attn_wide_bwd_rows<T, true>, opted[0],
                                (unsigned)(bh * tiles * pieces), rows_smem, s, x, gt, o,
                                out_stride, stats, N, H, dh, tiles, pieces, scale)
           : launch_wide_kernel(attn_wide_bwd_rows<T, false>, opted[1], (unsigned)(bh * tiles),
                                rows_smem, s, x, gt, o, out_stride, stats, N, H, dh, tiles, 1,
                                scale);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(bh * tiles * pieces);
  const float* st = stats;
  if (dqdk && dv)
    return launch_wide_kernel(attn_wide_bwd_keys<T, true, true>, opted[2], grid, keys_smem, s,
                              x, gt, o, out_stride, st, N, H, dh, tiles, pieces, scale);
  if (dqdk)
    return launch_wide_kernel(attn_wide_bwd_keys<T, true, false>, opted[3], grid, keys_smem, s,
                              x, gt, o, out_stride, st, N, H, dh, tiles, pieces, scale);
  return launch_wide_kernel(attn_wide_bwd_keys<T, false, true>, opted[4], grid, keys_smem, s, x,
                            gt, o, out_stride, st, N, H, dh, tiles, pieces, scale);
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
  } else {  // f32: the CUDA-core kernels above
    if (head_dim == 32)
      return launch_long_t<T, 32>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
    if (head_dim == 64)
      return launch_long_t<T, 64>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
    if (head_dim == 128)
      return launch_long_t<T, 128>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

namespace devit {
namespace bwd {

size_t long_smem_bytes(int dh, int elem) {
  if (dh > 128)  // the keys kernel's, the larger of the two
    return elem == 2 ? wide_keys_smem_bytes<__nv_bfloat16>() : wide_keys_smem_bytes<float>();
  if (elem == 2) return long_mma_smem_bytes(dh);
  return dqdk_smem_bytes<float>(long_chunk(dh), dh);
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
