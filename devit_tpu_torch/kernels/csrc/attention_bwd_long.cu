// The attention backward past kShortN (256) keys, at both dtypes: what the
// monolithic kernel (attention_bwd.cu) and the split pair
// (attention_bwd_split.cu) launch when N > 256.
//
// Replaces, for long sequences, devit_tpu/kernels/attention.py:
// _attn_bwd_kernel and the split pair _attn_bwd_dv_kernel /
// _attn_bwd_dqdk_kernel, which hold whole rows and so take any N. Numerics
// follow the TPU kernels: s = (q . k^T) * dh^-0.5 and p = softmax(s) in f32,
// dv = round(p)^T g with p rounded to the input dtype, dp = g v^T in f32, ds =
// round((p * (dp - rowsum(dp * p))) * scale) over the unrounded p, dq = ds k,
// dk = ds^T q; every product accumulates in f32 and is rounded once.
//
// Why a second design: a short-path block owns a whole (batch row, head), and
// its softmax needs the whole score row. At N 578 a block cannot hold the
// score rows and the resident K and V (240 KB of shared memory at f32 for the
// CUDA-core dv kernel's K alone), and the warps' registers hold dk and dv of
// 256 keys at most. So the long path walks 256-key chunks, as the forward's
// long path does (attention.cu), with the CUDA-core steps of bwd_common.cuh:
// 1. attn_bwd_long_rows: one block a (batch row, head, 32-query tile). It
//    walks the key chunks once for each row's max m, once for its sum l, and
//    (DQ) once for delta = rowsum(dp * p) and once more for dq = sum ds K,
//    written once. It writes (m, l, delta) in f32 to the caller's scratch.
// 2. attn_bwd_long_keys: one block a (batch row, head, 256-key chunk), the
//    chunk's K (and V) resident. It walks all query tiles, forms p =
//    exp(s - m) / l (and ds) from the statistics, and sums dv += round(p)^T g
//    and/or dk += ds^T q for its keys in registers, written once.
// The monolithic backward is rows<DQ> + keys<DK, DV>, the dv kernel rows +
// keys<DV>, the dq/dk kernel rows<DQ> + keys<DK>. Every output has one writer
// and nothing is summed with atomics, so repeat launches are bit-identical.
// A lane's partial max, sum and rowsum run over its columns l + 32 j in
// softmax_row's and ds_row's order, and the chunks are a multiple of 32 wide,
// so at f32 this path computes what the one-block-a-head steps would if their
// registers held the row.
//
// Head widths 32, 64 and 128: a lane owns dims l + 32 j, j < dh / 32. At dh
// 128 the chunks are 128 keys (long_chunk), so that an f32 block's K and V
// chunk fits beside the score rows; the monolithic wrapper also routes dh
// 128 here where its short block would not fit shared memory.
//
// What bounds it: speed past 256 keys is not a target (no training
// configuration runs there yet). It recomputes s four times (rows<DQ>) and
// once more per key chunk, on the CUDA cores; chip_smoke.py times it at N 578.

#include "bwd_common.cuh"

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

template <typename T>
cudaError_t launch_long_dh(const void* qkv, const void* g, void* out, long long out_stride,
                           float* stats, int B, int N, int H, int head_dim, bool dqdk, bool dv,
                           float scale, cudaStream_t s) {
  if (head_dim == 32)
    return launch_long_t<T, 32>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
  if (head_dim == 64)
    return launch_long_t<T, 64>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
  if (head_dim == 128)
    return launch_long_t<T, 128>(qkv, g, out, out_stride, stats, B, N, H, dqdk, dv, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

namespace devit {
namespace bwd {

size_t long_smem_bytes(int dh, int elem) {
  const int chunk = long_chunk(dh);
  return elem == 2 ? dqdk_smem_bytes<__nv_bfloat16>(chunk, dh) : dqdk_smem_bytes<float>(chunk, dh);
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
