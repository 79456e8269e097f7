// Backward of the fused multi-head self-attention: dqkv from qkv and the
// output's gradient g.
//
// Replaces devit_tpu/kernels/attention.py:_attn_bwd_kernel (the monolithic
// Pallas backward behind make_trainable_attention). Same contract: the inputs
// are the raw (B, N, 3C) qkv, ordered [q | k | v] and head-major inside each
// third, and g of shape (B, N, C); the output dqkv has qkv's shape and dtype.
// Only qkv is saved by the forward, so the probabilities are recomputed here.
//
// Numerics follow the TPU kernel: s = (q . k^T) * dh^-0.5 and p = softmax(s)
// in f32; dv = round(p)^T g, with p rounded to v's dtype; dp = g v^T in f32;
// ds = round((p * (dp - rowsum(dp * p))) * scale), with the rowsum over the
// unrounded f32 p; dq = ds k and dk = ds^T q. Every product accumulates in
// f32 and is rounded to the input dtype once, when it is written.
//
// What bounds it on an H100: one launch reads qkv and g once and writes dqkv
// once, 7 * B * N * C elements, against about 10 * B * N^2 * C FLOPs (s, dv,
// dp, dq, dk), i.e. ~140 FLOP per byte in bf16 at N = 198: under the ~295 at
// which the tensor cores would be the limit, so the bound is memory bandwidth
// (B = 256, 6 heads: 272.5 MB, ~0.081 ms at 3.35 TB/s). This first version
// computes every product with f32 FMAs on the CUDA cores from shared memory,
// and recomputes s once more than the bound counts, so its time is set by
// that arithmetic, far above the bound; chip_smoke.py prints both.
//
// Design: dk and dv sum over all N queries of one (batch row, head), so one
// block owns a whole (batch row, head) and loops over 32-query tiles: no two
// blocks write the same output, nothing is summed with atomics, and the
// result is the same on every run. K and V of the head stay in shared memory
// for the whole block; the tile's f32 p and dp/ds (32 x N each) sit beside
// them. The dk and dv sums live in registers: thread (warp w, lane l) owns
// rows c = w + 16 i of dims l and l + 32, which caps N at 16 * kMaxCPerWarp
// = 256.
// Holding both sums would double those registers, so the block makes two
// passes over the query tiles: pass 1 recomputes p and sums dv; pass 2
// recomputes p, forms dp and ds, writes each tile's dq (a tile owns its rows
// of dq) and sums dk. At N = 198 a block takes ~109 KB of shared memory in
// bf16 and ~166 KB in f32.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using devit::from_f;
using devit::round_to;
using devit::score_stride;
using devit::to_f;
using devit::warp_max;
using devit::warp_sum;

constexpr int kBQ = 32;        // query rows per tile
constexpr int kThreads = 512;  // 16 warps; warp w owns tile rows 2w and 2w+1
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCPerWarp = 16;  // key rows of dk/dv a warp holds: N <= 256
constexpr int kMaxN = kWarps * kMaxCPerWarp;
static_assert(kBQ == 2 * kWarps, "each warp owns two rows of a tile");

// K and V rows are padded by one 32-bit word, so that the 32 lanes of a warp
// reading one dim of 32 consecutive rows hit 32 different banks.
template <typename T> __host__ __device__ constexpr int kv_stride(int dh) {
  return dh + (int)(4 / sizeof(T));
}

template <typename T>
size_t smem_bytes_t(int n, int dh) {
  // P, D [kBQ][stride] f32 | K, V [N][kv_stride] T | Q, G [kBQ][dh] T
  return sizeof(float) * 2 * (size_t)kBQ * score_stride(n) +
         sizeof(T) * (2 * (size_t)n * kv_stride<T>(dh) + 2 * (size_t)kBQ * dh);
}

// Shared memory of one block at sequence length n, or -1 past kMaxN (the
// registers that hold dk and dv bound N, not the shared memory).
long long smem_bytes(int n, int dh, int elem) {
  if (n > kMaxN) return -1;
  return (long long)(elem == 2 ? smem_bytes_t<__nv_bfloat16>(n, dh) : smem_bytes_t<float>(n, dh));
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

// acc[i][j] += sum_{r < rows} W[r][c] * X[r][d] for the thread's rows
// c = warp + 16 i and dims d = lane + 32 j (dv += round(p)^T g with W = P,
// X = G, rounding W to T; dk += ds^T q with W = D, X = Q). A warp reads one
// W value per c (a broadcast) and two X values per r.
template <typename T, int DH, bool kRoundW>
__device__ __forceinline__ void accumulate_keys(float (&acc)[kMaxCPerWarp][2], const float* W,
                                                const T* X, int N, int SP, int rows) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = 0; r < rows; ++r) {
    const float x0 = to_f(X[r * DH + lane]), x1 = to_f(X[r * DH + lane + 32]);
    const float* wrow = W + r * SP;
#pragma unroll
    for (int i = 0; i < kMaxCPerWarp; ++i) {
      const int c = warp + kWarps * i;
      if (c < N) {
        const float w = kRoundW ? round_to<T>(wrow[c]) : wrow[c];
        acc[i][0] = fmaf(w, x0, acc[i][0]);
        acc[i][1] = fmaf(w, x1, acc[i][1]);
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                int N, int H, float scale) {
  static_assert(DH == 64, "a lane owns dims l and l + 32");
  constexpr int KS = kv_stride<T>(DH);

  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = score_stride(N);
  float* P = reinterpret_cast<float*>(smem);  // p of the tile (f32)
  float* D = P + kBQ * SP;                    // dp, then ds, of the tile
  T* Ks = reinterpret_cast<T*>(D + kBQ * SP);
  T* Vs = Ks + N * KS;
  T* Qs = Vs + N * KS;  // the tile's q rows, zero past N
  T* Gs = Qs + kBQ * DH;  // the tile's g rows, zero past N

  const int C = H * DH;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  T* obase = dqkv + (int64_t)b * N * row3 + h * DH;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < N * DH; i += kThreads) {
    const int n = i / DH, d = i % DH;
    const T* row = base + (int64_t)n * row3;
    Ks[n * KS + d] = row[C + d];
    Vs[n * KS + d] = row[2 * C + d];
  }

  for (int pass = 0; pass < 2; ++pass) {
    float acc[kMaxCPerWarp][2];  // dv (pass 1), then dk (pass 2)
#pragma unroll
    for (int i = 0; i < kMaxCPerWarp; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int q0 = 0; q0 < N; q0 += kBQ) {
      const int rows = min(kBQ, N - q0);
      __syncthreads();  // the previous tile's readers of Q, G, P, D are done
      for (int i = threadIdx.x; i < kBQ * DH; i += kThreads) {
        const int r = i / DH, d = i % DH;
        const bool in = r < rows;
        Qs[i] = in ? base[(int64_t)(q0 + r) * row3 + d] : from_f<T>(0.f);
        Gs[i] = in ? gbase[(int64_t)(q0 + r) * C + d] : from_f<T>(0.f);
      }
      __syncthreads();
      rows_times_keys<T, DH>(Qs, Ks, P, N, SP, scale);
      if (pass == 1) rows_times_keys<T, DH>(Gs, Vs, D, N, SP, 1.f);
      // Each warp finishes its own two rows; a lane reads only the columns it
      // wrote, so no barrier is needed between the products and this step.
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r >= rows) continue;  // rows past N: never read below
        float* prow = P + r * SP;
        softmax_row(prow, N);
        if (pass == 0) continue;
        float* drow = D + r * SP;
        float rs = 0.f;
        for (int c = lane; c < N; c += 32) rs = fmaf(drow[c], prow[c], rs);
        rs = warp_sum(rs);
        for (int c = lane; c < N; c += 32)
          drow[c] = round_to<T>((prow[c] * (drow[c] - rs)) * scale);
      }
      __syncthreads();
      if (pass == 0) {
        accumulate_keys<T, DH, true>(acc, P, Gs, N, SP, rows);  // dv += round(p)^T g
        continue;
      }
      accumulate_keys<T, DH, false>(acc, D, Qs, N, SP, rows);  // dk += ds^T q
      // dq = ds k for the warp's two rows, dims lane and lane + 32
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r >= rows) continue;
        const float* drow = D + r * SP;
        float s0 = 0.f, s1 = 0.f;
        for (int c = 0; c < N; ++c) {
          const float ds = drow[c];
          s0 = fmaf(ds, to_f(Ks[c * KS + lane]), s0);
          s1 = fmaf(ds, to_f(Ks[c * KS + lane + 32]), s1);
        }
        T* out = obase + (int64_t)(q0 + r) * row3;
        out[lane] = from_f<T>(s0);
        out[lane + 32] = from_f<T>(s1);
      }
    }
    const int third = pass == 0 ? 2 : 1;  // pass 1 summed dv, pass 2 dk
#pragma unroll
    for (int i = 0; i < kMaxCPerWarp; ++i) {
      const int c = warp + kWarps * i;
      if (c >= N) continue;
      T* out = obase + (int64_t)c * row3 + third * C;
      out[lane] = from_f<T>(acc[i][0]);
      out[lane + 32] = from_f<T>(acc[i][1]);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, int B, int N, int H,
                   cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  if (N > kMaxN) return cudaErrorInvalidValue;
  attn_bwd_kernel<T, DH><<<(unsigned)B * H, kThreads, smem_bytes_t<T>(N, DH), stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(g), static_cast<T*>(dqkv), N, H,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one backward block needs at sequence length n.
// -1 if n is past what the kernel takes at all.
long long devit_attention_bwd_smem_bytes(int n, int head_dim, int elem_bytes) {
  return smem_bytes(n, head_dim, elem_bytes);
}

// qkv: (B, N, 3*H*head_dim), g: (B, N, H*head_dim), dqkv: like qkv; all
// contiguous and of one dtype (0 = float32, 1 = bfloat16). Returns a
// cudaError_t (0 = launched).
int devit_attention_bwd(const void* qkv, const void* g, void* dqkv, int B, int N, int H,
                        int head_dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float, 64>(qkv, g, dqkv, B, N, H, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, 64>(qkv, g, dqkv, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
