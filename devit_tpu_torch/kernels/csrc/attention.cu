// Fused multi-head self-attention over the raw fused-qkv activations.
//
// Replaces devit_tpu/kernels/attention.py:_attn_kernel (the Pallas TPU kernel
// behind fused_attention). Same contract: the input is the (B, N, 3C) output
// of the qkv matmul, ordered [q | k | v] and head-major inside each third;
// the output is the proj-ready (B, N, C) layout. No (3, B, H, N, dh)
// transpose is ever written to device memory.
//
// Numerics follow the TPU kernel exactly: logits q.k^T in f32, scaled by
// dh^-0.5; a two-pass softmax in f32 (row max, exp, sum, divide); the
// probabilities are rounded to v's dtype before p.v, which accumulates in
// f32; the result is rounded to the input dtype. Keys at or past N are never
// read, which is the same as masking them to -inf before the max. Query rows
// at or past N are never written.
//
// What bounds it on an H100: at the serving shapes (N = 198, dh = 64, bf16)
// one launch reads each qkv byte once and writes each output byte once, about
// 4 * B * N * C * 2 bytes, against 4 * B * N^2 * C FLOPs (two products):
// N/2 = 99 FLOP per byte, under the ~295 FLOP/byte at which the tensor cores, not
// HBM, would be the limit. So the bound is memory bandwidth (B = 256, 6 heads:
// ~156 MB, ~47 us at 3.35 TB/s).
//
// bf16 (attn_kernel_mma): both products on the tensor cores, as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators, which is what
// the TPU's MXU computes here (exact bf16 products summed in f32). A block
// owns (batch row, head, a run of 64-query tiles) and has 4 warps, each
// owning 16 query rows of a tile, so no two blocks write the same output. It
// stages the head's K and V once, and its q tiles, with 16-byte cp.async into
// XOR-swizzled shared memory (rows zero-filled to a multiple of 16), so
// ldmatrix reads them without bank conflicts; the next tile's q arrives
// while the current one computes. The launcher gives a block all of a
// head's tiles when the heads alone make four blocks an SM (0.177 against
// 0.199 ms for one tile a block at B 256, kh 6, on the H100), and shorter
// runs at small batches. S = Q K^T takes A from ldmatrix of Q (held in
// registers) and B from ldmatrix of K's rows; the 16 x N f32 score rows stay
// in registers (at most 128 a lane, N <= 256) and the row max and sum reduce
// over the 4 lanes of a quad. p = e / sum is the IEEE quotient from one
// reciprocal a row and an FMA correction (div_rn), a third of the
// instructions of `/`, which took 38% of the kernel's time. O = P V takes V
// through ldmatrix.trans, and p never leaves registers: the rounded, packed
// accumulators of two adjacent key tiles are the A fragment of the next mma.
// o goes out through shared memory as 16-byte stores. Past N = 256 the keys
// come in 256-key chunks and S is recomputed per chunk: once for the row
// max, once for the sum, once for p . v (the exact two-pass softmax without
// a score tile in shared memory). What bounds it: the f32 softmax (expf, the
// divisions) on 8 warps an SM (the score registers allow two blocks), and
// the padding of N = 198 to 208 keys and 256 query rows. The steps on a
// warp's rows (attend_rows and its chunk_* steps) live in attn_mma.cuh,
// which block_attention.cu's bf16 kernel shares.
//
// Head widths: every kernel is instantiated for dh 32, 64 and 128 (the
// wrapper raises on any other). At bf16 the swizzled tiles hold rows of dh
// bf16 (swz_dh in mma_common.cuh); a warp's q fragments, o accumulators and
// the key and value steps scale with dh.
//
// f32 (attn_kernel): f32 FMAs on the CUDA cores, reading its operands from
// shared memory. It stays off the tensor cores because the f32 tolerance is
// 1e-4 and a TF32 mma keeps ~10 mantissa bits of each operand, too few. The
// whole N-wide score row sits in shared memory, as it fits in VMEM on the
// TPU: each block owns (batch row, head, 64-query tile), stages that head's
// K (transposed, so a warp reads consecutive keys) and V and its Q tile in
// shared memory once, and keeps the 64 x N f32 score tile there between the
// two products, so no score or probability reaches device memory (~165 KB a
// block at N = 198). At dh 128, K^T and V of N 198 would not fit beside S
// (280 KB), so V takes K^T's place once S is formed (~181 KB a block).

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "attn_mma.cuh"
#include "common.cuh"
#include "mma_common.cuh"

namespace {

using devit::from_f;
using devit::score_stride;
using devit::to_f;
using devit::warp_max;
using devit::warp_sum;

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // f32: 8 warps, 16 column lanes x 16 row groups of 4
constexpr int kMmaThreads = 128;  // bf16: 4 warps, 16 query rows each

// f32 at dh > 64: V shares K^T's region (staged once S is formed).
__host__ __device__ constexpr bool shares_kv(int head_dim) { return head_dim > 64; }

size_t smem_bytes(int n, int head_dim, int elem) {
  if (elem == 2)  // bf16: Q [2][kBQ][dh] | K [NP][dh] | V [NP][dh], NP = N rounded up to 16
    return (size_t)2 * head_dim * (2 * kBQ + 2 * (size_t)((n + 15) & ~15));
  // f32: S [kBQ][stride] | K^T [dh][N] | V [N][dh] (or V over K^T) | Q^T [dh][kBQ]
  const size_t kv = (shares_kv(head_dim) ? 1 : 2) * (size_t)n * head_dim;
  return (size_t)kBQ * score_stride(n) * sizeof(float) +
         (size_t)elem * (kv + (size_t)head_dim * kBQ);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int H,
            int n_tiles, float scale) {
  static_assert(DH % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DJ = DH / 16;  // output dims per thread

  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = score_stride(N);
  float* S = reinterpret_cast<float*>(smem);
  constexpr bool kShare = shares_kv(DH);
  T* Kt = reinterpret_cast<T*>(S + kBQ * SP);
  T* Vs = kShare ? Kt : Kt + DH * N;
  T* Qt = Vs + N * DH;

  const int C = H * DH;
  const int tile = blockIdx.x % n_tiles;
  const int b = blockIdx.x / n_tiles;
  const int h = blockIdx.y;
  const int q0 = tile * kBQ;
  const int64_t row_stride = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row_stride + h * DH;

  // ---- stage K^T, V (whole sequence; V later where it shares K^T's place)
  // and Q^T (this tile) in shared memory
  for (int i = threadIdx.x; i < N * DH; i += kThreads) {
    const int n = i / DH, d = i % DH;
    const T* row = base + (int64_t)n * row_stride;
    Kt[d * N + n] = row[C + d];
    if (!kShare) Vs[n * DH + d] = row[2 * C + d];
  }
  for (int i = threadIdx.x; i < kBQ * DH; i += kThreads) {
    const int r = i / DH, d = i % DH;
    const int n = q0 + r;
    Qt[d * kBQ + r] = n < N ? base[(int64_t)n * row_stride + d] : from_f<T>(0.f);
  }
  __syncthreads();

  const int tx = threadIdx.x % 16;  // column lane
  const int ty = threadIdx.x / 16;  // row group: rows 4*ty .. 4*ty+3

  // ---- S = (q . k^T) * scale, f32, 64 key columns per pass
  for (int c0 = 0; c0 < N; c0 += 64) {
    float acc[4][4];
    int col[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) col[j] = c0 + tx + 16 * j;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      float q[4], k[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = to_f(Qt[d * kBQ + 4 * ty + i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = col[j] < N ? to_f(Kt[d * N + col[j]]) : 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(q[i], k[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col[j] < N) S[(4 * ty + i) * SP + col[j]] = acc[i][j] * scale;
  }
  __syncthreads();
  if (kShare) {  // K^T is read no more: V takes its place
    for (int i = threadIdx.x; i < N * DH; i += kThreads)
      Vs[i] = base[(int64_t)(i / DH) * row_stride + 2 * C + i % DH];
  }

  // ---- softmax over each row's N keys, f32; p rounded to T (v's dtype)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    if (q0 + r >= N) continue;  // row past the sequence: never written
    float* row = S + r * SP;
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
    for (int c = lane; c < N; c += 32) row[c] = to_f(from_f<T>(row[c] / sum));
  }
  __syncthreads();

  // ---- O = p . v, f32 accumulation; rows 4*ty+i, dims tx + 16*j
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < N; ++c) {
    float p[4], v[DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = S[(4 * ty + i) * SP + c];
#pragma unroll
    for (int j = 0; j < DJ; ++j) v[j] = to_f(Vs[c * DH + tx + 16 * j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], v[j], acc[i][j]);
  }
  T* obase = out + (int64_t)b * N * C + h * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + 4 * ty + i;
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) obase[(int64_t)n * C + tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, void* out, int B, int N, int H, float scale,
                   cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(N, DH, sizeof(T));
  const int n_tiles = (N + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)B * n_tiles, (unsigned)H);
  attn_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, n_tiles,
      scale);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores

using devit::mma::attend_rows;
using devit::mma::bf16;
using devit::mma::ldmatrix_x4;
using devit::mma::pack_bf16;
using devit::mma::swz_dh;

// One block: (batch row, head, a run of tpb 64-query tiles); 4 warps of 16
// query rows. K and V of the head are staged once a block; the next tile's q
// rows arrive (cp.async) while the current tile computes. KC key steps of 16 are
// held in registers at once: N <= 16 * KC takes one chunk, a larger N
// (KC = 16) walks 256-key chunks three times. DH: the head width.
template <int KC, int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
attn_kernel_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                int n_tiles, int tpb, float scale) {
  constexpr int kShift = devit::mma::chunk_shift<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = (N + 15) & ~15;
  bf16* Qbuf = reinterpret_cast<bf16*>(smem);  // two [kBQ][dh] q tiles
  bf16* Ks = Qbuf + 2 * kBQ * DH;
  bf16* Vs = Ks + NP * DH;

  const int C = H * DH;
  const int n_runs = (n_tiles + tpb - 1) / tpb;
  const int t0 = (blockIdx.x % n_runs) * tpb;
  const int t1 = min(n_tiles, t0 + tpb);
  const int b = blockIdx.x / n_runs;
  const int h = blockIdx.y;
  const int64_t row3 = 3LL * C;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  bf16* obase = out + (int64_t)b * N * C + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp;  // the warp's first row in a tile

  devit::mma::load_rows<DH>(Ks, base + C, row3, NP, N, tid, kMmaThreads);
  devit::mma::load_rows<DH>(Vs, base + 2 * C, row3, NP, N, tid, kMmaThreads);
  devit::mma::load_rows<DH>(Qbuf, base + (int64_t)t0 * kBQ * row3, row3, kBQ, N - t0 * kBQ, tid,
                            kMmaThreads);
  for (int tile = t0; tile < t1; ++tile) {
    bf16* Qs = Qbuf + ((tile - t0) & 1) * kBQ * DH;
    devit::mma::cp_async_wait_all();
    __syncthreads();  // this tile's q (and K, V) landed; the other buffer is free
    if (tile + 1 < t1)
      devit::mma::load_rows<DH>(Qbuf + ((tile + 1 - t0) & 1) * kBQ * DH,
                            base + (int64_t)(tile + 1) * kBQ * row3, row3, kBQ,
                            N - (tile + 1) * kBQ, tid, kMmaThreads);
    const int q0 = tile * kBQ;
    if (q0 + r0 >= N) continue;  // all 16 rows past the sequence

    uint32_t qa[DH / 16][4];  // A fragments of the warp's 16 q rows, one per 16 dims
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      ldmatrix_x4(qa[ks], Qs + swz_dh<DH>(r0 + (lane & 15), 2 * ks + (lane >> 4)));
    float o[DH / 8][4];
    attend_rows<KC, DH>(o, qa, Ks, Vs, N, scale, lane);

    // o rounded once into the warp's own 16 rows of Qs, then 16-byte stores
    __syncwarp();
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + (lane >> 2) + 8 * half;
        *reinterpret_cast<uint32_t*>(Qs + swz_dh<DH>(r, t) + 2 * (lane & 3)) =
            pack_bf16(o[t][2 * half], o[t][2 * half + 1]);
      }
    __syncwarp();
    for (int i = lane; i < 16 * (DH / 8); i += 32) {
      const int r = i >> kShift, c = i & (DH / 8 - 1);
      const int n = q0 + r0 + r;
      if (n < N)
        *reinterpret_cast<uint4*>(obase + (int64_t)n * C + 8 * c) =
            *reinterpret_cast<const uint4*>(Qs + swz_dh<DH>(r0 + r, c));
    }
  }
}

template <int KC, int DH>
cudaError_t launch_mma(const void* qkv, void* out, int B, int N, int H, float scale,
                       cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_kernel_mma<KC, DH>, opted_in);
  if (err != cudaSuccess) return err;
  static std::atomic<int> sms[devit::kMaxDevices];
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev].load(std::memory_order_relaxed) == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(v, std::memory_order_relaxed);
  }
  // A block walks all of a head's query tiles (K and V staged once) when the
  // heads alone give four blocks an SM; otherwise the tiles are split into
  // runs until they do (at most one tile a block).
  const int n_tiles = (N + kBQ - 1) / kBQ;
  const long long heads = (long long)B * H, want = 4LL * sms[dev].load();
  const int runs = (int)std::min<long long>(n_tiles, (want + heads - 1) / heads);
  const int tpb = (n_tiles + runs - 1) / runs;
  const dim3 grid((unsigned)(B * ((n_tiles + tpb - 1) / tpb)), (unsigned)H);
  attn_kernel_mma<KC, DH><<<grid, kMmaThreads, smem_bytes(N, DH, 2), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, n_tiles, tpb,
      scale);
  return cudaGetLastError();
}

// The fewest score registers that hold the row: N <= 64, 128, 208 (the
// deployed N = 198), 256; past 256, 256-key chunks.
template <int DH>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int N, int H, float scale,
                        cudaStream_t s) {
  if (N <= 64) return launch_mma<4, DH>(qkv, out, B, N, H, scale, s);
  if (N <= 128) return launch_mma<8, DH>(qkv, out, B, N, H, scale, s);
  if (N <= 208) return launch_mma<13, DH>(qkv, out, B, N, H, scale, s);
  return launch_mma<16, DH>(qkv, out, B, N, H, scale, s);
}

template <int DH>
cudaError_t launch_dh(const void* qkv, void* out, int B, int N, int H, int dtype,
                      float scale, cudaStream_t s) {
  if (dtype == 0) return launch<float, DH>(qkv, out, B, N, H, scale, s);
  if (dtype == 1) return launch_bf16<DH>(qkv, out, B, N, H, scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at sequence length n.
long long devit_attention_smem_bytes(int n, int head_dim, int elem_bytes) {
  return (long long)smem_bytes(n, head_dim, elem_bytes);
}

// The most dynamic shared memory a block may opt in to on `device`, or -1.
long long devit_max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

// qkv: (B, N, 3*H*head_dim) contiguous; out: (B, N, H*head_dim) contiguous.
// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64 or 128. scale multiplies
// the logits: head_dim^-0.5, or a narrower head's dh^-0.5 when the caller has
// zero-padded its heads to head_dim. Returns a cudaError_t (0 = launched).
int devit_fused_attention(const void* qkv, void* out, int B, int N, int H,
                          int head_dim, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return (int)launch_dh<32>(qkv, out, B, N, H, dtype, scale, s);
  if (head_dim == 64) return (int)launch_dh<64>(qkv, out, B, N, H, dtype, scale, s);
  if (head_dim == 128) return (int)launch_dh<128>(qkv, out, B, N, H, dtype, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* devit_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
