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
// HBM, would be the limit. So the bound is memory bandwidth (B = 256, 5 heads:
// ~130 MB, ~39 us at 3.35 TB/s). This first version computes both products
// with f32 FMAs on the CUDA cores (no mma/wgmma) and reads its operands from
// shared memory, so its time is set by that arithmetic and those shared-memory
// reads, far above the memory bound; chip_smoke.py prints both.
//
// Design: the whole N-wide score row fits in shared memory, as it fits in
// VMEM on the TPU. Each block owns (batch row, head, 64-query tile), stages
// that head's K (transposed, so a warp reads consecutive keys) and V and its
// Q tile in shared memory once, and keeps the 64 x N f32 score tile there
// between the two products, so no score or probability reaches device
// memory. At N = 198 a bf16 block takes ~107 KB (two blocks per SM), an f32
// block ~165 KB.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using devit::from_f;
using devit::score_stride;
using devit::to_f;
using devit::warp_max;
using devit::warp_sum;

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // 8 warps: 16 column lanes x 16 row groups of 4

size_t smem_bytes(int n, int head_dim, int elem) {
  // S [kBQ][stride] f32 | K^T [dh][N] | V [N][dh] | Q^T [dh][kBQ]  (T = elem bytes)
  return (size_t)kBQ * score_stride(n) * sizeof(float) +
         (size_t)elem * (2 * (size_t)n * head_dim + (size_t)head_dim * kBQ);
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
  T* Kt = reinterpret_cast<T*>(S + kBQ * SP);
  T* Vs = Kt + DH * N;
  T* Qt = Vs + N * DH;

  const int C = H * DH;
  const int tile = blockIdx.x % n_tiles;
  const int b = blockIdx.x / n_tiles;
  const int h = blockIdx.y;
  const int q0 = tile * kBQ;
  const int64_t row_stride = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row_stride + h * DH;

  // ---- stage K^T, V (whole sequence) and Q^T (this tile) in shared memory
  for (int i = threadIdx.x; i < N * DH; i += kThreads) {
    const int n = i / DH, d = i % DH;
    const T* row = base + (int64_t)n * row_stride;
    Kt[d * N + n] = row[C + d];
    Vs[n * DH + d] = row[2 * C + d];
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
cudaError_t launch(const void* qkv, void* out, int B, int N, int H, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(N, DH, sizeof(T));
  const int n_tiles = (N + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)B * n_tiles, (unsigned)H);
  attn_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, n_tiles,
      1.0f / sqrtf((float)DH));
  return cudaGetLastError();
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
// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int devit_fused_attention(const void* qkv, void* out, int B, int N, int H,
                          int head_dim, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float, 64>(qkv, out, B, N, H, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16, 64>(qkv, out, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* devit_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
