// Int8 matmul with dynamic per-row activation quantization, on the int8
// tensor cores.
//
// Replaces devit_tpu/kernels/quant.py:_quant_matmul_kernel (the Pallas TPU
// kernel behind fused_int8_matmul). Same contract and the same arithmetic as
// the plain dynamic_int8_matmul: x (M, K) f32 or bf16; the (K, N) int8
// weight, here in the layout the tensor cores take, w_nk (N, Kp): row n holds
// column n of w_q, K bytes zero-padded to Kp (a multiple of 32), built once by
// QuantizedLinear; w_scale (N,) and bias (N,) f32 (bias may be absent); out
// (M, N) f32 or bf16. Per row: amax = max |x| in f32, xs = max(amax, 1e-8) /
// 127, x_q = clip(rint(x / xs), -127, 127) with an IEEE division and
// round-half-even (the library is built without fast math); acc = x_q . w_q
// in int32, exact; y = (float)acc * xs * w_scale[n] + bias[n] in f32, each
// step rounded on its own (the intrinsics keep nvcc from contracting the
// product and the add into an FMA), then rounded to the output type. The
// int32 sums are exact in any order, so the output is the plain version's
// bit for bit.
//
// What bounds it on an H100: one call must read x (2 M K bytes in bf16) and
// w_q (K N), and write the output (2 M N); it does 2 M K N int8 operations.
// At the serving shapes (M = B * 198, K and N of 64..1536) that is K N / (K +
// N) operations a byte, ~50-380, below the ~590 at which the int8 tensor
// cores (1979 TOP/s) rather than HBM (3.35 TB/s) would be the limit: memory.
//
// Design: two launches a call.
// - quant_rows_kernel (a warp a row): amax, the scale, and the row's codes
//   into an (M, Kp) int8 scratch (zero past K) and an (M,) f32 scale that
//   the wrapper allocates. It reads x once and writes M Kp bytes, which the
//   GEMM reads back: 2 M Kp bytes more than the bound counts, against
//   re-quantizing x in every column block of the GEMM. x / xs is one
//   reciprocal a row and an FMA correction (div_rn, the IEEE quotient for
//   normal results; rint takes anything smaller to 0 either way): 7.26 ->
//   6.73 ms over a bs256 int8 forward's 192 calls on the H100, every code
//   the same (scripts/kernel_variants.py).
// - quant_mma_kernel: one block a 128 x 128 output tile, the column tiles of
//   a row tile adjacent in the launch order, so the blocks in flight share x
//   rows in L2. Eight warps, each 64 rows x 32 columns (4 x 4 m16n8 tiles,
//   64 int32 accumulators a lane, 128 registers: two blocks an SM). K comes
//   in 128-byte chunks through a three-stage cp.async ring into XOR-swizzled
//   tiles (codes [128][128], weight [128][128]); ldmatrix brings the
//   fragments, mma.sync m16n8k32 s8 sums them exactly. Shared memory does
//   not grow with K (96 KB a block). The epilogue loads every scale before
//   its first store and goes out through a padded shared tile as 16-byte
//   stores (per-element scale loads and 4-byte stores took 21.8 against 15.0
//   ms of the forward's GEMM time, scripts/kernel_variants.py on the H100).
//   Rows past M and columns past N are zero-filled on the way in and never
//   stored. Every output has one writer: no atomics, the same bits on every
//   run. Measured on the H100 and not kept: a persistent grid whose ring ran
//   across tiles (2% faster but spilled), 256-row tiles (one block an SM; 4%
//   slower), 16-byte row loads and a row held in registers (both slower).
//   What holds it back: at K 384 a block runs three chunks, so the ring's
//   first load and the epilogue are exposed; the GEMM does a bs256 int8
//   forward's 5.4 T operations at ~366 T/s. wgmma with TMA is the next step.

#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "mma_common.cuh"

namespace {

using devit::from_f;
using devit::warp_max;
using devit::mma::cp_async16;
using devit::mma::ldmatrix_x4;
using devit::mma::mma_s8;
using devit::mma::swz8;

constexpr int kRowThreads = 256;   // quant_rows_kernel: a warp a row
constexpr int kBM = 128;           // output rows of a GEMM tile
constexpr int kBN = 128;           // output columns of a GEMM tile
constexpr int kBK = 128;           // bytes of K a stage
constexpr int kStages = 3;
constexpr int kThreads = 256;      // 8 warps: 2 (rows) x 4 (columns) of 64 x 32
constexpr int kStageBytes = (kBM + kBN) * kBK;

size_t smem_bytes() { return (size_t)kStages * kStageBytes; }

// Four consecutive values of a row as f32 (8 bytes of bf16, 16 of f32).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
  const float2 lo = __bfloat1622float2(h[0]), hi = __bfloat1622float2(h[1]);
  v[0] = lo.x, v[1] = lo.y, v[2] = hi.x, v[3] = hi.y;
}

// A warp a row: amax over the row's K values, four a lane a load (unrolled,
// so several loads are in flight); the scale; then the codes (zero past K)
// into the row of the (M, Kp) scratch.
template <typename TI>
__global__ void __launch_bounds__(kRowThreads)
quant_rows_kernel(const TI* __restrict__ x, int8_t* __restrict__ xq, float* __restrict__ x_scale,
                  int64_t M, int K, int Kp) {
  const int64_t m = (int64_t)blockIdx.x * (kRowThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const TI* row = x + m * K;
  float amax = 0.f;
#pragma unroll 4
  for (int g = lane; g < K / 4; g += 32) {
    float v[4];
    load4(row + 4 * g, v);
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[0]), fabsf(v[1])), fmaxf(fabsf(v[2]), fabsf(v[3]))));
  }
  const float xs = fmaxf(warp_max(amax), 1e-8f) / 127.0f;
  const float rxs = __frcp_rn(xs);
  uint32_t* qrow = reinterpret_cast<uint32_t*>(xq + m * Kp);
#pragma unroll 4
  for (int g = lane; g < Kp / 4; g += 32) {
    uint32_t packed = 0;
    if (g < K / 4) {
      float v[4];
      load4(row + 4 * g, v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q = fminf(fmaxf(rintf(devit::mma::div_rn(v[j], xs, rxs)), -127.f), 127.f);
        packed |= ((uint32_t)(int)q & 0xffu) << (8 * j);
      }
    }
    qrow[g] = packed;
  }
  if (lane == 0) x_scale[m] = xs;
}

// One stage: codes rows m0.. and weight rows n0.., bytes k0 .. k0 + 127 of
// each, zero-filled past M, N and Kp.
__device__ __forceinline__ void load_stage(unsigned char* st, const int8_t* xq, const int8_t* w,
                                           int64_t m0, int n0, int k0, int64_t M, int N, int Kp,
                                           int tid) {
#pragma unroll
  for (int j = 0; j < (kBM + kBN) * 8 / kThreads; ++j) {
    const int i = tid + j * kThreads;
    const int r = (i >> 3) % kBM, c = i & 7;  // i < kBM * 8: codes; then weight
    const bool is_w = i >= kBM * 8;
    const int k = k0 + 16 * c;
    const bool ok = k < Kp && (is_w ? n0 + r < N : m0 + r < M);
    const int8_t* src = is_w ? w + (int64_t)(n0 + r) * Kp + k : xq + (m0 + r) * Kp + k;
    cp_async16(st + (is_w ? kBM * kBK : 0) + swz8(r, c), ok ? src : xq, ok);
  }
}

// The epilogue of one output tile: (float)acc * xs * w_scale (+ bias),
// rounded step by step, then to TO. With N a multiple of 16 bytes' worth of
// TO, the tile goes through shared memory (rows padded by 16 bytes, so
// neither side conflicts on banks) and out as 16-byte stores; otherwise
// straight from the registers.
template <typename TO>
__device__ __forceinline__ void epilogue(const int (&acc)[4][4][4], unsigned char* smem,
                                         const float* x_scale, const float* ws, const float* bias,
                                         TO* out, int64_t m0, int n0, int64_t M, int N, int wm,
                                         int wn, int tid, int lane) {
  // every scale and bias the lane needs, loaded before the first store
  float xs[4][2], sc[4][2], bi[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + 16 * i + (lane >> 2) + 8 * half;
      xs[i][half] = m < M ? x_scale[m] : 0.f;
    }
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn + 8 * t + 2 * (lane & 3) + e;
      sc[t][e] = n < N ? ws[n] : 0.f;
      bi[t][e] = bias != nullptr && n < N ? bias[n] : 0.f;
    }
  // y of the accumulator element (i, t, e): row 16i + lane/4 + 8(e/2), column
  // 8t + 2(lane%4) + e%2 of the warp's block
  auto y = [&](int i, int t, int e) {
    const float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][t][e]), xs[i][e >> 1]),
                              sc[t][e & 1]);
    return bias != nullptr ? __fadd_rn(v, bi[t][e & 1]) : v;
  };
  constexpr int kVec = 16 / sizeof(TO);  // values a 16-byte store
  constexpr int kLd = kBN + kVec;        // staged row stride in values
  if (N % kVec == 0) {
    devit::mma::cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring
    TO* tile = reinterpret_cast<TO*>(smem);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          TO* dst = tile + (wm + 16 * i + (lane >> 2) + 8 * half) * kLd + wn + 8 * t +
                    2 * (lane & 3);
          if constexpr (sizeof(TO) == 4) {
            *reinterpret_cast<float2*>(dst) = make_float2(y(i, t, 2 * half), y(i, t, 2 * half + 1));
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) =
                __floats2bfloat162_rn(y(i, t, 2 * half), y(i, t, 2 * half + 1));
          }
        }
    __syncthreads();
    constexpr int kChunks = kBN / kVec;  // 16-byte chunks of a tile row
    for (int idx = tid; idx < kBM * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const int64_t m = m0 + r;
      const int n = n0 + c * kVec;
      if (m < M && n < N)
        *reinterpret_cast<uint4*>(out + m * N + n) =
            *reinterpret_cast<const uint4*>(tile + r * kLd + c * kVec);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + 16 * i + (lane >> 2) + 8 * half;
      if (m >= M) continue;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = n0 + wn + 8 * t + 2 * (lane & 3);
        TO* dst = out + m * N + n;
        const float y0 = y(i, t, 2 * half), y1 = y(i, t, 2 * half + 1);
        if ((N & 1) == 0 && n < N) {  // two adjacent columns a store
          if constexpr (sizeof(TO) == 4) {
            *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
          }
        } else {
          if (n < N) dst[0] = from_f<TO>(y0);
          if (n + 1 < N) dst[1] = from_f<TO>(y1);
        }
      }
    }
}

// The 32-byte K steps of one staged chunk: A (codes) and B (weight) through
// ldmatrix, 16 mma a step into the warp's 64 x 32 accumulators.
__device__ __forceinline__ void chunk_mma(int (&acc)[4][4][4], const unsigned char* As,
                                          const unsigned char* Bs, int steps, int wm, int wn,
                                          int lane) {
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks) {
    if (ks >= steps) break;
    uint32_t a[4][4], b[2][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ldmatrix_x4(a[i], As + swz8(wm + 16 * i + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
    for (int j = 0; j < 2; ++j)  // n8 tiles 2j: {b0, b1}; 2j + 1: {b2, b3}
      ldmatrix_x4(b[j], Bs + swz8(wn + 16 * j + (lane & 7) + ((lane >> 4) << 3),
                                  2 * ks + ((lane >> 3) & 1)));
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t)
        mma_s8(acc[i][t], a[i], b[t >> 1][2 * (t & 1)], b[t >> 1][2 * (t & 1) + 1]);
  }
}

// One block a 128 x 128 output tile; the column tiles of a row tile are
// adjacent blocks, so the blocks in flight share x rows.
template <typename TO>
__global__ void __launch_bounds__(kThreads, 2)
quant_mma_kernel(const int8_t* __restrict__ xq, const float* __restrict__ x_scale,
                 const int8_t* __restrict__ w, const float* __restrict__ ws,
                 const float* __restrict__ bias, TO* __restrict__ out, int64_t M, int Kp, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_tiles = (N + kBN - 1) / kBN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kBM;
  const int n0 = blockIdx.x % n_tiles * kBN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;  // the warp's rows and columns
  const int nk = (Kp + kBK - 1) / kBK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(smem + s * kStageBytes, xq, w, m0, n0, s * kBK, M, N, Kp, tid);
    devit::mma::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    devit::mma::cp_async_wait<kStages - 2>();
    __syncthreads();  // chunk kc landed; the stage chunk kc - 1 used is free
    if (kc + kStages - 1 < nk)
      load_stage(smem + (kc + kStages - 1) % kStages * kStageBytes, xq, w, m0, n0,
                 (kc + kStages - 1) * kBK, M, N, Kp, tid);
    devit::mma::cp_async_commit();
    const unsigned char* As = smem + kc % kStages * kStageBytes;
    const int steps = min(kBK, Kp - kc * kBK) / 32;
    chunk_mma(acc, As, As + kBM * kBK, steps, wm, wn, lane);
  }
  epilogue<TO>(acc, smem, x_scale, ws, bias, out, m0, n0, M, N, wm, wn, tid, lane);
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* w, const void* ws, const void* bias, void* xq,
                   void* xs, void* out, int64_t M, int K, int Kp, int N, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)quant_mma_kernel<TO>, opted_in);
  if (err != cudaSuccess) return err;
  const unsigned row_blocks = (unsigned)((M + kRowThreads / 32 - 1) / (kRowThreads / 32));
  quant_rows_kernel<TI><<<row_blocks, kRowThreads, 0, stream>>>(
      static_cast<const TI*>(x), static_cast<int8_t*>(xq), static_cast<float*>(xs), M, K, Kp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t tiles = (M + kBM - 1) / kBM * ((N + kBN - 1) / kBN);
  if (tiles > INT32_MAX) return cudaErrorInvalidValue;
  const unsigned grid = (unsigned)tiles;
  quant_mma_kernel<TO><<<grid, kThreads, smem_bytes(), stream>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xs),
      static_cast<const int8_t*>(w), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, Kp, N);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_out(const void* x, const void* w, const void* ws, const void* bias, void* xq,
                       void* xs, void* out, int64_t M, int K, int Kp, int N, int out_dtype,
                       cudaStream_t s) {
  if (out_dtype == 0) return launch<TI, float>(x, w, ws, bias, xq, xs, out, M, K, Kp, N, s);
  if (out_dtype == 1)
    return launch<TI, __nv_bfloat16>(x, w, ws, bias, xq, xs, out, M, K, Kp, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x: (M, K) contiguous, 4-value groups aligned; w_nk: (N, Kp) int8
// contiguous, row n = column n of w_q zero-padded to Kp; w_scale: (N,) f32;
// bias: (N,) f32 or NULL; x_q: (M, Kp) int8 and x_scale: (M,) f32 scratch;
// out: (M, N) contiguous. K a multiple of 4, Kp of 32, K <= Kp. dtypes:
// 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int devit_quant_matmul(const void* x, const void* w_nk, const void* ws, const void* bias,
                       void* x_q, void* x_scale, void* out, long long M, int K, int Kp, int N,
                       int x_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 4 != 0 || Kp % 32 != 0 || K <= 0 || K > Kp || N <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  if (x_dtype == 0)
    return (int)launch_out<float>(x, w_nk, ws, bias, x_q, x_scale, out, M, K, Kp, N, out_dtype, s);
  if (x_dtype == 1)
    return (int)launch_out<__nv_bfloat16>(x, w_nk, ws, bias, x_q, x_scale, out, M, K, Kp, N,
                                          out_dtype, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
