// Int8 matmul with dynamic per-row activation quantization, fused.
//
// Replaces devit_tpu/kernels/quant.py:_quant_matmul_kernel (the Pallas TPU
// kernel behind fused_int8_matmul). Same contract and the same arithmetic as
// the plain dynamic_int8_matmul: x (M, K) f32 or bf16; w_q (K, N) int8 in the
// JAX package's (in, out) layout; w_scale (N,) and bias (N,) f32 (bias may be
// absent); out (M, N) f32 or bf16. Per row: amax = max |x| in f32,
// xs = max(amax, 1e-8) / 127, x_q = clip(rint(x / xs), -127, 127) with an IEEE
// division and round-half-even (the library is built without fast math);
// acc = x_q . w_q in int32, exact; y = (float)acc * xs * w_scale[n] + bias[n]
// in f32, each step rounded on its own (the intrinsics keep nvcc from
// contracting the product and the add into an FMA), then rounded to the
// output type. The int32 sums are exact, so the output is the plain
// version's bit for bit.
//
// What bounds it on an H100: one launch must read x (2 M K bytes in bf16) and
// w_q (K N), and write the output (2 M N); it does 2 M K N int8 operations.
// At the serving shapes (M = B * 198, K and N of 64..1536) that is K N / (K +
// N) operations a byte, ~100-380, near the ~590 at which the int8 tensor
// cores (1979 TOP/s) rather than HBM would be the limit, so the bound is
// memory at small K, N and the tensor cores at the largest. This first
// version does the dot with __dp4a (four int8 products a lane per
// instruction) on the CUDA cores, not the tensor cores, so its time is set
// by that arithmetic and the shared-memory reads that feed it; chip_smoke.py
// prints it beside its bound.
//
// Design: a block owns kTM rows. It reads each row once (a warp a row) for
// its amax, then quantizes it into shared memory as int8, packed four along K
// into one 32-bit word, K-major, so that __dp4a takes a word of x and a word
// of w. It then walks the N columns kTN at a time; for each it stages w_q in
// depth chunks of kKC, transposed into the same packed K-major words, and
// each thread accumulates a 4 x 4 tile of outputs in int32 registers. Every
// output has one writer and the sum runs in one fixed order: no atomics, the
// same bits on every run. The M tail is masked (rows past M quantize to zero
// and are never stored), and so is the N tail.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using devit::from_f;
using devit::to_f;
using devit::warp_max;

constexpr int kTM = 64;        // rows a block owns
constexpr int kTN = 64;        // output columns per pass
constexpr int kKC = 128;       // depth of one staged chunk of w_q
constexpr int kXS = kTM + 4;   // word stride of the packed x: 16-byte aligned row groups
constexpr int kThreads = 256;  // 16 column lanes x 16 row groups, a 4 x 4 tile each

size_t smem_bytes(int K) {
  // row scales [kTM] f32 | Xq [K/4][kXS] words of 4 int8 | Wq [kKC/4][kTN] words
  // of 4 int8 (all dynamic: opt_in_smem gives the kernel the whole opt-in
  // size, which leaves no room for static shared memory)
  return (size_t)kTM * 4 + (size_t)(K / 4) * kXS * 4 + (size_t)(kKC / 4) * kTN * 4;
}

template <typename TI, typename TO>
__global__ void __launch_bounds__(kThreads)
quant_matmul_kernel(const TI* __restrict__ x, const int8_t* __restrict__ wq,
                    const float* __restrict__ ws, const float* __restrict__ bias,
                    TO* __restrict__ out, int64_t M, int K, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KW = K / 4;
  float* row_scale = reinterpret_cast<float*>(smem);
  int* Xq = reinterpret_cast<int*>(row_scale + kTM);
  int* Wq = Xq + KW * kXS;

  const int64_t m0 = (int64_t)blockIdx.x * kTM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // ---- each row once: amax, its scale, and the row quantized into Xq
  for (int r = warp; r < kTM; r += kThreads / 32) {
    const int64_t m = m0 + r;
    if (m >= M) {
      for (int kw = lane; kw < KW; kw += 32) Xq[kw * kXS + r] = 0;
      continue;
    }
    const TI* row = x + m * K;
    float amax = 0.f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f(row[k])));
    amax = warp_max(amax);
    const float xs = fmaxf(amax, 1e-8f) / 127.0f;
    for (int kw = lane; kw < KW; kw += 32) {
      unsigned packed = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float q = fminf(fmaxf(rintf(to_f(row[4 * kw + j]) / xs), -127.f), 127.f);
        packed |= ((unsigned)(int)q & 0xffu) << (8 * j);
      }
      Xq[kw * kXS + r] = (int)packed;
    }
    if (lane == 0) row_scale[r] = xs;
  }
  __syncthreads();

  const int tx = threadIdx.x % 16;  // columns 4*tx .. 4*tx+3 of the pass
  const int ty = threadIdx.x / 16;  // rows 4*ty .. 4*ty+3 of the block
  for (int n0 = 0; n0 < N; n0 += kTN) {
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;

    for (int k0 = 0; k0 < K; k0 += kKC) {
      const int kcw = min(kKC, K - k0) / 4;  // words of this chunk
      // ---- stage w_q[k0 .., n0 .. n0+kTN) as packed K-major words
      for (int i = threadIdx.x; i < kcw * kTN; i += kThreads) {
        const int kw = i / kTN, c = i % kTN;
        const int n = n0 + c;
        unsigned packed = 0;
        if (n < N) {
          const int8_t* col = wq + (int64_t)(k0 + 4 * kw) * N + n;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            packed |= (unsigned)(uint8_t)col[(int64_t)j * N] << (8 * j);
        }
        Wq[kw * kTN + c] = (int)packed;
      }
      __syncthreads();
      const int kw0 = k0 / 4;
#pragma unroll 4
      for (int kw = 0; kw < kcw; ++kw) {
        const int4 a = *reinterpret_cast<const int4*>(Xq + (kw0 + kw) * kXS + 4 * ty);
        const int4 b = *reinterpret_cast<const int4*>(Wq + kw * kTN + 4 * tx);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // ---- epilogue: (float)acc * xs * w_scale (+ bias), rounded step by step
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t m = m0 + 4 * ty + i;
      if (m >= M) continue;
      const float xs = row_scale[4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + 4 * tx + j;
        if (n >= N) continue;
        float y = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j]), xs), ws[n]);
        if (bias != nullptr) y = __fadd_rn(y, bias[n]);
        out[m * N + n] = from_f<TO>(y);
      }
    }
  }
}

template <typename TI, typename TO>
cudaError_t launch(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                   int64_t M, int K, int N, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)quant_matmul_kernel<TI, TO>, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)((M + kTM - 1) / kTM));
  quant_matmul_kernel<TI, TO><<<grid, kThreads, smem_bytes(K), stream>>>(
      static_cast<const TI*>(x), static_cast<const int8_t*>(wq), static_cast<const float*>(ws),
      static_cast<const float*>(bias), static_cast<TO*>(out), M, K, N);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t launch_out(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                       int64_t M, int K, int N, int out_dtype, cudaStream_t s) {
  if (out_dtype == 0) return launch<TI, float>(x, wq, ws, bias, out, M, K, N, s);
  if (out_dtype == 1) return launch<TI, __nv_bfloat16>(x, wq, ws, bias, out, M, K, N, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at depth K.
long long devit_quant_matmul_smem_bytes(int K) { return (long long)smem_bytes(K); }

// x: (M, K) contiguous; w_q: (K, N) int8 contiguous; w_scale: (N,) f32;
// bias: (N,) f32 or NULL; out: (M, N) contiguous. K must be a multiple of 4.
// dtypes: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int devit_quant_matmul(const void* x, const void* wq, const void* ws, const void* bias, void* out,
                       long long M, int K, int N, int x_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 4 != 0 || K <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0) return (int)launch_out<float>(x, wq, ws, bias, out, M, K, N, out_dtype, s);
  if (x_dtype == 1)
    return (int)launch_out<__nv_bfloat16>(x, wq, ws, bias, out, M, K, N, out_dtype, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
