// The exact-erf GELU with the Abramowitz-Stegun 7.1.26 erf, forward and
// backward, one pass each over the (B, N, hidden) tensor.
//
// It replaces no TPU kernel: on the TPU the JAX package's fast_gelu is a chain
// of XLA elementwise ops that the compiler fuses into the neighbouring
// matmuls. Run eagerly on the card, the same chain is 27 aten ops forward and
// 41 backward, each writing an f32 intermediate of the whole hidden tensor.
// Both kernels are bound by device memory: the forward reads x and writes y,
// the backward reads x and dy and writes dx, in the caller's dtype, so their
// bounds are 2 and 3 bytes-per-element passes at 3.35 TB/s. Each thread moves
// two 16-byte vectors of each operand (8 bf16/f16 or 4 f32 values each), the
// last partial vector value by value, so every operand is 16-byte aligned
// (the wrapper copies one that is not); indices are 64-bit (stage 3's B 4096
// times a 3072-wide hidden layer passes 2^31 values); the training shapes
// give tens of waves over the SMs; no shared memory.
//
// gelu_as_fwd is bit for bit the plain chain (kernels/gelu.py reference_gelu)
// as PyTorch's CUDA ops compute it: every product and sum rounded on its own
// (__fmul_rn/__fadd_rn, so nothing contracts into an FMA), the constants
// rounded from the Python floats to f32 as PyTorch rounds a scalar operand,
// 1/(1 + p z) correctly rounded (PyTorch's reciprocal), expf (no fast-math
// flag), sign as (0 < u) - (u < 0), and one round to nearest even into the
// input dtype. gelu_as_bwd is dy * g'(x), g' the derivative of that A&S
// expression (not the Gaussian pdf), what autograd of the chain and jax.grad
// of the JAX package's fast_gelu compute; in f32, rounded once to the dtype.

#include <cstdint>

#include "common.cuh"

namespace {

using devit::from_f;
using devit::to_f;

constexpr int kThreads = 256;
constexpr int kVectors = 2;  // 16-byte vectors a thread (1.04x the forward's rate of 1)

// the constants of fast_erf/fast_gelu: Python floats (doubles) rounded to f32
constexpr float kRsqrt2 = static_cast<float>(0.7071067811865476);
constexpr float kP = static_cast<float>(0.3275911);
constexpr float kA1 = static_cast<float>(0.254829592);
constexpr float kA2 = static_cast<float>(-0.284496736);
constexpr float kA3 = static_cast<float>(1.421413741);
constexpr float kA4 = static_cast<float>(-1.453152027);
constexpr float kA5 = static_cast<float>(1.061405429);

// Two values of T, converted to and from f32 a pair at a time (one packed
// round-to-nearest-even conversion for the pair at bf16 and f16)
template <typename T> struct Pair;
template <> struct Pair<float> {
  using P = float2;
  __device__ static float2 to_f2(P p) { return p; }
  __device__ static P from_f2(float a, float b) { return make_float2(a, b); }
};
template <> struct Pair<__nv_bfloat16> {
  using P = __nv_bfloat162;
  __device__ static float2 to_f2(P p) { return __bfloat1622float2(p); }
  __device__ static P from_f2(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <> struct Pair<__half> {
  using P = __half2;
  __device__ static float2 to_f2(P p) { return __half22float2(p); }
  __device__ static P from_f2(float a, float b) { return __floats2half2_rn(a, b); }
};

// fast_gelu's chain, op for op in the order PyTorch runs it
__device__ __forceinline__ float gelu_as(float x) {
  const float u = __fmul_rn(x, kRsqrt2);
  const float z = fabsf(u);
  const float t = __frcp_rn(__fadd_rn(__fmul_rn(kP, z), 1.0f));
  float p = __fmul_rn(t, kA5);
  p = __fmul_rn(t, __fadd_rn(p, kA4));
  p = __fmul_rn(t, __fadd_rn(p, kA3));
  p = __fmul_rn(t, __fadd_rn(p, kA2));
  p = __fmul_rn(t, __fadd_rn(p, kA1));
  const float e = __fsub_rn(1.0f, __fmul_rn(p, expf(__fmul_rn(-z, z))));
  // sign(u) * e as selects: sign is (0 < u) - (u < 0), so e, -e, or 0 at u = 0
  // and at a NaN (whose y is NaN all the same)
  const float erf = u > 0.0f ? e : (u < 0.0f ? -e : 0.0f);
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(erf, 1.0f));
}

// P(t) as Q(s) = P(1 - s) with s = 1 - t = p |u| t, for the backward:
// q_k = (-1)^k sum_j C(j, k) a_j, from the f32 constants in f64 (q0 is 1
// exactly, q5 = -a5), rounded to f32. Near u = 0, t is near 1, where P's
// alternating terms (1.42 t^3, -1.45 t^4) cancel and t's own rounding is
// multiplied by P'(1) = 3.44; there s is small and Q(s) = 1 + small terms.
constexpr float kQ1 = -3.4444963335990906f;
constexpr float kQ2 = 5.874886453151703f;
constexpr float kQ3 = -6.222859740257263f;
constexpr float kQ4 = 3.8538750410079956f;

// dy * g'(x), g' of y = x/2 (1 + E(u)), u = x/sqrt(2), E(u) = sign(u) (1 -
// P(t) e), t = 1/(1 + p |u|), e = exp(-u^2):
//   g' = (1 + E)/2 + u/2 dE/du,
//   dE/du = e (p t^2 P'(t) + 2 |u| P(t)) (dt/d|u| = -p t^2), times sign(u)^2,
// which is 0 at u = 0 as abs's derivative there, so g'(0) = 1/2. The large
// part of 1 + E is added last, in the product with dy: dx = dy + dy (u dE/du
// - P e)/2 above 0 as one FMA, and dy (u dE/du + P e)/2 below
// (kernels/gelu.py gelu_as_slope is the same g' with P(t) in t).
__device__ __forceinline__ float gelu_as_grad(float x, float dy) {
  const float u = x * kRsqrt2;
  const float z = fabsf(u);
  const float pz = kP * z;
  const float t = __frcp_rn(pz + 1.0f);
  const float s = pz * t;
  const float poly = 1.0f + s * (kQ1 + s * (kQ2 + s * (kQ3 + s * (kQ4 + s * -kA5))));
  const float dpoly =
      kA1 + t * (2.0f * kA2 + t * (3.0f * kA3 + t * (4.0f * kA4 + t * (5.0f * kA5))));
  const float e = expf(-z * z);
  const float pe = poly * e;
  const float uderf = u * (e * (kP * t * t * dpoly) + 2.0f * z * pe);
  // a NaN takes the last branch and stays NaN
  return u == 0.0f ? 0.5f * dy
                   : (u < 0.0f ? dy * (0.5f * (uderf + pe)) : fmaf(dy, 0.5f * (uderf - pe), dy));
}

// One pass over n values: the forward's y = gelu(x), or the backward's
// dx = dy * g'(x). A thread takes kVectors 16-byte vectors of V values,
// kThreads vectors apart, loads them all before it computes any, and takes
// a last partial vector value by value.
template <bool kBwd, typename T, int V>
__device__ __forceinline__ void gelu_pass(const T* __restrict__ x, const T* __restrict__ dy,
                                          T* __restrict__ out, long long n) {
  static_assert(V * sizeof(T) == 16, "one 16-byte vector");
  using P = typename Pair<T>::P;
  auto at = [](float xv, float dyv) { return kBwd ? gelu_as_grad(xv, dyv) : gelu_as(xv); };
  const long long first =
      (static_cast<long long>(blockIdx.x) * kVectors * kThreads + threadIdx.x) * V;
  alignas(16) P v[kVectors][V / 2];
  alignas(16) P g[kVectors][V / 2];
#pragma unroll
  for (int r = 0; r < kVectors; ++r) {
    const long long i = first + static_cast<long long>(r) * kThreads * V;
    if (i + V <= n) {
      *reinterpret_cast<uint4*>(v[r]) = *reinterpret_cast<const uint4*>(x + i);
      if constexpr (kBwd) *reinterpret_cast<uint4*>(g[r]) = *reinterpret_cast<const uint4*>(dy + i);
    }
  }
#pragma unroll
  for (int r = 0; r < kVectors; ++r) {
    const long long i = first + static_cast<long long>(r) * kThreads * V;
    if (i + V <= n) {
#pragma unroll
      for (int k = 0; k < V / 2; ++k) {
        const float2 f = Pair<T>::to_f2(v[r][k]);
        const float2 d = kBwd ? Pair<T>::to_f2(g[r][k]) : float2{0.0f, 0.0f};
        v[r][k] = Pair<T>::from_f2(at(f.x, d.x), at(f.y, d.y));
      }
      *reinterpret_cast<uint4*>(out + i) = *reinterpret_cast<const uint4*>(v[r]);
    } else {
      for (long long j = i; j < n; ++j) {
        out[j] = from_f<T>(at(to_f(x[j]), kBwd ? to_f(dy[j]) : 0.0f));
      }
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gelu_as_fwd(const T* __restrict__ x,
                                                       T* __restrict__ y, long long n) {
  gelu_pass<false, T, V>(x, nullptr, y, n);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) gelu_as_bwd(const T* __restrict__ x,
                                                       const T* __restrict__ dy,
                                                       T* __restrict__ dx, long long n) {
  gelu_pass<true, T, V>(x, dy, dx, n);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

// kThreads threads a block, each over kVectors vectors of V values
template <typename T>
cudaError_t launch(bool bwd, const void* x, const void* dy, void* out, long long n,
                   cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const long long blocks = ((n + V - 1) / V + kVectors * kThreads - 1) / (kVectors * kThreads);
  if (n <= 0 || blocks > 0x7fffffffLL || !aligned16(x) || !aligned16(out) ||
      (bwd && !aligned16(dy))) {
    return cudaErrorInvalidValue;
  }
  const T* xp = static_cast<const T*>(x);
  if (bwd) {
    gelu_as_bwd<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, static_cast<const T*>(dy), static_cast<T*>(out), n);
  } else {
    gelu_as_fwd<T, V><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        xp, static_cast<T*>(out), n);
  }
  return cudaGetLastError();
}

cudaError_t launch_dtype(bool bwd, const void* x, const void* dy, void* out, long long n,
                         int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(bwd, x, dy, out, n, s);
  if (dtype == 1) return launch<__nv_bfloat16>(bwd, x, dy, out, n, s);
  if (dtype == 2) return launch<__half>(bwd, x, dy, out, n, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x, y: n contiguous values, 16-byte aligned; dtype 0 = float32, 1 =
// bfloat16, 2 = float16. Returns a cudaError_t (0 = launched).
int devit_gelu_fwd(const void* x, void* y, long long n, int dtype, void* stream) {
  return (int)launch_dtype(false, x, nullptr, y, n, dtype, stream);
}

// x, dy, dx: n contiguous values of one dtype, as devit_gelu_fwd's.
int devit_gelu_bwd(const void* x, const void* dy, void* dx, long long n, int dtype,
                   void* stream) {
  return (int)launch_dtype(true, x, dy, dx, n, dtype, stream);
}

}  // extern "C"
