// Helpers shared by the attention kernels (attention.cu, attention_bwd.cu)
// and the GELU pair (gelu.cu): dtype conversion, warp reductions, the odd
// score-row stride and the once-per-device opt-in to the whole dynamic
// shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <atomic>

namespace devit {

constexpr int kMaxDevices = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// x rounded to T and read back as f32 (the identity for T = float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__host__ __device__ __forceinline__ int score_stride(int n) {
  // odd row stride: rows a warp reads at the same column land on different banks
  return n | 1;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Let `kernel` use the device's whole opt-in shared memory, once per device
// (`opted` is the kernel's own flag array), so a launch at any size that fits
// (the Python wrapper checks) needs no further attribute call. Every caller
// sets the same value, so a race between threads is harmless.
inline cudaError_t opt_in_smem(const void* kernel, std::atomic<bool>* opted) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (opted[dev].load(std::memory_order_acquire)) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err != cudaSuccess) return err;
  opted[dev].store(true, std::memory_order_release);
  return cudaSuccess;
}

// The most dynamic shared memory a block may opt in to on `dev` (cached per
// device), or -1.
inline long long device_optin(int dev) {
  static std::atomic<long long> cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return -1;
  long long v = cache[dev].load(std::memory_order_relaxed);
  if (v > 0) return v;
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess)
    return -1;
  cache[dev].store(optin, std::memory_order_relaxed);
  return optin;
}

}  // namespace devit
