// The sparse-expert layer's data movement (models/moe.py): the dispatch of
// tokens into per-expert slot buffers and the weighted combine back, each
// with its backward, as two row kernels.
//
// It replaces no TPU kernel: the JAX package has no sparse experts. V-MoE's
// own code (github.com/google-research/vmoe) dispatches and combines with
// einsums against one-hot (tokens, experts, capacity) tensors; on the card
// that is a GEMM against a tensor that is almost all zeros. Here both
// directions are gathers through two index maps, so every output row has
// one writer, nothing is atomic, and a result repeats bit for bit:
//   tok_slot (T, K): the slot expert * cap + position of token t's j-th
//                    choice, -1 where capacity dropped it;
//   slot_tok (S):    the token in slot s (S = E * cap), -1 where empty.
//
// moe_gather_rows<T, V, kWeighted>: out[s] = x[slot_tok[s]], zeros where the
//   slot is empty (the dispatch); with kWeighted, out[s] = w[t, j] * x[t] for
//   the choice (t, j) that fills s, the product in f32 rounded once (the
//   combine's backward for the slot buffer, x = dy).
// moe_combine_rows<T, V, kMode>: one token a warp over its K choices in j
//   order, dropped choices skipped:
//   kMode 0: y[t] = sum_j w[t, j] * buf[slot], every product and sum
//            rounded on its own in f32 (so nothing contracts into an FMA),
//            then once to T: bit for bit the eager path's j loop;
//   kMode 1: y[t] = sum_j buf[slot] (the dispatch's backward, weight 1);
//   kMode 2: dw[t, j] = <dy[t], buf[slot]> in f32, a lane's strided
//            partial sums then a warp reduction (the combine's backward for
//            the weights; 0 where dropped).
//
// Every kernel is bound by device memory: a row is C values moved once. One
// warp takes one row, 16-byte vectors of V values (8 bf16/f16, 4 f32) where
// the row and pointers are 16-byte aligned, else one value a lane (V = 1).
// Indices into the rows are 64-bit; the maps are int32.

#include <cstdint>

#include "common.cuh"

namespace {

using devit::from_f;
using devit::to_f;
using devit::warp_sum;

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;
constexpr int kMaxK = 8;  // choices a token the kernels take

// V values of T at p as f32
template <typename T, int V>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T v[V];
    *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(v[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) f[i] = to_f(p[i]);
  }
}

// V f32 values rounded to T, stored at p
template <typename T, int V>
__device__ __forceinline__ void store(T* __restrict__ p, const float (&f)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    alignas(16) T v[V];
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = from_f<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(v);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f<T>(f[i]);
  }
}

// V values copied bit for bit from src to dst (zeros where src is null)
template <typename T, int V>
__device__ __forceinline__ void copy(T* __restrict__ dst, const T* __restrict__ src) {
  if constexpr (V * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(dst) =
        src ? *reinterpret_cast<const uint4*>(src) : make_uint4(0u, 0u, 0u, 0u);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) dst[i] = src ? src[i] : from_f<T>(0.0f);
  }
}

template <typename T, int V, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
    moe_gather_rows(const T* __restrict__ x, const int* __restrict__ slot_tok,
                    const int* __restrict__ tok_slot, const float* __restrict__ w,
                    T* __restrict__ out, int S, int K, int C) {
  const int s = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (s >= S) return;
  const int t = slot_tok[s];
  float scale = 1.0f;
  if constexpr (kWeighted) {
    if (t >= 0) {
      for (int j = 0; j < K; ++j) {
        if (tok_slot[static_cast<long long>(t) * K + j] == s) {
          scale = w[static_cast<long long>(t) * K + j];
          break;
        }
      }
    }
  }
  T* dst = out + static_cast<long long>(s) * C;
  const T* src = t >= 0 ? x + static_cast<long long>(t) * C : nullptr;
  for (int c = lane * V; c < C; c += 32 * V) {
    if constexpr (kWeighted) {
      float f[V];
      if (src) {
        load<T, V>(src + c, f);
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = __fmul_rn(scale, f[i]);
      } else {
#pragma unroll
        for (int i = 0; i < V; ++i) f[i] = 0.0f;
      }
      store<T, V>(dst + c, f);
    } else {
      copy<T, V>(dst + c, src ? src + c : nullptr);
    }
  }
}

template <typename T, int V, int kMode>
__global__ void __launch_bounds__(kThreads)
    moe_combine_rows(const T* __restrict__ buf, const int* __restrict__ tok_slot,
                     const float* __restrict__ w, const T* __restrict__ dy,
                     T* __restrict__ y, float* __restrict__ dw, int T_, int K, int C) {
  const int t = blockIdx.x * kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (t >= T_) return;
  int slot[kMaxK];
  float wt[kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    slot[j] = j < K ? tok_slot[static_cast<long long>(t) * K + j] : -1;
    wt[j] = (kMode == 0 && j < K) ? w[static_cast<long long>(t) * K + j] : 1.0f;
  }
  if constexpr (kMode == 2) {
    float part[kMaxK];
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) part[j] = 0.0f;
    const T* g = dy + static_cast<long long>(t) * C;
    for (int c = lane * V; c < C; c += 32 * V) {
      float gv[V];
      load<T, V>(g + c, gv);
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (slot[j] >= 0) {
          float b[V];
          load<T, V>(buf + static_cast<long long>(slot[j]) * C + c, b);
#pragma unroll
          for (int i = 0; i < V; ++i) part[j] = fmaf(gv[i], b[i], part[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      if (j < K) {
        const float total = warp_sum(part[j]);
        if (lane == 0) dw[static_cast<long long>(t) * K + j] = slot[j] >= 0 ? total : 0.0f;
      }
    }
  } else {
    T* out = y + static_cast<long long>(t) * C;
    for (int c = lane * V; c < C; c += 32 * V) {
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < kMaxK; ++j) {
        if (slot[j] >= 0) {
          float b[V];
          load<T, V>(buf + static_cast<long long>(slot[j]) * C + c, b);
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[i] = __fadd_rn(acc[i], kMode == 0 ? __fmul_rn(wt[j], b[i]) : b[i]);
          }
        }
      }
      store<T, V>(out + c, acc);
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

unsigned blocks_for(int rows) {
  return static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
}

// Whether every row of C values at each pointer starts 16-byte aligned
template <typename T>
bool vectorizable(int C, std::initializer_list<const void*> ptrs) {
  if ((static_cast<long long>(C) * sizeof(T)) % 16 != 0) return false;
  for (const void* p : ptrs) {
    if (p != nullptr && !aligned16(p)) return false;
  }
  return true;
}

template <typename T>
cudaError_t gather(const void* x, const int* slot_tok, const int* tok_slot, const float* w,
                   void* out, int S, int K, int C, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  const bool vec = vectorizable<T>(C, {x, out});
  const unsigned g = blocks_for(S);
  if (w != nullptr) {
    if (vec) moe_gather_rows<T, V, true><<<g, kThreads, 0, s>>>(xp, slot_tok, tok_slot, w, op, S, K, C);
    else moe_gather_rows<T, 1, true><<<g, kThreads, 0, s>>>(xp, slot_tok, tok_slot, w, op, S, K, C);
  } else {
    if (vec) moe_gather_rows<T, V, false><<<g, kThreads, 0, s>>>(xp, slot_tok, tok_slot, w, op, S, K, C);
    else moe_gather_rows<T, 1, false><<<g, kThreads, 0, s>>>(xp, slot_tok, tok_slot, w, op, S, K, C);
  }
  return cudaGetLastError();
}

template <typename T, int kMode>
cudaError_t combine_mode(const T* buf, const int* tok_slot, const float* w, const T* dy, T* y,
                         float* dw, int T_, int K, int C, bool vec, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  const unsigned g = blocks_for(T_);
  if (vec) moe_combine_rows<T, V, kMode><<<g, kThreads, 0, s>>>(buf, tok_slot, w, dy, y, dw, T_, K, C);
  else moe_combine_rows<T, 1, kMode><<<g, kThreads, 0, s>>>(buf, tok_slot, w, dy, y, dw, T_, K, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t combine(const void* buf, const int* tok_slot, const float* w, const void* dy, void* y,
                    float* dw, int T_, int K, int C, cudaStream_t s) {
  const T* bp = static_cast<const T*>(buf);
  if (dw != nullptr) {
    const bool vec = vectorizable<T>(C, {buf, dy});
    return combine_mode<T, 2>(bp, tok_slot, nullptr, static_cast<const T*>(dy), nullptr, dw, T_,
                              K, C, vec, s);
  }
  const bool vec = vectorizable<T>(C, {buf, y});
  if (w != nullptr) {
    return combine_mode<T, 0>(bp, tok_slot, w, nullptr, static_cast<T*>(y), nullptr, T_, K, C,
                              vec, s);
  }
  return combine_mode<T, 1>(bp, tok_slot, nullptr, nullptr, static_cast<T*>(y), nullptr, T_, K,
                            C, vec, s);
}

bool shape_ok(int rows, int K, int C) { return rows > 0 && K > 0 && K <= kMaxK && C > 0; }

}  // namespace

extern "C" {

// out (S, C) = the rows of x (T, C) that slot_tok (S) names, zeros where it
// holds -1; with w (T, K) f32 non-NULL, each row times the weight of the
// choice in tok_slot (T, K) that fills the slot (tok_slot may be NULL
// without w). dtype 0 = float32, 1 = bfloat16, 2 = float16. Returns a
// cudaError_t (0 = launched).
int devit_moe_gather(const void* x, const int* slot_tok, const int* tok_slot, const float* w,
                     void* out, int S, int K, int C, int dtype, void* stream) {
  if (!shape_ok(S, K, C) || (w != nullptr && tok_slot == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)gather<float>(x, slot_tok, tok_slot, w, out, S, K, C, s);
  if (dtype == 1) return (int)gather<__nv_bfloat16>(x, slot_tok, tok_slot, w, out, S, K, C, s);
  if (dtype == 2) return (int)gather<__half>(x, slot_tok, tok_slot, w, out, S, K, C, s);
  return (int)cudaErrorInvalidValue;
}

// With dw NULL: y (T, C) = sum over j of w[t, j] (1 where w is NULL) times
// the row of buf (S, C) in slot tok_slot[t, j], dropped choices (-1)
// skipped. With dw non-NULL: dw (T, K) f32 = the dot of dy (T, C) with each
// choice's row (0 where dropped); y and w unused. dtype as
// devit_moe_gather's.
int devit_moe_combine(const void* buf, const int* tok_slot, const float* w, const void* dy,
                      void* y, float* dw, int T, int K, int C, int dtype, void* stream) {
  if (!shape_ok(T, K, C)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)combine<float>(buf, tok_slot, w, dy, y, dw, T, K, C, s);
  if (dtype == 1) return (int)combine<__nv_bfloat16>(buf, tok_slot, w, dy, y, dw, T, K, C, s);
  if (dtype == 2) return (int)combine<__half>(buf, tok_slot, w, dy, y, dw, T, K, C, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
