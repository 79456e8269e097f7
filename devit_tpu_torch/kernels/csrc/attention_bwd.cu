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
// bf16 and ~166 KB in f32. Its steps live in bwd_common.cuh, shared with
// the split kernels (attention_bwd_split.cu), which run the two passes as
// two kernels. The passes stay one loop here: written as two inlined
// functions they ran 5% slower on the H100 (4.55 against 4.31 ms at B 256).

#include "bwd_common.cuh"

namespace {

using namespace devit::bwd;

constexpr int kMaxCPerWarp = 16;  // key rows of dk/dv a warp holds: N <= 256
constexpr int kMaxN = kWarps * kMaxCPerWarp;

// Shared memory of one block at sequence length n, or -1 past kMaxN (the
// registers that hold dk and dv bound N, not the shared memory).
long long smem_bytes(int n, int dh, int elem) {
  if (n > kMaxN) return -1;
  return (long long)(elem == 2 ? dqdk_smem_bytes<__nv_bfloat16>(n, dh)
                               : dqdk_smem_bytes<float>(n, dh));
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ g, T* __restrict__ dqkv,
                int N, int H, float scale) {
  static_assert(DH == 64, "a lane owns dims l and l + 32");
  constexpr int KS = kv_stride<T>(DH);

  extern __shared__ __align__(16) unsigned char smem[];
  const int SP = devit::score_stride(N);
  float* P = reinterpret_cast<float*>(smem);  // p of the tile (f32)
  float* D = P + kBQ * SP;                    // dp, then ds, of the tile
  T* Ks = reinterpret_cast<T*>(D + kBQ * SP);
  T* Vs = Ks + N * KS;
  T* Qs = Vs + N * KS;    // the tile's q rows, zero past N
  T* Gs = Qs + kBQ * DH;  // the tile's g rows, zero past N

  const int C = H * DH;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + h * DH;
  const T* gbase = g + (int64_t)b * N * C + h * DH;
  T* obase = dqkv + (int64_t)b * N * row3 + h * DH;

  load_keys<T, DH>(base, Ks, Vs, N, row3, C);
  const int warp = threadIdx.x / 32;
  for (int pass = 0; pass < 2; ++pass) {
    float acc[kMaxCPerWarp][2];  // dv (pass 1), then dk (pass 2)
#pragma unroll
    for (int i = 0; i < kMaxCPerWarp; ++i) acc[i][0] = acc[i][1] = 0.f;
    for (int q0 = 0; q0 < N; q0 += kBQ) {
      const int rows = min(kBQ, N - q0);
      __syncthreads();  // the previous tile's readers of Q, G, P, D are done
      load_query_tile<T, DH>(base, gbase, Qs, Gs, q0, rows, row3, C);
      __syncthreads();
      rows_times_keys<T, DH>(Qs, Ks, P, N, SP, scale);
      if (pass == 1) rows_times_keys<T, DH>(Gs, Vs, D, N, SP, 1.f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r >= rows) continue;  // rows past N: never read below
        softmax_row(P + r * SP, N);
        if (pass == 1) ds_row<T>(P + r * SP, D + r * SP, N, scale);
      }
      __syncthreads();
      if (pass == 0) {
        accumulate_keys<T, DH, true, kMaxCPerWarp>(acc, P, Gs, 0, N, SP, rows);  // dv
        continue;
      }
      accumulate_keys<T, DH, false, kMaxCPerWarp>(acc, D, Qs, 0, N, SP, rows);  // dk
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * warp + i;
        if (r < rows) dq_row<T, DH>(D + r * SP, Ks, obase + (int64_t)(q0 + r) * row3, N);
      }
    }
    store_keys<T, kMaxCPerWarp>(acc, obase + (pass == 0 ? 2 : 1) * C, row3, 0, N);
  }
}

template <typename T, int DH>
cudaError_t launch(const void* qkv, const void* g, void* dqkv, int B, int N, int H,
                   cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  if (N > kMaxN) return cudaErrorInvalidValue;
  attn_bwd_kernel<T, DH><<<(unsigned)B * H, kThreads, dqdk_smem_bytes<T>(N, DH), stream>>>(
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
