// The attention half of a compact ViT layer in one kernel:
// out = t + proj(attention(qkv(LayerNorm(t)))).
//
// Replaces devit_tpu/kernels/attention.py:_block_attn_kernel (the Pallas TPU
// kernel behind fused_block_attention). Same contract: t (B, N, C); the
// LayerNorm's scale and bias (C,); the compact ragged weights qkv_kernel
// (C, 3K) and proj_kernel (K, C), K = H * head_dim, in t's dtype, with the
// qkv columns [q | k | v] and head-major inside each third; the biases (3K,)
// (or none) and (C,), and the LayerNorm's, in f32. Numerics follow the TPU
// kernel step by step: LayerNorm statistics in f32 whatever the dtype, with
// rsqrt(var + eps); h rounded to t's dtype; qkv = h . W in f32, plus the
// bias, rounded; per head the f32 scores and two-pass softmax of
// attention.cu, p rounded to v's dtype, o = p . v in f32 rounded to v's
// dtype; each head's o . proj[head rows] (f32) added onto an f32 copy of t;
// then + proj_bias and one rounding. Only the order of the f32 sums inside
// each product differs from the TPU's.
//
// What bounds it on an H100: it must read t and the weights once and write
// the output once (~4 B N C bytes in bf16, the weights are small), against
// 2 B N C 3K + 4 B N^2 K + 2 B N K C operations: ~250 operations a byte at
// the deployed shapes (C 384, N 198, K 64..320), so the bf16 tensor cores
// and HBM set about the same bound. This first version runs every product
// with f32 FMAs on the CUDA cores, reading its operands from shared memory,
// so its time is set by that arithmetic, far above the bound; chip_smoke.py
// prints both.
//
// Design: a block owns one batch row and loops over the heads; no other
// block touches its rows, so nothing needs atomics and every run gives the
// same bits. The LayerNorm'd rows (N x C) and the f32 residual accumulator
// do not fit in shared memory beside the rest (at C 384, N 198: 152 KB in
// bf16 and 304 KB in f32 for the rows alone), so the block writes them once
// to global scratch that only it reads back (from L2, mostly). Per head it
// makes that head's q, k and v (N x 64 each) from the rows in shared memory,
// 64 token rows at a time with staged chunks of rows and weights; then for
// each 64-query tile it runs attention.cu's steps (the f32 score tile in
// shared memory, softmax, p rounded, p . v), writes o, rounded, over the
// tile's q columns (no longer needed), and adds o . proj[head rows] onto the
// accumulator with staged chunks of proj. At the end it adds proj_bias and
// writes the output. At N 198 a block takes ~124 KB (bf16) or ~198 KB (f32)
// of shared memory: one block an SM.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using devit::from_f;
using devit::score_stride;
using devit::to_f;
using devit::warp_max;
using devit::warp_sum;

constexpr int kBQ = 64;        // query rows of an attention tile, token rows of a qkv tile
constexpr int kThreads = 256;  // 16 column lanes x 16 row groups of 4
constexpr int kKC = 32;        // depth of a staged chunk of LN'd rows and qkv weights
constexpr int kPC = 128;       // output columns of a staged chunk of proj

size_t scratch_bytes(int n, int dh, int elem) {
  // one region, three uses in turn: the f32 score tile S [kBQ][score_stride(N)];
  // the qkv product's staging Hs [kBQ][kKC + 1] | Ws [kKC][3 dh]; the proj
  // product's staging P [dh][kPC]
  const size_t s = (size_t)kBQ * score_stride(n) * sizeof(float);
  const size_t qkv = (size_t)elem * (kBQ * (kKC + 1) + kKC * 3 * dh);
  const size_t proj = (size_t)elem * dh * kPC;
  return s > qkv ? (s > proj ? s : proj) : (qkv > proj ? qkv : proj);
}

size_t smem_bytes(int n, int dh, int elem) {
  // Qt [dh][N] | Kt [dh][N] | V [N][dh] (a multiple of 128 bytes) | scratch
  return (size_t)3 * n * dh * elem + scratch_bytes(n, dh, elem);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
block_attn_kernel(const T* __restrict__ t, const float* __restrict__ ns,
                  const float* __restrict__ nb, const T* __restrict__ qw,
                  const float* __restrict__ qb, const T* __restrict__ pw,
                  const float* __restrict__ pb, T* __restrict__ hbuf,
                  float* __restrict__ acc, T* __restrict__ out, int N, int C, int H,
                  float scale, float eps) {
  static_assert(DH == 64, "the tiles below assume head_dim 64");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qt = reinterpret_cast<T*>(smem);  // [DH][N]: q, then o over each finished tile
  T* Kt = Qt + DH * N;                 // [DH][N]
  T* V = Kt + DH * N;                  // [N][DH]
  unsigned char* scratch = reinterpret_cast<unsigned char*>(V + N * DH);
  float* S = reinterpret_cast<float*>(scratch);
  T* Hs = reinterpret_cast<T*>(scratch);  // [kBQ][kKC + 1]
  T* Ws = Hs + kBQ * (kKC + 1);           // [kKC][3 DH]
  T* P = reinterpret_cast<T*>(scratch);   // [DH][kPC]

  const int K = H * DH;
  const int64_t row0 = (int64_t)blockIdx.x * N;  // this block's first token row
  const T* tb = t + row0 * C;
  T* hb = hbuf + row0 * C;
  float* ab = acc + row0 * C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int SP = score_stride(N);

  // ---- LayerNorm of every token row (f32 statistics), a warp a row; the
  // rounded rows into hbuf, an f32 copy of t into the accumulator
  for (int n = warp; n < N; n += kThreads / 32) {
    const T* tr = tb + (int64_t)n * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(tr[c]);
    const float mu = warp_sum(s) / (float)C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(tr[c]) - mu;
      v = fmaf(d, d, v);
    }
    const float r = rsqrtf(warp_sum(v) / (float)C + eps);
    for (int c = lane; c < C; c += 32) {
      const float xv = to_f(tr[c]);
      const float h = __fadd_rn(__fmul_rn(__fmul_rn(xv - mu, r), ns[c]), nb[c]);
      hb[(int64_t)n * C + c] = from_f<T>(h);
      ab[(int64_t)n * C + c] = xv;
    }
  }
  __syncthreads();

  for (int hd = 0; hd < H; ++hd) {
    // ---- q, k, v of head hd: (64-row tile of h) . (C x [q | k | v] columns)
    for (int r0 = 0; r0 < N; r0 += kBQ) {
      float a[4][12];  // rows 4*ty+i, columns tx + 16*j of the 3*DH = 192
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 12; ++j) a[i][j] = 0.f;
      for (int k0 = 0; k0 < C; k0 += kKC) {
        for (int i = threadIdx.x; i < kBQ * kKC; i += kThreads) {
          const int r = i / kKC, c = i % kKC;
          const int n = r0 + r;
          Hs[r * (kKC + 1) + c] = n < N ? hb[(int64_t)n * C + k0 + c] : from_f<T>(0.f);
        }
        for (int i = threadIdx.x; i < kKC * 3 * DH; i += kThreads) {
          const int k = i / (3 * DH), j = i % (3 * DH);
          Ws[i] = qw[(int64_t)(k0 + k) * 3 * K + (j / DH) * K + hd * DH + j % DH];
        }
        __syncthreads();
#pragma unroll 4
        for (int k = 0; k < kKC; ++k) {
          float h[4], w[12];
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = to_f(Hs[(4 * ty + i) * (kKC + 1) + k]);
#pragma unroll
          for (int j = 0; j < 12; ++j) w[j] = to_f(Ws[k * 3 * DH + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 12; ++j) a[i][j] = fmaf(h[i], w[j], a[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = r0 + 4 * ty + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 12; ++j) {
          const int sec = j / 4, d = tx + 16 * (j % 4);  // [q | k | v], dim
          const float bias = qb != nullptr ? qb[sec * K + hd * DH + d] : 0.f;
          const T v = from_f<T>(a[i][j] + bias);
          if (sec == 0) Qt[d * N + n] = v;
          else if (sec == 1) Kt[d * N + n] = v;
          else V[n * DH + d] = v;
        }
      }
    }
    __syncthreads();

    for (int q0 = 0; q0 < N; q0 += kBQ) {
      // ---- S = (q . k^T) * scale, f32, 64 key columns per pass
      for (int c0 = 0; c0 < N; c0 += 64) {
        float s[4][4];
        int col[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) col[j] = c0 + tx + 16 * j;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < DH; ++d) {
          float q[4], k[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = q0 + 4 * ty + i;
            q[i] = n < N ? to_f(Qt[d * N + n]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) k[j] = col[j] < N ? to_f(Kt[d * N + col[j]]) : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(q[i], k[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (col[j] < N) S[(4 * ty + i) * SP + col[j]] = s[i][j] * scale;
      }
      __syncthreads();

      // ---- softmax over each row's N keys, f32; p rounded to T
      for (int r = warp; r < kBQ; r += kThreads / 32) {
        if (q0 + r >= N) continue;
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

      // ---- o = p . v, f32, rounded to T, over this tile's q columns of Qt
      {
        float o[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < N; ++c) {
          float p[4], v[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = S[(4 * ty + i) * SP + c];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = to_f(V[c * DH + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = q0 + 4 * ty + i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < 4; ++j) Qt[(tx + 16 * j) * N + n] = from_f<T>(o[i][j]);
        }
      }
      __syncthreads();

      // ---- acc[rows of the tile] += o . proj[head rows], kPC columns at a time
      for (int c0 = 0; c0 < C; c0 += kPC) {
        for (int i = threadIdx.x; i < DH * kPC; i += kThreads) {
          const int d = i / kPC, c = i % kPC;
          P[i] = c0 + c < C ? pw[(int64_t)(hd * DH + d) * C + c0 + c] : from_f<T>(0.f);
        }
        __syncthreads();
        float y[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) y[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < DH; ++d) {
          float o[4], w[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = q0 + 4 * ty + i;
            o[i] = n < N ? to_f(Qt[d * N + n]) : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) w[j] = to_f(P[d * kPC + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) y[i][j] = fmaf(o[i], w[j], y[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = q0 + 4 * ty + i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int c = c0 + tx + 16 * j;
            if (c < C) {
              float* dst = ab + (int64_t)n * C + c;
              *dst = __fadd_rn(*dst, y[i][j]);
            }
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- out = acc + proj_bias, one rounding
  for (int64_t i = threadIdx.x; i < (int64_t)N * C; i += kThreads)
    out[row0 * C + i] = from_f<T>(__fadd_rn(ab[i], pb[i % C]));
}

template <typename T>
cudaError_t launch(const void* t, const float* ns, const float* nb, const void* qw,
                   const float* qb, const void* pw, const float* pb, void* hbuf, float* acc,
                   void* out, int B, int N, int C, int H, float eps, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_attn_kernel<T, 64>, opted_in);
  if (err != cudaSuccess) return err;
  block_attn_kernel<T, 64><<<B, kThreads, smem_bytes(N, 64, sizeof(T)), stream>>>(
      static_cast<const T*>(t), ns, nb, static_cast<const T*>(qw), qb,
      static_cast<const T*>(pw), pb, static_cast<T*>(hbuf), acc, static_cast<T*>(out), N, C, H,
      1.0f / sqrtf(64.0f), eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at sequence length n.
long long devit_block_attention_smem_bytes(int n, int head_dim, int elem_bytes) {
  return (long long)smem_bytes(n, head_dim, elem_bytes);
}

// t, hbuf, out: (B, N, C) contiguous of the dtype; acc: (B, N, C) f32
// scratch; qkv_kernel (C, 3 H head_dim) and proj_kernel (H head_dim, C)
// contiguous of the dtype; norm scale/bias, proj bias (C,) and qkv bias
// (3 H head_dim,) or NULL, f32. C must be a multiple of 32. dtype: 0 =
// float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
int devit_block_attention(const void* t, const void* ns, const void* nb, const void* qw,
                          const void* qb, const void* pw, const void* pb, void* hbuf, void* acc,
                          void* out, int B, int N, int C, int H, int head_dim, float eps,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim != 64 || C % 32 != 0 || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const float* f[4] = {static_cast<const float*>(ns), static_cast<const float*>(nb),
                       static_cast<const float*>(qb), static_cast<const float*>(pb)};
  float* a = static_cast<float*>(acc);
  if (dtype == 0)
    return (int)launch<float>(t, f[0], f[1], qw, f[2], pw, f[3], hbuf, a, out, B, N, C, H, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(t, f[0], f[1], qw, f[2], pw, f[3], hbuf, a, out, B, N, C,
                                      H, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
