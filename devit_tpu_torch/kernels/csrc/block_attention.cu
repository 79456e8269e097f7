// The attention half of a compact ViT layer:
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
// bias, rounded; per head the f32 scores and two-pass softmax, p rounded to
// v's dtype, o = p . v in f32 rounded to v's dtype; each head's
// o . proj[head rows] (f32) added onto an f32 copy of t; then + proj_bias and
// one rounding. Only the order of the f32 sums inside each product differs
// from the TPU's.
//
// What bounds it on an H100: it must read t and the weights once and write
// the output once (~4 B N C bytes in bf16, the weights are small), against
// 2 B N C 3K + 4 B N^2 K + 2 B N K C operations: ~250 operations a byte at
// the deployed shapes (C 384, N 198, K 64..320), so the bf16 tensor cores
// and HBM set about the same bound.
//
// bf16: two kernels on the tensor cores (mma.sync m16n8k16, bf16 operands,
// f32 accumulators). The TPU kernel holds a batch block's rows, qkv and
// residual in VMEM through one grid step; a block here has neither the room
// nor the order for that, so the work is cut at the heads:
// - block_qkv_attn_kernel: one block a (batch row, head), B H blocks, 4
//   warps. It takes the LayerNorm statistics of its row's N tokens (8 lanes
//   a token, 16 tokens in flight: a warp a token waited on each token's
//   loads in turn, 32.5 against 26.5 ms a bs256 forward's 48 calls on the
//   H100, scripts/kernel_variants.py), then forms that head's q, k and v (N x 64 each) 64 tokens at a
//   time: per 64-column chunk of C, the head's 3 x 64 weight columns arrive
//   by cp.async and the tokens are normalised and rounded on their way into
//   shared memory; each warp owns 16 tokens and 192 f32 accumulators' worth
//   of columns; the rounded q, k and v (plus the bias) go into XOR-swizzled
//   tiles. The forward kernel's attention steps (attn_mma.cuh, the same
//   source as attention.cu's) then give each warp's 16 rows of o, written
//   rounded into a (B, N, K) bf16 scratch that the wrapper allocates. At N
//   198 a block takes ~112 KB of shared memory: two blocks an SM. Tried on
//   the H100 and not kept: 32-column chunks through two buffers, the next
//   chunk loading while this one's mma ran (29.5 against 26.4 ms a bs256
//   forward's 48 calls: twice the barriers, no overlap won).
// - block_proj_kernel: out = round(t + o . proj + proj_bias) as a GEMM over
//   128 x 128 output tiles (8 warps of 64 x 32), its f32 accumulators
//   started from t and proj's 64-row chunks of K = H dh taken in order
//   through a two-stage cp.async ring (at dh 64 one chunk a head).
// Every output has one writer; no atomics, the same bits on every run.
//
// f32: f32 FMAs on the CUDA cores (block_attn_kernel). One TF32 mma pass
// keeps too few bits for the f32 tolerance of 1e-4; the forward and the
// backwards run f32 as three TF32 passes (3xTF32) on the tensor cores, and
// this half, with no caller, was not moved to them. A
// block owns one batch row and loops over the heads; no other block touches
// its rows, so nothing needs atomics and every run gives the same bits. The
// LayerNorm'd rows (N x C) and the f32 residual accumulator do not fit in
// shared memory beside the rest (at C 384, N 198: 304 KB in f32 for the rows
// alone), so the block writes them once to global scratch that only it
// reads back (from L2, mostly). Per head it makes that head's q, k and v (N
// x 64 each) from the rows in shared memory, 64 token rows at a time with
// staged chunks of rows and weights; then for each 64-query tile it runs
// attention.cu's f32 steps (the f32 score tile in shared memory, softmax, p
// rounded, p . v), writes o, rounded, over the tile's q columns (no longer
// needed), and adds o . proj[head rows] onto the accumulator with staged
// chunks of proj. At the end it adds proj_bias and writes the output. At N
// 198 a block takes ~198 KB of shared memory: one block an SM.
//
// Head widths 32, 64 and 128 (DH, a template parameter of every kernel). At
// bf16 the head tiles hold rows of DH bf16 (swz_dh); at dh 128 the qkv
// product makes q, k and v one after the other (a warp's 16 tokens x 3 x 128
// f32 accumulators would not fit its registers), and the proj kernel takes
// o and proj in 64-row chunks of K = H dh (at dh 32 and an odd H the last
// chunk is zero-filled past K). At f32, dh 128 fits shared memory up to N
// 108 (Qt, Kt and V of the head in f32).
//
// The chunked route (use_chunked): where a block above would not fit shared
// memory (the whole head staged: bf16 past N ~ 420 at dh 64, f32 past N ~
// 250 at dh 64 or 108 at dh 128) and at every head width past 128, the
// same computation runs as three launches over scratch the wrapper
// allocates, (B N, 4 K) of t's dtype: block_gemm_kernel<LN> forms qkv =
// round(LayerNorm(t) . W + b) (statistics in f32, h rounded), the forward's
// kernels (attention.cu, which chunk the keys: attn_long_mma at bf16 past
// 256 keys, attn_long_tf32 at f32, attn_wide_mma past head width 128)
// give o, rounded, and
// block_gemm_kernel<!LN> adds o . proj onto t in f32, then proj_bias, one
// rounding. The GEMMs run f32 FMAs on the CUDA cores (T products are exact
// in f32): right, not fast.

#include <math.h>
#include <stdint.h>

#include "attn_mma.cuh"
#include "common.cuh"
#include "mma_common.cuh"

// The forward's entries (attention.cu), which the chunked route launches.
extern "C" int devit_fused_attention(const void* qkv, void* out, int B, int N, int H,
                                     int head_dim, int dtype, float scale, void* stream);
extern "C" long long devit_attention_smem_bytes(int n, int head_dim, int elem_bytes, int device);

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
  static_assert(DH % 16 == 0, "a thread owns dims tx + 16 j");
  constexpr int DJ = DH / 16;  // dims of a head a thread owns
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
      float a[4][3 * DJ];  // rows 4*ty+i, columns tx + 16*j of the 3*DH
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 3 * DJ; ++j) a[i][j] = 0.f;
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
          float h[4], w[3 * DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i] = to_f(Hs[(4 * ty + i) * (kKC + 1) + k]);
#pragma unroll
          for (int j = 0; j < 3 * DJ; ++j) w[j] = to_f(Ws[k * 3 * DH + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 3 * DJ; ++j) a[i][j] = fmaf(h[i], w[j], a[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = r0 + 4 * ty + i;
        if (n >= N) continue;
#pragma unroll
        for (int j = 0; j < 3 * DJ; ++j) {
          const int sec = j / DJ, d = tx + 16 * (j % DJ);  // [q | k | v], dim
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
        float o[4][DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) o[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < N; ++c) {
          float p[4], v[DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) p[i] = S[(4 * ty + i) * SP + c];
#pragma unroll
          for (int j = 0; j < DJ; ++j) v[j] = to_f(V[c * DH + tx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(p[i], v[j], o[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int n = q0 + 4 * ty + i;
          if (n >= N) continue;
#pragma unroll
          for (int j = 0; j < DJ; ++j) Qt[(tx + 16 * j) * N + n] = from_f<T>(o[i][j]);
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

template <typename T, int DH>
cudaError_t launch(const void* t, const float* ns, const float* nb, const void* qw,
                   const float* qb, const void* pw, const float* pb, void* hbuf, float* acc,
                   void* out, int B, int N, int C, int H, float eps, float scale,
                       cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_attn_kernel<T, DH>, opted_in);
  if (err != cudaSuccess) return err;
  block_attn_kernel<T, DH><<<B, kThreads, smem_bytes(N, DH, sizeof(T)), stream>>>(
      static_cast<const T*>(t), ns, nb, static_cast<const T*>(qw), qb,
      static_cast<const T*>(pw), pb, static_cast<T*>(hbuf), acc, static_cast<T*>(out), N, C, H,
      scale, eps);
  return cudaGetLastError();
}

// ---- bf16 on the tensor cores

using devit::mma::attend_rows;
using devit::mma::bf16;
using devit::mma::cp_async16;
using devit::mma::ldmatrix_x4;
using devit::mma::ldmatrix_x4_trans;
using devit::mma::mma_bf16;
using devit::mma::pack_bf16;
using devit::mma::swz;
using devit::mma::swz_dh;

constexpr int kAttnThreads = 128;  // block_qkv_attn_kernel: 4 warps
constexpr int kRG = 64;            // tokens of one qkv pass, 16 a warp
constexpr int kCC = 64;            // columns of C a staged chunk
constexpr int kPK = 64;            // rows of K (o columns, proj rows) a proj stage
constexpr int kPM = 128, kPN = 128;  // block_proj_kernel's output tile
constexpr int kProjThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kProjStage = (kPM + kPN) * kPK * 2;  // bytes: o [128][64] | proj [2][64][64]

// Sections of [q | k | v] one qkv pass of block_qkv_attn_kernel forms: all
// three at dh <= 64; one at a time at dh 128 (registers).
__host__ __device__ constexpr int sections_a_pass(int dh) { return dh > 64 ? 1 : 3; }

size_t attn_smem_bytes(int n, int dh) {
  // Q, K, V [NP][dh] | W [sections a pass][kCC][dh] | H [kRG][64] bf16 | mean, rstd [NP] f32
  const size_t np = (size_t)((n + 15) & ~15);
  return (3 * np * dh + (size_t)sections_a_pass(dh) * kCC * dh + kRG * 64) * 2 +
         2 * np * sizeof(float);
}

size_t mma_smem_bytes(int n, int dh) {
  const size_t a = attn_smem_bytes(n, dh), p = 2 * (size_t)kProjStage;
  return a > p ? a : p;
}

template <int KC, int DH>
__global__ void __launch_bounds__(kAttnThreads, 2)
block_qkv_attn_kernel(const bf16* __restrict__ t, const float* __restrict__ ns,
                      const float* __restrict__ nb, const bf16* __restrict__ qw,
                      const float* __restrict__ qb, bf16* __restrict__ o, int N, int C, int H,
                      float scale, float eps) {
  constexpr int kSec = sections_a_pass(DH);
  constexpr int kCPR = DH / 8;  // 16-byte chunks of a head row
  constexpr int kShift = devit::mma::chunk_shift<DH>();
  extern __shared__ __align__(128) unsigned char smem[];
  const int NP = (N + 15) & ~15;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + NP * DH;
  bf16* Vs = Ks + NP * DH;
  bf16* Ws = Vs + NP * DH;        // [kSec][kCC][DH]: the head's columns of a chunk
  bf16* Hs = Ws + kSec * kCC * DH;  // [kRG][64]: LN'd, rounded tokens of a chunk
  float* mean = reinterpret_cast<float*>(Hs + kRG * 64);
  float* rstd = mean + NP;

  const int K = H * DH;
  const int b = blockIdx.x / H, hd = blockIdx.x % H;  // a row's heads run together
  const bf16* tb = t + (int64_t)b * N * C;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // ---- LayerNorm statistics (f32): 8 lanes a token, 16 tokens in flight a
  // block; a lane sums 8 values a 16-byte load, loads unrolled
  {
    const int sub = lane & 7;
    for (int n0 = 4 * warp; n0 < N; n0 += 4 * (kAttnThreads / 32)) {
      const int n = n0 + (lane >> 3);
      const bf16* tr = tb + (int64_t)min(n, N - 1) * C;
      float s = 0.f;
#pragma unroll 4
      for (int c = 8 * sub; c < C; c += 64) {
        const uint4 raw = *reinterpret_cast<const uint4*>(tr + c);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) s += __bfloat162float(v[j]);
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      const float mu = s / (float)C;
      float var = 0.f;
#pragma unroll 4
      for (int c = 8 * sub; c < C; c += 64) {
        const uint4 raw = *reinterpret_cast<const uint4*>(tr + c);
        const bf16* v = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float d = __bfloat162float(v[j]) - mu;
          var = fmaf(d, d, var);
        }
      }
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
      if (sub == 0 && n < N) {
        mean[n] = mu;
        rstd[n] = rsqrtf(var / (float)C + eps);
      }
    }
  }

  // ---- q, k, v of head hd, kRG tokens a pass (kSec sections at once);
  // warp w owns tokens 16w ..
  const int64_t w3 = 3LL * K;
  const int m = 16 * warp;
  for (int r0 = 0; r0 < NP; r0 += kRG) {
    for (int s0 = 0; s0 < 3; s0 += kSec) {
      float acc[kSec][kCPR][4];
#pragma unroll
      for (int sec = 0; sec < kSec; ++sec)
#pragma unroll
        for (int j = 0; j < kCPR; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[sec][j][e] = 0.f;
      for (int c0 = 0; c0 < C; c0 += kCC) {
        __syncthreads();  // the statistics are in; the last chunk's Ws and Hs are free
        for (int i = tid; i < kSec * kCC * kCPR; i += kAttnThreads) {
          const int sec = i / (kCC * kCPR), r = (i >> kShift) % kCC, ch = i & (kCPR - 1);
          const bool ok = c0 + r < C;
          cp_async16(Ws + sec * kCC * DH + swz_dh<DH>(r, ch),
                     qw + (int64_t)(ok ? c0 + r : 0) * w3 + (s0 + sec) * K + hd * DH + 8 * ch, ok);
        }
        for (int i = tid; i < kRG * 8; i += kAttnThreads) {
          const int r = i >> 3, ch = i & 7;
          const int n = r0 + r, c = c0 + 8 * ch;
          uint4 packed = make_uint4(0u, 0u, 0u, 0u);  // zero past N and past C
          if (n < N && c < C) {
            const uint4 raw = *reinterpret_cast<const uint4*>(tb + (int64_t)n * C + c);
            const bf16* v = reinterpret_cast<const bf16*>(&raw);
            const float mu = mean[n], rs = rstd[n];
            uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c2 = c + 2 * j;
              const float h0 = __fadd_rn(__fmul_rn(__fmul_rn(__bfloat162float(v[2 * j]) - mu, rs),
                                                   ns[c2]), nb[c2]);
              const float h1 = __fadd_rn(__fmul_rn(__fmul_rn(__bfloat162float(v[2 * j + 1]) - mu,
                                                             rs), ns[c2 + 1]), nb[c2 + 1]);
              p[j] = pack_bf16(h0, h1);
            }
          }
          *reinterpret_cast<uint4*>(Hs + swz(r, ch)) = packed;
        }
        devit::mma::cp_async_wait_all();
        __syncthreads();
        if (r0 + m < NP) {
#pragma unroll
          for (int ks = 0; ks < kCC / 16; ++ks) {
            uint32_t a[4];
            ldmatrix_x4(a, Hs + swz(m + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
            for (int sec = 0; sec < kSec; ++sec)
#pragma unroll
              for (int d = 0; d < DH / 16; ++d) {
                uint32_t wb[4];  // columns 16d ..: {wb0, wb1}; 16d + 8 ..: {wb2, wb3}
                const int wr = 16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3);
                ldmatrix_x4_trans(wb, Ws + sec * kCC * DH + swz_dh<DH>(wr, 2 * d + (lane >> 4)));
                mma_bf16(acc[sec][2 * d], a, wb[0], wb[1]);
                mma_bf16(acc[sec][2 * d + 1], a, wb[2], wb[3]);
              }
          }
        }
      }
      // + the bias, rounded once, into the warp's 16 rows of Q, K and V (rows
      // past N hold the bias: finite, masked as keys, never written as queries)
      if (r0 + m < NP) {
#pragma unroll
        for (int sec = 0; sec < kSec; ++sec) {
          bf16* dst = Qs + (s0 + sec) * NP * DH;
#pragma unroll
          for (int j = 0; j < kCPR; ++j) {
            const int col = 8 * j + 2 * (lane & 3);
            const float b0 = qb != nullptr ? qb[(s0 + sec) * K + hd * DH + col] : 0.f;
            const float b1 = qb != nullptr ? qb[(s0 + sec) * K + hd * DH + col + 1] : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int r = r0 + m + (lane >> 2) + 8 * half;
              *reinterpret_cast<uint32_t*>(dst + swz_dh<DH>(r, j) + 2 * (lane & 3)) =
                  pack_bf16(acc[sec][j][2 * half] + b0, acc[sec][j][2 * half + 1] + b1);
            }
          }
        }
      }
    }
  }
  __syncthreads();

  // ---- attention: warp w takes the 16-row tiles w, w + 4, ...; o rounded
  // into the tile's own rows of Q, then 16-byte stores into the scratch
  bf16* ob = o + (int64_t)b * N * K + hd * DH;
  for (int q0 = m; q0 < NP; q0 += 16 * (kAttnThreads / 32)) {
    uint32_t qa[DH / 16][4];
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      ldmatrix_x4(qa[ks], Qs + swz_dh<DH>(q0 + (lane & 15), 2 * ks + (lane >> 4)));
    float ov[kCPR][4];
    attend_rows<KC, DH>(ov, qa, Ks, Vs, N, scale, lane);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kCPR; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = q0 + (lane >> 2) + 8 * half;
        *reinterpret_cast<uint32_t*>(Qs + swz_dh<DH>(r, j) + 2 * (lane & 3)) =
            pack_bf16(ov[j][2 * half], ov[j][2 * half + 1]);
      }
    __syncwarp();
    for (int i = lane; i < 16 * kCPR; i += 32) {
      const int r = i >> kShift, c = i & (kCPR - 1);
      const int n = q0 + r;
      if (n < N)
        *reinterpret_cast<uint4*>(ob + (int64_t)n * K + 8 * c) =
            *reinterpret_cast<const uint4*>(Qs + swz_dh<DH>(q0 + r, c));
    }
  }
}

// One stage of block_proj_kernel: o rows m0.., K columns 64 kc .. 64 kc +
// 63; proj rows 64 kc.., columns n0 .. n0 + 127 as two swizzled [64][64]
// tiles. Ragged (K not a multiple of 64: dh 32, odd H): zero past K.
template <bool Ragged>
__device__ __forceinline__ void proj_stage(bf16* st, const bf16* o, const bf16* pw, int64_t m0,
                                           int n0, int kc, int64_t M, int C, int K, int tid) {
  bf16* Os = st;
  bf16* Ps = st + kPM * kPK;
#pragma unroll
  for (int j = 0; j < kPM * 8 / kProjThreads; ++j) {
    const int i = tid + j * kProjThreads;
    const int r = i >> 3, c = i & 7;
    const bool ok = m0 + r < M && (!Ragged || kc * kPK + 8 * c < K);
    cp_async16(Os + swz(r, c), o + (ok ? m0 + r : 0) * K + (ok ? kc * kPK + 8 * c : 0), ok);
  }
#pragma unroll
  for (int j = 0; j < kPK * 16 / kProjThreads; ++j) {
    const int i = tid + j * kProjThreads;
    const int r = i >> 4, half = (i >> 3) & 1, c = i & 7;
    const int col = n0 + 64 * half + 8 * c;
    const bool ok = col < C && (!Ragged || kc * kPK + r < K);
    cp_async16(Ps + half * kPK * kPK + swz(r, c),
               pw + (int64_t)(ok ? kc * kPK + r : 0) * C + (ok ? col : 0), ok);
  }
}

template <bool Ragged>
__global__ void __launch_bounds__(kProjThreads, 2)
block_proj_kernel(const bf16* __restrict__ t, const bf16* __restrict__ o,
                  const bf16* __restrict__ pw, const float* __restrict__ pb,
                  bf16* __restrict__ out, int64_t M, int C, int K) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  constexpr int kStageElems = kProjStage / 2;
  const int n_kc = (K + kPK - 1) / kPK;     // 64-row chunks of K
  const int n_tiles = (C + kPN - 1) / kPN;  // a row tile's column tiles are adjacent blocks
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kPM;
  const int n0 = (blockIdx.x % n_tiles) * kPN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;  // the warp's rows and columns

  proj_stage<Ragged>(stages, o, pw, m0, n0, 0, M, C, K, tid);
  devit::mma::cp_async_commit();
  // the accumulators start from t (f32); C is a multiple of 32, so a pair
  // of columns lies wholly before or past C
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + 8 * j + 2 * (lane & 3);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = m0 + wm + 16 * i + (lane >> 2) + 8 * half;
        float2 v = make_float2(0.f, 0.f);
        if (row < M && col < C)
          v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(t + row * C + col));
        acc[i][j][2 * half] = v.x;
        acc[i][j][2 * half + 1] = v.y;
      }
    }

  for (int kc = 0; kc < n_kc; ++kc) {
    if (kc + 1 < n_kc)
      proj_stage<Ragged>(stages + ((kc + 1) & 1) * kStageElems, o, pw, m0, n0, kc + 1, M, C, K,
                         tid);
    devit::mma::cp_async_commit();
    devit::mma::cp_async_wait<1>();
    __syncthreads();  // head kc's stage landed
    const bf16* Os = stages + (kc & 1) * kStageElems;
    const bf16* Ps = Os + kPM * kPK + (wn >> 6) * kPK * kPK;  // the warp's 64-column tile
#pragma unroll
    for (int ks = 0; ks < kPK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], Os + swz(wm + 16 * i + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        uint32_t pb4[4];  // columns wn + 16d ..: {pb0, pb1}; wn + 16d + 8 ..: {pb2, pb3}
        ldmatrix_x4_trans(pb4, Ps + swz(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                        2 * ((wn & 63) / 16 + d) + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * d], a[i], pb4[0], pb4[1]);
          mma_bf16(acc[i][2 * d + 1], a[i], pb4[2], pb4[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  // ---- + proj_bias, one rounding
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * (lane & 3);
    if (col >= C) continue;
    const float b0 = pb[col], b1 = pb[col + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = m0 + wm + 16 * i + (lane >> 2) + 8 * half;
        if (row < M)
          *reinterpret_cast<uint32_t*>(out + row * C + col) =
              pack_bf16(__fadd_rn(acc[i][j][2 * half], b0), __fadd_rn(acc[i][j][2 * half + 1], b1));
      }
  }
}

template <int KC, int DH>
cudaError_t launch_qkv_attn(const bf16* t, const float* ns, const float* nb, const bf16* qw,
                            const float* qb, bf16* o, int B, int N, int C, int H, float eps,
                            float scale, cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_qkv_attn_kernel<KC, DH>, opted_in);
  if (err != cudaSuccess) return err;
  block_qkv_attn_kernel<KC, DH><<<(unsigned)(B * H), kAttnThreads, attn_smem_bytes(N, DH),
                                  stream>>>(t, ns, nb, qw, qb, o, N, C, H,
                                            scale, eps);
  return cudaGetLastError();
}

template <bool Ragged>
cudaError_t launch_proj(const bf16* t, const bf16* o, const bf16* pw, const float* pb,
                        bf16* out, int64_t M, int C, int K, cudaStream_t s) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_proj_kernel<Ragged>, opted_in);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)(((M + kPM - 1) / kPM) * ((C + kPN - 1) / kPN));
  block_proj_kernel<Ragged><<<grid, kProjThreads, 2 * kProjStage, s>>>(t, o, pw, pb, out, M, C,
                                                                       K);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_bf16(const void* t, const float* ns, const float* nb, const void* qw,
                        const float* qb, const void* pw, const float* pb, void* o, void* out,
                        int B, int N, int C, int H, float eps, float scale, cudaStream_t s) {
  const bf16* tt = static_cast<const bf16*>(t);
  const bf16* w = static_cast<const bf16*>(qw);
  bf16* ob = static_cast<bf16*>(o);
  // the fewest score registers that hold a row, as attention.cu's launch_bf16
  cudaError_t err =
      N <= 64    ? launch_qkv_attn<4, DH>(tt, ns, nb, w, qb, ob, B, N, C, H, eps, scale, s)
      : N <= 128 ? launch_qkv_attn<8, DH>(tt, ns, nb, w, qb, ob, B, N, C, H, eps, scale, s)
      : N <= 208 ? launch_qkv_attn<13, DH>(tt, ns, nb, w, qb, ob, B, N, C, H, eps, scale, s)
                 : launch_qkv_attn<16, DH>(tt, ns, nb, w, qb, ob, B, N, C, H, eps, scale, s);
  if (err != cudaSuccess) return err;
  const int64_t M = (int64_t)B * N;
  const int K = H * DH;
  const bf16* pwt = static_cast<const bf16*>(pw);
  bf16* outt = static_cast<bf16*>(out);
  if (K % kPK != 0) return launch_proj<true>(tt, ob, pwt, pb, outt, M, C, K, s);
  return launch_proj<false>(tt, ob, pwt, pb, outt, M, C, K, s);
}

// ---- the chunked route: LN + qkv, the forward's kernels, proj

constexpr int kGT = 64;         // output rows and columns of a block_gemm_kernel block
constexpr int kGK = 32;         // depth of its staged chunks
constexpr int kGStride = kGT + 1;

size_t gemm_smem_bytes() {
  // A^T [kGK][kGStride] | W [kGK][kGStride] | mean, rstd [kGT], f32
  return sizeof(float) * (2 * kGK * kGStride + 2 * kGT);
}

// out[m][n] = round(init + sum_k a[m][k] w[k][n] + bias[n]), m < M, n < Nc,
// for (M, Kd) rows a and a (Kd, Nc) weight w. LN: a is t and its rows enter
// as round(LayerNorm(a)) (the two-pass f32 statistics, then (a - mean) rstd
// ns + nb), init 0: the qkv product. Otherwise init = t[m][n] (width Nc):
// the proj product onto the residual. bias may be null. One block a 64 x 64
// output tile, 16 column lanes x 16 row groups of 4.
template <typename T, bool LN>
__global__ void __launch_bounds__(kThreads)
block_gemm_kernel(const T* __restrict__ a, const T* __restrict__ t, const float* __restrict__ ns,
                  const float* __restrict__ nb, const T* __restrict__ w,
                  const float* __restrict__ bias, T* __restrict__ out, long long M, int Kd,
                  int Nc, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* As = reinterpret_cast<float*>(smem);
  float* Ws = As + kGK * kGStride;
  float* mean = Ws + kGK * kGStride;
  float* rstd = mean + kGT;
  const int col_tiles = (Nc + kGT - 1) / kGT;
  const long long m0 = (long long)(blockIdx.x / col_tiles) * kGT;
  const int n0 = (blockIdx.x % col_tiles) * kGT;
  const int rows = (int)(M - m0 < kGT ? M - m0 : kGT);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  if (LN) {  // 4 lanes a row
    const int r = tid / 4, sub = tid % 4;
    const T* row = a + (m0 + r) * Kd;
    float sum = 0.f, sq = 0.f;
    if (r < rows)
      for (int k = sub; k < Kd; k += 4) sum += to_f(row[k]);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float mu = sum / Kd;
    if (r < rows)
      for (int k = sub; k < Kd; k += 4) {
        const float d = to_f(row[k]) - mu;
        sq = fmaf(d, d, sq);
      }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    if (sub == 0) {
      mean[r] = mu;
      rstd[r] = rsqrtf(sq / Kd + eps);
    }
  }
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Kd; k0 += kGK) {
    __syncthreads();  // the statistics are in; the previous chunk's readers are done
    for (int i = tid; i < kGT * kGK; i += kThreads) {
      const int r = i / kGK, k = i % kGK;
      float v = 0.f;
      if (r < rows && k0 + k < Kd) {
        v = to_f(a[(m0 + r) * Kd + k0 + k]);
        if (LN) v = devit::round_to<T>((v - mean[r]) * rstd[r] * ns[k0 + k] + nb[k0 + k]);
      }
      As[k * kGStride + r] = v;
    }
    for (int i = tid; i < kGK * kGT; i += kThreads) {
      const int k = i / kGT, c = i % kGT;
      Ws[k * kGStride + c] =
          k0 + k < Kd && n0 + c < Nc ? to_f(w[(int64_t)(k0 + k) * Nc + n0 + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kGK; ++k) {
      float av[4], wv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k * kGStride + 4 * ty + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = Ws[k * kGStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], wv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= Nc) continue;
      const int64_t at = (m0 + r) * Nc + c;
      float v = LN ? acc[i][j] : to_f(t[at]) + acc[i][j];
      if (bias != nullptr) v += bias[c];
      out[at] = from_f<T>(v);
    }
  }
}

template <typename T, bool LN>
cudaError_t launch_gemm(const T* a, const T* t, const float* ns, const float* nb, const T* w,
                        const float* bias, T* out, long long M, int Kd, int Nc, float eps,
                        cudaStream_t s) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_gemm_kernel<T, LN>, opted_in);
  if (err != cudaSuccess) return err;
  const long long blocks = ((M + kGT - 1) / kGT) * ((Nc + kGT - 1) / kGT);
  block_gemm_kernel<T, LN><<<(unsigned)blocks, kThreads, gemm_smem_bytes(), s>>>(
      a, t, ns, nb, w, bias, out, M, Kd, Nc, eps);
  return cudaGetLastError();
}

// Whether the block half takes the chunked route at (n, head_dim, elem
// bytes) on a device that lets a block opt in to `optin` bytes.
bool use_chunked(int n, int dh, int elem, long long optin) {
  if (dh > 128) return true;
  const size_t need = elem == 2 ? mma_smem_bytes(n, dh) : smem_bytes(n, dh, elem);
  return (long long)need > optin;
}

template <typename T>
cudaError_t launch_chunked(const void* t, const float* const (&f)[4], const void* qw,
                           const void* pw, void* scratch, void* out, int B, int N, int C, int H,
                           int dh, float eps, int dtype, float scale, cudaStream_t s) {
  const long long M = (long long)B * N;
  const int K = H * dh;
  const T* tt = static_cast<const T*>(t);
  T* qkv = static_cast<T*>(scratch);
  T* o = qkv + M * 3 * K;
  cudaError_t err = launch_gemm<T, true>(tt, nullptr, f[0], f[1], static_cast<const T*>(qw),
                                         f[2], qkv, M, C, 3 * K, eps, s);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)devit_fused_attention(qkv, o, B, N, H, dh, dtype, scale, s);
  if (err != cudaSuccess) return err;
  return launch_gemm<T, false>(o, tt, nullptr, nullptr, static_cast<const T*>(pw), f[3],
                               static_cast<T*>(out), M, K, C, eps, s);
}

template <int DH>
cudaError_t launch_dh(const void* t, const float* const (&f)[4], const void* qw, const void* pw,
                      void* scratch, void* acc, void* out, int B, int N, int C, int H, float eps,
                      int dtype, float scale, cudaStream_t s) {
  if (dtype == 0)
    return launch<float, DH>(t, f[0], f[1], qw, f[2], pw, f[3], scratch,
                             static_cast<float*>(acc), out, B, N, C, H, eps, scale, s);
  if (dtype == 1)
    return launch_bf16<DH>(t, f[0], f[1], qw, f[2], pw, f[3], scratch, out, B, N, C, H, eps,
                           scale, s);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at sequence length n on `device`
// (bf16: the larger of the two kernels' needs; the chunked route: the
// largest of its launches').
long long devit_block_attention_smem_bytes(int n, int head_dim, int elem_bytes, int device) {
  if (use_chunked(n, head_dim, elem_bytes, devit::device_optin(device))) {
    const long long attn = devit_attention_smem_bytes(n, head_dim, elem_bytes, device);
    const long long gemm = (long long)gemm_smem_bytes();
    return attn > gemm ? attn : gemm;
  }
  return (long long)(elem_bytes == 2 ? mma_smem_bytes(n, head_dim)
                                     : smem_bytes(n, head_dim, elem_bytes));
}

// 1 when the block half takes the chunked route at (n, head_dim,
// elem_bytes) on `device`, and so needs the (B N, 4 H head_dim) scratch.
int devit_block_attention_chunked(int n, int head_dim, int elem_bytes, int device) {
  return use_chunked(n, head_dim, elem_bytes, devit::device_optin(device)) ? 1 : 0;
}

// t, out: (B, N, C) contiguous of the dtype; qkv_kernel (C, 3 H head_dim)
// and proj_kernel (H head_dim, C) contiguous of the dtype; norm scale/bias,
// proj bias (C,) and qkv bias (3 H head_dim,) or NULL, f32. Scratch: f32,
// `scratch` (B, N, C) f32 for the LN'd rows and `acc` (B, N, C) f32; bf16,
// `scratch` (B, N, H head_dim) bf16 for o and `acc` unused; on the chunked
// route (devit_block_attention_chunked), `scratch` (B, N, 4 H head_dim) of
// the dtype and `acc` unused. C must be a multiple of 32, and the bf16
// operands 16-byte aligned; head_dim 32, 64, 128 or any multiple of 64 past 128.
// dtype: 0 = float32, 1 = bfloat16. scale: as devit_fused_attention's.
// Returns a cudaError_t (0 = launched).
int devit_block_attention(const void* t, const void* ns, const void* nb, const void* qw,
                          const void* qb, const void* pw, const void* pb, void* scratch,
                          void* acc, void* out, int B, int N, int C, int H, int head_dim,
                          float eps, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 32 != 0 || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const float* const f[4] = {static_cast<const float*>(ns), static_cast<const float*>(nb),
                             static_cast<const float*>(qb), static_cast<const float*>(pb)};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (use_chunked(N, head_dim, dtype == 1 ? 2 : 4, devit::device_optin(dev)))
    return (int)(dtype == 0 ? launch_chunked<float>(t, f, qw, pw, scratch, out, B, N, C, H,
                                                    head_dim, eps, dtype, scale, s)
                            : launch_chunked<bf16>(t, f, qw, pw, scratch, out, B, N, C, H,
                                                   head_dim, eps, dtype, scale, s));
  if (head_dim == 32)
    return (int)launch_dh<32>(t, f, qw, pw, scratch, acc, out, B, N, C, H, eps, dtype, scale, s);
  if (head_dim == 64)
    return (int)launch_dh<64>(t, f, qw, pw, scratch, acc, out, B, N, C, H, eps, dtype, scale, s);
  if (head_dim == 128)
    return (int)launch_dh<128>(t, f, qw, pw, scratch, acc, out, B, N, C, H, eps, dtype, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
