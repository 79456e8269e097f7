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
// and HBM set about the same bound; at f32 (8 bytes a value read and
// written, 3xTF32 at a third of TF32's rate) the operations bound it.
//
// Every product runs on the tensor cores: mma.sync m16n8k16 at bf16 (bf16
// operands, f32 accumulators), three TF32 passes (3xTF32, m16n8k8) at f32.
// Two routes.
//
// bf16, the whole row (N to ~420 at dh 64, 208 at dh 128): two kernels. The
// TPU kernel holds a batch block's rows, qkv and residual in VMEM through one
// grid step; a block here has neither the room nor the order for that, so
// the work is cut at the heads:
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
// Head widths 32, 64 and 128 (DH, a template parameter): the head tiles hold
// rows of DH bf16 (swz_dh); at dh 128 the qkv product makes q, k and v one
// after the other (a warp's 16 tokens x 3 x 128 f32 accumulators would not
// fit its registers), and the proj kernel takes o and proj in 64-row chunks
// of K (at dh 32 and an odd H the last chunk is zero-filled past K).
//
// The chunked route (use_chunked): f32 at every size, and bf16 where a block
// above would not fit shared memory (the whole head staged: past N ~ 420 at
// dh 64) and at every head width past 128. The same computation runs as
// three launches over a (B N, 4 K) scratch of t's dtype that the wrapper
// allocates (qkv, then o):
// 1. LayerNorm + qkv = round(LayerNorm(t) . W + b): a GEMM over 128 x 128
//    output tiles of (B N, 3K), 8 warps of 64 x 32, with the tile's 128 rows'
//    statistics taken first (f32, two passes, block_qkv_attn_kernel's 8
//    lanes a row). The rows arrive by 16-byte loads one chunk of C ahead (in
//    registers while the current chunk's mma runs) and are normalised with
//    its (x - mean) rstd ns + nb, rounded to bf16 at bf16, on their way into
//    shared memory; the weights come with them. bf16: block_ln_qkv_mma,
//    64-deep chunks, the weights by cp.async, block_proj_kernel's tiles and
//    fragment loads. f32: block_gemm_tf32<true>, 32-deep chunks.
// 2. The forward's kernels (attention.cu, which chunk the keys: attn_long_mma
//    at bf16 past 256 keys, attn_long_tf32 at f32, attn_wide_mma past head
//    width 128) give o, rounded.
// 3. proj: out = round(t + o . proj + proj_bias), accumulators started from t
//    in f32. bf16: block_proj_kernel as the whole-row route launches it
//    (o is its (B N, K) operand either way). f32: block_gemm_tf32<false>.
// block_gemm_tf32 splits each operand into its (big, small) TF32 halves once,
// where it is staged (two shared-memory tiles an operand), so a fragment
// serves every warp that reads it without a split of its own: splitting where
// operands are read made the f32 attention kernels issue-bound. The A tiles
// are [128][32 + 4] f32 (ldmatrix rows on distinct bank groups), the B tiles
// [32][128 + 8] (the B fragments' 32-bit loads of (k t, column g) on 32
// banks). Each m16 tile's passes over a chunk are summed apart and added to
// the accumulators by an f32 add, as long_tf32.cuh's long sums (the tensor
// core's own f32 sums over a depth of 384-768 drift); the proj's accumulators
// start from t and take proj_bias last. At one block an SM (141 KB of shared
// memory, 8 warps) what bounds it on the H100 is shared memory and issue, not
// the tensor cores: the split halves double every fragment read, and a
// chunk's stores (normalise, split, 16-byte stores) run between barriers
// beside no mma. The LayerNorm kernel also takes its rows' statistics once a
// column tile, from L2: its time an operation is ~27% above the proj's
// (kh 5 at B 256). Tried on the H100 and not kept
// (scripts/kernel_variants.py block, the deployed f32 forward's 48 calls at
// B 256): an f32 add after every k8 step's three passes, 66.6 ms against
// 60.5 kept; no adds, 58.7 but ten times the error (6.3e-6 against 5.9e-7
// of the plain version); 16-deep chunks, 63.1-69.8; 128 x 64 tiles of 4
// warps, two blocks an SM, 76.1; each stage's stores interleaved with the
// m16 tiles' products, 61.9 against 60.2 (and 0.244 against 0.225 ms for
// the bf16 route at B 16, N 578, kh 6, where block_ln_qkv_mma at one block
// an SM took 0.247).
// Every output has one writer; no atomics, the same bits on every run.

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

using devit::to_f;

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

// ---- the chunked route: LayerNorm + qkv, the forward's kernels, proj

using devit::mma::cp_async_commit;
using devit::mma::cp_async_wait_all;
using devit::mma::mma_3xtf32;
using devit::mma::split_tf32;

// Bytes of block_ln_qkv_mma's shared memory: two stages of block_proj_kernel's
// size (rows [128][64] | W [2][64][64], bf16), then the rows' mean and rstd.
size_t ln_qkv_smem_bytes() { return 2 * (size_t)kProjStage + 2 * kPM * sizeof(float); }

// block_gemm_tf32's staging: 32-deep chunks; per stage the A tile [128][32 +
// 4] and the B tile [32][128 + 8], each as its big and its small TF32 half.
constexpr int kFK = 32;
constexpr int kFAStride = kFK + 4, kFBStride = kPN + 8;  // floats a row
constexpr int kFATile = kPM * kFAStride, kFBTile = kFK * kFBStride;  // floats
constexpr int kFStage = 2 * (kFATile + kFBTile);  // A big | A small | B big | B small

size_t tf32_smem_bytes() { return sizeof(float) * (2 * (size_t)kFStage + 2 * kPM); }

// mean and rstd (f32, two passes: the sum, then the sum of squared
// deviations) of rows m0 .. m0 + 127 of t (M, C), 8 lanes a row with 16-byte
// loads, as block_qkv_attn_kernel's statistics. Rows past M take row M - 1's
// (never used: those rows are zero-filled and never written).
template <typename T>
__device__ __forceinline__ void tile_stats(const T* __restrict__ t, int64_t m0, int64_t M, int C,
                                           float eps, float* mean, float* rstd, int tid) {
  constexpr int kVec = 16 / sizeof(T);  // values a load
  const int sub = tid & 7;
  for (int r = tid >> 3; r < kPM; r += kProjThreads / 8) {
    const T* tr = t + (m0 + r < M ? m0 + r : M - 1) * C;
    float s = 0.f;
#pragma unroll 4
    for (int c = kVec * sub; c < C; c += 8 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tr + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) s += to_f(v[j]);
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mu = s / (float)C;
    float var = 0.f;
#pragma unroll 4
    for (int c = kVec * sub; c < C; c += 8 * kVec) {
      const uint4 raw = *reinterpret_cast<const uint4*>(tr + c);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float d = to_f(v[j]) - mu;
        var = fmaf(d, d, var);
      }
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) var += __shfl_xor_sync(0xffffffffu, var, o);
    if (sub == 0) {
      mean[r] = mu;
      rstd[r] = rsqrtf(var / (float)C + eps);
    }
  }
}

// x LayerNorm'd: (x - mean) rstd ns + nb, in this order, each step rounded
// (no FMA), as the whole-row kernel and the TPU kernel compute it.
__device__ __forceinline__ float layer_norm(float x, float mu, float rs, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mu, rs), s), b);
}

// Row r and 16-byte chunk c of the [128][64] row tile of one chunk that
// thread tid's j-th load covers (block_ln_qkv_mma).
__device__ __forceinline__ int ln_row(int tid, int j) { return (tid + j * kProjThreads) >> 3; }
__device__ __forceinline__ int ln_chunk(int tid, int j) { return (tid + j * kProjThreads) & 7; }

// qkv = round(LayerNorm(t) . w + qb) at bf16: t (M, C), w (C, N3), qkv (M,
// N3). One block a 128 x 128 output tile (a row tile's column tiles are
// adjacent blocks, so its rows stay in L2), 8 warps of 64 x 32 as
// block_proj_kernel's; C in 64-column chunks through two stages. A stage's
// rows are loaded into registers while the previous stage's mma runs and
// stored normalised and rounded after it; its W columns come by cp.async.
__global__ void __launch_bounds__(kProjThreads, 2)
block_ln_qkv_mma(const bf16* __restrict__ t, const float* __restrict__ ns,
                 const float* __restrict__ nb, const bf16* __restrict__ w,
                 const float* __restrict__ qb, bf16* __restrict__ qkv, int64_t M, int C, int N3,
                 float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  constexpr int kStageElems = kProjStage / 2;
  float* mean = reinterpret_cast<float*>(smem + 2 * kProjStage);
  float* rstd = mean + kPM;
  const int n_kc = (C + kPK - 1) / kPK;      // 64-column chunks of C
  const int n_tiles = (N3 + kPN - 1) / kPN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kPM;
  const int n0 = (blockIdx.x % n_tiles) * kPN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;  // the warp's rows and columns

  // W rows 64 kc .. of columns n0 .. n0 + 127 into a stage's two [64][64] tiles
  auto w_stage = [&](int kc) {
    bf16* Ws = stages + (kc & 1) * kStageElems + kPM * kPK;
#pragma unroll
    for (int j = 0; j < kPK * 16 / kProjThreads; ++j) {
      const int i = tid + j * kProjThreads;
      const int r = i >> 4, half = (i >> 3) & 1, c = i & 7;
      const int col = n0 + 64 * half + 8 * c, row = kc * kPK + r;
      const bool ok = col < N3 && row < C;
      cp_async16(Ws + half * kPK * kPK + swz(r, c), w + (ok ? (int64_t)row * N3 + col : 0), ok);
    }
    cp_async_commit();
  };
  uint4 raw[kPM * 8 / kProjThreads];  // the next chunk's rows, 8 bf16 a load
  auto load_rows = [&](int kc) {
#pragma unroll
    for (int j = 0; j < kPM * 8 / kProjThreads; ++j) {
      const int64_t row = m0 + ln_row(tid, j);
      const int col = kc * kPK + 8 * ln_chunk(tid, j);
      raw[j] = row < M && col < C ? *reinterpret_cast<const uint4*>(t + row * C + col)
                                  : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_rows = [&](int kc) {  // normalised, rounded; zero past M and past C
    bf16* As = stages + (kc & 1) * kStageElems;
#pragma unroll
    for (int j = 0; j < kPM * 8 / kProjThreads; ++j) {
      const int r = ln_row(tid, j), c = ln_chunk(tid, j);
      const int col = kc * kPK + 8 * c;
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M && col < C) {
        const bf16* v = reinterpret_cast<const bf16*>(&raw[j]);
        const float4 s0 = *reinterpret_cast<const float4*>(ns + col);
        const float4 s1 = *reinterpret_cast<const float4*>(ns + col + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(nb + col);
        const float4 b1 = *reinterpret_cast<const float4*>(nb + col + 4);
        const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
        const float mu = mean[r], rs = rstd[r];
        uint32_t* p = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = pack_bf16(layer_norm(__bfloat162float(v[2 * e]), mu, rs, s[2 * e], b[2 * e]),
                           layer_norm(__bfloat162float(v[2 * e + 1]), mu, rs, s[2 * e + 1],
                                      b[2 * e + 1]));
      }
      *reinterpret_cast<uint4*>(As + swz(r, c)) = packed;
    }
  };

  w_stage(0);
  tile_stats(t, m0, M, C, eps, mean, rstd, tid);
  load_rows(0);
  __syncthreads();  // the statistics are in
  store_rows(0);
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int kc = 0; kc < n_kc; ++kc) {
    cp_async_wait_all();
    __syncthreads();  // stage kc is in; every warp is done with stage kc - 1
    if (kc + 1 < n_kc) {
      w_stage(kc + 1);
      load_rows(kc + 1);
    }
    const bf16* As = stages + (kc & 1) * kStageElems;
    const bf16* Ws = As + kPM * kPK + (wn >> 6) * kPK * kPK;  // the warp's 64-column tile
#pragma unroll
    for (int ks = 0; ks < kPK / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4(a[i], As + swz(wm + 16 * i + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        uint32_t wb[4];  // columns wn + 16d ..: {wb0, wb1}; wn + 16d + 8 ..: {wb2, wb3}
        ldmatrix_x4_trans(wb, Ws + swz(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                                       2 * ((wn & 63) / 16 + d) + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          mma_bf16(acc[i][2 * d], a[i], wb[0], wb[1]);
          mma_bf16(acc[i][2 * d + 1], a[i], wb[2], wb[3]);
        }
      }
    }
    if (kc + 1 < n_kc) store_rows(kc + 1);
  }

  // ---- + the bias, one rounding (N3 is a multiple of 8: a column pair lies
  // wholly before or past it)
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * (lane & 3);
    if (col >= N3) continue;
    const float b0 = qb != nullptr ? qb[col] : 0.f, b1 = qb != nullptr ? qb[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = m0 + wm + 16 * i + (lane >> 2) + 8 * half;
        if (row < M)
          *reinterpret_cast<uint32_t*>(qkv + row * N3 + col) =
              pack_bf16(acc[i][j][2 * half] + b0, acc[i][j][2 * half + 1] + b1);
      }
  }
}

// out = init + a . b + bias at f32 as 3xTF32: a (M, depth), b (depth,
// ncols), out (M, ncols). LN (the qkv product): a is t, its rows entering as
// LayerNorm(t) (the tile's statistics first), init 0, bias qb (or null).
// Otherwise (the proj product): a is o, init = t (M, ncols), bias proj_bias.
// One block a 128 x 128 output tile (a row tile's column tiles adjacent), 8
// warps of 64 x 32; depth in 32-deep chunks through two stages. A stage's
// chunk of a and b is loaded into registers (16-byte loads) while the
// previous stage's mma runs, then normalised (LN), split into its TF32 halves
// and stored after it; every fragment is read already split. Per chunk a
// warp reads its B fragments (4 k8 steps x 4 n8 tiles, big and small) once
// into registers, then takes its m16 tiles one at a time: the tile's 12
// passes over the chunk (4 k8 steps x 3) go into zeroed partial sums, added
// to the accumulators by one f32 add each (the tensor core's own f32 sums
// drift over a depth of 384-768: long_tf32.cuh).
template <bool LN>
__global__ void __launch_bounds__(kProjThreads, 1)
block_gemm_tf32(const float* __restrict__ a, const float* __restrict__ t,
                const float* __restrict__ ns, const float* __restrict__ nb,
                const float* __restrict__ b, const float* __restrict__ bias,
                float* __restrict__ out, int64_t M, int depth, int ncols, float eps) {
  constexpr int kLoadsA = kPM * kFK / 4 / kProjThreads;  // 16-byte loads a thread, of a
  constexpr int kLoadsB = kFK * kPN / 4 / kProjThreads;  // and of b
  constexpr int kBC = kPN / 4;                           // 16-byte chunks of a b row
  extern __shared__ __align__(128) unsigned char smem[];
  uint32_t* stages = reinterpret_cast<uint32_t*>(smem);
  float* mean = reinterpret_cast<float*>(stages + 2 * kFStage);
  float* rstd = mean + kPM;
  const int n_kc = (depth + kFK - 1) / kFK;
  const int n_tiles = (ncols + kPN - 1) / kPN;
  const int64_t m0 = (int64_t)(blockIdx.x / n_tiles) * kPM;
  const int n0 = (blockIdx.x % n_tiles) * kPN;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

  // thread tid's j-th load: a row i / kAC, columns 4 (i % kAC) ..; b row i /
  // 32, columns 4 (i % 32) .., i = tid + j kProjThreads
  constexpr int kAC = kFK / 4;  // 16-byte chunks of a chunk's a row
  float4 ra[kLoadsA], rb[kLoadsB];
  auto load = [&](int kc) {
#pragma unroll
    for (int j = 0; j < kLoadsA; ++j) {
      const int i = tid + j * kProjThreads;
      const int64_t row = m0 + i / kAC;
      const int col = kc * kFK + 4 * (i % kAC);
      ra[j] = row < M && col < depth ? *reinterpret_cast<const float4*>(a + row * depth + col)
                                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kLoadsB; ++j) {
      const int i = tid + j * kProjThreads;
      const int brow = kc * kFK + i / kBC, bcol = n0 + 4 * (i % kBC);
      rb[j] = brow < depth && bcol < ncols
                  ? *reinterpret_cast<const float4*>(b + (int64_t)brow * ncols + bcol)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto put = [](uint32_t* big, uint32_t* small, float4 v) {
    uint4 hi, lo;
    split_tf32(__float_as_uint(v.x), hi.x, lo.x);
    split_tf32(__float_as_uint(v.y), hi.y, lo.y);
    split_tf32(__float_as_uint(v.z), hi.z, lo.z);
    split_tf32(__float_as_uint(v.w), hi.w, lo.w);
    *reinterpret_cast<uint4*>(big) = hi;
    *reinterpret_cast<uint4*>(small) = lo;
  };
  auto store = [&](int kc) {
    uint32_t* A = stages + (kc & 1) * kFStage;
    uint32_t* Bt = A + 2 * kFATile;
#pragma unroll
    for (int j = 0; j < kLoadsA; ++j) {
      const int i = tid + j * kProjThreads;
      const int r = i / kAC, c = i % kAC;
      float4 v = ra[j];
      const int col = kc * kFK + 4 * c;
      if (LN && m0 + r < M && col < depth) {  // zero past M and past C stays zero
        const float4 s = *reinterpret_cast<const float4*>(ns + col);
        const float4 o = *reinterpret_cast<const float4*>(nb + col);
        const float mu = mean[r], rs = rstd[r];
        v = make_float4(layer_norm(v.x, mu, rs, s.x, o.x), layer_norm(v.y, mu, rs, s.y, o.y),
                        layer_norm(v.z, mu, rs, s.z, o.z), layer_norm(v.w, mu, rs, s.w, o.w));
      }
      put(A + r * kFAStride + 4 * c, A + kFATile + r * kFAStride + 4 * c, v);
    }
#pragma unroll
    for (int j = 0; j < kLoadsB; ++j) {
      const int i = tid + j * kProjThreads;
      const int br = i / kBC, bc = i % kBC;
      put(Bt + br * kFBStride + 4 * bc, Bt + kFBTile + br * kFBStride + 4 * bc, rb[j]);
    }
  };

  if (LN) tile_stats(a, m0, M, depth, eps, mean, rstd, tid);
  load(0);
  if (LN) __syncthreads();  // the statistics are in
  store(0);
  // the accumulators start from t at the proj (0 at qkv); ncols is a
  // multiple of 8, so a column pair lies wholly before or past it
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
        if (!LN && row < M && col < ncols)
          v = *reinterpret_cast<const float2*>(t + row * ncols + col);
        acc[i][j][2 * half] = v.x;
        acc[i][j][2 * half + 1] = v.y;
      }
    }

  for (int kc = 0; kc < n_kc; ++kc) {
    __syncthreads();  // stage kc is in; every warp is done with stage kc - 1
    if (kc + 1 < n_kc) load(kc + 1);
    const uint32_t* A = stages + (kc & 1) * kFStage;
    const uint32_t* Bt = A + 2 * kFATile;
    uint32_t bf[kFK / 8][4][4];  // B fragments of the chunk: (ks, n8 tile) -> bb0, bb1, bs0, bs1
#pragma unroll
    for (int ks = 0; ks < kFK / 8; ++ks) {
      const int bt = (8 * ks + (lane & 3)) * kFBStride + wn + (lane >> 2);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bf[ks][j][0] = Bt[bt + 8 * j];
        bf[ks][j][1] = Bt[bt + 4 * kFBStride + 8 * j];
        bf[ks][j][2] = Bt[kFBTile + bt + 8 * j];
        bf[ks][j][3] = Bt[kFBTile + bt + 4 * kFBStride + 8 * j];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float part[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kFK / 8; ++ks) {
        uint32_t ab[4], as[4];
        const int at = (wm + 16 * i + (lane & 15)) * kFAStride + 4 * (2 * ks + (lane >> 4));
        ldmatrix_x4(ab, A + at);
        ldmatrix_x4(as, A + kFATile + at);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_3xtf32(part[j], ab, as, bf[ks][j][0], bf[ks][j][1], bf[ks][j][2], bf[ks][j][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = __fadd_rn(acc[i][j][e], part[j][e]);
    }
    if (kc + 1 < n_kc) store(kc + 1);
  }

  // ---- + the bias
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + wn + 8 * j + 2 * (lane & 3);
    if (col >= ncols) continue;
    const float b0 = bias != nullptr ? bias[col] : 0.f, b1 = bias != nullptr ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t row = m0 + wm + 16 * i + (lane >> 2) + 8 * half;
        if (row < M)
          *reinterpret_cast<float2*>(out + row * ncols + col) =
              make_float2(__fadd_rn(acc[i][j][2 * half], b0), __fadd_rn(acc[i][j][2 * half + 1], b1));
      }
  }
}

unsigned gemm_grid(int64_t M, int ncols) {
  return (unsigned)(((M + kPM - 1) / kPM) * ((ncols + kPN - 1) / kPN));
}

cudaError_t launch_ln_qkv(const bf16* t, const float* ns, const float* nb, const bf16* w,
                          const float* qb, bf16* qkv, int64_t M, int C, int N3, float eps,
                          cudaStream_t s) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_ln_qkv_mma, opted_in);
  if (err != cudaSuccess) return err;
  block_ln_qkv_mma<<<gemm_grid(M, N3), kProjThreads, ln_qkv_smem_bytes(), s>>>(
      t, ns, nb, w, qb, qkv, M, C, N3, eps);
  return cudaGetLastError();
}

template <bool LN>
cudaError_t launch_tf32(const float* a, const float* t, const float* ns, const float* nb,
                        const float* b, const float* bias, float* out, int64_t M, int depth,
                        int ncols, float eps, cudaStream_t s) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)block_gemm_tf32<LN>, opted_in);
  if (err != cudaSuccess) return err;
  block_gemm_tf32<LN><<<gemm_grid(M, ncols), kProjThreads, tf32_smem_bytes(), s>>>(
      a, t, ns, nb, b, bias, out, M, depth, ncols, eps);
  return cudaGetLastError();
}

// Whether the block half takes the chunked route at (n, head_dim, elem
// bytes) on a device that lets a block opt in to `optin` bytes: at f32
// always, at bf16 past head width 128 or where the whole-row pair's block
// would not fit.
bool use_chunked(int n, int dh, int elem, long long optin) {
  return elem == 4 || dh > 128 || (long long)mma_smem_bytes(n, dh) > optin;
}

cudaError_t launch_chunked(const void* t, const float* const (&f)[4], const void* qw,
                           const void* pw, void* scratch, void* out, int B, int N, int C, int H,
                           int dh, float eps, int dtype, float scale, cudaStream_t s) {
  const int64_t M = (int64_t)B * N;
  const int K = H * dh;
  if (dtype == 0) {
    const float* tt = static_cast<const float*>(t);
    float* qkv = static_cast<float*>(scratch);
    float* o = qkv + M * 3 * K;
    cudaError_t err = launch_tf32<true>(tt, nullptr, f[0], f[1], static_cast<const float*>(qw),
                                        f[2], qkv, M, C, 3 * K, eps, s);
    if (err != cudaSuccess) return err;
    err = (cudaError_t)devit_fused_attention(qkv, o, B, N, H, dh, dtype, scale, s);
    if (err != cudaSuccess) return err;
    return launch_tf32<false>(o, tt, nullptr, nullptr, static_cast<const float*>(pw), f[3],
                              static_cast<float*>(out), M, K, C, eps, s);
  }
  const bf16* tt = static_cast<const bf16*>(t);
  bf16* qkv = static_cast<bf16*>(scratch);
  bf16* o = qkv + M * 3 * K;
  cudaError_t err = launch_ln_qkv(tt, f[0], f[1], static_cast<const bf16*>(qw), f[2], qkv, M, C,
                                  3 * K, eps, s);
  if (err != cudaSuccess) return err;
  err = (cudaError_t)devit_fused_attention(qkv, o, B, N, H, dh, dtype, scale, s);
  if (err != cudaSuccess) return err;
  const bf16* pwt = static_cast<const bf16*>(pw);
  bf16* outt = static_cast<bf16*>(out);
  if (K % kPK != 0) return launch_proj<true>(tt, o, pwt, f[3], outt, M, C, K, s);
  return launch_proj<false>(tt, o, pwt, f[3], outt, M, C, K, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at sequence length n on `device`
// (the whole-row route: the larger of its two kernels' needs; the chunked
// route: the largest of its launches').
long long devit_block_attention_smem_bytes(int n, int head_dim, int elem_bytes, int device) {
  if (use_chunked(n, head_dim, elem_bytes, devit::device_optin(device))) {
    const long long attn = devit_attention_smem_bytes(n, head_dim, elem_bytes, device);
    const long long gemm = (long long)(elem_bytes == 4 ? tf32_smem_bytes() : ln_qkv_smem_bytes());
    return attn > gemm ? attn : gemm;
  }
  return (long long)mma_smem_bytes(n, head_dim);
}

// 1 when the block half takes the chunked route at (n, head_dim,
// elem_bytes) on `device` (at f32 always), and so needs the (B N, 4 H
// head_dim) scratch.
int devit_block_attention_chunked(int n, int head_dim, int elem_bytes, int device) {
  return use_chunked(n, head_dim, elem_bytes, devit::device_optin(device)) ? 1 : 0;
}

// t, out: (B, N, C) contiguous of the dtype; qkv_kernel (C, 3 H head_dim)
// and proj_kernel (H head_dim, C) contiguous of the dtype; norm scale/bias,
// proj bias (C,) and qkv bias (3 H head_dim,) or NULL, f32. Scratch: on the
// chunked route (devit_block_attention_chunked; f32 always), (B, N, 4 H
// head_dim) of the dtype; on the bf16 whole-row route (B, N, H head_dim)
// bf16 for o. `acc` is unused (NULL). C must be a multiple of 32, and every
// operand 16-byte aligned; head_dim 32, 64, 128 or any multiple of 64 past
// 128. dtype: 0 = float32, 1 = bfloat16. scale: as devit_fused_attention's.
// Returns a cudaError_t (0 = launched).
int devit_block_attention(const void* t, const void* ns, const void* nb, const void* qw,
                          const void* qb, const void* pw, const void* pb, void* scratch,
                          void* acc, void* out, int B, int N, int C, int H, int head_dim,
                          float eps, int dtype, float scale, void* stream) {
  (void)acc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 32 != 0 || B <= 0 || N <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const float* const f[4] = {static_cast<const float*>(ns), static_cast<const float*>(nb),
                             static_cast<const float*>(qb), static_cast<const float*>(pb)};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (use_chunked(N, head_dim, dtype == 1 ? 2 : 4, devit::device_optin(dev)))
    return (int)launch_chunked(t, f, qw, pw, scratch, out, B, N, C, H, head_dim, eps, dtype, scale,
                               s);
  if (head_dim == 32)
    return (int)launch_bf16<32>(t, f[0], f[1], qw, f[2], pw, f[3], scratch, out, B, N, C, H, eps,
                                scale, s);
  if (head_dim == 64)
    return (int)launch_bf16<64>(t, f[0], f[1], qw, f[2], pw, f[3], scratch, out, B, N, C, H, eps,
                                scale, s);
  if (head_dim == 128)
    return (int)launch_bf16<128>(t, f[0], f[1], qw, f[2], pw, f[3], scratch, out, B, N, C, H, eps,
                                 scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
