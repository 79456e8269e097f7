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
// (B = 256, 6 heads: 272.5 MB, ~0.081 ms at 3.35 TB/s).
//
// Both dtypes: dk and dv sum over all N queries of one (batch row, head), so
// one block owns a whole (batch row, head), N <= 256, and walks its queries in
// 32-row tiles: no two blocks write the same output, nothing is summed with
// atomics, and the result is the same on every run. K and V of the head stay
// in shared memory for the whole block; the tile's f32 s and dp (32 x N
// each) sit beside them.
//
// bf16 (attn_bwd_kernel_mma): all five products on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulators; the building blocks
// are in mma_common.cuh). K, V and the tiles' q and g rows are staged with
// 16-byte cp.async into XOR-swizzled tiles, the next tile's q and g arriving
// while the current one computes. For each query tile: s = Q K^T and
// dp = G V^T by mma, 16 x 16 blocks dealt to the 16 warps; the f32 softmax
// and ds rows (softmax_ds_rows: softmax_row's and ds_row's arithmetic, each
// lane holding its columns of two rows in registers); round(p) and ds stored
// as bf16 tiles (rows padded by 16 bytes, so ldmatrix has no bank
// conflicts; zero past N); the tile's dq = ds K by mma (K through
// ldmatrix.trans), written once; and dv += round(p)^T G, dk += ds^T Q by mma
// with A through ldmatrix.trans of the bf16 tiles. Warp w owns key rows
// 16w .. 16w + 15 and keeps both sums in its accumulators (32 f32 registers
// a lane each) for the whole block, so one pass over the query tiles
// suffices and s is computed once. What bounds it: one 512-thread block an
// SM (dk and dv of 16 warps fill the register file), so the three block
// barriers a tile leave the SM waiting on the slowest warp. At B 256, kh 6
// on the H100 (0.57 ms a launch), builds that skip one step each ran faster
// by 0.17 ms without the softmax/ds rows, 0.17 without s and dp, 0.09
// without dq and 0.09 without dk/dv; the staging and barriers alone took
// 0.18 ms.
//
// f32 (attn_bwd_kernel): the PR-1 design on the CUDA cores, kept because the
// f32 tolerance is 1e-4 and a TF32 mma keeps ~10 mantissa bits of each
// operand, too few. Thread (warp w, lane l) holds dk or dv of key rows
// c = w + 16 i, dims l and l + 32; holding both would double those
// registers, so the block makes two passes over the query tiles: pass 1
// recomputes p and sums dv; pass 2 recomputes p, forms dp and ds, writes each
// tile's dq and sums dk. Its steps live in bwd_common.cuh, shared with the
// split kernels (attention_bwd_split.cu), which run the two passes as two
// kernels, so at f32 the split pair equals this kernel bit for bit; at bf16
// it agrees within the bf16 tolerance (other summation order). The passes
// stay one loop here: written as two inlined functions they ran 5% slower on
// the H100 (4.55 against 4.31 ms at B 256, bf16, before the tensor-core path).

#include "bwd_common.cuh"
#include "mma_common.cuh"

namespace {

using namespace devit::bwd;

constexpr int kMaxCPerWarp = 16;  // key rows of dk/dv a warp holds: N <= 256
constexpr int kMaxN = kWarps * kMaxCPerWarp;

// bf16: s, dp f32 [kBQ][NP + 8] | K, V [NP][dh] | two q, g buffers
// [2][2][kBQ][dh] | round(p), ds bf16 [kBQ][NP + 8], NP = n rounded up to 16.
size_t mma_smem_bytes(int n, int dh) {
  const size_t np = (size_t)((n + 15) & ~15);
  return sizeof(float) * 2 * (size_t)kBQ * (np + 8) +
         2 * (2 * np * dh + 4 * (size_t)kBQ * dh + 2 * (size_t)kBQ * (np + 8));
}

// Shared memory of one block at sequence length n, or -1 past kMaxN (the
// registers that hold dk and dv bound N, not the shared memory).
long long smem_bytes(int n, int dh, int elem) {
  if (n > kMaxN) return -1;
  return (long long)(elem == 2 ? mma_smem_bytes(n, dh) : dqdk_smem_bytes<float>(n, dh));
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

// ---- bf16 on the tensor cores

using devit::mma::bf16;
using devit::mma::div_rn;
using devit::mma::ldmatrix_x2_trans;
using devit::mma::ldmatrix_x4;
using devit::mma::ldmatrix_x4_trans;
using devit::mma::mma_bf16;
using devit::mma::pack_bf16;
using devit::mma::swz;

static_assert(kBQ == 32 && kWarps == 16, "the tile steps below deal 32-row tiles to 16 warps");
constexpr int kCols = kMaxN / 32;  // columns a lane holds of one row

// Writes the lane's two rows of an m16n8 accumulator (rows r0 + lane/4 and
// + 8, dims d0 + 2(lane % 4) and + 1), rounded, to rows out + row * stride
// that lie before `rows`.
__device__ __forceinline__ void store_rows(const float (&acc)[4], bf16* out, int64_t stride,
                                           int r0, int rows, int d0, int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + (lane >> 2) + 8 * half;
    if (r < rows)
      *reinterpret_cast<uint32_t*>(out + (int64_t)r * stride + d0 + 2 * (lane & 3)) =
          pack_bf16(acc[2 * half], acc[2 * half + 1]);
  }
}

// Tile rows r0 .. r0 + R - 1: s (in P) and dp (in D) -> round(p) into Pb and
// ds into Sb, bf16, zero past N and in rows past the sequence, with the
// arithmetic of softmax_row and ds_row (bwd_common.cuh): row max, expf,
// sum, the IEEE quotient (div_rn), the fmaf rowsum over the unrounded p,
// ds = round((p (dp - rs)) scale). Lane l holds the column pairs 2l + 64k in
// registers (float2 loads, bf16x2 stores); R rows go through at once for
// independent chains.
template <int R>
__device__ __forceinline__ void softmax_ds_rows(const float* P, const float* D, bf16* Pb,
                                                bf16* Sb, int r0, int rows, int N, int NP,
                                                int SP, int PB, float scale, int lane) {
  constexpr int kPairs = kCols / 2;
  float x[R][kPairs][2], y[R][kPairs][2], m[R], sum[R], rs[R], rsum[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = -INFINITY;
    sum[i] = rs[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int c = 2 * lane + 64 * k;
      const float2 sv = c < NP ? *reinterpret_cast<const float2*>(P + (r0 + i) * SP + c)
                               : make_float2(0.f, 0.f);
      const float2 dv = c < NP ? *reinterpret_cast<const float2*>(D + (r0 + i) * SP + c)
                               : make_float2(0.f, 0.f);
      x[i][k][0] = c < N ? sv.x : -INFINITY;
      x[i][k][1] = c + 1 < N ? sv.y : -INFINITY;
      y[i][k][0] = dv.x;
      y[i][k][1] = dv.y;
      m[i] = fmaxf(m[i], fmaxf(x[i][k][0], x[i][k][1]));
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) m[i] = devit::warp_max(m[i]);
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[i][k][j] = expf(x[i][k][j] - m[i]);  // 0 past N
        sum[i] += x[i][k][j];
      }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    sum[i] = devit::warp_sum(sum[i]);
    rsum[i] = __frcp_rn(sum[i]);
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int k = 0; k < kPairs; ++k)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[i][k][j] = div_rn(x[i][k][j], sum[i], rsum[i]);  // the unrounded f32 p
        rs[i] = fmaf(y[i][k][j], x[i][k][j], rs[i]);
      }
#pragma unroll
  for (int i = 0; i < R; ++i) rs[i] = devit::warp_sum(rs[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float keep = r0 + i < rows ? 1.f : 0.f;  // rows past the sequence: zero
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int c = 2 * lane + 64 * k;
      if (c >= NP) continue;
      const float p0 = keep * x[i][k][0], p1 = keep * x[i][k][1];
      *reinterpret_cast<uint32_t*>(Pb + (r0 + i) * PB + c) = pack_bf16(p0, p1);
      *reinterpret_cast<uint32_t*>(Sb + (r0 + i) * PB + c) =
          pack_bf16((p0 * (y[i][k][0] - rs[i])) * scale, (p1 * (y[i][k][1] - rs[i])) * scale);
    }
  }
}

// One block: (batch row, head), 16 warps, 32-query tiles, the next tile's q
// and g rows arriving (cp.async) while the current tile computes. Warp w
// keeps dk and dv of key rows 16w .. 16w + 15 in its accumulators.
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_kernel_mma(const bf16* __restrict__ qkv, const bf16* __restrict__ g,
                    bf16* __restrict__ dqkv, int N, int H, float scale) {
  constexpr int DH = 64;
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = (N + 15) & ~15;
  const int SP = NP + 8;  // f32 row: 8 mod 16 words, so float2 stores of 4 rows miss no bank
  const int PB = NP + 8;  // bf16 row: an odd number of 16-byte chunks
  float* P = reinterpret_cast<float*>(smem);  // s of the tile (f32)
  float* D = P + kBQ * SP;                    // dp of the tile (f32)
  bf16* Ks = reinterpret_cast<bf16*>(D + kBQ * SP);
  bf16* Vs = Ks + NP * DH;
  bf16* QG = Vs + NP * DH;     // two buffers of the tile's q and g rows, zero past N
  bf16* Pb = QG + 4 * kBQ * DH;  // round(p) [kBQ][PB]
  bf16* Sb = Pb + kBQ * PB;      // ds [kBQ][PB]

  const int C = H * DH;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int64_t row3 = 3LL * C;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  const bf16* gbase = g + (int64_t)b * N * C + h * DH;
  bf16* obase = dqkv + (int64_t)b * N * row3 + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kr = 16 * warp;  // the warp's key rows of dk and dv

  auto load_tile = [&](int q0, bf16* dst) {
    const int rows = min(kBQ, N - q0);
    devit::mma::load_rows(dst, base + (int64_t)q0 * row3, row3, kBQ, rows, tid, kThreads);
    devit::mma::load_rows(dst + kBQ * DH, gbase + (int64_t)q0 * C, C, kBQ, rows, tid, kThreads);
  };
  devit::mma::load_rows(Ks, base + C, row3, NP, N, tid, kThreads);
  devit::mma::load_rows(Vs, base + 2 * C, row3, NP, N, tid, kThreads);
  load_tile(0, QG);

  float dk[8][4], dv[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[t][e] = dv[t][e] = 0.f;

  const int nb = NP / 16;  // 16-key blocks
  for (int q0 = 0, it = 0; q0 < N; q0 += kBQ, ++it) {
    const int rows = min(kBQ, N - q0);
    bf16* Qs = QG + (it & 1) * 2 * kBQ * DH;
    bf16* Gs = Qs + kBQ * DH;
    devit::mma::cp_async_wait_all();
    __syncthreads();  // this tile's q, g landed; the previous tile's readers are done
    if (q0 + kBQ < N) load_tile(q0 + kBQ, QG + ((it + 1) & 1) * 2 * kBQ * DH);

    // s = q k^T * scale into P, dp = g v^T into D: 16 x 16 blocks (which,
    // query half mi, key block nj) dealt to the warps
    for (int job = warp; job < 4 * nb; job += kWarps) {
      const int which = job / (2 * nb), mi = (job / nb) & 1, nj = job % nb;
      const bf16* A = which ? Gs : Qs;
      const bf16* Bm = which ? Vs : Ks;
      float* out = which ? D : P;
      const float sc = which ? 1.f : scale;
      float acc[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t a[4], kb[4];
        ldmatrix_x4(a, A + swz(16 * mi + (lane & 15), 2 * ks + (lane >> 4)));
        ldmatrix_x4(kb, Bm + swz(16 * nj + (lane & 7) + ((lane >> 4) << 3),
                                 2 * ks + ((lane >> 3) & 1)));
        mma_bf16(acc[0], a, kb[0], kb[1]);
        mma_bf16(acc[1], a, kb[2], kb[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = 16 * mi + (lane >> 2) + 8 * half;
          const int c = 16 * nj + 8 * t + 2 * (lane & 3);
          *reinterpret_cast<float2*>(out + r * SP + c) =
              make_float2(acc[t][2 * half] * sc, acc[t][2 * half + 1] * sc);
        }
    }
    __syncthreads();

    // the f32 softmax and ds rows (warp w: rows 2w, 2w + 1) into bf16 tiles
    softmax_ds_rows<2>(P, D, Pb, Sb, 2 * warp, rows, N, NP, SP, PB, scale, lane);
    __syncthreads();

    // the tile's dq = ds k: warp w owns rows 16 (w / 8) .., dims 8 (w % 8) ..;
    // two accumulators (even and odd key steps) for independent mma chains
    {
      const int mi = warp >> 3, nt = warp & 7;
      float acc[2][4] = {};
      const bf16* arow = Sb + (16 * mi + (lane & 15)) * PB + ((lane >> 4) << 3);
      const int krow = (lane & 7) + (((lane >> 3) & 1) << 3);
      for (int k0 = 0; k0 < NP; k0 += 32) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (j == 1 && k0 + 16 >= NP) break;
          uint32_t a[4], kb[2];
          ldmatrix_x4(a, arow + k0 + 16 * j);
          ldmatrix_x2_trans(kb, Ks + swz(k0 + 16 * j + krow, nt));
          mma_bf16(acc[j], a, kb[0], kb[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][e] += acc[1][e];
      store_rows(acc[0], obase + (int64_t)q0 * row3, row3, 16 * mi, rows, 8 * nt, lane);
    }

    // dv += round(p)^T g and dk += ds^T q for the warp's 16 keys: A through
    // ldmatrix.trans of the bf16 tiles, B (g, q) through ldmatrix.trans
    if (kr < NP) {
#pragma unroll
      for (int ks = 0; ks < kBQ / 16; ++ks) {
        uint32_t ap[4], as[4];
        const int qrow = 16 * ks + (lane & 7) + ((lane >> 4) << 3);
        const int kcol = kr + (((lane >> 3) & 1) << 3);
        ldmatrix_x4_trans(ap, Pb + qrow * PB + kcol);
        ldmatrix_x4_trans(as, Sb + qrow * PB + kcol);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          uint32_t gb[4], qb[4];
          const int off = swz(16 * ks + (lane & 7) + (((lane >> 3) & 1) << 3),
                              2 * d + (lane >> 4));
          ldmatrix_x4_trans(gb, Gs + off);
          ldmatrix_x4_trans(qb, Qs + off);
          mma_bf16(dv[2 * d], ap, gb[0], gb[1]);
          mma_bf16(dv[2 * d + 1], ap, gb[2], gb[3]);
          mma_bf16(dk[2 * d], as, qb[0], qb[1]);
          mma_bf16(dk[2 * d + 1], as, qb[2], qb[3]);
        }
      }
    }
  }

  // dk and dv of the warp's keys, rounded once
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    store_rows(dk[t], obase + C + kr * row3, row3, 0, N - kr, 8 * t, lane);
    store_rows(dv[t], obase + 2 * C + kr * row3, row3, 0, N - kr, 8 * t, lane);
  }
}

cudaError_t launch_bf16(const void* qkv, const void* g, void* dqkv, int B, int N, int H,
                        cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_bwd_kernel_mma, opted_in);
  if (err != cudaSuccess) return err;
  if (N > kMaxN) return cudaErrorInvalidValue;
  attn_bwd_kernel_mma<<<(unsigned)B * H, kThreads, mma_smem_bytes(N, 64), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(g), static_cast<bf16*>(dqkv), N,
      H, 1.0f / sqrtf(64.f));
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
  if (dtype == 1) return (int)launch_bf16(qkv, g, dqkv, B, N, H, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
