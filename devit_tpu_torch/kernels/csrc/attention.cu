// Fused multi-head self-attention over the raw fused-qkv activations.
//
// Replaces devit_tpu/kernels/attention.py:_attn_kernel (the Pallas TPU kernel
// behind fused_attention). Same contract: the input is the (B, N, 3C) output
// of the qkv matmul, ordered [q | k | v] and head-major inside each third;
// the output is the proj-ready (B, N, C) layout. No (3, B, H, N, dh)
// transpose is ever written to device memory.
//
// Numerics follow the TPU kernel exactly: logits q.k^T in f32, scaled by
// dh^-0.5; a two-pass softmax in f32 (row max, exp, sum, divide); the
// probabilities are rounded to v's dtype before p.v, which accumulates in
// f32; the result is rounded to the input dtype. Keys at or past N are never
// read, which is the same as masking them to -inf before the max. Query rows
// at or past N are never written.
//
// What bounds it on an H100: at the serving shapes (N = 198, dh = 64, bf16)
// one launch reads each qkv byte once and writes each output byte once, about
// 4 * B * N * C * 2 bytes, against 4 * B * N^2 * C FLOPs (two products):
// N/2 = 99 FLOP per byte, under the ~295 FLOP/byte at which the tensor cores, not
// HBM, would be the limit. So the bound is memory bandwidth (B = 256, 6 heads:
// ~156 MB, ~47 us at 3.35 TB/s).
//
// bf16 (attn_kernel_mma): both products on the tensor cores, as
// mma.sync.m16n8k16 with bf16 operands and f32 accumulators, which is what
// the TPU's MXU computes here (exact bf16 products summed in f32). A block
// owns (batch row, head, a run of 64-query tiles) and has 4 warps, each
// owning 16 query rows of a tile, so no two blocks write the same output. It
// stages the head's K and V once, and its q tiles, with 16-byte cp.async into
// XOR-swizzled shared memory (rows zero-filled to a multiple of 16), so
// ldmatrix reads them without bank conflicts; the next tile's q arrives
// while the current one computes. The launcher gives a block all of a
// head's tiles when the heads alone make four blocks an SM (0.177 against
// 0.199 ms for one tile a block at B 256, kh 6, on the H100), and shorter
// runs at small batches. S = Q K^T takes A from ldmatrix of Q (held in
// registers) and B from ldmatrix of K's rows; the 16 x N f32 score rows stay
// in registers (at most 128 a lane, N <= 256) and the row max and sum reduce
// over the 4 lanes of a quad. p = e / sum is the IEEE quotient from one
// reciprocal a row and an FMA correction (div_rn), a third of the
// instructions of `/`, which took 38% of the kernel's time. O = P V takes V
// through ldmatrix.trans, and p never leaves registers: the rounded, packed
// accumulators of two adjacent key tiles are the A fragment of the next mma.
// o goes out through shared memory as 16-byte stores. Past N = 256 the
// score row does not fit a lane's registers: attn_long_mma below. What bounds
// it: the f32 softmax (expf, the divisions) on 8 warps an SM (the score
// registers allow two blocks), and the padding of N = 198 to 208 keys and
// 256 query rows. The steps on a
// warp's rows (attend_rows and its chunk_* steps) live in attn_mma.cuh,
// which block_attention.cu's bf16 kernel shares.
//
// Head widths: every kernel is instantiated for dh 32, 64 and 128 (the
// wrapper pads any other width up to 128 to one of them). At bf16 the
// swizzled tiles hold rows of dh bf16 (swz_dh in mma_common.cuh), at f32
// padded rows of dh f32; a warp's q fragments, o accumulators and the key and
// value steps scale with dh.
//
// f32 (attn_long_tf32, steps in long_tf32.cuh), every N at dh <= 128: both
// products on the tensor cores as 3xTF32 mma.sync.m16n8k8. One TF32 pass
// keeps 11 significant bits of each operand, too few for the f32 tolerance
// of 1e-4; each operand is split into big = x rounded to TF32 and small = x -
// big rounded to TF32, and a b = small big + big small + big big, which drops
// only small small (~2^-22 of the product): f32 accuracy (the numpy
// emulation in tests/test_torch_tf32x3.py comes within ~1e-6 of the f32
// reference where one pass is ~1e-3 off; on the H100 the kernel within a few
// 1e-6, SDPA's class, once each k8 step of p . v is added to o in f32:
// long_tf32.cuh chunk_times_cols). A block owns (batch row, head, 128
// query rows), 4 warps of two m16 tiles; K and V chunks come through
// attn_long_mma's ring in one walk with an online max and sum, o rescaled as
// the max grows and divided by the sum once at the end (p is not rounded at
// f32, so this is the same function as normalising p first). What bounds it
// on the H100: not the tensor cores (0.199 ms at 165 TFLOP/s, three TF32
// passes at 495, at B 64, N 578, kh 6) but the instructions a warp issues:
// the splits (five an element, each B element split once for both m16 tiles),
// the fragment loads and their addresses, the softmax (~12 instructions an
// HMMA in the first design, whose two walks took 1.36 ms there; this one
// 0.71, 0.77 with o's f32 adds). It replaced the CUDA-core whole-row kernel
// (attn_kernel) at N <= 256 too: at N 198 it ran 3-4x faster at every head
// width.
//
// Past those sizes (kernel_path):
// - bf16, N > 256 (attn_long_mma, steps in long_mma.cuh): one block a
//   (batch row, head, 64-query tile), 4 warps of 16 rows, the q fragments in
//   registers. The keys come in chunks of 64 (32 at dh 128) through a ring
//   of two cp.async buffers, one block barrier a chunk, the next chunk's
//   copy running while this one computes. Two walks: K alone for the row's
//   max and sum, kept online per lane (rescaled as the max grows) and
//   reduced over the quad at the end; then K and V for o += round(exp(s -
//   m) / l) . v, p normalised by the final sum before it is rounded, as the
//   TPU kernel does. The online (m, l) sum in another order than
//   attn_kernel_mma's, so this path's bits differ from the whole-row
//   kernel's (within the bf16 tolerance); it runs only past 256 keys. What
//   bounds it: not the bytes (0.034 ms at B 64, N 578, kh 6) but the
//   per-score f32 work, two expf and a division a score: at kh 12, dh 32
//   (twice the scores, the same products) it takes 1.6x the dh-64 time. 128
//   registers a thread give four blocks (16 warps) an SM; eight-warp blocks
//   sharing a chunk ran slower on the H100 (0.4245 against 0.4181 ms), and
//   a whole-chunk path without the key mask took 0.42 to 0.39 ms. exp2 on
//   prescaled scores ran at 0.332 ms but is not kept: it rounds the
//   exponent otherwise than the TPU kernel's exp.
// - both dtypes past head width 128 (attn_wide_mma, steps in wide.cuh): the
//   wrapper pads the head to W, a multiple of 64. One block a (batch row,
//   head, 64-query tile), 4 warps of 16 rows, on the tensor cores: s = q k^T
//   walks the head in pieces (64 dims at bf16, 32 at f32) through the same
//   ring of two cp.async buffers, the q tile's piece staged beside the key
//   chunk's, so shared memory does not grow with W; o is made 256 dims (a
//   slab) at a time, the block's slabs one after the other, each recomputing
//   s (one slab up to dh 256). The numerics are attn_long_mma's at bf16 (a
//   statistics walk, then p normalised and rounded before p . v) and
//   attn_long_tf32's at f32 (one online walk a slab, 3xTF32, each k8 step of
//   p . v added apart). It
//   replaced the key-chunked CUDA-core kernel (attn_chunked_kernel), which
//   took 22.09 ms (bf16) and 20.18 ms (f32) at B 64, N 578, kh 4, dh 192.

#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "attn_mma.cuh"
#include "common.cuh"
#include "long_mma.cuh"
#include "long_tf32.cuh"
#include "mma_common.cuh"
#include "wide.cuh"

namespace {

constexpr int kBQ = 64;           // query rows per block
constexpr int kMmaThreads = 128;  // bf16: 4 warps, 16 query rows each

// The whole-row bf16 block: Q [2][kBQ][dh] | K [NP][dh] | V [NP][dh], NP = N
// rounded up to 16
size_t smem_bytes(int n, int head_dim) {
  return (size_t)2 * head_dim * (2 * kBQ + 2 * (size_t)((n + 15) & ~15));
}

// ---- bf16 on the tensor cores

using devit::mma::attend_rows;
using devit::mma::bf16;
using devit::mma::ldmatrix_x4;
using devit::mma::pack_bf16;
using devit::mma::swz_dh;

// One block: (batch row, head, a run of tpb 64-query tiles); 4 warps of 16
// query rows. K and V of the head are staged once a block; the next tile's q
// rows arrive (cp.async) while the current tile computes. KC key steps of 16 are
// held in registers at once: N <= 16 * KC takes one chunk, a larger N
// (KC = 16) walks 256-key chunks three times. DH: the head width.
template <int KC, int DH>
__global__ void __launch_bounds__(kMmaThreads, 2)
attn_kernel_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H,
                int n_tiles, int tpb, float scale) {
  constexpr int kShift = devit::mma::chunk_shift<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int NP = (N + 15) & ~15;
  bf16* Qbuf = reinterpret_cast<bf16*>(smem);  // two [kBQ][dh] q tiles
  bf16* Ks = Qbuf + 2 * kBQ * DH;
  bf16* Vs = Ks + NP * DH;

  const int C = H * DH;
  const int n_runs = (n_tiles + tpb - 1) / tpb;
  const int t0 = (blockIdx.x % n_runs) * tpb;
  const int t1 = min(n_tiles, t0 + tpb);
  const int b = blockIdx.x / n_runs;
  const int h = blockIdx.y;
  const int64_t row3 = 3LL * C;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  bf16* obase = out + (int64_t)b * N * C + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = 16 * warp;  // the warp's first row in a tile

  devit::mma::load_rows<DH>(Ks, base + C, row3, NP, N, tid, kMmaThreads);
  devit::mma::load_rows<DH>(Vs, base + 2 * C, row3, NP, N, tid, kMmaThreads);
  devit::mma::load_rows<DH>(Qbuf, base + (int64_t)t0 * kBQ * row3, row3, kBQ, N - t0 * kBQ, tid,
                            kMmaThreads);
  for (int tile = t0; tile < t1; ++tile) {
    bf16* Qs = Qbuf + ((tile - t0) & 1) * kBQ * DH;
    devit::mma::cp_async_wait_all();
    __syncthreads();  // this tile's q (and K, V) landed; the other buffer is free
    if (tile + 1 < t1)
      devit::mma::load_rows<DH>(Qbuf + ((tile + 1 - t0) & 1) * kBQ * DH,
                            base + (int64_t)(tile + 1) * kBQ * row3, row3, kBQ,
                            N - (tile + 1) * kBQ, tid, kMmaThreads);
    const int q0 = tile * kBQ;
    if (q0 + r0 >= N) continue;  // all 16 rows past the sequence

    uint32_t qa[DH / 16][4];  // A fragments of the warp's 16 q rows, one per 16 dims
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks)
      ldmatrix_x4(qa[ks], Qs + swz_dh<DH>(r0 + (lane & 15), 2 * ks + (lane >> 4)));
    float o[DH / 8][4];
    attend_rows<KC, DH>(o, qa, Ks, Vs, N, scale, lane);

    // o rounded once into the warp's own 16 rows of Qs, then 16-byte stores
    __syncwarp();
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = r0 + (lane >> 2) + 8 * half;
        *reinterpret_cast<uint32_t*>(Qs + swz_dh<DH>(r, t) + 2 * (lane & 3)) =
            pack_bf16(o[t][2 * half], o[t][2 * half + 1]);
      }
    __syncwarp();
    for (int i = lane; i < 16 * (DH / 8); i += 32) {
      const int r = i >> kShift, c = i & (DH / 8 - 1);
      const int n = q0 + r0 + r;
      if (n < N)
        *reinterpret_cast<uint4*>(obase + (int64_t)n * C + 8 * c) =
            *reinterpret_cast<const uint4*>(Qs + swz_dh<DH>(r0 + r, c));
    }
  }
}

// The 64-query tiles a bf16 forward block walks (tpb) and its grid: a block
// walks all of a head's query tiles (K and V staged once) when the heads
// alone give four blocks an SM; otherwise the tiles are split into runs
// until they do (at most one tile a block).
cudaError_t tile_runs(int B, int N, int H, int* tpb, dim3* grid) {
  static std::atomic<int> sms[devit::kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (sms[dev].load(std::memory_order_relaxed) == 0) {
    int v = 0;
    err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    sms[dev].store(v, std::memory_order_relaxed);
  }
  const int n_tiles = (N + kBQ - 1) / kBQ;
  const long long heads = (long long)B * H, want = 4LL * sms[dev].load();
  const int runs = (int)std::min<long long>(n_tiles, (want + heads - 1) / heads);
  *tpb = (n_tiles + runs - 1) / runs;
  *grid = dim3((unsigned)(B * ((n_tiles + *tpb - 1) / *tpb)), (unsigned)H);
  return cudaSuccess;
}

template <int KC, int DH>
cudaError_t launch_mma(const void* qkv, void* out, int B, int N, int H, float scale,
                       cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_kernel_mma<KC, DH>, opted_in);
  if (err != cudaSuccess) return err;
  int tpb = 0;
  dim3 grid;
  err = tile_runs(B, N, H, &tpb, &grid);
  if (err != cudaSuccess) return err;
  attn_kernel_mma<KC, DH><<<grid, kMmaThreads, smem_bytes(N, DH), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, (N + kBQ - 1) / kBQ, tpb,
      scale);
  return cudaGetLastError();
}

// ---- bf16 past 256 keys: K and V chunks through a ring of two buffers

constexpr int kLongN = 256;  // past this many keys the bf16 forward walks key chunks

namespace lm = devit::longmma;

// Q [16 W][dh] | two buffers of a K and a V chunk [2][2][chunk_keys][dh], bf16
template <int DH>
constexpr size_t long_smem_bytes() {
  return (size_t)2 * DH * (kBQ + 4 * lm::chunk_keys<DH>());
}

size_t long_fwd_smem_bytes(int head_dim) {
  return head_dim == 32 ? long_smem_bytes<32>()
         : head_dim == 64 ? long_smem_bytes<64>() : long_smem_bytes<128>();
}

// One block: (batch row, head, 64-query tile); 4 warps of 16 query rows. The
// keys come in chunks of CK through a ring of two cp.async buffers (the copy
// of the next chunk runs while this one computes; one block barrier a
// chunk): walk 1 over K alone for the online row max and sum, walk 2 over K
// and V for o += round(exp(s - m) / l) . v. The q fragments stay in registers
// for both walks; o leaves through the warp's own rows of the q tile.
template <int DH>
__global__ void __launch_bounds__(lm::kThreads, DH == 128 ? 3 : 4)
attn_long_mma(const bf16* __restrict__ qkv, bf16* __restrict__ out, int N, int H, int n_tiles,
              float scale) {
  constexpr int CK = lm::chunk_keys<DH>(), NT = CK / 8;
  constexpr int kShift = devit::mma::chunk_shift<DH>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // the tile's q rows, then its o rows
  bf16* ring = Qs + kBQ * DH;                // buffer i & 1: K chunk, then V chunk

  const int C = H * DH;
  const int tile = blockIdx.x % n_tiles, b = blockIdx.x / n_tiles, h = blockIdx.y;
  const int64_t row3 = 3LL * C;
  const bf16* base = qkv + (int64_t)b * N * row3 + h * DH;
  bf16* obase = out + (int64_t)b * N * C + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * kBQ, r0 = 16 * warp;
  const bool active = q0 + r0 < N;  // some of the warp's 16 rows lie before N
  const int n_chunks = (N + CK - 1) / CK;

  devit::mma::load_rows<DH>(Qs, base + (int64_t)q0 * row3, row3, kBQ, N - q0, tid,
                            lm::kThreads);
  uint32_t qa[DH / 16][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, unused[2], rl[2];
  float o[DH / 8][4];
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[t][e] = 0.f;
  // step i: chunk i % n_chunks, K (and V in walk 2) into buffer i & 1
  lm::ring_walk(
      2 * n_chunks, active,
      [&](int i) {
        lm::fetch_chunk<DH>(ring, i, n_chunks, base + C, C, row3, N, i >= n_chunks, tid);
      },
      [&](int i) {
        if (i == 0) lm::load_a<DH>(qa, Qs, r0, lane);
        const bf16* Kb = ring + (i & 1) * 2 * CK * DH;
        const int c0 = lm::chunk_key0<DH>(i, n_chunks);
        float s[NT][4];
        lm::times_rows<NT, DH>(s, qa, Kb, 0, N - c0, lane);
        lm::scale_mask<NT>(s, c0, N, scale, lane);
        if (i < n_chunks) {
          lm::stats_step<NT, false>(s, s, m, l, unused, rl, i == n_chunks - 1);
          return;
        }
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[t][e] = lm::prob(s[t][e], m[e >> 1], l[e >> 1], rl[e >> 1]);
        lm::chunk_times_cols<NT, DH>(o, s, Kb + CK * DH, c0, N, lane);
      });
  if (!active) return;

  // o rounded once into the warp's own 16 rows of Qs, then 16-byte stores
  __syncwarp();
#pragma unroll
  for (int t = 0; t < DH / 8; ++t)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + (lane >> 2) + 8 * half;
      *reinterpret_cast<uint32_t*>(Qs + swz_dh<DH>(r, t) + 2 * (lane & 3)) =
          pack_bf16(o[t][2 * half], o[t][2 * half + 1]);
    }
  __syncwarp();
  for (int i = lane; i < 16 * (DH / 8); i += 32) {
    const int r = i >> kShift, c = i & (DH / 8 - 1);
    const int n = q0 + r0 + r;
    if (n < N)
      *reinterpret_cast<uint4*>(obase + (int64_t)n * C + 8 * c) =
          *reinterpret_cast<const uint4*>(Qs + swz_dh<DH>(r0 + r, c));
  }
}

template <int DH>
cudaError_t launch_long_mma(const void* qkv, void* out, int B, int N, int H, float scale,
                            cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_long_mma<DH>, opted_in);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + kBQ - 1) / kBQ;
  const dim3 grid((unsigned)(B * n_tiles), (unsigned)H);
  attn_long_mma<DH><<<grid, lm::kThreads, long_smem_bytes<DH>(), stream>>>(
      static_cast<const bf16*>(qkv), static_cast<bf16*>(out), N, H, n_tiles, scale);
  return cudaGetLastError();
}

// ---- f32 on the tensor cores (3xTF32): K and V chunks through the same ring

namespace lt = devit::longtf32;

// m16 tiles a warp: 128 query rows a block (one tile a warp ran 0.8634
// against 0.7142 ms at B 64, N 578, kh 6 on the H100)
constexpr int kFwdMT = 2;

// Q [64 kFwdMT][dh + 4] | two buffers of a K and a V chunk [2][2][chunk_keys][dh + 4], f32
template <int DH>
constexpr size_t tf32_smem_bytes() {
  return sizeof(float) * (size_t)(lt::tile_floats<DH>(64 * kFwdMT) +
                                  4 * lt::tile_floats<DH>(lt::chunk_keys<DH>()));
}

size_t tf32_fwd_smem_bytes(int head_dim) {
  return head_dim == 32 ? tf32_smem_bytes<32>()
         : head_dim == 64 ? tf32_smem_bytes<64>() : tf32_smem_bytes<128>();
}

// One block: (batch row, head, 64 kFwdMT query rows), 4 warps of kFwdMT m16
// tiles. K and V come in chunks through attn_long_mma's ring, in one walk:
// s = q k^T (3xTF32), the online row max and sum with o rescaled as the max
// grows (lt::softmax_step), o += exp(s - m) . v (3xTF32); o / l at the end.
// p is not rounded at f32, so normalising o once at the end is the same
// function as attn_long_mma's two walks, which normalise p before rounding
// it, with one product a chunk fewer. The q fragments are read from the
// staged tile and split once a k8 step of each chunk; o leaves as 8-byte
// stores.
template <int DH>
__global__ void __launch_bounds__(lm::kThreads, DH == 128 ? 2 : 3)
attn_long_tf32(const float* __restrict__ qkv, float* __restrict__ out, int N, int H,
               int n_tiles, float scale) {
  constexpr int MT = kFwdMT, TQ = 64 * MT;
  constexpr int CK = lt::chunk_keys<DH>(), NT = CK / 8, KT = lt::tile_floats<DH>(CK);
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // the tile's q rows
  float* ring = Qs + lt::tile_floats<DH>(TQ);  // buffer i & 1: K chunk, then V chunk

  const int C = H * DH;
  const int tile = blockIdx.x % n_tiles, b = blockIdx.x / n_tiles, h = blockIdx.y;
  const int64_t row3 = 3LL * C;
  const float* base = qkv + (int64_t)b * N * row3 + h * DH;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * TQ, r0 = 16 * MT * warp;
  const bool active = q0 + r0 < N;  // some of the warp's rows lie before N
  const int n_chunks = (N + CK - 1) / CK;

  lt::load_rows<DH>(Qs, base + (int64_t)q0 * row3, row3, TQ, N - q0, tid, lm::kThreads);
  float m[MT][2], l[MT][2], o[MT][DH / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int t = 0; t < DH / 8; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][t][e] = 0.f;
  }
  // step i: chunk i of K and V into buffer i & 1
  lm::ring_walk(
      n_chunks, active,
      [&](int i) { lt::fetch_chunk<DH>(ring, i, i * CK, base + C, C, row3, N, true, tid); },
      [&](int i) {
        const float* Kb = ring + (i & 1) * 2 * KT;
        const int c0 = i * CK;
        float s[MT][NT][4];
        lt::times_rows<MT, NT, DH>(s, Qs, r0, Kb, 0, N - c0, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          lm::scale_mask<NT>(s[mt], c0, N, scale, lane);
          lt::softmax_step<NT, DH>(s[mt], m[mt], l[mt], o[mt]);
        }
        lt::chunk_times_cols<MT, NT, DH>(o, s, Kb + KT, c0, N, lane);
      });
  if (!active) return;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float li = devit::mma::quad_sum(l[mt][i]), rl = __frcp_rn(li);
#pragma unroll
      for (int d = 0; d < DH / 8; ++d)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) o[mt][d][e] = devit::mma::div_rn(o[mt][d][e], li, rl);
    }
    lt::store_rows<DH>(o[mt], out + ((int64_t)b * N + q0) * C + h * DH, C, r0 + 16 * mt,
                       N - q0, lane);
  }
}

template <int DH>
cudaError_t launch_tf32(const void* qkv, void* out, int B, int N, int H, float scale,
                        cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  cudaError_t err = devit::opt_in_smem((const void*)attn_long_tf32<DH>, opted_in);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + 64 * kFwdMT - 1) / (64 * kFwdMT);
  const dim3 grid((unsigned)(B * n_tiles), (unsigned)H);
  attn_long_tf32<DH><<<grid, lm::kThreads, tf32_smem_bytes<DH>(), stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), N, H, n_tiles, scale);
  return cudaGetLastError();
}

// The fewest score registers that hold the row: N <= 64, 128, 208 (the
// deployed N = 198), 256; past 256, attn_long_mma.
template <int DH>
cudaError_t launch_bf16(const void* qkv, void* out, int B, int N, int H, float scale,
                        cudaStream_t s) {
  if (N > kLongN) return launch_long_mma<DH>(qkv, out, B, N, H, scale, s);
  if (N <= 64) return launch_mma<4, DH>(qkv, out, B, N, H, scale, s);
  if (N <= 128) return launch_mma<8, DH>(qkv, out, B, N, H, scale, s);
  if (N <= 208) return launch_mma<13, DH>(qkv, out, B, N, H, scale, s);
  return launch_mma<16, DH>(qkv, out, B, N, H, scale, s);
}

enum Path { kWholeRow = 0, kKeyChunkMma = 1, kWide = 2 };

template <int DH>
cudaError_t launch_dh(const void* qkv, void* out, int B, int N, int H, int dtype, float scale,
                      cudaStream_t s) {
  if (dtype == 0) return launch_tf32<DH>(qkv, out, B, N, H, scale, s);
  if (dtype == 1) return launch_bf16<DH>(qkv, out, B, N, H, scale, s);
  return cudaErrorInvalidValue;
}

// ---- past head width 128 (wide.cuh): head pieces and output slabs, both dtypes

namespace wd = devit::wide;

// Elements of a ring buffer: the q tile's piece | the K chunk's piece | the
// V chunk's slab.
template <typename T>
__host__ __device__ constexpr int wide_buffer() {
  using O = wd::Ops<T>;
  return O::template tile<O::kPiece>(wd::kRows) + O::template tile<O::kPiece>(O::kChunk) +
         O::template tile<wd::kFwdSlab>(O::kChunk);
}

template <typename T>
constexpr size_t wide_smem_bytes() {
  return 2 * sizeof(T) * (size_t)wide_buffer<T>();
}

// One block: (batch row, head, 64-query tile), 4 warps of 16 rows, every
// SW-dim slab of o in turn. Each step of the ring stages a piece of the q
// tile and of a K chunk (and, at the chunk's last piece, the chunk's V slab);
// s = q k^T gathers its pieces in the warps' accumulators. bf16 (as
// attn_long_mma): walk 0 takes the online row max and sum, then one walk a
// slab computes o += round(exp(s - m) / l) . v. f32 (as attn_long_tf32): one
// walk a slab with the online max and sum, o rescaled as the max grows and
// divided by the sum at the end. Each slab leaves as the warp's stores.
template <typename T, int SW>
__global__ void __launch_bounds__(wd::kThreads, 2)
attn_wide_mma(const T* __restrict__ qkv, T* __restrict__ out, int N, int H, int W, int n_tiles,
              float scale) {
  using O = wd::Ops<T>;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int CK = O::kChunk, NT = CK / 8, kStats = kF32 ? 0 : 1;
  constexpr int QE = O::template tile<O::kPiece>(wd::kRows);
  constexpr int KE = O::template tile<O::kPiece>(CK);
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);

  const int C = H * W;
  const int tile = blockIdx.x % n_tiles, b = blockIdx.x / n_tiles, h = blockIdx.y;
  const int64_t row3 = 3LL * C;
  const T* base = qkv + (int64_t)b * N * row3 + (int64_t)h * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = tile * wd::kRows, r0 = 16 * warp;
  const bool active = q0 + r0 < N;  // some of the warp's 16 rows lie before N
  const wd::Steps steps(N, W, CK, O::kPiece);
  const int n_slabs = (W + SW - 1) / SW;

  float s[NT][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2], unused[2];
  float o[SW / 8][4];
  lm::ring_walk(
      (kStats + n_slabs) * steps.per_walk, active,
      [&](int i) {
        int w, c0, d;
        steps.at(i, CK, w, c0, d);
        T* buf = ring + (i & 1) * wide_buffer<T>();
        O::template stage<O::kPiece>(buf, base + (int64_t)q0 * row3 + d * O::kPiece, row3,
                                     wd::kRows, N - q0, O::kPiece, tid);
        O::template stage<O::kPiece>(buf + QE, base + C + (int64_t)c0 * row3 + d * O::kPiece,
                                     row3, CK, N - c0, O::kPiece, tid);
        if (w >= kStats && d == steps.pieces - 1) {
          const int e0 = (w - kStats) * SW;
          O::template stage<SW>(buf + QE + KE, base + 2 * C + (int64_t)c0 * row3 + e0, row3, CK,
                                N - c0, W - e0, tid);
        }
        devit::mma::cp_async_commit();
      },
      [&](int i) {
        int w, c0, d;
        steps.at(i, CK, w, c0, d);
        const T* buf = ring + (i & 1) * wide_buffer<T>();
        if (d == 0) wd::zero(s);
        O::template piece_product<NT, false>(s, buf, r0, buf + QE, 0, N - c0, lane);
        if (d < steps.pieces - 1) return;
        lm::scale_mask<NT>(s, c0, N, scale, lane);
        const bool last = c0 + CK >= N;
        if (w < kStats) {
          lm::stats_step<NT, false>(s, s, m, l, unused, rl, last);
          return;
        }
        const int e0 = (w - kStats) * SW;
        if (c0 == 0) {  // a slab's first chunk (at f32 its walk's statistics start over)
          wd::zero(o);
          if (kF32) {
            m[0] = m[1] = -INFINITY;
            l[0] = l[1] = 0.f;
          }
        }
        if constexpr (kF32) {
          lt::softmax_step<NT, SW>(s, m, l, o);
        } else {
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              s[t][e] = lm::prob(s[t][e], m[e >> 1], l[e >> 1], rl[e >> 1]);
        }
        O::template slab_product<NT, SW>(o, s, buf + QE + KE, c0, N, W - e0, lane);
        if (!last) return;
        if constexpr (kF32) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float lr = devit::mma::quad_sum(l[r]), rr = __frcp_rn(lr);
#pragma unroll
            for (int t = 0; t < SW / 8; ++t)
#pragma unroll
              for (int e = 2 * r; e < 2 * r + 2; ++e) o[t][e] = devit::mma::div_rn(o[t][e], lr, rr);
          }
        }
        O::template store<SW>(o, out + ((int64_t)b * N + q0) * C + (int64_t)h * W + e0, C, r0,
                              N - q0, W - e0, lane);
      });
}

template <typename T>
cudaError_t launch_wide(const void* qkv, void* out, int B, int N, int H, int W, float scale,
                        cudaStream_t stream) {
  static std::atomic<bool> opted_in[devit::kMaxDevices];
  constexpr int SW = wd::kFwdSlab;
  cudaError_t err = devit::opt_in_smem((const void*)attn_wide_mma<T, SW>, opted_in);
  if (err != cudaSuccess) return err;
  const int n_tiles = (N + wd::kRows - 1) / wd::kRows;
  const dim3 grid((unsigned)(B * n_tiles), (unsigned)H);
  attn_wide_mma<T, SW><<<grid, wd::kThreads, wide_smem_bytes<T>(), stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), N, H, W, n_tiles, scale);
  return cudaGetLastError();
}

// ---- which design a launch takes

// bf16 and dh <= 128: attn_kernel_mma to 256 keys, attn_long_mma past
// them; f32 and dh <= 128: attn_long_tf32 at every N; at every dh > 128
// attn_wide_mma.
int kernel_path(int n, int head_dim, int elem) {
  if (head_dim > 128) return kWide;
  if (elem == 2) return n > kLongN ? kKeyChunkMma : kWholeRow;
  return kKeyChunkMma;
}

size_t path_smem_bytes(int n, int head_dim, int elem) {
  switch (kernel_path(n, head_dim, elem)) {
    case kWholeRow: return smem_bytes(n, head_dim);
    case kKeyChunkMma:
      return elem == 2 ? long_fwd_smem_bytes(head_dim) : tf32_fwd_smem_bytes(head_dim);
    default: return elem == 2 ? wide_smem_bytes<bf16>() : wide_smem_bytes<float>();
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at sequence length n on `device`
// (on the path devit_attention_path picks).
long long devit_attention_smem_bytes(int n, int head_dim, int elem_bytes, int device) {
  (void)device;  // every design's need is the same on every device
  return (long long)path_smem_bytes(n, head_dim, elem_bytes);
}

// The design a forward at (n, head_dim, elem_bytes) takes on `device`: 0 one
// block holds the head's keys (bf16 to 256 keys: attn_kernel_mma), 1 a
// tensor-core kernel over key chunks (bf16 past 256 keys: attn_long_mma;
// f32: attn_long_tf32), 2 the tensor-core kernel over key chunks, head
// pieces and output slabs past head width 128 (attn_wide_mma).
int devit_attention_path(int n, int head_dim, int elem_bytes, int device) {
  (void)device;
  return kernel_path(n, head_dim, elem_bytes);
}

// The most dynamic shared memory a block may opt in to on `device`, or -1.
long long devit_max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return -1;
  return v;
}

// qkv: (B, N, 3*H*head_dim) contiguous; out: (B, N, H*head_dim) contiguous.
// dtype: 0 = float32, 1 = bfloat16; head_dim 32, 64, 128 or any multiple
// of 64 past 128. scale multiplies the logits: head_dim^-0.5, or a narrower head's
// dh^-0.5 when the caller has zero-padded its heads to head_dim. Returns a
// cudaError_t (0 = launched).
int devit_fused_attention(const void* qkv, void* out, int B, int N, int H,
                          int head_dim, int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (kernel_path(N, head_dim, dtype == 1 ? 2 : 4) == kWide) {
    if (head_dim % 64) return (int)cudaErrorInvalidValue;
    return (int)(dtype == 0 ? launch_wide<float>(qkv, out, B, N, H, head_dim, scale, s)
                            : launch_wide<bf16>(qkv, out, B, N, H, head_dim, scale, s));
  }
  if (head_dim == 32) return (int)launch_dh<32>(qkv, out, B, N, H, dtype, scale, s);
  if (head_dim == 64) return (int)launch_dh<64>(qkv, out, B, N, H, dtype, scale, s);
  if (head_dim == 128) return (int)launch_dh<128>(qkv, out, B, N, H, dtype, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* devit_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
