// Tensor-core steps of the attention kernels past head width 128, at both
// dtypes: the forward attn_wide_mma (attention.cu) and the backward pair
// attn_bwd_wide_rows_mma / attn_bwd_wide_keys_mma (attention_bwd_long.cu).
//
// The wrapper pads a head wider than 128 to W, the next multiple of 64
// (kernels/attention.py kernel_head_dim; zero dims add exact zeros to every
// product). A lane cannot hold an output row of W dims in registers, nor a
// block a q tile and two chunks of W-wide K rows in shared memory at every W
// (dh 768 bf16 would take 288 KB with 64-key chunks), so both sides of the
// work are cut:
// - Head pieces. Every score product (s = q k^T and dp = g v^T, and k q^T,
//   v g^T in the keys kernel) walks the head kPiece dims at a time: step i of
//   ring_walk's two-buffer cp.async ring stages one piece of the 64-row tile
//   and of the chunk (both operands), and each warp adds that piece's product
//   into its score accumulators. After the chunk's last piece its scores are
//   whole. The q (or k) piece is staged again for every chunk: one design for
//   every W, at the price of reading it from L2 once a chunk.
// - Output slabs. Each output (o, dq, dk, dv) is made SW dims at a time: the
//   step of a chunk's last piece also stages the slab's columns of the rows
//   the output is a sum over (V, K, g or q), and the slab product adds them
//   into SW/8 n8 accumulator tiles (SW/2 f32 registers a lane: the forward's
//   256, FlashAttention-2's budget at dh 256; the backward's 64 or 128). A
//   block walks its slabs one after the other and recomputes the scores for
//   each; columns past W in the last slab are zero-filled and skipped.
// Shared memory and registers do not grow with N or W. The steps are written
// once for both dtypes (Ops<T>): at bf16 m16n8k16 mma.sync on 64-dim pieces
// in XOR-swizzled tiles (ldmatrix, ldmatrix.trans for the slab products); at
// f32 3xTF32 m16n8k8 on 32-dim pieces of padded rows, each piece's product
// and each k8 step of a slab product added to the accumulators by an f32 add
// (long_tf32.cuh's reasons), the accumulator operands split by acc_a.

#pragma once

#include <math.h>

#include "long_mma.cuh"
#include "long_tf32.cuh"
#include "mma_common.cuh"

namespace devit {
namespace wide {

using mma::bf16;

constexpr int kThreads = 128;  // 4 warps of 16 rows
constexpr int kRows = 64;      // query rows of a tile; keys of a keys-kernel block

// The output slabs, dims, at both dtypes: the forward's o (256: one slab up
// to dh 256, 128 accumulator registers a lane, 1.4x faster than 128 on the
// H100); the rows kernel's dq; the keys kernel's dk and dv, 64 in the
// monolithic backward (two sets of accumulators share a lane's registers;
// 128 there ran slower, at one block an SM) and 128 in either half of the
// split pair (faster there).
constexpr int kFwdSlab = 256, kRowsSlab = 128, kKeysSlab = 64, kHalfSlab = 128;

// Each dtype's head piece and chunk of keys (queries in the keys kernel),
// dims, its tile layout and its products.
template <typename T>
struct Ops;

// bf16: 64-dim pieces, 64-key chunks (64-query tiles in the keys kernel).
template <>
struct Ops<bf16> {
  static constexpr int kPiece = 64;
  static constexpr int kChunk = 64;

  // Elements of a staged [rows][COLS] tile.
  template <int COLS>
  __host__ __device__ static constexpr int tile(int rows) {
    return rows * COLS;
  }

  // Element offset of 16-byte chunk c of row r: swz_dh's XOR pattern, which
  // flips only the chunk's place inside its 128-byte group, at any COLS that
  // is a multiple of 64.
  template <int COLS>
  __device__ static int off(int r, int c) {
    return r * COLS + ((c ^ (r & 7)) << 3);
  }

  // Rows [0, rows) and dims [0, cols) of a head slice (row r at src + r *
  // stride) into the [rows][COLS] tile dst, rows at or past `valid` and dims
  // at or past `cols` zero-filled.
  template <int COLS>
  __device__ static void stage(bf16* dst, const bf16* src, int64_t stride, int rows, int valid,
                               int cols, int tid) {
    constexpr int kC = COLS / 8;
    for (int i = tid; i < rows * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const bool ok = r < valid && 8 * c < cols;
      mma::cp_async16(dst + off<COLS>(r, c), ok ? src + (int64_t)r * stride + 8 * c : src, ok);
    }
  }

  // s[t] += A . B^T over one piece: the warp's 16 rows of the piece tile At
  // (from row a0) against the NT * 8 rows of Bt from b0, 16-row steps from
  // b_end on not multiplied. One accumulator over the whole head.
  template <int NT, bool Transposed>
  __device__ static void piece_product(float (&s)[NT][4], const bf16* At, int a0, const bf16* Bt,
                                       int b0, int b_end, int lane) {
#pragma unroll
    for (int ks = 0; ks < kPiece / 16; ++ks) {
      uint32_t a[4];
      mma::ldmatrix_x4(a, At + off<kPiece>(a0 + (lane & 15), 2 * ks + (lane >> 4)));
#pragma unroll
      for (int j = 0; j < NT / 2; ++j) {
        if (b0 + 16 * j >= b_end) break;  // warp-uniform
        uint32_t b[4];
        mma::ldmatrix_x4(b, Bt + off<kPiece>(b0 + 16 * j + (lane & 7) + ((lane >> 4) << 3),
                                             2 * ks + ((lane >> 3) & 1)));
        mma::mma_bf16(s[2 * j], a, b[0], b[1]);
        mma::mma_bf16(s[2 * j + 1], a, b[2], b[3]);
      }
    }
  }

  // acc += round(x) . T: x the chunk's values from row c0 on (NT n8 tiles of
  // the accumulator layout) and T the staged [NT * 8][SW] slab tile (k = T's
  // rows, through ldmatrix.trans); 16-row steps up to n, 16-dim steps up to
  // cols.
  template <int NT, int SW>
  __device__ static void slab_product(float (&acc)[SW / 8][4], const float (&x)[NT][4],
                                      const bf16* Tt, int c0, int n, int cols, int lane) {
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      if (c0 + 16 * j >= n) break;  // rows past n: x is 0 (warp-uniform)
      uint32_t a[4];
      longmma::pack_a<NT>(a, x, j);
#pragma unroll
      for (int d = 0; d < SW / 16; ++d) {
        if (16 * d >= cols) break;
        uint32_t b[4];  // dims 16d ..: {b0, b1}; 16d + 8 ..: {b2, b3}
        mma::ldmatrix_x4_trans(b, Tt + off<SW>(16 * j + (lane & 7) + (((lane >> 3) & 1) << 3),
                                               2 * d + (lane >> 4)));
        mma::mma_bf16(acc[2 * d], a, b[0], b[1]);
        mma::mma_bf16(acc[2 * d + 1], a, b[2], b[3]);
      }
    }
  }

  // The warp's 16 rows of a slab (from r0; those before `rows`), dims before
  // `cols`, rounded, to out + row * stride.
  template <int SW>
  __device__ static void store(const float (&acc)[SW / 8][4], bf16* out, int64_t stride, int r0,
                               int rows, int cols, int lane) {
#pragma unroll
    for (int t = 0; t < SW / 8; ++t) {
      if (8 * t >= cols) break;
      mma::store_rows(acc[t], out, stride, r0, rows, 8 * t, lane);
    }
  }
};

// f32: 32-dim pieces (rows of 32 + 4 floats, long_tf32.cuh's padding), 32-key
// chunks (32-query tiles in the keys kernel): a ring buffer of the backward
// then leaves two blocks an SM.
template <>
struct Ops<float> {
  static constexpr int kPiece = 32;
  static constexpr int kChunk = 32;

  template <int COLS>
  __host__ __device__ static constexpr int tile(int rows) {
    return rows * (COLS + 4);
  }

  template <int COLS>
  __device__ static void stage(float* dst, const float* src, int64_t stride, int rows, int valid,
                               int cols, int tid) {
    constexpr int kC = COLS / 4;
    for (int i = tid; i < rows * kC; i += kThreads) {
      const int r = i / kC, c = i % kC;
      const bool ok = r < valid && 4 * c < cols;
      mma::cp_async16(dst + r * (COLS + 4) + 4 * c, ok ? src + (int64_t)r * stride + 4 * c : src,
                      ok);
    }
  }

  // s[t] += A . B^T over one piece (long_tf32.cuh times_rows, whose
  // Transposed order the keys kernel's k q^T and v g^T take), the piece's
  // product added by an f32 add.
  template <int NT, bool Transposed>
  __device__ static void piece_product(float (&s)[NT][4], const float* At, int a0,
                                       const float* Bt, int b0, int b_end, int lane) {
    float part[1][NT][4];
    longtf32::times_rows<1, NT, kPiece, Transposed>(part, At, a0, Bt, b0, b_end, lane);
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[t][e] = __fadd_rn(s[t][e], part[0][t][e]);
  }

  // acc += x . T (long_tf32.cuh chunk_times_cols over a slab): x's n8 tile t
  // as acc_a's A fragment, T's rows 2t and 2t + 1 at column g its B; each k8
  // step's three passes added to acc apart; 8-dim steps up to cols.
  template <int NT, int SW>
  __device__ static void slab_product(float (&acc)[SW / 8][4], const float (&x)[NT][4],
                                      const float* Tt, int c0, int n, int cols, int lane) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      if (c0 + 8 * t >= n) break;  // warp-uniform
      uint32_t ab[4], as[4];
      longtf32::acc_a<NT>(ab, as, x, t);
      const uint32_t* row = reinterpret_cast<const uint32_t*>(Tt) +
                            (8 * t + 2 * (lane & 3)) * (SW + 4) + (lane >> 2);
#pragma unroll
      for (int d = 0; d < SW / 8; ++d) {
        if (8 * d >= cols) break;
        uint32_t bb0, bs0, bb1, bs1;
        mma::split_tf32(row[8 * d], bb0, bs0);
        mma::split_tf32(row[SW + 4 + 8 * d], bb1, bs1);
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma::mma_3xtf32(part, ab, as, bb0, bb1, bs0, bs1);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[d][e] = __fadd_rn(acc[d][e], part[e]);
      }
    }
  }

  template <int SW>
  __device__ static void store(const float (&acc)[SW / 8][4], float* out, int64_t stride, int r0,
                               int rows, int cols, int lane) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + (lane >> 2) + 8 * half;
      if (r >= rows) continue;
      float* dst = out + (int64_t)r * stride + 2 * (lane & 3);
#pragma unroll
      for (int d = 0; d < SW / 8; ++d) {
        if (8 * d >= cols) break;
        *reinterpret_cast<float2*>(dst + 8 * d) =
            make_float2(acc[d][2 * half], acc[d][2 * half + 1]);
      }
    }
  }
};

// The ring's steps: walk w takes per_walk steps, one a (chunk, piece), the
// pieces of a chunk in order (so every walk adds a score's pieces in the
// same order and gets the same bits).
struct Steps {
  int pieces, per_walk;
  __device__ Steps(int n, int w, int chunk, int piece)
      : pieces(w / piece), per_walk(w / piece * ((n + chunk - 1) / chunk)) {}
  // step i: its walk, the chunk's first row (chunk rows a chunk) and the piece
  __device__ void at(int i, int chunk, int& walk, int& c0, int& d) const {
    walk = i / per_walk;
    const int k = i - walk * per_walk;
    c0 = k / pieces * chunk;
    d = k - k / pieces * pieces;
  }
};

template <int NT>
__device__ __forceinline__ void zero(float (&x)[NT][4]) {
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[t][e] = 0.f;
}

}  // namespace wide
}  // namespace devit
