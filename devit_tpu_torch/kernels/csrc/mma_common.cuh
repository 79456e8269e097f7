// Tensor-core building blocks shared by the bf16 kernels (attention.cu,
// attention_bwd.cu, attention_bwd_split.cu, block_attention.cu), the f32
// attention kernels (long_tf32.cuh) and the int8 matmul (quant_matmul.cu):
// 16-byte cp.async staging into an XOR-swizzled tile of head rows (DH = 32,
// 64 or 128 bf16: 64-, 128- or 256-byte rows) or of 128-byte int8 rows,
// ldmatrix (plain and transposed), the m16n8k16 bf16 mma.sync with f32
// accumulation, the m16n8k8 TF32 mma.sync and its 3xTF32 product at f32
// accuracy, and the m16n8k32 s8 mma.sync with exact int32 accumulation.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16): lane l holds, of the f32
// accumulator, rows l/4 (c0, c1) and l/4 + 8 (c2, c3) at columns 2(l%4) and
// 2(l%4) + 1; of A, registers {a0a1, a2a3, a4a5, a6a7} = (row l/4, k lo),
// (row l/4 + 8, k lo), (row l/4, k hi), (row l/4 + 8, k hi); of B, {b0b1,
// b2b3} = (k lo, column l/4), (k hi, column l/4), two consecutive k a
// register. So the accumulators of two adjacent n8 tiles, rounded and packed
// two bf16 a register, are the A fragment of the next product (pack_bf16).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace devit {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Element offset of 16-byte chunk c (8 bf16) of row r in a [rows][DH] bf16
// tile. DH 64 (128-byte rows): chunk c sits at c ^ (r % 8), so the eight rows
// of one ldmatrix 8x8 matrix (eight consecutive rows from a multiple of 8)
// hit eight different bank groups. DH 128: two 128-byte column halves, each
// swizzled so (c ^ (r % 8) flips only the chunk's place inside its half).
// DH 32 (64-byte rows, two a 128-byte line): chunk c sits at c ^ ((r / 2) %
// 4), so rows r .. r + 7 cover the line's eight 16-byte slots once.
template <int DH>
__device__ __forceinline__ int swz_dh(int r, int c) {
  static_assert(DH == 32 || DH == 64 || DH == 128, "head rows of 32, 64 or 128 bf16");
  if (DH == 32) return r * 32 + ((c ^ ((r >> 1) & 3)) << 3);
  return r * DH + ((c ^ (r & 7)) << 3);
}

// The [rows][64] tile (128-byte rows) of the 64-wide staging tiles.
__device__ __forceinline__ int swz(int r, int c) { return swz_dh<64>(r, c); }

// log2 of the 16-byte chunks a row of DH bf16 holds (DH / 8).
template <int DH>
__host__ __device__ constexpr int chunk_shift() {
  return DH == 32 ? 2 : DH == 64 ? 3 : 4;
}

// 16 bytes from global to shared memory, asynchronously; zero-filled (no
// global read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Rows [0, rows) of a DH-wide head slice (row r at src + r * stride, 2 DH
// bytes, 16-byte aligned) into the swizzled tile dst, rows at or past
// `valid` zero-filled. Issued by threads tid, tid + nthreads, ...
template <int DH = 64>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t stride, int rows,
                                          int valid, int tid, int nthreads) {
  constexpr int kShift = chunk_shift<DH>();
  for (int i = tid; i < rows * (DH / 8); i += nthreads) {
    const int r = i >> kShift, c = i & (DH / 8 - 1);
    const bool ok = r < valid;
    cp_async16(dst + swz_dh<DH>(r, c), ok ? src + (int64_t)r * stride + c * 8 : src, ok);
  }
}

// Four 8x8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// Two matrices; lanes 0 .. 15 give the addresses (the others' are ignored).
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// d += a b: m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo and hi rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// a / b rounded to nearest, given rb = 1/b rounded to nearest (__frcp_rn):
// q = a rb and one FMA correction (Markstein), which is the IEEE quotient
// whenever it is a normal number; three instructions where `/` takes ~10.
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = a * rb;
  return fmaf(fmaf(-b, q, a), rb, q);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- multi-stage cp.async rings

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` committed groups are still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// ---- f32 at f32 accuracy on the TF32 tensor cores (m16n8k8 .tf32, 3xTF32)
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), g = lane / 4, t = lane % 4:
// A {a0, a1, a2, a3} = (row g, k t), (row g + 8, k t), (row g, k t + 4),
// (row g + 8, k t + 4); B {b0, b1} = (k t, column g), (k t + 4, column g);
// the f32 accumulator as mma_bf16's, (c0, c1, c2, c3) = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1). An 8x8 b16 matrix of ldmatrix is 8 rows of 4
// f32, lane l receiving f32 l % 4 of row l / 4: the A fragment's (row, k t)
// and the B fragment of a tile whose rows are B's columns (k contiguous).
//
// One TF32 pass keeps 11 significant bits of each operand, too few for the
// f32 tolerance. Each operand is split as x = big + small, big = x rounded to
// TF32 and small = x - big (exact) rounded to TF32, and a b = big big + big
// small + small big: the dropped small small term and small's own rounding
// sit ~2^-22 below the product, near the f32 rounding of the sum (the 3xTF32
// of CUTLASS's OpMultiplyAddFastF32, which SDPA's f32 path runs).

// x = big + small, both TF32 (x given as its 32 bits): big = x rounded to
// TF32 to nearest, ties away from zero (cvt.rna.tf32.f32's rounding, written
// as an integer add and mask, two instructions where cvt takes more; equal
// to it for every finite x), small = x - big (exact) rounded the same way.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& big, uint32_t& small) {
  big = (x + 0x1000u) & 0xffffe000u;
  const uint32_t r = __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(big)));
  small = (r + 0x1000u) & 0xffffe000u;
}

// d += a b: m16n8k8, TF32 operands, f32 accumulators (one pass).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four registers of fragments (an A fragment, or two B fragments) as their
// (big, small) halves.
__device__ __forceinline__ void split4(const uint32_t (&x)[4], uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
}

// d += a b at f32 accuracy from the split halves of a (ab, as) and b ({bb0,
// bb1}, {bs0, bs1}): three TF32 passes, the small terms first (small a . big
// b, then big a . small b; with SmallBFirst the other way round), then big a
// . big b. A product whose operands trade places (k q^T against q k^T) with
// SmallBFirst flipped adds the same terms in the same order, so it gives the
// same bits.
template <bool SmallBFirst = false>
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                           uint32_t bs0, uint32_t bs1) {
  if (SmallBFirst) {
    mma_tf32(d, ab, bs0, bs1);
    mma_tf32(d, as, bb0, bb1);
  } else {
    mma_tf32(d, as, bb0, bb1);
    mma_tf32(d, ab, bs0, bs1);
  }
  mma_tf32(d, ab, bb0, bb1);
}

// ---- int8 (m16n8k32 .s8)
//
// An 8x8 b16 matrix of ldmatrix is 8 rows of 16 bytes: 16 int8 of K. Lane l
// receives bytes 4(l%4) .. 4(l%4) + 3 of row l/4, which is the s8 fragment
// layout: A {a0, a1, a2, a3} = (row l/4, k 4(l%4) ..), (row l/4 + 8, same
// k), (row l/4, k 16 + 4(l%4) ..), (row l/4 + 8, k 16 + ..); B {b0, b1} =
// (column l/4, k 4(l%4) ..), (column l/4, k 16 + 4(l%4) ..) from a tile whose
// rows are the output columns (K contiguous); the int32 accumulators sit as
// the f32 ones of mma_bf16.

// Byte offset of 16-byte chunk c of row r in a [rows][128] int8 tile: swz's
// XOR pattern in bytes.
__device__ __forceinline__ int swz8(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// d += a b: m16n8k32, s8 operands, s32 accumulators (exact below 2^31).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma
}  // namespace devit
