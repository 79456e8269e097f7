// What the attention backwards share: the tiling of the bf16 whole-head
// kernel (bwd_mma.cuh: kThreads threads walk queries in kBQ-row tiles, warp w
// owning rows 2w and 2w + 1; one block a (batch row, head) up to kShortN
// keys) and the entry to the chunked long path (attention_bwd_long.cu), which
// every f32 backward and every backward past kShortN keys takes.

#pragma once

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace devit {
namespace bwd {

constexpr int kBQ = 32;        // query rows per tile
constexpr int kThreads = 512;  // 16 warps; warp w owns tile rows 2w and 2w+1
constexpr int kWarps = kThreads / 32;
static_assert(kBQ == 2 * kWarps, "each warp owns two rows of a tile");
// The kernels that give one block a whole (batch row, head) hold dk and dv of
// 16 key rows a warp in registers, so they take N <= kShortN; past it the
// backward walks kShortN-key chunks (attention_bwd_long.cu).
constexpr int kShortN = 16 * kWarps;

// Shared memory of one block of the long path (the same at every N).
size_t long_smem_bytes(int dh, int elem);

// dq and dk (dqdk) and/or dv (dv) of (B, N, 3C) qkv and (B, N, C) g, any N,
// dtype 0 = float32, 1 = bfloat16, head_dim 32, 64, 128 or any multiple of
// 64 past 128. Token n of batch row b writes
// from out + (b N + n) out_stride: dq there, dk C further, dv 2C further with
// dqdk and at the start without. stats: B * H * N * 3 floats of scratch (each
// row's softmax max, sum and rowsum(dp * p)).
cudaError_t launch_long(const void* qkv, const void* g, void* out, long long out_stride,
                        float* stats, int B, int N, int H, int head_dim, int dtype, bool dqdk,
                        bool dv, float scale, cudaStream_t stream);

}  // namespace bwd
}  // namespace devit
