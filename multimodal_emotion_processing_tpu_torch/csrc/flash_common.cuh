// Shared by csrc/flash_fwd.cu, csrc/flash_bwd.cu, csrc/scored_fwd.cu and
// csrc/scored_bwd.cu: the score of one (query, key) pair and the small
// helpers around it.
//
// The backward recomputes p = exp(s - m) / l from the forward's saved row
// stats m and l, so s must be bit-identical in the two kernels.  In a row
// whose mask is all zero every score is -1e8 + raw, and f32 rounds that to a
// multiple of 8: a raw near +-4 that rounds one way in the forward and the
// other in the backward turns exp(0) into exp(8).  Both kernels therefore
// compute a score only through `tile_dots` and `masked_score`: a
// sequential fmaf over d = 0 .. DH-1 (zero-padded past dh, which adds
// exact zeros), then one fmaf with the scale and the penalty.  The scale
// comes from `score_scale` and the penalty from `mask_penalty`.  The bf16
// flash kernels up to dh 128 take their raw dots from flash_mma.cuh
// `score_dots` instead, one tensor-core chain shared by the forward and
// both backward kernels, and then the same `masked_score`.
//
// The score-chained kernels (csrc/scored_fwd.cu, both kernels of
// csrc/scored_bwd.cu and csrc/fused_block.cu) take their raw dots from
// csrc/scored_mma.cuh `score_dots`, one split-TF32 tensor-core chain (Q as
// A, K as B, d in 8-wide chunks from zero up to the head-width bucket), and
// then `chained_score` below; none of them uses `tile_dots`.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace flash {

constexpr int kThreads = 256;   // a block is 16 x 16 threads
constexpr int kTX = 16;
constexpr int kTY = 16;
constexpr float kMaskPenalty = 1.0e8f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// the 16 lanes of a half-warp share a row: reduce across them
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = kTX / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

inline float score_scale(int dh) { return 1.0f / sqrtf((float)dh); }

// 1e8 * (1 - mask) for one key; 0 without a mask
__device__ __forceinline__ float mask_penalty(const float* mask_row, int col) {
  return mask_row ? kMaskPenalty * (1.f - mask_row[col]) : 0.f;
}

// (q . k) * scale - penalty, rounded once
__device__ __forceinline__ float masked_score(float dot, float scale, float neg) {
  return fmaf(dot, scale, -neg);
}

// The score of the score-chained kernels (csrc/scored_fwd.cu,
// csrc/scored_bwd.cu and csrc/fused_block.cu), from the raw dot of
// scored_mma.cuh `score_dots`: dot * scale, + c * S_prev when `sprev` is not null,
// - penalty, each step rounded on its own in the plain path's order.  A key
// masked in the previous block carries S_prev ~ -1e8, so s there is
// ~ -(1 + c) * 1e8, where the f32 spacing is 8 to 16: one fused rounding
// would move such an entry by a whole spacing, and in a fully masked row
// change which keys share the row's maximum.  The backward rebuilds s
// through this function, so it is bit-identical to the forward's.
__device__ __forceinline__ float chained_score(float dot, float scale,
                                               const float* sprev, float c,
                                               float neg) {
  float x = __fmul_rn(dot, scale);
  if (sprev) x = __fadd_rn(x, __fmul_rn(c, *sprev));
  return __fsub_rn(x, neg);
}

// Raw dot products of a tile: thread (tx, ty) gets rows ty + 16 r of `sA`
// against rows tx + 16 c of `sB`, each a sequential fmaf over d from 0.
// Rows of both are LDS floats apart and zero past dh.
template <int DH, int RM, int CN, int LDS>
__device__ __forceinline__ void tile_dots(const float* sA, const float* sB,
                                          int tx, int ty, float (&s)[RM][CN]) {
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int c = 0; c < CN; ++c) s[r][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[RM], bv[CN];
#pragma unroll
    for (int r = 0; r < RM; ++r) av[r] = sA[(ty + kTY * r) * LDS + d];
#pragma unroll
    for (int c = 0; c < CN; ++c) bv[c] = sB[(tx + kTX * c) * LDS + d];
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int c = 0; c < CN; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
  }
}

// Stage `rows` rows of a (L, H*dh) tensor, starting at row `row0`, into
// shared memory as f32 rows LDS apart; rows past `n_real` and columns past
// dh are zero.
template <typename T, int DH, int LDS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, size_t D,
                                           int row0, int rows, int n_real,
                                           int dh) {
  for (int i = threadIdx.x; i < rows * DH; i += kThreads) {
    const int r = i / DH, c = i % DH;
    dst[r * LDS + c] = (r < n_real && c < dh)
                           ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

}  // namespace flash
