// Shared by csrc/scored_fwd.cu, csrc/scored_bwd.cu and csrc/fused_block.cu:
// f32-faithful tensor-core products for the score-chained kernels.
//
// Every f32 operand x enters a product as two TF32 values, hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna; x - hi is exact in f32), and each product is
// the three terms lo.hi, hi.lo, hi.hi, in that order, on
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with f32
// accumulators.  hi + lo carries 22 of x's 24 mantissa bits and the dropped
// lo.lo term is ~2^-22 of the product, so the result is within a few f32
// ulps of a plain f32 dot product, where one TF32 term keeps ~3 digits.
// The small terms lo.hi and hi.lo go to an accumulator of their own, and
// a product over keys or query rows is taken 16 deep at a time from zero,
// its second 8-deep chunk with A negated into a third accumulator that is
// subtracted, and added to its running sum in f32: the tensor cores'
// accumulate truncates each aligned product toward -inf, and one chain of
// three terms a chunk over hundreds of keys missed f32's accuracy by up to
// 5x on the card; the negated half carries the same bias, which cancels.  A
// bf16 input is exact in TF32, so its lo is 0.  P and dS enter the same
// way, never rounded once.
//
// One score chain (flash_common.cuh says why it must be one): scored_fwd,
// scored_bwd_dq, scored_bwd_dkv and fused_block take their raw q.k dots only
// from `score_dots`, with Q as the A operand and K as the B operand, d from
// zero in 8-wide chunks up to the head-width bucket DH (zero-padded past dh:
// exact zeros), and then flash_common.cuh `chained_score`.  Each element of
// that chain depends only on its own q row and k row, so the kernels may tile
// rows and keys as they like.
//
// Tiles live in shared memory as f32 rows LD floats apart; LD = DH + 4 puts
// the 8 rows x 4 columns a fragment load touches on 32 different banks.
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32), lane = 4 g + t:
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):       c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace flash {
namespace tf32 {

constexpr int kRows = 16;        // a warp owns a 16-row slab
constexpr int kMaxWarps = 4;     // at most four warps a block
constexpr int kSub = 16;         // keys a warp takes in one step
// the scored kernels' launch bounds ask for two blocks of four warps an SM:
// without the second argument ptxas kept them at 128 registers and spilled
// (measured on the card); with it they use up to 255 and spill only at the
// dh-256 bucket
constexpr int kMinBlocks = 2;

// keys staged per step and the row stride of the f32 tiles, per head-width
// bucket: the dkv kernel's dK and dV accumulators stay at 64 floats a
// thread up to dh 256
template <int DH>
struct Bucket {
  static constexpr int BKV = DH <= 64 ? 64 : DH <= 128 ? 32 : 16;
  static constexpr int LD = DH + 4;
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same split on the integer bits, for a finite x: hi is x with half a
// TF32 ulp added to the magnitude's bits and the 13 bits below TF32's
// mantissa cleared (cvt.rna's round to nearest, ties away from zero, a carry
// into the exponent rounding up), and lo is rounded so, its low 13 bits left
// as they are, since the tensor cores read a .tf32 operand's top 19 bits
// only.  sm_90 has no instruction for the cvt: the compiler emulates it with
// a guard for inf and NaN, twice the instructions.  fused_block's tile
// kernel takes it (its key loop and products issue-bound on the splits);
// the kernels that fill the register file at dh 128 keep `split`, whose
// compiled form their register budget was fit to.
__device__ __forceinline__ void split_bits(float x, uint32_t& hi,
                                           uint32_t& lo) {
  asm("{\n"
      "add.u32 %0, %1, 0x1000;\n"
      "and.b32 %0, %0, 0xffffe000;\n"
      "}\n"
      : "=r"(hi) : "r"(__float_as_uint(x)));
  asm("add.u32 %0, %1, 0x1000;\n"
      : "=r"(lo) : "r"(__float_as_uint(x - __uint_as_float(hi))));
}

// `split`, or `split_bits` where BITS
template <bool BITS>
__device__ __forceinline__ void split_as(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (BITS)
    split_bits(x, hi, lo);
  else
    split(x, hi, lo);
}

__device__ __forceinline__ void mma_1688(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b, both as hi + lo: the two small terms lo.hi and hi.lo into
// `corr`, then hi.hi into `main`.  The tensor cores' f32 accumulate
// truncates to the accumulator's magnitude, so the small terms keep their
// own, small accumulator and are added to the large one once, in f32.
__device__ __forceinline__ void mma3(float (&main)[4], float (&corr)[4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_1688(corr, al, bh[0], bh[1]);
  mma_1688(corr, ah, bl[0], bl[1]);
  mma_1688(main, ah, bh[0], bh[1]);
}

// mma3 with the hi.hi term taken as (-a_hi).b_hi into `neg`, to be
// subtracted: the accumulate truncates each aligned product toward -inf, so
// over hundreds of keys the error of one accumulator grows with the count
// of products; alternate chunks into `main` and `neg` carry the same bias,
// which cancels in main - neg
__device__ __forceinline__ void mma3_neg(float (&neg)[4], float (&corr)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  const uint32_t nh[4] = {ah[0] ^ 0x80000000u, ah[1] ^ 0x80000000u,
                          ah[2] ^ 0x80000000u, ah[3] ^ 0x80000000u};
  mma_1688(corr, al, bh[0], bh[1]);
  mma_1688(corr, ah, bl[0], bl[1]);
  mma_1688(neg, nh, bh[0], bh[1]);
}

// The raw dots of one warp: rows a_row0 .. a_row0 + 15 of sA against rows
// b_row0 .. b_row0 + 8 NT - 1 of sB, both DH wide (zero past dh) with rows
// LD floats apart.  Element (g, 2t + e) of n-tile j lands in s[j][e], row
// g + 8 in s[j][2 + e]: the hi.hi chain over d plus the chain of the small
// terms, added once.  Scores are score_dots(sQ, ., sK, .); dP = dO.V^T
// uses it too.
template <int DH, int NT, int LD, int UNROLL = 0>
__device__ __forceinline__ void score_dots(const float* sA, int a_row0,
                                           const float* sB, int b_row0,
                                           float (&s)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float corr[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = corr[j][e] = 0.f;
  // whole up to dh 64 and for one n-tile; four chunks at a time where 16
  // keys x dh 128-256 would hold too many loads in flight, or UNROLL where
  // a caller asks (the order of the products, and so the bits, is the same)
  constexpr int kUnroll = UNROLL ? UNROLL : DH <= 64 || NT == 1 ? DH / 8 : 4;
#pragma unroll (kUnroll)
  for (int k0 = 0; k0 < DH; k0 += 8) {
    const float* pa = sA + (a_row0 + g) * LD + k0 + t;
    uint32_t ah[4], al[4];
    split(pa[0], ah[0], al[0]);
    split(pa[8 * LD], ah[1], al[1]);
    split(pa[4], ah[2], al[2]);
    split(pa[8 * LD + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* pb = sB + (b_row0 + 8 * j + g) * LD + k0 + t;
      uint32_t bh[2], bl[2];
      split(pb[0], bh[0], bl[0]);
      split(pb[4], bh[1], bl[1]);
      mma3(s[j], corr[j], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += corr[j][e];
}

// score_dots with the A operand's fragments split once ahead (`split_rows`),
// for a warp whose rows stay the same over many key steps, every operand
// through `split_bits`: the same products in the same order, so the same
// bits
template <int DH>
struct SplitRows {
  uint32_t hi[DH / 8][4], lo[DH / 8][4];
};

template <int DH, int LD>
__device__ __forceinline__ void split_rows(const float* sA, int a_row0,
                                           SplitRows<DH>& a) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c) {
    const float* pa = sA + (a_row0 + g) * LD + 8 * c + t;
    split_bits(pa[0], a.hi[c][0], a.lo[c][0]);
    split_bits(pa[8 * LD], a.hi[c][1], a.lo[c][1]);
    split_bits(pa[4], a.hi[c][2], a.lo[c][2]);
    split_bits(pa[8 * LD + 4], a.hi[c][3], a.lo[c][3]);
  }
}

template <int DH, int NT, int LD>
__device__ __forceinline__ void score_dots(const SplitRows<DH>& a,
                                           const float* sB, int b_row0,
                                           float (&s)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float corr[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = corr[j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < DH / 8; ++c)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* pb = sB + (b_row0 + 8 * j + g) * LD + 8 * c + t;
      uint32_t bh[2], bl[2];
      split_bits(pb[0], bh[0], bl[0]);
      split_bits(pb[4], bh[1], bl[1]);
      mma3(s[j], corr[j], a.hi[c], a.lo[c], bh, bl);
    }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] += corr[j][e];
}

// acc (16 x DH in n-tiles of 8 columns) += X . B, where X (16 x 8 NT) is
// held in registers in the accumulator layout above and B is rows kr0 ..
// kr0 + 8 NT - 1 of the DH-wide tile sB: O += P.V and dQ += dS.K.  The k
// index of chunk j is taken in the order the accumulator holds it (A column
// t is key 8j + 2t, column t + 4 key 8j + 2t + 1) and B's rows alike, so no
// register moves between lanes.  Each n-tile's product starts from zero and
// is added to acc in f32, so no truncating chain runs across calls; its
// odd chunks go through mma3_neg.  BITS splits through `split_bits`.
template <int DH, int NT, int LD, bool BITS = false>
__device__ __forceinline__ void mma_regA(float (&acc)[DH / 8][4],
                                         const float (&x)[NT][4],
                                         const float* sB, int kr0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_as<BITS>(x[j][0], ah[j][0], al[j][0]);
    split_as<BITS>(x[j][2], ah[j][1], al[j][1]);
    split_as<BITS>(x[j][1], ah[j][2], al[j][2]);
    split_as<BITS>(x[j][3], ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    float main[4] = {0.f, 0.f, 0.f, 0.f}, neg[4] = {0.f, 0.f, 0.f, 0.f};
    float corr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float* pb = sB + (kr0 + 8 * j + 2 * t) * LD + 8 * n + g;
      uint32_t bh[2], bl[2];
      split_as<BITS>(pb[0], bh[0], bl[0]);
      split_as<BITS>(pb[LD], bh[1], bl[1]);
      if (j & 1)
        mma3_neg(neg, corr, ah[j], al[j], bh, bl);
      else
        mma3(main, corr, ah[j], al[j], bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += (main[e] - neg[e]) + corr[e];
  }
}

// acc (16 x 8 NC) += At^T . B over k < KR (a multiple of 16): the A operand
// is rows m0 .. m0 + 15 of At^T, read from the [KR][LDT] tile sAt by
// columns, and B is columns c0 .. c0 + 8 NC - 1 of the [KR][LD] tile sB; k
// in pairs as in mma_regA.  Each 16-deep slice of k starts from zero, its
// second chunk through mma3_neg, and is added to acc in f32.  dV += P^T.dO
// and dK += dS^T.Q in scored_bwd_dkv.
template <int KR, int NC, int LDT, int LD>
__device__ __forceinline__ void mma_transA(float (&acc)[NC][4],
                                           const float* sAt, int m0,
                                           const float* sB, int c0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 1
  for (int k0 = 0; k0 < KR; k0 += 16) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* pa = sAt + (k0 + 8 * c + 2 * t) * LDT + m0 + g;
      split(pa[0], ah[c][0], al[c][0]);
      split(pa[8], ah[c][1], al[c][1]);
      split(pa[LDT], ah[c][2], al[c][2]);
      split(pa[LDT + 8], ah[c][3], al[c][3]);
    }
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      float main[4] = {0.f, 0.f, 0.f, 0.f}, neg[4] = {0.f, 0.f, 0.f, 0.f};
      float corr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float* pb = sB + (k0 + 8 * c + 2 * t) * LD + c0 + 8 * n + g;
        uint32_t bh[2], bl[2];
        split(pb[0], bh[0], bl[0]);
        split(pb[LD], bh[1], bl[1]);
        if (c)
          mma3_neg(neg, corr, ah[c], al[c], bh, bl);
        else
          mma3(main, corr, ah[c], al[c], bh, bl);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += (main[e] - neg[e]) + corr[e];
    }
  }
}

// acc (16 x 8) += A . W^T over k < KC (a multiple of 16), as a Linear
// takes it: A is rows a_row0 .. a_row0 + 15 of the tile sA (rows LDA floats
// apart) from column ka0, and the 8 columns of W^T are rows w_row0 ..
// w_row0 + 7 of the tile sW (rows LDW floats apart, from column 0), torch's
// (out, in) rows.  The fragments are score_dots' (A row-major, W rows as
// B), and k runs in slices as in mma_regA and mma_transA: each 16-deep
// slice starts from zero, its second chunk through mma3_neg, and is added
// to acc in f32.  fused_block's epilogue products.
template <int KC>
__device__ __forceinline__ void mma_rowsW(float (&acc)[4], const float* sA,
                                          int LDA, int a_row0, int ka0,
                                          const float* sW, int LDW,
                                          int w_row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < KC; k0 += 16) {
    float main[4] = {0.f, 0.f, 0.f, 0.f}, neg[4] = {0.f, 0.f, 0.f, 0.f};
    float corr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const float* pa = sA + (a_row0 + g) * LDA + ka0 + k0 + 8 * c + t;
      uint32_t ah[4], al[4];
      split(pa[0], ah[0], al[0]);
      split(pa[8 * LDA], ah[1], al[1]);
      split(pa[4], ah[2], al[2]);
      split(pa[8 * LDA + 4], ah[3], al[3]);
      const float* pb = sW + (w_row0 + g) * LDW + k0 + 8 * c + t;
      uint32_t bh[2], bl[2];
      split(pb[0], bh[0], bl[0]);
      split(pb[4], bh[1], bl[1]);
      if (c)
        mma3_neg(neg, corr, ah, al, bh, bl);
      else
        mma3(main, corr, ah, al, bh, bl);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] += (main[e] - neg[e]) + corr[e];
  }
}

using mma::quad_max;
using mma::quad_sum;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// wait for every copy `stage` started; the caller then syncs the block
__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Stage `rows` rows of a (L, H*dh) tensor, from row `row0`, into f32 rows LD
// apart; rows past `n_real` and columns past dh are zero.  All the block's
// threads take part.  f32 with `vec` (dh % 4 == 0, 16-byte aligned tensors)
// copies 16-byte chunks with cp.async, all in flight at once, until
// `stage_wait`; otherwise elements are converted and stored directly.
template <typename T, int DH, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, size_t D,
                                      int row0, int rows, int n_real, int dh,
                                      bool vec) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (vec) {
      constexpr int CPR = DH / 4;   // 16-byte chunks per row
      for (int i = threadIdx.x; i < rows * CPR; i += blockDim.x) {
        const int r = i / CPR, c = 4 * (i % CPR);
        const bool real = r < n_real && c < dh;
        mma::cp_async16(dst + r * LD + c,
                   real ? src + (size_t)(row0 + r) * D + c : src, real);
      }
      return;
    }
  }
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) {
    const int r = i / DH, c = i % DH;
    dst[r * LD + c] = (r < n_real && c < dh)
                          ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// `stage` by threads tid < nthreads of the block (a group of its warps).
// `stage` itself keeps reading threadIdx and blockDim: the whole-block
// kernels at dh 128 have no register to spare for the two values.
template <typename T, int DH, int LD>
__device__ __forceinline__ void stage_part(float* dst, const T* src, size_t D,
                                           int row0, int rows, int n_real,
                                           int dh, bool vec, int tid,
                                           int nthreads) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (vec) {
      constexpr int CPR = DH / 4;   // 16-byte chunks per row
      for (int i = tid; i < rows * CPR; i += nthreads) {
        const int r = i / CPR, c = 4 * (i % CPR);
        const bool real = r < n_real && c < dh;
        mma::cp_async16(dst + r * LD + c,
                   real ? src + (size_t)(row0 + r) * D + c : src, real);
      }
      return;
    }
  }
  for (int i = tid; i < rows * DH; i += nthreads) {
    const int r = i / DH, c = i % DH;
    dst[r * LD + c] = (r < n_real && c < dh)
                          ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// Stage the rows x cols block of an f32 score tensor whose row r starts at
// src + r * ld into rows LDS floats apart, one 4-byte cp.async an element
// (rows of Lkv floats need not be 16-byte aligned), a warp a row so the
// lanes read consecutive columns, until `stage_wait`.  Elements outside the
// block are not written.  All the block's threads take part.
template <int LDS>
__device__ __forceinline__ void stage_scores(float* dst, const float* src,
                                             size_t ld, int rows, int cols) {
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x / 32; r < rows; r += blockDim.x / 32)
    for (int c = lane; c < cols; c += 32)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       mma::smem_addr(dst + r * LDS + c)),
                   "l"(src + r * ld + c));
}

// whether `stage` may copy 16-byte chunks: f32, dh % 4 == 0 and every
// tensor 16-byte aligned (heads start at h * dh elements)
inline bool vec_ok(int is_bf16, int dh, std::initializer_list<const void*> ptrs) {
  if (is_bf16 || dh % 4) return false;
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// Warps per block for a grid of (q tiles) x H x B: 16-row slabs, up to four
// a block, fewer while the grid would be under two waves of the card's SMs.
inline int pick_warps(int Lq, int H, int B) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int w = kMaxWarps;
  while (w > 1 && (Lq <= kRows * (w / 2) ||
                   (long long)((Lq + kRows * w - 1) / (kRows * w)) * H * B <
                       2LL * sms))
    w /= 2;
  return w;
}

// Allow a kernel its dynamic shared memory once per device (bit `dev` of
// `done`), not on every launch: the attribute call costs host time.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, std::atomic<unsigned>& done) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit & done.load(std::memory_order_acquire)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace tf32
}  // namespace flash
