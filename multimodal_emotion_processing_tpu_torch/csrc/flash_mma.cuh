// Shared by csrc/flash_fwd.cu and csrc/flash_bwd.cu: the tensor-core pieces
// of the bf16 flash kernels at head widths up to 128.
//
// The backward recomputes p = exp(s - m) / l from the forward's saved m and
// l, so the forward, flash_bwd_dq and flash_bwd_dkv must produce the same
// score bits (flash_common.cuh says why: in a fully masked row every score
// is -1e8 + raw, and f32 rounds that to a multiple of 8).  All three get
// their raw dots only from `score_dots`: Q is the A operand, K the B
// operand of one chain of mma.sync.m16n8k16 (bf16 in, f32 accumulator)
// that starts from zero and walks over d in 16-wide chunks in increasing
// order, zero-padded past dh up to the head-width bucket (exact zeros).
// Each output element of that chain depends only on its own q row, k row
// and accumulator, never on the tile around it, so the three kernels may
// tile the rows and keys as they like.  The score is then
// `masked_score(dot, scale, neg)` as in flash_common.cuh.
//
// Operand tiles live in shared memory as bf16 rows of COLS elements (the
// head-width bucket, or the key count of a P / dS tile) in 16-byte chunks,
// swizzled so that the eight rows an ldmatrix reads at one chunk index fall
// on eight different 16-byte bank groups.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "flash_common.cuh"

namespace flash {
namespace mma {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;   // a block is four warps
constexpr int kRows = 16;               // each warp owns a 16-row slab

// bf16 and dh up to 128 take the tensor-core kernels in all three entry
// points; f32, and bf16 at dh 129..256, keep the scalar kernels.  At dh 256
// the dkv kernel's dK and dV accumulators alone would be 256 f32 a thread,
// over the 255 registers a thread may hold, and the forward and dq kernels
// follow it: one predicate for all three, so a head width never gets its
// scores from two different chains.
inline bool takes_tensor_cores(int is_bf16, int dh) {
  return is_bf16 && dh <= 128;
}

// Index of the 16-byte chunk that holds elements [8c, 8c + 8) of row r.
template <int COLS>
__device__ __forceinline__ int chunk(int r, int c) {
  constexpr int CPR = COLS / 8;   // chunks per row
  static_assert(CPR >= 2 && (CPR & (CPR - 1)) == 0, "row width 16 .. 256");
  if constexpr (CPR >= 8)
    return r * CPR + (c ^ (r & 7));
  else
    return r * CPR + (c ^ ((r / (8 / CPR)) & (CPR - 1)));
}

// element offset of (r, d), d a multiple of 8 or any d inside a chunk
template <int COLS>
__device__ __forceinline__ int at(int r, int d) {
  return chunk<COLS>(r, d >> 3) * 8 + (d & 7);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !real
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(real ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulator
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 as one bf16 pair, lo in the low half (the lower k index)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// P and dS enter their products as a sum of kSplit bf16 terms: t0 =
// bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1) (each difference is
// exact in f32).  The product is taken once with each term, into one f32
// accumulator, so the operand carries 24 bits of x's mantissa, as an f32
// does, and the kernels' outputs round to the f32-softmax path's bf16
// values as often as f32 kernels' do.  Measured on the s1024 bf16 training
// path against impl="xla" (H100 80GB HBM3, 700 W; bounds 5e-2): one term,
// step-1 gradients 9.0e-2 apart; two terms, gradients 4.8e-2 but the 8-step
// losses 5.8e-2 apart; three terms, 4.7e-2 and 1.4e-2, for ~12 % more
// kernel time than one (the products are not what bounds these kernels).
constexpr int kSplit = 3;

// the packed bf16 pairs of the terms of (x0, x1)
__device__ __forceinline__ void split_bf16(float x0, float x1,
                                           uint32_t (&t)[kSplit]) {
#pragma unroll
  for (int i = 0; i < kSplit; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    const float2 hf = __bfloat1622float2(h);
    t[i] = *reinterpret_cast<const uint32_t*>(&h);
    x0 -= hf.x;
    x1 -= hf.y;
  }
}

// The accumulators of n-tiles 2c and 2c + 1 (16 rows x 16 columns of an
// m16n8 accumulator pair) as the A fragments of k-chunk c, split into
// terms: O += P.V takes P from S this way, dQ += dS.K takes dS.
template <int NT>
__device__ __forceinline__ void to_a_split(const float (&x)[NT][4],
                                           uint32_t (&a)[kSplit][NT / 2][4]) {
#pragma unroll
  for (int c = 0; c < NT / 2; ++c)
#pragma unroll
    for (int f = 0; f < 4; ++f) {
      // fragment register f: rows g (f even) or g + 8, keys 16c + 2t (f < 2)
      // or 16c + 8 + 2t
      const float(&src)[4] = x[2 * c + (f >> 1)];
      uint32_t t[kSplit];
      split_bf16(src[2 * (f & 1)], src[2 * (f & 1) + 1], t);
#pragma unroll
      for (int i = 0; i < kSplit; ++i) a[i][c][f] = t[i];
    }
}

// Stage ROWS rows of a (L, H*dh) bf16 tensor, from row `row0`, into a
// swizzled tile of COLS columns; rows past `n_real` and columns past dh are
// zero.  `vec` (dh % 8 == 0 and 16-byte aligned tensors) copies 16-byte
// chunks with cp.async, which the caller commits and waits for; otherwise
// elements are stored directly.
template <int COLS, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, size_t D,
                                          int row0, int n_real, int dh,
                                          bool vec) {
  constexpr int CPR = COLS / 8;
  if (vec) {
    for (int i = threadIdx.x; i < ROWS * CPR; i += kThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool real = r < n_real && c * 8 < dh;
      const __nv_bfloat16* g = real ? src + (size_t)(row0 + r) * D + c * 8 : src;
      cp_async16(dst + chunk<COLS>(r, c) * 8, g, real);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * COLS; i += kThreads) {
      const int r = i / COLS, d = i % COLS;
      dst[at<COLS>(r, d)] = (r < n_real && d < dh)
                                ? src[(size_t)(row0 + r) * D + d]
                                : __float2bfloat16_rn(0.f);
    }
  }
}

// The raw dots of one warp: rows a_row0 .. a_row0 + 15 of tile sA against
// rows b_row0 .. b_row0 + 8 NT - 1 of tile sB, both DH wide.  Element
// (g, 2t + e) of n-tile j lands in s[j][e] for row g = lane / 4 and in
// s[j][2 + e] for row g + 8 (t = lane % 4), the m16n8 accumulator layout.
// Scores are score_dots(sQ, ., sK, .); dP = dO . V^T uses it too.
template <int DH, int NT>
__device__ __forceinline__ void score_dots(const __nv_bfloat16* sA, int a_row0,
                                           const __nv_bfloat16* sB, int b_row0,
                                           float (&s)[NT][4]) {
  static_assert(NT % 2 == 0, "keys in pairs of n-tiles");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    uint32_t a[4];
    ldsm_x4(a, sA + at<DH>(a_row0 + (lane & 15), kc * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      ldsm_x4(b, sB + at<DH>(b_row0 + j * 8 + (lane & 7) + (lane >> 4) * 8,
                             kc * 16 + ((lane >> 3) & 1) * 8));
      mma_16816(s[j], a, b[0], b[1]);
      mma_16816(s[j + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 x DH) += (sum of the A terms) (16 x 16 KT, fragments in
// registers) . B, where B is rows b_row0 .. b_row0 + 16 KT - 1 of the
// DH-wide tile sB (k = row, n = column), read once with ldmatrix.trans for
// all terms: O += P.V and dQ += dS.K.
template <int DH, int KT>
__device__ __forceinline__ void mma_regA(float (&acc)[DH / 8][4],
                                         const uint32_t (&a)[kSplit][KT][4],
                                         const __nv_bfloat16* sB, int b_row0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc)
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, sB + at<DH>(b_row0 + kc * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8,
                               n * 8 + (lane >> 4) * 8));
#pragma unroll
      for (int i = 0; i < kSplit; ++i) {
        mma_16816(acc[n], a[i][kc], b[0], b[1]);
        mma_16816(acc[n + 1], a[i][kc], b[2], b[3]);
      }
    }
}

// acc (16 x DH) += (sum of the At terms)^T . B: term i is the KROWS x ACOLS
// tile at sAt + i KROWS ACOLS (k = row, m = column), of which this warp
// takes columns m0 .. m0 + 15, read with ldmatrix.trans as the A operand; B
// as in mma_regA, rows 0 .. KROWS - 1.  dV += P^T.dO and dK += dS^T.Q in
// flash_bwd_dkv.
template <int DH, int KROWS, int ACOLS>
__device__ __forceinline__ void mma_transA(float (&acc)[DH / 8][4],
                                           const __nv_bfloat16* sAt, int m0,
                                           const __nv_bfloat16* sB) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < KROWS / 16; ++kc) {
    const int a_off = at<ACOLS>(kc * 16 + (lane & 7) + (lane >> 4) * 8,
                                m0 + ((lane >> 3) & 1) * 8);
    uint32_t a[kSplit][4];
#pragma unroll
    for (int i = 0; i < kSplit; ++i)
      ldsm_x4_t(a[i], sAt + i * KROWS * ACOLS + a_off);
#pragma unroll
    for (int n = 0; n < DH / 8; n += 2) {
      uint32_t b[4];
      ldsm_x4_t(b, sB + at<DH>(kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                               n * 8 + (lane >> 4) * 8));
#pragma unroll
      for (int i = 0; i < kSplit; ++i) {
        mma_16816(acc[n], a[i], b[0], b[1]);
        mma_16816(acc[n + 1], a[i], b[2], b[3]);
      }
    }
  }
}

// the four lanes of a quad share an accumulator row: reduce across them
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// delta_i = sum_d do_i,d o_i,d (f32) of the warp's 16 rows row0 .. of the
// DH-wide tiles sdO and sO (zero past dh and past the real rows, so those
// give 0).  Lane l sums half a row (row l / 2, half l % 2) in order;
// returns the deltas of this lane's accumulator rows g and g + 8.
template <int DH>
__device__ __forceinline__ void warp_delta(const __nv_bfloat16* sdO,
                                           const __nv_bfloat16* sO, int row0,
                                           float (&delta)[2]) {
  const int lane = threadIdx.x & 31;
  const int r = row0 + (lane >> 1);
  const int d0 = (lane & 1) * (DH / 2);
  float acc = 0.f;
#pragma unroll
  for (int d = d0; d < d0 + DH / 2; d += 8) {
    const uint4 ov = *reinterpret_cast<const uint4*>(sO + at<DH>(r, d));
    const uint4 dv = *reinterpret_cast<const uint4*>(sdO + at<DH>(r, d));
    const __nv_bfloat16* op = reinterpret_cast<const __nv_bfloat16*>(&ov);
    const __nv_bfloat16* dp = reinterpret_cast<const __nv_bfloat16*>(&dv);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc = fmaf(__bfloat162float(dp[e]), __bfloat162float(op[e]), acc);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  const int g = lane >> 2;
  delta[0] = __shfl_sync(0xffffffffu, acc, 2 * g);
  delta[1] = __shfl_sync(0xffffffffu, acc, 2 * (g + 8));
}

// whether the flash kernels may copy 16-byte chunks: dh a multiple of 8 and
// every bf16 tensor 16-byte aligned (heads start at h * dh elements)
inline bool vec_ok(int dh, std::initializer_list<const void*> ptrs) {
  if (dh % 8) return false;
  for (const void* p : ptrs)
    if (p && reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

}  // namespace mma
}  // namespace flash
