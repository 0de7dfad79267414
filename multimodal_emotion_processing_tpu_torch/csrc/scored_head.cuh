// Shared by csrc/scored_fwd.cu and csrc/fused_block.cu: one head of
// score-chained attention for a group of warps, from its q tile to each
// row's (m, l) and unnormalised ctx in registers.
//
// The group's warps own 16-row slabs of the q tile: `slabs` of them (1, 2 or
// 4), and the warps / slabs warps of a slab split its keys, each taking
// every (warps / slabs)-th step of 16 keys, then merge their (m, l, acc) in
// a fixed order.  Each kv tile (64 keys up to dh 64, 32 at dh 128, 16 at dh
// 256; half that in two buffers where the caller pipelines the tiles) is
// staged once for the group in f32; a step is the warp's 16 x 16 raw dots
// from scored_mma.cuh `score_dots`, flash_common.cuh `chained_score` (so S
// is the same bits in every kernel that builds it), an online-softmax update
// in registers (row max and sum across the four lanes of a quad), S written
// straight from the accumulator layout, and P.V on the tensor cores
// (`mma_regA`, P split into TF32 terms).  A group is the whole block
// (scored_fwd, fused_block's cluster kernel) or one head's warps of a
// block that runs several heads at once (fused_block's tile kernel), which
// then syncs only on a named barrier of its own.

#pragma once

#include <float.h>

#include <type_traits>

#include "scored_mma.cuh"

namespace flash {
namespace tf32 {

// The warps that run one head together, ordered among themselves by a
// barrier of their own.  WholeBlock: the block's four warps and
// __syncthreads, all known at compile time (scored_fwd, fused_block's
// cluster kernel).  HeadGroup: `warps` warps from warp `warp0` of a block
// that runs several heads at once, synced by named barrier `bar` (1-15).
struct WholeBlock {
  static constexpr int warp0 = 0, warps = kMaxWarps;
  __device__ __forceinline__ static int tid() { return threadIdx.x; }
  __device__ __forceinline__ static int threads() { return blockDim.x; }
  __device__ __forceinline__ static void sync() { __syncthreads(); }
};

struct HeadGroup {
  int warp0, warps, bar;
  __device__ __forceinline__ int tid() const {
    return (int)threadIdx.x - 32 * warp0;
  }
  __device__ __forceinline__ int threads() const { return 32 * warps; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync %0, %1;\n" ::"r"(bar), "r"(32 * warps) : "memory");
  }
};

// keys a staged kv tile holds: Bucket's, or half that where PIPE = 2
// buffers take turns
template <int DH, int PIPE>
__host__ __device__ constexpr int head_bkv() {
  return PIPE == 1 ? Bucket<DH>::BKV : Bucket<DH>::BKV / 2;
}

// floats of shared memory one head takes for `slabs` row slabs: sQ, then
// PIPE buffers of sK, sV and the penalties, which the merge of the key
// groups' (m, l, acc) then reuses
template <int DH, int PIPE = 1>
__host__ __device__ constexpr size_t head_floats(int slabs) {
  constexpr int LD = Bucket<DH>::LD, BKV = head_bkv<DH, PIPE>();
  const size_t tiles = (size_t)kRows * slabs * LD +
                       PIPE * (2 * (size_t)BKV * LD + BKV);
  const size_t merge = (size_t)kMaxWarps * kRows * (LD + 2);
  return tiles > merge ? tiles : merge;
}

// 4 bytes global -> shared, asynchronously; zero-filled when !real
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool real) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   mma::smem_addr(dst)),
               "l"(src), "r"(real ? 4 : 0));
}

// `stage` by the group's threads: the whole block's as `stage` takes them
template <typename T, int DH, int LD, typename Group>
__device__ __forceinline__ void stage_by(const Group& grp, float* dst,
                                         const T* src, size_t D, int row0,
                                         int rows, int n_real, int dh,
                                         bool vec) {
  if constexpr (std::is_same_v<Group, WholeBlock>)
    stage<T, DH, LD>(dst, src, D, row0, rows, n_real, dh, vec);
  else
    stage_part<T, DH, LD>(dst, src, D, row0, rows, n_real, dh, vec,
                          grp.tid(), grp.threads());
}

// The kv tile from kv0 into the buffer at sK (sV, then the mask's BKV
// values after it) by the group's threads, as cp.async where `vec` (the
// mask always), until waited for; the values past Lkv are zero.
template <typename T, int DH, int LD, int BKV, typename Group>
__device__ __forceinline__ void stage_kv_async(const Group& grp, float* sK,
                                               const T* kb, const T* vb,
                                               const float* mb, size_t D,
                                               int kv0, int Lkv, int dh,
                                               bool vec) {
  const int nkv = min(BKV, Lkv - kv0);
  stage_by<T, DH, LD>(grp, sK, kb, D, kv0, BKV, nkv, dh, vec);
  stage_by<T, DH, LD>(grp, sK + BKV * LD, vb, D, kv0, BKV, nkv, dh, vec);
  float* sMask = sK + 2 * BKV * LD;
  if (mb)
    for (int j = grp.tid(); j < BKV; j += grp.threads())
      cp_async4(sMask + j, mb + kv0 + (j < nkv ? j : 0), j < nkv);
}

// What one warp holds after `attend_head`: rows row[hr] = q0 + slab row g +
// 8 hr, live when below Lq, their max m, sum l of exp(s - m), and ctx * l in
// the accumulator layout (element (g + 8 hr, 8 n + 2 t + e) in acc[n][2 hr +
// e]).
template <int DH>
struct HeadRows {
  float acc[DH / 8][4];
  float m[2], l[2];
  int row[2];
  bool live[2];
};

// One head: q rows q0 .. q0 + 16 slabs - 1 of qb against all Lkv keys of kb
// and vb, each (L, D) with the head's columns from 0 (the caller offsets the
// pointers to the head), mask row mb or null, S_prev and S rows from
// head_row0 (row i of the head at (head_row0 + i) * Lkv), each null when
// absent.  Every thread of the group `grp` (at most kMaxWarps warps; by
// default the whole block) calls it, and it syncs only the group; `smem`
// holds head_floats<DH, PIPE>(slabs) floats and is free again once the
// group has synced after the call.  Returns whether this warp holds its
// slab's merged rows (key group 0 of a slab with a row below Lq).  UNROLL,
// where not 0, sets how many 8-wide chunks of the score dots are unrolled
// (fewer loads in flight, the same products in the same order).
//
// A HeadGroup (fused_block's tile kernel) passes PIPE = 2: the next kv
// tile's copies, the mask's values among them, are in flight while the
// group works on this one (the copies its caller issued are waited for
// with the first tile), the warp's q fragments are split once, and every
// split goes through `split_bits`.  The same products in the same order as
// the whole block's, so S and m are the same bits.
template <typename T, int DH, int UNROLL = 0, int PIPE = 1,
          typename Group = WholeBlock>
__device__ __forceinline__ bool attend_head(
    float* smem, const T* qb, const T* kb, const T* vb, const float* mb,
    const float* s_prev, float* s_out, size_t head_row0, float cv, size_t D,
    int q0, int Lq, int Lkv, int dh, float scale, bool vec, int slabs,
    HeadRows<DH>& o, const Group& grp = Group()) {
  static_assert(PIPE == 1 || PIPE == 2, "one or two kv buffers");
  constexpr bool kBits = PIPE == 2;
  constexpr int BKV = head_bkv<DH, PIPE>(), LD = Bucket<DH>::LD;
  constexpr int NT = kSub / 8, NO = DH / 8;
  constexpr int kBuf = 2 * BKV * LD + BKV;   // floats of one kv buffer
  const int BQ = kRows * slabs;
  const int groups = grp.warps / slabs;   // key groups per row slab

  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sNeg = sV + BKV * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32 - grp.warp0;
  const int g = lane >> 2, t = lane & 3;

  stage_by<T, DH, LD>(grp, sQ, qb, D, q0, BQ, Lq - q0, dh, vec);

  // warp = slab + slabs * group: its 16 rows, and every groups-th 16-key step
  const int slab = warp % slabs, group = warp / slabs;
  const int r0 = kRows * slab;
  const bool active = q0 + r0 < Lq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    o.row[hr] = q0 + r0 + g + 8 * hr;
    o.live[hr] = o.row[hr] < Lq;   // rows past Lq are computed, never stored
    o.m[hr] = -FLT_MAX;
    o.l[hr] = 0.f;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o.acc[n][e] = 0.f;

  SplitRows<kBits ? DH : 8> qs;   // PIPE = 2: the warp's q fragments
  if constexpr (PIPE == 2) {
    stage_kv_async<T, DH, LD, BKV>(grp, sK, kb, vb, mb, D, 0, Lkv, dh, vec);
    mma::cp_async_commit();
  }
  for (int kv0 = 0, buf = 0; kv0 < Lkv; kv0 += BKV, buf ^= PIPE - 1) {
    const int nkv = min(BKV, Lkv - kv0);
    // sQ is written; the last tile's sK / sV readers are done
    grp.sync();
    if constexpr (PIPE == 1) {
      stage<T, DH, LD>(sK, kb, D, kv0, BKV, nkv, dh, vec);
      stage<T, DH, LD>(sV, vb, D, kv0, BKV, nkv, dh, vec);
      for (int j = threadIdx.x; j < BKV; j += blockDim.x)
        sNeg[j] = j < nkv ? mask_penalty(mb, kv0 + j) : 0.f;
      stage_wait();
    } else if (kv0 + BKV < Lkv) {
      stage_kv_async<T, DH, LD, BKV>(grp, sK + (buf ^ 1) * kBuf, kb, vb, mb, D,
                                     kv0 + BKV, Lkv, dh, vec);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();   // all but the tile just issued
    } else {
      mma::cp_async_wait<0>();
    }
    grp.sync();
    if constexpr (PIPE == 2)
      if (kv0 == 0) split_rows<DH, LD>(sQ, r0, qs);
    if (!active) continue;
    const float* bK = sK + buf * kBuf;
    const float* bV = bK + BKV * LD;
    const float* bNeg = bV + BKV * LD;

    // the group's steps of 16 keys, each an online-softmax update
#pragma unroll 1
    for (int c0 = kSub * group; c0 < nkv; c0 += kSub * groups) {
      float s[NT][4];
      if constexpr (PIPE == 2)
        score_dots<DH, NT, LD>(qs, bK, c0, s);
      else
        score_dots<DH, NT, LD, UNROLL>(sQ, r0, bK, c0, s);
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
          if (col < nkv) {
            const size_t off =
                (head_row0 + o.row[hr]) * (size_t)Lkv + kv0 + col;
            // PIPE = 2 staged the mask itself: its penalty, the same bits
            const float neg =
                PIPE == 2 ? mask_penalty(mb ? bNeg : nullptr, col) : bNeg[col];
            const float x = chained_score(
                s[j][e], scale, s_prev && o.live[hr] ? s_prev + off : nullptr,
                cv, neg);
            if (s_out && o.live[hr]) s_out[off] = x;
            s[j][e] = x;
            mx[hr] = fmaxf(mx[hr], x);
          }
        }
      // every step holds at least one real column, so its max is finite
      float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m_new[hr] = fmaxf(o.m[hr], quad_max(mx[hr]));
        alpha[hr] = expf(o.m[hr] - m_new[hr]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
          const float p = col < nkv ? expf(s[j][e] - m_new[hr]) : 0.f;
          s[j][e] = p;
          sum[hr] += p;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        o.l[hr] = o.l[hr] * alpha[hr] + quad_sum(sum[hr]);
        o.m[hr] = m_new[hr];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o.acc[n][e] *= alpha[e >> 1];
      mma_regA<DH, NT, LD, kBits>(o.acc, s, bV, c0);
    }
  }

  if (groups == 1) return active;
  // merge the groups of each slab in a fixed order: m the max of theirs, l
  // and acc their sums rescaled to it (a group that saw no key holds
  // m = -FLT_MAX, l = 0, acc = 0 and adds nothing)
  float* sAcc = smem;                              // [warp][row][LD]
  float* sML = smem + kMaxWarps * kRows * LD;      // [warp][row][m, l]
  grp.sync();  // every warp is done with sQ, sK and sV
  if (active) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
      float* dst = sAcc + (warp * kRows + r) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        dst[8 * n + 2 * t] = o.acc[n][2 * hr];
        dst[8 * n + 2 * t + 1] = o.acc[n][2 * hr + 1];
      }
      if (t == 0) {
        sML[(warp * kRows + r) * 2] = o.m[hr];
        sML[(warp * kRows + r) * 2 + 1] = o.l[hr];
      }
    }
  }
  grp.sync();
  if (group != 0 || !active) return false;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = g + 8 * hr;
    float m_tot = -FLT_MAX;
    for (int gr = 0; gr < groups; ++gr)
      m_tot = fmaxf(m_tot, sML[((slab + slabs * gr) * kRows + r) * 2]);
    float l_tot = 0.f;
#pragma unroll
    for (int n = 0; n < NO; ++n) o.acc[n][2 * hr] = o.acc[n][2 * hr + 1] = 0.f;
    for (int gr = 0; gr < groups; ++gr) {
      const int w = slab + slabs * gr;
      const float f = expf(sML[(w * kRows + r) * 2] - m_tot);
      l_tot += sML[(w * kRows + r) * 2 + 1] * f;
      const float* src = sAcc + (w * kRows + r) * LD;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o.acc[n][2 * hr] += src[8 * n + 2 * t] * f;
        o.acc[n][2 * hr + 1] += src[8 * n + 2 * t + 1] * f;
      }
    }
    o.m[hr] = m_tot;
    o.l[hr] = l_tot;
  }
  return true;
}

}  // namespace tf32
}  // namespace flash
