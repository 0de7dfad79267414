// Score-chained (RealFormer) attention forward, written for Hopper (sm_90a).
//
// Replaces the materializing forward Pallas kernel of the JAX package,
// multimodal_emotion_processing_tpu/ops/pallas_attention.py:
//   _forward (:162-198, pallas_call at :190; kernel _make_fwd_kernel :49-96)
// in all four of its variants (has S_prev x emits S, `_make` :407-519).
//
// Computes, per batch row b, head h, query row i and key j < Lkv:
//   s[j] = (q_i . k_j) * scale              scale = 1/sqrt(dh), rounded
//   s[j] = s[j] + c * S_prev[b, h, i, j]    when S_prev is given; c*S_prev
//                                           rounded, then the sum rounded
//   s[j] = s[j] - 1e8 * (1 - mask[b, j])    rounded; no mask: nothing
//   S[b, h, i, j] = s[j]                    f32, when S is asked for
//   ctx_i = softmax(s) . v
//   m_i, l_i = max_j s, sum_j exp(s - m_i)  f32, when the row stats are asked
//                                           for (the backward reads them)
// in that order, each step rounded on its own, as the JAX kernel (:79-85)
// and the plain path (ops/attention.py `_scored_attention_xla`) do.  The
// order matters in a chained block: a key masked in the previous block
// carries S_prev ~ -1e8, so s there is ~ -(1 + c) * 1e8, where the f32
// spacing is 8 to 16, and in a fully masked row one rounding more or less
// changes which keys share the row's maximum.
//
// The score chain: the raw dot comes from csrc/scored_mma.cuh `score_dots`
// (split-TF32 tensor-core products, Q as A and K as B, d from zero in
// 8-wide chunks up to the head-width bucket), then flash_common.cuh
// `chained_score`.  csrc/scored_bwd.cu and csrc/fused_block.cu build s
// through the same two functions with the same buckets, so S, and the s
// the backward rebuilds where no S was emitted, are bit-identical in all
// of them.
//
// The gate c is a device pointer of the input dtype, read inside the kernel
// (never copied to the host, which would synchronise every call).  A null
// S_prev selects the variants without the residual term (c is not read); a
// null S selects those that emit nothing; a null `stats` writes no row
// stats.  The mask penalty is the reference's finite 1e8, never -inf, and
// columns at or past Lkv are skipped inside the kernel (kv is never padded),
// so a fully masked row is a softmax over its Lkv real keys only.
//
// Layout: q (B, Lq, H*dh), k and v (B, Lkv, H*dh), ctx like q, all
// row-major and contiguous, heads read by stride; mask (B, Lkv) f32 or null;
// S_prev and S (B, H, Lq, Lkv) f32; stats (2, B, H, Lq) f32 (m, l).  Grid:
// (q tiles of 16 W rows) x heads x batch, four warps a block over W = 1, 2
// or 4 row slabs of 16: W shrinks while the grid would be under two waves of
// the card's SMs (robot_demo at B 8 runs 96-336 blocks where 64-row tiles
// gave 48-96), and the 4 / W warps of a slab split its keys, each taking
// every (4 / W)-th step of 16 keys, then merge their (m, l, acc) in a fixed
// order, so a small grid's blocks run a quarter of the steps each.  Each kv
// tile (64 keys up to dh 64, 32 at dh 128, 16 at dh 256) is staged once for
// the block in f32; a step is the warp's 16 x 16 scores on the tensor
// cores, an online-softmax update in registers (row max and sum across the
// four lanes of a quad), S written straight from the accumulator layout,
// and P.V on the tensor cores with P split into TF32 terms.
//
// What bounds it on an H100: per (b, h), 4*Lq*Lkv*dh flops against
// (2*Lq + 2*Lkv)*dh input and output elements plus Lq*Lkv f32 scores read
// (S_prev) and written (S).  At the robot_demo shapes (dh 32, L 25 or 100,
// f32, one score tensor per call) that is 5 to 14 flops per byte; the three
// TF32 terms of each product run on the tensor cores (495 TFLOP/s dense),
// so the bytes bound it, and the score tensor is a large share of them.
// At B 8 a call moves 0.2-4.4 MB, a few microseconds at 3.35 TB/s, so in
// practice launch latency and the wrapper's host time bound a call; the
// design cuts the host side (the shared-memory attribute is set once per
// instance) and fills the card with small blocks.

#include <float.h>

#include "scored_mma.cuh"

namespace {

using namespace flash;
using namespace flash::tf32;

// shared memory of a block of `slabs` row slabs: sQ, sK, sV and the
// penalties, which the merge of the key groups' (m, l, acc) then reuses
template <int DH>
size_t smem_bytes(int slabs) {
  using Bk = Bucket<DH>;
  const size_t tiles = (size_t)kRows * slabs * Bk::LD +
                       2 * (size_t)Bk::BKV * Bk::LD + Bk::BKV;
  const size_t merge = (size_t)kMaxWarps * kRows * (Bk::LD + 2);
  return sizeof(float) * (tiles > merge ? tiles : merge);
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
scored_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ s_prev, const T* __restrict__ c,
                  T* __restrict__ o, float* __restrict__ s_out,
                  float* __restrict__ stats, int B, int Lq, int Lkv, int H,
                  int dh, float scale, bool vec, int slabs) {
  constexpr int BKV = Bucket<DH>::BKV, LD = Bucket<DH>::LD;
  constexpr int NT = kSub / 8, NO = DH / 8;
  const int BQ = kRows * slabs;
  const int groups = kMaxWarps / slabs;   // key groups per row slab

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sNeg = sV + BKV * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t D = (size_t)H * dh;
  const T* qb = q + (size_t)b * Lq * D + (size_t)h * dh;
  const T* kb = k + (size_t)b * Lkv * D + (size_t)h * dh;
  const T* vb = v + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;
  // row (b, h, i) of S_prev and S starts at (head_row0 + i) * Lkv
  const size_t head_row0 = ((size_t)b * H + h) * Lq;
  const float cv = s_prev ? to_f32(c[0]) : 0.f;

  stage<T, DH, LD>(sQ, qb, D, q0, BQ, Lq - q0, dh, vec);

  // warp = slab + slabs * group: its 16 rows, and every groups-th 16-key step
  const int slab = warp % slabs, group = warp / slabs;
  const int r0 = kRows * slab;
  const bool active = q0 + r0 < Lq;
  int row[2];
  bool live[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    row[hr] = q0 + r0 + g + 8 * hr;
    live[hr] = row[hr] < Lq;   // rows past Lq are computed, never stored
  }
  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
    const int nkv = min(BKV, Lkv - kv0);
    __syncthreads();  // sQ is written; the last tile's sK / sV readers are done
    stage<T, DH, LD>(sK, kb, D, kv0, BKV, nkv, dh, vec);
    stage<T, DH, LD>(sV, vb, D, kv0, BKV, nkv, dh, vec);
    for (int j = threadIdx.x; j < BKV; j += blockDim.x)
      sNeg[j] = j < nkv ? mask_penalty(mb, kv0 + j) : 0.f;
    stage_wait();
    __syncthreads();
    if (!active) continue;

    // the group's steps of 16 keys, each an online-softmax update
#pragma unroll 1
    for (int c0 = kSub * group; c0 < nkv; c0 += kSub * groups) {
      float s[NT][4];
      score_dots<DH, NT, LD>(sQ, r0, sK, c0, s);
      float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
          if (col < nkv) {
            const size_t off = (head_row0 + row[hr]) * (size_t)Lkv + kv0 + col;
            const float x = chained_score(
                s[j][e], scale, s_prev && live[hr] ? s_prev + off : nullptr,
                cv, sNeg[col]);
            if (s_out && live[hr]) s_out[off] = x;
            s[j][e] = x;
            mx[hr] = fmaxf(mx[hr], x);
          }
        }
      // every step holds at least one real column, so its max is finite
      float m_new[2], alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        m_new[hr] = fmaxf(m_run[hr], quad_max(mx[hr]));
        alpha[hr] = expf(m_run[hr] - m_new[hr]);
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
        l_run[hr] = l_run[hr] * alpha[hr] + quad_sum(sum[hr]);
        m_run[hr] = m_new[hr];
      }
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
      mma_regA<DH, NT, LD>(acc, s, sV, c0);
    }
  }

  if (groups > 1) {
    // merge the groups of each slab in a fixed order: m the max of theirs,
    // l and acc their sums rescaled to it (a group that saw no key holds
    // m = -FLT_MAX, l = 0, acc = 0 and adds nothing)
    float* sAcc = smem;                              // [warp][row][LD]
    float* sML = smem + kMaxWarps * kRows * LD;      // [warp][row][m, l]
    __syncthreads();  // every warp is done with sQ, sK and sV
    if (active) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int r = g + 8 * hr;
        float* dst = sAcc + (warp * kRows + r) * LD;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          dst[8 * n + 2 * t] = acc[n][2 * hr];
          dst[8 * n + 2 * t + 1] = acc[n][2 * hr + 1];
        }
        if (t == 0) {
          sML[(warp * kRows + r) * 2] = m_run[hr];
          sML[(warp * kRows + r) * 2 + 1] = l_run[hr];
        }
      }
    }
    __syncthreads();
    if (group != 0 || !active) return;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = g + 8 * hr;
      float m_tot = -FLT_MAX;
      for (int gr = 0; gr < groups; ++gr)
        m_tot = fmaxf(m_tot, sML[((slab + slabs * gr) * kRows + r) * 2]);
      float l_tot = 0.f;
#pragma unroll
      for (int n = 0; n < NO; ++n) acc[n][2 * hr] = acc[n][2 * hr + 1] = 0.f;
      for (int gr = 0; gr < groups; ++gr) {
        const int w = slab + slabs * gr;
        const float f = expf(sML[(w * kRows + r) * 2] - m_tot);
        l_tot += sML[(w * kRows + r) * 2 + 1] * f;
        const float* src = sAcc + (w * kRows + r) * LD;
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          acc[n][2 * hr] += src[8 * n + 2 * t] * f;
          acc[n][2 * hr + 1] += src[8 * n + 2 * t + 1] * f;
        }
      }
      m_run[hr] = m_tot;
      l_run[hr] = l_tot;
    }
  }
  if (!active) return;

  const size_t n_rows = (size_t)B * H * Lq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!live[hr]) continue;
    // l >= 1 (the row max contributes exp(0)): the fast reciprocal, which
    // has no slow path for tiny or huge divisors and so no call
    const float inv = __fdividef(1.f, l_run[hr]);
    T* orow = o + ((size_t)b * Lq + row[hr]) * D + (size_t)h * dh;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < dh) store(orow + d, acc[n][2 * hr + e] * inv);
      }
    if (stats && t == 0) {
      stats[head_row0 + row[hr]] = m_run[hr];
      stats[n_rows + head_row0 + row[hr]] = l_run[hr];
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* s_prev, const void* c,
                   void* o, void* s_out, void* stats, int B, int H, int Lq,
                   int Lkv, int dh, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = allow_smem(scored_fwd_kernel<T, DH>,
                               smem_bytes<DH>(kMaxWarps), smem_set);
  if (err != cudaSuccess) return err;
  const int slabs = pick_warps(Lq, H, B);
  const int bq = kRows * slabs;
  const dim3 grid((Lq + bq - 1) / bq, H, B);
  scored_fwd_kernel<T, DH><<<grid, 32 * kMaxWarps, smem_bytes<DH>(slabs),
                             stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(s_prev), static_cast<const T*>(c),
      static_cast<T*>(o), static_cast<float*>(s_out),
      static_cast<float*>(stats), B, Lq, Lkv, H, dh, score_scale(dh),
      vec_ok(sizeof(T) != sizeof(float), dh, {q, k, v}), slabs);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, const void* sp, const void* c, void* o,
                     void* so, void* st, int B, int H, int Lq, int Lkv, int dh,
                     cudaStream_t s) {
  if (dh <= 16) return launch<T, 16>(q, k, v, mask, sp, c, o, so, st, B, H, Lq, Lkv, dh, s);
  if (dh <= 32) return launch<T, 32>(q, k, v, mask, sp, c, o, so, st, B, H, Lq, Lkv, dh, s);
  if (dh <= 64) return launch<T, 64>(q, k, v, mask, sp, c, o, so, st, B, H, Lq, Lkv, dh, s);
  if (dh <= 128) return launch<T, 128>(q, k, v, mask, sp, c, o, so, st, B, H, Lq, Lkv, dh, s);
  return launch<T, 256>(q, k, v, mask, sp, c, o, so, st, B, H, Lq, Lkv, dh, s);
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel was launched.  s_prev and
// s_out are each null or (B, H, Lq, Lkv) f32; c (one value of the input
// dtype) must be given with s_prev; stats is null or (2, B, H, Lq) f32.
extern "C" int scored_fwd(const void* q, const void* k, const void* v,
                          const void* mask, const void* s_prev, const void* c,
                          void* ctx, void* s_out, void* stats, int B, int H,
                          int Lq, int Lkv, int dh, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lkv < 1 || dh < 1 || dh > 256 ||
      B > 65535 || H > 65535 || (s_prev != nullptr && c == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, mask, s_prev, c, ctx, s_out,
                                        stats, B, H, Lq, Lkv, dh, s)
              : dispatch<float>(q, k, v, mask, s_prev, c, ctx, s_out, stats,
                                B, H, Lq, Lkv, dh, s);
  return (int)err;
}
