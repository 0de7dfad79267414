// Score-chained (RealFormer) attention backward, written for Hopper (sm_90a):
// two kernels in the FlashAttention-2 split, each deterministic (no atomics).
//
// Replace the backward Pallas kernel of the JAX package,
// multimodal_emotion_processing_tpu/ops/pallas_attention.py:
//   _backward_pallas (:303-361, pallas_call at :350; kernel
//   _make_bwd_kernel :201-286), in all four of its variants (has S_prev x
//   emits S, `_make` :407-519), together:
//   scored_bwd_dq   delta, dS_prev, the dc partials and dq (and the row
//                   stats where the forward kept none)
//   scored_bwd_dkv  dk, dv, the per-head dmask rows, and dc from the partials
//
// Per batch row b, head h, query row i and key j < Lkv:
//   s       = S[b, h, i, j] when the forward emitted S; otherwise rebuilt
//             through the forward's chain (csrc/scored_mma.cuh `score_dots`,
//             then flash_common.cuh `chained_score`: q.k * scale (+ c *
//             S_prev) - 1e8 (1 - mask), each step rounded on its own), bit
//             for bit
//   m_i, l_i = the forward's row stats (scored_fwd writes them when asked);
//             where none come in (fused_block's forward keeps none),
//             scored_bwd_dq takes them in a first sweep over the keys
//   p       = exp(s - m_i) * (1 / l_i)
//   dp      = dctx_i . v_j
//   delta_i = dctx_i . ctx_i                 (= sum_j p dp, JAX :265; at
//                                            bf16 sum_j p dp itself, as
//                                            ctx was rounded to bf16)
//   ds      = p (dp - delta_i) (+ dS[b, h, i, j], the cotangent of the
//             emitted S, when there is one)
//   dS_prev = c ds                           f32, when S_prev is given
//   dc      = sum ds S_prev                  one partial per 16-row slab,
//                                            summed in a fixed order by
//                                            scored_bwd_dkv's first block
//   dq_i    = sum_j ds k_j / sqrt(dh)        (scored_bwd_dq)
//   dk_j    = sum_i ds q_i / sqrt(dh)        (scored_bwd_dkv)
//   dv_j    = sum_i p dctx_i                 (scored_bwd_dkv)
//   dmh[b, h, j] = 1e8 sum_i ds              (scored_bwd_dkv, when asked for;
//                  the sum over heads is the caller's)
// all accumulated in f32; dq, dk and dv are stored at the input dtype.  With
// the forward's stats and ctx, scored_bwd_dq makes one sweep over the keys
// (f32; bf16 inputs add the stats sweep, for delta):
// it reads each score tensor (S, dS, S_prev) once and writes dS_prev once.
// It writes (m, l, delta) per row for scored_bwd_dkv, which rebuilds the
// same p and ds from them.  Columns at or past Lkv and rows at or past Lq
// are skipped, never padded, so a fully masked row is a softmax over its
// Lkv real keys, as in the forward.
//
// Every product runs on the tensor cores in csrc/scored_mma.cuh's
// split-TF32 form (three TF32 terms, f32 accumulator): s (when rebuilt) and
// dp = dO.V^T through `score_dots`, dq += dS.K from registers, dk += dS^T.Q
// and dv += P^T.dO through shared P / dS tiles.
//
// Layout: q, dctx and ctx (B, Lq, H*dh), k and v (B, Lkv, H*dh), all
// row-major and contiguous, heads read by stride; mask (B, Lkv) f32 or null;
// S, dS, S_prev and dS_prev (B, H, Lq, Lkv) f32; stats_in (2, B, H, Lq) f32
// (m, l) or null; stats (3, B, H, Lq) f32 (m, l, delta); dc_part (B, H,
// ceil(Lq / 16)) f32; the gate c one value of the input dtype on the device.
// scored_bwd_dq: grid (q tiles of 16 W rows) x H x B, W = 1, 2 or 4 warps
// (W chosen as scored_fwd chooses its row slabs), each warp owning 16 query
// rows and dq in registers, 16 keys a step; kv tiles
// of 64 keys up to dh 64 (32 at dh 128, 16 at dh 256) staged once for the
// block.  scored_bwd_dkv: grid (kv tiles) x H x B, four warps; per step of
// 64 query rows the step's S (or S_prev) and dS tiles are staged by
// cp.async with Q and dO into the sP / sDS tiles, each warp turns its 16
// rows x the tile's keys of them into p and ds in place, then each warp
// adds its share (16 keys x DH/4..DH columns) of dk and dv.
//
// What bounds it on an H100: per (b, h), 8 Lq Lkv dh flops for the four
// products (10 where s is rebuilt), each run as three TF32 terms on the
// tensor cores, against (3 Lq + 2 Lkv) dh elements read, (Lq + 2 Lkv) dh
// written and 2 Lq Lkv f32 score elements moved (S and dS read, or S_prev
// read and dS_prev written).  At the mosei_realformer training shapes
// (dh 16, Lq = Lkv = 50, f32) that is ~3 flops per byte, so the bytes bound
// it and the two score tensors are most of them; the single dq sweep moves
// each once in dq, and dkv, which needs p and ds again, reads S (or S_prev
// to rebuild s) and dS a second time.  In practice both kernels run at ~3x
// their byte bound there, held by the issue of dependent short steps (a
// step's splits, mma.sync chains and exp) at 12-16 warps an SM: staging
// dkv's score tiles cut it; staging dq's, or splitting the operand tiles
// once into shared memory, did not (measured on the card; PERF.md).

#include <float.h>

#include "scored_mma.cuh"

namespace {

using namespace flash;
using namespace flash::tf32;

constexpr int kDkvRows = kRows * kMaxWarps;   // scored_bwd_dkv's query step

struct Args {
  const void *q, *k, *v;
  const float *mask, *s, *dsc, *sprev;
  const void *c, *dout, *o;
  const float* stats_in;
  float* stats;
  void *dq, *dk, *dv;
  float *dsprev, *dcpart, *dmh, *dc;
  int B, H, Lq, Lkv, dh;
  bool vec;   // `stage` may copy 16-byte chunks
  cudaStream_t stream;
};

__host__ __device__ inline int q_slabs(int Lq) { return (Lq + kRows - 1) / kRows; }

template <int DH>
size_t dq_smem(int warps) {
  using Bk = Bucket<DH>;
  return sizeof(float) * (2 * (size_t)kRows * warps * Bk::LD +
                          2 * (size_t)Bk::BKV * Bk::LD + Bk::BKV);
}

template <int DH>
struct DkvTiles {
  static constexpr int BKV = Bucket<DH>::BKV, LD = Bucket<DH>::LD;
  static constexpr int LDP = BKV + 4;
  // each warp's share of dk and dv: 16 keys x DC columns, four shares
  static constexpr int DC = DH * BKV / (kRows * kMaxWarps);
  static constexpr size_t smem =
      sizeof(float) * (2 * (size_t)BKV * LD + 2 * (size_t)kDkvRows * LD +
                       2 * (size_t)kDkvRows * LDP + BKV + 3 * kDkvRows);
  static_assert(DC % 8 == 0 && (BKV / kRows) * (DH / DC) == kMaxWarps,
                "four shares of 16 keys x DC columns");
};

constexpr int NT = kSub / 8;   // n-tiles of one 16-key step

// The scores of a warp's 16 rows (row[0], row[1] are this lane's two rows,
// r0 + g and r0 + g + 8 of the block's staged rows) against keys c0 .. c0 +
// 15 of the staged tile of keys kv0 .. kv0 + nkv - 1: read from the emitted
// S, or rebuilt through the forward's chain.  With LDT 0 S and S_prev are
// read from global memory (scored_bwd_dq); otherwise `tile` holds the
// block's S where it was emitted, else its S_prev, in shared memory, rows
// LDT floats apart from the first staged row and key kv0 (scored_bwd_dkv).
// Entries past Lq or past nkv are -FLT_MAX.
template <int DH, int LDT>
__device__ __forceinline__ void step_scores(
    const Args& a, const float* sQ, int r0, const float* sK, const float* sNeg,
    const float* tile, const int (&row)[2], size_t head_row0, int kv0,
    int nkv, int c0, float cv, float scale, float (&s)[NT][4]) {
  constexpr int LD = Bucket<DH>::LD;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  if (!a.s) score_dots<DH, NT, LD>(sQ, r0, sK, c0, s);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hr = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
      if (row[hr] < a.Lq && col < nkv) {
        if constexpr (LDT == 0) {
          const size_t off =
              (head_row0 + row[hr]) * (size_t)a.Lkv + kv0 + col;
          s[j][e] = a.s ? a.s[off]
                        : chained_score(s[j][e], scale,
                                        a.sprev ? a.sprev + off : nullptr, cv,
                                        sNeg[col]);
        } else {
          const float* at = tile + (r0 + g + 8 * hr) * LDT + col;
          s[j][e] = a.s ? *at
                        : chained_score(s[j][e], scale, a.sprev ? at : nullptr,
                                        cv, sNeg[col]);
        }
      } else {
        s[j][e] = -FLT_MAX;
      }
    }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
scored_bwd_dq_kernel(Args a, float scale) {
  constexpr int BKV = Bucket<DH>::BKV, LD = Bucket<DH>::LD;
  constexpr int NO = DH / 8;
  const int warps = blockDim.x / 32;
  const int BQ = kRows * warps;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BKV * LD;
  float* sNeg = sV + BKV * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lq = a.Lq, Lkv = a.Lkv, H = a.H, dh = a.dh;
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const T* kb = static_cast<const T*>(a.k) + (size_t)b * Lkv * D + (size_t)h * dh;
  const T* vb = static_cast<const T*>(a.v) + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = a.mask ? a.mask + (size_t)b * Lkv : nullptr;
  const float cv = a.sprev ? to_f32(static_cast<const T*>(a.c)[0]) : 0.f;
  // row (b, h, i) of the score tensors starts at (head_row0 + i) * Lkv
  const size_t head_row0 = ((size_t)b * H + h) * Lq;
  const size_t n_rows = (size_t)a.B * H * Lq;

  if (!a.s) stage<T, DH, LD>(sQ, static_cast<const T*>(a.q) + qoff, D, q0, BQ,
                             Lq - q0, dh, a.vec);
  stage<T, DH, LD>(sdO, static_cast<const T*>(a.dout) + qoff, D, q0, BQ,
                   Lq - q0, dh, a.vec);
  stage_wait();
  __syncthreads();

  const int r0 = kRows * warp;
  const bool active = q0 + r0 < Lq;
  const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  // stage K, V and the penalties of keys kv0 .. kv0 + nkv - 1
  auto stage_kv = [&](int kv0, int nkv, bool with_v) {
    __syncthreads();  // the last tile's readers are done
    stage<T, DH, LD>(sK, kb, D, kv0, BKV, nkv, dh, a.vec);
    if (with_v) stage<T, DH, LD>(sV, vb, D, kv0, BKV, nkv, dh, a.vec);
    for (int j = threadIdx.x; j < BKV; j += blockDim.x)
      sNeg[j] = j < nkv ? mask_penalty(mb, kv0 + j) : 0.f;
    stage_wait();
    __syncthreads();
  };

  // the row stats: the forward's, or one sweep over the keys.  A bf16
  // input's ctx comes back rounded to bf16, and dctx . ctx with it missed
  // f32's delta by up to 8e-2 of dk in fully masked rows (measured in f64),
  // so at bf16 the sweep always runs and takes delta = sum p dp online too
  constexpr bool kSweepDelta = sizeof(T) < sizeof(float);
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, pdp[2] = {0.f, 0.f};
  if (a.stats_in && !kSweepDelta) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (row[hr] < Lq) {
        m[hr] = a.stats_in[head_row0 + row[hr]];
        l[hr] = a.stats_in[n_rows + head_row0 + row[hr]];
      }
  } else {
    for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
      const int nkv = min(BKV, Lkv - kv0);
      if (!a.s || kSweepDelta) stage_kv(kv0, nkv, kSweepDelta);
      if (!active) continue;
#pragma unroll 1
      for (int c0 = 0; c0 < nkv; c0 += kSub) {
        float s[NT][4], dp[NT][4];
        step_scores<DH, 0>(a, sQ, r0, sK, sNeg, nullptr, row, head_row0, kv0,
                           nkv, c0, cv, scale, s);
        if constexpr (kSweepDelta) score_dots<DH, NT, LD>(sdO, r0, sV, c0, dp);
        float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.f, 0.f};
        float sdp[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        float m_new[2];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          m_new[hr] = fmaxf(m[hr], quad_max(mx[hr]));
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (c0 + 8 * j + 2 * t + (e & 1) < nkv) {
              const float p = expf(s[j][e] - m_new[e >> 1]);
              sum[e >> 1] += p;
              if constexpr (kSweepDelta)
                sdp[e >> 1] = fmaf(p, dp[j][e], sdp[e >> 1]);
            }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          l[hr] = l[hr] * expf(m[hr] - m_new[hr]) + quad_sum(sum[hr]);
          if constexpr (kSweepDelta)
            pdp[hr] = pdp[hr] * expf(m[hr] - m_new[hr]) + quad_sum(sdp[hr]);
          m[hr] = m_new[hr];
        }
      }
    }
  }

  // delta: the sweep's sum p dp at bf16, else dctx . ctx per row (lane pair
  // (2r, 2r + 1) sums halves of row r)
  float delta[2] = {0.f, 0.f};
  if constexpr (kSweepDelta) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      if (row[hr] < Lq) delta[hr] = pdp[hr] / l[hr];
  } else if (active) {
    const int r = lane >> 1, d0 = (lane & 1) * (DH / 2);
    float part = 0.f;
    if (q0 + r0 + r < Lq) {
      const T* orow = static_cast<const T*>(a.o) + qoff + (size_t)(q0 + r0 + r) * D;
      const float* drow = sdO + (r0 + r) * LD;
      for (int d = d0; d < min(d0 + DH / 2, dh); ++d)
        part = fmaf(drow[d], to_f32(orow[d]), part);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    delta[0] = __shfl_sync(0xffffffffu, part, 2 * g);
    delta[1] = __shfl_sync(0xffffffffu, part, 2 * (g + 8));
  }
  float inv_l[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)   // l >= 1: scored_fwd's fast reciprocal
    inv_l[hr] = row[hr] < Lq ? __fdividef(1.f, l[hr]) : 0.f;

  // the sweep: ds, dS_prev and dc, then dq += ds k
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float dc_acc = 0.f;
  for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
    const int nkv = min(BKV, Lkv - kv0);
    stage_kv(kv0, nkv, true);
    if (!active) continue;
#pragma unroll 1
    for (int c0 = 0; c0 < nkv; c0 += kSub) {
      float s[NT][4], dp[NT][4];
      step_scores<DH, 0>(a, sQ, r0, sK, sNeg, nullptr, row, head_row0, kv0,
                         nkv, c0, cv, scale, s);
      score_dots<DH, NT, LD>(sdO, r0, sV, c0, dp);
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int hr = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
          float ds = 0.f;
          if (row[hr] < Lq && col < nkv) {
            const size_t off = (head_row0 + row[hr]) * (size_t)Lkv + kv0 + col;
            const float p = expf(s[j][e] - m[hr]) * inv_l[hr];
            ds = p * (dp[j][e] - delta[hr]);
            if (a.dsc) ds += a.dsc[off];
            if (a.sprev) {
              a.dsprev[off] = cv * ds;
              dc_acc = fmaf(ds, a.sprev[off], dc_acc);
            }
          }
          s[j][e] = ds;
        }
      mma_regA<DH, NT, LD>(acc, s, sK, c0);
    }
  }
  if (!active) return;

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (row[hr] >= Lq) continue;
    T* out = static_cast<T*>(a.dq) + qoff + (size_t)row[hr] * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < dh) store(out + d, acc[n][2 * hr + e] * scale);
      }
    if (t == 0) {
      const size_t i = head_row0 + row[hr];
      a.stats[i] = m[hr];
      a.stats[n_rows + i] = l[hr];
      a.stats[2 * n_rows + i] = delta[hr];
    }
  }
  if (a.sprev) {
    const float total = warp_sum(dc_acc);
    if (lane == 0)
      a.dcpart[((size_t)b * H + h) * q_slabs(Lq) + (q0 + r0) / kRows] = total;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
scored_bwd_dkv_kernel(Args a, float scale) {
  using Ti = DkvTiles<DH>;
  constexpr int BKV = Ti::BKV, LD = Ti::LD, LDP = Ti::LDP, DC = Ti::DC;
  constexpr int NC = DC / 8, BQ = kDkvRows;

  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BKV * LD;
  float* sQ = sV + BKV * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;
  float* sDS = sP + BQ * LDP;
  float* sNeg = sDS + BQ * LDP;
  float* sM = sNeg + BKV;
  float* sIL = sM + BQ;
  float* sDelta = sIL + BQ;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int g = lane >> 2, t = lane & 3;
  const int kv0 = blockIdx.x * BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lq = a.Lq, Lkv = a.Lkv, H = a.H, dh = a.dh;
  const int nkv = min(BKV, Lkv - kv0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const size_t kvoff = (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = a.mask ? a.mask + (size_t)b * Lkv : nullptr;
  const float cv = a.sprev ? to_f32(static_cast<const T*>(a.c)[0]) : 0.f;
  const size_t head_row0 = ((size_t)b * H + h) * Lq;
  const size_t n_rows = (size_t)a.B * H * Lq;

  // dc: the first block sums scored_bwd_dq's partials in a fixed order
  if (a.dc && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0) {
    const size_t n = (size_t)a.B * H * q_slabs(Lq);
    float part = 0.f;
    for (size_t i = tid; i < n; i += blockDim.x) part += a.dcpart[i];
    part = warp_sum(part);
    __shared__ float red[kMaxWarps];
    if (lane == 0) red[warp] = part;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int w = 0; w < kMaxWarps; ++w) total += red[w];
      a.dc[0] = total;
    }
  }

  stage<T, DH, LD>(sK, static_cast<const T*>(a.k) + kvoff, D, kv0, BKV, nkv,
                   dh, a.vec);
  stage<T, DH, LD>(sV, static_cast<const T*>(a.v) + kvoff, D, kv0, BKV, nkv,
                   dh, a.vec);
  for (int j = tid; j < BKV; j += blockDim.x)
    sNeg[j] = j < nkv ? mask_penalty(mb, kv0 + j) : 0.f;

  // this warp's share of dk and dv: keys ks .. ks + 15, columns c0 .. c0 + DC - 1
  const int ks = kRows * (warp / (DH / DC)), c0 = DC * (warp % (DH / DC));
  float dk_acc[NC][4], dv_acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  float dm_acc = 0.f;   // column tid of this tile, for tid < BKV
  const int r0 = kRows * warp;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int nq = min(BQ, Lq - q0);
    __syncthreads();  // the last step's sQ / sdO / sP / sDS readers are done
    stage<T, DH, LD>(sQ, static_cast<const T*>(a.q) + qoff, D, q0, BQ, nq, dh,
                     a.vec);
    stage<T, DH, LD>(sdO, static_cast<const T*>(a.dout) + qoff, D, q0, BQ, nq,
                     dh, a.vec);
    // the step's S (or the S_prev that rebuilds s) into sP and dS into sDS,
    // in flight with Q and dO: each element is read, then overwritten with
    // p or ds, by one lane
    const size_t at = (head_row0 + q0) * (size_t)Lkv + kv0;
    if (a.s || a.sprev)
      stage_scores<LDP>(sP, (a.s ? a.s : a.sprev) + at, Lkv, nq, nkv);
    if (a.dsc) stage_scores<LDP>(sDS, a.dsc + at, Lkv, nq, nkv);
    for (int i = tid; i < BQ; i += blockDim.x) {
      const size_t r = head_row0 + q0 + i;
      sM[i] = i < nq ? a.stats[r] : 0.f;
      sIL[i] = i < nq ? __fdividef(1.f, a.stats[n_rows + r]) : 0.f;
      sDelta[i] = i < nq ? a.stats[2 * n_rows + r] : 0.f;
    }
    stage_wait();
    __syncthreads();

    // p and ds of this warp's 16 rows into sP / sDS
    if (r0 < nq) {
      const int row[2] = {q0 + r0 + g, q0 + r0 + g + 8};
#pragma unroll 1
      for (int c0 = 0; c0 < BKV; c0 += kSub) {
        float s[NT][4], dp[NT][4];
        step_scores<DH, LDP>(a, sQ, r0, sK, sNeg, sP, row, head_row0, kv0,
                             nkv, c0, cv, scale, s);
        score_dots<DH, NT, LD>(sdO, r0, sV, c0, dp);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hr = e >> 1, col = c0 + 8 * j + 2 * t + (e & 1);
            const int rl = r0 + g + 8 * hr;   // row in the step
            float p = 0.f, ds = 0.f;
            if (rl < nq && col < nkv) {
              p = expf(s[j][e] - sM[rl]) * sIL[rl];
              ds = p * (dp[j][e] - sDelta[rl]);
              if (a.dsc) ds += sDS[rl * LDP + col];
            }
            sP[rl * LDP + col] = p;
            sDS[rl * LDP + col] = ds;
          }
      }
    } else {
      for (int i = lane; i < kRows * BKV; i += 32) {
        sP[(r0 + i / BKV) * LDP + i % BKV] = 0.f;
        sDS[(r0 + i / BKV) * LDP + i % BKV] = 0.f;
      }
    }
    __syncthreads();

    mma_transA<BQ, NC, LDP, LD>(dv_acc, sP, ks, sdO, c0);
    mma_transA<BQ, NC, LDP, LD>(dk_acc, sDS, ks, sQ, c0);
    if (a.dmh && tid < BKV)
      for (int i = 0; i < nq; ++i) dm_acc += sDS[i * LDP + tid];
  }

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int key = ks + g + 8 * hr;
    if (key >= nkv) continue;
    const size_t off = kvoff + (size_t)(kv0 + key) * D;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = c0 + 8 * n + 2 * t + e;
        if (d < dh) {
          store(static_cast<T*>(a.dk) + off + d, dk_acc[n][2 * hr + e] * scale);
          store(static_cast<T*>(a.dv) + off + d, dv_acc[n][2 * hr + e]);
        }
      }
  }
  if (a.dmh && tid < nkv)
    a.dmh[((size_t)b * H + h) * Lkv + kv0 + tid] = kMaskPenalty * dm_acc;
}

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = allow_smem(scored_bwd_dq_kernel<T, DH>,
                               dq_smem<DH>(kMaxWarps), smem_set);
  if (err != cudaSuccess) return err;
  const int warps = pick_warps(a.Lq, a.H, a.B);
  const int bq = kRows * warps;
  const dim3 grid((a.Lq + bq - 1) / bq, a.H, a.B);
  scored_bwd_dq_kernel<T, DH><<<grid, 32 * warps, dq_smem<DH>(warps), a.stream>>>(
      a, score_scale(a.dh));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err = allow_smem(scored_bwd_dkv_kernel<T, DH>, DkvTiles<DH>::smem,
                               smem_set);
  if (err != cudaSuccess) return err;
  constexpr int BKV = DkvTiles<DH>::BKV;
  const dim3 grid((a.Lkv + BKV - 1) / BKV, a.H, a.B);
  scored_bwd_dkv_kernel<T, DH><<<grid, 32 * kMaxWarps, DkvTiles<DH>::smem,
                                 a.stream>>>(a, score_scale(a.dh));
  return cudaGetLastError();
}

// scored_fwd's head-width buckets: the same DH gives the same score chain,
// so a rebuilt score equals the forward's
template <bool DKV, typename T>
cudaError_t dispatch(const Args& a) {
  if (a.dh <= 16) return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
  if (a.dh <= 32) return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (a.dh <= 64) return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.dh <= 128) return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  return DKV ? launch_dkv<T, 256>(a) : launch_dq<T, 256>(a);
}

template <bool DKV>
int run(Args a, int is_bf16) {
  a.vec = vec_ok(is_bf16, a.dh, {a.q, a.k, a.v, a.dout});
  if (a.B < 1 || a.H < 1 || a.Lq < 1 || a.Lkv < 1 || a.dh < 1 ||
      a.dh > 256 || a.B > 65535 || a.H > 65535 || a.stats == nullptr ||
      (a.sprev != nullptr && a.c == nullptr) ||
      (!DKV && (a.o == nullptr ||
                (a.sprev != nullptr &&
                 (a.dsprev == nullptr || a.dcpart == nullptr)))) ||
      (DKV && a.dc != nullptr && a.dcpart == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<DKV, __nv_bfloat16>(a)
                       : dispatch<DKV, float>(a));
}

}  // namespace

// Each returns a cudaError_t as int: 0 when the kernel was launched.  s (the
// emitted S) null selects the variants that rebuild s from q, k, the mask
// and S_prev; dscores (the cotangent of S) may be null; s_prev null selects
// the variants without the residual term.  ctx is the forward's output.
// stats_in is the forward's (2, B, H, Lq) row stats or null; stats is
// (3, B, H, Lq) f32: scored_bwd_dq writes it, scored_bwd_dkv reads it.  With
// s_prev, scored_bwd_dq writes ds_prev (B, H, Lq, Lkv) f32 and one dc
// partial per 16-row slab into dc_part (B, H, ceil(Lq / 16)) f32.
extern "C" int scored_bwd_dq(const void* q, const void* k, const void* v,
                             const void* mask, const void* s,
                             const void* dscores, const void* s_prev,
                             const void* c, const void* dctx, const void* ctx,
                             const void* stats_in, void* stats, void* dq,
                             void* ds_prev, void* dc_part, int B, int H,
                             int Lq, int Lkv, int dh, int is_bf16,
                             void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.s = static_cast<const float*>(s);
  a.dsc = static_cast<const float*>(dscores);
  a.sprev = static_cast<const float*>(s_prev);
  a.c = c; a.dout = dctx; a.o = ctx;
  a.stats_in = static_cast<const float*>(stats_in);
  a.stats = static_cast<float*>(stats);
  a.dq = dq;
  a.dsprev = static_cast<float*>(ds_prev);
  a.dcpart = static_cast<float*>(dc_part);
  a.B = B; a.H = H; a.Lq = Lq; a.Lkv = Lkv; a.dh = dh;
  a.stream = static_cast<cudaStream_t>(stream);
  return run<false>(a, is_bf16);
}

// dmh, the per-head rows 1e8 sum_i ds (B, H, Lkv) f32, may be null; dc (one
// f32) is null or written from dc_part, the partials scored_bwd_dq wrote.
extern "C" int scored_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* mask, const void* s,
                              const void* dscores, const void* s_prev,
                              const void* c, const void* dctx,
                              const void* stats, const void* dc_part,
                              void* dk, void* dv, void* dmh, void* dc, int B,
                              int H, int Lq, int Lkv, int dh, int is_bf16,
                              void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v;
  a.mask = static_cast<const float*>(mask);
  a.s = static_cast<const float*>(s);
  a.dsc = static_cast<const float*>(dscores);
  a.sprev = static_cast<const float*>(s_prev);
  a.c = c; a.dout = dctx;
  a.stats = static_cast<float*>(const_cast<void*>(stats));
  a.dcpart = static_cast<float*>(const_cast<void*>(dc_part));
  a.dk = dk; a.dv = dv;
  a.dmh = static_cast<float*>(dmh);
  a.dc = static_cast<float*>(dc);
  a.B = B; a.H = H; a.Lq = Lq; a.Lkv = Lkv; a.dh = dh;
  a.stream = static_cast<cudaStream_t>(stream);
  return run<true>(a, is_bf16);
}
