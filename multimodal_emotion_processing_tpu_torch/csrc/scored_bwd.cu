// Score-chained (RealFormer) attention backward, written for Hopper (sm_90a):
// two kernels in the FlashAttention-2 split, each deterministic (no atomics).
//
// Replace the backward Pallas kernel of the JAX package,
// multimodal_emotion_processing_tpu/ops/pallas_attention.py:
//   _backward_pallas (:303-361, pallas_call at :350; kernel
//   _make_bwd_kernel :201-286), in all four of its variants (has S_prev x
//   emits S, `_make` :407-519), together:
//   scored_bwd_dq   row stats, dS_prev, the dc partials and dq
//   scored_bwd_dkv  dk, dv and the per-head dmask rows
//
// Per batch row b, head h, query row i and key j < Lkv:
//   s       = S[b, h, i, j] when the forward emitted S; otherwise rebuilt
//             exactly as csrc/scored_fwd.cu computes it (flash_common.cuh
//             `chained_score`: q.k * scale (+ c * S_prev) - 1e8 (1 - mask),
//             each step rounded on its own), bit for bit
//   m_i, l_i = max_j s, sum_j exp(s - m_i)   over the Lkv real keys
//   p       = exp(s - m_i) * (1 / l_i)
//   dp      = dctx_i . v_j
//   delta_i = sum_j p dp                     (as JAX :265)
//   ds      = p (dp - delta_i) (+ dS[b, h, i, j], the cotangent of the
//             emitted S, when there is one)
//   dS_prev = c ds                           f32, when S_prev is given
//   dc      = sum ds S_prev                  one partial per block of
//                                            scored_bwd_dq; the caller sums
//   dq_i    = sum_j ds k_j / sqrt(dh)        (scored_bwd_dq)
//   dk_j    = sum_i ds q_i / sqrt(dh)        (scored_bwd_dkv)
//   dv_j    = sum_i p dctx_i                 (scored_bwd_dkv)
//   dmh[b, h, j] = sum_i ds                  (scored_bwd_dkv, when asked for;
//                  the 1e8 and the sum over heads are the caller's)
// all accumulated in f32; dq, dk and dv are stored at the input dtype.
// scored_bwd_dq takes m, l and delta in one sweep over the keys (online
// max, with the sums of exp(s - m) and exp(s - m) dp rescaled as m moves),
// then a second sweep computes ds; it writes (m, l, delta) per row for
// scored_bwd_dkv, which rebuilds the same p and ds from them.  The forward
// keeps no row stats, so S is only materialized where the TPU kernel had it
// (the emitted variants), never rebuilt whole.  Columns at or past Lkv and
// rows at or past Lq are skipped, never padded, so a fully masked row is a
// softmax over its Lkv real keys, as in the forward.
//
// Layout: q and dctx (B, Lq, H*dh), k and v (B, Lkv, H*dh), all row-major
// and contiguous, heads read by stride; mask (B, Lkv) f32 or null; S, dS,
// S_prev and dS_prev (B, H, Lq, Lkv) f32; stats (3, B, H, Lq) f32 (m, l,
// delta); the gate c one value of the input dtype on the device.
// scored_bwd_dq: grid (q tiles) x H x B, each block sweeps the kv tiles
// twice and keeps dq in registers.  scored_bwd_dkv: grid (kv tiles) x H x B,
// each block loops over q tiles and keeps dk, dv and its dmask row in
// registers.  Block: 256 threads as 16 x 16, scored_fwd's mapping; sixteen
// neighbouring threads touch sixteen neighbouring floats of a row of S,
// dS, S_prev or dS_prev.
//
// What bounds it on an H100: per (b, h), 8 Lq Lkv dh flops for the four
// products (10 where s is rebuilt) against (2 Lq + 2 Lkv) dh elements read,
// (Lq + 2 Lkv) dh written and 2 Lq Lkv f32 score elements moved (S and dS
// read, or S_prev read and dS_prev written).  At the mosei_realformer
// training shapes (dh 16, Lq = Lkv = 50, f32) that is ~3 flops per byte,
// far below the card's f32 ridge of ~20, so the bytes bound it, and the
// two score tensors are most of them (46 of 98 MB a call at B 384).  This
// first version does every product with scalar f32 FMAs out of shared
// memory and rebuilds s and dp in both kernels (dq sweeps the keys twice),
// so it moves the score tensors two to three times; tensor cores and a
// single pass are the work that makes it fast.

#include <float.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

template <int DH, int BQ_, int BKV_>
struct BwdTiles {
  static constexpr int BQ = BQ_;                   // query rows per tile
  static constexpr int BKV = BKV_;                 // keys per tile
  static constexpr int LDS = DH + 1;               // padded rows
  static constexpr int LDP = BKV + 1;
  static constexpr int RM = BQ / kTY;              // score rows per thread
  static constexpr int CN = BKV / kTX;             // score columns per thread
  static constexpr int DN = DH / kTX;              // head columns per thread
  static constexpr int RK = BKV / kTY;             // dk/dv rows per thread
  // scored_bwd_dq: sQ, sdO, sK, sV, sDS, penalties
  static constexpr size_t dq_smem =
      sizeof(float) * (size_t)(2 * BQ * LDS + 2 * BKV * LDS + BQ * LDP + BKV);
  // scored_bwd_dkv: the same, sP and the m / l / delta rows
  static constexpr size_t dkv_smem =
      dq_smem + sizeof(float) * (size_t)(BQ * LDP + 3 * BQ);
};

// csrc/flash_bwd.cu's tile sizes: shared memory stays under ~140 KB up to
// dh 256, with at least two blocks per SM up to dh 64
template <int DH>
using DqTiles = BwdTiles<DH, DH <= 128 ? 64 : 32, DH <= 64 ? 64 : 32>;
template <int DH>
using DkvTiles = BwdTiles<DH, 32, DH <= 64 ? 64 : 32>;

struct Args {
  const void *q, *k, *v;
  const float *mask, *s, *dsc, *sprev;
  const void *c, *dout;
  float* stats;
  void *dq, *dk, *dv;
  float *dsprev, *dcpart, *dmh;
  int B, H, Lq, Lkv, dh;
  cudaStream_t stream;
};

// the score of entry (row, col) of a tile: read from the emitted S, or
// rebuilt from the raw dot as the forward computed it.  `off` is the
// entry's index in (B, H, Lq, Lkv).
__device__ __forceinline__ float tile_score(const float* s_in, float dot,
                                            float scale, const float* sprev,
                                            float c, float neg, size_t off) {
  return s_in ? s_in[off]
              : chained_score(dot, scale, sprev ? sprev + off : nullptr, c, neg);
}

// the sum of x over the block's 256 threads, in thread 0
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  return total;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
scored_bwd_dq_kernel(Args a, float scale) {
  using Ti = DqTiles<DH>;
  constexpr int BQ = Ti::BQ, BKV = Ti::BKV, LDS = Ti::LDS, LDP = Ti::LDP;
  constexpr int RM = Ti::RM, CN = Ti::CN, DN = Ti::DN;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LDS;
  float* sK = sdO + BQ * LDS;
  float* sV = sK + BKV * LDS;
  float* sDS = sV + BKV * LDS;
  float* sNeg = sDS + BQ * LDP;
  __shared__ float red[kThreads / 32];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lq = a.Lq, Lkv = a.Lkv, H = a.H, dh = a.dh;
  const int nq = min(BQ, Lq - q0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const T* kb = static_cast<const T*>(a.k) + (size_t)b * Lkv * D + (size_t)h * dh;
  const T* vb = static_cast<const T*>(a.v) + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = a.mask ? a.mask + (size_t)b * Lkv : nullptr;
  const bool rebuild = a.s == nullptr;
  const float cv = a.sprev ? to_f32(static_cast<const T*>(a.c)[0]) : 0.f;
  // row (b, h, i) of the score tensors starts at (head_row0 + i) * Lkv
  const size_t head_row0 = ((size_t)b * H + h) * Lq;

  stage_rows<T, DH, LDS>(sQ, static_cast<const T*>(a.q) + qoff, D, q0, BQ,
                         nq, dh);
  stage_rows<T, DH, LDS>(sdO, static_cast<const T*>(a.dout) + qoff, D, q0,
                         BQ, nq, dh);

  // the score and dp tiles of keys kv0 .. kv0 + nkv: stages the tile, then
  // every thread's entries; s[r][c] holds the score, dp[r][c] dctx . v
  auto tile = [&](int kv0, int nkv, float (&s)[RM][CN], float (&dp)[RM][CN]) {
    __syncthreads();  // the last tile's sK / sV / sDS readers are done
    if (rebuild) stage_rows<T, DH, LDS>(sK, kb, D, kv0, BKV, nkv, dh);
    stage_rows<T, DH, LDS>(sV, vb, D, kv0, BKV, nkv, dh);
    for (int c = tid; c < BKV; c += kThreads)
      sNeg[c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;
    __syncthreads();
    tile_dots<DH, RM, CN, LDS>(sdO, sV, tx, ty, dp);
    if (rebuild) tile_dots<DH, RM, CN, LDS>(sQ, sK, tx, ty, s);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty + kTY * r;
      const size_t srow = (head_row0 + q0 + row) * (size_t)Lkv + kv0;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = tx + kTX * c;
        if (!rebuild) s[r][c] = 0.f;   // the score is read from S
        s[r][c] = (row < nq && col < nkv)
                      ? tile_score(a.s, s[r][c], scale, a.sprev, cv, sNeg[col],
                                   srow + col)
                      : -FLT_MAX;
      }
    }
  };

  // sweep 1: the row stats m, l and delta, online
  float m_run[RM], l_run[RM], d_run[RM];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = d_run[r] = 0.f;
  }
  for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
    const int nkv = min(BKV, Lkv - kv0);
    float s[RM][CN], dp[RM][CN];
    tile(kv0, nkv, s, dp);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int c = 0; c < CN; ++c) mx = fmaxf(mx, s[r][c]);
      // every tile holds a real column, so a real row's max is finite
      const float m_new = fmaxf(m_run[r], half_warp_max(mx));
      const float alpha = expf(m_run[r] - m_new);
      float sum = 0.f, sdp = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const float e = tx + kTX * c < nkv ? expf(s[r][c] - m_new) : 0.f;
        sum += e;
        sdp = fmaf(e, dp[r][c], sdp);
      }
      l_run[r] = l_run[r] * alpha + half_warp_sum(sum);
      d_run[r] = d_run[r] * alpha + half_warp_sum(sdp);
      m_run[r] = m_new;
    }
  }
  float inv_l[RM], delta[RM];
  const size_t n_rows = (size_t)a.B * H * Lq;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty + kTY * r;
    inv_l[r] = row < nq ? 1.f / l_run[r] : 0.f;  // l >= 1 in a real row
    delta[r] = row < nq ? d_run[r] / l_run[r] : 0.f;
    if (tx == 0 && row < nq) {
      const size_t i = head_row0 + q0 + row;
      a.stats[i] = m_run[r];
      a.stats[n_rows + i] = l_run[r];
      a.stats[2 * n_rows + i] = delta[r];
    }
  }

  // sweep 2: ds, dS_prev and dc, then dq += ds k
  float acc[RM][DN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[r][j] = 0.f;
  float dc_acc = 0.f;
  for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
    const int nkv = min(BKV, Lkv - kv0);
    float s[RM][CN], dp[RM][CN];
    if (!rebuild) {   // dq needs k; the score sweep did not stage it
      __syncthreads();
      stage_rows<T, DH, LDS>(sK, kb, D, kv0, BKV, nkv, dh);
    }
    tile(kv0, nkv, s, dp);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty + kTY * r;
      const size_t srow = (head_row0 + q0 + row) * (size_t)Lkv + kv0;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = tx + kTX * c;
        float ds = 0.f;
        if (row < nq && col < nkv) {
          const float p = expf(s[r][c] - m_run[r]) * inv_l[r];
          ds = p * (dp[r][c] - delta[r]);
          if (a.dsc) ds += a.dsc[srow + col];
          if (a.sprev) {
            a.dsprev[srow + col] = cv * ds;
            dc_acc = fmaf(ds, a.sprev[srow + col], dc_acc);
          }
        }
        sDS[row * LDP + col] = ds;
      }
    }
    __syncthreads();
    for (int c = 0; c < nkv; ++c) {
      float dsv[RM], kv[DN];
#pragma unroll
      for (int r = 0; r < RM; ++r) dsv[r] = sDS[(ty + kTY * r) * LDP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) kv[j] = sK[c * LDS + tx + kTX * j];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[r][j] = fmaf(dsv[r], kv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty + kTY * r;
    if (row >= nq) continue;
    T* out = static_cast<T*>(a.dq) + qoff + (size_t)(q0 + row) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + kTX * j;
      if (d < dh) store(out + d, acc[r][j] * scale);
    }
  }
  if (a.sprev) {
    const float total = block_sum(dc_acc, red);
    if (tid == 0)
      a.dcpart[((size_t)b * H + h) * gridDim.x + blockIdx.x] = total;
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
scored_bwd_dkv_kernel(Args a, float scale) {
  using Ti = DkvTiles<DH>;
  constexpr int BQ = Ti::BQ, BKV = Ti::BKV, LDS = Ti::LDS, LDP = Ti::LDP;
  constexpr int RM = Ti::RM, CN = Ti::CN, DN = Ti::DN, RK = Ti::RK;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LDS;
  float* sK = sdO + BQ * LDS;
  float* sV = sK + BKV * LDS;
  float* sDS = sV + BKV * LDS;
  float* sNeg = sDS + BQ * LDP;
  float* sP = sNeg + BKV;
  float* sM = sP + BQ * LDP;
  float* sL = sM + BQ;
  float* sDelta = sL + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int kv0 = blockIdx.x * BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int Lq = a.Lq, Lkv = a.Lkv, H = a.H, dh = a.dh;
  const int nkv = min(BKV, Lkv - kv0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const size_t kvoff = (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = a.mask ? a.mask + (size_t)b * Lkv : nullptr;
  const bool rebuild = a.s == nullptr;
  const float cv = a.sprev ? to_f32(static_cast<const T*>(a.c)[0]) : 0.f;
  const size_t head_row0 = ((size_t)b * H + h) * Lq;
  const size_t n_rows = (size_t)a.B * H * Lq;

  stage_rows<T, DH, LDS>(sK, static_cast<const T*>(a.k) + kvoff, D, kv0, BKV,
                         nkv, dh);
  stage_rows<T, DH, LDS>(sV, static_cast<const T*>(a.v) + kvoff, D, kv0, BKV,
                         nkv, dh);
  for (int c = tid; c < BKV; c += kThreads)
    sNeg[c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;

  float dk_acc[RK][DN], dv_acc[RK][DN];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int j = 0; j < DN; ++j) dk_acc[r][j] = dv_acc[r][j] = 0.f;
  float dm_acc = 0.f;   // column tid of this tile, for tid < BKV

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    const int nq = min(BQ, Lq - q0);
    __syncthreads();  // the last tile's sQ / sdO / sP / sDS readers are done
    stage_rows<T, DH, LDS>(sQ, static_cast<const T*>(a.q) + qoff, D, q0, BQ,
                           nq, dh);
    stage_rows<T, DH, LDS>(sdO, static_cast<const T*>(a.dout) + qoff, D, q0,
                           BQ, nq, dh);
    for (int i = tid; i < BQ; i += kThreads) {
      const size_t row = head_row0 + q0 + i;
      sM[i] = i < nq ? a.stats[row] : 0.f;
      sL[i] = i < nq ? 1.f / a.stats[n_rows + row] : 0.f;
      sDelta[i] = i < nq ? a.stats[2 * n_rows + row] : 0.f;
    }
    __syncthreads();

    float s[RM][CN] = {}, dp[RM][CN];
    if (rebuild) tile_dots<DH, RM, CN, LDS>(sQ, sK, tx, ty, s);
    tile_dots<DH, RM, CN, LDS>(sdO, sV, tx, ty, dp);
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = ty + kTY * r;
      const size_t srow = (head_row0 + q0 + row) * (size_t)Lkv + kv0;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = tx + kTX * c;
        float p = 0.f, ds = 0.f;
        if (row < nq && col < nkv) {
          const size_t off = srow + col;
          const float x = tile_score(a.s, s[r][c], scale, a.sprev, cv,
                                     sNeg[col], off);
          p = expf(x - sM[row]) * sL[row];
          ds = p * (dp[r][c] - sDelta[row]);
          if (a.dsc) ds += a.dsc[off];
        }
        sP[row * LDP + col] = p;
        sDS[row * LDP + col] = ds;
      }
    }
    __syncthreads();

    for (int i = 0; i < nq; ++i) {
      float pv[RK], dsv[RK], dov[DN], qv[DN];
#pragma unroll
      for (int r = 0; r < RK; ++r) {
        pv[r] = sP[i * LDP + ty + kTY * r];
        dsv[r] = sDS[i * LDP + ty + kTY * r];
      }
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        dov[j] = sdO[i * LDS + tx + kTX * j];
        qv[j] = sQ[i * LDS + tx + kTX * j];
      }
#pragma unroll
      for (int r = 0; r < RK; ++r)
#pragma unroll
        for (int j = 0; j < DN; ++j) {
          dv_acc[r][j] = fmaf(pv[r], dov[j], dv_acc[r][j]);
          dk_acc[r][j] = fmaf(dsv[r], qv[j], dk_acc[r][j]);
        }
    }
    if (a.dmh && tid < BKV)
      for (int i = 0; i < nq; ++i) dm_acc += sDS[i * LDP + tid];
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int row = ty + kTY * r;
    if (row >= nkv) continue;
    const size_t off = kvoff + (size_t)(kv0 + row) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + kTX * j;
      if (d < dh) {
        store(static_cast<T*>(a.dk) + off + d, dk_acc[r][j] * scale);
        store(static_cast<T*>(a.dv) + off + d, dv_acc[r][j]);
      }
    }
  }
  if (a.dmh && tid < nkv)
    a.dmh[((size_t)b * H + h) * Lkv + kv0 + tid] = dm_acc;
}

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = DqTiles<DH>::dq_smem;
  cudaError_t err = cudaFuncSetAttribute(
      scored_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = DqTiles<DH>::BQ;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  scored_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      a, score_scale(a.dh));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = DkvTiles<DH>::dkv_smem;
  cudaError_t err = cudaFuncSetAttribute(
      scored_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BKV = DkvTiles<DH>::BKV;
  const dim3 grid((a.Lkv + BKV - 1) / BKV, a.H, a.B);
  scored_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      a, score_scale(a.dh));
  return cudaGetLastError();
}

// scored_fwd's head-width buckets: the same DH gives the same fmaf chain in
// `tile_dots`, so a rebuilt score equals the forward's
template <bool DKV, typename T>
cudaError_t dispatch(const Args& a) {
  if (a.dh <= 16) return DKV ? launch_dkv<T, 16>(a) : launch_dq<T, 16>(a);
  if (a.dh <= 32) return DKV ? launch_dkv<T, 32>(a) : launch_dq<T, 32>(a);
  if (a.dh <= 64) return DKV ? launch_dkv<T, 64>(a) : launch_dq<T, 64>(a);
  if (a.dh <= 128) return DKV ? launch_dkv<T, 128>(a) : launch_dq<T, 128>(a);
  return DKV ? launch_dkv<T, 256>(a) : launch_dq<T, 256>(a);
}

template <bool DKV>
int run(const Args& a, int is_bf16) {
  if (a.B < 1 || a.H < 1 || a.Lq < 1 || a.Lkv < 1 || a.dh < 1 ||
      a.dh > 256 || a.B > 65535 || a.H > 65535 || a.stats == nullptr ||
      (a.sprev != nullptr && a.c == nullptr) ||
      (!DKV && a.sprev != nullptr && (a.dsprev == nullptr || a.dcpart == nullptr)))
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<DKV, __nv_bfloat16>(a)
                       : dispatch<DKV, float>(a));
}

}  // namespace

// Each returns a cudaError_t as int: 0 when the kernel was launched.  s (the
// emitted S) null selects the variants that rebuild s from q, k, the mask
// and S_prev; dscores (the cotangent of S) may be null; s_prev null selects
// the variants without the residual term.  stats is (3, B, H, Lq) f32:
// scored_bwd_dq writes it, scored_bwd_dkv reads it.  With s_prev,
// scored_bwd_dq writes ds_prev (B, H, Lq, Lkv) f32 and one dc partial per
// block into dc_part (B, H, q tiles) f32.
extern "C" int scored_bwd_dq(const void* q, const void* k, const void* v,
                             const void* mask, const void* s,
                             const void* dscores, const void* s_prev,
                             const void* c, const void* dctx, void* stats,
                             void* dq, void* ds_prev, void* dc_part, int B,
                             int H, int Lq, int Lkv, int dh, int is_bf16,
                             void* stream) {
  const Args a{q, k, v,
               static_cast<const float*>(mask), static_cast<const float*>(s),
               static_cast<const float*>(dscores),
               static_cast<const float*>(s_prev), c, dctx,
               static_cast<float*>(stats), dq, nullptr, nullptr,
               static_cast<float*>(ds_prev), static_cast<float*>(dc_part),
               nullptr, B, H, Lq, Lkv, dh, static_cast<cudaStream_t>(stream)};
  return run<false>(a, is_bf16);
}

// dmh, the per-head rows sum_i ds (B, H, Lkv) f32, may be null
extern "C" int scored_bwd_dkv(const void* q, const void* k, const void* v,
                              const void* mask, const void* s,
                              const void* dscores, const void* s_prev,
                              const void* c, const void* dctx,
                              const void* stats, void* dk, void* dv,
                              void* dmh, int B, int H, int Lq, int Lkv,
                              int dh, int is_bf16, void* stream) {
  const Args a{q, k, v,
               static_cast<const float*>(mask), static_cast<const float*>(s),
               static_cast<const float*>(dscores),
               static_cast<const float*>(s_prev), c, dctx,
               static_cast<float*>(const_cast<void*>(stats)), nullptr, dk, dv,
               nullptr, nullptr, static_cast<float*>(dmh), B, H, Lq, Lkv, dh,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, is_bf16);
}
