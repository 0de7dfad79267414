// Flash attention backward for terminal attention blocks, written for Hopper
// (sm_90a): two kernels in the FlashAttention-2 split, each deterministic
// (no atomics), both reading the forward's saved row stats m and l.
//
// Replace the backward Pallas kernels of the JAX package,
// multimodal_emotion_processing_tpu/ops/flash_attention.py:
//   flash_bwd_dq   <- _flash_backward's dQ sweep (:568, _make_flash_dq_kernel)
//   flash_bwd_dkv  <- _flash_backward's dK/dV sweep (:596,
//                     _make_flash_dkv_kernel)
//   both together  <- _flash_backward_whole (:321, _make_whole_bwd_kernel),
//                     which rebuilt m and l from a whole score tile held in
//                     VMEM; here the kv loop is tiled, so m and l come from
//                     the forward (csrc/flash_fwd.cu's m_out / l_out).
//
// Per batch row b, head h, query row i and key j < Lkv, with s exactly the
// forward's score (flash_common.cuh: same fmaf order, bit for bit):
//   p      = exp(s - m_i) * (1 / l_i)        the softmax row
//   delta_i = sum_d do_i,d * o_i,d           recomputed per q tile
//   dp     = do_i . v_j
//   ds     = p (dp - delta_i)
//   dq_i   = sum_j ds k_j / sqrt(dh)         (flash_bwd_dq)
//   dk_j   = sum_i ds q_i / sqrt(dh)         (flash_bwd_dkv)
//   dv_j   = sum_i p do_i                    (flash_bwd_dkv)
//   dmask_h[b, h, j] = 1e8 sum_i ds          (flash_bwd_dkv; scores hold
//                      -1e8 (1 - mask), so d s / d mask = +1e8; the sum over
//                      heads is the caller's)
// all accumulated in f32; dq, dk and dv are stored at the input dtype, the
// dmask rows in f32.  Columns at or past Lkv and rows at or past Lq are
// skipped, never padded.
//
// Layout as the forward: q, o, do (B, Lq, H*dh), k, v (B, Lkv, H*dh), all
// contiguous, heads read by stride; mask (B, Lkv) f32 or null; m, l
// (B, H, Lq) f32.  flash_bwd_dq: grid (q tiles) x H x B, each block loops
// over kv tiles and keeps dq in registers.  flash_bwd_dkv: grid (kv tiles)
// x H x B, each block loops over q tiles and keeps dk, dv and its dmask row
// in registers.  Block: 256 threads as 16 x 16, the forward's mapping.
//
// What bounds it on an H100: 10 Lq Lkv dh flops per (b, h) for the five
// products against (3 Lq + 2 Lkv) dh elements read and (Lq + 2 Lkv) dh
// written: in bf16 that is ~100 to ~640 flops per byte at the s1024
// training shapes (L 128 to 512), so the bytes bound the small shapes and
// the tensor-core operations the large ones; in f32 it is the operations.
// This first version does every product with scalar f32 FMAs out of shared
// memory and recomputes s and dp in both kernels (14 instead of 10 Lq Lkv dh
// flops), so it runs far above either bound; wgmma tiles, TMA and a shared
// delta pass are the work that makes it fast.

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
  // flash_bwd_dq: sQ, sdO, sK, sV, sDS, m / l / delta rows, penalties
  static constexpr size_t dq_smem =
      sizeof(float) * (size_t)(2 * BQ * LDS + 2 * BKV * LDS + BQ * LDP +
                               3 * BQ + BKV);
  // flash_bwd_dkv: the same and sP
  static constexpr size_t dkv_smem = dq_smem + sizeof(float) * BQ * LDP;
};

// Tile sizes, chosen on an H100 at the s1024 shapes (dh 128): dq keeps 64
// query rows and stages 32-key tiles (108 KB, two blocks per SM); dkv stages
// 32 query rows per step, which keeps it at 75 KB and three blocks per SM
// (with 64 rows it needed 117 KB, one block per SM, and ran 2.5x slower).
template <int DH>
using DqTiles = BwdTiles<DH, DH <= 128 ? 64 : 32, DH <= 64 ? 64 : 32>;
template <int DH>
using DkvTiles = BwdTiles<DH, 32, DH <= 64 ? 64 : 32>;

// m and l of the tile's rows into shared memory (l = 1 past Lq)
__device__ __forceinline__ void stage_stats(float* sM, float* sL,
                                            const float* m, const float* l,
                                            size_t base, int rows, int nq) {
  for (int i = threadIdx.x; i < rows; i += kThreads) {
    sM[i] = i < nq ? m[base + i] : 0.f;
    sL[i] = i < nq ? l[base + i] : 1.f;
  }
}

// delta_i = sum_d do_i,d o_i,d for the tile's rows: half-warp ty sums rows
// ty + 16 r over d = tx + 16 j, reading do from shared memory and o from
// device memory
template <typename T, int BQ, int LDS>
__device__ __forceinline__ void stage_delta(float* sDelta, const float* sdO,
                                            const T* ob, size_t D, int q0,
                                            int nq, int dh) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  for (int r = ty; r < BQ; r += kTY) {
    float acc = 0.f;
    if (r < nq)
      for (int d = tx; d < dh; d += kTX)
        acc = fmaf(sdO[r * LDS + d], to_f32(ob[(size_t)(q0 + r) * D + d]), acc);
    acc = half_warp_sum(acc);
    if (tx == 0) sDelta[r] = acc;
  }
}

// p and ds of a (BQ x BKV) tile from the raw dots s = q.k and dp = do.v;
// thread (tx, ty) holds rows ty + 16 r and columns tx + 16 c.  Entries past
// nq rows or nkv columns are 0.
template <int RM, int CN, int LDP>
__device__ __forceinline__ void tile_p_ds(const float (&s)[RM][CN],
                                          const float (&dp)[RM][CN],
                                          const float* sNeg, const float* sM,
                                          const float* sL, const float* sDelta,
                                          float scale, int nq, int nkv,
                                          float* sP, float* sDS) {
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = ty + kTY * r;
    const bool real_row = row < nq;
    const float m = sM[row];
    const float inv_l = 1.f / sL[row];
    const float delta = sDelta[row];
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int col = tx + kTX * c;
      float p = 0.f, ds = 0.f;
      if (real_row && col < nkv) {
        p = expf(masked_score(s[r][c], scale, sNeg[col]) - m) * inv_l;
        ds = p * (dp[r][c] - delta);
      }
      if (sP) sP[row * LDP + col] = p;
      sDS[row * LDP + col] = ds;
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ mask,
                    const T* __restrict__ o, const T* __restrict__ dout,
                    const float* __restrict__ m, const float* __restrict__ l,
                    T* __restrict__ dq, int Lq, int Lkv, int H, int dh,
                    float scale) {
  using Ti = DqTiles<DH>;
  constexpr int BQ = Ti::BQ, BKV = Ti::BKV, LDS = Ti::LDS, LDP = Ti::LDP;
  constexpr int RM = Ti::RM, CN = Ti::CN, DN = Ti::DN;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LDS;
  float* sK = sdO + BQ * LDS;
  float* sV = sK + BKV * LDS;
  float* sDS = sV + BKV * LDS;
  float* sM = sDS + BQ * LDP;
  float* sL = sM + BQ;
  float* sDelta = sL + BQ;
  float* sNeg = sDelta + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Lq - q0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const T* kb = k + (size_t)b * Lkv * D + (size_t)h * dh;
  const T* vb = v + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;

  stage_rows<T, DH, LDS>(sQ, q + qoff, D, q0, BQ, nq, dh);
  stage_rows<T, DH, LDS>(sdO, dout + qoff, D, q0, BQ, nq, dh);
  stage_stats(sM, sL, m, l, ((size_t)b * H + h) * Lq + q0, BQ, nq);
  __syncthreads();
  stage_delta<T, BQ, LDS>(sDelta, sdO, o + qoff, D, q0, nq, dh);

  float acc[RM][DN];
#pragma unroll
  for (int r = 0; r < RM; ++r)
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[r][j] = 0.f;

  for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
    const int nkv = min(BKV, Lkv - kv0);
    __syncthreads();  // the last tile's sK / sDS readers are done
    stage_rows<T, DH, LDS>(sK, kb, D, kv0, BKV, nkv, dh);
    stage_rows<T, DH, LDS>(sV, vb, D, kv0, BKV, nkv, dh);
    for (int c = tid; c < BKV; c += kThreads)
      sNeg[c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    tile_dots<DH, RM, CN, LDS>(sQ, sK, tx, ty, s);
    tile_dots<DH, RM, CN, LDS>(sdO, sV, tx, ty, dp);
    tile_p_ds<RM, CN, LDP>(s, dp, sNeg, sM, sL, sDelta, scale, nq, nkv,
                           nullptr, sDS);
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
    T* out = dq + qoff + (size_t)(q0 + row) * D;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + kTX * j;
      if (d < dh) store(out + d, acc[r][j] * scale);
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ mask,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dmh, int Lq, int Lkv, int H, int dh,
                     float scale) {
  using Ti = DkvTiles<DH>;
  constexpr int BQ = Ti::BQ, BKV = Ti::BKV, LDS = Ti::LDS, LDP = Ti::LDP;
  constexpr int RM = Ti::RM, CN = Ti::CN, DN = Ti::DN, RK = Ti::RK;

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LDS;
  float* sK = sdO + BQ * LDS;
  float* sV = sK + BKV * LDS;
  float* sDS = sV + BKV * LDS;
  float* sM = sDS + BQ * LDP;
  float* sL = sM + BQ;
  float* sDelta = sL + BQ;
  float* sNeg = sDelta + BQ;
  float* sP = sNeg + BKV;

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int kv0 = blockIdx.x * BKV;
  const int h = blockIdx.y, b = blockIdx.z;
  const int nkv = min(BKV, Lkv - kv0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const size_t kvoff = (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;

  stage_rows<T, DH, LDS>(sK, k + kvoff, D, kv0, BKV, nkv, dh);
  stage_rows<T, DH, LDS>(sV, v + kvoff, D, kv0, BKV, nkv, dh);
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
    stage_rows<T, DH, LDS>(sQ, q + qoff, D, q0, BQ, nq, dh);
    stage_rows<T, DH, LDS>(sdO, dout + qoff, D, q0, BQ, nq, dh);
    stage_stats(sM, sL, m, l, ((size_t)b * H + h) * Lq + q0, BQ, nq);
    __syncthreads();
    stage_delta<T, BQ, LDS>(sDelta, sdO, o + qoff, D, q0, nq, dh);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
    tile_dots<DH, RM, CN, LDS>(sQ, sK, tx, ty, s);
    tile_dots<DH, RM, CN, LDS>(sdO, sV, tx, ty, dp);
    tile_p_ds<RM, CN, LDP>(s, dp, sNeg, sM, sL, sDelta, scale, nq, nkv, sP,
                           sDS);
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
    if (dmh && tid < BKV)
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
        store(dk + off + d, dk_acc[r][j] * scale);
        store(dv + off + d, dv_acc[r][j]);
      }
    }
  }
  if (dmh && tid < nkv)
    dmh[((size_t)b * H + h) * Lkv + kv0 + tid] = kMaskPenalty * dm_acc;
}

struct Args {
  const void *q, *k, *v, *mask, *o, *dout, *m, *l;
  void *dq, *dk, *dv, *dmh;
  int B, H, Lq, Lkv, dh;
  cudaStream_t stream;
};

template <typename T, int DH>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = DqTiles<DH>::dq_smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BQ = DqTiles<DH>::BQ;
  const dim3 grid((a.Lq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<T*>(a.dq), a.Lq, a.Lkv, a.H, a.dh, score_scale(a.dh));
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = DkvTiles<DH>::dkv_smem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int BKV = DkvTiles<DH>::BKV;
  const dim3 grid((a.Lkv + BKV - 1) / BKV, a.H, a.B);
  flash_bwd_dkv_kernel<T, DH><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const T*>(a.o), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      static_cast<float*>(a.dmh), a.Lq, a.Lkv, a.H, a.dh, score_scale(a.dh));
  return cudaGetLastError();
}

// the forward's head-width buckets (flash_fwd.cu dispatch): the same DH
// gives the same fmaf chain, so the same scores
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
      a.dh > 256 || a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? dispatch<DKV, __nv_bfloat16>(a)
                       : dispatch<DKV, float>(a));
}

}  // namespace

// Each returns a cudaError_t as int: 0 when the kernel was launched.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* mask, const void* o, const void* dout,
                            const void* m, const void* l, void* dq, int B,
                            int H, int Lq, int Lkv, int dh, int is_bf16,
                            void* stream) {
  const Args a{q, k, v, mask, o, dout, m, l, dq, nullptr, nullptr, nullptr,
               B, H, Lq, Lkv, dh, static_cast<cudaStream_t>(stream)};
  return run<false>(a, is_bf16);
}

// dmh, the per-head mask gradient rows (B, H, Lkv) f32, may be null
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* mask, const void* o, const void* dout,
                             const void* m, const void* l, void* dk, void* dv,
                             void* dmh, int B, int H, int Lq, int Lkv, int dh,
                             int is_bf16, void* stream) {
  const Args a{q, k, v, mask, o, dout, m, l, nullptr, dk, dv, dmh,
               B, H, Lq, Lkv, dh, static_cast<cudaStream_t>(stream)};
  return run<true>(a, is_bf16);
}
