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
// forward's score, bit for bit:
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
// skipped, never padded.  Layout as the forward: q, o, do (B, Lq, H*dh),
// k, v (B, Lkv, H*dh), all contiguous, heads read by stride; mask (B, Lkv)
// f32 or null; m, l (B, H, Lq) f32.
//
// What bounds it on an H100: 10 Lq Lkv dh flops per (b, h) for the five
// products against (3 Lq + 2 Lkv) dh elements read and (Lq + 2 Lkv) dh
// written: in bf16 that is ~100 to ~640 flops per byte at the s1024
// training shapes (L 128 to 512, dh 128), so the bytes bound the small
// shapes and the tensor-core operations the large ones; over the nine
// shapes at batch 64 the pair's bound is 0.855 ms of bytes (2.86 GB)
// against 0.532 ms of operations (526 GFLOP).  The split recomputes s and dp
// in both kernels (14 instead of 10 Lq Lkv dh flops) to stay free of
// atomics.
//
// Two pairs of kernels, chosen by dtype and head-width bucket
// (16/32/64/128/256) with the forward's predicate, mma::takes_tensor_cores:
// - bf16, dh <= 128: every product on the tensor cores (mma.sync m16n8k16,
//   bf16 in, f32 accumulators), four warps a block, operands bf16 in
//   swizzled shared memory, copied by cp.async into two-stage rings.
//   s comes from flash_mma.cuh `score_dots` with Q as the A operand and K
//   as the B operand, as in the forward, so it is the forward's bit for
//   bit; dP = dO.V^T goes through the same routine.  p and ds stay f32
//   until they become product operands, and then enter as three bf16 terms
//   (flash_mma.cuh `split_bf16`), which carry their 24 bits: with one bf16
//   p and ds the s1024 bf16 model's step-1 gradients moved 9.0e-2 from
//   impl="xla" (bound 5e-2, on an H100 80GB HBM3 at 700 W), a bf16 step in
//   many of the outputs.  The three products that take p or ds issue three
//   mma.sync per operand fragment instead of one.
//   flash_bwd_dq_mma_kernel: 64 query rows a block, 16 a warp, Q and dO
//   resident (O is staged once for delta); 32-key K / V tiles stream
//   through the ring.  dS goes from the accumulators straight into the
//   register A operand of dQ += dS.K (K read with ldmatrix.trans).  64.3 KB
//   of shared memory at dh 128, three blocks per SM.
//   flash_bwd_dkv_mma_kernel: 64 keys a block, K and V resident; 32-row Q,
//   dO and O tiles stream through the ring (O for delta).  Warp w computes S and dP for query
//   rows 16 (w % 2) .. + 15 of the tile against keys 32 (w / 2) .. + 31,
//   writes the bf16 terms of P and dS to shared memory, and then, as
//   the owner of keys 16w .. 16w + 15, accumulates dV += P^T.dO and
//   dK += dS^T.Q with P^T and dS^T read by ldmatrix.trans.  The 32-row step
//   keeps the six (32 x 64) terms and the two stages at 104.3 KB at dh
//   128, two blocks per SM (64 rows would need 176 KB, one block), and leaves
//   room in the 255 registers a thread may hold for the 128 f32 of dK and
//   dV beside S and dP.  dmask sums the f32 ds before any rounding: per
//   thread over its two rows, across the warp's rows by shuffles, per warp
//   in shared memory over the q tiles, then over the four warps, a fixed
//   order (105.3 KB of shared memory with those partials).
// - f32, and bf16 at dh 129..256: the scalar kernels flash_bwd_dq_kernel /
//   flash_bwd_dkv_kernel (f32 FMAs out of shared memory, 16 x 16 threads,
//   scores through flash_common.cuh `tile_dots`, the forward's order).  At
//   dh 256 the tensor-core dkv kernel's dK and dV would be 256 f32 a
//   thread, over the 255 registers a thread may hold.

#include "flash_common.cuh"
#include "flash_mma.cuh"

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

// ---- bf16 on the tensor cores, dh <= 128 --------------------------------

using bf16 = __nv_bfloat16;

// dq: 64 query rows a block against 32-key steps, three blocks an SM
// (64.3 KB of shared memory and at most 170 registers each; with 64-key
// steps it held 96.5 KB and 240 registers, two blocks an SM, and took
// 12 % longer at the s1024 shapes on an H100 80GB HBM3 at 700 W).  dkv:
// 64 keys a block against 32-row query steps.
constexpr int kDqBQ = mma::kWarps * mma::kRows;
constexpr int kDqBKV = 32;
constexpr int kDqMinBlocks = 3;
constexpr int kDkvBQ = 2 * mma::kRows;
constexpr int kDkvBKV = mma::kWarps * mma::kRows;

template <int DH>
constexpr size_t mma_dq_smem() {
  // sQ, sdO, two stages of sK and sV, two stages of penalties
  return sizeof(bf16) * (size_t)(2 * kDqBQ * DH + 4 * kDqBKV * DH) +
         sizeof(float) * 2 * kDqBKV;
}

// sK, sV, two stages of sQ, sdO and sO, the bf16 terms of P and of dS,
// penalties; then, with a dmask, the per-warp column sums
template <int DH>
constexpr size_t mma_dkv_smem(bool dmask) {
  return sizeof(bf16) * (size_t)(2 * kDkvBKV * DH + 6 * kDkvBQ * DH +
                                 2 * mma::kSplit * kDkvBQ * kDkvBKV) +
         sizeof(float) * (size_t)(kDkvBKV + (dmask ? mma::kWarps * kDkvBKV : 0));
}

// m and 1 / l of this lane's accumulator rows g and g + 8 of the warp slab
// starting at query row `row0`; rows at or past Lq are not real
__device__ __forceinline__ void lane_stats(const float* m, const float* l,
                                           size_t base, int row0, int Lq,
                                           float (&m_r)[2], float (&inv_l)[2],
                                           bool (&real)[2]) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    real[r] = row < Lq;
    m_r[r] = real[r] ? m[base + row] : 0.f;
    inv_l[r] = real[r] ? 1.f / l[base + row] : 1.f;
  }
}

// store this lane's two accumulator rows of a (rows x DH) f32 tile, times
// `mul`, to rows row0 + g (+ 8) of a (L, H*dh) tensor, rows below n_real
template <int DH>
__device__ __forceinline__ void store_rows(bf16* dst, size_t D, int row0,
                                           int n_real, int dh, bool vec,
                                           const float (&acc)[DH / 8][4],
                                           float mul) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= n_real) continue;
    bf16* out = dst + (size_t)row * D;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d >= dh) continue;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            acc[n][2 * r] * mul, acc[n][2 * r + 1] * mul);
      } else {
        out[d] = __float2bfloat16_rn(acc[n][2 * r] * mul);
        if (d + 1 < dh) out[d + 1] = __float2bfloat16_rn(acc[n][2 * r + 1] * mul);
      }
    }
  }
}

template <int DH>
__global__ void __launch_bounds__(mma::kThreads, kDqMinBlocks)
flash_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v,
                        const float* __restrict__ mask,
                        const bf16* __restrict__ o, const bf16* __restrict__ dout,
                        const float* __restrict__ m, const float* __restrict__ l,
                        bf16* __restrict__ dq, int Lq, int Lkv, int H, int dh,
                        float scale, bool vec) {
  constexpr int BQ = kDqBQ, BKV = kDqBKV, NT = BKV / 8, DT = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BQ * DH;
  bf16* sKV = sdO + BQ * DH;       // two stages, each K then V
  float* sNeg = reinterpret_cast<float*>(sKV + 4 * BKV * DH);  // two stages
  auto sK = [=](int stage) { return sKV + stage * 2 * BKV * DH; };
  auto sV = [=](int stage) { return sKV + (stage * 2 + 1) * BKV * DH; };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int nq = min(BQ, Lq - q0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const bf16* kb = k + (size_t)b * Lkv * D + (size_t)h * dh;
  const bf16* vb = v + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;
  const int n_tiles = (Lkv + BKV - 1) / BKV;

  auto load_kv = [=](int tile, int stage) {
    const int kv0 = tile * BKV, nkv = min(BKV, Lkv - kv0);
    mma::load_rows<DH, BKV>(sK(stage), kb, D, kv0, nkv, dh, vec);
    mma::load_rows<DH, BKV>(sV(stage), vb, D, kv0, nkv, dh, vec);
    for (int c = threadIdx.x; c < BKV; c += mma::kThreads)
      sNeg[stage * BKV + c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;
  };

  // O waits in the ring's second stage until the deltas are taken
  static_assert(BQ <= 2 * BKV, "the O tile fits a stage");
  mma::load_rows<DH, BQ>(sQ, q + qoff, D, q0, nq, dh, vec);
  mma::load_rows<DH, BQ>(sdO, dout + qoff, D, q0, nq, dh, vec);
  mma::load_rows<DH, BQ>(sK(1), o + qoff, D, q0, nq, dh, vec);
  load_kv(0, 0);
  mma::cp_async_commit();

  const int row0 = warp * mma::kRows;   // the warp's slab in the q tile
  float m_r[2], inv_l[2], delta[2];
  bool real[2];
  lane_stats(m, l, ((size_t)b * H + h) * Lq + q0, row0, nq, m_r, inv_l, real);
  mma::cp_async_wait<0>();
  __syncthreads();
  mma::warp_delta<DH>(sdO, sK(1), row0, delta);
  __syncthreads();   // the second stage is free for tile 1

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {
      load_kv(t + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int nkv = min(BKV, Lkv - t * BKV);
    const float* neg = sNeg + stage * BKV;
    const bf16* sKs = sK(stage);

    float s[NT][4], dp[NT][4];
    mma::score_dots<DH, NT>(sQ, row0, sKs, 0, s);
    mma::score_dots<DH, NT>(sdO, row0, sV(stage), 0, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1), r = e >> 1;
        float ds = 0.f;
        if (real[r] && col < nkv) {
          const float p =
              expf(masked_score(s[j][e], scale, neg[col]) - m_r[r]) * inv_l[r];
          ds = p * (dp[j][e] - delta[r]);
        }
        s[j][e] = ds;
      }
    // ds rounded to bf16 only as the terms of this product's operand
    uint32_t da[mma::kSplit][NT / 2][4];
    mma::to_a_split<NT>(s, da);
    mma::mma_regA<DH, NT / 2>(acc, da, sKs, 0);
    __syncthreads();   // this stage is refilled two tiles on
  }
  store_rows<DH>(dq + qoff + (size_t)q0 * D, D, row0, nq, dh, vec, acc, scale);
}

template <int DH>
__global__ void __launch_bounds__(mma::kThreads)
flash_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const float* __restrict__ mask,
                         const bf16* __restrict__ o,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ m,
                         const float* __restrict__ l, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, float* __restrict__ dmh,
                         int Lq, int Lkv, int H, int dh, float scale,
                         bool vec) {
  constexpr int BQ = kDkvBQ, BKV = kDkvBKV, DT = DH / 8;
  constexpr int SN = BKV / 2, NT = SN / 8;   // a warp's score columns
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BKV * DH;
  bf16* sQ = sV + BKV * DH;        // two stages
  bf16* sdO = sQ + 2 * BQ * DH;    // two stages
  bf16* sO = sdO + 2 * BQ * DH;    // two stages
  bf16* sP = sO + 2 * BQ * DH;     // the terms of P, (BQ, BKV) each
  bf16* sdS = sP + mma::kSplit * BQ * BKV;   // the terms of dS
  float* sNeg = reinterpret_cast<float*>(sdS + mma::kSplit * BQ * BKV);
  float* sDm = sNeg + BKV;         // (warps, BKV), only with dmh

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kv0 = blockIdx.x * BKV, h = blockIdx.y, b = blockIdx.z;
  const int nkv = min(BKV, Lkv - kv0);
  const size_t D = (size_t)H * dh;
  const size_t qoff = (size_t)b * Lq * D + (size_t)h * dh;
  const size_t kvoff = (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;
  const size_t stat0 = ((size_t)b * H + h) * Lq;
  const int n_tiles = (Lq + BQ - 1) / BQ;

  auto load_q = [=](int tile, int stage) {
    const int q0 = tile * BQ, nq = min(BQ, Lq - q0);
    mma::load_rows<DH, BQ>(sQ + stage * BQ * DH, q + qoff, D, q0, nq, dh, vec);
    mma::load_rows<DH, BQ>(sdO + stage * BQ * DH, dout + qoff, D, q0, nq, dh,
                           vec);
    mma::load_rows<DH, BQ>(sO + stage * BQ * DH, o + qoff, D, q0, nq, dh, vec);
  };

  mma::load_rows<DH, BKV>(sK, k + kvoff, D, kv0, nkv, dh, vec);
  mma::load_rows<DH, BKV>(sV, v + kvoff, D, kv0, nkv, dh, vec);
  load_q(0, 0);
  mma::cp_async_commit();
  for (int c = threadIdx.x; c < BKV; c += mma::kThreads)
    sNeg[c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;
  if (dmh)
    for (int i = threadIdx.x; i < mma::kWarps * BKV; i += mma::kThreads)
      sDm[i] = 0.f;

  // S / dP: warp w takes query rows qr0 .. qr0 + 15 of the q tile against
  // keys c0 .. c0 + 31; dK / dV: it owns keys kr0 .. kr0 + 15
  const int qr0 = (warp & 1) * mma::kRows, c0 = (warp >> 1) * SN;
  const int kr0 = warp * mma::kRows;
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1, q0 = it * BQ, nq = min(BQ, Lq - q0);
    if (it + 1 < n_tiles) {
      load_q(it + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sQs = sQ + stage * BQ * DH;
    const bf16* sdOs = sdO + stage * BQ * DH;
    float m_r[2], inv_l[2], delta[2];
    bool real[2];
    lane_stats(m, l, stat0 + q0, qr0, nq, m_r, inv_l, real);
    mma::warp_delta<DH>(sdOs, sO + stage * BQ * DH, qr0, delta);

    float s[NT][4], dp[NT][4];
    mma::score_dots<DH, NT>(sQs, qr0, sK, c0, s);
    mma::score_dots<DH, NT>(sdOs, qr0, sV, c0, dp);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + j * 8 + 2 * t4 + (e & 1), r = e >> 1;
        float p = 0.f, ds = 0.f;
        if (real[r] && col < nkv) {
          p = expf(masked_score(s[j][e], scale, sNeg[col]) - m_r[r]) * inv_l[r];
          ds = p * (dp[j][e] - delta[r]);
        }
        s[j][e] = p;
        dp[j][e] = ds;
      }
      // p and ds rounded to bf16 only as the terms of the operands of dV
      // and dK
      const int col = c0 + j * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int off = mma::at<BKV>(qr0 + g + 8 * r, col);
        uint32_t tp[mma::kSplit], tds[mma::kSplit];
        mma::split_bf16(s[j][2 * r], s[j][2 * r + 1], tp);
        mma::split_bf16(dp[j][2 * r], dp[j][2 * r + 1], tds);
#pragma unroll
        for (int i = 0; i < mma::kSplit; ++i) {
          *reinterpret_cast<uint32_t*>(sP + i * BQ * BKV + off) = tp[i];
          *reinterpret_cast<uint32_t*>(sdS + i * BQ * BKV + off) = tds[i];
        }
      }
      if (dmh) {   // f32 ds: this lane's two rows, then the warp's 16
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float cs = dp[j][e] + dp[j][2 + e];
          cs += __shfl_xor_sync(0xffffffffu, cs, 4);
          cs += __shfl_xor_sync(0xffffffffu, cs, 8);
          cs += __shfl_xor_sync(0xffffffffu, cs, 16);
          if (g == 0) sDm[warp * BKV + col + e] += cs;
        }
      }
    }
    __syncthreads();   // P and dS are whole
    mma::mma_transA<DH, BQ, BKV>(dv_acc, sP, kr0, sdOs);
    mma::mma_transA<DH, BQ, BKV>(dk_acc, sdS, kr0, sQs);
    __syncthreads();   // P, dS and this stage are free again
  }

  store_rows<DH>(dk + kvoff + (size_t)kv0 * D, D, kr0, nkv, dh, vec, dk_acc,
                 scale);
  store_rows<DH>(dv + kvoff + (size_t)kv0 * D, D, kr0, nkv, dh, vec, dv_acc,
                 1.f);
  if (dmh)   // each warp summed its own columns; the others hold zeros
    for (int c = threadIdx.x; c < nkv; c += mma::kThreads) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < mma::kWarps; ++w) sum += sDm[w * BKV + c];
      dmh[((size_t)b * H + h) * Lkv + kv0 + c] = kMaskPenalty * sum;
    }
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

// f32 over the forward's head-width buckets (flash_fwd.cu dispatch): the
// same DH gives the same fmaf chain, so the same scores
template <bool DKV>
cudaError_t dispatch(const Args& a) {
  if (a.dh <= 16) return DKV ? launch_dkv<float, 16>(a) : launch_dq<float, 16>(a);
  if (a.dh <= 32) return DKV ? launch_dkv<float, 32>(a) : launch_dq<float, 32>(a);
  if (a.dh <= 64) return DKV ? launch_dkv<float, 64>(a) : launch_dq<float, 64>(a);
  if (a.dh <= 128) return DKV ? launch_dkv<float, 128>(a) : launch_dq<float, 128>(a);
  return DKV ? launch_dkv<float, 256>(a) : launch_dq<float, 256>(a);
}

template <int DH>
cudaError_t launch_dq_mma(const Args& a) {
  constexpr size_t smem = mma_dq_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + kDqBQ - 1) / kDqBQ, a.H, a.B);
  flash_bwd_dq_mma_kernel<DH><<<grid, mma::kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<bf16*>(a.dq), a.Lq, a.Lkv, a.H, a.dh, score_scale(a.dh),
      mma::vec_ok(a.dh, {a.q, a.k, a.v, a.o, a.dout, a.dq}));
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv_mma(const Args& a) {
  const size_t smem = mma_dkv_smem<DH>(a.dmh != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_dkv_smem<DH>(true));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lkv + kDkvBKV - 1) / kDkvBKV, a.H, a.B);
  flash_bwd_dkv_mma_kernel<DH><<<grid, mma::kThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.m), static_cast<const float*>(a.l),
      static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      static_cast<float*>(a.dmh), a.Lq, a.Lkv, a.H, a.dh, score_scale(a.dh),
      mma::vec_ok(a.dh, {a.q, a.k, a.v, a.o, a.dout, a.dk, a.dv}));
  return cudaGetLastError();
}

// the forward's buckets on the tensor cores (flash_fwd.cu dispatch_mma)
template <bool DKV>
cudaError_t dispatch_mma(const Args& a) {
  if (a.dh <= 16) return DKV ? launch_dkv_mma<16>(a) : launch_dq_mma<16>(a);
  if (a.dh <= 32) return DKV ? launch_dkv_mma<32>(a) : launch_dq_mma<32>(a);
  if (a.dh <= 64) return DKV ? launch_dkv_mma<64>(a) : launch_dq_mma<64>(a);
  return DKV ? launch_dkv_mma<128>(a) : launch_dq_mma<128>(a);
}

template <bool DKV>
int run(const Args& a, int is_bf16) {
  if (a.B < 1 || a.H < 1 || a.Lq < 1 || a.Lkv < 1 || a.dh < 1 ||
      a.dh > 256 || a.B > 65535 || a.H > 65535)
    return (int)cudaErrorInvalidValue;
  if (mma::takes_tensor_cores(is_bf16, a.dh)) return (int)dispatch_mma<DKV>(a);
  if (is_bf16)   // dh 129..256
    return (int)(DKV ? launch_dkv<__nv_bfloat16, 256>(a)
                     : launch_dq<__nv_bfloat16, 256>(a));
  return (int)dispatch<DKV>(a);
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
