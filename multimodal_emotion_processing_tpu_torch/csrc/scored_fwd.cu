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
// in that order, each step rounded on its own (no fused multiply-add across
// steps), as the JAX kernel (:79-85) and the plain path
// (ops/attention.py `_scored_attention_xla`) do.  The order matters in a
// chained block: a key masked in the previous block carries
// S_prev ~ -1e8, so s there is ~ -(1 + c) * 1e8, where the f32 spacing is
// 8 to 16; a fused c*S_prev + dot would round once where the plain path
// rounds twice and move such an entry by a whole spacing, which in a fully
// masked row changes which keys share the row's maximum.  The steps are
// flash_common.cuh's `chained_score`, which csrc/scored_bwd.cu rebuilds s
// with; the scale and the penalty are `score_scale` and `mask_penalty`,
// and the raw dot is `tile_dots`' sequential fmaf over d.
//
// The gate c is a device pointer of the input dtype, read inside the kernel
// (never copied to the host, which would synchronise every call).  A null
// S_prev selects the variants without the residual term (c is not read); a
// null S selects those that emit nothing.  The mask penalty is the
// reference's finite 1e8, never -inf, and columns at or past Lkv are skipped
// inside the kernel (kv is never padded), so a fully masked row is a softmax
// over its Lkv real keys only.
//
// Layout: q (B, Lq, H*dh), k and v (B, Lkv, H*dh), ctx like q, all
// row-major and contiguous, heads read by stride; mask (B, Lkv) f32 or null;
// S_prev and S (B, H, Lq, Lkv) f32.  Grid: (q tiles of 64 rows) x heads x
// batch.  Block: 256 threads as 16 x 16, as csrc/flash_fwd.cu: thread
// (tx, ty) owns query rows ty + 16r (r < 4), score columns tx + 16c of each kv
// tile and output columns tx + 16j.  The kv loop is flash_fwd's online
// softmax (running max and sum in f32, an f32 accumulator), so any Lkv and
// any head width 1-256 take the same loop; each f32 score tile is written to
// S as soon as it is computed, so S is emitted without holding a whole row,
// and S_prev is read tile by tile the same way.  Sixteen neighbouring
// threads touch sixteen neighbouring floats of a row of S or S_prev.
//
// What bounds it on an H100: per (b, h), 4*Lq*Lkv*dh flops against
// (2*Lq + 2*Lkv)*dh input and output elements plus Lq*Lkv f32 scores read
// (S_prev) and written (S).  At the robot_demo shapes (dh 32, L 25 or 100,
// f32, one score tensor per call) that is 5 to 14 flops per byte, below the
// card's f32 ridge of ~20 (67 TFLOP/s outside the tensor cores over
// 3.35 TB/s), so the bound is the bytes, and the score tensor is a large
// share of them: 1.9 of a 100 x 100 call's 4.4 MB at B 8.  The call is far
// too small to fill the card (48 to 96 blocks at B 8, 6 to 12 at batch 1,
// for 132 SMs), so in practice launch latency bounds it.  Like flash_fwd,
// this first version
// computes both products with scalar f32 FMAs out of shared memory; tensor
// cores come later.

#include <float.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;

// kv tile width per head-width bucket, as csrc/flash_fwd.cu: 64 keys up to
// dh 64, 32 above, so that shared memory stays at or under ~74 KB up to
// dh 128
template <int DH>
struct Tiles {
  static constexpr int BKV = DH <= 64 ? 64 : 32;
  static constexpr int LDS = DH + 1;   // padded rows: conflict-free columns
  static constexpr int LDP = BKV + 1;
  static constexpr size_t smem_bytes =
      sizeof(float) * (size_t)(kBQ * LDS + 2 * BKV * LDS + kBQ * LDP + BKV);
};

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
scored_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ s_prev, const T* __restrict__ c,
                  T* __restrict__ o, float* __restrict__ s_out, int Lq,
                  int Lkv, int H, int dh, float scale) {
  constexpr int BKV = Tiles<DH>::BKV;
  constexpr int LDS = Tiles<DH>::LDS;
  constexpr int LDP = Tiles<DH>::LDP;
  constexpr int RM = kBQ / kTY;   // query rows per thread
  constexpr int CN = BKV / kTX;   // score columns per thread
  constexpr int DN = DH / kTX;    // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LDS;
  float* sV = sK + BKV * LDS;
  float* sP = sV + BKV * LDS;
  float* sNeg = sP + kBQ * LDP;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t D = (size_t)H * dh;
  const T* qb = q + (size_t)b * Lq * D + (size_t)h * dh;
  const T* kb = k + (size_t)b * Lkv * D + (size_t)h * dh;
  const T* vb = v + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;
  // row (b, h, i) of S_prev and S starts at (head_row0 + i) * Lkv
  const size_t head_row0 = ((size_t)b * H + h) * Lq;
  const float cv = s_prev ? to_f32(c[0]) : 0.f;

  stage_rows<T, DH, LDS>(sQ, qb, D, q0, kBQ, Lq - q0, dh);

  float m_run[RM], l_run[RM], acc[RM][DN];
#pragma unroll
  for (int r = 0; r < RM; ++r) {
    m_run[r] = -FLT_MAX;
    l_run[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[r][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < Lkv; kv0 += BKV) {
    const int nkv = min(BKV, Lkv - kv0);
    __syncthreads();  // sQ is written; the last tile's sK/sV/sP readers are done
    stage_rows<T, DH, LDS>(sK, kb, D, kv0, BKV, nkv, dh);
    stage_rows<T, DH, LDS>(sV, vb, D, kv0, BKV, nkv, dh);
    for (int j = tid; j < BKV; j += kThreads)
      sNeg[j] = j < nkv ? mask_penalty(mb, kv0 + j) : 0.f;
    __syncthreads();

    float s[RM][CN];
    tile_dots<DH, RM, CN, LDS>(sQ, sK, tx, ty, s);

    float alpha[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      const int row = q0 + ty + kTY * r;
      const bool live = row < Lq;   // rows past Lq are computed, never stored
      const size_t srow = (head_row0 + row) * (size_t)Lkv + kv0;
      float mx = -FLT_MAX;
#pragma unroll
      for (int cc = 0; cc < CN; ++cc) {
        const int col = tx + kTX * cc;
        if (col < nkv) {
          const float x = chained_score(
              s[r][cc], scale, s_prev && live ? s_prev + srow + col : nullptr,
              cv, sNeg[col]);
          if (s_out && live) s_out[srow + col] = x;
          s[r][cc] = x;
          mx = fmaxf(mx, x);
        }
      }
      // every tile holds at least one real column, so the tile max is finite
      const float m_new = fmaxf(m_run[r], half_warp_max(mx));
      alpha[r] = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int cc = 0; cc < CN; ++cc) {
        const int col = tx + kTX * cc;
        const float p = col < nkv ? expf(s[r][cc] - m_new) : 0.f;
        sP[(ty + kTY * r) * LDP + col] = p;
        sum += p;
      }
      l_run[r] = l_run[r] * alpha[r] + half_warp_sum(sum);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int r = 0; r < RM; ++r)
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[r][j] *= alpha[r];
    __syncthreads();

    for (int cc = 0; cc < nkv; ++cc) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int r = 0; r < RM; ++r) pv[r] = sP[(ty + kTY * r) * LDP + cc];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = sV[cc * LDS + tx + kTX * j];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int j = 0; j < DN; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < RM; ++r) {
    const int row = q0 + ty + kTY * r;
    if (row >= Lq) continue;
    const float inv = 1.f / l_run[r];  // l >= 1: the row max contributes exp(0)
    T* orow = o + ((size_t)b * Lq + row) * D + (size_t)h * dh;
#pragma unroll
    for (int j = 0; j < DN; ++j) {
      const int d = tx + kTX * j;
      if (d < dh) store(orow + d, acc[r][j] * inv);
    }
  }
}

template <typename T, int DH>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* mask, const void* s_prev, const void* c,
                   void* o, void* s_out, int B, int H, int Lq, int Lkv, int dh,
                   cudaStream_t stream) {
  const size_t smem = Tiles<DH>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      scored_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  scored_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(s_prev), static_cast<const T*>(c),
      static_cast<T*>(o), static_cast<float*>(s_out), Lq, Lkv, H, dh,
      score_scale(dh));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, const void* sp, const void* c, void* o,
                     void* so, int B, int H, int Lq, int Lkv, int dh,
                     cudaStream_t s) {
  if (dh <= 16) return launch<T, 16>(q, k, v, mask, sp, c, o, so, B, H, Lq, Lkv, dh, s);
  if (dh <= 32) return launch<T, 32>(q, k, v, mask, sp, c, o, so, B, H, Lq, Lkv, dh, s);
  if (dh <= 64) return launch<T, 64>(q, k, v, mask, sp, c, o, so, B, H, Lq, Lkv, dh, s);
  if (dh <= 128) return launch<T, 128>(q, k, v, mask, sp, c, o, so, B, H, Lq, Lkv, dh, s);
  return launch<T, 256>(q, k, v, mask, sp, c, o, so, B, H, Lq, Lkv, dh, s);
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel was launched.  s_prev and
// s_out are each null or (B, H, Lq, Lkv) f32; c (one value of the input
// dtype) must be given with s_prev.
extern "C" int scored_fwd(const void* q, const void* k, const void* v,
                          const void* mask, const void* s_prev, const void* c,
                          void* ctx, void* s_out, int B, int H, int Lq,
                          int Lkv, int dh, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lkv < 1 || dh < 1 || dh > 256 ||
      B > 65535 || H > 65535 || (s_prev != nullptr && c == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, mask, s_prev, c, ctx, s_out,
                                        B, H, Lq, Lkv, dh, s)
              : dispatch<float>(q, k, v, mask, s_prev, c, ctx, s_out, B, H,
                                Lq, Lkv, dh, s);
  return (int)err;
}
