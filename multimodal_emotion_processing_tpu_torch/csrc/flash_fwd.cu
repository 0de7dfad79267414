// Flash attention forward for terminal attention blocks, written for Hopper
// (sm_90a).
//
// Replaces the two forward Pallas kernels of the JAX package,
// multimodal_emotion_processing_tpu/ops/flash_attention.py:
//   _flash_forward_whole (:179-216, kernel _make_whole_fwd_kernel :147-176)
//   _flash_forward       (:399-444, kernel _make_flash_fwd_kernel :337-396)
// One kernel covers both: the whole-sequence variant is the tiled one with a
// single kv tile, and here every kv length walks the same tile loop.
//
// Computes, per batch row b, head h and query row i:
//   s[j] = (q_i . k_j) / sqrt(dh) - 1e8 * (1 - mask[b, j])     j < Lkv
//   o_i  = softmax(s) . v
// with the running max m and running sum l of the online softmax in f32 and
// an f32 accumulator; o is stored at the input dtype (f32 or bf16).  For the
// backward (csrc/flash_bwd.cu) the kernel also writes the final m and l of
// every row, (B, H, Lq) f32 each, when it is given the two pointers.  They
// stay separate, never folded into lse = m + log l: in a fully masked row
// m is about -1e8, where the f32 spacing is 8, and log l would round away.
// Scores come from flash_common.cuh, the same code the backward uses.
// The mask penalty is the reference's finite 1e8, never -inf, so a row whose
// mask is all zero gets a uniform softmax over its Lkv real keys.  Columns at
// or past Lkv are skipped inside the kernel: kv is never padded, so padded
// keys cannot join that uniform softmax (the JAX wrapper zero-pads kv to a
// multiple of 128 and its fully masked rows then average over the padded
// length).
//
// Layout: q (B, Lq, H*dh), k and v (B, Lkv, H*dh), o like q, all row-major
// and contiguous; heads are read by stride, so no split/merge copies.  mask
// is (B, Lkv) f32 or null.  Grid: (q tiles of 64 rows) x heads x batch.
// Block: 256 threads as 16 x 16; thread (tx, ty) owns query rows ty + 16r
// (r < 4), score columns tx + 16c of each kv tile, and output columns
// tx + 16j.  Q stays in shared memory for the whole kv loop; K and V tiles
// of at most 64 keys are staged per step.
//
// What bounds it on an H100: per (b, h) the work is 4*Lq*Lkv*dh flops
// against (2*Lq + 2*Lkv)*dh elements moved, i.e. Lq*Lkv/(Lq+Lkv) flops per
// byte in bf16: 64 to 256 at the s1024 serving shapes (L 128 to 512), under
// the card's bf16 ridge of ~295, so the bound is the bytes (HBM); in f32,
// with the 67 TFLOP/s of the non-tensor-core units, it is the operations.
// This first version computes both products with scalar f32 FMAs out of
// shared memory (no tensor cores, no wgmma or TMA yet), so what limits it in
// practice is the shared-memory operand traffic of those FMAs, far above
// either bound.  Moving S = Q.K^T and O = P.V onto the tensor cores (wgmma)
// is the work that makes it fast.

#include <float.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBQ = 64;

// kv tile width per head-width bucket: 64 keys up to dh 64, 32 above, so
// that shared memory stays at or under ~74 KB (three blocks per SM) up to
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
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const float* __restrict__ mask,
                 T* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int Lq, int Lkv, int H, int dh,
                 float scale) {
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
    for (int c = tid; c < BKV; c += kThreads)
      sNeg[c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;
    __syncthreads();

    float s[RM][CN];
    tile_dots<DH, RM, CN, LDS>(sQ, sK, tx, ty, s);

    float alpha[RM];
#pragma unroll
    for (int r = 0; r < RM; ++r) {
      float mx = -FLT_MAX;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = tx + kTX * c;
        if (col < nkv) {
          s[r][c] = masked_score(s[r][c], scale, sNeg[col]);
          mx = fmaxf(mx, s[r][c]);
        }
      }
      // every tile holds at least one real column, so the tile max is finite
      const float m_new = fmaxf(m_run[r], half_warp_max(mx));
      alpha[r] = expf(m_run[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < CN; ++c) {
        const int col = tx + kTX * c;
        const float p = col < nkv ? expf(s[r][c] - m_new) : 0.f;
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

    for (int c = 0; c < nkv; ++c) {
      float pv[RM], vv[DN];
#pragma unroll
      for (int r = 0; r < RM; ++r) pv[r] = sP[(ty + kTY * r) * LDP + c];
#pragma unroll
      for (int j = 0; j < DN; ++j) vv[j] = sV[c * LDS + tx + kTX * j];
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
    if (m_out && tx == 0) {
      const size_t stat = ((size_t)b * H + h) * Lq + row;
      m_out[stat] = m_run[r];
      l_out[stat] = l_run[r];
    }
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
                   const void* mask, void* o, float* m_out, float* l_out,
                   int B, int H, int Lq, int Lkv, int dh, cudaStream_t stream) {
  const size_t smem = Tiles<DH>::smem_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(o), m_out, l_out, Lq, Lkv, H, dh, score_scale(dh));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, void* o, float* m, float* l, int B,
                     int H, int Lq, int Lkv, int dh, cudaStream_t s) {
  if (dh <= 16) return launch<T, 16>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 32) return launch<T, 32>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 64) return launch<T, 64>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 128) return launch<T, 128>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  return launch<T, 256>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel was launched.  m_out and
// l_out are both null (serving) or both (B, H, Lq) f32 (training).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const void* mask, void* o, void* m_out, void* l_out,
                         int B, int H, int Lq, int Lkv, int dh, int is_bf16,
                         void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lkv < 1 || dh < 1 || dh > 256 ||
      B > 65535 || H > 65535 || (m_out == nullptr) != (l_out == nullptr))
    return (int)cudaErrorInvalidValue;
  float* m = static_cast<float*>(m_out);
  float* l = static_cast<float*>(l_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s)
              : dispatch<float>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  return (int)err;
}
