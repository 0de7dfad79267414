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
// The mask penalty is the reference's finite 1e8, never -inf, so a row whose
// mask is all zero gets a uniform softmax over its Lkv real keys.  Columns at
// or past Lkv are skipped inside the kernel: kv is never padded, so padded
// keys cannot join that uniform softmax (the JAX wrapper zero-pads kv to a
// multiple of 128 and its fully masked rows then average over the padded
// length).  Layout: q (B, Lq, H*dh), k and v (B, Lkv, H*dh), o like q, all
// row-major and contiguous; heads are read by stride, so no split/merge
// copies; mask is (B, Lkv) f32 or null.
//
// What bounds it on an H100: per (b, h) the work is 4*Lq*Lkv*dh flops
// against (2*Lq + 2*Lkv)*dh elements moved, i.e. Lq*Lkv/(Lq+Lkv) flops per
// byte in bf16: 64 to 256 at the s1024 serving shapes (L 128 to 512, dh
// 128), under the card's bf16 ridge of ~295, so the bound is the bytes: 176
// MB for the nine shapes at batch 8, 0.053 ms at 3.35 TB/s, against 26 GFLOP
// (0.027 ms at 989 TFLOP/s).  In f32, with the 67 TFLOP/s outside the tensor
// cores, it is the operations.
//
// Two kernels, chosen by dtype and head-width bucket (16/32/64/128/256) with
// the predicate the backward uses, mma::takes_tensor_cores:
// - bf16, dh <= 128: flash_fwd_mma_kernel.  Four warps, each owning 16 query
//   rows (the FA2 layout), so a block is 64 query rows; grid (q tiles) x
//   heads x batch.  Q, K and V stay bf16 in swizzled shared memory; K / V
//   tiles of 64 keys come in by cp.async (16 bytes a thread) into a
//   two-stage ring, so the next tile's copy overlaps this tile's products.
//   S = Q.K^T comes from flash_mma.cuh `score_dots` (mma.sync m16n8k16,
//   bf16 in, f32 accumulator), the same chain both backward kernels use.  P
//   is built in registers from the S accumulator, summed into l in f32, and
//   only then rounded to bf16, as the A operand of O += P.V (mma.sync again,
//   V read with ldmatrix.trans), never passing through shared memory.  It
//   enters that product as three bf16 terms (flash_mma.cuh `split_bf16`),
//   which carry f32 p's 24 bits: with one bf16 P the output differed from
//   the f32-softmax path's by a bf16 step in many elements, and the s1024
//   bf16 model amplified that to step-1 gradients 9.0e-2 from impl="xla"
//   (bound 5e-2, on an H100 80GB HBM3 at 700 W).  A tile of 64 keys keeps
//   the per-thread state at 64 f32 of O, 32 of S and 48 packed P registers
//   at dh 128, which ptxas fits without spilling; 64 query rows keep the
//   s1024 serving grids at 128 to 512 blocks.  Shared memory: 80.5 KB at dh
//   128,
//   two blocks per SM.
// - f32, and bf16 at dh 129..256: flash_fwd_kernel, scalar f32 FMAs out of
//   shared memory (16 x 16 threads, 64 query rows, the scores through
//   flash_common.cuh `tile_dots`).  It is exact with TF32 off; no main path
//   runs flash in f32.  Above dh 128 bf16 stays here because the dkv
//   kernel does (flash_mma.cuh `takes_tensor_cores`).

#include <float.h>

#include "flash_common.cuh"
#include "flash_mma.cuh"

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

// f32 over the head-width buckets (bf16 takes the 256 bucket only)
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const void* mask, void* o, float* m, float* l, int B,
                     int H, int Lq, int Lkv, int dh, cudaStream_t s) {
  if (dh <= 16) return launch<float, 16>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 32) return launch<float, 32>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 64) return launch<float, 64>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 128) return launch<float, 128>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  return launch<float, 256>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
}


// ---- bf16 on the tensor cores, dh <= 128 --------------------------------

using bf16 = __nv_bfloat16;

constexpr int kMmaBQ = mma::kWarps * mma::kRows;   // 64 query rows a block
constexpr int kMmaBKV = 64;                         // keys a tile

template <int DH>
constexpr size_t mma_fwd_smem() {
  // sQ, two stages of sK and sV, two stages of penalties
  return sizeof(bf16) * (size_t)(kMmaBQ * DH + 4 * kMmaBKV * DH) +
         sizeof(float) * 2 * kMmaBKV;
}

template <int DH>
__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, int Lq, int Lkv, int H, int dh,
                     float scale, bool vec) {
  constexpr int BQ = kMmaBQ, BKV = kMmaBKV, NT = BKV / 8, DT = DH / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + BQ * DH;         // two stages
  bf16* sV = sK + 2 * BKV * DH;    // two stages
  float* sNeg = reinterpret_cast<float*>(sV + 2 * BKV * DH);   // two stages

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const size_t D = (size_t)H * dh;
  const bf16* qb = q + (size_t)b * Lq * D + (size_t)h * dh;
  const bf16* kb = k + (size_t)b * Lkv * D + (size_t)h * dh;
  const bf16* vb = v + (size_t)b * Lkv * D + (size_t)h * dh;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;
  const int n_tiles = (Lkv + BKV - 1) / BKV;

  auto load_kv = [=](int tile, int stage) {
    const int kv0 = tile * BKV, nkv = min(BKV, Lkv - kv0);
    mma::load_rows<DH, BKV>(sK + stage * BKV * DH, kb, D, kv0, nkv, dh, vec);
    mma::load_rows<DH, BKV>(sV + stage * BKV * DH, vb, D, kv0, nkv, dh, vec);
    for (int c = threadIdx.x; c < BKV; c += mma::kThreads)
      sNeg[stage * BKV + c] = c < nkv ? mask_penalty(mb, kv0 + c) : 0.f;
  };

  mma::load_rows<DH, BQ>(sQ, qb, D, q0, Lq - q0, dh, vec);
  load_kv(0, 0);
  mma::cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_tiles) {   // the next tile's copy overlaps this one's work
      load_kv(t + 1, stage ^ 1);
      mma::cp_async_commit();
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();
    const int nkv = min(BKV, Lkv - t * BKV);
    const float* neg = sNeg + stage * BKV;

    float s[NT][4];
    mma::score_dots<DH, NT>(sQ, warp * mma::kRows, sK + stage * BKV * DH, 0, s);

    // rows g (e = 0, 1) and g + 8 (e = 2, 3); every tile holds at least one
    // real column, so each row's tile max is finite
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t4 + (e & 1);
        if (col < nkv) {
          s[j][e] = masked_score(s[j][e], scale, neg[col]);
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        } else {
          s[j][e] = -INFINITY;
        }
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mma::quad_max(mx[r]));
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);   // p, f32
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + mma::quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // p rounded to bf16 only here, as the terms of the A operand of
    // O += P.V, straight from the S accumulators
    uint32_t pa[mma::kSplit][NT / 2][4];
    mma::to_a_split<NT>(s, pa);
    mma::mma_regA<DH, NT / 2>(acc, pa, sV + stage * BKV * DH, 0);
    __syncthreads();   // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + warp * mma::kRows + g + 8 * r;
    if (row >= Lq) continue;
    if (m_out && t4 == 0) {
      const size_t stat = ((size_t)b * H + h) * Lq + row;
      m_out[stat] = m_run[r];
      l_out[stat] = l_run[r];
    }
    const float inv = 1.f / l_run[r];   // l >= 1: the row max contributes exp(0)
    bf16* orow = o + ((size_t)b * Lq + row) * D + (size_t)h * dh;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      const int d = n * 8 + 2 * t4;
      if (d >= dh) continue;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      } else {
        orow[d] = __float2bfloat16_rn(acc[n][2 * r] * inv);
        if (d + 1 < dh) orow[d + 1] = __float2bfloat16_rn(acc[n][2 * r + 1] * inv);
      }
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k, const void* v,
                       const void* mask, void* o, float* m_out, float* l_out,
                       int B, int H, int Lq, int Lkv, int dh,
                       cudaStream_t stream) {
  constexpr size_t smem = mma_fwd_smem<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mma_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Lq + kMmaBQ - 1) / kMmaBQ, H, B);
  flash_fwd_mma_kernel<DH><<<grid, mma::kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(mask),
      static_cast<bf16*>(o), m_out, l_out, Lq, Lkv, H, dh, score_scale(dh),
      mma::vec_ok(dh, {q, k, v, o}));
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const void* q, const void* k, const void* v,
                         const void* mask, void* o, float* m, float* l, int B,
                         int H, int Lq, int Lkv, int dh, cudaStream_t s) {
  if (dh <= 16) return launch_mma<16>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 32) return launch_mma<32>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  if (dh <= 64) return launch_mma<64>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  return launch_mma<128>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
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
      flash::mma::takes_tensor_cores(is_bf16, dh)
          ? dispatch_mma(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s)
      : is_bf16
          ? launch<__nv_bfloat16, 256>(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s)
          : dispatch(q, k, v, mask, o, m, l, B, H, Lq, Lkv, dh, s);
  return (int)err;
}


// ---- latent attention prefill: causal, variable length, qk 192 / v 128 ---
//
// The prefill of DeepSeek-V2/V3's multi-head latent attention (MLA) with the
// latent expanded per head (as Moonlight-16B-A3B runs it in
// models/tower.py): for sequence s of a packed batch (tokens cu[s] ..
// cu[s + 1] - 1), head h and query row i of s,
//   score_j = (q_nope_i . k_nope_j + q_rope_i . k_pe_j) / sqrt(192),  j <= i
//   o_i     = softmax(score) . v
// in f32 (running max and sum, f32 accumulator), stored in bf16.  Layouts,
// row-major and contiguous, so the projections' outputs are read in place:
// q (T, H, 192) bf16, per head the 128 nope then the 64 rope dims (RoPE
// applied); kv (T, H, 256) bf16, per head k_nope then v (kv_b_proj's
// output); k_pe (T, 64) bf16, one rope key per token shared by every head
// (RoPE applied); o (T, H, 128) bf16.  No key past a query's own position
// and no key of another sequence enters its softmax.
//
// Four warps of 16 query rows (64 a block, one head, one sequence), kv tiles
// of 64 keys in a two-stage cp.async ring: q's 128 + 64 columns, then k's
// 128 + 64 and v's 128 in swizzled tiles of power-of-two widths (flash_mma.cuh
// `chunk`): 104 KB, two blocks an SM.  S = Q_nope.K_nope^T + Q_rope.K_pe^T
// is one accumulator chain of mma.sync m16n8k16 (bf16 in, f32 out); P is
// rounded once to bf16 as the A operand of O += P.V, straight from the S
// accumulators, as FlashAttention-2 does in bf16 inference.  Only the
// diagonal tile is masked.  The grid is (sequences x the longest
// sequence's q tiles) x heads, the last q tiles (the most keys) first; a
// block past its sequence's end returns at once.
//
// What bounds it: per (sequence, head) 2 L^2 (192 + 128) / 2 causal flops
// against (192 + 256) L bf16 read and 128 L written, so at the median 384
// tokens ~100 flops a byte, the bytes; at 4,096 tokens the flops.

namespace {

using namespace flash;

constexpr int kMlaNope = 128, kMlaRope = 64, kMlaQK = 192, kMlaV = 128;
constexpr int kMlaBQ = mma::kWarps * mma::kRows;   // 64 query rows a block
constexpr int kMlaBKV = 64;                         // keys a tile
constexpr int kMlaStage = kMlaBKV * (kMlaNope + kMlaRope + kMlaV);
constexpr size_t kMlaSmem =
    sizeof(bf16) * (size_t)(kMlaBQ * kMlaQK + 2 * kMlaStage);

// ROWS rows of COLS bf16 from `src` (row r at src + r * stride) into a
// swizzled tile, 16 bytes a cp.async, rows past n_real zero
template <int COLS, int ROWS>
__device__ __forceinline__ void mla_load(bf16* dst, const bf16* src,
                                         size_t stride, int n_real) {
  constexpr int CPR = COLS / 8;
  for (int i = threadIdx.x; i < ROWS * CPR; i += mma::kThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool real = r < n_real;
    mma::cp_async16(dst + mma::chunk<COLS>(r, c) * 8,
                    real ? src + (size_t)r * stride + c * 8 : src, real);
  }
}

// s += the dots of this warp's 16 rows of sA against the 8 NT rows of sB,
// both DH wide (mma::score_dots without its zeroing)
template <int DH, int NT>
__device__ __forceinline__ void mla_dots(const bf16* sA, int a_row0,
                                         const bf16* sB, float (&s)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kc = 0; kc < DH / 16; ++kc) {
    uint32_t a[4];
    mma::ldsm_x4(a, sA + mma::at<DH>(a_row0 + (lane & 15), kc * 16 + (lane >> 4) * 8));
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t b[4];
      mma::ldsm_x4(b, sB + mma::at<DH>(j * 8 + (lane & 7) + (lane >> 4) * 8,
                                       kc * 16 + ((lane >> 3) & 1) * 8));
      mma::mma_16816(s[j], a, b[0], b[1]);
      mma::mma_16816(s[j + 1], a, b[2], b[3]);
    }
  }
}

__global__ void __launch_bounds__(mma::kThreads)
flash_fwd_mla_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kv,
                     const bf16* __restrict__ kpe, const int* __restrict__ cu,
                     bf16* __restrict__ o, int n_seqs, int H, int n_qtiles,
                     float scale) {
  constexpr int NT = kMlaBKV / 8, VT = kMlaV / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQn = reinterpret_cast<bf16*>(smem_raw);
  bf16* sQr = sQn + kMlaBQ * kMlaNope;
  bf16* sKV = sQr + kMlaBQ * kMlaRope;   // two stages of K_nope, K_pe, V

  const int seq = blockIdx.x % n_seqs;
  const int qt = n_qtiles - 1 - blockIdx.x / n_seqs;
  const int h = blockIdx.y;
  const int start = cu[seq], len = cu[seq + 1] - start;
  const int q0 = qt * kMlaBQ;
  if (q0 >= len) return;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t qstride = (size_t)H * kMlaQK, kvstride = (size_t)H * 2 * kMlaV;
  const bf16* qb = q + (size_t)(start + q0) * qstride + (size_t)h * kMlaQK;
  const bf16* kvb = kv + (size_t)start * kvstride + (size_t)h * 2 * kMlaV;
  const bf16* kpb = kpe + (size_t)start * kMlaRope;
  const int kv_end = min(q0 + kMlaBQ, len);   // keys the block's rows see
  const int n_tiles = (kv_end + kMlaBKV - 1) / kMlaBKV;

  auto load_kv = [=](int tile, int stage) {
    const int kv0 = tile * kMlaBKV, nkv = min(kMlaBKV, len - kv0);
    bf16* sK = sKV + stage * kMlaStage;
    mla_load<kMlaNope, kMlaBKV>(sK, kvb + (size_t)kv0 * kvstride, kvstride, nkv);
    mla_load<kMlaRope, kMlaBKV>(sK + kMlaBKV * kMlaNope,
                                kpb + (size_t)kv0 * kMlaRope, kMlaRope, nkv);
    mla_load<kMlaV, kMlaBKV>(sK + kMlaBKV * (kMlaNope + kMlaRope),
                             kvb + (size_t)kv0 * kvstride + kMlaNope, kvstride,
                             nkv);
  };

  mla_load<kMlaNope, kMlaBQ>(sQn, qb, qstride, len - q0);
  mla_load<kMlaRope, kMlaBQ>(sQr, qb + kMlaNope, qstride, len - q0);
  load_kv(0, 0);
  mma::cp_async_commit();

  float acc[VT][4];
#pragma unroll
  for (int n = 0; n < VT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_run[2] = {-FLT_MAX, -FLT_MAX}, l_run[2] = {0.f, 0.f};
  const int row_a = q0 + warp * mma::kRows + g;   // rows row_a, row_a + 8

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
    const bf16* sK = sKV + stage * kMlaStage;
    const int kv0 = t * kMlaBKV;

    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    mla_dots<kMlaNope, NT>(sQn, warp * mma::kRows, sK, s);
    mla_dots<kMlaRope, NT>(sQr, warp * mma::kRows, sK + kMlaBKV * kMlaNope, s);

    // every row sees key kv0 of its tile (kv0 <= q0 <= row), so each
    // row's tile max is finite
    const bool diagonal = kv0 + kMlaBKV > q0;
    float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kv0 + j * 8 + 2 * t4 + (e & 1);
        const int row = row_a + 8 * (e >> 1);
        if (diagonal && (key > row || key >= len)) {
          s[j][e] = -INFINITY;
        } else {
          s[j][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_run[r], mma::quad_max(mx[r]));
      alpha[r] = expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_run[e >> 1]);
        sum[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * alpha[r] + mma::quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < VT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];

    // P as the A fragments of key chunk c: rows g / g + 8, keys 16c + 2t4
    // (+ 8 for registers 2, 3), one bf16 rounding
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int c = 0; c < NT / 2; ++c)
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const float(&src)[4] = s[2 * c + (f >> 1)];
        pa[c][f] = mma::pack_bf16(src[2 * (f & 1)], src[2 * (f & 1) + 1]);
      }
    const bf16* sV = sK + kMlaBKV * (kMlaNope + kMlaRope);
#pragma unroll
    for (int c = 0; c < NT / 2; ++c)
#pragma unroll
      for (int n = 0; n < VT; n += 2) {
        uint32_t b[4];
        mma::ldsm_x4_t(b, sV + mma::at<kMlaV>(c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8,
                                              n * 8 + (lane >> 4) * 8));
        mma::mma_16816(acc[n], pa[c], b[0], b[1]);
        mma::mma_16816(acc[n + 1], pa[c], b[2], b[3]);
      }
    __syncthreads();   // this stage is refilled two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= len) continue;
    const float inv = 1.f / l_run[r];
    bf16* orow = o + ((size_t)(start + row) * H + h) * kMlaV;
#pragma unroll
    for (int n = 0; n < VT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel was launched.  q, kv,
// k_pe, o as above, all 16-byte aligned; cu (n_seqs + 1,) int32 on the
// device, cu[0] = 0; n_tokens = cu[n_seqs]; max_len the longest sequence;
// dh the qk width (192 only) and is_bf16 1 (bf16 only).
extern "C" int flash_fwd_mla_varlen(const void* q, const void* kv,
                                    const void* k_pe, const void* cu, void* o,
                                    int n_seqs, int H, int n_tokens,
                                    int max_len, int dh, int is_bf16,
                                    void* stream) {
  if (n_seqs < 1 || H < 1 || H > 65535 || n_tokens < 1 || max_len < 1 ||
      dh != kMlaQK || !is_bf16 ||
      !mma::vec_ok(8, {q, kv, k_pe, o}))
    return (int)cudaErrorInvalidValue;
  const int n_qtiles = (max_len + kMlaBQ - 1) / kMlaBQ;
  if ((long long)n_seqs * n_qtiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_mla_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMlaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_seqs * n_qtiles, H);
  flash_fwd_mla_kernel<<<grid, mma::kThreads, kMlaSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kv),
      static_cast<const bf16*>(k_pe), static_cast<const int*>(cu),
      static_cast<bf16*>(o), n_seqs, H, n_qtiles, 1.0f / sqrtf((float)kMlaQK));
  return (int)cudaGetLastError();
}
