// The whole `minus` attention block in one kernel, written for Hopper
// (sm_90a).
//
// Replaces the whole-block Pallas kernel of the JAX package,
// multimodal_emotion_processing_tpu/ops/fused_block.py:
//   _forward (:101-134, pallas_call at :109; kernel _fwd_kernel :59-98)
// in four variants: S_prev given or not, times S emitted or not.  (The JAX
// kernel always reads S_prev, zeros when there is none, and always writes
// S; skipping S_prev gives the same bits, as s + c*0 = s.)
//
// Computes, per batch row b and query row i, with D = H*dh:
//   s[h, j]  = the score of csrc/scored_fwd.cu, bit for bit:
//              q_i.k_j/sqrt(dh) (+ c*S_prev[b, h, i, j]) - 1e8*(1 - mask[b, j])
//   S[b, h, i, j] = s[h, j]                         f32, when S is asked for
//   ctx_i    = [softmax(s[h]) . v_h  for h < H]     (D,), f32
//   x_i      = ctx_i . W_proj^T                     W_proj (D, D), torch (out, in)
//   y_i      = q_i . W_minus[:, :D]^T + x_i . W_minus[:, D:]^T
//                                                   W_minus (D, 2D): the
//                                                   reference's Linear over
//                                                   concat[q, x], split
//   out_i    = (y_i - mean) * rsqrt(var + 1e-5) * gamma + beta
//                                                   biased variance, at q's dtype
// and, when asked for, ctx_i at q's dtype as a residual for the backward
// (ops/fused_block.py `FusedMinusBlock`), which recomputes x and y from it.
//
// The scores come only from csrc/scored_mma.cuh's `score_dots` (split-TF32
// tensor-core products, Q as A and K as B) -> flash_common.cuh's
// `chained_score`, with scored_fwd.cu's head-width buckets, so S is
// bit-identical to scored_fwd's, and to the s that csrc/scored_bwd.cu
// rebuilds when it is given no S (FusedMinusBlock's backward, whose forward
// here emits no S on a stream's last block): at -1e8 the f32 spacing is 8 to
// 16, so a fully masked row depends on every score being rounded the same
// way in each kernel.  The dots go through the sP tile, one 16 x 8 mma unit
// per warp, to the 16 x 16 thread mapping of the softmax below.
//
// Layout: q (B, Lq, D), k and v (B, Lkv, D), out and ctx like q, all
// row-major and contiguous; mask (B, Lkv) f32 or null; S_prev and S
// (B, H, Lq, Lkv) f32 or null; the gate c one value of the input dtype on the
// device (read only with S_prev); the weights and the LayerNorm's gamma and
// beta at the input dtype.  Null S_prev selects "no residual term", null S
// "no S write", null ctx "no residual".
//
// Grid: one block per (tile of R query rows, batch row); 256 threads.
//   1. Attention: the block loops over the H heads.  Each head runs
//      scored_fwd's online-softmax kv loop (16 x 16 threads, thread (tx, ty)
//      owning rows ty + 16r, score columns tx + 16c, output columns tx + 16j),
//      writing S tile by tile as it goes, and puts its dh ctx columns into an
//      R x D f32 tile in shared memory.
//   2. x = ctx . W_proj^T into a second R x D tile, which reuses the
//      attention's staging buffers.
//   3. y = x . W_minus[:, D:]^T into the ctx tile; then q's rows are staged
//      into the x tile and y += q . W_minus[:, :D]^T.
//   4. LayerNorm, one warp per row: the mean, then the biased variance of
//      (y - mean), then rsqrt(var + 1e-5), gamma, beta.
// Each output of steps 2 and 3 is one thread's sequential fmaf over the
// contraction.  In those products lane r of a warp owns row r of the tile
// (with R = 16, the two half-warps own two columns), so the lanes of a
// (half-)warp read one weight address, which the weights' L1/L2 residency
// serves as a broadcast (3*D^2 values shared by every block), and 32
// different rows of the tile, whose odd row stride keeps them on 32
// different banks.  R is 32 where shared memory allows it and 16
// otherwise; the wrapper accepts D up to 1024 and dh 1-256, where R = 16
// always fits (<= 150 KB).
//
// What bounds it on an H100: 4*B*H*Lq*Lkv*dh flops for the attention plus
// 6*B*Lq*D^2 for the three products, against q, k, v, the mask and the
// 3*D^2 weights read once, out written once, plus S_prev read, S and ctx
// written where present.  At the mosei_trans shapes (D 96, H 6, dh 16,
// L 20/100/200, f32, B 64) a terminal block (no S_prev, no S) does 15 to
// 85 flops per byte; the card's f32 ridge is ~20 (67 TFLOP/s outside the
// tensor cores over 3.35 TB/s), so flops bound seven of the nine streams
// and bytes the two whose 20 queries read 100 or 200 keys.  A block that
// emits S writes H*Lq*Lkv f32 per sample, at 200 x 200 ~75 % of the
// bytes, and drops to 10-47 flops per byte; with S_prev and ctx too, 7-29.
// The score dots run on the tensor cores (the shared chain above); P.V and
// the epilogue's products still run on scalar f32 FMAs (shared memory for
// the attention, global/L1 weights for the epilogue), and its serial loop
// over heads leaves a small batch's grid short of the card; those, the
// tensor cores for the rest and TMA-fed weight tiles are its redesign.

#include <float.h>

#include "scored_mma.cuh"

namespace {

using namespace flash;

constexpr float kLnEps = 1e-5f;
constexpr int kWarps = kThreads / 32;
constexpr size_t kMaxSmem = 232448;   // 227 KB: what one block may use

// kv tile width per head-width bucket, as csrc/scored_fwd.cu
template <int DH>
struct Tiles {
  static constexpr int BKV = DH <= 64 ? 64 : 32;
  static constexpr int LDS = DH + 1;   // padded rows: conflict-free columns
  static constexpr int LDP = BKV + 1;
};

// the row stride of the R x D tiles: odd, so the 32 rows a warp reads at
// one column fall on 32 different banks
__host__ __device__ __forceinline__ int tile_stride(int D) { return D | 1; }

// shared memory: the ctx / y tile, then the larger of the attention's
// staging buffers (sQ, sK, sV, sP, sNeg) and the x / q tile
template <int DH, int R>
size_t smem_bytes(int D) {
  using Tl = Tiles<DH>;
  const size_t tile = (size_t)R * tile_stride(D);
  const size_t attn = (size_t)R * Tl::LDS + 2 * (size_t)Tl::BKV * Tl::LDS +
                      (size_t)R * Tl::LDP + Tl::BKV;
  return sizeof(float) * (tile + (attn > tile ? attn : tile));
}

// out[r][n] = (out[r][n] +) sum_m a[r][m] * w[n][m] for r < nrows, n < D,
// each a sequential fmaf over m from 0; a and out are R x D tiles with row
// stride LDC, w is (D, ldw) at T.  Lane r % R of a warp owns row r % R and
// the (half-)warp lane / R one column per pass.
template <typename T, int R, bool ACCUMULATE>
__device__ __forceinline__ void tile_times_weights(const float* a, int LDC,
                                                   const T* w, size_t ldw,
                                                   int D, int nrows,
                                                   float* out) {
  constexpr int CPW = 32 / R;   // columns per warp and pass
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r = lane % R;
  if (r >= nrows) return;
  const float* ar = a + r * LDC;
  for (int n = warp * CPW + lane / R; n < D; n += kWarps * CPW) {
    const T* wn = w + (size_t)n * ldw;
    float acc = 0.f;
    for (int m = 0; m < D; ++m) acc = fmaf(ar[m], to_f32(wn[m]), acc);
    float* o = out + r * LDC + n;
    *o = ACCUMULATE ? *o + acc : acc;
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int DH, int R>
__global__ void __launch_bounds__(kThreads)
fused_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ s_prev, const T* __restrict__ c,
                   const T* __restrict__ w_proj, const T* __restrict__ w_minus,
                   const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                   T* __restrict__ out, float* __restrict__ s_out,
                   T* __restrict__ ctx_out, int Lq, int Lkv, int H, int dh,
                   float scale) {
  constexpr int BKV = Tiles<DH>::BKV;
  constexpr int LDS = Tiles<DH>::LDS;
  constexpr int LDP = Tiles<DH>::LDP;
  constexpr int RM = R / kTY;     // query rows per thread
  constexpr int CN = BKV / kTX;   // score columns per thread
  constexpr int DN = DH / kTX;    // output columns per thread

  const int D = H * dh;
  const int LDC = tile_stride(D);
  extern __shared__ float smem[];
  float* sC = smem;               // ctx, then y
  float* sQ = sC + R * LDC;       // the attention's staging buffers ...
  float* sK = sQ + R * LDS;
  float* sV = sK + BKV * LDS;
  float* sP = sV + BKV * LDS;
  float* sNeg = sP + R * LDP;
  float* sX = sQ;                 // ... then x, then q

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int q0 = blockIdx.x * R;
  const int b = blockIdx.y;
  const int nrows = min(R, Lq - q0);
  const size_t Dz = D;
  const T* qb = q + (size_t)b * Lq * Dz;
  const T* kb = k + (size_t)b * Lkv * Dz;
  const T* vb = v + (size_t)b * Lkv * Dz;
  const float* mb = mask ? mask + (size_t)b * Lkv : nullptr;
  const float cv = s_prev ? to_f32(c[0]) : 0.f;

  // 1. attention, head by head, into the ctx tile
  for (int h = 0; h < H; ++h) {
    const int c0 = h * dh;
    // row (b, h, i) of S_prev and S starts at (head_row0 + i) * Lkv
    const size_t head_row0 = ((size_t)b * H + h) * Lq;
    __syncthreads();  // the last head's readers of sQ, sK, sV, sP are done
    stage_rows<T, DH, LDS>(sQ, qb + c0, Dz, q0, R, Lq - q0, dh);

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
      __syncthreads();  // sQ is written; the last tile's readers are done
      stage_rows<T, DH, LDS>(sK, kb + c0, Dz, kv0, BKV, nkv, dh);
      stage_rows<T, DH, LDS>(sV, vb + c0, Dz, kv0, BKV, nkv, dh);
      for (int j = tid; j < BKV; j += kThreads)
        sNeg[j] = j < nkv ? mask_penalty(mb, kv0 + j) : 0.f;
      __syncthreads();

      // the raw dots from scored_mma.cuh's chain, one 16-row x 8-key unit
      // per warp in turn, through sP to this kernel's 16 x 16 mapping
      for (int u = tid / 32; u < (R / 16) * (BKV / 8); u += kWarps) {
        const int rs = 16 * (u / (BKV / 8)), ks = 8 * (u % (BKV / 8));
        const int g = (tid & 31) >> 2, t = tid & 3;
        float d[1][4];
        tf32::score_dots<DH, 1, LDS>(sQ, rs, sK, ks, d);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sP[(rs + g + 8 * (e >> 1)) * LDP + ks + 2 * t + (e & 1)] = d[0][e];
      }
      __syncthreads();
      float s[RM][CN];
#pragma unroll
      for (int r = 0; r < RM; ++r)
#pragma unroll
        for (int cc = 0; cc < CN; ++cc)
          s[r][cc] = sP[(ty + kTY * r) * LDP + tx + kTX * cc];

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
      const int rl = ty + kTY * r;
      if (rl >= nrows) continue;
      const float inv = 1.f / l_run[r];  // l >= 1: the row max contributes exp(0)
      T* crow = ctx_out ? ctx_out + ((size_t)b * Lq + q0 + rl) * Dz + c0 : nullptr;
#pragma unroll
      for (int j = 0; j < DN; ++j) {
        const int d = tx + kTX * j;
        if (d < dh) {
          const float val = acc[r][j] * inv;
          sC[rl * LDC + c0 + d] = val;
          if (crow) store(crow + d, val);
        }
      }
    }
  }
  __syncthreads();  // the ctx tile is whole; the staging buffers are free

  // 2. x = ctx . W_proj^T
  tile_times_weights<T, R, false>(sC, LDC, w_proj, Dz, D, nrows, sX);
  __syncthreads();  // x is whole; ctx is read no more

  // 3. y = x . W_minus[:, D:]^T, then y += q . W_minus[:, :D]^T
  tile_times_weights<T, R, false>(sX, LDC, w_minus + Dz, 2 * Dz, D, nrows, sC);
  __syncthreads();  // x is read no more
  for (int i = tid; i < nrows * D; i += kThreads) {
    const int r = i / D, m = i - r * D;
    sX[r * LDC + m] = to_f32(qb[(size_t)(q0 + r) * Dz + m]);
  }
  __syncthreads();
  tile_times_weights<T, R, true>(sX, LDC, w_minus, 2 * Dz, D, nrows, sC);
  __syncthreads();

  // 4. LayerNorm, one warp per row
  const int warp = tid / 32, lane = tid % 32;
  const float inv_d = 1.f / (float)D;
  for (int r = warp; r < nrows; r += kWarps) {
    const float* y = sC + r * LDC;
    float sum = 0.f;
    for (int n = lane; n < D; n += 32) sum += y[n];
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.f;
    for (int n = lane; n < D; n += 32) {
      const float dv = y[n] - mean;
      sq = fmaf(dv, dv, sq);
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + kLnEps);
    T* orow = out + ((size_t)b * Lq + q0 + r) * Dz;
    for (int n = lane; n < D; n += 32)
      store(orow + n, (y[n] - mean) * rstd * to_f32(ln_w[n]) + to_f32(ln_b[n]));
  }
}

struct Args {
  const void *q, *k, *v, *mask, *s_prev, *c, *w_proj, *w_minus, *ln_w, *ln_b;
  void *out, *s_out, *ctx_out;
  int B, H, Lq, Lkv, dh;
};

template <typename T, int DH, int R>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<DH, R>(a.H * a.dh);
  cudaError_t err = cudaFuncSetAttribute(
      fused_block_kernel<T, DH, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Lq + R - 1) / R, a.B);
  fused_block_kernel<T, DH, R><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.s_prev), static_cast<const T*>(a.c),
      static_cast<const T*>(a.w_proj), static_cast<const T*>(a.w_minus),
      static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b),
      static_cast<T*>(a.out), static_cast<float*>(a.s_out),
      static_cast<T*>(a.ctx_out), a.Lq, a.Lkv, a.H, a.dh, score_scale(a.dh));
  return cudaGetLastError();
}

// R = 32 query rows where shared memory allows it, else 16
template <typename T, int DH>
cudaError_t pick_rows(const Args& a, cudaStream_t s) {
  if (smem_bytes<DH, 32>(a.H * a.dh) <= kMaxSmem) return launch<T, DH, 32>(a, s);
  if (smem_bytes<DH, 16>(a.H * a.dh) <= kMaxSmem) return launch<T, DH, 16>(a, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.dh <= 16) return pick_rows<T, 16>(a, s);
  if (a.dh <= 32) return pick_rows<T, 32>(a, s);
  if (a.dh <= 64) return pick_rows<T, 64>(a, s);
  if (a.dh <= 128) return pick_rows<T, 128>(a, s);
  return pick_rows<T, 256>(a, s);
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel was launched.  s_prev and
// s_out are each null or (B, H, Lq, Lkv) f32; c (one value of the input
// dtype) must be given with s_prev; ctx_out is null or like q.  D = H*dh is
// at most 1024.
extern "C" int fused_block(const void* q, const void* k, const void* v,
                           const void* mask, const void* s_prev, const void* c,
                           const void* w_proj, const void* w_minus,
                           const void* ln_w, const void* ln_b, void* out,
                           void* s_out, void* ctx_out, int B, int H, int Lq,
                           int Lkv, int dh, int is_bf16, void* stream) {
  if (B < 1 || H < 1 || Lq < 1 || Lkv < 1 || dh < 1 || dh > 256 ||
      (long long)H * dh > 1024 || B > 65535 ||
      (s_prev != nullptr && c == nullptr) || !q || !k || !v || !w_proj ||
      !w_minus || !ln_w || !ln_b || !out)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, mask, s_prev, c, w_proj, w_minus, ln_w, ln_b,
               out, s_out, ctx_out, B, H, Lq, Lkv, dh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s));
}
