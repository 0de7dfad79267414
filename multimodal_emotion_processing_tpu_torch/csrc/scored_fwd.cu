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
// order, so a small grid's blocks run a quarter of the steps each.  That
// per-head body is csrc/scored_head.cuh `attend_head`, which
// csrc/fused_block.cu runs too; this kernel normalises its rows and stores
// ctx and the stats.
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

#include "scored_head.cuh"

namespace {

using namespace flash;
using namespace flash::tf32;

template <int DH>
size_t smem_bytes(int slabs) {
  return sizeof(float) * head_floats<DH>(slabs);
}

// the block's head and batch row, read afresh where they are used: volatile,
// so that the reads after the key loop are not merged with those before it
// and kept live across it (at dh 128 the loop needs every register)
__device__ __forceinline__ int sreg_head() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int sreg_batch_row() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.z;\n" : "=r"(r));
  return (int)r;
}

template <typename T, int DH>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
scored_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ mask,
                  const float* __restrict__ s_prev, const T* __restrict__ c,
                  T* __restrict__ o, float* __restrict__ s_out,
                  float* __restrict__ stats, int B, int Lq, int Lkv, int H,
                  int dh, float scale, bool vec, int slabs) {
  extern __shared__ float smem[];
  HeadRows<DH> r;
  {
    const int h = sreg_head(), b = sreg_batch_row();
    const size_t D = (size_t)H * dh;
    // row (b, h, i) of S_prev and S starts at (head_row0 + i) * Lkv
    if (!attend_head<T, DH>(
            smem, q + (size_t)b * Lq * D + (size_t)h * dh,
            k + (size_t)b * Lkv * D + (size_t)h * dh,
            v + (size_t)b * Lkv * D + (size_t)h * dh,
            mask ? mask + (size_t)b * Lkv : nullptr, s_prev, s_out,
            ((size_t)b * H + h) * Lq, s_prev ? to_f32(c[0]) : 0.f, D,
            blockIdx.x * kRows * slabs, Lq, Lkv, dh, scale, vec, slabs, r))
      return;
  }

  const int t = threadIdx.x & 3;
  const int h = sreg_head(), b = sreg_batch_row();
  const size_t D = (size_t)H * dh;
  const size_t head_row0 = ((size_t)b * H + h) * Lq;
  const size_t n_rows = (size_t)B * H * Lq;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (!r.live[hr]) continue;
    // l >= 1 (the row max contributes exp(0)): the fast reciprocal, which
    // has no slow path for tiny or huge divisors and so no call
    const float inv = __fdividef(1.f, r.l[hr]);
    T* orow = o + ((size_t)b * Lq + r.row[hr]) * D + (size_t)h * dh;
#pragma unroll
    for (int n = 0; n < DH / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * n + 2 * t + e;
        if (d < dh) store(orow + d, r.acc[n][2 * hr + e] * inv);
      }
    if (stats && t == 0) {
      stats[head_row0 + r.row[hr]] = r.m[hr];
      stats[n_rows + head_row0 + r.row[hr]] = r.l[hr];
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
