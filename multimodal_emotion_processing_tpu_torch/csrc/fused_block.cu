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
// (ops/fused_block.py `FusedMinusBlock`, which recomputes x and y from it)
// and each head's row stats m = max_j s, l = sum_j exp(s - m), as
// scored_fwd writes them, so that csrc/scored_bwd.cu's dq sweeps the keys
// once.
//
// Layout: q (B, Lq, D), k and v (B, Lkv, D), out and ctx like q, all
// row-major and contiguous; mask (B, Lkv) f32 or null; S_prev and S
// (B, H, Lq, Lkv) f32 or null; stats (2, B, H, Lq) f32 or null; the gate c
// one value of the input dtype on the device (read only with S_prev); the
// weights and the LayerNorm's gamma and beta at the input dtype.
//
// Grid: one thread-block cluster of C = min(H, 8) blocks of four warps per
// (tile of R = 16 or 32 query rows, batch row): grid (C * tiles, B),
// cluster (C, 1, 1); block rank r of a cluster takes heads r, r + C, ...
// (the tiles run along x with the cluster, so Lq is bounded as before by
// 2^31 blocks, not by grid.y's 65535).  R is 32 where that still gives 2.5
// waves of blocks on the card's SMs and shared memory holds it, else 16
// (always at D 1024).  A block's epilogue costs about as much as its
// attention at dh 16, so fewer, larger blocks win until the card runs
// short of them; 64-row tiles were slower at the mosei_trans shapes, with
// fewer blocks an SM.  ren_mme at B 8 runs 192, 320 and 576 blocks for Lq
// 40, 76 and 275, where one block per (tile of 32 rows, batch row) ran 16,
// 24 and 72.
//   1. Attention, head by head: csrc/scored_head.cuh `attend_head`, the
//      body of scored_fwd (raw dots from scored_mma.cuh `score_dots`, then
//      flash_common.cuh `chained_score`, so S is bit-identical to
//      scored_fwd's and to the s that scored_bwd rebuilds; online softmax in
//      the mma accumulator layout; P.V on the tensor cores by `mma_regA`;
//      a small tile's warps split its keys).  Each head's ctx columns go
//      into the block's R x D tile sC, and to the residual and stats.
//   2. The block arrives at the cluster barrier, stages q and computes
//      y = q . W_minus[:, :D]^T for its own 8-column tiles n = r, r + C, ...
//      (D 96 over 6 blocks and D 128 over 8 give 2 each, D 1024 over 8
//      gives 16), which needs no peer, and then waits: that product fills
//      the time the cluster's slowest head takes.
//   3. It copies its peers' ctx columns into its own sC through distributed
//      shared memory, computes x = ctx . W_proj^T for its own tiles, and
//      after a second cluster barrier copies its peers' x tiles, so that
//      y += x . W_minus[:, D:]^T.  The three products run on split-TF32
//      mma.sync (scored_mma.cuh `mma_rowsW`: each f32 operand as hi + lo
//      TF32 terms, three products, k in 16-deep slices from zero added in
//      f32 to the output tile in shared memory).  The block's rows of the
//      three weights stream through a ring of their own as one sequence of
//      k-chunks by cp.async (3*D^2/C values in all, which at D 1024 do not
//      fit at once: at D 96 and 128 all three are copied at once, at the
//      kernel's start, so they land during the attention; at D 1024 in
//      32-wide chunks, one always in flight).  A warp takes (16-row slab,
//      tile) units.  A bf16 input is exact in TF32: its lo terms are 0.
//   4. LayerNorm across the cluster: each block writes its rows' partial
//      sum of y over its own columns into every block of the cluster; each
//      adds the C partials in rank order 0 .. C-1 (the same bits in every
//      block, whatever the timing), then the same for sum (y - mean)^2,
//      rsqrt(var + 1e-5), and writes its own columns with gamma and beta.
//      After that second exchange no block touches a peer's shared memory,
//      so its barrier is the last.
//
// What bounds it on an H100: 4*B*H*Lq*Lkv*dh flops for the attention plus
// 6*B*Lq*D^2 for the three products, against q, k, v, the mask and the
// 3*D^2 weights read once, out written once, plus S_prev read, S, ctx and
// the stats written where present.  Every product runs on the tensor cores
// as three TF32 terms: 495/3 TFLOP/s of f32 work (scalar f32 FMAs give 67),
// whose ridge over 3.35 TB/s is ~49 flops per byte.  At the mosei_trans
// shapes (D 96, f32, no S) a call does 15 to 86 flops per byte, so bytes
// bound the streams whose 20 queries or 20 keys are short and operations
// the others; a block that emits S writes H*Lq*Lkv f32 per sample, most of
// its bytes.  The design keeps every intermediate (ctx, x, y) on chip, runs
// the heads of a row tile in parallel (a batch-8 grid has C times the
// blocks) and takes no product on scalar FMAs.  What holds it above that
// bound is latency: a block's epilogue is a chain of dependent steps
// (cluster barriers, copies between the blocks' shared memories, three
// short products, the LayerNorm's two exchanges) with few blocks an SM to
// hide it; at dh 16 it takes about as many cycles as the attention.

#include <cooperative_groups.h>

#include "scored_head.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flash;
using namespace flash::tf32;

constexpr float kLnEps = 1e-5f;
constexpr int kClusterMax = 8;          // the portable cluster size
constexpr int kThreadsBlk = 32 * kMaxWarps;
constexpr size_t kMaxSmem = 232448;     // 227 KB: what one block may use
// the weight ring: three buffers of all of K where they fit in this many
// bytes (D 96 and 128: the three products' chunks are all copied at once),
// else two buffers of KC columns, KC the widest multiple of 32 that divides
// KP within it (32 columns at D 1024)
constexpr size_t kRingBudget = 32 * 1024;

// blocks an SM in the launch bounds: at dh 16 (both models' heads) the
// kernel fits 128 registers, so four blocks of four warps share an SM;
// wider heads need up to 255 registers
template <int DH>
constexpr int min_blocks() { return DH <= 16 ? 4 : kMinBlocks; }

// The shared memory of a block, in floats: sC (R x LDC: ctx), the weight
// ring (NB x NW x LDW), then sX (R x LDC: q, then x), sY (R x LDY: y of
// the own tiles), the LayerNorm's partials [2][8][R] (one row of R per
// block of the cluster, which each block writes into all of them), its row
// stats [2][R] and gamma, beta of the own columns [2][NW].  The attention's
// staging (scored_head.cuh) aliases everything from sX on, which it leaves
// before the epilogue starts; the ring is its own, so the weights come in
// during the attention.  LDC = KP + 4 and LDW = KC + 4 with KP and KC
// multiples of 32, so the 8 rows x 4 columns of a fragment load fall on 32
// different banks; LDY is odd, so a thread a row reads sY on as many banks.
struct Layout {
  int R, LDC, NW, LDW, LDY, NB;
  __host__ __device__ Layout(int slabs, int KP, int nw, int KC, int nb)
      : R(kRows * slabs), LDC(KP + 4), NW(nw), LDW(KC + 4), LDY(nw + 1),
        NB(nb) {}
  __host__ __device__ size_t ring() const { return (size_t)R * LDC; }
  __host__ __device__ size_t x() const {
    return ring() + (size_t)NB * NW * LDW;
  }
  __host__ __device__ size_t y() const { return x() + (size_t)R * LDC; }
  __host__ __device__ size_t red() const { return y() + (size_t)R * LDY; }
  __host__ __device__ size_t row_stats() const {
    return red() + 2 * (size_t)kClusterMax * R;
  }
  __host__ __device__ size_t gb() const { return row_stats() + 2 * (size_t)R; }
  __host__ __device__ size_t end() const { return gb() + 2 * (size_t)NW; }
};

template <int DH>
size_t smem_bytes(const Layout& L, int slabs) {
  const size_t attn = L.x() + head_floats<DH>(slabs);
  return sizeof(float) * (attn > L.end() ? attn : L.end());
}

// The block's rows of the three products' weights as one stream of chunks,
// in the order the kernel takes the products: item i is chunk i % nk of
// W_minus[:, :D] (i < nk), W_proj (i < 2 nk) or W_minus[:, D:], staged into
// ring buffer i % NB: NB = 3 holds the three items of nk = 1 at once, NB =
// 2 streams them with one in flight.  Ring row r holds W row 8 (rank + C (r
// / 8)) + r % 8; rows and columns past D are zero.
template <typename T>
struct WeightStream {
  const T* w_proj;
  const T* w_minus;
  float* ring;
  int D, KC, nk, rank, C, rows, NW, LDW, NB;
  bool vec;   // f32, D % 4 == 0, 16-byte aligned: cp.async 16-byte copies

  __device__ float* buffer(int i) const {
    return ring + (i % NB) * (size_t)NW * LDW;
  }

  // start copying item i, as its own cp.async group
  __device__ void issue(int i) const {
    const int p = i / nk, k0 = (i - p * nk) * KC;
    const T* w = p == 1 ? w_proj : w_minus + (p == 2 ? D : 0);
    const size_t ldw = p == 1 ? (size_t)D : 2 * (size_t)D;
    float* buf = buffer(i);
    if constexpr (sizeof(T) == sizeof(float)) {
      if (vec) {
        const int cpr = KC / 4;
        for (int j = threadIdx.x; j < rows * cpr; j += blockDim.x) {
          const int r = j / cpr, c = 4 * (j - r * cpr);
          const int n = 8 * (rank + C * (r >> 3)) + (r & 7);
          const bool real = n < D && k0 + c < D;
          mma::cp_async16(buf + r * LDW + c,
                          real ? w + (size_t)n * ldw + k0 + c : w, real);
        }
        mma::cp_async_commit();
        return;
      }
    }
    for (int j = threadIdx.x; j < rows * KC; j += blockDim.x) {
      const int r = j / KC, c = j - r * KC;
      const int n = 8 * (rank + C * (r >> 3)) + (r & 7);
      buf[r * LDW + c] =
          n < D && k0 + c < D ? to_f32(w[(size_t)n * ldw + k0 + c]) : 0.f;
    }
    mma::cp_async_commit();
  }
};

// sOut[r][8 (off + stride j) + i] (+)= sum_k sA[r][k] * W[8 (rank + C j) +
// i][k] for the block's own tiles j < own and every row r < R, over the
// stream's items i0 .. i0 + nk - 1 (one product).  Every item is issued
// before it is needed: the first (with NB = 3 all three) at the kernel's
// start, and with NB = 2 each item issues the next one.  A warp takes (row slab, tile)
// units; each 32-column part of a chunk is two 16-deep slices added to the
// unit's output in f32, from zero where `first`.  Ends with the block
// synced.
template <typename T>
__device__ void own_product(const WeightStream<T>& ws, int i0, const float* sA,
                            int LDC, float* sOut, int ldo, int off,
                            int stride, bool first, int own, int R) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int g = lane >> 2, t = lane & 3;
  const int units = (R / kRows) * own;
  for (int i = i0; i < i0 + ws.nk; ++i) {
    // the copies in flight, oldest first: NB = 2: item i (the attention
    // waited for item 0), q's tile at i = 0, item i + 1; NB = 3: q's tile
    // (the attention waited for the three items)
    if (ws.NB == 2 && i + 1 < 3 * ws.nk) {
      ws.issue(i + 1);
      mma::cp_async_wait<1>();
    } else {
      mma::cp_async_wait<0>();
    }
    __syncthreads();  // item i (and every earlier copy) landed
    const float* cur = ws.buffer(i);
    const int k0 = (i - i0) * ws.KC;
    for (int u = warp; u < units; u += kMaxWarps) {
      const int slab = u / own, j = u - slab * own;
      float* po =
          sOut + (kRows * slab + g) * ldo + 8 * (off + stride * j) + 2 * t;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (!first || i > i0) {
        acc[0] = po[0];
        acc[1] = po[1];
        acc[2] = po[8 * ldo];
        acc[3] = po[8 * ldo + 1];
      }
      for (int kk = 0; kk < ws.KC; kk += 32)
        mma_rowsW<32>(acc, sA, LDC, kRows * slab, k0 + kk, cur + kk, ws.LDW,
                      8 * j);
      po[0] = acc[0];
      po[1] = acc[1];
      po[8 * ldo] = acc[2];
      po[8 * ldo + 1] = acc[3];
    }
    __syncthreads();  // item i is read: its buffer may be restaged
  }
}

// q rows row0 .. row0 + rows - 1 (zero past n_real), all D columns (zero
// to KP), into f32 rows LDC apart, as one cp.async group where `vec`
template <typename T>
__device__ __forceinline__ void stage_q(float* dst, int LDC, const T* src,
                                        int D, int row0, int rows, int n_real,
                                        int KP, bool vec) {
  if constexpr (sizeof(T) == sizeof(float)) {
    if (vec) {
      const int cpr = KP / 4;
      for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
        const int r = i / cpr, c = 4 * (i - r * cpr);
        const bool real = r < n_real && c < D;
        mma::cp_async16(dst + r * LDC + c,
                        real ? src + (size_t)(row0 + r) * D + c : src, real);
      }
      mma::cp_async_commit();
      return;
    }
  }
  for (int i = threadIdx.x; i < rows * KP; i += blockDim.x) {
    const int r = i / KP, c = i - r * KP;
    dst[r * LDC + c] = r < n_real && c < D
                           ? to_f32(src[(size_t)(row0 + r) * D + c]) : 0.f;
  }
}

// the address of `p` (this block's shared memory) in block `rank` of the
// cluster, for ld / st.shared::cluster
__device__ __forceinline__ uint32_t peer_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(mma::smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float4 ld_peer4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ float ld_peer(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void st_peer(uint32_t a, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}

// copy the peers' columns into this block's tile (same offsets in every
// block): columns c < ncols of rows r < nrows whose owner(c) is not
// `rank`, four floats at a time (owner(c) is constant over each aligned
// four), four loads in flight a thread
template <typename Owner>
__device__ __forceinline__ void gather_peers(float* tile, int LDC, int nrows,
                                             int ncols, int rank, Owner owner) {
  const int per_row = ncols / 4, n = nrows * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * blockDim.x) {
    float4 val[4];
    float* at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * blockDim.x;
      at[u] = nullptr;
      if (i < n) {
        const int r = i / per_row, c = 4 * (i - r * per_row);
        const int p = owner(c);
        if (p != rank) {
          at[u] = tile + r * LDC + c;
          val[u] = ld_peer4(peer_addr(at[u], p));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u]) *reinterpret_cast<float4*>(at[u]) = val[u];
  }
}

// each row's partial over this block's own columns, one thread a row in
// column order: sum y, or with `mean` sum (y - mean)^2; written to slot
// `rank` of dst in every block of the cluster
__device__ __forceinline__ void post_partials(const float* sY, int LDY, int R,
                                              int own, int rank, int C, int D,
                                              const float* mean, float* dst) {
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < own; ++j)
      for (int i = 0; i < 8; ++i) {
        if (8 * (rank + C * j) + i >= D) break;
        const float y = sY[r * LDY + 8 * j + i];
        if (mean) {
          const float dv = y - mean[r];
          s = fmaf(dv, dv, s);
        } else {
          s += y;
        }
      }
    for (int p = 0; p < C; ++p) st_peer(peer_addr(dst + rank * R + r, p), s);
  }
}

// the C partials of row r (slots 0 .. C-1 of R floats), added in rank order
__device__ __forceinline__ float rank_sum(const float* part, int R, int r,
                                          int C) {
  float tot = 0.f;
  for (int p = 0; p < C; ++p) tot += part[p * R + r];
  return tot;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// special registers, read afresh where they are used: volatile, so the
// epilogue's reads are not merged with the attention's and kept live
// across its register-heavy key loop
__device__ __forceinline__ int sreg_cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int sreg_cluster_size() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int sreg_cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return (int)r;
}

__device__ __forceinline__ int sreg_batch_row() {
  unsigned r;
  asm volatile("mov.u32 %0, %%ctaid.y;\n" : "=r"(r));
  return (int)r;
}

// 1. attention for heads rank, rank + C, ...: ctx columns into sC (R x
// KP + 4 at smem), the ctx residual and the row stats; the attention's
// tiles at smem + stage_off (an offset, not a pointer, so that the
// compiler can rebuild the address from the kernel's parameters rather than
// hold it in registers across the key loop)
template <typename T, int DH>
__device__ __forceinline__ void attention_phase(
    const T* q, const T* k, const T* v, const float* mask,
    const float* s_prev, const T* c, float* s_out, T* ctx_out, float* stats,
    int B, int Lq, int Lkv, int H, int dh, float scale, bool vec, int slabs,
    int KP, float* smem, int stage_off) {
  const int R = kRows * slabs, LDC = KP + 4, D = H * dh;
  float* sC = smem;
  // ctx's pad columns D .. KP - 1 meet zero weights: they must be finite
  for (int i = threadIdx.x; i < R * (KP - D); i += blockDim.x) {
    const int r = i / (KP - D);
    sC[r * LDC + D + (i - r * (KP - D))] = 0.f;
  }
  // the cluster's rank and size, the tile and the batch row are read from
  // their special registers where they are used, none held across the key
  // loop
  for (int h = sreg_cluster_rank(); h < H; h += sreg_cluster_size()) {
    // after the block's first head: the last head's staging is read
    if (h >= sreg_cluster_size()) __syncthreads();
    const int b = sreg_batch_row();
    const size_t head_row0 = ((size_t)b * H + h) * Lq;
    const size_t kvoff = ((size_t)b * Lkv) * D + (size_t)h * dh;
    HeadRows<DH> hr;
    // at dh 128 and 256, two chunks of the score dots at a time keep the
    // key loop free of spills
    if (!attend_head<T, DH, (DH >= 128 ? 2 : 0)>(
            smem + stage_off, q + ((size_t)b * Lq) * D + (size_t)h * dh,
            k + kvoff, v + kvoff, mask ? mask + (size_t)b * Lkv : nullptr,
            s_prev, s_out, head_row0, s_prev ? to_f32(c[0]) : 0.f, D,
            sreg_cluster_id() * R, Lq, Lkv, dh, scale, vec, slabs, hr))
      continue;
    const int t = threadIdx.x & 3;
    const size_t n_rows = (size_t)B * H * Lq;
    // the warp's first row in the tile: its slab's
    const int r0 = kRows * ((threadIdx.x / 32) % slabs);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      if (!hr.live[e2]) continue;
      const float inv = __fdividef(1.f, hr.l[e2]);   // l >= 1
      float* crow = sC + (r0 + (threadIdx.x & 31) / 4 + 8 * e2) * LDC + h * dh;
      T* grow = ctx_out ? ctx_out +
                              ((size_t)sreg_batch_row() * Lq + hr.row[e2]) * D +
                              (size_t)h * dh
                        : nullptr;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = 8 * n + 2 * t + e;
          if (d < dh) {
            const float val = hr.acc[n][2 * e2 + e] * inv;
            crow[d] = val;
            if (grow) store(grow + d, val);
          }
        }
      if (stats && t == 0) {
        stats[head_row0 + hr.row[e2]] = hr.m[e2];
        stats[n_rows + head_row0 + hr.row[e2]] = hr.l[e2];
      }
    }
  }
}

template <typename T, int DH>
__global__ void __launch_bounds__(kThreadsBlk, min_blocks<DH>())
fused_block_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ mask,
                   const float* __restrict__ s_prev, const T* __restrict__ c,
                   const T* __restrict__ w_proj, const T* __restrict__ w_minus,
                   const T* __restrict__ ln_w, const T* __restrict__ ln_b,
                   T* __restrict__ out, float* __restrict__ s_out,
                   T* __restrict__ ctx_out, float* __restrict__ stats, int B,
                   int Lq, int Lkv, int H, int dh, float scale, bool vec,
                   bool dvec, int slabs, int KP, int NW, int KC, int NB,
                   int ring_off, int stage_off) {
  // ring_off and stage_off are Layout's ring() and x(), from the host: the
  // epilogue's Layout is built after the attention, so that none of it
  // stays live in registers across the attention's key loop
  extern __shared__ __align__(16) float smem[];
  {
    // the first weight chunk (with NB = 3 all three) comes in under the
    // attention
    const int C = sreg_cluster_size(), rank = sreg_cluster_rank();
    const int NT = (H * dh + 7) / 8;
    const WeightStream<T> ws{w_proj, w_minus, smem + ring_off, H * dh, KC,
                             KP / KC, rank, C, 8 * ((NT - rank + C - 1) / C),
                             NW, KC + 4, NB, dvec};
    for (int i = 0; i < (NB == 3 ? 3 : 1); ++i) ws.issue(i);
  }
  attention_phase<T, DH>(q, k, v, mask, s_prev, c, s_out, ctx_out, stats, B,
                         Lq, Lkv, H, dh, scale, vec, slabs, KP, smem,
                         stage_off);

  const Layout L(slabs, KP, NW, KC, NB);
  const int C = sreg_cluster_size(), rank = sreg_cluster_rank();
  const int R = kRows * slabs, LDC = KP + 4, D = H * dh;
  const int q0 = sreg_cluster_id() * R, b = sreg_batch_row();
  const int NT = (D + 7) / 8;                 // 8-column output tiles
  const int own = (NT - rank + C - 1) / C;    // this block's: rank + C j
  const int nrows = min(R, Lq - q0);
  float* sC = smem;
  float* sX = smem + L.x();
  float* sY = smem + L.y();
  float* sRed = smem + L.red();
  float* sStat = smem + L.row_stats();
  float* sGB = smem + L.gb();
  const WeightStream<T> ws{w_proj, w_minus, smem + L.ring(), D, KC, KP / KC,
                           rank, C, 8 * own, NW, L.LDW, NB, dvec};

  __syncthreads();  // the attention's staging is free
  // gamma and beta of the own columns
  for (int i = threadIdx.x; i < 8 * own; i += blockDim.x) {
    const int col = 8 * (rank + C * (i >> 3)) + (i & 7);
    sGB[i] = col < D ? to_f32(ln_w[col]) : 0.f;
    sGB[NW + i] = col < D ? to_f32(ln_b[col]) : 0.f;
  }
  cluster_arrive();   // A: this block's ctx columns are in its sC

  // 2. y = q . W_minus[:, :D]^T, the own tiles into sY, while the slowest
  // head of the cluster finishes (q's pad columns stay x's)
  stage_q<T>(sX, LDC, q + (size_t)b * Lq * D, D, q0, R, nrows, KP, dvec);
  own_product<T>(ws, 0, sX, LDC, sY, L.LDY, 0, 1, true, own, R);
  cluster_wait();     // A: every block's ctx columns are in place

  // 3. the peers' ctx columns (head h's belong to block h % C), then
  // x = ctx . W_proj^T, the own tiles into sX
  if (dh % 4 == 0) {
    gather_peers(sC, LDC, nrows, D, rank,
                 [=](int col) { return (col / dh) % C; });
  } else {
    for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
      const int r = i / D, col = i - r * D;
      const int p = (col / dh) % C;
      if (p != rank)
        sC[r * LDC + col] = ld_peer(peer_addr(sC + r * LDC + col, p));
    }
  }
  own_product<T>(ws, ws.nk, sC, LDC, sX, LDC, rank, C, true, own, R);
  cg::this_cluster().sync();   // B: every block's x tiles are in its sX
  // the peers' x tiles (tile n belongs to block n % C), then
  // y += x . W_minus[:, D:]^T
  gather_peers(sX, LDC, nrows, 8 * NT, rank,
               [=](int col) { return (col / 8) % C; });
  own_product<T>(ws, 2 * ws.nk, sX, LDC, sY, L.LDY, 0, 1, false, own, R);

  // 4. LayerNorm across the cluster, the partials added in rank order
  const float inv_d = 1.f / (float)D;
  float* sRed2 = sRed + kClusterMax * R;
  post_partials(sY, L.LDY, R, own, rank, C, D, nullptr, sRed);
  cg::this_cluster().sync();   // C: every block's sums of y are in each
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    sStat[r] = rank_sum(sRed, R, r, C) * inv_d;
  __syncthreads();
  post_partials(sY, L.LDY, R, own, rank, C, D, sStat, sRed2);
  // D: every block's sums of (y - mean)^2 are in each; the last access of
  // a peer's shared memory, so no block exits while a peer still needs it
  cg::this_cluster().sync();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    sStat[R + r] = rsqrtf(rank_sum(sRed2, R, r, C) * inv_d + kLnEps);
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * 8 * own; i += blockDim.x) {
    const int r = i / (8 * own), lc = i - r * 8 * own;
    const int col = 8 * (rank + C * (lc >> 3)) + (lc & 7);
    if (col >= D) continue;
    store(out + ((size_t)b * Lq + q0 + r) * D + col,
          (sY[r * L.LDY + lc] - sStat[r]) * sStat[R + r] * sGB[lc] +
              sGB[NW + lc]);
  }
}

struct Args {
  const void *q, *k, *v, *mask, *s_prev, *c, *w_proj, *w_minus, *ln_w, *ln_b;
  void *out, *s_out, *ctx_out, *stats;
  int B, H, Lq, Lkv, dh;
};

// the geometry of one call
struct Plan {
  int C, slabs, KP, NW, KC, NB, tiles;
  size_t smem;
};

template <int DH>
cudaError_t make_plan(const Args& a, Plan& p) {
  const int D = a.H * a.dh;
  p.C = a.H < kClusterMax ? a.H : kClusterMax;
  p.KP = (D + 31) / 32 * 32;
  p.NW = ((D + 7) / 8 + p.C - 1) / p.C * 8;
  p.KC = 32;
  p.NB = 2;
  if (3 * sizeof(float) * p.NW * (p.KP + 4) <= kRingBudget) {
    p.KC = p.KP;
    p.NB = 3;
  } else {
    for (int m = p.KP / 32; m > 1; --m)
      if ((p.KP / 32) % m == 0 &&
          2 * sizeof(float) * p.NW * (32 * m + 4) <= kRingBudget) {
        p.KC = 32 * m;
        break;
      }
  }
  // row slabs: two, one where half the tile would be past Lq, the grid
  // would be under 2.5 waves of the card's SMs or shared memory does not
  // hold two
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  p.slabs = 2;
  while (p.slabs > 1 &&
         (a.Lq <= kRows * (p.slabs / 2) ||
          2LL * p.C * a.B * ((a.Lq + kRows * p.slabs - 1) / (kRows * p.slabs)) <
              5LL * sms))
    p.slabs /= 2;
  for (;;) {
    p.smem =
        smem_bytes<DH>(Layout(p.slabs, p.KP, p.NW, p.KC, p.NB), p.slabs);
    if (p.smem <= kMaxSmem) break;
    if (p.slabs == 1) return cudaErrorInvalidValue;
    p.slabs /= 2;
  }
  const int R = kRows * p.slabs;
  p.tiles = (a.Lq + R - 1) / R;
  return cudaSuccess;
}

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan<DH>(a, p);
  if (err != cudaSuccess) return err;
  const Layout L(p.slabs, p.KP, p.NW, p.KC, p.NB);
  static std::atomic<unsigned> smem_set{0};
  err = allow_smem(fused_block_kernel<T, DH>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.C * p.tiles, a.B, 1);
  cfg.blockDim = dim3(kThreadsBlk, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool is_bf16 = sizeof(T) != sizeof(float);
  // the epilogue's 16-byte copies of q's and the weights' rows: f32,
  // D % 4 == 0 and aligned tensors
  const bool dvec = vec_ok(is_bf16, a.H * a.dh, {a.q, a.w_proj, a.w_minus});
  return cudaLaunchKernelEx(
      &cfg, fused_block_kernel<T, DH>, static_cast<const T*>(a.q),
      static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const float*>(a.mask), static_cast<const float*>(a.s_prev),
      static_cast<const T*>(a.c), static_cast<const T*>(a.w_proj),
      static_cast<const T*>(a.w_minus), static_cast<const T*>(a.ln_w),
      static_cast<const T*>(a.ln_b), static_cast<T*>(a.out),
      static_cast<float*>(a.s_out), static_cast<T*>(a.ctx_out),
      static_cast<float*>(a.stats), a.B, a.Lq, a.Lkv, a.H, a.dh,
      score_scale(a.dh), vec_ok(is_bf16, a.dh, {a.q, a.k, a.v}), dvec,
      p.slabs, p.KP, p.NW, p.KC, p.NB, (int)L.ring(), (int)L.x());
}

template <typename T>
cudaError_t dispatch(const Args& a, cudaStream_t s) {
  if (a.dh <= 16) return launch<T, 16>(a, s);
  if (a.dh <= 32) return launch<T, 32>(a, s);
  if (a.dh <= 64) return launch<T, 64>(a, s);
  if (a.dh <= 128) return launch<T, 128>(a, s);
  return launch<T, 256>(a, s);
}

cudaError_t plan_for(const Args& a, Plan& p) {
  if (a.dh <= 16) return make_plan<16>(a, p);
  if (a.dh <= 32) return make_plan<32>(a, p);
  if (a.dh <= 64) return make_plan<64>(a, p);
  if (a.dh <= 128) return make_plan<128>(a, p);
  return make_plan<256>(a, p);
}

bool valid(const Args& a) {
  return a.B >= 1 && a.H >= 1 && a.Lq >= 1 && a.Lkv >= 1 && a.dh >= 1 &&
         a.dh <= 256 && (long long)a.H * a.dh <= 1024 && a.B <= 65535;
}

}  // namespace

// Returns a cudaError_t as int: 0 when the kernel was launched.  s_prev and
// s_out are each null or (B, H, Lq, Lkv) f32; c (one value of the input
// dtype) must be given with s_prev; ctx_out is null or like q; stats is null
// or (2, B, H, Lq) f32.  D = H*dh is at most 1024.
extern "C" int fused_block(const void* q, const void* k, const void* v,
                           const void* mask, const void* s_prev, const void* c,
                           const void* w_proj, const void* w_minus,
                           const void* ln_w, const void* ln_b, void* out,
                           void* s_out, void* ctx_out, void* stats, int B,
                           int H, int Lq, int Lkv, int dh, int is_bf16,
                           void* stream) {
  const Args a{q, k, v, mask, s_prev, c, w_proj, w_minus, ln_w, ln_b,
               out, s_out, ctx_out, stats, B, H, Lq, Lkv, dh};
  if (!valid(a) || (s_prev != nullptr && c == nullptr) || !q || !k || !v ||
      !w_proj || !w_minus || !ln_w || !ln_b || !out)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(is_bf16 ? dispatch<__nv_bfloat16>(a, s) : dispatch<float>(a, s));
}

// The launch geometry `fused_block` takes for these sizes, into geometry[4]:
// the cluster size C, the query rows R of a block, the blocks of the grid
// and the dynamic shared memory of a block in bytes.  Returns a cudaError_t
// as int, as `fused_block` would for these sizes.
extern "C" int fused_block_geometry(int B, int H, int Lq, int Lkv, int dh,
                                    int is_bf16, int* geometry) {
  (void)is_bf16;   // the geometry does not depend on the input dtype
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               B, H, Lq, Lkv, dh};
  if (!valid(a) || !geometry) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_for(a, p);
  if (err != cudaSuccess) return (int)err;
  geometry[0] = p.C;
  geometry[1] = kRows * p.slabs;
  geometry[2] = p.C * p.tiles * B;
  geometry[3] = (int)p.smem;
  return 0;
}
