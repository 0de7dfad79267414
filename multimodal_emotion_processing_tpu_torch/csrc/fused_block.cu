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
// Two paths, chosen by the launch's plan from the sizes and the card (no
// option): the tile path, `fused_block_kernel_tile` below, where one block
// can hold a row tile with every head (head width up to 16, D up to 96:
// mosei_trans); the cluster path otherwise (ren_mme's D 128, robot_demo's
// 192, s1024's 1024).  Both run each head through scored_head.cuh
// `attend_head`, and their epilogues share nothing.
//
// The cluster path.  Grid: one thread-block cluster of C = min(H, 8) blocks
// of four warps per (tile of R = 16 or 32 query rows, batch row): grid (C *
// tiles, B), cluster (C, 1, 1); block rank r of a cluster takes heads r, r +
// C, ...
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
// hide it; at dh 16 it takes about as many cycles as the attention.  The
// tile path takes that chain away where one block holds the tile: no
// barrier across blocks, the three products and the LayerNorm on the
// block's own shared memory, the weights resident for all the items a
// block takes.

#include <cooperative_groups.h>
#include <cuda.h>

#include "hopper.cuh"
#include "scored_head.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace flash;
using namespace flash::tf32;
using namespace hopper;

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

// ---- The tile path: one block, no cluster, every head of its row tile ----

constexpr int kTileWarps = 12;   // warps a tile block may run
constexpr int kTileDH = 16;      // the head-width bucket the tile path takes

// A tile block's shared memory, in floats, from its first 1024-byte
// boundary: the three products' weights (W_minus[:, :D], W_proj,
// W_minus[:, D:]), each as KP / 32 tiles of KP rows x 32 columns in TMA's
// 128-byte swizzle (`w_at`; rows and columns past D zero); sC (R x LDC:
// ctx) and sQ (R x LDC: q, whole rows); gamma and beta (2 x KP); the
// weights' mbarrier (8 bytes, in 4 floats); then the heads' attention
// regions (H x `head` floats), which the epilogue's sX (R x LDC: x) and sY
// (R x LDC: y) alias once every head is done.  LDC = KP + 4 with KP a
// multiple of 32, so a fragment load's 8 rows x 4 columns fall on 32
// different banks, and every region starts on 16 bytes.
struct TileLayout {
  int R, KP, LDC, H;
  size_t head;
  __host__ __device__ TileLayout(int slabs, int kp, int h, size_t head_size)
      : R(kRows * slabs), KP(kp), LDC(kp + 4), H(h), head(head_size) {}
  __host__ __device__ size_t c() const { return 3 * (size_t)KP * KP; }
  __host__ __device__ size_t q() const { return c() + (size_t)R * LDC; }
  __host__ __device__ size_t gb() const { return q() + (size_t)R * LDC; }
  __host__ __device__ size_t bar() const { return gb() + 2 * (size_t)KP; }
  __host__ __device__ size_t attn() const { return bar() + 4; }
  __host__ __device__ size_t y() const { return attn() + (size_t)R * LDC; }
  __host__ __device__ size_t end() const {
    const size_t a = (size_t)H * head, e = 2 * (size_t)R * LDC;
    return attn() + (a > e ? a : e);
  }
  // the dynamic shared memory to ask for: room to align the base
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * end() + kSwizzle;
  }
};

// Element (n, k) of a product's weights in the swizzled layout, in floats
// from the product's first tile: tile k / 32, row n of 128 bytes, whose
// 16-byte chunks sit XOR-ed with n % 8 (TMA's CU_TENSOR_MAP_SWIZZLE_128B),
// so that a fragment load's rows n0 + g, g < 8, at one column fall on 8
// different chunks.
__device__ __forceinline__ int w_at(int KP, int n, int k) {
  return ((k >> 5) * KP + n) * 32 + ((((k >> 2) & 7) ^ (n & 7)) << 2) +
         (k & 3);
}

// Products of the tile path: product p of np (1 or 2) writes out_p[r][c]
// (+)= sum_k A_p[r][k] W_p[c][k] for the rows of `slabs` 16-row slabs and
// every column c < KP (A_p and out_p rows LDC floats apart, W_p in the
// swizzled layout of `w_at`), as units of (product, slab, strip of NS
// 8-column tiles) dealt to the block's warps.  Each tile takes k as
// scored_mma.cuh `mma_rowsW` does: 16-deep slices from zero, the second
// 8-deep chunk through mma3_neg, each slice added to the output in f32
// (from zero unless `accumulate`); a strip splits its A fragment once for
// its NS tiles, through `split_bits`.
template <int NS>
__device__ __forceinline__ void tile_products(
    int np, const float* A0, const float* W0, float* out0, const float* A1,
    const float* W1, float* out1, int LDC, int KP, int slabs,
    bool accumulate) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int strips = KP / (8 * NS), per = slabs * strips;
  for (int u = threadIdx.x / 32; u < np * per; u += blockDim.x / 32) {
    const int pr = u / per, slab = (u - pr * per) / strips;
    const int c0 = 8 * NS * (u - pr * per - slab * strips);
    const int r = kRows * slab + g;
    const float* sA = pr ? A1 : A0;
    const float* sW = pr ? W1 : W0;
    float* po = (pr ? out1 : out0) + r * LDC + c0 + 2 * t;
    float acc[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      acc[j][0] = accumulate ? po[8 * j] : 0.f;
      acc[j][1] = accumulate ? po[8 * j + 1] : 0.f;
      acc[j][2] = accumulate ? po[8 * j + 8 * LDC] : 0.f;
      acc[j][3] = accumulate ? po[8 * j + 8 * LDC + 1] : 0.f;
    }
    // a 32-column tile of the weights at a time, in its two 16-deep slices:
    // the swizzled chunk of each load is chunk ^ g
    const int gs = g << 2;
#pragma unroll 1
    for (int kt = 0; kt < KP / 32; ++kt) {
      const float* wt = sW + (size_t)kt * KP * 32 + t;
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        const int k0 = 32 * kt + 16 * half;
        uint32_t ah[2][4], al[2][4];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float* pa = sA + r * LDC + k0 + 8 * c + t;
          split_bits(pa[0], ah[c][0], al[c][0]);
          split_bits(pa[8 * LDC], ah[c][1], al[c][1]);
          split_bits(pa[4], ah[c][2], al[c][2]);
          split_bits(pa[8 * LDC + 4], ah[c][3], al[c][3]);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float* wr = wt + (c0 + 8 * j + g) * 32;
          float main[4] = {0.f, 0.f, 0.f, 0.f};
          float neg[4] = {0.f, 0.f, 0.f, 0.f};
          float corr[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // columns k0 + 8c + t and k0 + 8c + t + 4: chunks cc and cc + 1
            const int cc = 4 * half + 2 * c;
            uint32_t bh[2], bl[2];
            split_bits(wr[(cc << 2) ^ gs], bh[0], bl[0]);
            split_bits(wr[((cc + 1) << 2) ^ gs], bh[1], bl[1]);
            if (c)
              mma3_neg(neg, corr, ah[c], al[c], bh, bl);
            else
              mma3(main, corr, ah[c], al[c], bh, bl);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] += (main[e] - neg[e]) + corr[e];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      po[8 * j] = acc[j][0];
      po[8 * j + 1] = acc[j][1];
      po[8 * j + 8 * LDC] = acc[j][2];
      po[8 * j + 8 * LDC + 1] = acc[j][3];
    }
  }
}

// The tile path: one block of H x W warps (W = 1 or 2 a head), no cluster,
// per (tile of R = 16 slabs query rows, batch row) "item"; the grid has at
// most one block an SM, each taking items blockIdx.x, + gridDim.x, ... in
// an order that runs the batch rows fastest (the blocks at work at once
// read different keys).  The three weights come in once a block: by the
// tensor memory accelerator as 3 KP / 32 tiles of KP rows x 32 columns,
// on an mbarrier, while the first item's attention runs (`tma`: f32, D a
// multiple of 32, the maps built by the host), else by cp.async (f32) or
// converted (bf16), waited for with the first kv tile.  q comes by
// cp.async under the attention.  Per item:
//   1. Head h's W warps run attend_head on their own region with the kv
//      tiles in two buffers, synced by named barrier 1 + h alone, and write
//      their ctx columns into sC and their row stats.
//   2. One block barrier; the ctx residual as whole rows; y = q.W_minus[:,
//      :D]^T and x = ctx.W_proj^T together, then (a second barrier) y +=
//      x.W_minus[:, D:]^T, on split-TF32 mma.sync in mma_rowsW's k order.
//   3. LayerNorm a row to 8 lanes of a warp: lane l of the 8 sums columns
//      l, l + 8, ... in order, the 8 sums added by the xor butterfly 4, 2,
//      1 (the same bits in each of the 8 and in every launch), first y for
//      the mean, then (y - mean)^2 for the biased variance; out written as
//      whole rows.
template <typename T, int DH>
__global__ void __launch_bounds__(32 * kTileWarps, 1)
fused_block_kernel_tile(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ mask, const float* __restrict__ s_prev,
    const T* __restrict__ c, const T* __restrict__ w_proj,
    const T* __restrict__ w_minus, const T* __restrict__ ln_w,
    const T* __restrict__ ln_b, T* __restrict__ out, float* __restrict__ s_out,
    T* __restrict__ ctx_out, float* __restrict__ stats, int B, int Lq, int Lkv,
    int H, int dh, float scale, bool vec, bool dvec, int slabs, int W, int KP,
    int tiles, bool tma, const __grid_constant__ CUtensorMap map_proj,
    const __grid_constant__ CUtensorMap map_minus) {
  extern __shared__ __align__(16) float smem_raw[];
  float* smem = smem_raw + (kSwizzle - mma::smem_addr(smem_raw) % kSwizzle) %
                               kSwizzle / sizeof(float);
  const int D = H * dh;
  const TileLayout L(slabs, KP, H, head_floats<DH, 2>(slabs));
  const int R = L.R, LDC = L.LDC;
  float* sW = smem;   // the three products' weights, KP * KP floats each
  float* sC = smem + L.c();
  float* sQ = smem + L.q();
  float* sGB = smem + L.gb();
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L.bar());
  float* sX = smem + L.attn();
  float* sY = smem + L.y();
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;

  if (tma) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_expect_tx(bar, 3u * KP * KP * sizeof(float));
      for (int p = 0; p < 3; ++p)
        for (int k0 = 0; k0 < KP; k0 += 32)
          tma_load_2d(sW + (size_t)p * KP * KP + k0 * KP,
                      p == 1 ? map_proj : map_minus,
                      k0 + (p == 2 ? D : 0), 0, bar);
    }
  } else {
    // rows and columns past D zero; f32 by cp.async 16-byte chunks, which
    // the swizzle moves whole
    for (int i = warp; i < 3 * KP; i += nwarps) {
      const int p = i / KP, n = i - p * KP;
      const T* src = p == 1 ? w_proj + (size_t)n * D
                            : w_minus + (size_t)n * 2 * D + (p == 2 ? D : 0);
      float* dst = sW + (size_t)p * KP * KP;
      if (dvec) {
        for (int col = 4 * lane; col < KP; col += 128)
          mma::cp_async16(dst + w_at(KP, n, col), n < D && col < D ? src + col
                                                                   : w_proj,
                          n < D && col < D);
      } else {
        for (int col = lane; col < KP; col += 32)
          dst[w_at(KP, n, col)] = n < D && col < D ? to_f32(src[col]) : 0.f;
      }
    }
    mma::cp_async_commit();
  }
  // ctx's columns past D meet zero weights: finite
  for (int i = threadIdx.x; i < R * (KP - D); i += blockDim.x) {
    const int r = i / (KP - D);
    sC[r * LDC + D + (i - r * (KP - D))] = 0.f;
  }
  for (int i = threadIdx.x; i < KP; i += blockDim.x) {
    sGB[i] = i < D ? to_f32(ln_w[i]) : 0.f;
    sGB[KP + i] = i < D ? to_f32(ln_b[i]) : 0.f;
  }

  const int h = warp / W;   // this warp's head
  const HeadGroup grp{h * W, W, 1 + h};
  const float inv_d = 1.f / (float)D;
  for (int item = blockIdx.x; item < tiles * B; item += gridDim.x) {
    // batch rows run fastest, so that the blocks at work at once read the
    // keys of different batch rows
    const int tile = item / B, b = item - tile * B, q0 = tile * R;
    const int nrows = min(R, Lq - q0);
    const T* qb = q + (size_t)b * Lq * D;
    // q's tile under the attention (its copies are waited for with the
    // first kv tile's)
    stage_q<T>(sQ, LDC, qb, D, q0, R, nrows, KP, dvec);

    // 1. attention, every head at once
    {
      const size_t head_row0 = ((size_t)b * H + h) * Lq;
      const size_t kvoff = (size_t)b * Lkv * D + (size_t)h * dh;
      HeadRows<DH> hr;
      if (attend_head<T, DH, 0, 2, HeadGroup>(
              smem + L.attn() + h * L.head, qb + (size_t)h * dh, k + kvoff,
              v + kvoff, mask ? mask + (size_t)b * Lkv : nullptr, s_prev,
              s_out, head_row0, s_prev ? to_f32(c[0]) : 0.f, D, q0, Lq, Lkv,
              dh, scale, vec, slabs, hr, grp)) {
        const int t = lane & 3;
        const size_t n_rows = (size_t)B * H * Lq;
        const int r0 = kRows * ((warp - grp.warp0) % slabs);
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          if (!hr.live[e2]) continue;
          const float inv = __fdividef(1.f, hr.l[e2]);   // l >= 1
          float* crow = sC + (r0 + lane / 4 + 8 * e2) * LDC + h * dh;
#pragma unroll
          for (int n = 0; n < DH / 8; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = 8 * n + 2 * t + e;
              if (d < dh) crow[d] = hr.acc[n][2 * e2 + e] * inv;
            }
          if (stats && t == 0) {
            stats[head_row0 + hr.row[e2]] = hr.m[e2];
            stats[n_rows + head_row0 + hr.row[e2]] = hr.l[e2];
          }
        }
      }
    }
    if (tma) mbar_wait(bar, 0);   // the weights (at once after the first)
    __syncthreads();   // ctx, q and the weights in place; the attention's
                       // regions free

    // 2. the ctx residual, then the three products
    if (ctx_out)
      for (int i = threadIdx.x; i < nrows * D; i += blockDim.x) {
        const int r = i / D, col = i - r * D;
        store(ctx_out + ((size_t)b * Lq + q0 + r) * D + col,
              sC[r * LDC + col]);
      }
    tile_products<4>(2, sQ, sW, sY, sC, sW + (size_t)KP * KP, sX, LDC, KP,
                     slabs, false);
    __syncthreads();   // x and the first half of y are in place
    tile_products<2>(1, sX, sW + 2 * (size_t)KP * KP, sY, nullptr, nullptr,
                     nullptr, LDC, KP, slabs, true);
    __syncthreads();   // y is in place

    // 3. LayerNorm and out, a row to 8 lanes (four rows a warp at once)
    {
      const int sub = lane & 7;   // the lane's place among its row's 8
      // every lane of a warp takes as many passes (the shuffles need all 32)
      const int passes = (nrows + 4 * nwarps - 1) / (4 * nwarps);
      for (int i = 0; i < passes; ++i) {
        const int r = 4 * (warp + i * nwarps) + (lane >> 3);
        const bool live = r < nrows;
        const float* yr = sY + (live ? r : 0) * LDC;
        float sum = 0.f;
        for (int col = sub; col < D; col += 8) sum += yr[col];
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float mean = sum * inv_d;
        float var = 0.f;
        for (int col = sub; col < D; col += 8) {
          const float dv = yr[col] - mean;
          var = fmaf(dv, dv, var);
        }
#pragma unroll
        for (int off = 4; off > 0; off >>= 1)
          var += __shfl_xor_sync(0xffffffffu, var, off);
        const float rstd = rsqrtf(var * inv_d + kLnEps);
        if (live) {
          T* orow = out + ((size_t)b * Lq + q0 + r) * D;
          for (int col = sub; col < D; col += 8)
            store(orow + col,
                  (yr[col] - mean) * rstd * sGB[col] + sGB[KP + col]);
        }
      }
    }
    __syncthreads();   // sY and sC are read: the next item may write them
  }
}

struct Args {
  const void *q, *k, *v, *mask, *s_prev, *c, *w_proj, *w_minus, *ln_w, *ln_b;
  void *out, *s_out, *ctx_out, *stats;
  int B, H, Lq, Lkv, dh;
};

// the geometry of one call: the tile path's (`tile`: C 1, `warps` a block,
// `grid` blocks) or the cluster path's
struct Plan {
  int C, slabs, KP, NW, KC, NB, tiles, warps, grid;
  bool tile;
  size_t smem;
};

int card_sms() {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// The tile path where it can hold the call: head width up to 16, one or two
// warps a head in at most 12 warps (a named barrier a head; 12 warps of 32
// threads leave a thread up to 170 registers), and the whole tile with the
// three weights resident within a block's shared memory, which holds D up
// to 96 (mosei_trans's D 96; not ren_mme's 128, robot_demo's 192 or
// s1024's 1024).  Two warps a head where 12 warps hold them, each a 16-row
// slab of a 32-row tile (one 16-row slab with the keys split between them
// where Lq is 16 or less); one a head otherwise, on 16-row tiles.  Not on
// a grid of few items that leaves most of the card idle (below).
bool tile_plan(const Args& a, Plan& p) {
  if (a.dh > kTileDH || a.H > kTileWarps) return false;
  const int D = a.H * a.dh;
  const int W = 2 * a.H <= kTileWarps ? 2 : 1;
  p.slabs = W == 2 && a.Lq > kRows ? 2 : 1;
  p.KP = (D + 31) / 32 * 32;
  const TileLayout L(p.slabs, p.KP, a.H, head_floats<kTileDH, 2>(p.slabs));
  p.smem = L.bytes();
  if (p.smem > kMaxSmem) return false;
  p.tile = true;
  p.C = 1;
  p.warps = a.H * W;
  p.tiles = (a.Lq + L.R - 1) / L.R;
  const long long items = (long long)p.tiles * a.B;
  const int sms = card_sms();
  // A tile block walks every key of its head on one warp (two), so on a
  // grid of few items with more keys than two kv tiles the cluster path,
  // which splits a head's keys over four warps and a tile's heads over C
  // blocks, finishes first: measured on an H100 at 1-32 items and Lkv 100
  // or 200 (22.7-27.8 us against 33.1-33.6), while from 48 items up, or at
  // Lkv 20, the tile path led (from 15.0 against 17.4 us)
  if (4 * items <= sms && a.Lkv > 2 * head_bkv<kTileDH, 2>()) return false;
  p.grid = items < sms ? (int)items : sms;
  return true;
}

template <int DH>
cudaError_t make_plan(const Args& a, Plan& p) {
  if (DH == kTileDH && tile_plan(a, p)) return cudaSuccess;
  const int D = a.H * a.dh;
  p.tile = false;
  p.warps = kMaxWarps;
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
  const int sms = card_sms();
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
  p.grid = p.C * p.tiles * a.B;
  return cudaSuccess;
}

// The map of a (rows, cols) f32 matrix `rows` rows of `ld` floats apart,
// read in boxes of KP rows x 32 columns in the 128-byte swizzle
bool weight_map(CUtensorMap* map, const void* w, int rows, int cols, int ld,
                int KP) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {32, (cuuint32_t)KP};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(w),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
cudaError_t launch_tile(const Args& a, const Plan& p, cudaStream_t stream) {
  static std::atomic<unsigned> smem_set{0};
  cudaError_t err =
      allow_smem(fused_block_kernel_tile<T, kTileDH>, kMaxSmem, smem_set);
  if (err != cudaSuccess) return err;
  const bool is_bf16 = sizeof(T) != sizeof(float);
  const int D = a.H * a.dh;
  // the 16-byte copies of q's and the weights' rows: f32, D % 4 == 0 and
  // aligned tensors; the weights by the tensor memory accelerator where D
  // is also a multiple of 32 (its boxes hold no column of the other half
  // of W_minus)
  const bool dvec = vec_ok(is_bf16, D, {a.q, a.w_proj, a.w_minus});
  CUtensorMap map_proj = {}, map_minus = {};
  const bool tma = dvec && D % 32 == 0 &&
                   weight_map(&map_proj, a.w_proj, D, D, D, p.KP) &&
                   weight_map(&map_minus, a.w_minus, D, 2 * D, 2 * D, p.KP);
  fused_block_kernel_tile<T, kTileDH><<<p.grid, 32 * p.warps, p.smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const float*>(a.mask),
      static_cast<const float*>(a.s_prev), static_cast<const T*>(a.c),
      static_cast<const T*>(a.w_proj), static_cast<const T*>(a.w_minus),
      static_cast<const T*>(a.ln_w), static_cast<const T*>(a.ln_b),
      static_cast<T*>(a.out), static_cast<float*>(a.s_out),
      static_cast<T*>(a.ctx_out), static_cast<float*>(a.stats), a.B, a.Lq,
      a.Lkv, a.H, a.dh, score_scale(a.dh),
      vec_ok(is_bf16, a.dh, {a.q, a.k, a.v}), dvec, p.slabs,
      p.warps / a.H, p.KP, p.tiles, tma, map_proj, map_minus);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  Plan p;
  cudaError_t err = make_plan<DH>(a, p);
  if (err != cudaSuccess) return err;
  if constexpr (DH == kTileDH)
    if (p.tile) return launch_tile<T>(a, p, stream);
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

// The launch geometry `fused_block` takes for these sizes, into geometry[6]:
// the cluster size C (1 on the tile path), the query rows R of a block's
// tile, the blocks of the grid, the dynamic shared memory of a block in
// bytes, the path (1 the tile path, 0 the cluster path) and the warps of a
// block.  Returns a cudaError_t as int, as `fused_block` would for these
// sizes.
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
  geometry[2] = p.tile ? p.grid : p.C * p.tiles * B;
  geometry[3] = (int)p.smem;
  geometry[4] = p.tile ? 1 : 0;
  geometry[5] = p.warps;
  return 0;
}
