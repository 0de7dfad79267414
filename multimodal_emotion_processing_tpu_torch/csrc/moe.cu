// The routed experts of a sparse mixture-of-experts layer (DeepSeek-V3's
// block, as in Moonlight-16B-A3B) for a prefill of many packed tokens,
// written for Hopper (sm_90a) on wgmma.  No TPU kernel is replaced: the
// JAX package has no mixture-of-experts layer; these came with the text
// tower (models/tower.py).
//
// The router (models/tower.py) gives each token its k experts and weights.
// The (token, choice) rows are sorted by expert, stably, so expert e owns
// the rows offsets[e] .. offsets[e + 1] - 1 of the sorted order, and
// `rows[r]` names the token of sorted row r.  Three kernels then run:
//
// - moe_gate_up: for every sorted row r of expert e,
//     h[r, j] = silu(x[rows[r]] . Wg_e[j]) * (x[rows[r]] . Wu_e[j])
//   one grouped product over all experts in one launch.  W13_e is (2F, K)
//   with the gate and up rows interleaved in groups of eight (rows 16i ..
//   16i + 7 the gate rows 8i .., rows 16i + 8 .. 16i + 15 the up rows 8i
//   ..).  h is stored once, in bf16.
// - moe_down: y[r] = w[r] * (h[r] . W2_e^T), W2_e (D, F), the routing
//   weight of the row applied in f32 in the epilogue, y stored in bf16.
// - moe_combine: out[t] += shared[t] + sum_k y[pos[t, k]], each token's k
//   routed rows summed in the router's order in f32, then the shared
//   expert's row, then added to the f32 residual: a fixed order, no
//   atomics, the same bits on every run.
//
// What bounds the products: per routed row 2 K N flops against K + N bf16
// read and written once and the expert's weights once per layer, so at the
// ~3,400 rows an expert sees in a batch of 64 pairs they are compute-bound
// (the ridge is ~295 flops a byte); the bound is the flops at 989 TFLOP/s,
// which only wgmma reaches.  The combine is bound by its bytes.
//
// The products' design (`moe_gemm_kernel<MODE>`, one launch a product):
// - Persistent blocks, one an SM, each walking the tile list (expert, m
//   tile of 128 rows, n tile of 256 columns) with the n tile fastest and a
//   stride of the grid, so the ~132 tiles in flight share one expert's
//   weights in L2.  A block finds a tile's expert from `offsets` with a
//   cursor that only moves forward; there is no schedule to compute.
// - Three warpgroups: a producer (registers lowered by setmaxnreg) and two
//   consumers (registers raised), each consumer 64 rows x 256 columns of
//   the 128 x 256 tile as wgmma.m64n256k16 with f32 accumulators in
//   registers, both operands read from shared memory.
// - A ring of 4 stages of 64-wide k steps (16 KB of A, 32 KB of B each,
//   192 KB), each stage with a full and an empty mbarrier.  The producer
//   loads the next tile's stages while the consumers store the last one.
// - B, the expert's weights, comes by TMA in 256 x 64 boxes of a tensor
//   map over (E N, K) in the 128-byte swizzle.  In moe_down A (h, sorted
//   and contiguous) comes by TMA too: rows past M read as zeros, rows past
//   the expert's end belong to the next one and are read, then dropped at
//   the store.  In moe_gate_up A is x gathered through `rows`, which TMA
//   cannot do: the producer's 128 threads copy the rows' 16-byte chunks
//   by cp.async into the same swizzle (flash_mma.cuh `chunk<64>`: chunk c
//   of row r at c ^ (r % 8), on a 1024-byte-aligned tile), completing on
//   the stage's full barrier (cp.async.mbarrier.arrive.noinc).  So no
//   gathered copy of x is ever written or read back.
// - The epilogue: in wgmma's accumulator layout a thread holds columns
//   2 t4 and 2 t4 + 1 of every 8-column group, so the gate and up of one
//   h column (groups 2i and 2i + 1) are in one thread and silu * mul needs
//   no exchange.  The four lanes of a row then swap their bf16 pairs
//   (`quad_transpose`) so each stores 16 contiguous bytes: with 4-byte
//   stores (8 rows a warp instruction) moe_down spent a fifth of its time
//   on an H100 in the epilogue.  Stores are masked to the rows below the
//   expert's end: the tile's later rows are another tile's (the next
//   expert's), so a whole-box store would race with it.
// - The two consumers share each tile (cooperative), so their epilogue is
//   not hidden behind the other's products.  Ping-pong (a tile each) would
//   need 64 x 256 tiles, as registers allow no more, and so 1.7 x the
//   operand bytes a flop out of shared memory and L2 for the same work.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;
using flash::mma::chunk;
using flash::mma::cp_async16;
using flash::mma::pack_bf16;

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 3 * 128;             // producer + two consumers
constexpr int kABytes = kBM * kBK * 2;        // a stage's A tile, bf16
constexpr int kBBytes = kBN * kBK * 2;        // a stage's B tile
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr size_t kGemmSmem =
    (size_t)kStages * kStageBytes + 2 * kStages * sizeof(uint64_t) + kSwizzle;

// ---- wgmma ----

// The shared-memory descriptor of a K-major tile in the 128-byte swizzle:
// rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define MOE_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MOE_ACC16(i) MOE_ACC4(i), MOE_ACC4(i + 4), MOE_ACC4(i + 8), MOE_ACC4(i + 12)

// d (64 x 256, f32) = A (64 x 16) . B (256 x 16)^T (+ d if `add`), both
// bf16 K-major in shared memory.  Thread (warp w, lane 4 g + t4) holds
// d[4 j + 2 h + q] = (row 16 w + g + 8 h, column 8 j + 2 t4 + q).
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : MOE_ACC16(0), MOE_ACC16(16), MOE_ACC16(32), MOE_ACC16(48),
        MOE_ACC16(64), MOE_ACC16(80), MOE_ACC16(96), MOE_ACC16(112)
      : "l"(da), "l"(db), "r"(add));
}

#undef MOE_ACC16
#undef MOE_ACC4

// The epilogue's stores: lane t4 of a quad (the four lanes of one row)
// holds word j (its two columns) of each of four 8-column groups; after
// the exchange it holds group t4's four words (lanes 0-3's columns), 16
// contiguous bytes.  A 4 x 4 transpose by 2 x 2 blocks: within each, then
// of the blocks.  Every lane of the warp takes part.
__device__ __forceinline__ uint4 quad_transpose(uint32_t w0, uint32_t w1,
                                                uint32_t w2, uint32_t w3,
                                                int t4) {
  const bool odd = t4 & 1, high = t4 & 2;
  uint32_t a = odd ? w0 : w1, b = odd ? w2 : w3;
  a = __shfl_xor_sync(0xffffffffu, a, 1);
  b = __shfl_xor_sync(0xffffffffu, b, 1);
  if (odd) {
    w0 = a;
    w2 = b;
  } else {
    w1 = a;
    w3 = b;
  }
  a = high ? w0 : w2;
  b = high ? w1 : w3;
  a = __shfl_xor_sync(0xffffffffu, a, 2);
  b = __shfl_xor_sync(0xffffffffu, b, 2);
  if (high) {
    w0 = a;
    w1 = b;
  } else {
    w2 = a;
    w3 = b;
  }
  return make_uint4(w0, w1, w2, w3);
}

// ---- the tile list ----

// Walks the m tiles in expert order: expert e owns m tiles first ..
// first + tiles - 1, its sorted rows row_a .. row_b - 1.  The tiles a
// block takes only grow, so the cursor only moves forward.
struct TileCursor {
  const int* offsets;
  int n_experts;
  int e = -1, first = 0, tiles = 0, row_a = 0, row_b = 0;

  __device__ TileCursor(const int* o, int n) : offsets(o), n_experts(n) {}

  // false past the last expert's tiles
  __device__ bool seek(int m_tile) {
    while (m_tile >= first + tiles) {
      first += tiles;
      if (++e >= n_experts) return false;
      row_a = offsets[e];
      row_b = offsets[e + 1];
      tiles = (row_b - row_a + kBM - 1) / kBM;
    }
    return true;
  }
};

// MODE 0: gate and up with silu * mul, out h (M, N / 2); A rows gathered
// through `rows` from `a`.  MODE 1: down, A by `map_a`, scaled by the
// row's weight, out y (M, N).
template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
moe_gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_w,
                const bf16* __restrict__ a, const int* __restrict__ rows,
                const int* __restrict__ offsets,
                const float* __restrict__ row_w, bf16* __restrict__ out,
                int N, int K, int n_experts) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + (kSwizzle - smem_u32(smem_raw) % kSwizzle) % kSwizzle;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      // gate-up: the B box's bytes and one cp.async arrival per producer
      // thread; down: both boxes' bytes.  Empty: one arrival a consumer warp.
      mbar_init(full + s, MODE == 0 ? 128 + 1 : 1);
      mbar_init(empty + s, 8);
    }
  }
  __syncthreads();

  const int n_tiles = N / kBN, n_kt = K / kBK;
  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  TileCursor cur(offsets, n_experts);
  int stage = 0;
  unsigned phase = 0;

  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (MODE == 1 && tid != 0) return;   // one thread issues the TMA copies
    for (int t = blockIdx.x;; t += gridDim.x) {
      const int m_tile = t / n_tiles, n0 = (t - m_tile * n_tiles) * kBN;
      if (!cur.seek(m_tile)) break;
      const int row0 = cur.row_a + (m_tile - cur.first) * kBM;
      const int w_row = cur.e * N + n0;
      // gate-up: the token of this thread's row of the tile, -1 past it
      int src = -1;
      if (MODE == 0 && tid < cur.row_b - row0) src = rows[row0 + tid];
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(empty + stage, phase ^ 1);
        unsigned char* sa = smem + stage * kStageBytes;
        const int k0 = kt * kBK;
        if (MODE == 0) {
          if (tid == 0) {
            mbar_expect_tx(full + stage, kBBytes);
            tma_load_2d(sa + kABytes, map_w, k0, w_row, full + stage);
          }
          // warp w copies rows 32 w .. 32 w + 31, a row's eight chunks by
          // eight neighbouring lanes; lane l holds the token of row 32 w + l
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int r = 32 * warp + 4 * j + lane / 8, c = lane % 8;
            const int s_row = __shfl_sync(0xffffffffu, src, 4 * j + lane / 8);
            cp_async16(sa + chunk<kBK>(r, c) * 16,
                       a + (size_t)(s_row < 0 ? 0 : s_row) * K + k0 + c * 8,
                       s_row >= 0);
          }
          asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                           smem_u32(full + stage)) : "memory");
        } else {
          mbar_expect_tx(full + stage, kStageBytes);
          tma_load_2d(sa, map_a, k0, row0, full + stage);
          tma_load_2d(sa + kABytes, map_w, k0, w_row, full + stage);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup 1 the tile's rows 0-63, 2 rows 64-127 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int g = lane / 4, t4 = lane % 4;
  const int rbase = 64 * (wg - 1) + 16 * warp + g;
  float acc[128];   // each tile's first slice overwrites it
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  for (int t = blockIdx.x;; t += gridDim.x) {
    const int m_tile = t / n_tiles, n0 = (t - m_tile * n_tiles) * kBN;
    if (!cur.seek(m_tile)) break;
    const int row0 = cur.row_a + (m_tile - cur.first) * kBM;
    const int n_rows = min(kBM, cur.row_b - row0);
    int last = 0;
    for (int kt = 0; kt < n_kt; ++kt) {
      mbar_wait(full + stage, phase);
      // gate-up's A came by cp.async, the generic proxy: order it before
      // wgmma's reads, which go through the async proxy
      if (MODE == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      const uint32_t sa = smem_u32(smem + stage * kStageBytes);
      const uint64_t da = sw128_desc(sa + (wg - 1) * 64 * 128);
      const uint64_t db = sw128_desc(sa + kABytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)   // 32 bytes a 16-deep slice
        wgmma_256(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();   // the step before is done: free its stage
      if (kt > 0 && lane == 0) mbar_arrive(empty + last);
      last = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + last);

#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = rbase + 8 * hr;
      const bool real = r < n_rows;
      const size_t orow = (size_t)(row0 + (real ? r : 0));
      // this thread's bf16 pairs of the row, one word a group of 8 columns
      uint32_t w[MODE == 0 ? kBN / 16 : kBN / 8];
      if constexpr (MODE == 0) {
#pragma unroll
        for (int i = 0; i < kBN / 16; ++i) {   // groups 2i (gate), 2i + 1 (up)
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gt = acc[8 * i + 2 * hr + q];
            const float up = acc[8 * i + 4 + 2 * hr + q];
            v[q] = gt / (1.f + __expf(-gt)) * up;
          }
          w[i] = pack_bf16(v[0], v[1]);
        }
      } else {
        const float s = real ? row_w[orow] : 0.f;
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          w[j] = pack_bf16(acc[4 * j + 2 * hr] * s, acc[4 * j + 2 * hr + 1] * s);
      }
      // out's columns of the tile from n0 (h: n0 / 2), 16 bytes a store
      bf16* o = out + orow * (MODE == 0 ? N / 2 : N) + (MODE == 0 ? n0 / 2 : n0);
#pragma unroll
      for (int j0 = 0; j0 < (int)(sizeof(w) / sizeof(w[0])); j0 += 4) {
        const uint4 v = quad_transpose(w[j0], w[j0 + 1], w[j0 + 2], w[j0 + 3], t4);
        if (real) *reinterpret_cast<uint4*>(o + 8 * (j0 + t4)) = v;
      }
    }
  }
}

// The map of a (rows, cols) bf16 matrix read in boxes of `box_rows` rows x
// 64 columns in the 128-byte swizzle; rows past the end read as zeros
bool bf16_map(CUtensorMap* map, const void* p, long long rows, int cols,
              int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * sizeof(bf16)};
  const cuuint32_t box[2] = {kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// an upper bound of the tiles: every expert's last m tile may be partial
long long max_tiles(int M, int N, int n_experts) {
  return ((long long)(M + kBM - 1) / kBM + n_experts) * (N / kBN);
}

template <int MODE>
cudaError_t launch_gemm(const void* a, const void* rows, const void* offsets,
                        const void* w, const void* row_w, void* out, int M,
                        int N, int K, int n_experts, cudaStream_t stream) {
  CUtensorMap map_a = {}, map_w = {};
  if (!bf16_map(&map_w, w, (long long)n_experts * N, K, kBN) ||
      (MODE == 1 && !bf16_map(&map_a, a, M, K, kBM)))
    return cudaErrorNotSupported;
  cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const long long tiles = max_tiles(M, N, n_experts);
  const int grid = (int)(tiles < sms ? tiles : sms);
  moe_gemm_kernel<MODE><<<grid, kThreads, kGemmSmem, stream>>>(
      map_a, map_w, static_cast<const bf16*>(a), static_cast<const int*>(rows),
      static_cast<const int*>(offsets), static_cast<const float*>(row_w),
      static_cast<bf16*>(out), N, K, n_experts);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

// N a multiple of the 256-wide n tile, K of the 64-wide k step, the tile
// list and the weights' rows within int
bool shapes_ok(int M, int N, int K, int n_experts) {
  return M >= 1 && N >= kBN && N % kBN == 0 && K >= kBK && K % kBK == 0 &&
         n_experts >= 1 && max_tiles(M, N, n_experts) < (1LL << 31) &&
         (long long)n_experts * N < (1LL << 31);
}

// one block of 256 threads a token, eight bf16 columns a thread and step
__global__ void __launch_bounds__(256)
moe_combine_kernel(const bf16* __restrict__ y, const int* __restrict__ pos,
                   const bf16* __restrict__ shared, float* __restrict__ out,
                   int D, int k) {
  const int t = blockIdx.x;
  for (int d = threadIdx.x * 8; d < D; d += blockDim.x * 8) {
    float s[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = 0.f;
    for (int j = 0; j < k; ++j) {
      const uint4 v = *reinterpret_cast<const uint4*>(
          y + (size_t)pos[(size_t)t * k + j] * D + d);
      const bf16* p = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] += __bfloat162float(p[q]);
    }
    if (shared) {
      const uint4 v = *reinterpret_cast<const uint4*>(shared + (size_t)t * D + d);
      const bf16* p = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int q = 0; q < 8; ++q) s[q] += __bfloat162float(p[q]);
    }
    float4* o = reinterpret_cast<float4*>(out + (size_t)t * D + d);
    float4 o0 = o[0], o1 = o[1];
    o0.x += s[0]; o0.y += s[1]; o0.z += s[2]; o0.w += s[3];
    o1.x += s[4]; o1.y += s[5]; o1.z += s[6]; o1.w += s[7];
    o[0] = o0;
    o[1] = o1;
  }
}

}  // namespace

// Each returns a cudaError_t as int: 0 when the kernel was launched.
// x (T, K) bf16; rows (M,) int32, the token of each sorted row; offsets
// (E + 1,) int32; w13 (E, N, K) bf16 interleaved as above; h (M, N / 2).
extern "C" int moe_gate_up(const void* x, const void* rows, const void* offsets,
                           const void* w13, void* h, int M, int N, int K,
                           int n_experts, void* stream) {
  if (!shapes_ok(M, N, K, n_experts) || !aligned16({x, w13, h}))
    return (int)cudaErrorInvalidValue;
  return (int)launch_gemm<0>(x, rows, offsets, w13, nullptr, h, M, N, K,
                             n_experts, static_cast<cudaStream_t>(stream));
}

// h (M, K) bf16 in sorted order; w2 (E, N, K) bf16; row_w (M,) f32; y (M, N)
extern "C" int moe_down(const void* h, const void* offsets, const void* w2,
                        const void* row_w, void* y, int M, int N, int K,
                        int n_experts, void* stream) {
  if (!shapes_ok(M, N, K, n_experts) || !aligned16({h, w2, y}))
    return (int)cudaErrorInvalidValue;
  return (int)launch_gemm<1>(h, nullptr, offsets, w2, row_w, y, M, N, K,
                             n_experts, static_cast<cudaStream_t>(stream));
}

// y (T k, D) bf16; pos (T, k) int32, the sorted row of each (token,
// choice); shared (T, D) bf16 or null; out (T, D) f32, added to in place
extern "C" int moe_combine(const void* y, const void* pos, const void* shared,
                           void* out, int T, int D, int k, void* stream) {
  if (T < 1 || D < 8 || D % 8 || k < 1 || !aligned16({y, shared, out}))
    return (int)cudaErrorInvalidValue;
  moe_combine_kernel<<<T, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const int*>(pos),
      static_cast<const bf16*>(shared), static_cast<float*>(out), D, k);
  return (int)cudaGetLastError();
}
