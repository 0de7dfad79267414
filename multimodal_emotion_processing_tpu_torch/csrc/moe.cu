// The routed experts of a sparse mixture-of-experts layer (DeepSeek-V3's
// block, as in Moonlight-16B-A3B) for a prefill of many packed tokens,
// written for Hopper (sm_90a) on mma.sync.
//
// The router (models/tower.py) gives each token its k experts and weights.
// The (token, choice) rows are sorted by expert, stably, so expert e owns
// the rows offsets[e] .. offsets[e + 1] - 1 of the sorted order, and
// `rows[r]` names the token of sorted row r.  Three kernels then run:
//
// - moe_gate_up: for every sorted row r of expert e,
//     h[r, j] = silu(x[rows[r]] . Wg_e[j]) * (x[rows[r]] . Wu_e[j])
//   one grouped product over all experts in one launch.  x is read through
//   `rows` (the gather is the A operand's load, so no gathered copy of x is
//   written), W13_e is (2F, K) with the gate and up rows interleaved in
//   groups of eight (rows 16i .. 16i + 7 gate rows 8i .., rows 16i + 8 ..
//   16i + 15 the up rows 8i ..), so one warp's accumulators of n-tiles 2i
//   and 2i + 1 hold the gate and up of the same eight columns and the
//   silu * mul epilogue needs no exchange.  h is stored once, in bf16.
// - moe_down: y[r] = w[r] * (h[r] . W2_e^T), W2_e (D, F), the routing
//   weight of the row applied in f32 in the epilogue, y stored in bf16.
// - moe_combine: out[t] += shared[t] + sum_k y[pos[t, k]], each token's k
//   routed rows summed in the router's order in f32, then the shared
//   expert's row, then added to the f32 residual: a fixed order, no
//   atomics, the same bits on every run.
//
// The products: blocks of 8 warps over a 128 x 128 output tile, 64-wide k
// steps through a 3-stage cp.async ring (96 KB of shared memory, two blocks
// an SM), operands in swizzled rows of 64 bf16 (flash_mma.cuh `chunk`),
// fragments by ldmatrix, mma.sync m16n8k16 with f32 accumulators.  Each
// warp owns 64 rows x 32 columns.  The grid is (N / 128) x (an upper bound
// of the m tiles: ceil(M / 128) + experts); a block finds its expert by
// walking the per-expert tile counts, and a block past the last tile
// returns at once.  Consecutive blocks share an A tile and one expert's
// weights, which therefore stay in L2 while they are read.
//
// What bounds them: per routed row 2 K N flops against K + N bf16 read and
// written once and the expert's weights once per layer, so at the ~3,400
// rows an expert sees in a batch of 64 pairs they are compute-bound (the
// ridge is ~295 flops a byte); the bound is the flops at 989 TFLOP/s.
// mma.sync reaches less than wgmma's rate on Hopper.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace flash::mma;

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kGemmWarps = 8, kGemmThreads = 32 * kGemmWarps;
constexpr int kTileElems = kBM * kBK;   // one operand tile of a stage
constexpr size_t kGemmSmem = sizeof(bf16) * 2 * kTileElems * kStages;

// element offset of (r, d) in a swizzled tile of rows of 64 bf16
__device__ __forceinline__ int at64(int r, int d) { return at<kBK>(r, d); }

// The expert, first sorted row and real row count of m tile `tile`, or
// e = -1 past the last tile.
__device__ __forceinline__ void find_tile(const int* __restrict__ offsets,
                                          int n_experts, int tile, int& e,
                                          int& row0, int& n_rows) {
  int seen = 0;
  e = -1;
  for (int i = 0; i < n_experts; ++i) {
    const int a = offsets[i], b = offsets[i + 1];
    const int tiles = (b - a + kBM - 1) / kBM;
    if (tile < seen + tiles) {
      e = i;
      row0 = a + (tile - seen) * kBM;
      n_rows = min(kBM, b - row0);
      return;
    }
    seen += tiles;
  }
}

// MODE 0: gate and up with silu * mul, out h (M, N / 2); A rows gathered
// through `rows`.  MODE 1: down, scaled by the row's weight, out y (M, N).
template <int MODE>
__global__ void __launch_bounds__(kGemmThreads, 2)
moe_gemm_kernel(const bf16* __restrict__ a, const int* __restrict__ rows,
                const int* __restrict__ offsets, const bf16* __restrict__ w,
                const float* __restrict__ row_w, bf16* __restrict__ out,
                int N, int K, int n_experts) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sA = reinterpret_cast<bf16*>(smem_raw);
  bf16* sB = sA + kStages * kTileElems;

  int e, row0, n_rows;
  find_tile(offsets, n_experts, blockIdx.y, e, row0, n_rows);
  if (e < 0) return;
  const int n0 = blockIdx.x * kBN;
  const bf16* we = w + (size_t)e * N * K + (size_t)n0 * K;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;

  // this thread's four 16-byte chunks of each operand tile: rows tid / 8
  // + 32 j, chunk tid % 8
  const int c = tid & 7;
  const bf16* a_src[4];
  const bf16* b_src[4];
  bool a_real[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (tid >> 3) + 32 * j;
    a_real[j] = r < n_rows;
    const int src_row = a_real[j] ? (MODE == 0 ? rows[row0 + r] : row0 + r) : 0;
    a_src[j] = a + (size_t)src_row * K + c * 8;
    b_src[j] = we + (size_t)r * K + c * 8;
  }
  auto load_stage = [&](int kt, int stage) {
    bf16* da = sA + stage * kTileElems;
    bf16* db = sB + stage * kTileElems;
    const int k0 = kt * kBK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = (tid >> 3) + 32 * j;
      cp_async16(da + chunk<kBK>(r, c) * 8, a_src[j] + (a_real[j] ? k0 : 0),
                 a_real[j]);
      cp_async16(db + chunk<kBK>(r, c) * 8, b_src[j] + k0, true);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

  const int n_kt = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_kt) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile kt is in; every warp is done with tile kt - 1
    const int next = kt + kStages - 1;
    if (next < n_kt) load_stage(next, next % kStages);
    cp_async_commit();
    const bf16* ta = sA + (kt % kStages) * kTileElems;
    const bf16* tb = sB + (kt % kStages) * kTileElems;
#pragma unroll
    for (int kc = 0; kc < kBK / 16; ++kc) {
      uint32_t bfr[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldsm_x4(bfr[j], tb + at64(wn + j * 16 + (lane & 7) + (lane >> 4) * 8,
                                  kc * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t afr[4];
        ldsm_x4(afr, ta + at64(wm + i * 16 + (lane & 15), kc * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma_16816(acc[i][2 * j], afr, bfr[j][0], bfr[j][1]);
          mma_16816(acc[i][2 * j + 1], afr, bfr[j][2], bfr[j][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = wm + i * 16 + g + 8 * hr;
      if (r >= n_rows) continue;
      const size_t orow = (size_t)(row0 + r);
      if (MODE == 0) {
        const int half = N / 2;
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          // n-tiles j (gate) and j + 1 (up) of global tile (n0 + wn) / 8 + j
          const int col = ((n0 + wn) / 8 + j) / 2 * 8 + 2 * t4;
          float v[2];
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const float gt = acc[i][j][2 * hr + q];
            const float up = acc[i][j + 1][2 * hr + q];
            v[q] = gt / (1.f + __expf(-gt)) * up;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + orow * half + col) =
              __floats2bfloat162_rn(v[0], v[1]);
        }
      } else {
        const float s = row_w[orow];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn + j * 8 + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(out + orow * N + col) =
              __floats2bfloat162_rn(acc[i][j][2 * hr] * s,
                                    acc[i][j][2 * hr + 1] * s);
        }
      }
    }
}

template <int MODE>
cudaError_t launch_gemm(const void* a, const void* rows, const void* offsets,
                        const void* w, const void* row_w, void* out, int M,
                        int N, int K, int n_experts, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kGemmSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid(N / kBN, (M + kBM - 1) / kBM + n_experts);
  moe_gemm_kernel<MODE><<<grid, kGemmThreads, kGemmSmem, stream>>>(
      static_cast<const bf16*>(a), static_cast<const int*>(rows),
      static_cast<const int*>(offsets), static_cast<const bf16*>(w),
      static_cast<const float*>(row_w), static_cast<bf16*>(out), N, K,
      n_experts);
  return cudaGetLastError();
}

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

bool shapes_ok(int M, int N, int K, int n_experts) {
  return M >= 1 && N >= kBN && N % kBN == 0 && K >= kBK && K % kBK == 0 &&
         n_experts >= 1 && (M + kBM - 1) / kBM + n_experts <= 65535;
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
  if (!shapes_ok(M, N, K, n_experts) || N % 16 || !aligned16({x, w13, h}))
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
