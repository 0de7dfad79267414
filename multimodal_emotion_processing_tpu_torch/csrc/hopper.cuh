// Shared by csrc/fused_block.cu and csrc/moe.cu: Hopper's tensor memory
// accelerator (TMA) and the shared-memory barriers (mbarrier) its copies
// complete on.
//
// A tensor map describes a 2-D row-major matrix in device memory; one
// thread asks for a box of it, and the hardware copies the box into shared
// memory, here in the 128-byte swizzle (CU_TENSOR_MAP_SWIZZLE_128B: the
// 16-byte chunk c of box row r lands at chunk c ^ (r % 8) of that row, on
// a tile aligned to kSwizzle bytes), and counts its bytes against the
// barrier's expected transaction count.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kSwizzle = 1024;   // bytes a 128-byte-swizzled tile aligns to

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// a barrier whose phase completes after `count` arrivals (and the bytes
// any arrival announced)
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` to come by the copy engine
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// wait until the barrier's phase of parity `phase` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned phase) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(phase) : "memory");
}

// the box of `map` at (column x, row y) into dst, completing on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap& map,
                                            int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(x), "r"(y),
      "r"(smem_u32(bar)) : "memory");
}

// cuTensorMapEncodeTiled of libcuda, found through the CUDA runtime (no
// link against libcuda); null where libcuda lacks it
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

}  // namespace hopper
