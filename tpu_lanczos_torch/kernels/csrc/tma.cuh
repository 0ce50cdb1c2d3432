// Hopper bulk asynchronous copies for the level kernels (spmv_gpg.cu,
// spmv_cst.cu, the slab walk of spmv_cpg.cu) and the dense-block probe
// (mxu_probe.cu): mbarriers, 2-D TMA boxes and 1-D bulk copies into
// shared memory, and on the host the tensor-map encoding and the raise of
// a kernel's shared-memory limit.
//
// A copy completes on an mbarrier in shared memory: the issuing thread
// arms the barrier with the bytes it expects (arrive_expect_tx), the copy
// engine counts them down, and a waiting thread sees the phase flip.  A
// kernel launched without a cluster is a cluster of one, where the
// shared::cluster forms address the CTA's own shared memory; in a
// cluster, one multicast box lands in every CTA of a mask and signals
// the barrier at the same offset in each.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

namespace tlt {

__host__ __device__ constexpr int align128(int b) {
  return (b + 127) / 128 * 128;
}

// TMA and bulk copies need 16-byte aligned global addresses.
inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the copy engine; the caller
// then syncs the block before any thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` more from the copies on `bar`.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of parity `parity` of `bar` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (done == 0);
}

// The 2-D box of `map` at element coordinates (c0 innermost, c1) into
// `dst` (128-byte aligned), completing on `bar`.  Parts of the box
// outside the tensor are filled with zeros and counted all the same.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from `src` into `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The 2-D box of `map` at (c0, c1) into `dst` of every CTA of the
// cluster in `mask`, completing on the barrier at `bar`'s offset in each.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      int c0, int c1,
                                                      uint64_t* bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  return rank;
}

// Every thread of every CTA of the cluster (threads of a warp may reach
// it apart).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive;\n"
      "barrier.cluster.wait;" ::
          : "memory");
}

// One arrival on the barrier at `bar`'s offset in CTA `cta` of the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n .reg .b32 remote;\n"
      " mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}" ::"r"(
          smem_addr(bar)),
      "r"(cta)
      : "memory");
}

// A 2-D row-major tensor map: `rows` rows of `cols` elements of
// `elem_bytes` bytes (1, 2 or 4), `row_bytes` apart (a multiple of 16),
// read in boxes of box_rows x box_cols, laid out in shared memory as
// `swizzle` says (with CU_TENSOR_MAP_SWIZZLE_128B, a box row of at most
// 128 bytes whose 16-byte chunk j lands at chunk j ^ (row % 8), the box
// 1024-byte aligned).  Returns false when cuTensorMapEncodeTiled refuses
// it or cannot be found.
inline bool encode_2d(CUtensorMap* map, const void* base, int elem_bytes,
                      uint64_t cols, uint64_t rows, uint64_t row_bytes,
                      uint32_t box_cols, uint32_t box_rows,
                      CUtensorMapSwizzle swizzle =
                          CU_TENSOR_MAP_SWIZZLE_NONE) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<Encode>(fn)
               : nullptr;
  }();
  if (encode == nullptr) return false;
  const CUtensorMapDataType type =
      elem_bytes == 1   ? CU_TENSOR_MAP_DATA_TYPE_UINT8
      : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                        : CU_TENSOR_MAP_DATA_TYPE_UINT32;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Runs `set` (a cudaFuncSetAttribute call) on the current device unless
// it succeeded there before; `done` is the caller's own static, a bit a
// device (devices past 63 run it every time).  So a launch pays the
// attribute call once a kernel and device, not once a launch.
template <typename Set>
inline cudaError_t once_per_device(std::atomic<uint64_t>& done, Set set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if ((done.load(std::memory_order_acquire) & bit) != 0) return cudaSuccess;
  err = set();
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace tlt
