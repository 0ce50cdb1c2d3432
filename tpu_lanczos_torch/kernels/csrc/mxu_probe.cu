// The dense-block probe on Hopper (sm_90a), bound through ctypes: does a
// stream of (128, 128) bf16 0/1 blocks through the tensor cores run at
// the HBM rate?
//
// Replaces the Pallas TPU kernel tpu_lanczos/eval/mxu_probe.py::
// _make_kernel (:50), launched by _run (:105, pallas_call :106).  Over B
// blocks A_b (rows b*128 .. b*128+127 of a), with x_hi and x_lo the
// (m_rows, 128) bf16 rows of x:
//
//   dma   acc += float(A_b[:m_rows, :])       (copy baseline, CUDA cores)
//   mxu1  acc += x_hi @ A_b                   (tensor cores, f32 accumulate)
//   mxu2  acc += x_hi @ A_b + x_lo @ A_b      (the hi/lo split)
//
// Design notes.
// - The TPU kernel is one sequential grid step with a 2-deep DMA ring.
//   Here each CTA takes a contiguous run of blocks and stages each 32 KB
//   block into shared memory with cp.async, double-buffered (the
//   counterpart of _N_PIPE = 2): block b+1 is in flight while block b is
//   consumed.
// - The tensor-core product is wmma bf16 16x16x16 with a float
//   accumulator.  x's rows are zero-padded from m_rows (<= 16) to 16; each
//   of the 8 warps owns one 16-column slice of the output and walks the
//   block's 8 k-steps; x's fragments stay in registers for the whole run.
//   mxu2 issues the second product, against x_lo, into a second
//   accumulator, added to the first once at the end: the tensor cores
//   align a sum to its largest term and drop the bits below, so x_lo's
//   terms, ~2^-9 of x_hi's, keep their precision only in an accumulator
//   of their own scale.  dma adds rows :m_rows of the staged block in
//   float on the CUDA cores, after the whole block was copied, as the TPU
//   kernel DMAs the whole block and touches a row band.
// - Each CTA writes one (16, 128) float partial; probe_reduce_kernel, a
//   second launch, sums the partials in CTA order, so the result does not
//   depend on scheduling.  dma's sums are integers below 2^24: exact in
//   any order.
// - What bounds it.  The block bytes: B * 32 KB, 512 MB at the default
//   16,384 blocks, 0.16 ms at 3.35 TB/s.  The tensor work (about 8.6
//   GFLOP with M padded to 16, twice that for mxu2) is far below the
//   card's bf16 rate.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kLane = 128;
constexpr int kM = 16;                     // wmma rows; m_rows <= kM
constexpr int kThreads = 256;              // 8 warps x 16 output columns
constexpr int kBlockElems = kLane * kLane;  // one block: 16,384 bf16
constexpr int kStages = 2;
constexpr int kPartial = kM * kLane;        // floats per CTA partial
constexpr size_t kSmemBytes =
    (kStages * kBlockElems + 2 * kPartial) * sizeof(__nv_bfloat16);

enum Variant { kDma = 0, kMxu1 = 1, kMxu2 = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// waits until at most one committed group of this thread is in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// every thread issues its share of block b's 2,048 16-byte copies
__device__ __forceinline__ void stage(__nv_bfloat16* buf,
                                      const __nv_bfloat16* a, int64_t b) {
  const char* src = reinterpret_cast<const char*>(a + b * kBlockElems);
  char* dst = reinterpret_cast<char*>(buf);
  for (int k = threadIdx.x; k < kBlockElems * 2 / 16; k += kThreads) {
    cp_async16(dst + k * 16, src + k * 16);
  }
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const __nv_bfloat16* __restrict__ a,
             const __nv_bfloat16* __restrict__ xh,
             const __nv_bfloat16* __restrict__ xl,
             float* __restrict__ partial, int n_blocks, int per_cta,
             int m_rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ring + kStages * kBlockElems;  // [hi | lo] (16, 128)
  const int b0 = blockIdx.x * per_cta;
  const int b1 = min(n_blocks, b0 + per_cta);
  if (b0 < b1) stage(ring, a, b0);
  cp_async_commit();
  for (int e = threadIdx.x; e < 2 * kPartial; e += kThreads) {
    const int r = (e % kPartial) / kLane;
    const __nv_bfloat16* x = e < kPartial ? xh : xl;
    xs[e] = r < m_rows ? x[e % kPartial] : __float2bfloat16(0.0f);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc, acc_lo;
  wmma::fill_fragment(acc, 0.0f);
  wmma::fill_fragment(acc_lo, 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      ah[kLane / 16], al[kLane / 16];
  if (kVariant != kDma) {
#pragma unroll
    for (int kk = 0; kk < kLane / 16; ++kk) {
      wmma::load_matrix_sync(ah[kk], xs + kk * 16, kLane);
      if (kVariant == kMxu2) {
        wmma::load_matrix_sync(al[kk], xs + kPartial + kk * 16, kLane);
      }
    }
  }
  float dacc[kPartial / kThreads] = {};

  for (int b = b0; b < b1; ++b) {
    if (b + 1 < b1) stage(ring + ((b + 1 - b0) % kStages) * kBlockElems, a,
                          b + 1);
    cp_async_commit();
    cp_async_wait_one();  // block b's group has landed (this thread's part)
    __syncthreads();      // ... and every other thread's
    const __nv_bfloat16* blk = ring + ((b - b0) % kStages) * kBlockElems;
    if (kVariant == kDma) {
#pragma unroll
      for (int k = 0; k < kPartial / kThreads; ++k) {
        const int e = threadIdx.x + k * kThreads;
        if (e / kLane < m_rows) dacc[k] += __bfloat162float(blk[e]);
      }
    } else {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bf;
#pragma unroll
      for (int kk = 0; kk < kLane / 16; ++kk) {
        wmma::load_matrix_sync(bf, blk + kk * 16 * kLane + warp * 16, kLane);
        wmma::mma_sync(acc, ah[kk], bf, acc);
        if (kVariant == kMxu2) wmma::mma_sync(acc_lo, al[kk], bf, acc_lo);
      }
    }
    __syncthreads();  // the slot is read out before it is refilled
  }

  float* mine = partial + static_cast<int64_t>(blockIdx.x) * kPartial;
  if (kVariant == kDma) {
#pragma unroll
    for (int k = 0; k < kPartial / kThreads; ++k) {
      mine[threadIdx.x + k * kThreads] = dacc[k];
    }
  } else {
    if (kVariant == kMxu2) {
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += acc_lo.x[i];
    }
    wmma::store_matrix_sync(mine + warp * 16, acc, kLane,
                            wmma::mem_row_major);
  }
}

// out[r, c] = sum over CTAs in order of partial[cta, r, c] for r < m_rows,
// 0 for m_rows <= r < out_rows
__global__ void probe_reduce_kernel(const float* __restrict__ partial,
                                    float* __restrict__ out, int n_cta,
                                    int m_rows, int out_rows) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= out_rows * kLane) return;
  float s = 0.0f;
  if (e / kLane < m_rows) {
    for (int c = 0; c < n_cta; ++c) s += partial[static_cast<int64_t>(c) *
                                                 kPartial + e];
  }
  out[e] = s;
}

template <int kVariant>
int launch(const void* a, const void* xh, const void* xl, void* partial,
           int n_blocks, int per_cta, int n_cta, int m_rows,
           cudaStream_t stream) {
  const cudaError_t set = cudaFuncSetAttribute(
      probe_kernel<kVariant>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (set != cudaSuccess) return static_cast<int>(set);
  probe_kernel<kVariant><<<n_cta, kThreads, kSmemBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(a),
      static_cast<const __nv_bfloat16*>(xh),
      static_cast<const __nv_bfloat16*>(xl), static_cast<float*>(partial),
      n_blocks, per_cta, m_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the probe on `stream`: a (n_blocks*128, 128) bf16, xh and xl
// (>= m_rows, 128) bf16, partial (n_cta, 16, 128) float scratch, out
// (out_rows, 128) float.  CTA i takes blocks [i*per_cta, (i+1)*per_cta).
// variant: 0 dma, 1 mxu1, 2 mxu2.  Returns the first CUDA error of the
// two launches (0 = launched).
extern "C" int tlt_mxu_probe(const void* a, const void* xh, const void* xl,
                             void* partial, void* out, int n_blocks,
                             int per_cta, int n_cta, int m_rows, int out_rows,
                             int variant, void* stream) {
  if (n_blocks <= 0 || per_cta <= 0 || n_cta <= 0 ||
      static_cast<int64_t>(per_cta) * n_cta < n_blocks || m_rows <= 0 ||
      m_rows > kM || out_rows < m_rows || out_rows > kM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (variant == kDma) {
    err = launch<kDma>(a, xh, xl, partial, n_blocks, per_cta, n_cta, m_rows,
                       s);
  } else if (variant == kMxu1) {
    err = launch<kMxu1>(a, xh, xl, partial, n_blocks, per_cta, n_cta, m_rows,
                        s);
  } else if (variant == kMxu2) {
    err = launch<kMxu2>(a, xh, xl, partial, n_blocks, per_cta, n_cta, m_rows,
                        s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  probe_reduce_kernel<<<(out_rows * kLane + kThreads - 1) / kThreads,
                        kThreads, 0, s>>>(static_cast<const float*>(partial),
                                          static_cast<float*>(out), n_cta,
                                          m_rows, out_rows);
  return static_cast<int>(cudaGetLastError());
}
