// One level of the CPG SpMV on Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel tpu_lanczos/kernels/spmv_cpg.py::
// _make_kernel (:85), launched by _run_level (:320, pallas_call :342) in
// its plain, classic-layout form (cpg_level_kernel) and in its
// compensated form (compensated=True, :295-301; cpg_level_comp_kernel,
// below).  For every dest chunk D and dest cell
// (ld, rd) it computes
//
//   out[D*sub + rd, ld] = base[D*sub + rd, ld]
//       + sum_{t in [starts[D], starts[D] + counts[D])}
//             x[s_ids[t]*sub + L2, L1[L2, ld]],   L2 = l2_t[ld, rd]
//
// with l1_t = l1[t*sub : (t+1)*sub] (sub, 128) and l2_t = l2[t*128 :
// (t+1)*128] (128, sub).  The sum runs in tile order from 0, and base (if
// given) is added last, exactly as the reference adds its tile sum to x
// or y outside the kernel: the result is bit-identical to the reference.
// Output is the untransposed (n_chunks*sub, 128) y layout, so no
// transpose pass follows.
//
// Design notes.
// - Parallelism.  The TPU ran one grid step per dest chunk; at bn1M
//   (BA n=1M, m=10, sub=512) that is ~16 real chunks, far too few blocks
//   for 132 SMs.  Here one thread owns one dest cell: a 2-D grid over
//   (blocks of cells, D), 65,536 cells per chunk at sub=512.  Each thread
//   walks D's tiles in order with one register accumulator; that per-cell
//   order is what keeps the result bit-identical.
// - Coalescing.  l2 is row-major (T*128, sub), so cell c = ld*sub + rd
//   with rd fastest makes each warp's l2 read one contiguous run: l2 is
//   the bulk of the bytes.  The l1 read (t*sub + L2)*128 + ld and the x
//   read are data-dependent gathers; the y write is strided by 128.  Both
//   are left as they are in this first kernel.
// - Source chunk.  A classic sub=512 source chunk is 512*128*4 B = 256
//   KB, more than one block's 227 KB of shared memory, so x is gathered
//   straight from global memory: the whole x of bn1M (a few MB) stays
//   in the 50 MB L2.
// - What bounds it.  The index bytes: each tile carries sub*128 B of l1
//   plus 128*sub*sizeof(L2) B of l2 (64 KB + 128 KB at sub=512), and the
//   whole pack is read once per SpMV (~2,200 tiles at bn1M, ~420 MB):
//   ~0.13 ms at 3.35 TB/s is the roofline this kernel is measured
//   against.  The tile loop is unrolled so several tiles' independent
//   l2 -> l1 -> x load chains are in flight per thread.
// - Index types.  Templated on the l2 type (uint8 for sub <= 256, int16
//   above); l1 is int8 with values 0..127.  Every tile offset is 64-bit:
//   t*sub*128 passes 2^31 on multi-GB packs.
// - No masking.  Ghost dest cells point at a staging sublane whose l1
//   entry is lane 127, a structural zero of x, so they add 0.  The TPU's
//   pair_mask and run_ids only scheduled its VMEM and DMA; unused here.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;
constexpr int kThreads = 256;

// x[s_ids[t]*sub + L2, L1[L2, ld]] for tile t and dest cell c = ld*sub + rd
template <typename T, typename L2T>
__device__ __forceinline__ T tile_value(const T* __restrict__ x,
                                        const int8_t* __restrict__ l1,
                                        const L2T* __restrict__ l2,
                                        const int32_t* __restrict__ s_ids,
                                        int64_t t, int64_t cells, int c,
                                        int sub, int ld) {
  const int64_t ss = static_cast<int64_t>(l2[t * cells + c]);
  const int lane = l1[(t * sub + ss) * kLane + ld];
  const int64_t s = s_ids[t];
  return x[(s * sub + ss) * kLane + lane];
}

template <typename T, typename L2T>
__global__ void __launch_bounds__(kThreads)
cpg_level_kernel(const T* __restrict__ x, const int8_t* __restrict__ l1,
                 const L2T* __restrict__ l2, const int32_t* __restrict__ s_ids,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ counts,
                 const T* __restrict__ base, T* __restrict__ out, int sub) {
  const int64_t cells = static_cast<int64_t>(sub) * kLane;
  const int c = blockIdx.x * kThreads + threadIdx.x;  // ld * sub + rd
  if (c >= cells) return;
  const int d = blockIdx.y;
  const int ld = c / sub;
  const int rd = c - ld * sub;
  const int64_t start = starts[d];
  const int count = counts[d];
  T acc = T(0);
#pragma unroll 4
  for (int i = 0; i < count; ++i) {
    acc += tile_value(x, l1, l2, s_ids, start + i, cells, c, sub, ld);
  }
  const int64_t o = (static_cast<int64_t>(d) * sub + rd) * kLane + ld;
  out[o] = base != nullptr ? base[o] + acc : acc;
}

// The compensated level (float only): the same tile walk with a Knuth
// two-sum per tile, acc and its error stream err both from 0:
//
//   s = acc + g;  z = s - acc;  err += (acc - (s - z)) + (g - z);  acc = s
//
// in exactly this order, as the Pallas body has it.  The two-sum holds
// only if every add rounds as written: it has no multiply, so nvcc's
// default --fmad=true has nothing to contract, and this file must never
// be built with -use_fast_math or any flag that reassociates adds.
// There is no base: the caller folds levels with a two-sum outside the
// kernel (spmv_cpg.py:477-478).  A ghost cell's tile value is the
// structural zero of lane 127, which leaves acc and err unchanged, as
// the reference's masked duplicate tiles do.
template <typename L2T>
__global__ void __launch_bounds__(kThreads)
cpg_level_comp_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ l1,
                      const L2T* __restrict__ l2,
                      const int32_t* __restrict__ s_ids,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts,
                      float* __restrict__ out, float* __restrict__ err,
                      int sub) {
  const int64_t cells = static_cast<int64_t>(sub) * kLane;
  const int c = blockIdx.x * kThreads + threadIdx.x;  // ld * sub + rd
  if (c >= cells) return;
  const int d = blockIdx.y;
  const int ld = c / sub;
  const int rd = c - ld * sub;
  const int64_t start = starts[d];
  const int count = counts[d];
  float acc = 0.0f;
  float e = 0.0f;
#pragma unroll 4
  for (int i = 0; i < count; ++i) {
    const float g = tile_value(x, l1, l2, s_ids, start + i, cells, c, sub, ld);
    const float s = acc + g;
    const float z = s - acc;
    e += (acc - (s - z)) + (g - z);
    acc = s;
  }
  const int64_t o = (static_cast<int64_t>(d) * sub + rd) * kLane + ld;
  out[o] = acc;
  err[o] = e;
}

template <typename T, typename L2T>
void launch(const void* x, const void* l1, const void* l2, const void* s_ids,
            const void* starts, const void* counts, const void* base,
            void* out, int n_chunks, int sub, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((sub * kLane) / kThreads),
                  static_cast<unsigned>(n_chunks));
  cpg_level_kernel<T, L2T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(l1),
      static_cast<const L2T*>(l2), static_cast<const int32_t*>(s_ids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      static_cast<const T*>(base), static_cast<T*>(out), sub);
}

template <typename L2T>
void launch_comp(const void* x, const void* l1, const void* l2,
                 const void* s_ids, const void* starts, const void* counts,
                 void* out, void* err, int n_chunks, int sub,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((sub * kLane) / kThreads),
                  static_cast<unsigned>(n_chunks));
  cpg_level_comp_kernel<L2T><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(l1),
      static_cast<const L2T*>(l2), static_cast<const int32_t*>(s_ids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      static_cast<float*>(out), static_cast<float*>(err), sub);
}

bool bad_shape(int n_chunks, int sub) {
  return n_chunks <= 0 || n_chunks > 65535 || sub <= 0 || sub % kLane != 0;
}

}  // namespace

// Launches one CPG level on `stream`; `base` may be null.  value_bytes is
// 4 (float) or 8 (double), l2_bytes 1 (uint8) or 2 (int16).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tlt_spmv_cpg_level(const void* x, const void* l1,
                                  const void* l2, const void* s_ids,
                                  const void* starts, const void* counts,
                                  const void* base, void* out, int n_chunks,
                                  int sub, int l2_bytes, int value_bytes,
                                  void* stream) {
  if (bad_shape(n_chunks, sub)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4 && l2_bytes == 1) {
    launch<float, uint8_t>(x, l1, l2, s_ids, starts, counts, base, out,
                           n_chunks, sub, s);
  } else if (value_bytes == 4 && l2_bytes == 2) {
    launch<float, int16_t>(x, l1, l2, s_ids, starts, counts, base, out,
                           n_chunks, sub, s);
  } else if (value_bytes == 8 && l2_bytes == 1) {
    launch<double, uint8_t>(x, l1, l2, s_ids, starts, counts, base, out,
                            n_chunks, sub, s);
  } else if (value_bytes == 8 && l2_bytes == 2) {
    launch<double, int16_t>(x, l1, l2, s_ids, starts, counts, base, out,
                            n_chunks, sub, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches one compensated CPG level on `stream`: float x, out and err
// (no base).  l2_bytes is 1 (uint8) or 2 (int16).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tlt_spmv_cpg_level_comp(const void* x, const void* l1,
                                       const void* l2, const void* s_ids,
                                       const void* starts, const void* counts,
                                       void* out, void* err, int n_chunks,
                                       int sub, int l2_bytes, void* stream) {
  if (bad_shape(n_chunks, sub)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2_bytes == 1) {
    launch_comp<uint8_t>(x, l1, l2, s_ids, starts, counts, out, err,
                         n_chunks, sub, s);
  } else if (l2_bytes == 2) {
    launch_comp<int16_t>(x, l1, l2, s_ids, starts, counts, out, err,
                         n_chunks, sub, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
