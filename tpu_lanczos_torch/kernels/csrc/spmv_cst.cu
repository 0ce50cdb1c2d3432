// One level of the CST SpMV on Hopper (sm_90a), bound through ctypes.
//
// Replaces the two Pallas TPU kernels of tpu_lanczos/kernels/
// spmv_pallas2.py, _stage_kernel (:33, pallas_call :42) and
// _deliver_kernel (:37, pallas_call :52), and the lax.scan over slots
// that alternates them (spmv_cst, :67-74).  For every cell (l, j) of the
// (128, n_cols) classT layout and the level's slots s in order:
//
//   out[l, j] = acc[l, j] + sum_s src[c, idx1[s, c, j]],  c = idx3[s, l, j]
//
// acc is the level's starting accumulator (+0.0 when absent: level 0).
// A reduce level passes the same array as src and as acc (spmv_pallas2.py
// :80-81); src is fixed for the whole scan, so this kernel reads the
// level's input and writes a NEW buffer: in place, one thread would read
// another's already-updated cell.
//
// Design notes.
// - One thread per cell, j fastest: each warp's idx3 read is one
//   contiguous run; the idx1 read (row c = idx3[...], column j) and the
//   src read are gathers.  The slots are added in order into one
//   register, starting from acc, as the reference adds one delivered slot
//   at a time: the result is bit-identical to the interpret run.
// - One launch per level replaces the reference's 2 x slots pallas_calls
//   (3 launches per SpMV at bn1M, BA n=1M m=10, whose levels have 131, 75
//   and 1 slots, against 414).
// - What bounds it.  The index bytes: idx1 and idx3 are int32 (slots, 128,
//   n_cols) and both are read once per SpMV, 1.73 GB at bn1M, so at least
//   0.52 ms at 3.35 TB/s.  The idx1 read depends on the idx3 read and the
//   src read on both; the slot loop is unrolled so several slots' chains
//   are in flight per thread.  src (4 MB at bn1M) stays in the 50 MB L2.
// - No masks.  Ghost staging cells read the all-zero column; ghost dest
//   cells point at a staging class that is ghost in the same slot, so
//   they add +0.0, as in the reference.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kClasses = 128;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
cst_level_kernel(const T* __restrict__ src, const T* __restrict__ acc_in,
                 const int32_t* __restrict__ idx1,
                 const int32_t* __restrict__ idx3, T* __restrict__ out,
                 int n_slots, int n_cols) {
  const int64_t cells = static_cast<int64_t>(kClasses) * n_cols;
  const int64_t cell = static_cast<int64_t>(blockIdx.x) * kThreads +
                       threadIdx.x;  // l * n_cols + j
  if (cell >= cells) return;
  const int64_t j = cell % n_cols;
  T acc = acc_in != nullptr ? acc_in[cell] : T(0);
#pragma unroll 4
  for (int s = 0; s < n_slots; ++s) {
    const int64_t slot = static_cast<int64_t>(s) * cells;
    const int64_t c = idx3[slot + cell];
    const int64_t col = idx1[slot + c * n_cols + j];
    acc += src[c * n_cols + col];
  }
  out[cell] = acc;
}

template <typename T>
void launch(const void* src, const void* acc, const void* idx1,
            const void* idx3, void* out, int n_slots, int n_cols,
            cudaStream_t stream) {
  const int64_t cells = static_cast<int64_t>(kClasses) * n_cols;
  const unsigned blocks = static_cast<unsigned>((cells + kThreads - 1) /
                                                kThreads);
  cst_level_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(acc),
      static_cast<const int32_t*>(idx1), static_cast<const int32_t*>(idx3),
      static_cast<T*>(out), n_slots, n_cols);
}

}  // namespace

// Launches one CST level on `stream`; `acc` may be null (start from +0.0).
// value_bytes is 4 (float) or 8 (double).  Returns cudaGetLastError()
// after the launch (0 = launched).
extern "C" int tlt_spmv_cst_level(const void* src, const void* acc,
                                  const void* idx1, const void* idx3,
                                  void* out, int n_slots, int n_cols,
                                  int value_bytes, void* stream) {
  if (n_slots <= 0 || n_cols <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4) {
    launch<float>(src, acc, idx1, idx3, out, n_slots, n_cols, s);
  } else if (value_bytes == 8) {
    launch<double>(src, acc, idx1, idx3, out, n_slots, n_cols, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
