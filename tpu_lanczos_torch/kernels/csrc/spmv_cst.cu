// One level of the CST SpMV on Hopper (sm_90a), bound through ctypes.
//
// Replaces the two Pallas TPU kernels of tpu_lanczos/kernels/
// spmv_pallas2.py, _stage_kernel (:33, pallas_call :42) and
// _deliver_kernel (:37, pallas_call :52), and the lax.scan over slots
// that alternates them (spmv_cst, :67-74).  For every cell (l, j) of the
// (128, n_cols) classT layout and the level's slots s in order:
//
//   G[c, j]    = src[c, idx1[s, c, j]]                       stage
//   out[l, j]  = acc[l, j] + sum_s G[idx3[s, l, j], j]       deliver
//
// acc is the level's starting accumulator (+0.0 when absent: level 0).
// A reduce level passes the same array as src and as acc (spmv_pallas2.py
// :80-81); src is fixed for the whole scan, so this kernel reads the
// level's input and writes a NEW buffer: in place, one thread would read
// another's already-updated cell.
//
// Design: the TPU's two kernels, in one block.
// - A block owns kJ = 32 columns j0 .. j0 + kJ of all 128 classes (252
//   blocks at bn1M, BA n=1M m=10, n_cols 8,064) and walks the level's
//   slots in order.  Per slot, one producer thread brings the slot's idx1
//   box (128 x kJ) and idx3 box (128 x kJ) into a ring of shared-memory
//   stages with 2-D TMA boxes, each stage completing on an mbarrier.  A
//   TMA row must start 16-byte aligned and n_cols is only a multiple of
//   8, so idx3 (uint8) is stored with its rows padded to a multiple of 16
//   bytes (cst.py: from_numpy).
// - Stage: each of the 512 consumer threads writes G[c, j] for its 8
//   staging cells into a shared-memory buffer, loading src only where
//   idx1 is not the zero column (cst.py: zero_col = n_cols - 1); a ghost
//   staging cell gets +0.0 without a load.  Slot s+kAhead's loads are
//   issued before slot s is delivered, so their latency hides behind it.
// - Deliver: after a barrier of the consumer warps, each thread adds
//   G[idx3[s, l, j], j] from shared memory into the register sums of its
//   8 dest cells.  Two G buffers alternate, so one barrier a slot
//   suffices.
// - Bit-identity.  The slots are added in order into one register per
//   cell, from acc or +0.0, as the reference adds one delivered slot at a
//   time.  Ghost dest cells point at a ghost staging cell of the same
//   slot and add its G.  The reference reads src's zero column there,
//   which may hold -0.0 (x after a mask multiply); this kernel adds +0.0.
//   That is the same sum: acc starts at +0.0 or at an earlier level's
//   output, itself a sum from +0.0, and in round-to-nearest a sum is -0.0
//   only if both addends are, so acc is never -0.0 and adding +0.0 or
//   -0.0 leaves it unchanged.
// - What bounds it.  The index bytes, read once per SpMV: idx3 is uint8
//   (classes 0..127) and idx1 int16 while n_cols <= 32,767 (int32
//   above), 3 bytes a slot cell, 641 MB at bn1M (1.71 GB as the TPU's
//   int32 pair), ~0.19 ms at 3.35 TB/s.  src (4 MB at bn1M) stays in the
//   50 MB L2.  The measured walk reads them at ~1.5 TB/s: each slot is a
//   block-wide step (TMA rows of 32-64 bytes, one barrier).
// - One launch per level replaces the reference's 2 x slots pallas_calls
//   (3 launches per SpMV at bn1M, whose levels have 131, 75 and 1 slots,
//   against 414).

#include <cstdint>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kClasses = 128;
constexpr int kJ = 32;  // columns a block owns
// consumer thread tid owns column tid % kJ of the classes tid / kJ + 16m
constexpr int kGroups = 16;
constexpr int kConsumers = kGroups * kJ;
constexpr int kRowsPerThread = kClasses / kGroups;
constexpr int kThreads = kConsumers + 32;  // and one producer warp

constexpr int kAhead = 2;  // slots whose src loads are in flight

// Slots in the shared-memory ring: the kAhead + 1 in use and some ahead
// of them, fewer for f64, whose G buffers are twice as large, so that
// two blocks share an SM.
template <typename T>
__host__ __device__ constexpr int stages() {
  return sizeof(T) == 4 ? kAhead + 4 : kAhead + 2;
}

// A stage holds the idx1 box (128, p1) and the idx3 box (128, p3), rows
// p1 and p3 <= kJ wide: kJ, or less on a pack narrower than kJ columns.
template <typename I1>
struct Stage {
  static constexpr int kIdx3 = tlt::align128(kClasses * kJ * sizeof(I1));
  static constexpr int kBytes = kIdx3 + kClasses * kJ;
};

// Consumer-warp barrier (named barrier 1); the producer warp is not in it.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <typename T, typename I1>
__global__ void __launch_bounds__(kThreads)
cst_level_kernel(const __grid_constant__ CUtensorMap idx1_map,
                 const __grid_constant__ CUtensorMap idx3_map,
                 const T* __restrict__ src, const T* __restrict__ acc_in,
                 T* __restrict__ out, int n_slots, int n_cols, int p1,
                 int p3) {
  constexpr int kStages = stages<T>();
  using St = Stage<I1>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kStages], empty[kStages];
  T* g_buf = reinterpret_cast<T*>(smem + kStages * St::kBytes);  // [2][128][kJ]

  const int j0 = static_cast<int>(blockIdx.x) * kJ;
  const int tid = static_cast<int>(threadIdx.x);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tlt::mbar_init(&full[s], 1);
      tlt::mbar_init(&empty[s], kConsumers / 32);
    }
    tlt::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread issues
    if (tid != kConsumers) return;
    for (int s = 0; s < n_slots; ++s) {
      const int b = s % kStages;
      const int use = s / kStages;
      if (use > 0) tlt::mbar_wait(&empty[b], (use - 1) & 1);
      uint8_t* buf = smem + b * St::kBytes;
      tlt::mbar_arrive_expect_tx(
          &full[b], static_cast<uint32_t>(kClasses * (p1 * sizeof(I1) + p3)));
      tlt::tma_load_2d(buf, &idx1_map, j0, s * kClasses, &full[b]);
      tlt::tma_load_2d(buf + St::kIdx3, &idx3_map, j0, s * kClasses,
                       &full[b]);
    }
    return;
  }

  const int grp = tid / kJ;
  const int j = tid % kJ;
  const bool live = j0 + j < n_cols;
  const int zero_col = n_cols - 1;
  T acc[kRowsPerThread];
#pragma unroll
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int l = grp + kGroups * m;
    acc[m] = acc_in != nullptr && live
                 ? acc_in[static_cast<int64_t>(l) * n_cols + j0 + j]
                 : T(0);
  }

  // slot s's staged values for this thread's cells, +0.0 for ghosts;
  // slot s+kAhead's loads are issued while slot s is delivered
  auto gather = [&](int s, T (&v)[kRowsPerThread]) {
    if (s >= n_slots) return;
    const int b = s % kStages;
    tlt::mbar_wait(&full[b], (s / kStages) & 1);
    const I1* i1 = reinterpret_cast<const I1*>(smem + b * St::kBytes);
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int c = grp + kGroups * m;
      const int col = static_cast<int>(i1[c * p1 + j]);
      v[m] = live && col != zero_col
                 ? src[static_cast<int64_t>(c) * n_cols + col]
                 : T(0);
    }
  };
  auto put = [&](int s, const T (&v)[kRowsPerThread]) {
    T* g = g_buf + (s & 1) * kClasses * kJ;
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) g[(grp + kGroups * m) * kJ + j] = v[m];
  };

  T staged[kAhead][kRowsPerThread];
#pragma unroll
  for (int u = 0; u < kAhead; ++u) gather(u, staged[u]);
  put(0, staged[0]);
  consumers_sync();
  for (int s0 = 0; s0 < n_slots; s0 += kAhead) {
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int s = s0 + u;  // staged[u] is free: slot s is in G
      if (s < n_slots) {
        gather(s + kAhead, staged[u]);
        const int b = s % kStages;
        const uint8_t* i3 = smem + b * St::kBytes + St::kIdx3;  // [128][p3]
        const T* g = g_buf + (s & 1) * kClasses * kJ;
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int l = grp + kGroups * m;
          const int c = live ? i3[l * p3 + j] : 0;
          acc[m] += g[c * kJ + j];
        }
        __syncwarp();
        if (tid % 32 == 0) tlt::mbar_arrive(&empty[b]);
        if (s + 1 < n_slots) put(s + 1, staged[(u + 1) % kAhead]);
        consumers_sync();
      }
    }
  }

  if (live) {
#pragma unroll
    for (int m = 0; m < kRowsPerThread; ++m) {
      out[static_cast<int64_t>(grp + kGroups * m) * n_cols + j0 + j] = acc[m];
    }
  }
}

template <typename T, typename I1>
int launch(const void* src, const void* acc, const void* idx1,
           const void* idx3, void* out, int n_slots, int n_cols, int pitch3,
           cudaStream_t stream) {
  CUtensorMap idx1_map, idx3_map;
  // idx1 (slots*128, n_cols) in (128, p1) boxes; idx3 (slots*128, pitch3)
  // in (128, p3) boxes; a box row is a multiple of 16 bytes
  const int p1 = n_cols < kJ ? n_cols : kJ;
  const int p3 = pitch3 < kJ ? pitch3 : kJ;
  if (!tlt::encode_2d(&idx1_map, idx1, sizeof(I1), n_cols,
                      static_cast<uint64_t>(n_slots) * kClasses,
                      static_cast<uint64_t>(n_cols) * sizeof(I1), p1,
                      kClasses) ||
      !tlt::encode_2d(&idx3_map, idx3, 1, pitch3,
                      static_cast<uint64_t>(n_slots) * kClasses, pitch3, p3,
                      kClasses)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = stages<T>() * Stage<I1>::kBytes +
                   2 * kClasses * kJ * static_cast<int>(sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      cst_level_kernel<T, I1>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks = static_cast<unsigned>((n_cols + kJ - 1) / kJ);
  cst_level_kernel<T, I1><<<blocks, kThreads, smem, stream>>>(
      idx1_map, idx3_map, static_cast<const T*>(src),
      static_cast<const T*>(acc), static_cast<T*>(out), n_slots, n_cols, p1,
      p3);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_idx(const void* src, const void* acc, const void* idx1,
               const void* idx3, void* out, int n_slots, int n_cols,
               int pitch3, int idx1_bytes, cudaStream_t stream) {
  if (idx1_bytes == 2) {
    return launch<T, int16_t>(src, acc, idx1, idx3, out, n_slots, n_cols,
                              pitch3, stream);
  }
  if (idx1_bytes == 4) {
    return launch<T, int32_t>(src, acc, idx1, idx3, out, n_slots, n_cols,
                              pitch3, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Launches one CST level on `stream`; `acc` may be null (start from +0.0).
// idx1 is int16 (idx1_bytes 2) or int32 (4), (slots, 128, n_cols) with
// n_cols a multiple of 8; idx3 is uint8 (slots, 128, n_cols) in rows
// pitch3 bytes apart (a multiple of 16, at least n_cols); value_bytes is
// 4 (float) or 8 (double).  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int tlt_spmv_cst_level(const void* src, const void* acc,
                                  const void* idx1, const void* idx3,
                                  void* out, int n_slots, int n_cols,
                                  int pitch3, int idx1_bytes, int value_bytes,
                                  void* stream) {
  if (n_slots <= 0 || n_cols <= 0 || n_cols % 8 != 0 || pitch3 < n_cols ||
      pitch3 % 16 != 0 ||
      static_cast<int64_t>(n_slots) * kClasses > INT32_MAX ||
      !tlt::aligned16(idx1) || !tlt::aligned16(idx3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4) {
    return launch_idx<float>(src, acc, idx1, idx3, out, n_slots, n_cols,
                             pitch3, idx1_bytes, s);
  }
  if (value_bytes == 8) {
    return launch_idx<double>(src, acc, idx1, idx3, out, n_slots, n_cols,
                              pitch3, idx1_bytes, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
