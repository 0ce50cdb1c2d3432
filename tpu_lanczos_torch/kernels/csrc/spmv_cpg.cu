// One level of the CPG SpMV on Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel tpu_lanczos/kernels/spmv_cpg.py::
// _make_kernel (:85), launched by _run_level (:320, pallas_call :342) in
// its plain form (cpg_level_kernel) and in its compensated form
// (compensated=True, :295-301; cpg_level_comp_kernel), each in the
// classic layout, and in the slab layout (slab=True, :184-205;
// cpg_slab_level_kernel, cpg_slab_level_comp_kernel).  For every dest
// chunk D and dest cell (ld, rd) the classic layout computes
//
//   out[D*sub + rd, ld] = base[D*sub + rd, ld]
//       + sum_{t in [starts[D], starts[D] + counts[D])}
//             x[s_ids[t]*sub + L2, L1[L2, ld]],   L2 = l2_t[ld, rd]
//
// with l1_t = l1[t*sub : (t+1)*sub] (sub, 128) and l2_t = l2[t*128 :
// (t+1)*128] (128, sub).  The sum runs in tile order from +0.0, and base
// (if given) is added last, exactly as the reference adds its tile sum to
// x or y outside the kernel: the result is bit-identical to the
// reference.  Output is the untransposed (n_chunks*sub, 128) y layout, so
// no transpose pass follows.
//
// The slab layout makes every tile source-slab-pure: s_ids are GLOBAL
// slab ids (128 rows of x each, not chunk ids times sub), l1_t = l1[t*128
// : (t+1)*128] is (128, 128), and l2 is uint8 at every sub with bit 7
// marking a ghost dest cell:
//
//   L2 = l2_t[ld, rd];  v = L2 >= 128 ? +0.0
//                           : x[s_ids[t]*128 + L2, L1[L2, ld]]
//
// A ghost adds +0.0 (no skipped add), as the Pallas body's
// where(idx < LANE, part, zero) does, so the sum is bit-identical too.
//
// Design of the classic walk, as measured on the H100 (PERF.md, PR 5).
// - What bounds it.  The index bytes are read once per SpMV (~2,200 tiles
//   of 64 KB of l1 and 128 KB of l2 at bn1M, ~440 MB, ~0.13 ms at 3.35
//   TB/s), but the time goes to the gathers: per real entry (~14% of the
//   tile cells) one byte of l1 at a random row of the tile and four bytes
//   of x at a random row of the source chunk, each a 32-byte sector of
//   the L2 cache, read by latency-bound warps.
// - One thread per dest cell walks D's tiles in order with one register
//   accumulator (32-40 registers, 48-64 warps per SM), which is what
//   keeps the sum bit-identical and what hides the gather latency; the
//   tile loop is unrolled 8 deep so that several tiles' l2 -> l1 -> x
//   chains are in flight per thread.  Staging each tile's l1 columns (and
//   l2 rows) in a shared-memory ring did not pay: with 16 dest chunks on
//   132 SMs a CTA can own only ~1/8 of a chunk's cells, so a staged l1
//   sector serves about one real lookup, as many as the gather it
//   replaces, and the copies, barriers and the shared memory taken from
//   the L1 cache cost more (0.57 to 1.3 ms for the bn1M main level
//   against 0.42 ms here).
// - Coalesced output.  A block is 32 dest sublanes x 8 dest lanes, one
//   lane per warp, so each warp's l2 read is one contiguous run; the
//   block writes its cells (and reads base) through a shared-memory
//   transpose, eight contiguous values per row, where a warp of the first
//   port wrote 32 values 512 bytes apart.
// - Heaviest chunks first.  Dest chunks hold very different tile counts
//   (bn1M's main level: 93 to 340 a chunk, median 118).  With up to
//   tlt::kHeavyFirstMax chunks, block row blockIdx.y walks the chunk of that
//   place in the tile-count order, most first, so the longest walks start
//   first and do not form the tail.
// - Ghost cells.  ~86% of bn1M's tile cells are ghosts: L2 points at a
//   staging sublane whose l1 entry is lane 127, a structural zero of x
//   (the pack never places a unit there), and no real entry has lane 127.
//   The compensated walk adds +0.0 for a ghost without loading x.  That
//   is bit-identical: acc starts at +0.0 and in round-to-nearest a sum is
//   -0.0 only if both addends are, so acc is never -0.0 and adding +0.0
//   or -0.0 to it gives acc, and the two-sum gives err += +0.0 for g =
//   +0.0 and g = -0.0 alike.  Every level's input holds +-0.0 in lane 127
//   (tests/test_torch_spmv.py pins this premise).  The plain walk loads x
//   for ghosts too: the skip made it 13% slower there (the ghosts of a
//   warp share one cached address), and it made the compensated walk
//   faster.
//
// The slab walk is the first port's: one thread per dest cell c = ld*sub
// + rd (rd fastest) in blocks of 256 cells, l1 and x gathered from global
// memory, outputs written 512 bytes apart.  The classic walk above ran
// the slab layout 23% slower (SpMV 1.114 ms against 0.876-0.907 ms).
//
// Index types: l2 is uint8 for sub <= 256 and int16 above in the classic
// layout, uint8 always in the slab layout; l1 is int8 with values 0..127.
// Every tile offset is 64-bit: t*sub*128 passes 2^31 on multi-GB packs.
// The TPU's pair_mask and run_ids only scheduled its VMEM and DMA; unused
// here.

#include <cstdint>
#include <cuda_runtime.h>

#include "heavy_first.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kGhost = kLane - 1;  // lane 127: the structural zero of x
constexpr int kThreads = 256;
constexpr int kRows = 32;                 // classic block: dest sublanes
constexpr int kCols = kThreads / kRows;   // ... and dest lanes, one a warp
static_assert(tlt::kHeavyFirstMax <= kThreads, "one thread ranks one chunk");

// The classic block's cells: rows rd0 .. rd0 + kRows (a warp's lanes) of
// lanes ld0 .. ld0 + kCols (one a warp); this thread's (ld, rd) and its
// l2 column c = ld*sub + rd.
struct Cells {
  int ld0, rd0, ld, rd, c;
};

__device__ __forceinline__ Cells block_cells(int sub) {
  const int row_blocks = sub / kRows;
  Cells k;
  k.ld0 = static_cast<int>(blockIdx.x) / row_blocks * kCols;
  k.rd0 = static_cast<int>(blockIdx.x) % row_blocks * kRows;
  k.ld = k.ld0 + static_cast<int>(threadIdx.x) / kRows;
  k.rd = k.rd0 + static_cast<int>(threadIdx.x) % kRows;
  k.c = k.ld * sub + k.rd;
  return k;
}

// Classic tile t's value for dest cell (ld, c): x[s_ids[t]*sub + L2,
// L1[L2, ld]], or, with kSkipGhost, +0.0 without a load where L1 is lane
// 127.
template <bool kSkipGhost, typename T, typename L2T>
__device__ __forceinline__ T tile_value(const T* __restrict__ x,
                                        const int8_t* __restrict__ l1,
                                        const L2T* __restrict__ l2,
                                        const int32_t* __restrict__ s_ids,
                                        int64_t t, int64_t cells, int c,
                                        int sub, int ld) {
  const int ss = static_cast<int>(l2[t * cells + c]);
  const int lane = l1[(t * sub + ss) * kLane + ld];
  const T* p = x + (static_cast<int64_t>(s_ids[t]) * sub + ss) * kLane + lane;
  if constexpr (kSkipGhost) {
    return lane != kGhost ? *p : T(0);
  } else {
    return *p;
  }
}

// Writes the block's cells of v to y (plus base, if given) through the
// transpose tile tr: each row's kCols values are contiguous in y.  Every
// thread must call it.
template <typename T>
__device__ __forceinline__ void store_cells(T v, T (&tr)[kRows][kCols + 1],
                                            const Cells& k, int d, int sub,
                                            const T* __restrict__ base,
                                            T* __restrict__ out) {
  tr[threadIdx.x % kRows][threadIdx.x / kRows] = v;
  __syncthreads();
  const int r = static_cast<int>(threadIdx.x) / kCols;
  const int col = static_cast<int>(threadIdx.x) % kCols;
  const int64_t o =
      (static_cast<int64_t>(d) * sub + k.rd0 + r) * kLane + k.ld0 + col;
  out[o] = base != nullptr ? base[o] + tr[r][col] : tr[r][col];
}

template <typename T, typename L2T>
__global__ void __launch_bounds__(kThreads)
cpg_level_kernel(const T* __restrict__ x, const int8_t* __restrict__ l1,
                 const L2T* __restrict__ l2, const int32_t* __restrict__ s_ids,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ counts,
                 const T* __restrict__ base, T* __restrict__ out,
                 int n_chunks, int sub) {
  const Cells k = block_cells(sub);
  const int d = tlt::heavy_first_chunk(counts, n_chunks);
  const int64_t cells = static_cast<int64_t>(sub) * kLane;
  const int64_t start = starts[d];
  const int count = counts[d];
  T acc = T(0);
#pragma unroll 8
  for (int i = 0; i < count; ++i) {
    acc += tile_value<false>(x, l1, l2, s_ids, start + i, cells, k.c, sub,
                             k.ld);
  }
  __shared__ T tr[kRows][kCols + 1];
  store_cells(acc, tr, k, d, sub, base, out);
}

// The compensated level (float only): the same walk with a Knuth two-sum
// per tile, acc and its error stream err both from 0:
//
//   s = acc + g;  z = s - acc;  err += (acc - (s - z)) + (g - z);  acc = s
//
// in exactly this order, as the Pallas body has it.  The two-sum holds
// only if every add rounds as written: it has no multiply, so nvcc's
// default --fmad=true has nothing to contract, and this file must never
// be built with -use_fast_math or any flag that reassociates adds.
// There is no base: the caller folds levels with a two-sum outside the
// kernel (spmv_cpg.py:477-478).
template <typename L2T>
__global__ void __launch_bounds__(kThreads)
cpg_level_comp_kernel(const float* __restrict__ x,
                      const int8_t* __restrict__ l1,
                      const L2T* __restrict__ l2,
                      const int32_t* __restrict__ s_ids,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts,
                      float* __restrict__ out, float* __restrict__ err,
                      int n_chunks, int sub) {
  const Cells k = block_cells(sub);
  const int d = tlt::heavy_first_chunk(counts, n_chunks);
  const int64_t cells = static_cast<int64_t>(sub) * kLane;
  const int64_t start = starts[d];
  const int count = counts[d];
  float acc = 0.0f;
  float e = 0.0f;
#pragma unroll 8
  for (int i = 0; i < count; ++i) {
    const float g = tile_value<true>(x, l1, l2, s_ids, start + i, cells,
                                     k.c, sub, k.ld);
    const float s = acc + g;
    const float z = s - acc;
    e += (acc - (s - z)) + (g - z);
    acc = s;
  }
  __shared__ float tr_acc[kRows][kCols + 1];
  __shared__ float tr_err[kRows][kCols + 1];
  store_cells(acc, tr_acc, k, d, sub, static_cast<const float*>(nullptr),
              out);
  store_cells(e, tr_err, k, d, sub, static_cast<const float*>(nullptr), err);
}

// Slab tile t's value for dest cell c = ld*sub + rd: +0.0 for a ghost
// (bit 7 of L2), else x[s_ids[t]*128 + L2, L1[L2, ld]] with (128, 128) l1
// tiles.
template <typename T>
__device__ __forceinline__ T slab_value(const T* __restrict__ x,
                                        const int8_t* __restrict__ l1,
                                        const uint8_t* __restrict__ l2,
                                        const int32_t* __restrict__ s_ids,
                                        int64_t t, int64_t cells, int c,
                                        int ld) {
  const int64_t ss = static_cast<int64_t>(l2[t * cells + c]);
  if (ss >= kLane) return T(0);
  const int lane = l1[(t * kLane + ss) * kLane + ld];
  const int64_t s = s_ids[t];
  return x[(s * kLane + ss) * kLane + lane];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
cpg_slab_level_kernel(const T* __restrict__ x, const int8_t* __restrict__ l1,
                      const uint8_t* __restrict__ l2,
                      const int32_t* __restrict__ s_ids,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts,
                      const T* __restrict__ base, T* __restrict__ out,
                      int sub) {
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
    acc += slab_value(x, l1, l2, s_ids, start + i, cells, c, ld);
  }
  const int64_t o = (static_cast<int64_t>(d) * sub + rd) * kLane + ld;
  out[o] = base != nullptr ? base[o] + acc : acc;
}

// The compensated slab level: the slab walk with the two-sum above.
__global__ void __launch_bounds__(kThreads)
cpg_slab_level_comp_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ l1,
                           const uint8_t* __restrict__ l2,
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
    const float g = slab_value(x, l1, l2, s_ids, start + i, cells, c, ld);
    const float s = acc + g;
    const float z = s - acc;
    e += (acc - (s - z)) + (g - z);
    acc = s;
  }
  const int64_t o = (static_cast<int64_t>(d) * sub + rd) * kLane + ld;
  out[o] = acc;
  err[o] = e;
}

// Both layouts: sub*128/256 blocks of 256 cells per dest chunk.
dim3 level_grid(int n_chunks, int sub) {
  return dim3(static_cast<unsigned>((sub * kLane) / kThreads),
              static_cast<unsigned>(n_chunks));
}

template <typename T, typename L2T>
void launch(const void* x, const void* l1, const void* l2, const void* s_ids,
            const void* starts, const void* counts, const void* base,
            void* out, int n_chunks, int sub, cudaStream_t stream) {
  cpg_level_kernel<T, L2T><<<level_grid(n_chunks, sub), kThreads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(l1),
      static_cast<const L2T*>(l2), static_cast<const int32_t*>(s_ids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      static_cast<const T*>(base), static_cast<T*>(out), n_chunks, sub);
}

template <typename L2T>
void launch_comp(const void* x, const void* l1, const void* l2,
                 const void* s_ids, const void* starts, const void* counts,
                 void* out, void* err, int n_chunks, int sub,
                 cudaStream_t stream) {
  cpg_level_comp_kernel<L2T><<<level_grid(n_chunks, sub), kThreads, 0,
                               stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(l1),
      static_cast<const L2T*>(l2), static_cast<const int32_t*>(s_ids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      static_cast<float*>(out), static_cast<float*>(err), n_chunks, sub);
}

template <typename T>
void launch_slab(const void* x, const void* l1, const void* l2,
                 const void* s_ids, const void* starts, const void* counts,
                 const void* base, void* out, int n_chunks, int sub,
                 cudaStream_t stream) {
  cpg_slab_level_kernel<T><<<level_grid(n_chunks, sub), kThreads, 0,
                             stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(l1),
      static_cast<const uint8_t*>(l2), static_cast<const int32_t*>(s_ids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      static_cast<const T*>(base), static_cast<T*>(out), sub);
}

bool bad_shape(int n_chunks, int sub) {
  return n_chunks <= 0 || n_chunks > 65535 || sub <= 0 || sub % kLane != 0;
}

}  // namespace

// Launches one CPG level on `stream`; `base` may be null.  value_bytes is
// 4 (float) or 8 (double), l2_bytes 1 (uint8) or 2 (int16); slab != 0
// selects the slab layout, whose l2 is always uint8.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int tlt_spmv_cpg_level(const void* x, const void* l1,
                                  const void* l2, const void* s_ids,
                                  const void* starts, const void* counts,
                                  const void* base, void* out, int n_chunks,
                                  int sub, int l2_bytes, int value_bytes,
                                  int slab, void* stream) {
  if (bad_shape(n_chunks, sub)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab != 0 && value_bytes == 4 && l2_bytes == 1) {
    launch_slab<float>(x, l1, l2, s_ids, starts, counts, base, out, n_chunks,
                       sub, s);
  } else if (slab != 0 && value_bytes == 8 && l2_bytes == 1) {
    launch_slab<double>(x, l1, l2, s_ids, starts, counts, base, out,
                        n_chunks, sub, s);
  } else if (slab != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (value_bytes == 4 && l2_bytes == 1) {
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
// (no base).  l2_bytes is 1 (uint8) or 2 (int16); slab != 0 selects the
// slab layout (uint8 l2).  Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int tlt_spmv_cpg_level_comp(const void* x, const void* l1,
                                       const void* l2, const void* s_ids,
                                       const void* starts, const void* counts,
                                       void* out, void* err, int n_chunks,
                                       int sub, int l2_bytes, int slab,
                                       void* stream) {
  if (bad_shape(n_chunks, sub)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab != 0 && l2_bytes == 1) {
    cpg_slab_level_comp_kernel<<<level_grid(n_chunks, sub), kThreads, 0,
                                 s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(l1),
        static_cast<const uint8_t*>(l2), static_cast<const int32_t*>(s_ids),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(counts), static_cast<float*>(out),
        static_cast<float*>(err), sub);
  } else if (slab != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else if (l2_bytes == 1) {
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
