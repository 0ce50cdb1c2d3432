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
// no transpose pass follows.  A shard of the row-sharded path may read its
// source from two buffers, its own rows and its halo, each in place
// (tlt_spmv_cpg_level_halo).
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
// Design of the slab walk (below, at "The slab walk"), as measured on
// the H100 (PERF.md, section 6).
// - What bounds it.  A slab tile is 80 KB of indices (16 KB of l1, 64 KB
//   of l2 at sub 512) with ~4% real cells: bn1M's main level reads ~590
//   MB of them (0.18 ms at 3.35 TB/s), 3.3x classic's tiles, and its
//   heaviest dest chunk holds 1,013 of the 7,348 tiles.  The first port
//   read l2 one byte a thread (~0.76 TB/s), and each real cell then
//   waited on two dependent gathers, the l1 byte and x.
// - Index bytes by TMA.  A block owns 16 dest lanes (TMA's least int8
//   box) and 256 rows, and a producer thread streams each tile's l1 box
//   (128 rows of 16 bytes) and l2 box (16 rows of 256 bytes) into an
//   8-stage shared-memory ring; the two row parts of a lane group form a
//   cluster that brings each l1 box once, by multicast.  A real cell's
//   source lane comes from shared memory: only x is gathered.  The
//   stream alone (consumers that only wait and release) takes ~0.34 ms
//   of the main level, less with wider l2 rows (64 rows a block: 0.69).
// - Loads in flight.  A consumer thread owns eight cells (one 8-byte
//   piece of l2) and issues tile i+6's x loads (i+4 in double) before it
//   adds tile i's values, in tile order.
// - Ghosts add +0.0 without a load, and a warp whose cells are all ghosts
//   in a tile skips it (exact in both sums: see SlabWalk).
// - Outputs go through a shared-memory transpose, 16 contiguous values a
//   row, where the first port wrote one value 512 bytes apart; dest
//   chunks run heaviest first.
// - Lost (PERF.md): the whole l1 tile by bulk copies multicast across
//   the lane groups, l1 rows by the producer warp's cp.async, L2 evict
//   hints, 2 blocks an SM by launch bounds, 4 or 16 cells a thread.

// Index types: l2 is uint8 for sub <= 256 and int16 above in the classic
// layout, uint8 always in the slab layout; l1 is int8 with values 0..127.
// The slab walk's l1 and l2 must be 16-byte aligned (TMA).
// Every tile offset is 64-bit: t*sub*128 passes 2^31 on multi-GB packs.
// The TPU's pair_mask and run_ids only scheduled its VMEM and DMA; unused
// here.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "heavy_first.cuh"
#include "tma.cuh"

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
// 127.  With kHalo the source is two buffers: chunks s_id < split are
// x's, the rest chunk s_id - split of halo (a shard's rows and its halo,
// each read in place).
template <bool kSkipGhost, bool kHalo = false, typename T, typename L2T>
__device__ __forceinline__ T tile_value(const T* __restrict__ x,
                                        const int8_t* __restrict__ l1,
                                        const L2T* __restrict__ l2,
                                        const int32_t* __restrict__ s_ids,
                                        int64_t t, int64_t cells, int c,
                                        int sub, int ld,
                                        const T* __restrict__ halo = nullptr,
                                        int split = 0) {
  const int ss = static_cast<int>(l2[t * cells + c]);
  const int lane = l1[(t * sub + ss) * kLane + ld];
  int64_t sid = s_ids[t];
  const T* src = x;
  if constexpr (kHalo) {
    if (sid >= split) {
      src = halo;
      sid -= split;
    }
  }
  const T* p = src + (sid * sub + ss) * kLane + lane;
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

// With kHalo, chunks s_id >= split of the source are halo's (tile_value).
template <typename T, typename L2T, bool kHalo = false>
__global__ void __launch_bounds__(kThreads)
cpg_level_kernel(const T* __restrict__ x, const int8_t* __restrict__ l1,
                 const L2T* __restrict__ l2, const int32_t* __restrict__ s_ids,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ counts,
                 const T* __restrict__ base, T* __restrict__ out,
                 int n_chunks, int sub, const T* __restrict__ halo = nullptr,
                 int split = 0) {
  const Cells k = block_cells(sub);
  const int d = tlt::heavy_first_chunk(counts, n_chunks);
  const int64_t cells = static_cast<int64_t>(sub) * kLane;
  const int64_t start = starts[d];
  const int count = counts[d];
  T acc = T(0);
#pragma unroll 8
  for (int i = 0; i < count; ++i) {
    acc += tile_value<false, kHalo>(x, l1, l2, s_ids, start + i, cells, k.c,
                                    sub, k.ld, halo, split);
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

// ---- The slab walk (cpg_slab_level_kernel, cpg_slab_level_comp_kernel)
//
// A block owns dest chunk d, a group of kSlabGroup = 16 dest lanes (16
// bytes, TMA's least box width for the int8 l1) and `rows` =
// slab_rows(sub) dest rows; each consumer thread owns kSlabCells cells,
// consecutive rows of one lane (one kSlabCells-byte piece of the block's
// l2 box).  One producer thread brings each tile's (128, 16) l1 box and
// (16, rows) l2 box into a ring of kSlabStages shared-memory stages by
// 2-D TMA boxes, each stage completing on an mbarrier; a stage is
// refilled once every consumer warp of the cluster has read it.  The row
// parts of a lane group form clusters of up to kSlabCluster CTAs, and
// each CTA brings its share of the l1 box's rows to all of them in one
// multicast.
constexpr int kSlabGroup = 16;    // dest lanes a block owns
constexpr int kSlabRows = 256;    // dest rows a block owns, at most
constexpr int kSlabCells = 8;     // cells a consumer thread owns
constexpr int kSlabConsumers = kSlabGroup * kSlabRows / kSlabCells;
constexpr int kSlabThreads = kSlabConsumers + 32;  // + one producer warp
constexpr int kSlabStages = 8;
constexpr int kSlabCluster = 2;
constexpr int kSlabL1Bytes = kLane * kSlabGroup;  // the (128, 16) l1 box
constexpr int kSlabStageBytes =
    kSlabL1Bytes + tlt::align128(kSlabGroup * kSlabRows);
// tiles of x loads in flight: 4 for double, whose values take twice the
// registers (6 spill to local memory)
template <typename T>
constexpr int kSlabAhead = sizeof(T) == 8 ? 4 : 6;
static_assert(tlt::kHeavyFirstMax <= kSlabThreads,
              "one thread ranks one chunk");
static_assert(kSlabStages * kSlabStageBytes >=
                  kSlabRows * (kSlabGroup + 1) * 8,
              "the output transpose reuses the ring");

// Rows a block owns at this sub (a multiple of 128): kSlabRows where they
// divide it, else 128.
__host__ __device__ constexpr int slab_rows(int sub) {
  return sub % kSlabRows == 0 ? kSlabRows : kLane;
}

// CTAs of a cluster: the largest power of two up to kSlabCluster that
// divides a lane group's row parts.
__host__ __device__ constexpr int slab_cluster(int row_parts) {
  return (row_parts & -row_parts) < kSlabCluster ? (row_parts & -row_parts)
                                                 : kSlabCluster;
}

// The block's cells: chunk d (heaviest first), lanes ld0.., rows rd0..
// rd0 + rows, its cluster size cs and its consumer thread count.
struct SlabBlock {
  int d, ld0, rd0, rows, cs, consumers;
};

__device__ __forceinline__ SlabBlock slab_block(
    const int32_t* __restrict__ counts, int n_chunks, int sub) {
  SlabBlock k;
  k.rows = slab_rows(sub);
  const int row_parts = sub / k.rows;
  k.d = tlt::heavy_first_chunk(counts, n_chunks);
  k.ld0 = static_cast<int>(blockIdx.x) / row_parts * kSlabGroup;
  k.rd0 = static_cast<int>(blockIdx.x) % row_parts * k.rows;
  k.cs = slab_cluster(row_parts);
  k.consumers = kSlabGroup * k.rows / kSlabCells;
  return k;
}

// The walk of one block: acc (and, kComp, err) of its consumer thread's
// cells, summed over dest chunk d's tiles in order from +0.0.
//
// Ghosts.  A ghost cell (bit 7 of L2) adds +0.0 without a load.  In the
// plain sum that is exact as it stands.  In the two-sum, g = +0.0 leaves
// (acc, err) unchanged: for finite acc, s = acc, z = +0.0 and err gains
// +0.0; and err is NaN from the step at which acc first turned inf or
// NaN on (z = s - acc is then inf or NaN, and s - z is NaN), so a ghost
// after it changes nothing either.  Neither sum is ever -0.0.  So a warp
// whose cells are all ghosts in a tile skips the tile's adds, and both
// walks stay bit-identical to the plain versions.
template <typename T, bool kComp>
struct SlabWalk {
  static constexpr int kAhead = kSlabAhead<T>;
  T acc[kSlabCells];
  T err[kSlabCells];

  __device__ __forceinline__ void run(const CUtensorMap* l1_map,
                                      const CUtensorMap* l2_map,
                                      const T* __restrict__ x,
                                      const int32_t* __restrict__ s_ids,
                                      int64_t start, int count,
                                      const SlabBlock& k, uint8_t* smem,
                                      uint64_t* full, uint64_t* empty) {
#pragma unroll
    for (int b = 0; b < kSlabCells; ++b) acc[b] = err[b] = T(0);
    const int tid = static_cast<int>(threadIdx.x);
    if (tid == kSlabConsumers) {  // the producer
      const int rank = static_cast<int>(tlt::cluster_rank());
      const int slice = kLane / k.cs;  // l1 box rows this CTA brings
      const uint16_t all = static_cast<uint16_t>((1u << k.cs) - 1);
      for (int i = 0; i < count; ++i) {
        const int s = i % kSlabStages;
        const int use = i / kSlabStages;
        // stage s is free in every CTA of the cluster
        if (use > 0) tlt::mbar_wait(&empty[s], (use - 1) & 1);
        uint8_t* buf = smem + s * kSlabStageBytes;
        const int row = static_cast<int>((start + i) * kLane);
        tlt::mbar_arrive_expect_tx(&full[s],
                                   kSlabL1Bytes + kSlabGroup * k.rows);
        if (k.cs > 1) {
          tlt::tma_load_2d_multicast(buf + rank * slice * kSlabGroup, l1_map,
                                     k.ld0, row + rank * slice, &full[s],
                                     all);
        } else {
          tlt::tma_load_2d(buf, l1_map, k.ld0, row, &full[s]);
        }
        tlt::tma_load_2d(buf + kSlabL1Bytes, l2_map, k.rd0, row + k.ld0,
                         &full[s]);
      }
      return;
    }
    if (tid >= k.consumers) return;
    const int lane = tid % 32;
    const int cl = tid / (k.rows / kSlabCells);  // the cells' lane
    // tile i's values for this thread's cells, +0.0 for a ghost and past
    // the chunk's tiles; true if any cell of the warp is real.  The tile's
    // stage is released in every CTA of the cluster once read.
    auto fetch = [&](int i, T (&v)[kSlabCells]) -> bool {
#pragma unroll
      for (int b = 0; b < kSlabCells; ++b) v[b] = T(0);
      if (i >= count) return false;
      const T* xs = x + static_cast<int64_t>(__ldg(s_ids + start + i)) *
                            (kLane * kLane);
      const int s = i % kSlabStages;
      tlt::mbar_wait(&full[s], (i / kSlabStages) & 1);
      const uint8_t* buf = smem + s * kSlabStageBytes;
      // this thread's 8 bytes of the (16, rows) l2 box
      const uint2 w = *reinterpret_cast<const uint2*>(buf + kSlabL1Bytes +
                                                      tid * kSlabCells);
      const uint32_t real = (~w.x | ~w.y) & 0x80808080u;
      const bool any = __any_sync(0xffffffffu, real != 0);
      if (any) {
#pragma unroll
        for (int b = 0; b < kSlabCells; ++b) {
          const int r = ((b < 4 ? w.x : w.y) >> (8 * (b % 4))) & 0xff;
          if (r < kLane) v[b] = xs[r * kLane + buf[r * kSlabGroup + cl]];
        }
      }
      __syncwarp();
      if (lane < k.cs) tlt::mbar_arrive_cluster(&empty[s], lane);
      return any;
    };

    // tile i+u's loads are issued kAhead tiles before its adds, which run
    // in tile order; a tile all of whose warp's cells are ghosts adds
    // nothing
    T v[kAhead][kSlabCells];
    uint32_t live = 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) live |= uint32_t{fetch(u, v[u])} << u;
    for (int i = 0; i < count; i += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
        if ((live >> u) & 1u) {
#pragma unroll
          for (int b = 0; b < kSlabCells; ++b) {
            const T g = v[u][b];
            if constexpr (kComp) {
              const T s = acc[b] + g;
              const T z = s - acc[b];
              err[b] += (acc[b] - (s - z)) + (g - z);
              acc[b] = s;
            } else {
              acc[b] += g;
            }
          }
        }
        live = (live & ~(1u << u)) |
               uint32_t{fetch(i + u + kAhead, v[u])} << u;
      }
    }
  }
};

// Barriers of the ring: full[s] takes the producer's arrival and the
// copies' bytes, empty[s] one arrival from every consumer warp of every
// CTA of the cluster.  Every thread must call it.
__device__ __forceinline__ void slab_ring_init(uint64_t* full,
                                               uint64_t* empty,
                                               const SlabBlock& k) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSlabStages; ++s) {
      tlt::mbar_init(&full[s], 1);
      tlt::mbar_init(&empty[s], k.consumers / 32 * k.cs);
    }
    tlt::mbar_fence_init();
  }
  __syncthreads();
  tlt::cluster_sync();  // the cluster's barriers are ready
}

// Writes each consumer thread's cells of v to out (plus base, if given)
// through a transpose tile in the ring's shared memory (read out by
// then): each of the block's rows is kSlabGroup contiguous values in
// out.  Every thread must call it.
template <typename T>
__device__ __forceinline__ void slab_store(const T (&v)[kSlabCells],
                                           uint8_t* smem, const SlabBlock& k,
                                           int sub,
                                           const T* __restrict__ base,
                                           T* __restrict__ out) {
  constexpr int kPitch = kSlabGroup + 1;
  T* tr = reinterpret_cast<T*>(smem);
  const int tid = static_cast<int>(threadIdx.x);
  __syncthreads();  // every thread is past its last read of the ring
  if (tid < k.consumers) {
    const int per_lane = k.rows / kSlabCells;
    const int cl = tid / per_lane;
    const int r0 = tid % per_lane * kSlabCells;
#pragma unroll
    for (int b = 0; b < kSlabCells; ++b) tr[(r0 + b) * kPitch + cl] = v[b];
  }
  __syncthreads();
  for (int e = tid; e < k.rows * kSlabGroup; e += kSlabThreads) {
    const int r = e / kSlabGroup;
    const int c = e % kSlabGroup;
    const int64_t o =
        (static_cast<int64_t>(k.d) * sub + k.rd0 + r) * kLane + k.ld0 + c;
    const T t = tr[r * kPitch + c];
    out[o] = base != nullptr ? base[o] + t : t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kSlabThreads)
cpg_slab_level_kernel(const __grid_constant__ CUtensorMap l1_map,
                      const __grid_constant__ CUtensorMap l2_map,
                      const T* __restrict__ x,
                      const int32_t* __restrict__ s_ids,
                      const int32_t* __restrict__ starts,
                      const int32_t* __restrict__ counts,
                      const T* __restrict__ base, T* __restrict__ out,
                      int n_chunks, int sub) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kSlabStages], empty[kSlabStages];
  const SlabBlock k = slab_block(counts, n_chunks, sub);
  slab_ring_init(full, empty, k);
  SlabWalk<T, false> w;
  w.run(&l1_map, &l2_map, x, s_ids, starts[k.d], counts[k.d], k, smem, full,
        empty);
  slab_store(w.acc, smem, k, sub, base, out);
  // no CTA leaves while a peer may still arrive on its barriers
  tlt::cluster_sync();
}

// The compensated slab level (float only, no base): the slab walk with
// the two-sum of cpg_level_comp_kernel in its order.
__global__ void __launch_bounds__(kSlabThreads)
cpg_slab_level_comp_kernel(const __grid_constant__ CUtensorMap l1_map,
                           const __grid_constant__ CUtensorMap l2_map,
                           const float* __restrict__ x,
                           const int32_t* __restrict__ s_ids,
                           const int32_t* __restrict__ starts,
                           const int32_t* __restrict__ counts,
                           float* __restrict__ out, float* __restrict__ err,
                           int n_chunks, int sub) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kSlabStages], empty[kSlabStages];
  const SlabBlock k = slab_block(counts, n_chunks, sub);
  slab_ring_init(full, empty, k);
  SlabWalk<float, true> w;
  w.run(&l1_map, &l2_map, x, s_ids, starts[k.d], counts[k.d], k, smem, full,
        empty);
  slab_store(w.acc, smem, k, sub, static_cast<const float*>(nullptr), out);
  slab_store(w.err, smem, k, sub, static_cast<const float*>(nullptr), err);
  tlt::cluster_sync();
}

// Rows of the l1 and l2 tensor maps.  The C interface carries no tile
// count, so the maps declare the most rows a TMA coordinate (int32) and
// stride can address; the kernel asks only for boxes of the level's real
// tiles (start + i < starts[d] + counts[d]), all inside the buffers.
uint64_t slab_map_rows(uint64_t row_bytes) {
  const uint64_t by_coord = (uint64_t{1} << 31) - kLane;
  const uint64_t by_bytes = (uint64_t{1} << 40) / row_bytes;
  return by_coord < by_bytes ? by_coord : by_bytes;
}

// Launches one slab level (kComp: the compensated one, out2 = err).
template <typename T, bool kComp>
int launch_slab(const void* x, const void* l1, const void* l2,
                const void* s_ids, const void* starts, const void* counts,
                const void* base, void* out, void* out2, int n_chunks,
                int sub, cudaStream_t stream) {
  if (!tlt::aligned16(l1) || !tlt::aligned16(l2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = slab_rows(sub);
  const int row_parts = sub / rows;
  const int cs = slab_cluster(row_parts);
  CUtensorMap l1_map, l2_map;
  // l1 (tiles*128, 128) int8 in (128/cs, 16) boxes; l2 (tiles*128, sub)
  // uint8 in (16, rows) boxes
  if (!tlt::encode_2d(&l1_map, l1, 1, kLane, slab_map_rows(kLane), kLane,
                      kSlabGroup, kLane / cs) ||
      !tlt::encode_2d(&l2_map, l2, 1, sub, slab_map_rows(sub), sub, rows,
                      kSlabGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kSlabStages * kSlabStageBytes;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kLane / kSlabGroup * row_parts),
                     static_cast<unsigned>(n_chunks));
  cfg.blockDim = dim3(kSlabThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(cs);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  static std::atomic<uint64_t> smem_raised{0};
  cudaError_t err;
  if constexpr (kComp) {
    err = tlt::once_per_device(smem_raised, [&] {
      return cudaFuncSetAttribute(cpg_slab_level_comp_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(
        &cfg, cpg_slab_level_comp_kernel, l1_map, l2_map,
        static_cast<const float*>(x), static_cast<const int32_t*>(s_ids),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(counts), static_cast<float*>(out),
        static_cast<float*>(out2), n_chunks, sub);
  } else {
    err = tlt::once_per_device(smem_raised, [&] {
      return cudaFuncSetAttribute(cpg_slab_level_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaLaunchKernelEx(
        &cfg, cpg_slab_level_kernel<T>, l1_map, l2_map,
        static_cast<const T*>(x), static_cast<const int32_t*>(s_ids),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(counts), static_cast<const T*>(base),
        static_cast<T*>(out), n_chunks, sub);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The classic layout: sub*128/256 blocks of 256 cells per dest chunk.
dim3 level_grid(int n_chunks, int sub) {
  return dim3(static_cast<unsigned>((sub * kLane) / kThreads),
              static_cast<unsigned>(n_chunks));
}

template <typename T, typename L2T>
void launch(const void* x, const void* l1, const void* l2, const void* s_ids,
            const void* starts, const void* counts, const void* base,
            void* out, int n_chunks, int sub, cudaStream_t stream,
            const void* halo = nullptr, int split = 0) {
  const auto args = [&](auto kernel) {
    kernel<<<level_grid(n_chunks, sub), kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const int8_t*>(l1),
        static_cast<const L2T*>(l2), static_cast<const int32_t*>(s_ids),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(counts), static_cast<const T*>(base),
        static_cast<T*>(out), n_chunks, sub, static_cast<const T*>(halo),
        split);
  };
  if (halo != nullptr) {
    args(cpg_level_kernel<T, L2T, true>);
  } else {
    args(cpg_level_kernel<T, L2T, false>);
  }
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
    return launch_slab<float, false>(x, l1, l2, s_ids, starts, counts, base,
                                     out, nullptr, n_chunks, sub, s);
  } else if (slab != 0 && value_bytes == 8 && l2_bytes == 1) {
    return launch_slab<double, false>(x, l1, l2, s_ids, starts, counts, base,
                                      out, nullptr, n_chunks, sub, s);
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

// Launches one classic CPG level on `stream` that reads its source from
// two buffers: chunks s_id < split of x, the rest chunk s_id - split of
// halo (a shard's own rows and its halo, each read in place, where the
// row-sharded path once copied them into one buffer).  Otherwise as
// tlt_spmv_cpg_level.
extern "C" int tlt_spmv_cpg_level_halo(const void* x, const void* halo,
                                       int split, const void* l1,
                                       const void* l2, const void* s_ids,
                                       const void* starts,
                                       const void* counts, const void* base,
                                       void* out, int n_chunks, int sub,
                                       int l2_bytes, int value_bytes,
                                       void* stream) {
  if (bad_shape(n_chunks, sub) || halo == nullptr || split < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4 && l2_bytes == 1) {
    launch<float, uint8_t>(x, l1, l2, s_ids, starts, counts, base, out,
                           n_chunks, sub, s, halo, split);
  } else if (value_bytes == 4 && l2_bytes == 2) {
    launch<float, int16_t>(x, l1, l2, s_ids, starts, counts, base, out,
                           n_chunks, sub, s, halo, split);
  } else if (value_bytes == 8 && l2_bytes == 1) {
    launch<double, uint8_t>(x, l1, l2, s_ids, starts, counts, base, out,
                            n_chunks, sub, s, halo, split);
  } else if (value_bytes == 8 && l2_bytes == 2) {
    launch<double, int16_t>(x, l1, l2, s_ids, starts, counts, base, out,
                            n_chunks, sub, s, halo, split);
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
    return launch_slab<float, true>(x, l1, l2, s_ids, starts, counts, nullptr,
                                    out, err, n_chunks, sub, s);
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
