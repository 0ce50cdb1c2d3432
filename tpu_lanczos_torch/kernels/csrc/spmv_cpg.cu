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
// The single-device df64 SpMV (tpu_lanczos/kernels/spmv_cpg.py::
// spmv_cpg_df, :419-483: kernels 1c and 1 a level, on hi and on lo, with
// XLA's two-sum folds between) runs a level of a slab pack as one launch
// of cpg_slab_level_df_kernel: the slab walk of both streams at once, the
// folds in the writing threads (df_level.cuh); a classic pack's level is
// spmv_cpg_shard.cu's cpg_level_df_kernel.  The compensated kernels stay
// the one-to-one counterparts of _run_level(compensated=True).
//
// Design of the classic walk, as measured on the H100 (PERF.md, PR 5).
// - What bounds it.  The index bytes are read once per SpMV (bn1M's sub
//   256 pack, the benchmark's: 32 dest chunks, a main level of 5,856 tiles
//   of 32 KB of l1 and 32 KB of l2, 108 to 436 a chunk, median 167, ~387
//   MB with the small levels, ~0.12 ms at 3.35 TB/s), but the time goes
//   to the gathers: per real entry (~10% of the tile cells) one byte of
//   l1 at a random row of the tile and four bytes of x at a random row of
//   the source chunk, each a 32-byte sector of the L2 cache, read by
//   latency-bound warps.
// - One thread per dest cell walks D's tiles in order with one register
//   accumulator (32-40 registers, 48-64 warps per SM), which is what
//   keeps the sum bit-identical and what hides the gather latency; the
//   tile loop is unrolled 8 deep so that several tiles' l2 -> l1 -> x
//   chains are in flight per thread.  Shared-memory rings of l1
//   columns did not pay at sub 512 (16 dest chunks): a CTA of 32 rows x
//   8 lanes owned ~1/8 of a chunk's cells, so a staged l1 sector served
//   about one real lookup, and thread copies, barriers and the shared
//   memory taken from the L1 cache cost more (0.57 to 1.3 ms against
//   0.42).  The staged walk below owns a lane group's rows whole.
// - Coalesced output.  A block is 32 dest sublanes x 8 dest lanes, one
//   lane per warp, so each warp's l2 read is one contiguous run; the
//   block writes its cells (and reads base) through a shared-memory
//   transpose, eight contiguous values per row, where a warp of the first
//   port wrote 32 values 512 bytes apart.
// - Heaviest chunks first.  Dest chunks hold very different tile counts.
//   With up to tlt::kHeavyFirstMax chunks, block row blockIdx.y walks the
//   chunk of that place in the tile-count order, most first, so the
//   longest walks start first and do not form the tail.
// - Ghost cells.  ~90% of bn1M's tile cells are ghosts: L2 points at a
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
// Design of the staged classic walk (below, at "The staged classic
// walk"), as measured on the H100 (PERF.md, section 6).
// - Where it runs.  spmv_cpg.py::staged_walk gives it a classic level of
//   one source buffer at sub 256 (uint8 l2; a tile's l1 rows one TMA box)
//   of at least 512 padded tiles whose real tiles T reach 12 H or
//   k*H + t0, H its heaviest chunk's (k, t0 = 4, 1000 in float; 10, 500
//   in double): bn1M's main level (5,856 and 436), Graph500's (SCALE 21:
//   ~9,300 and ~820), the stencil packs' one level.  Its time is about its
//   heaviest chunk's serial chain (0.62 us a tile in float, 0.85 in
//   double), the walk above's the level's x gathers spread over the card
//   (0.06-0.14 us a tile by the tiles' fill), so the walk above keeps
//   the rest: small levels (bn1M's broadcast and reduce levels, 15 and 39
//   tiles of one chunk; Graph500's reduce level, one chunk's 571-648
//   tiles: 0.32-0.35 ms staged against 0.14-0.16), levels with a heavier
//   chunk or fewer tiles (BA-100k to -600k, Graph500 SCALE 18-19: +15% to
//   +78% staged in float), sub 128 (BA 100k-600k: +9% to +105%; only
//   the balanced copapers_540k pack was faster, 0.192 against 0.260 ms),
//   the halo launch and int16 l2.
// - Why it wins where those rings lost.  A block owns 32 dest lanes and
//   128 rows; at sub 256 the two row halves form a cluster, and each
//   brings half of the (256, 32) l1 box to both by multicast.  So a
//   staged l1 box serves every real lookup of its lanes' 256 rows (~850
//   a tile, ~3 a 32-byte sector), the boxes come by TMA with no copy
//   instructions, and one ring of 8 stages (96 KB) leaves the rest of
//   the SM's 256 KB to the L1 cache that the x gathers hit.  Only x is
//   gathered; a ghost is skipped as in the compensated walk above.
// - What bounds it: the index stream.  With consumers that only wait and
//   release, bn1M's main level takes 0.23-0.24 ms of its ~0.28.  Boxes of
//   16 lanes (TMA's least) streamed slower (0.26 ms; the walk 0.32 with
//   rows = sub, 0.37 in a cluster of 2), 64 lanes in clusters of 4
//   faster (0.16) but the walk slower (0.33-0.35: four CTAs in step).
// - Lost: 12 stages (0.37: shared memory taken from the L1 cache), 2
//   blocks an SM (0.49), an L2 prefetch of the boxes 8-32 tiles ahead
//   (0.36-0.37), a ghost test by a sublane found twice among a thread's
//   eight L2 bytes (+25%: one more dependent shared load a tile).

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
// - The df walk (cpg_slab_level_df_kernel) gathers x_hi and x_lo at each
//   real cell's place, 3 tiles ahead (kSlabAhead): one index stream for
//   both, and twice the values a tile in flight.

// Index types: l2 is uint8 for sub <= 256 and int16 above in the classic
// layout, uint8 always in the slab layout; l1 is int8 with values 0..127.
// The slab walk's l1 and l2 must be 16-byte aligned (TMA).
// Every tile offset is 64-bit: t*sub*128 passes 2^31 on multi-GB packs.
// The TPU's pair_mask and run_ids only scheduled its VMEM and DMA; unused
// here.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "df_level.cuh"
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
// registers (6 spill to local memory); 3 for the df walk's two streams
// (at 4 it spilled 280 bytes a thread, and its main level took 0.92 ms
// against 0.71 at 3 and 0.72 at 2: PERF.md, section 6)
template <typename T, bool kDf = false>
constexpr int kSlabAhead = sizeof(T) == 8 ? 4 : kDf ? 3 : 6;
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
// cells, summed over dest chunk d's tiles in order from +0.0; with kDf
// (and kComp) also lo, the plain sum of the lo stream x_lo, gathered at
// the same places as x.
//
// Ghosts.  A ghost cell (bit 7 of L2) adds +0.0 without a load.  In the
// plain sum that is exact as it stands.  In the two-sum, g = +0.0 leaves
// (acc, err) unchanged: for finite acc, s = acc, z = +0.0 and err gains
// +0.0; and err is NaN from the step at which acc first turned inf or
// NaN on (z = s - acc is then inf or NaN, and s - z is NaN), so a ghost
// after it changes nothing either.  Neither sum is ever -0.0.  So a warp
// whose cells are all ghosts in a tile skips the tile's adds, and both
// walks stay bit-identical to the plain versions.
template <typename T, bool kComp, bool kDf = false>
struct SlabWalk {
  static_assert(kComp || !kDf, "the df walk two-sums the hi stream");
  static constexpr int kAhead = kSlabAhead<T, kDf>;
  static constexpr int kLoCells = kDf ? kSlabCells : 1;
  T acc[kSlabCells];
  T err[kSlabCells];
  T lo[kLoCells];

  __device__ __forceinline__ void run(const CUtensorMap* l1_map,
                                      const CUtensorMap* l2_map,
                                      const T* __restrict__ x,
                                      const T* __restrict__ x_lo,
                                      const int32_t* __restrict__ s_ids,
                                      int64_t start, int count,
                                      const SlabBlock& k, uint8_t* smem,
                                      uint64_t* full, uint64_t* empty) {
#pragma unroll
    for (int b = 0; b < kSlabCells; ++b) acc[b] = err[b] = T(0);
#pragma unroll
    for (int b = 0; b < kLoCells; ++b) lo[b] = T(0);
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
    // tile i's values for this thread's cells (v; vl of the lo stream),
    // +0.0 for a ghost and past the chunk's tiles; true if any cell of the
    // warp is real.  The tile's stage is released in every CTA of the
    // cluster once read.
    auto fetch = [&](int i, T (&v)[kSlabCells], T (&vl)[kLoCells]) -> bool {
#pragma unroll
      for (int b = 0; b < kSlabCells; ++b) v[b] = T(0);
#pragma unroll
      for (int b = 0; b < kLoCells; ++b) vl[b] = T(0);
      if (i >= count) return false;
      const int64_t slab =
          static_cast<int64_t>(__ldg(s_ids + start + i)) * (kLane * kLane);
      const T* xs = x + slab;
      const int s = i % kSlabStages;
      tlt::mbar_wait(&full[s], (i / kSlabStages) & 1);
      const uint8_t* buf = smem + s * kSlabStageBytes;
      // this thread's 8 bytes of the (16, rows) l2 box
      const uint2 l2w = *reinterpret_cast<const uint2*>(
          buf + kSlabL1Bytes + tid * kSlabCells);
      const uint32_t real = (~l2w.x | ~l2w.y) & 0x80808080u;
      const bool any = __any_sync(0xffffffffu, real != 0);
      if (any) {
#pragma unroll
        for (int b = 0; b < kSlabCells; ++b) {
          const int r = ((b < 4 ? l2w.x : l2w.y) >> (8 * (b % 4))) & 0xff;
          if (r < kLane) {
            const int at = r * kLane + buf[r * kSlabGroup + cl];
            v[b] = xs[at];
            if constexpr (kDf) vl[b] = x_lo[slab + at];
          }
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
    T v_lo[kAhead][kLoCells];
    uint32_t live = 0;
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      live |= uint32_t{fetch(u, v[u], v_lo[u])} << u;
    }
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
            if constexpr (kDf) lo[b] += v_lo[u][b];
          }
        }
        live = (live & ~(1u << u)) |
               uint32_t{fetch(i + u + kAhead, v[u], v_lo[u])} << u;
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
  w.run(&l1_map, &l2_map, x, static_cast<const T*>(nullptr), s_ids,
        starts[k.d], counts[k.d], k, smem, full, empty);
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
  w.run(&l1_map, &l2_map, x, static_cast<const float*>(nullptr), s_ids,
        starts[k.d], counts[k.d], k, smem, full, empty);
  slab_store(w.acc, smem, k, sub, static_cast<const float*>(nullptr), out);
  slab_store(w.err, smem, k, sub, static_cast<const float*>(nullptr), err);
  tlt::cluster_sync();
}

// The df level's shared memory: the ring, or the three transpose tiles of
// its output (acc, err, lo), whichever is larger.
constexpr int kSlabDfTile = kSlabRows * (kSlabGroup + 1);
constexpr int kSlabDfSmemBytes =
    kSlabStages * kSlabStageBytes > 3 * kSlabDfTile * 4
        ? kSlabStages * kSlabStageBytes
        : 3 * kSlabDfTile * 4;

// The single-device df64 slab level (float only): one slab walk of both
// streams, x_hi two-summed as by cpg_slab_level_comp_kernel and x_lo
// summed as by cpg_slab_level_kernel, gathered at the same places, and
// the level's folds in the writing threads (tlt::df_level_cell, in
// `mode`, finished where `finish`).  The outputs are other buffers than
// the source.
__global__ void __launch_bounds__(kSlabThreads)
cpg_slab_level_df_kernel(const __grid_constant__ CUtensorMap l1_map,
                         const __grid_constant__ CUtensorMap l2_map,
                         const float* __restrict__ x_hi,
                         const float* __restrict__ x_lo,
                         const int32_t* __restrict__ s_ids,
                         const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ counts,
                         const float* __restrict__ mask,
                         float* __restrict__ out_a, float* __restrict__ out_b,
                         int n_chunks, int sub, int mode, int finish) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kSlabStages], empty[kSlabStages];
  const SlabBlock k = slab_block(counts, n_chunks, sub);
  slab_ring_init(full, empty, k);
  SlabWalk<float, true, true> w;
  w.run(&l1_map, &l2_map, x_hi, x_lo, s_ids, starts[k.d], counts[k.d], k,
        smem, full, empty);
  // the three sums through transpose tiles in the ring's shared memory
  // (read out by then), as slab_store does one
  constexpr int kPitch = kSlabGroup + 1;
  float* tr = reinterpret_cast<float*>(smem);
  const int tid = static_cast<int>(threadIdx.x);
  __syncthreads();  // every thread is past its last read of the ring
  if (tid < k.consumers) {
    const int per_lane = k.rows / kSlabCells;
    const int cl = tid / per_lane;
    const int r0 = tid % per_lane * kSlabCells;
#pragma unroll
    for (int b = 0; b < kSlabCells; ++b) {
      const int at = (r0 + b) * kPitch + cl;
      tr[at] = w.acc[b];
      tr[kSlabDfTile + at] = w.err[b];
      tr[2 * kSlabDfTile + at] = w.lo[b];
    }
  }
  __syncthreads();
  for (int e = tid; e < k.rows * kSlabGroup; e += kSlabThreads) {
    const int at = e / kSlabGroup * kPitch + e % kSlabGroup;
    const int64_t o =
        (static_cast<int64_t>(k.d) * sub + k.rd0 + e / kSlabGroup) * kLane +
        k.ld0 + e % kSlabGroup;
    tlt::df_level_cell(mode, finish != 0, tr[at], tr[kSlabDfTile + at],
                       tr[2 * kSlabDfTile + at], x_hi, x_lo, mask, o, out_a,
                       out_b);
  }
  // no CTA leaves while a peer may still arrive on its barriers
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

// A slab level's launch: the l1 and l2 tensor maps, and the grid, block,
// shared memory and cluster of a launch on `stream`.
struct SlabLaunch {
  CUtensorMap l1_map, l2_map;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;

  // False where the index buffers cannot be read by TMA.
  bool init(const void* l1, const void* l2, int n_chunks, int sub, int smem,
            cudaStream_t stream) {
    if (!tlt::aligned16(l1) || !tlt::aligned16(l2)) return false;
    const int rows = slab_rows(sub);
    const int row_parts = sub / rows;
    const int cs = slab_cluster(row_parts);
    // l1 (tiles*128, 128) int8 in (128/cs, 16) boxes; l2 (tiles*128, sub)
    // uint8 in (16, rows) boxes
    if (!tlt::encode_2d(&l1_map, l1, 1, kLane, slab_map_rows(kLane), kLane,
                        kSlabGroup, kLane / cs) ||
        !tlt::encode_2d(&l2_map, l2, 1, sub, slab_map_rows(sub), sub, rows,
                        kSlabGroup)) {
      return false;
    }
    cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(kLane / kSlabGroup * row_parts),
                       static_cast<unsigned>(n_chunks));
    cfg.blockDim = dim3(kSlabThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = static_cast<unsigned>(cs);
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
    return true;
  }
};

// Launches one slab level (kComp: the compensated one, out2 = err).
template <typename T, bool kComp>
int launch_slab(const void* x, const void* l1, const void* l2,
                const void* s_ids, const void* starts, const void* counts,
                const void* base, void* out, void* out2, int n_chunks,
                int sub, cudaStream_t stream) {
  const int smem = kSlabStages * kSlabStageBytes;
  SlabLaunch sl;
  if (!sl.init(l1, l2, n_chunks, sub, smem, stream)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaLaunchConfig_t& cfg = sl.cfg;
  const CUtensorMap& l1_map = sl.l1_map;
  const CUtensorMap& l2_map = sl.l2_map;
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

// ---- The staged classic walk (cpg_staged_level_kernel)
//
// A block owns dest chunk d (heaviest first), a group of kStagedGroup
// dest lanes and kRows = min(sub, kStagedRows) dest rows; the sub / kRows
// row parts of a lane group form a cluster.  One producer thread brings
// each tile's (sub, group) l1 box (its source sublanes' bytes of the
// group's lanes) and (group, kRows) l2 box into a ring of kStagedStages
// stages by 2-D TMA boxes, each CTA of the cluster bringing its share of
// the l1 box's rows to all of them by multicast.  Each consumer thread
// owns kStagedCells consecutive rows of one lane (one 8-byte piece of the
// l2 box), reads L2 and then L1 from shared memory, and gathers x only
// where L1 is not lane 127.  A warp walks 64 rows of 4 lanes a quarter of
// the group apart, the four lanes' row blocks rotated, so its l2 pieces
// take the least wavefronts.
constexpr int kStagedGroup = 32;
constexpr int kStagedRows = 128;
constexpr int kStagedCells = 8;
constexpr int kStagedStages = 8;
constexpr int kStagedSub = 256;  // one TMA box of l1 rows; uint8 l2
// tiles of x loads in flight: 2 for double (76 registers; at 3 and 4 its
// main level took 0.39-0.41 ms against 0.38 at 2), 6 for float
template <typename T>
constexpr int kStagedAhead = sizeof(T) == 8 ? 2 : 6;

template <int kSub>
struct Staged {
  static constexpr int kRows = kSub < kStagedRows ? kSub : kStagedRows;
  static constexpr int kCluster = kSub / kRows;
  static constexpr int kConsumers = kStagedGroup * kRows / kStagedCells;
  static constexpr int kThreads = kConsumers + 32;  // + one producer warp
  static constexpr int kL1Bytes = kSub * kStagedGroup;
  static constexpr int kL2Bytes = kStagedGroup * kRows;
  static constexpr int kStageBytes =
      tlt::align128(kL1Bytes) + tlt::align128(kL2Bytes);
  // the ring, and the output's transpose tile after it is read out
  static constexpr int kRingBytes = kStagedStages * kStageBytes;
  static constexpr int kTileBytes = kRows * (kStagedGroup + 1) * 8;
  static constexpr int kSmemBytes =
      kRingBytes > kTileBytes ? kRingBytes : kTileBytes;
  static_assert(kSub % kLane == 0 && kSub <= kStagedSub, "uint8 l2");
  static_assert(kRows % 64 == 0 && kStagedGroup % 4 == 0,
                "a warp walks 64 rows of 4 lanes");
  static_assert(kCluster <= 8, "a portable cluster");
  static_assert(tlt::kHeavyFirstMax <= kThreads,
                "one thread ranks one chunk");
};

// The consumer thread's lane cl (in the group) and first row r0 (in the
// block's rows).
template <int kRows>
__device__ __forceinline__ void staged_cells(int tid, int& cl, int& r0) {
  constexpr int kQuads = kStagedGroup / 4;
  constexpr int kRowBlocks = kRows / 64;
  const int w = tid / 32;
  const int k = tid % 32 / 8;
  cl = w % kQuads + kQuads * k;
  r0 = (w / kQuads + k) % kRowBlocks * 64 + tid % 8 * kStagedCells;
}

// Ghosts.  A ghost cell's L1 is lane 127, x's structural zero: it adds
// +0.0 without a load.  That is bit-identical to the plain version, which
// adds x's lane-127 value: every level's source holds +-0.0 there
// (tests/test_torch_spmv.py pins it), acc starts at +0.0, and in
// round-to-nearest a sum is -0.0 only if both addends are, so acc is never
// -0.0 and adding +0.0 or -0.0 to it leaves it unchanged (inf and NaN
// too).  The adds past the chunk's tiles add +0.0 as well.
template <typename T, int kSub>
__global__ void __launch_bounds__(Staged<kSub>::kThreads)
cpg_staged_level_kernel(const __grid_constant__ CUtensorMap l1_map,
                        const __grid_constant__ CUtensorMap l2_map,
                        const T* __restrict__ x,
                        const int32_t* __restrict__ s_ids,
                        const int32_t* __restrict__ starts,
                        const int32_t* __restrict__ counts,
                        const T* __restrict__ base, T* __restrict__ out,
                        int n_chunks) {
  using S = Staged<kSub>;
  constexpr int kRows = S::kRows;
  constexpr int kCs = S::kCluster;
  constexpr int kAhead = kStagedAhead<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kStagedStages], empty[kStagedStages];
  const int tid = static_cast<int>(threadIdx.x);
  const int d = tlt::heavy_first_chunk(counts, n_chunks);
  const int ld0 = static_cast<int>(blockIdx.x) / kCs * kStagedGroup;
  const int rd0 = static_cast<int>(blockIdx.x) % kCs * kRows;
  if (tid == 0) {
    for (int s = 0; s < kStagedStages; ++s) {
      tlt::mbar_init(&full[s], 1);
      tlt::mbar_init(&empty[s], S::kConsumers / 32 * kCs);
    }
    tlt::mbar_fence_init();
  }
  __syncthreads();
  tlt::cluster_sync();  // the cluster's barriers are ready

  const int64_t start = starts[d];
  const int count = counts[d];
  T acc[kStagedCells];
#pragma unroll
  for (int b = 0; b < kStagedCells; ++b) acc[b] = T(0);
  int cl = 0, r0 = 0;
  if (tid == S::kConsumers) {  // the producer
    const uint32_t rank = tlt::cluster_rank();
    constexpr int kSlice = kSub / kCs;  // l1 rows it brings
    constexpr uint16_t kAll = (1u << kCs) - 1;
    for (int i = 0; i < count; ++i) {
      const int s = i % kStagedStages;
      const int use = i / kStagedStages;
      // stage s is free in every CTA of the cluster
      if (use > 0) tlt::mbar_wait(&empty[s], (use - 1) & 1);
      uint8_t* buf = smem + s * S::kStageBytes;
      tlt::mbar_arrive_expect_tx(&full[s], S::kL1Bytes + S::kL2Bytes);
      const int l1_row = static_cast<int>((start + i) * kSub) +
                         static_cast<int>(rank) * kSlice;
      if constexpr (kCs > 1) {
        tlt::tma_load_2d_multicast(buf + rank * kSlice * kStagedGroup,
                                   &l1_map, ld0, l1_row, &full[s], kAll);
      } else {
        tlt::tma_load_2d(buf, &l1_map, ld0, l1_row, &full[s]);
      }
      tlt::tma_load_2d(buf + tlt::align128(S::kL1Bytes), &l2_map, rd0,
                       static_cast<int>((start + i) * kLane) + ld0, &full[s]);
    }
  } else if (tid < S::kConsumers) {
    staged_cells<kRows>(tid, cl, r0);
    const int lane_id = tid % 32;
    // tile i's values of this thread's cells, +0.0 for a ghost and past
    // the chunk's tiles; the tile's stage is released in every CTA of the
    // cluster once read
    auto fetch = [&](int i, T (&v)[kStagedCells]) {
#pragma unroll
      for (int b = 0; b < kStagedCells; ++b) v[b] = T(0);
      if (i >= count) return;
      const T* xs =
          x + static_cast<int64_t>(__ldg(s_ids + start + i)) * kSub * kLane;
      const int s = i % kStagedStages;
      tlt::mbar_wait(&full[s], (i / kStagedStages) & 1);
      const uint8_t* buf = smem + s * S::kStageBytes;
      const uint2 l2w = *reinterpret_cast<const uint2*>(
          buf + tlt::align128(S::kL1Bytes) + cl * kRows + r0);
#pragma unroll
      for (int b = 0; b < kStagedCells; ++b) {
        const int r = ((b < 4 ? l2w.x : l2w.y) >> (8 * (b % 4))) & 0xff;
        const int lane = buf[r * kStagedGroup + cl];
        if (lane != kGhost) v[b] = xs[r * kLane + lane];
      }
      __syncwarp();
      if (lane_id < kCs) {
        tlt::mbar_arrive_cluster(&empty[s], static_cast<uint32_t>(lane_id));
      }
    };
    // tile i+u's loads are issued kAhead tiles before its adds, which run
    // in tile order
    T v[kAhead][kStagedCells];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) fetch(u, v[u]);
    for (int i = 0; i < count; i += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
#pragma unroll
        for (int b = 0; b < kStagedCells; ++b) acc[b] += v[u][b];
        fetch(i + u + kAhead, v[u]);
      }
    }
  }

  // the cells (plus base) through a transpose tile in the ring's shared
  // memory, read out by then: each of the block's rows is kStagedGroup
  // contiguous values of out
  constexpr int kPitch = kStagedGroup + 1;
  T* tr = reinterpret_cast<T*>(smem);
  __syncthreads();  // every thread is past its last read of the ring
  if (tid < S::kConsumers) {
#pragma unroll
    for (int b = 0; b < kStagedCells; ++b) tr[(r0 + b) * kPitch + cl] = acc[b];
  }
  __syncthreads();
  for (int e = tid; e < kRows * kStagedGroup; e += S::kThreads) {
    const int r = e / kStagedGroup;
    const int c = e % kStagedGroup;
    const int64_t o =
        (static_cast<int64_t>(d) * kSub + rd0 + r) * kLane + ld0 + c;
    const T t = tr[r * kPitch + c];
    out[o] = base != nullptr ? base[o] + t : t;
  }
  // no CTA leaves while a peer may still multicast into it or arrive on
  // its barriers
  tlt::cluster_sync();
}

// Launches one staged classic level at sub = kSub.
template <typename T, int kSub>
int launch_staged(const void* x, const void* l1, const void* l2,
                  const void* s_ids, const void* starts, const void* counts,
                  const void* base, void* out, int n_chunks,
                  cudaStream_t stream) {
  using S = Staged<kSub>;
  if (!tlt::aligned16(l1) || !tlt::aligned16(l2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap l1_map, l2_map;
  // l1 (tiles*sub, 128) int8 in (sub/cluster, group) boxes; l2 (tiles*128,
  // sub) uint8 in (group, rows) boxes
  if (!tlt::encode_2d(&l1_map, l1, 1, kLane, slab_map_rows(kLane), kLane,
                      kStagedGroup, kSub / S::kCluster) ||
      !tlt::encode_2d(&l2_map, l2, 1, kSub, slab_map_rows(kSub), kSub,
                      S::kRows, kStagedGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<uint64_t> smem_raised{0};
  cudaError_t err = tlt::once_per_device(smem_raised, [] {
    return cudaFuncSetAttribute(cpg_staged_level_kernel<T, kSub>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                S::kSmemBytes);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim =
      dim3(static_cast<unsigned>(kLane / kStagedGroup * S::kCluster),
           static_cast<unsigned>(n_chunks));
  cfg.blockDim = dim3(S::kThreads);
  cfg.dynamicSmemBytes = S::kSmemBytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S::kCluster;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, cpg_staged_level_kernel<T, kSub>, l1_map, l2_map,
      static_cast<const T*>(x), static_cast<const int32_t*>(s_ids),
      static_cast<const int32_t*>(starts), static_cast<const int32_t*>(counts),
      static_cast<const T*>(base), static_cast<T*>(out), n_chunks);
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

// Launches one classic CPG level by the staged walk on `stream`: sub 256
// (uint8 l2), l1 and l2 16-byte aligned, one source buffer whose
// lane-127 slots hold +-0.0; `base` may be null.  value_bytes is 4 (float)
// or 8 (double).  Returns cudaGetLastError() after the launch (0 =
// launched), cudaErrorInvalidValue for a level the walk does not take.
extern "C" int tlt_spmv_cpg_level_staged(const void* x, const void* l1,
                                         const void* l2, const void* s_ids,
                                         const void* starts,
                                         const void* counts,
                                         const void* base, void* out,
                                         int n_chunks, int sub,
                                         int value_bytes, void* stream) {
  if (bad_shape(n_chunks, sub)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sub == kStagedSub && value_bytes == 4) {
    return launch_staged<float, kStagedSub>(x, l1, l2, s_ids, starts, counts,
                                            base, out, n_chunks, s);
  } else if (sub == kStagedSub && value_bytes == 8) {
    return launch_staged<double, kStagedSub>(x, l1, l2, s_ids, starts,
                                             counts, base, out, n_chunks, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
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

// Launches one single-device df64 level in the slab layout on `stream`:
// arguments as spmv_cpg_shard.cu's tlt_spmv_cpg_level_df (l2_bytes must
// be 1, l1 and l2 16-byte aligned).  Returns the CUDA error (0 =
// launched).
extern "C" int tlt_spmv_cpg_slab_level_df(
    const void* x_hi, const void* x_lo, const void* l1, const void* l2,
    const void* s_ids, const void* starts, const void* counts,
    const void* mask, void* out_a, void* out_b, int n_chunks, int sub,
    int l2_bytes, int mode, int finish, void* stream) {
  if (bad_shape(n_chunks, sub) || l2_bytes != 1 || mode < tlt::kDfBcast ||
      mode > tlt::kDfReduce || (mode == tlt::kDfBcast && finish != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SlabLaunch sl;
  if (!sl.init(l1, l2, n_chunks, sub, kSlabDfSmemBytes,
               static_cast<cudaStream_t>(stream))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static std::atomic<uint64_t> smem_raised{0};
  cudaError_t err = tlt::once_per_device(smem_raised, [] {
    return cudaFuncSetAttribute(cpg_slab_level_df_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kSlabDfSmemBytes);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(
      &sl.cfg, cpg_slab_level_df_kernel, sl.l1_map, sl.l2_map,
      static_cast<const float*>(x_hi), static_cast<const float*>(x_lo),
      static_cast<const int32_t*>(s_ids), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<const float*>(mask),
      static_cast<float*>(out_a), static_cast<float*>(out_b), n_chunks, sub,
      mode, finish);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
