// One df64 level of the CPG SpMV on Hopper (sm_90a), bound through
// ctypes: a shard's (cpg_shard_level_df_kernel) and a single device's in
// the classic layout (cpg_level_df_kernel).
//
// cpg_shard_level_df_kernel replaces kernels 1 and 1c of spmv_cpg.cu as
// the row-sharded df64 SpMV ran them, one launch a pass and a stream with
// eager folds between: tpu_lanczos/dist/lanczos_df.py::_local_spmv_df
// (:64; every level compensated on hi, plain on lo, folded by two-sums
// :121-166), each level there a call of the Pallas kernel tpu_lanczos/
// kernels/spmv_cpg.py::_run_level (pallas_call :342).  The f32/f64
// sharded SpMV runs kernel 1 itself, a launch a pass (spmv_cpg.cu).
//
// cpg_level_df_kernel replaces them likewise on one device: tpu_lanczos/
// kernels/spmv_cpg.py::spmv_cpg_df (:419-483), two Pallas calls a level
// (_run_level :320, compensated=True on hi) and XLA's folds between.  A
// level is one walk over all n_chunks dest chunks of the pack, with the
// level's folds (df_level.cuh): the broadcast levels' plain adds, the main
// level's e = err + lo, the reduce levels' two-sums onto their source, and
// the last level's finish.  The slab layout's df level is spmv_cpg.cu's
// cpg_slab_level_df_kernel.
//
// A walk is one pass's tiles on the shard (a level dict of the sharded
// pack: l1, l2, s_ids, starts, counts over the shard's c_loc dest chunks)
// and its source: chunk s_id of x[0] for s_id < split, chunk s_id - split
// of x[1] above (a shard's own rows followed by its halo, read in place).
// For a dest cell (ld, rd) of dest chunk D a walk yields, from +0.0 in tile
// order, kernel 1c's compensated sum (spmv_cpg.cu, cpg_level_comp_kernel)
// of the hi stream with its error stream, and kernel 1's plain sum of the
// lo stream, of
//
//   x[s_ids[t]*sub + L2, L1[L2, ld]],   L2 = l2_t[ld, rd],
//   t in [starts[D], starts[D] + counts[D]).
//
// cpg_shard_level_df_kernel folds a level's walks: without a base (the
// main level) y = acc_0, e = err_0 + lo_0; then, for every further walk,
// and for the one walk of a reduce level onto its (y, e) base,
//   y, t = two_sum(y, acc);  e = ((e + t) + err) + lo
// (the reference's order, lanczos_df.py:124-131, :163-164); it writes
// (y, e) where a later level's exchange reads them and, on the shard's
// last level, hi, lo = two_sum(y, e) times the realmask where given.
//
// Design, as measured on the H100 (PERF.md, section 6).
// - One walk per tile for both streams: each tile's l2 and l1 are read
//   once, x_hi and x_lo gathered at the same place; the folds of the
//   levels and the finish run in the writing threads, so no elementwise
//   op is left between launches (the per-pass composition read the index
//   bytes twice and ran ~150 eager ops a 4-shard df SpMV, the single
//   device's ~15 a df SpMV).
// - The main level's own and cross passes in one launch: a block owns 256
//   dest cells of one (walk, chunk) pair, one thread a cell, as kernel 1;
//   the pairs run heaviest first.  Of the two blocks of a cell range the
//   later to finish adds the earlier one's partials, in the reference's
//   order: each writes its partials, fences, and counts itself on the
//   range's flag (zeroed on the launch's stream before it, in the call's
//   own buffer, so launches on other streams never share one); the
//   second reads the first's.  No block waits on another.
// - One device: the grid of kernel 1, a block a 256-cell range of a dest
//   chunk, heaviest chunks first (blockIdx.y's place past 64 chunks, as
//   heavy_first_chunk orders them), one launch a level.  A reduce level
//   reads its (y, e) as the walk's source and as the fold's base and
//   writes fresh buffers: a block writing in place would race the blocks
//   still gathering from them.
// - Ghost cells (~86% of bench.py's tile cells) add +0.0 without a load,
//   as kernel 1c (exact: spmv_cpg.cu, "Ghost cells"); in the plain sums
//   too, whose accumulators start at +0.0 and so are never -0.0.
// - No flag that contracts or reassociates adds may build this file: the
//   two-sums hold only as written (the folds use the _rn intrinsics).

#include <cstdint>
#include <cuda_runtime.h>

#include "df_level.cuh"
#include "heavy_first.cuh"

namespace tlt {

constexpr int kShardWalks = 2;

// One walk (mirrored by kernels/spmv_cpg.py::_Walk).
struct Walk {
  const void* x[2];   // the source: chunks [0, split) of x[0], then x[1]
  const void* lo[2];  // the lo stream's, at the same places
  const int8_t* l1;
  const void* l2;     // uint8 (sub <= 256) or int16
  const int32_t* s_ids;
  const int32_t* starts;
  const int32_t* counts;
  int split;
  int pad;
};

// One launch (mirrored by kernels/spmv_cpg.py::_ShardArgs).
struct ShardArgs {
  Walk walk[kShardWalks];
  const float* base_y;  // df64: the (y, e) base of a reduce level, or null
  const float* base_e;
  float* out_y;         // the (y, e) a later level reads, or null
  float* out_e;
  float* out_hi;        // the finished pair, or null
  float* out_lo;
  const float* mask;    // the realmask the pair is multiplied by, or null
  float* part;          // two walks: each walk's partial sums (acc, err, lo)
  unsigned* flags;      // two walks: a flag a block of a walk
  int n_walks;          // 1 or 2
  int n_chunks;
  int sub;
  int pad;
};

}  // namespace tlt

namespace {

using tlt::ShardArgs;
using tlt::Walk;

constexpr int kLane = 128;
constexpr int kGhost = kLane - 1;  // lane 127: the structural zero of x
constexpr int kCells = 256;        // dest cells of a block, a thread each
constexpr int kRows = 32;          // ... dest sublanes, a warp's lanes
constexpr int kCols = kCells / kRows;  // ... and dest lanes, one a warp
constexpr int kMaxWalks = tlt::kShardWalks;
static_assert(tlt::kHeavyFirstMax <= kCells, "one thread ranks one chunk");

// This thread's dest cell of the block: lanes ld0 .. ld0 + kCols (one a
// warp), sublanes rd0 .. rd0 + kRows, and its l2 column c = ld*sub + rd.
struct Cell {
  int ld0, rd0, ld, c;
};

__device__ __forceinline__ Cell cell_of(int sub) {
  const int tid = static_cast<int>(threadIdx.x);
  const int row_blocks = sub / kRows;
  Cell k;
  k.ld0 = static_cast<int>(blockIdx.x) / row_blocks * kCols;
  k.rd0 = static_cast<int>(blockIdx.x) % row_blocks * kRows;
  k.ld = k.ld0 + tid / kRows;
  k.c = k.ld * sub + k.rd0 + tid % kRows;
  return k;
}

// The df64 sums of a walk: kernel 1c's compensated sum on hi (acc, err),
// ghost cells adding +0.0 without a load as there, and kernel 1's plain
// sum on lo, read at the same place.
struct DfSum {
  struct V {
    float hi, lo;
  };
  float acc = 0.0f, err = 0.0f, lo = 0.0f;
  __device__ __forceinline__ static V load(const float* hi, const float* lo,
                                           int lane) {
    if (lane == kGhost) return V{0.0f, 0.0f};
    return V{__ldg(hi), __ldg(lo)};
  }
  // s = acc + g; z = s - acc; err += (acc - (s - z)) + (g - z); acc = s
  __device__ __forceinline__ void add(V g) {
    const float s = __fadd_rn(acc, g.hi);
    const float z = __fsub_rn(s, acc);
    err = __fadd_rn(err, __fadd_rn(__fsub_rn(acc, __fsub_rn(s, z)),
                                   __fsub_rn(g.hi, z)));
    acc = s;
    lo = __fadd_rn(lo, g.lo);
  }
};

// A walk's inputs, as registers.  With kTwoSrc a source chunk sid lies at
// sid*cells from one of two bases: x[0]'s, or, from split on, x[1]'s
// moved back by split chunks (an address, never dereferenced below
// x[1]); without, every chunk is x[0]'s, as in kernel 1.
template <typename L2T, bool kTwoSrc>
struct WalkIn {
  const float* __restrict__ hi0;
  const float* __restrict__ lo0;
  uint64_t hi1, lo1;
  const int8_t* __restrict__ l1;
  const L2T* __restrict__ l2;
  const int32_t* __restrict__ s_ids;
  int64_t start, cells;
  int count, split;

  __device__ __forceinline__ WalkIn(const Walk& w, int d, int sub)
      : hi0(static_cast<const float*>(w.x[0])),
        lo0(static_cast<const float*>(w.lo[0])), hi1(0), lo1(0), l1(w.l1),
        l2(static_cast<const L2T*>(w.l2)), s_ids(w.s_ids),
        start(__ldg(w.starts + d)), cells(static_cast<int64_t>(sub) * kLane),
        count(__ldg(w.counts + d)), split(w.split) {
    if constexpr (kTwoSrc) {
      const uint64_t back = static_cast<uint64_t>(split) * cells * 4;
      hi1 = reinterpret_cast<uint64_t>(w.x[1]) - back;
      lo1 = reinterpret_cast<uint64_t>(w.lo[1]) - back;
    }
  }

  __device__ __forceinline__ DfSum::V value(int sid, int ss, int lane) const {
    const int64_t off = static_cast<int64_t>(sid) * cells + ss * kLane + lane;
    if constexpr (kTwoSrc) {
      if (sid >= split) {
        return DfSum::load(reinterpret_cast<const float*>(hi1) + off,
                           reinterpret_cast<const float*>(lo1) + off, lane);
      }
    }
    return DfSum::load(hi0 + off, lo0 + off, lane);
  }
};

// The sums of this thread's cell over dest chunk d's tiles of one walk,
// in order, as kernel 1 walks: each tile's l2 entry, its l1 lane, its
// values, unrolled 8 deep.
template <typename L2T, bool kTwoSrc>
__device__ __forceinline__ DfSum walk_sum_of(const Walk& walk, int d,
                                             const Cell& k, int sub) {
  const WalkIn<L2T, kTwoSrc> w(walk, d, sub);
  DfSum s;
#pragma unroll 8
  for (int i = 0; i < w.count; ++i) {
    const int64_t t = w.start + i;
    const int ss = static_cast<int>(__ldg(w.l2 + t * w.cells + k.c));
    const int lane = __ldg(w.l1 + (t * sub + ss) * kLane + k.ld);
    s.add(w.value(__ldg(w.s_ids + t), ss, lane));
  }
  return s;
}

// ... of walk w: a constant index into the arguments on each branch, so
// the walk's pointers stay operands of the argument bank.
template <typename L2T, bool kTwoSrc>
__device__ __forceinline__ DfSum walk_sum(const ShardArgs& a, int w, int d,
                                          const Cell& k) {
  if (w == 0) return walk_sum_of<L2T, kTwoSrc>(a.walk[0], d, k, a.sub);
  return walk_sum_of<L2T, kTwoSrc>(a.walk[1], d, k, a.sub);
}

// This block's walk and dest chunk: blockIdx.y's place when the (walk,
// chunk) pairs are sorted by tile count, most first (heavy_first_chunk's
// order over both walks' counts), so the longest walks start first and
// the slots of short ones free early.  Every thread must call it.
__device__ __forceinline__ int2 shard_block(const ShardArgs& a) {
  const int pairs = a.n_walks * a.n_chunks;
  const auto count = [&a](int j) {
    return static_cast<int>(
        __ldg(a.walk[j / a.n_chunks].counts + j % a.n_chunks));
  };
  __shared__ int pair;
  if (pairs > tlt::kHeavyFirstMax) {
    pair = static_cast<int>(blockIdx.y);
  } else {
    const int t = static_cast<int>(threadIdx.x);
    if (t < pairs) {
      const int own = count(t);
      int place = 0;
      for (int j = 0; j < pairs; ++j) {
        const int other = count(j);
        place += other > own || (other == own && j < t);
      }
      if (place == static_cast<int>(blockIdx.y)) pair = t;
    }
  }
  __syncthreads();
  return make_int2(pair / a.n_chunks, pair % a.n_chunks);
}

// With two walks: true in the later of the two blocks of (d, blockIdx.x),
// once the other's partials (written before the call) are visible.  The
// pair's flag starts at zero (tlt_spmv_cpg_shard_df).  Every thread must
// call it.
__device__ __forceinline__ bool later_of_pair(const ShardArgs& a, int d) {
  __shared__ bool later;
  __threadfence();  // this block's partials before its arrival
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned* flag = a.flags + static_cast<int64_t>(d) * gridDim.x +
                     blockIdx.x;
    later = atomicAdd(flag, 1u) == 1u;
  }
  __syncthreads();
  if (later) __threadfence();
  return later;
}

// This thread's cell of the block's outputs after a transpose through
// shared memory (each row's kCols values contiguous in y): the walk sums
// (acc, err, lo) of that cell into c, and its offset in the untransposed
// (n_chunks*sub, 128) layout.  Every thread must call it.
__device__ __forceinline__ int64_t transposed_sums(const DfSum& s,
                                                  const Cell& k, int d,
                                                  int sub, float (&c)[3]) {
  __shared__ float tr[3][kRows][kCols + 1];
  const int tr_r = static_cast<int>(threadIdx.x) % kRows;
  const int tr_c = static_cast<int>(threadIdx.x) / kRows;
  tr[0][tr_r][tr_c] = s.acc;
  tr[1][tr_r][tr_c] = s.err;
  tr[2][tr_r][tr_c] = s.lo;
  __syncthreads();
  const int r = static_cast<int>(threadIdx.x) / kCols;
  const int col = static_cast<int>(threadIdx.x) % kCols;
#pragma unroll
  for (int q = 0; q < 3; ++q) c[q] = tr[q][r][col];
  return (static_cast<int64_t>(d) * sub + k.rd0 + r) * kLane + k.ld0 + col;
}

// One block an SM at least, said outright: the compiler then takes 64
// registers a thread for the walk's two gathers, where it took 32 left to
// itself, and the df SpMV ran faster (PERF.md, section 6).
template <typename L2T, bool kTwoSrc>
__global__ void __launch_bounds__(kCells, 1)
    cpg_shard_level_df_kernel(const __grid_constant__ ShardArgs a) {
  const int2 wd = shard_block(a);
  const Cell k = cell_of(a.sub);
  const DfSum s = walk_sum<L2T, kTwoSrc>(a, wd.x, wd.y, k);
  // the walks' (acc, err, lo) in walk order
  float c[kMaxWalks][3];
  const int64_t o = transposed_sums(s, k, wd.y, a.sub, c[0]);
  if (a.n_walks > 1) {
    const int64_t n = static_cast<int64_t>(a.n_chunks) * a.sub * kLane;
#pragma unroll
    for (int q = 0; q < 3; ++q) a.part[(wd.x * 3 + q) * n + o] = c[0][q];
    if (!later_of_pair(a, wd.y)) return;
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const float other = __ldcg(a.part + ((1 - wd.x) * 3 + q) * n + o);
      c[1][q] = wd.x == 0 ? other : c[0][q];
      c[0][q] = wd.x == 0 ? c[0][q] : other;
    }
  }
  float y, e;
  int first = 0;
  if (a.base_y != nullptr) {
    y = a.base_y[o];
    e = a.base_e[o];
  } else {
    y = c[0][0];
    e = __fadd_rn(c[0][1], c[0][2]);
    first = 1;
  }
  for (int v = first; v < a.n_walks; ++v) {
    tlt::df_fold(y, e, c[v][0], c[v][1], c[v][2]);
  }
  if (a.out_y != nullptr) {
    a.out_y[o] = y;
    a.out_e[o] = e;
  }
  if (a.out_hi != nullptr) tlt::df_finish(y, e, a.mask, o, a.out_hi, a.out_lo);
}

// One single-device df64 level in the classic layout (mirrored by the C
// entry tlt_spmv_cpg_level_df): one walk over all dest chunks, its source
// the pair (walk.x[0], walk.lo[0]); mode and finish as df_level_cell
// takes them.
struct LevelDfArgs {
  Walk walk;
  const float* mask;  // finish: the realmask, or null
  float* out_a;       // the level's outputs, never its source
  float* out_b;
  int n_chunks;
  int sub;
  int mode;           // tlt::DfMode
  int finish;
};

// One block an SM at least, as the shard kernel says it: 66 registers, 3
// blocks an SM.  Bounds of 4, 5 and 6 blocks an SM (64, 48 and 40
// registers) made bn1M's main level 4%, 19% and 11% slower (PERF.md,
// section 6): the walk's loads in flight matter more than warps.
template <typename L2T>
__global__ void __launch_bounds__(kCells, 1)
    cpg_level_df_kernel(const __grid_constant__ LevelDfArgs a) {
  const int d = tlt::heavy_first_chunk(a.walk.counts, a.n_chunks);
  const Cell k = cell_of(a.sub);
  const DfSum s = walk_sum_of<L2T, false>(a.walk, d, k, a.sub);
  float c[3];
  const int64_t o = transposed_sums(s, k, d, a.sub, c);
  tlt::df_level_cell(a.mode, a.finish != 0, c[0], c[1], c[2],
                     static_cast<const float*>(a.walk.x[0]),
                     static_cast<const float*>(a.walk.lo[0]), a.mask, o,
                     a.out_a, a.out_b);
}

// (sub*128/256, n_walks*n_chunks) blocks of 256 cells.
dim3 shard_grid(const ShardArgs& a) {
  return dim3(static_cast<unsigned>(a.sub * kLane / kCells),
              static_cast<unsigned>(a.n_walks * a.n_chunks));
}

bool bad_args(const ShardArgs& a) {
  return a.n_chunks <= 0 || a.sub <= 0 || a.sub % kLane != 0 ||
         a.n_walks < 1 || a.n_walks > kMaxWalks ||
         a.n_walks * a.n_chunks > 65535 ||
         (a.n_walks > 1 && (a.part == nullptr || a.flags == nullptr)) ||
         (a.base_y == nullptr) != (a.base_e == nullptr) ||
         (a.out_y == nullptr) != (a.out_e == nullptr) ||
         (a.out_hi == nullptr) != (a.out_lo == nullptr) ||
         (a.out_y == nullptr && a.out_hi == nullptr);
}

// Whether a walk of the launch reads a second source (a halo).
bool two_sources(const ShardArgs& a) {
  for (int w = 0; w < a.n_walks; ++w) {
    if (a.walk[w].x[1] != nullptr) return true;
  }
  return false;
}

template <typename L2T>
void launch_df(const ShardArgs& a, cudaStream_t s) {
  if (two_sources(a)) {
    cpg_shard_level_df_kernel<L2T, true><<<shard_grid(a), kCells, 0, s>>>(a);
  } else {
    cpg_shard_level_df_kernel<L2T, false><<<shard_grid(a), kCells, 0, s>>>(a);
  }
}

}  // namespace

// Launches one shard's df64 level on `stream` (float streams; l2_bytes 1
// or 2), after zeroing its pair flags there when it has two walks.
// Returns the CUDA error (0 = launched).
extern "C" int tlt_spmv_cpg_shard_df(const tlt::ShardArgs* args, int l2_bytes,
                                     void* stream) {
  const tlt::ShardArgs& a = *args;
  if (bad_args(a) || (l2_bytes != 1 && l2_bytes != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.n_walks > 1) {
    const size_t flags = static_cast<size_t>(a.n_chunks) * shard_grid(a).x;
    const cudaError_t err =
        cudaMemsetAsync(a.flags, 0, flags * sizeof(unsigned), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (l2_bytes == 1) {
    launch_df<uint8_t>(a, s);
  } else {
    launch_df<int16_t>(a, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches one single-device df64 level in the classic layout on `stream`:
// the walk of (x_hi, x_lo) over the level's tiles (l2_bytes 1 or 2) into
// all n_chunks dest chunks, written in `mode` (tlt::DfMode) to out_a and
// out_b, which must not overlap the source; `finish` (main and reduce
// levels) writes the finished pair, times `mask` where it is not null.
// Returns the CUDA error (0 = launched).
extern "C" int tlt_spmv_cpg_level_df(const void* x_hi, const void* x_lo,
                                     const void* l1, const void* l2,
                                     const void* s_ids, const void* starts,
                                     const void* counts, const void* mask,
                                     void* out_a, void* out_b, int n_chunks,
                                     int sub, int l2_bytes, int mode,
                                     int finish, void* stream) {
  if (n_chunks <= 0 || n_chunks > 65535 || sub <= 0 || sub % kLane != 0 ||
      (l2_bytes != 1 && l2_bytes != 2) || mode < tlt::kDfBcast ||
      mode > tlt::kDfReduce || (mode == tlt::kDfBcast && finish != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LevelDfArgs a = {};
  a.walk.x[0] = x_hi;
  a.walk.lo[0] = x_lo;
  a.walk.l1 = static_cast<const int8_t*>(l1);
  a.walk.l2 = l2;
  a.walk.s_ids = static_cast<const int32_t*>(s_ids);
  a.walk.starts = static_cast<const int32_t*>(starts);
  a.walk.counts = static_cast<const int32_t*>(counts);
  a.walk.split = n_chunks;
  a.mask = static_cast<const float*>(mask);
  a.out_a = static_cast<float*>(out_a);
  a.out_b = static_cast<float*>(out_b);
  a.n_chunks = n_chunks;
  a.sub = sub;
  a.mode = mode;
  a.finish = finish;
  const dim3 grid(static_cast<unsigned>(sub * kLane / kCells),
                  static_cast<unsigned>(n_chunks));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (l2_bytes == 1) {
    cpg_level_df_kernel<uint8_t><<<grid, kCells, 0, s>>>(a);
  } else {
    cpg_level_df_kernel<int16_t><<<grid, kCells, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
