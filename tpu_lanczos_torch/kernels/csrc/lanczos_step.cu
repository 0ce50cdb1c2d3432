// The Lanczos step outside the SpMV on Hopper (sm_90a), bound through ctypes.
//
// Replaces the part of the reference's recurrence that XLA fuses inside
// its one-program loop: tpu_lanczos/core/lanczos.py:84-96 (the body of
// lanczos_range; the same step in lanczos_alphabeta :127-136 and
// lanczos_recombine :162-172), row 5, and tpu_lanczos/core/
// lanczos_df.py:30-40 (_body_core after spmv_cpg_df, with core/df64.py's
// df_dot, df_norm, df_div and df_scale), row 5c.  Given v = A q_j:
//
//   alpha_j = <v, q_j>;  v' = v - alpha_j q_j - beta_{j-1} q_{j-1};
//   beta_j = ||v'||;     q_{j+1} = v' / beta_j, or 0 when beta_j <= 0
//
// in float or double (row 5), or in df64 pairs of floats (row 5c).
//
// What bounds it: bytes.  A step must read v, q_j and q_{j-1} (and the
// pack's realmask, whose multiply the step folds into its load of v) and
// write q_{j+1} (and the stored row or the recombine fold): about 5n
// values.  So a step is ONE cooperative launch of a persistent grid
// (every block co-resident, sized by the occupancy calculator; a grid
// that cannot be co-resident is refused by the launch, never hung) in
// three phases, separated by two grid barriers:
//   1. the dot: v (times the mask) and q_j loaded once, alpha_j;
//   2. the update and its norm: q_{j-1} loaded, v' = ..., beta_j;
//   3. the normalize: q_{j+1} written over v (and, if asked, into a row of
//      the stored basis, and ans += coeff[jc] * q_{j+1}).
// Each thread holds its slice of v and q_j (then v') on chip between the
// phases, so the step reads its inputs once: the first chunks in
// registers (row 5: four 16-byte vectors an array), the next in
// shared memory, and what does not fit on the chip is re-read in the
// later phases (from the 50 MB L2 where it is there).  The caller (kernels/
// lanczos_step.py) picks the tier and the grid from the occupancy this
// file reports; the crossovers are measured (PERF.md).  Row 5c's dot and
// norm must follow the plain tree's element map below, which puts a
// warp's lanes G 32-byte sectors apart; those scattered sectors, not the
// df arithmetic, bound it, so its phase 3 (no reduction) recomputes v'
// past the held row in a grid-stride order whose warps touch contiguous
// memory, and phase 2 stores nothing.
// With reorthogonalization (row 5 only) the caller runs its two GEMVs
// between passes, so that path keeps separate pass kernels: head (dot,
// update without the norm), tail (sub+norm, normalize).  The df64 start
// norm (tlt_df_norm) is one launch of the df dot kernel.
//
// Rows 5d and 5cd are the same steps for one shard of the row-sharded
// loops, which replace tpu_lanczos/dist/mesh.py:82-107 and :189-220 (the
// step inside the sharded fori_loops) and dist/lanczos_df.py:171-188
// (_body_core_sh).  There the dot and the norm are sums over every shard
// (the reference's psum, and for df64 its _df_allsum), so the step splits
// into passes at those two points: a dot pass, an update pass (v' over
// v, and the shard's partial norm), a normalize pass, each one launch a
// shard.  Each reduction ends in the last block to arrive folding the
// block partials in index order and writing the shard's partial to its
// slot of a small buffer; the pass that consumes the sum folds all the
// slots in shard order itself (the psum's left fold, the allsum's df_add
// chain), so when the shards share a device nothing runs between a step's
// passes.  What bounds a pass at a shard's size (2^18 at bn1M over 4
// shards, 1 MB vectors that sit in the 50 MB L2) is latency: launch,
// load, the fold.  So each pass is a programmatic dependent launch
// (Hopper): it starts while the pass before it drains, loads what that
// pass cannot write before it waits, and lets the next one start as soon
// as its own wait returns (section "dependent launch" below).  The df64
// dot and norm keep the plain tree's element map on the shard's n
// elements (df_geometry below), so the hi word of each shard's partial
// is the plain tree's on its slice.
//
// Reductions are deterministic: no floating-point atomics.  Each block
// reduces its part in a fixed order and writes one partial; after the
// grid barrier EVERY block folds the G partials in index order itself, so
// each holds the same bits and no third barrier is needed (the pass
// kernels instead let the last block to arrive fold them).  So two runs,
// and the two passes of the two-pass mode, agree bit for bit.  Row 5
// accumulates in the vector's dtype with fused multiply-adds.
//
// Rounding.  The elementwise arithmetic rounds as the eager torch ops do:
// every add, multiply, divide and square root is written with the _rn
// intrinsics, which nvcc never contracts into a fused multiply-add, so
// given the same scalars q_{j+1} (and v', ans) equal the plain version's
// bit for bit; the mask multiply is by exact 0 or 1, so v * mask is the
// bit pattern the SpMV's separate multiply produced, -0.0 included.  Row
// 5c keeps core/df64.py's forms: the bit-mask split, the four-product
// two_prod, Knuth's two-sum; nothing here may be built with
// -use_fast_math or any flag that reassociates.
//
// Row 5c's dot keeps the plain version's pairwise two-sum tree over the
// hi products (df64.py _tree_sum_df: the vector zero-padded to a power of
// two P, level by level, index i with i + P/2^l).  Element i of a pass is
//
//   i = row * (G * 2048) + ((threadIdx.x * G + blockIdx.x) * 8 + r)
//
// with G a power of 2 blocks of 256 threads, r < 8 (one 32-byte sector of
// each array a thread) and row < 2^rows_log.  The tree's levels then pair,
// in order: rows (inside a thread: the rows are taken in bit-reversed
// order and summed by a binary counter of partial nodes, in shared
// memory), threads (t with t + 128, 64, 32 in shared memory, then t + 16,
// ..., 1 by warp shuffles), then blocks and r (the fold over the 8*G
// partials in index order).  Every level pairs the same indices as the
// plain tree, and two_sum's sum is symmetric, so the hi sum equals the
// plain version's (up to the sign of an all-zero sum below P = 2048).
// The error terms are summed in the kernel's own fixed order, which
// differs from the plain torch.sum's at second order (df64.py
// _tree_sum_df).  kernels/lanczos_step.py ``df_geometry`` picks G (the
// largest power of 2 that is co-resident), rows_log and the held row.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// the pass kernels (reorthogonalization): four blocks on each of the
// H100's 132 SMs, grid-stride
constexpr int kGrid = 4 * 132;
// row 5c's geometry (above): 8 elements a thread a row, at most
// kDfMaxBlocks blocks and 2^kDfMaxDepth rows in the df_norm kernel (P <=
// 2^31); the fold's threads hold at most 8 * kDfMaxBlocks / kThreads =
// 2^kFoldDepth values
constexpr int kDfVec = 8;
constexpr int kDfSpan = kThreads * kDfVec;
constexpr int kDfMaxBlocks = 4096;
constexpr int kDfMaxDepth = 8;
constexpr int kFoldDepth = 7;
// the fold's first partials a thread loads at once (4: every partial of
// a grid of up to 128 blocks, a shard of up to 2^18 elements)
constexpr int kFoldAhead = 4;
// the one-launch step: at most kMaxGrid blocks; row 5c at most
// kDfStepMaxGrid blocks (its fold stages their 8 * G partials in shared
// memory) and 2^kDfMaxRowsLog rows (P <= 2^31 at G = 1)
constexpr int kMaxGrid = kDfMaxBlocks;
constexpr int kRegChunks = 4;
constexpr int kDfStepMaxGrid = 512;
constexpr int kDfMaxRowsLog = 20;
static_assert(kWarps == kDfVec, "row 5c: one warp a lane r in the block tree");

// the workspace: the pass kernels' arrival counter, then two regions of
// partials (row 5: G values; row 5c: 8 hi values and one error sum a
// block), one for each of a step's two reductions
constexpr int kPartOff = 256;
constexpr int kRegionBytes = kDfMaxBlocks * (kDfVec + 1) * 4;
constexpr int kWorkspaceBytes = kPartOff + 2 * kRegionBytes;
static_assert(kMaxGrid * 8 <= kRegionBytes, "row 5's partials fit a region");

// ------------------------------------------------------------- rounding

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// ------------------------------------------------------------- dependent launch
// Rows 5d and 5cd's passes are launched with programmatic stream
// serialization (launch_pass below), so a pass may start while the kernel
// before it on the stream still runs.  grid_dep_wait() returns once every
// kernel before it has finished and its writes are visible; before it a
// pass loads only what the kernel just before it does not write, writes
// nothing, and touches neither the workspace nor the slots.
// grid_dep_launch() lets the next pass start; a pass calls it only after
// its own wait, so when pass N+1 starts, every kernel before pass N has
// finished (the transitive completion the slot folds rely on).

__device__ __forceinline__ void grid_dep_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}
__device__ __forceinline__ void grid_dep_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// 16-byte vector loads and stores: 4 floats or 2 doubles
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

__device__ __forceinline__ void load(const float* p, int64_t c,
                                     float (&e)[4]) {
  const float4 v = reinterpret_cast<const float4*>(p)[c];
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ void load(const double* p, int64_t c,
                                     double (&e)[2]) {
  const double2 v = reinterpret_cast<const double2*>(p)[c];
  e[0] = v.x;
  e[1] = v.y;
}
__device__ __forceinline__ void store(float* p, int64_t c,
                                      const float (&e)[4]) {
  reinterpret_cast<float4*>(p)[c] = make_float4(e[0], e[1], e[2], e[3]);
}
__device__ __forceinline__ void store(double* p, int64_t c,
                                      const double (&e)[2]) {
  reinterpret_cast<double2*>(p)[c] = make_double2(e[0], e[1]);
}

// ------------------------------------------------------------- reductions

// The block's sum of x in a fixed tree order, in thread 0: thread t adds
// t + 128, 64, 32 in shared memory, then t + 16, ..., 1 by shuffles in
// warp 0 (the same pairs and operand order as in shared memory, five
// barriers fewer).
template <typename T>
__device__ T block_sum(T x, T* sm) {
  __syncthreads();  // an earlier sum's readers of sm are done
  sm[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (threadIdx.x < s) {
      sm[threadIdx.x] = add_rn(sm[threadIdx.x], sm[threadIdx.x + s]);
    }
    __syncthreads();
  }
  T y = T(0);
  if (threadIdx.x < 32) {
    y = sm[threadIdx.x];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      const T z = __shfl_down_sync(0xffffffffu, y, s);
      if (static_cast<int>(threadIdx.x) < s) {
        y = add_rn(y, z);
      }
    }
  }
  return y;
}

// The threads that wrote the block's partials (`wrote`) fence them, then
// the block arrives on the counter (no other thread waits on its own
// stores: only the partials must be seen first).  True in every thread of
// the block that arrives last, which then sees every other block's
// partials.
__device__ bool arrive_last(unsigned int* counter, bool wrote) {
  __shared__ bool last;
  if (wrote) {
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
  }
  return last;
}

// Row 5: the grid's sum of every thread's x.  The block sums go to
// part[blockIdx.x]; the last block folds them in index order.  Returns
// true in the last block (the sum in `total`), and resets the counter.
template <typename T>
__device__ bool grid_sum(T x, T* part, unsigned int* counter, T& total) {
  __shared__ T sm[kThreads];
  const T b = block_sum(x, sm);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = b;
  }
  if (!arrive_last(counter, threadIdx.x == 0)) {
    return false;
  }
  T s = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    s = add_rn(s, __ldcg(part + i));
  }
  total = block_sum(s, sm);
  if (threadIdx.x == 0) {
    *counter = 0u;
  }
  return true;
}

// The one-launch step's reductions: a warp's sum pairs lane l with l + 16,
// 8, 4, 2, 1 by shuffles (lane 0 gets it); a block's sum is its warps'
// sums folded by warp 0 in the same order (thread 0 gets it).
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = add_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  }
  return x;
}

template <typename T>
__device__ T block_reduce(T x, T* sm) {
  x = warp_sum(x);
  __syncthreads();  // an earlier reduction's readers of sm are done
  if ((threadIdx.x & 31) == 0) {
    sm[threadIdx.x >> 5] = x;
  }
  __syncthreads();
  T s = T(0);
  if (threadIdx.x < 32) {
    s = warp_sum(threadIdx.x < kWarps ? sm[threadIdx.x] : T(0));
  }
  return s;
}

// The grid's sum of every thread's x, in every thread: the block sums go
// to part[blockIdx.x], the grid waits at a barrier, then every block
// folds the G partials in index order (so every block holds the same
// bits).
template <typename T>
__device__ T grid_total(T x, T* part, T* sm, T* bcast) {
  const T b = block_reduce(x, sm);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = b;
  }
  cg::this_grid().sync();
  T s = T(0);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    s = add_rn(s, __ldcg(part + i));
  }
  const T t = block_reduce(s, sm);
  if (threadIdx.x == 0) {
    *bcast = t;
  }
  __syncthreads();
  return *bcast;
}

// ------------------------------------------------------------- row 5

template <typename T>
__global__ void __launch_bounds__(kThreads)
step_dot_kernel(const T* __restrict__ v, const T* __restrict__ q, int64_t n,
                T* __restrict__ alpha, int j, T* part,
                unsigned int* counter) {
  constexpr int V = Vec<T>::n;
  const int64_t nv = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = T(0);
  for (int64_t c = g; c < nv; c += stride) {
    T a[V], b[V];
    load(v, c, a);
    load(q, c, b);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc = fma_rn(a[e], b[e], acc);
    }
  }
  if (g < n - nv * V) {
    acc = fma_rn(v[nv * V + g], q[nv * V + g], acc);
  }
  T total;
  if (grid_sum(acc, part, counter, total) && threadIdx.x == 0) {
    alpha[j] = total;
  }
}

// v' = (v - a q) - b_prev q_prev, rounded as the eager ops round.
template <typename T>
__device__ __forceinline__ T update(T v, T q, T qp, T a, T bp) {
  return sub_rn(sub_rn(v, mul_rn(a, q)), mul_rn(bp, qp));
}

// Pass 2: v' over v; with `norm`, beta[j] = ||v'||.
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_update_kernel(T* v, const T* __restrict__ q, const T* __restrict__ qp,
                   int64_t n, const T* alpha, T* beta, int j, int norm,
                   T* part, unsigned int* counter) {
  constexpr int V = Vec<T>::n;
  const T a = alpha[j];
  const T bp = j > 0 ? beta[j - 1] : T(0);
  const int64_t nv = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = T(0);
  for (int64_t c = g; c < nv; c += stride) {
    T x[V], y[V], z[V];
    load(v, c, x);
    load(q, c, y);
    load(qp, c, z);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = update(x[e], y[e], z[e], a, bp);
      acc = fma_rn(x[e], x[e], acc);
    }
    store(v, c, x);
  }
  if (g < n - nv * V) {
    const int64_t i = nv * V + g;
    const T w = update(v[i], q[i], qp[i], a, bp);
    v[i] = w;
    acc = fma_rn(w, w, acc);
  }
  T total;
  if (norm != 0 && grid_sum(acc, part, counter, total) && threadIdx.x == 0) {
    beta[j] = sqrt_rn(total);
  }
}

// Reorthogonalization's last pass: v -= w (the GEMVs' result), beta[j] =
// ||v||.
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_sub_norm_kernel(T* v, const T* __restrict__ w, int64_t n, T* beta, int j,
                     T* part, unsigned int* counter) {
  constexpr int V = Vec<T>::n;
  const int64_t nv = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  T acc = T(0);
  for (int64_t c = g; c < nv; c += stride) {
    T x[V], y[V];
    load(v, c, x);
    load(w, c, y);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = sub_rn(x[e], y[e]);
      acc = fma_rn(x[e], x[e], acc);
    }
    store(v, c, x);
  }
  if (g < n - nv * V) {
    const int64_t i = nv * V + g;
    const T x = sub_rn(v[i], w[i]);
    v[i] = x;
    acc = fma_rn(x, x, acc);
  }
  T total;
  if (grid_sum(acc, part, counter, total) && threadIdx.x == 0) {
    beta[j] = sqrt_rn(total);
  }
}

// Pass 3: q = beta[j] > 0 ? v / beta[j] : 0 over v; also into `row`
// (if given) and ans += coeff[jc] * q (if ans is given).
template <typename T>
__global__ void __launch_bounds__(kThreads)
step_normalize_kernel(T* v, int64_t n, const T* beta, int j, T* row, T* ans,
                      const T* coeff, int jc) {
  constexpr int V = Vec<T>::n;
  const T b = beta[j];
  const bool ok = b > T(0);
  const T c = ans != nullptr ? coeff[jc] : T(0);
  const int64_t nv = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (int64_t ch = g; ch < nv; ch += stride) {
    T x[V];
    load(v, ch, x);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = ok ? div_rn(x[e], b) : T(0);
    }
    store(v, ch, x);
    if (row != nullptr) {
      store(row, ch, x);
    }
    if (ans != nullptr) {
      T s[V];
      load(ans, ch, s);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] = add_rn(s[e], mul_rn(c, x[e]));
      }
      store(ans, ch, s);
    }
  }
  if (g < n - nv * V) {
    const int64_t i = nv * V + g;
    const T x = ok ? div_rn(v[i], b) : T(0);
    v[i] = x;
    if (row != nullptr) {
      row[i] = x;
    }
    if (ans != nullptr) {
      ans[i] = add_rn(ans[i], mul_rn(c, x));
    }
  }
}

// The one-launch row 5 step.  Held slot h of a thread is chunk (16 bytes
// of each array) h * G * kThreads + blockIdx.x * kThreads + threadIdx.x:
// slots h < kRegChunks in registers, kRegChunks <= h < kRegChunks + S in
// shared memory (S = smem_chunks, v's chunks then q's), and the chunks
// past the held ones grid-stride, re-read in the later phases.  Four
// register chunks on fewer blocks beat one or two on more at every size
// from 2^19 elements (PERF.md, eval/step_tiers.py), so C is 4.
template <typename T>
struct StepArgs {
  T* v;
  const float* mask;  // or null
  const T* q;
  const T* qp;
  T* alpha;
  T* beta;
  T* row;  // or null
  T* ans;  // or null
  const T* coeff;
  T* part1;
  T* part2;
  int64_t n;
  int j;
  int jc;
  int smem_chunks;
};

// chunk c of v, times the mask's chunk when there is one (exact: 0 or 1)
__device__ __forceinline__ void load_v(const StepArgs<float>& a, int64_t c,
                                       float (&e)[4]) {
  load(a.v, c, e);
  if (a.mask != nullptr) {
    float m[4];
    load(a.mask, c, m);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      e[i] = __fmul_rn(e[i], m[i]);
    }
  }
}
__device__ __forceinline__ void load_v(const StepArgs<double>& a, int64_t c,
                                       double (&e)[2]) {
  load(a.v, c, e);
  if (a.mask != nullptr) {
    const float2 m = reinterpret_cast<const float2*>(a.mask)[c];
    e[0] = __dmul_rn(e[0], static_cast<double>(m.x));
    e[1] = __dmul_rn(e[1], static_cast<double>(m.y));
  }
}
template <typename T>
__device__ __forceinline__ T load_v1(const StepArgs<T>& a, int64_t i) {
  return a.mask != nullptr ? mul_rn(a.v[i], static_cast<T>(a.mask[i]))
                           : a.v[i];
}

// phase 3 on one chunk (or, with V = 1, the tail element) of v': q_{j+1}
// over v, into the stored row, and the recombine fold
template <typename T, int V>
__device__ __forceinline__ void finish(const StepArgs<T>& a, int64_t c,
                                       T (&x)[V], bool ok, T b, T cf) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    x[e] = ok ? div_rn(x[e], b) : T(0);
  }
  if constexpr (V == 1) {
    a.v[c] = x[0];
    if (a.row != nullptr) {
      a.row[c] = x[0];
    }
    if (a.ans != nullptr) {
      a.ans[c] = add_rn(a.ans[c], mul_rn(cf, x[0]));
    }
  } else {
    store(a.v, c, x);
    if (a.row != nullptr) {
      store(a.row, c, x);
    }
    if (a.ans != nullptr) {
      T s[V];
      load(a.ans, c, s);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        s[e] = add_rn(s[e], mul_rn(cf, x[e]));
      }
      store(a.ans, c, s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
lanczos_step_kernel(StepArgs<T> a) {
  constexpr int V = Vec<T>::n;
  constexpr int C = kRegChunks;
  __shared__ T sm[kWarps];
  __shared__ T bc;
  extern __shared__ __align__(16) unsigned char dyn[];
  T* held_v = reinterpret_cast<T*>(dyn);
  T* held_q = held_v + static_cast<int64_t>(a.smem_chunks) * kThreads * V;
  const int S = a.smem_chunks;
  const int64_t n = a.n;
  const int64_t nv = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t held = (C + S) * stride;
  const int64_t tail = nv * V + g;  // this thread's element past the chunks
  const bool has_tail = g < n - nv * V;
  const T bp = a.j > 0 ? a.beta[a.j - 1] : T(0);

  // phase 1: alpha_j = <v, q_j>; every load issued before the first use
  T rv[C][V], rq[C][V];
#pragma unroll
  for (int h = 0; h < C; ++h) {
    const int64_t c = h * stride + g;
    if (c < nv) {
      load_v(a, c, rv[h]);
      load(a.q, c, rq[h]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        rv[h][e] = T(0);
        rq[h][e] = T(0);
      }
    }
  }
  T acc = T(0);
#pragma unroll
  for (int h = 0; h < C; ++h) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc = fma_rn(rv[h][e], rq[h][e], acc);
    }
  }
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const int64_t c = (C + s) * stride + g;
    if (c < nv) {
      T x[V], y[V];
      load_v(a, c, x);
      load(a.q, c, y);
      store(held_v, s * kThreads + threadIdx.x, x);
      store(held_q, s * kThreads + threadIdx.x, y);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        acc = fma_rn(x[e], y[e], acc);
      }
    }
  }
#pragma unroll 2
  for (int64_t c = held + g; c < nv; c += stride) {
    T x[V], y[V];
    load_v(a, c, x);
    load(a.q, c, y);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      acc = fma_rn(x[e], y[e], acc);
    }
  }
  if (has_tail) {
    acc = fma_rn(load_v1(a, tail), a.q[tail], acc);
  }
  const T al = grid_total(acc, a.part1, sm, &bc);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.alpha[a.j] = al;
  }

  // phase 2: v' = v - alpha_j q_j - beta_{j-1} q_{j-1}, beta_j = ||v'||
  T rp[C][V];
#pragma unroll
  for (int h = 0; h < C; ++h) {
    const int64_t c = h * stride + g;
    if (c < nv) {
      load(a.qp, c, rp[h]);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        rp[h][e] = T(0);
      }
    }
  }
  acc = T(0);
#pragma unroll
  for (int h = 0; h < C; ++h) {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      rv[h][e] = update(rv[h][e], rq[h][e], rp[h][e], al, bp);
      acc = fma_rn(rv[h][e], rv[h][e], acc);
    }
  }
#pragma unroll 4
  for (int s = 0; s < S; ++s) {
    const int64_t c = (C + s) * stride + g;
    if (c < nv) {
      T x[V], y[V], z[V];
      load(a.qp, c, z);
      load(held_v, s * kThreads + threadIdx.x, x);
      load(held_q, s * kThreads + threadIdx.x, y);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        x[e] = update(x[e], y[e], z[e], al, bp);
        acc = fma_rn(x[e], x[e], acc);
      }
      store(held_v, s * kThreads + threadIdx.x, x);
    }
  }
#pragma unroll 2
  for (int64_t c = held + g; c < nv; c += stride) {
    T x[V], y[V], z[V];
    load_v(a, c, x);
    load(a.q, c, y);
    load(a.qp, c, z);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = update(x[e], y[e], z[e], al, bp);
      acc = fma_rn(x[e], x[e], acc);
    }
    store(a.v, c, x);
  }
  T w_tail = T(0);
  if (has_tail) {
    w_tail = update(load_v1(a, tail), a.q[tail], a.qp[tail], al, bp);
    acc = fma_rn(w_tail, w_tail, acc);
  }
  const T b = sqrt_rn(grid_total(acc, a.part2, sm, &bc));
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.beta[a.j] = b;
  }

  // phase 3: q_{j+1} = v' / beta_j (0 on breakdown) over v, the stored
  // row, the recombine fold
  const bool ok = b > T(0);
  const T cf = a.ans != nullptr ? a.coeff[a.jc] : T(0);
#pragma unroll
  for (int h = 0; h < C; ++h) {
    const int64_t c = h * stride + g;
    if (c < nv) {
      finish<T, V>(a, c, rv[h], ok, b, cf);
    }
  }
  for (int s = 0; s < S; ++s) {
    const int64_t c = (C + s) * stride + g;
    if (c < nv) {
      T x[V];
      load(held_v, s * kThreads + threadIdx.x, x);
      finish<T, V>(a, c, x, ok, b, cf);
    }
  }
  for (int64_t c = held + g; c < nv; c += stride) {
    T x[V];
    load(a.v, c, x);
    finish<T, V>(a, c, x, ok, b, cf);
  }
  if (has_tail) {
    T x[1] = {w_tail};
    finish<T, 1>(a, tail, x, ok, b, cf);
  }
}

// ------------------------------------------------------------- df64 ops
// core/df64.py's forms, every operation rounded as written

struct Df {
  float h, l;
};

__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float z = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, z)), __fsub_rn(b, z));
}

__device__ __forceinline__ Df fast_two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  return {s, __fsub_rn(b, __fsub_rn(s, a))};
}

// the bit-level split: sign, exponent and the top 11 mantissa bits
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = __int_as_float(__float_as_int(a) & static_cast<int>(0xFFFFF000u));
  lo = __fsub_rn(a, hi);
}

__device__ __forceinline__ void two_prod(float a, float b, float& p,
                                         float& e) {
  float ah, al, bh, bl, e1, e2, e3;
  split(a, ah, al);
  split(b, bh, bl);
  two_sum(__fmul_rn(ah, bh), __fmul_rn(ah, bl), p, e1);
  two_sum(p, __fmul_rn(al, bh), p, e2);
  two_sum(p, __fmul_rn(al, bl), p, e3);
  e = __fadd_rn(__fadd_rn(e1, e2), e3);
}

__device__ __forceinline__ Df df_add(Df x, Df y) {
  float s, e;
  two_sum(x.h, y.h, s, e);
  e = __fadd_rn(e, __fadd_rn(x.l, y.l));
  return fast_two_sum(s, e);
}

__device__ __forceinline__ Df df_sub(Df x, Df y) {
  return df_add(x, Df{-y.h, -y.l});
}

__device__ __forceinline__ Df df_mul(Df x, Df y) {
  float p, e;
  two_prod(x.h, y.h, p, e);
  e = __fadd_rn(e, __fadd_rn(__fmul_rn(x.h, y.l), __fmul_rn(x.l, y.h)));
  return fast_two_sum(p, e);
}

__device__ Df df_div(Df x, Df y) {
  const float q1 = __fdiv_rn(x.h, y.h);
  const Df r = df_sub(x, df_mul(Df{q1, 0.0f}, y));
  const float q2 = __fdiv_rn(__fadd_rn(r.h, r.l), y.h);
  return fast_two_sum(q1, q2);
}

__device__ Df df_sqrt(Df x) {
  const float s1 = __fsqrt_rn(x.h);
  const Df r = df_sub(x, df_mul(Df{s1, 0.0f}, Df{s1, 0.0f}));
  float s2 = __fdiv_rn(__fadd_rn(r.h, r.l), __fmul_rn(2.0f, s1));
  s2 = s1 > 0.0f ? s2 : 0.0f;
  return fast_two_sum(s1, s2);
}

// One term of df_dot(x, y): the hi product p, its error e with the cross
// terms (df64.py df_dot: e + (x_hi*y_lo + x_lo*y_hi)).
__device__ __forceinline__ float dot_term(Df x, Df y, float& e) {
  float p, e1;
  two_prod(x.h, y.h, p, e1);
  e = __fadd_rn(e1, __fadd_rn(__fmul_rn(x.h, y.l), __fmul_rn(x.l, y.h)));
  return p;
}

// ------------------------------------------------------------- row 5c

// The first element of this thread's 8 in `row` (the geometry above).
__device__ __forceinline__ int64_t df_base(int row) {
  return static_cast<int64_t>(row) * gridDim.x * kDfSpan +
         (static_cast<int64_t>(threadIdx.x) * gridDim.x + blockIdx.x) * kDfVec;
}

__device__ __forceinline__ void load8(const float* p, int64_t i0, int64_t n,
                                      float (&e)[kDfVec]) {
  if (i0 + kDfVec <= n) {
    const float4 a = *reinterpret_cast<const float4*>(p + i0);
    const float4 b = *reinterpret_cast<const float4*>(p + i0 + 4);
    e[0] = a.x;
    e[1] = a.y;
    e[2] = a.z;
    e[3] = a.w;
    e[4] = b.x;
    e[5] = b.y;
    e[6] = b.z;
    e[7] = b.w;
  } else {
#pragma unroll
    for (int r = 0; r < kDfVec; ++r) {
      e[r] = i0 + r < n ? p[i0 + r] : 0.0f;
    }
  }
}

// the mask's multiply (exact: 0 or 1) of a thread's 8 hi and lo values
__device__ __forceinline__ void mask8(float (&h)[kDfVec], float (&l)[kDfVec],
                                      const float (&m)[kDfVec]) {
#pragma unroll
  for (int r = 0; r < kDfVec; ++r) {
    h[r] = __fmul_rn(h[r], m[r]);
    l[r] = __fmul_rn(l[r], m[r]);
  }
}

__device__ __forceinline__ int bit_reverse(int m, int bits) {
  return bits == 0 ? 0
                   : static_cast<int>(__brev(static_cast<unsigned>(m)) >>
                                      (32 - bits));
}

// A pairwise two-sum tree over the values pushed in bit-reversed order:
// push number m combines with the partial nodes of the set bits of m, as
// a binary counter does.  After 2^d pushes (d <= Depth) the last push's x
// holds the root.  Every index is static after unrolling: the nodes live
// in registers.
template <int W, int Depth>
struct TreeStack {
  float node[Depth > 0 ? Depth : 1][W];

  __device__ __forceinline__ void push(int m, float (&x)[W], float& err) {
    bool done = false;
#pragma unroll
    for (int l = 0; l < Depth; ++l) {
      if (!done) {
        if ((m >> l) & 1) {
#pragma unroll
          for (int r = 0; r < W; ++r) {
            float t;
            two_sum(node[l][r], x[r], x[r], t);
            err = __fadd_rn(err, t);
          }
        } else {
#pragma unroll
          for (int r = 0; r < W; ++r) {
            node[l][r] = x[r];
          }
          done = true;
        }
      }
    }
  }
};

// The levels of the tree over `count` (a power of 2) values in sm[r][.]
// for each of the `width` r: index t with t + count/2, and so on down to
// one value in sm[r][0].  The two-sum errors go to err.
__device__ void smem_tree(float (*sm)[kThreads], int width, int count,
                          float& err) {
  __syncthreads();
  for (int s = count / 2; s > 0; s >>= 1) {
    for (int it = threadIdx.x; it < width * s; it += kThreads) {
      const int r = it / s;
      const int t = it - r * s;
      float hi, lo;
      two_sum(sm[r][t], sm[r][t + s], hi, lo);
      sm[r][t] = hi;
      err = __fadd_rn(err, lo);
    }
    __syncthreads();
  }
}

// The tree after the rows: the thread's 8 nodes in x, its error sum in
// err.  Reduces over the block's threads, writes the block's 8 partials
// and its error sum, and lets the last block fold every block's partials
// in index order and write the sum, or with `root_sqrt` its df_sqrt, to
// (out_h[0], out_l[0]).
__device__ void df_grid_tree(float (&x)[kDfVec], float err, float* out_h,
                             float* out_l, bool root_sqrt,
                             unsigned char* work) {
  __shared__ float sm[kDfVec][kThreads];
  __shared__ float sm_err[kThreads];
  unsigned int* counter = reinterpret_cast<unsigned int*>(work);
  float* part = reinterpret_cast<float*>(work + kPartOff);
  float* part_err = part + kDfVec * kDfMaxBlocks;

#pragma unroll
  for (int r = 0; r < kDfVec; ++r) {
    sm[r][threadIdx.x] = x[r];
  }
  smem_tree(sm, kDfVec, kThreads, err);
  if (threadIdx.x < kDfVec) {
    part[blockIdx.x * kDfVec + threadIdx.x] = sm[threadIdx.x][0];
  }
  const float block_err = block_sum(err, sm_err);
  if (threadIdx.x == 0) {
    part_err[blockIdx.x] = block_err;
  }
  if (!arrive_last(counter, threadIdx.x < kDfVec)) {
    return;
  }
  // the fold: the tree over the 8*G partials, index i with i + 4G first;
  // thread t holds t + m*tf, summed over m in the binary counter
  const int nf = kDfVec * gridDim.x;
  const int tf = nf < kThreads ? nf : kThreads;
  const int mf = nf / tf;
  const int mf_log = __ffs(mf) - 1;
  // this thread's first error sum, loaded beside the partials
  const int g = static_cast<int>(gridDim.x);
  const float pe0 = static_cast<int>(threadIdx.x) < g
                        ? __ldcg(part_err + threadIdx.x) : 0.0f;
  float e2 = 0.0f;
  if (threadIdx.x < tf) {
    // the first kFoldAhead partials loaded together, before the pushes
    float ahead[kFoldAhead];
#pragma unroll
    for (int m = 0; m < kFoldAhead; ++m) {
      if (m < mf) {
        ahead[m] = __ldcg(part + threadIdx.x + bit_reverse(m, mf_log) * tf);
      }
    }
    TreeStack<1, kFoldDepth> stack;
    float y[1] = {0.0f};
#pragma unroll
    for (int m = 0; m < kFoldAhead; ++m) {
      if (m < mf) {
        y[0] = ahead[m];
        stack.push(m, y, e2);
      }
    }
    for (int m = kFoldAhead; m < mf; ++m) {
      y[0] = __ldcg(part + threadIdx.x + bit_reverse(m, mf_log) * tf);
      stack.push(m, y, e2);
    }
    sm[0][threadIdx.x] = y[0];
  }
  smem_tree(sm, 1, tf, e2);
  for (int i = threadIdx.x; i < g; i += kThreads) {
    e2 = __fadd_rn(e2, i == static_cast<int>(threadIdx.x)
                           ? pe0 : __ldcg(part_err + i));
  }
  const float total_err = block_sum(e2, sm_err);
  if (threadIdx.x == 0) {
    const Df sum = fast_two_sum(sm[0][0], total_err);
    const Df b = root_sqrt ? df_sqrt(sum) : sum;
    out_h[0] = b.h;
    out_l[0] = b.l;
    *counter = 0u;
  }
}

// df_dot(x * mask, y) (mask may be null) on df64.py's pairwise tree, in
// one launch, the last block writing the pair, or with `root_sqrt`
// its df_sqrt (df_norm(x) when y is x), to (out_h[0], out_l[0]).  The
// df64 start vector's norm (single device, and row 5cd's start norms)
// and row 5cd's dot pass (out: the shard's slot), launched as a
// dependent; with `early`, row 0's y and mask are loaded before the
// wait (x, the SpMV's output, never is).
template <int Depth>
__global__ void __launch_bounds__(kThreads)
df_dot_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
              const float* __restrict__ mask, const float* __restrict__ yh,
              const float* __restrict__ yl, int64_t n, int rows_log,
              float* out_h, float* out_l, int root_sqrt, int early,
              unsigned char* work) {
  float c[kDfVec], d[kDfVec], mk[kDfVec];
  const bool pre = early != 0 && df_base(0) < n;
  if (pre) {
    load8(yh, df_base(0), n, c);
    load8(yl, df_base(0), n, d);
    if (mask != nullptr) {
      load8(mask, df_base(0), n, mk);
    }
  }
  grid_dep_wait();
  grid_dep_launch();
  TreeStack<kDfVec, Depth> stack;
  float x[kDfVec];
  float err = 0.0f;
  for (int m = 0; m < (1 << rows_log); ++m) {
    const int64_t i0 = df_base(bit_reverse(m, rows_log));
    if (i0 < n) {
      float a[kDfVec], b[kDfVec];
      if (!pre || m != 0) {
        load8(yh, i0, n, c);
        load8(yl, i0, n, d);
        if (mask != nullptr) {
          load8(mask, i0, n, mk);
        }
      }
      load8(xh, i0, n, a);
      load8(xl, i0, n, b);
      if (mask != nullptr) {
        mask8(a, b, mk);
      }
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        float e;
        x[r] = dot_term(Df{a[r], b[r]}, Df{c[r], d[r]}, e);
        if (i0 + r < n) {
          err = __fadd_rn(err, e);
        } else {
          x[r] = 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        x[r] = 0.0f;
      }
    }
    stack.push(m, x, err);
  }
  df_grid_tree(x, err, out_h, out_l, root_sqrt != 0, work);
}

// ---- the one-launch row 5c step

struct DfStepArgs {
  float* vh;
  float* vl;
  const float* mask;  // or null
  const float* qh;
  const float* ql;
  const float* ph;
  const float* pl;
  float* ah;
  float* al;
  float* bh;
  float* bl;
  float* ans_h;  // n_ans rows of n, or null
  float* ans_l;
  const float* ch;
  const float* cl;
  float* part1;  // each: 8 * kDfMaxBlocks hi partials, then kDfMaxBlocks
  float* part2;  // error sums
  int64_t n;
  int64_t c_stride;
  int j;
  int jc;
  int n_ans;
  int rows_log;
  int hold;  // 1: row 0's inputs (then v') held in shared memory
};

// K (4 or 8) of a thread's 8 elements from i0 (a multiple of K), zero
// past n, as 16-byte accesses where they are all inside
template <int K>
__device__ __forceinline__ void loadk(const float* p, int64_t i0, int64_t n,
                                      float (&e)[K]) {
  if (i0 + K <= n) {
    if constexpr (K == 8) {
      const float4 a = *reinterpret_cast<const float4*>(p + i0);
      const float4 b = *reinterpret_cast<const float4*>(p + i0 + 4);
      e[0] = a.x;
      e[1] = a.y;
      e[2] = a.z;
      e[3] = a.w;
      e[4] = b.x;
      e[5] = b.y;
      e[6] = b.z;
      e[7] = b.w;
    } else {
      const float4 a = *reinterpret_cast<const float4*>(p + i0);
      e[0] = a.x;
      e[1] = a.y;
      e[2] = a.z;
      e[3] = a.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      e[r] = i0 + r < n ? p[i0 + r] : 0.0f;
    }
  }
}

template <int K>
__device__ __forceinline__ void storek(float* p, int64_t i0, int64_t n,
                                       const float (&e)[K]) {
  if (i0 + K <= n) {
    if constexpr (K == 8) {
      *reinterpret_cast<float4*>(p + i0) =
          make_float4(e[0], e[1], e[2], e[3]);
      *reinterpret_cast<float4*>(p + i0 + 4) =
          make_float4(e[4], e[5], e[6], e[7]);
    } else {
      *reinterpret_cast<float4*>(p + i0) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (i0 + r < n) {
        p[i0 + r] = e[r];
      }
    }
  }
}

// v's K elements (hi and lo) times the mask's (exact: 0 or 1)
template <int K>
__device__ __forceinline__ void load_v_df(const DfStepArgs& a, int64_t i0,
                                          float (&h)[K], float (&l)[K]) {
  loadk<K>(a.vh, i0, a.n, h);
  loadk<K>(a.vl, i0, a.n, l);
  if (a.mask != nullptr) {
    float m[K];
    loadk<K>(a.mask, i0, a.n, m);
#pragma unroll
    for (int r = 0; r < K; ++r) {
      h[r] = __fmul_rn(h[r], m[r]);
      l[r] = __fmul_rn(l[r], m[r]);
    }
  }
}

// v' = df_sub(v, df_add(df_scale(a, q), df_scale(b_prev, q_prev))) for
// one element: phases 2 and 3 both compute it (phase 3 again, in its own
// element order), with the same ops, so the same bits.
__device__ __forceinline__ Df df_update(Df v, Df q, Df p, Df a, Df bp) {
  return df_sub(v, df_add(df_mul(a, q), df_mul(bp, p)));
}

// q_{j+1} from v' (0 on breakdown) over v's K elements at i0, and the
// recombine fold into each of the n_ans answers
template <int K>
__device__ __forceinline__ void df_finish(const DfStepArgs& a, int64_t i0,
                                          float (&w0)[K], float (&w1)[K],
                                          Df inv, bool ok) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Df q = df_mul(inv, Df{w0[k], w1[k]});
    w0[k] = ok ? q.h : 0.0f;
    w1[k] = ok ? q.l : 0.0f;
  }
  storek<K>(a.vh, i0, a.n, w0);
  storek<K>(a.vl, i0, a.n, w1);
  for (int t = 0; t < a.n_ans; ++t) {
    const Df c{a.ch[t * a.c_stride + a.jc], a.cl[t * a.c_stride + a.jc]};
    float s0[K], s1[K];
    loadk<K>(a.ans_h + t * a.n, i0, a.n, s0);
    loadk<K>(a.ans_l + t * a.n, i0, a.n, s1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Df sum = df_add(Df{s0[k], s1[k]}, df_mul(c, Df{w0[k], w1[k]}));
      s0[k] = sum.h;
      s1[k] = sum.l;
    }
    storek<K>(a.ans_h + t * a.n, i0, a.n, s0);
    storek<K>(a.ans_l + t * a.n, i0, a.n, s1);
  }
}

// Held array k (0..3: vh, vl, qh, ql of row 0, then v' in 0 and 1),
// element r of this thread.
__device__ __forceinline__ float& held(float* hold, int k, int r) {
  return hold[(k * kDfVec + r) * kThreads + threadIdx.x];
}

// The binary counter of TreeStack with its nodes in shared memory: node
// l, lane r of this thread at stack[(l * 8 + r) * kThreads + threadIdx.x].
__device__ __forceinline__ void push_smem(float* stack, int depth, int m,
                                          float (&x)[kDfVec], float& err) {
  for (int l = 0; l < depth; ++l) {
    float* node = stack + l * kDfVec * kThreads + threadIdx.x;
    if ((m >> l) & 1) {
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        float t;
        two_sum(node[r * kThreads], x[r], x[r], t);
        err = __fadd_rn(err, t);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        node[r * kThreads] = x[r];
      }
      return;
    }
  }
}

// The tree over count (a power of 2) values in buf: index i with i +
// count/2 and so on, in shared memory down to 32 values, then by shuffles
// in warp 0.  The root in thread 0; the errors go to err.  buf is read
// after a barrier.
__device__ float tree_smem(float* buf, int count, float& err) {
  for (int s = count / 2; s >= 32; s >>= 1) {
    for (int i = threadIdx.x; i < s; i += kThreads) {
      float hi, lo;
      two_sum(buf[i], buf[i + s], hi, lo);
      buf[i] = hi;
      err = __fadd_rn(err, lo);
    }
    __syncthreads();
  }
  float y = 0.0f;
  if (threadIdx.x < 32) {
    y = static_cast<int>(threadIdx.x) < count ? buf[threadIdx.x] : 0.0f;
    for (int s = (count < 32 ? count : 32) / 2; s > 0; s >>= 1) {
      const float z = __shfl_down_sync(0xffffffffu, y, s);
      if (static_cast<int>(threadIdx.x) < s) {
        float hi, lo;
        two_sum(y, z, hi, lo);
        y = hi;
        err = __fadd_rn(err, lo);
      }
    }
  }
  return y;
}

// The tree over the block's threads for each lane r (sm[r][t] = thread
// t's x[r]): t with t + 128, 64, 32 in shared memory, then t + 16, ..., 1
// by shuffles in warp r, whose lane 0 writes lane r's root to out[r].  The
// two-sum errors go to err.
__device__ void block_tree8(const float (&x)[kDfVec], float& err,
                            float (*sm)[kThreads], float* out) {
#pragma unroll
  for (int r = 0; r < kDfVec; ++r) {
    sm[r][threadIdx.x] = x[r];
  }
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    for (int it = threadIdx.x; it < kDfVec * s; it += kThreads) {
      const int r = it / s;
      const int t = it - r * s;
      float hi, lo;
      two_sum(sm[r][t], sm[r][t + s], hi, lo);
      sm[r][t] = hi;
      err = __fadd_rn(err, lo);
    }
    __syncthreads();
  }
  const int lane = threadIdx.x & 31;
  float y = sm[threadIdx.x >> 5][lane];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) {
    const float z = __shfl_down_sync(0xffffffffu, y, s);
    if (lane < s) {
      float hi, lo;
      two_sum(y, z, hi, lo);
      y = hi;
      err = __fadd_rn(err, lo);
    }
  }
  if (lane == 0) {
    out[threadIdx.x >> 5] = y;
  }
}

// A block's part of a df reduction: the thread tree over x, the block's 8
// hi partials to part[blockIdx.x * 8 + r] and its error sum to part[8 *
// kDfMaxBlocks + blockIdx.x]; the grid barrier; then every block copies
// the 8*G partials into shared memory (all its loads in flight) and folds
// them in index order (index i with i + 4G first), with the G error
// sums, so every block holds the same df value.  buf holds 8 *
// kDfStepMaxGrid floats.
__device__ Df df_grid_total(const float (&x)[kDfVec], float err,
                            float* part, float* buf, float* smw, Df* bcast) {
  float* part_err = part + kDfVec * kDfMaxBlocks;
  block_tree8(x, err, reinterpret_cast<float(*)[kThreads]>(buf),
              part + blockIdx.x * kDfVec);
  const float block_err = block_reduce(err, smw);
  if (threadIdx.x == 0) {
    part_err[blockIdx.x] = block_err;
  }
  cg::this_grid().sync();
  const int nf = kDfVec * gridDim.x;
  for (int i = threadIdx.x; i < nf / 4; i += kThreads) {
    reinterpret_cast<float4*>(buf)[i] =
        __ldcg(reinterpret_cast<const float4*>(part) + i);
  }
  float e2 = 0.0f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    e2 = __fadd_rn(e2, __ldcg(part_err + i));
  }
  __syncthreads();
  const float root = tree_smem(buf, nf, e2);
  const float total_err = block_reduce(e2, smw);
  if (threadIdx.x == 0) {
    *bcast = fast_two_sum(root, total_err);
  }
  __syncthreads();
  return *bcast;
}

// Row 5c in one launch: the three phases of the file header on the
// element map above.  Row 0's inputs (then v') stay in shared memory when
// `hold`; other rows are re-read in the later phases.  The node stack
// sits in shared memory (rows_log levels), so registers do not grow with
// the depth.  Each array's 8 elements of a row (one 32-byte sector) are
// loaded by back-to-back 16-byte loads: the map puts neighbouring threads
// G sectors apart, and a sector split over two phases of the loop fell
// out of L1 in between.  128 registers, two blocks an SM: faster than 64
// registers and four blocks at every size measured (PERF.md).
__global__ void __launch_bounds__(kThreads, 2)
lanczos_step_df_kernel(DfStepArgs a) {
  __shared__ __align__(16) float buf[kDfVec * kDfStepMaxGrid];
  __shared__ float smw[kWarps];
  __shared__ Df bc;
  extern __shared__ __align__(16) float dyn_f[];
  const int d = a.rows_log;
  float* stack = dyn_f;
  float* hold = dyn_f + d * kDfVec * kThreads;
  const int64_t n = a.n;
  const int rows = 1 << d;
  const Df bp = a.j > 0 ? Df{a.bh[a.j - 1], a.bl[a.j - 1]} : Df{0.0f, 0.0f};

  // phase 1: alpha_j = df_dot(v * mask, q); each array's 8 elements (one
  // 32-byte sector) loaded at once
  float x[kDfVec];
  float err = 0.0f;
  for (int m = 0; m < rows; ++m) {
    const int64_t i0 = df_base(bit_reverse(m, d));
    const bool keep = m == 0 && a.hold != 0;
    float v0[8], v1[8], q0[8], q1[8];
    load_v_df<8>(a, i0, v0, v1);
    loadk<8>(a.qh, i0, n, q0);
    loadk<8>(a.ql, i0, n, q1);
#pragma unroll
    for (int r = 0; r < kDfVec; ++r) {
      if (keep) {
        held(hold, 0, r) = v0[r];
        held(hold, 1, r) = v1[r];
        held(hold, 2, r) = q0[r];
        held(hold, 3, r) = q1[r];
      }
      float e;
      x[r] = dot_term(Df{v0[r], v1[r]}, Df{q0[r], q1[r]}, e);
      if (i0 + r < n) {
        err = __fadd_rn(err, e);
      } else {
        x[r] = 0.0f;
      }
    }
    push_smem(stack, d, m, x, err);
  }
  const Df al = df_grid_total(x, err, a.part1, buf, smw, &bc);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.ah[a.j] = al.h;
    a.al[a.j] = al.l;
  }

  // phase 2: v' = df_update(v, q, q_prev), beta_j = df_norm(v'); v' kept
  // only for the held row (phase 3 recomputes the rest)
  err = 0.0f;
  for (int m = 0; m < rows; ++m) {
    const int64_t i0 = df_base(bit_reverse(m, d));
    const bool keep = m == 0 && a.hold != 0;
    float v0[8], v1[8], q0[8], q1[8], p0[8], p1[8];
    loadk<8>(a.ph, i0, n, p0);
    loadk<8>(a.pl, i0, n, p1);
    if (keep) {
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        v0[r] = held(hold, 0, r);
        v1[r] = held(hold, 1, r);
        q0[r] = held(hold, 2, r);
        q1[r] = held(hold, 3, r);
      }
    } else {
      load_v_df<8>(a, i0, v0, v1);
      loadk<8>(a.qh, i0, n, q0);
      loadk<8>(a.ql, i0, n, q1);
    }
#pragma unroll
    for (int r = 0; r < kDfVec; ++r) {
      const Df w = df_update(Df{v0[r], v1[r]}, Df{q0[r], q1[r]},
                             Df{p0[r], p1[r]}, al, bp);
      if (keep) {
        held(hold, 0, r) = w.h;
        held(hold, 1, r) = w.l;
      }
      float e;
      x[r] = dot_term(w, w, e);
      if (i0 + r < n) {
        err = __fadd_rn(err, e);
      } else {
        x[r] = 0.0f;
      }
    }
    push_smem(stack, d, m, x, err);
  }
  const Df b = df_sqrt(df_grid_total(x, err, a.part2, buf, smw, &bc));
  const bool ok = b.h > 0.0f;
  const Df inv = df_div(Df{1.0f, 0.0f}, ok ? b : Df{1.0f, 0.0f});
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.bh[a.j] = b.h;
    a.bl[a.j] = b.l;
  }

  // phase 3: q_{j+1} = where(ok, df_scale(1/beta, v'), 0) over v, and for
  // each of n_ans answers ans_m = df_add(ans_m, df_scale(c_m, q_{j+1}))
  // with c_m = coeff[m * c_stride + jc].  It needs no reduction, so past
  // the held row (elements [0, G * 2048)) it leaves the tree's element map
  // for a grid-stride one whose warps read and write contiguous memory,
  // recomputing v' from v, q_j and q_{j-1}.
  if (a.hold != 0) {
    const int64_t i0 = df_base(0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float w0[4], w1[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        w0[k] = held(hold, 0, 4 * hf + k);
        w1[k] = held(hold, 1, 4 * hf + k);
      }
      df_finish<4>(a, i0 + 4 * hf, w0, w1, inv, ok);
    }
  }
  const int64_t start = a.hold != 0
      ? static_cast<int64_t>(gridDim.x) * kDfSpan : 0;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * 4;
  for (int64_t i0 = start + (static_cast<int64_t>(blockIdx.x) * kThreads +
                             threadIdx.x) * 4;
       i0 < n; i0 += step) {
    float w0[4], w1[4], q0[4], q1[4], p0[4], p1[4];
    load_v_df<4>(a, i0, w0, w1);
    loadk<4>(a.qh, i0, n, q0);
    loadk<4>(a.ql, i0, n, q1);
    loadk<4>(a.ph, i0, n, p0);
    loadk<4>(a.pl, i0, n, p1);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Df w = df_update(Df{w0[k], w1[k]}, Df{q0[k], q1[k]},
                             Df{p0[k], p1[k]}, al, bp);
      w0[k] = w.h;
      w1[k] = w.l;
    }
    df_finish<4>(a, i0, w0, w1, inv, ok);
  }
}

// ------------------------------------------------------------- row 5d
// The per-shard passes of the row-sharded loops (dist/mesh.py): the step
// split where the reference psums, one dependent launch a pass a shard.
// A reducing pass (the dot, the update's norm, the sub-norm) ends in the
// shard's partial written to its slot, slots[shard] of an (n_shards,)
// buffer; the pass that consumes the sum folds every slot itself, in
// shard order, in its prologue (fold_slots: Mesh.psum's left fold, the
// same adds, from the slots staged in shared memory), so no op runs
// between a step's passes.  V values a thread
// an iteration: 16-byte vectors (V = 16 / sizeof(T)) when every vector is
// 16-byte aligned, else one value (V = 1; the ELL/COO shards' rows are
// any length).  With `early`, a thread's first chunk of the inputs that
// the loops never write just before the pass (q, q_{j-1}, the mask; v in
// the update pass, and in the normalize pass when several shards share
// the stream) is loaded before grid_dep_wait(); the grid-stride loop
// starts at the thread's second chunk.

// chunk c (V values); a mask chunk of V = 2 or 1 floats.  Float chunks
// load with ld.global.ca: the plain load of a const __restrict__ float4
// took 26.8 against 20.7 us for one shard's step at 2^21 on the H100,
// while plain loads served the double chunks better (51.8 against 59.7
// us) and the df passes alike (eval/step_tiers.py --sharded; PERF.md).
__device__ __forceinline__ void ldv(const float* p, int64_t c,
                                    float (&e)[4]) {
  const float4 v = __ldca(reinterpret_cast<const float4*>(p) + c);
  e[0] = v.x;
  e[1] = v.y;
  e[2] = v.z;
  e[3] = v.w;
}
__device__ __forceinline__ void ldv(const double* p, int64_t c,
                                    double (&e)[2]) {
  load(p, c, e);
}
__device__ __forceinline__ void ldv(const float* p, int64_t c,
                                    float (&e)[2]) {
  const float2 v = reinterpret_cast<const float2*>(p)[c];
  e[0] = v.x;
  e[1] = v.y;
}
template <typename T>
__device__ __forceinline__ void ldv(const T* p, int64_t c, T (&e)[1]) {
  e[0] = p[c];
}

template <typename T, int V>
__device__ __forceinline__ void stv(T* p, int64_t c, const T (&e)[V]) {
  if constexpr (V == 1) {
    p[c] = e[0];
  } else {
    store(p, c, e);
  }
}

// v times the float 0/1 mask (exact)
template <typename T, int V>
__device__ __forceinline__ void apply_mask(T (&x)[V], const float (&m)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    x[i] = mul_rn(x[i], static_cast<T>(m[i]));
  }
}

// The sum of n_shards slots in shard order, as Mesh.psum's left fold
// adds them: ((s0 + s1) + s2) + ...  `Ld` reads slot i.
template <typename T, typename Ld>
__device__ __forceinline__ T left_fold(int n_shards, Ld ld) {
  T acc = ld(0);
  for (int i = 1; i < n_shards; ++i) {
    acc = add_rn(acc, ld(i));
  }
  return acc;
}

// The folds of a's and b's n_shards slots (b may be null), in every
// thread.  Read slot by slot, each fold would wait on one L2 round trip a
// shard; so the block's first threads stage both sets of slots in shared
// memory in one round trip, and every thread folds them from there (slot
// by slot from the L2 only when they do not fit).
template <typename T>
__device__ void fold_slots(const T* a, const T* b, int n_shards, T& fa,
                           T& fb) {
  __shared__ T sm[kThreads];
  const int t = threadIdx.x;
  if (2 * n_shards > kThreads) {
    fa = left_fold<T>(n_shards, [&](int i) { return __ldcg(a + i); });
    if (b != nullptr) {
      fb = left_fold<T>(n_shards, [&](int i) { return __ldcg(b + i); });
    }
    return;
  }
  if (t < n_shards) {
    sm[t] = __ldcg(a + t);
  } else if (b != nullptr && t < 2 * n_shards) {
    sm[t] = __ldcg(b + t - n_shards);
  }
  __syncthreads();
  fa = left_fold<T>(n_shards, [&](int i) { return sm[i]; });
  if (b != nullptr) {
    fb = left_fold<T>(n_shards, [&](int i) { return sm[n_shards + i]; });
  }
}

// This thread's chunks: c = g, g + stride, ... below n / V.
struct ShardIter {
  int64_t nv, stride, g;
  __device__ ShardIter(int64_t n, int v)
      : nv(n / v),
        stride(static_cast<int64_t>(gridDim.x) * kThreads),
        g(static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) {}
  // the index of this thread's one tail element past the whole chunks,
  // or -1
  __device__ int64_t tail(int64_t n, int v) const {
    return v > 1 && g < n - nv * v ? nv * v + g : -1;
  }
};

// One chunk of the dot pass: acc += <x * m, y> (m when masked).
template <typename T, int V>
__device__ __forceinline__ void dot_chunk(T (&x)[V], const T (&y)[V],
                                          const float (&m)[V], bool masked,
                                          T& acc) {
  if (masked) {
    apply_mask(x, m);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    acc = fma_rn(x[e], y[e], acc);
  }
}

// dot pass: *out = the shard's <v * mask, q>
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
shard_dot_kernel(const T* __restrict__ v, const float* __restrict__ mask,
                 const T* __restrict__ q, int64_t n, T* out, T* part,
                 unsigned int* counter, int early) {
  const ShardIter it(n, V);
  const bool masked = mask != nullptr;
  const bool first = it.g < it.nv;
  T y0[V];
  float m0[V];
  if (early != 0 && first) {
    ldv(q, it.g, y0);
    if (masked) {
      ldv(mask, it.g, m0);
    }
  }
  grid_dep_wait();
  grid_dep_launch();
  T acc = T(0);
  if (first) {
    if (early == 0) {
      ldv(q, it.g, y0);
      if (masked) {
        ldv(mask, it.g, m0);
      }
    }
    T x[V];
    ldv(v, it.g, x);
    dot_chunk(x, y0, m0, masked, acc);
  }
  for (int64_t c = it.g + it.stride; c < it.nv; c += it.stride) {
    T x[V], y[V];
    float m[V];
    ldv(q, c, y);
    if (masked) {
      ldv(mask, c, m);
    }
    ldv(v, c, x);
    dot_chunk(x, y, m, masked, acc);
  }
  const int64_t i = it.tail(n, V);
  if (i >= 0) {
    T xi = v[i];
    if (masked) {
      xi = mul_rn(xi, static_cast<T>(mask[i]));
    }
    acc = fma_rn(xi, q[i], acc);
  }
  T total;
  if (grid_sum(acc, part, counter, total) && threadIdx.x == 0) {
    *out = total;
  }
}

// The update pass's loads of chunk c: v, q, q_{j-1} and (masked) the mask.
template <typename T, int V>
__device__ __forceinline__ void update_loads(const T* v, const float* mask,
                                             const T* q, const T* qp,
                                             int64_t c, T (&x)[V],
                                             T (&y)[V], T (&z)[V],
                                             float (&m)[V]) {
  ldv(v, c, x);
  ldv(q, c, y);
  ldv(qp, c, z);
  if (mask != nullptr) {
    ldv(mask, c, m);
  }
}

// One chunk of the update pass: v' over v at chunk c, acc += ||v'||^2.
template <typename T, int V>
__device__ __forceinline__ void update_chunk(T* v, int64_t c, T (&x)[V],
                                             const T (&y)[V],
                                             const T (&z)[V],
                                             const float (&m)[V],
                                             bool masked, T a, T bp,
                                             T& acc) {
  if (masked) {
    apply_mask(x, m);
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    x[e] = update(x[e], y[e], z[e], a, bp);
    acc = fma_rn(x[e], x[e], acc);
  }
  stv<T, V>(v, c, x);
}

// update pass: v' = (v * mask) - a q - b_prev q_prev over v, a the fold
// of the dot slots and b_prev = sqrt of the fold of the last step's norm
// slots (0 when ss_prev is null); alpha[j] = a when alpha is not null;
// with out, *out = the shard's ||v'||^2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
shard_update_kernel(T* v, const float* __restrict__ mask,
                    const T* __restrict__ q, const T* __restrict__ qp,
                    int64_t n, const T* a_slots, const T* ss_prev,
                    int n_shards, T* alpha, int j, T* out, T* part,
                    unsigned int* counter, int early) {
  const ShardIter it(n, V);
  const bool masked = mask != nullptr;
  const bool first = it.g < it.nv;
  T x0[V], y0[V], z0[V];
  float m0[V];
  if (early != 0 && first) {
    update_loads(v, mask, q, qp, it.g, x0, y0, z0, m0);
  }
  grid_dep_wait();
  grid_dep_launch();
  T a, ss = T(0);
  fold_slots(a_slots, ss_prev, n_shards, a, ss);
  const T bp = ss_prev != nullptr ? sqrt_rn(ss) : T(0);
  T acc = T(0);
  if (first) {
    if (early == 0) {
      update_loads(v, mask, q, qp, it.g, x0, y0, z0, m0);
    }
    update_chunk(v, it.g, x0, y0, z0, m0, masked, a, bp, acc);
  }
  for (int64_t c = it.g + it.stride; c < it.nv; c += it.stride) {
    T x[V], y[V], z[V];
    float m[V];
    update_loads(v, mask, q, qp, c, x, y, z, m);
    update_chunk(v, c, x, y, z, m, masked, a, bp, acc);
  }
  const int64_t i = it.tail(n, V);
  if (i >= 0) {
    T xi = v[i];
    if (masked) {
      xi = mul_rn(xi, static_cast<T>(mask[i]));
    }
    const T w = update(xi, q[i], qp[i], a, bp);
    v[i] = w;
    acc = fma_rn(w, w, acc);
  }
  if (alpha != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    alpha[j] = a;
  }
  T total;
  if (out != nullptr && grid_sum(acc, part, counter, total) &&
      threadIdx.x == 0) {
    *out = total;
  }
}

// reorthogonalization's pass: v -= w (the GEMVs' result), *out = the
// shard's ||v||^2
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
shard_sub_norm_kernel(T* v, const T* __restrict__ w, int64_t n, T* out,
                      T* part, unsigned int* counter) {
  grid_dep_wait();
  grid_dep_launch();
  const ShardIter it(n, V);
  T acc = T(0);
  for (int64_t c = it.g; c < it.nv; c += it.stride) {
    T x[V], y[V];
    ldv(v, c, x);
    ldv(w, c, y);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      x[e] = sub_rn(x[e], y[e]);
      acc = fma_rn(x[e], x[e], acc);
    }
    stv<T, V>(v, c, x);
  }
  const int64_t i = it.tail(n, V);
  if (i >= 0) {
    const T x = sub_rn(v[i], w[i]);
    v[i] = x;
    acc = fma_rn(x, x, acc);
  }
  T total;
  if (grid_sum(acc, part, counter, total) && threadIdx.x == 0) {
    *out = total;
  }
}

template <typename T, int V>
__device__ __forceinline__ void normalize_chunk(T* v, T* row, int64_t c,
                                                T (&x)[V], bool ok, T b) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    x[e] = ok ? div_rn(x[e], b) : T(0);
  }
  stv<T, V>(v, c, x);
  if (row != nullptr) {
    stv<T, V>(row, c, x);
  }
}

// normalize pass: b = sqrt of the fold of the norm slots, q = b > 0 ?
// v / b : 0 over v and into `row` (if not null); beta[j] = b when beta
// is not null.  With `early` (the caller's word that the kernel just
// before does not write v: several shards' passes in turn on one
// stream), the thread's first chunk of v is loaded before the wait.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
shard_normalize_kernel(T* v, int64_t n, const T* ss, int n_shards, T* beta,
                       int j, T* row, int early) {
  const ShardIter it(n, V);
  const bool first = it.g < it.nv;
  T x0[V];
  if (early != 0 && first) {
    ldv(v, it.g, x0);
  }
  grid_dep_wait();
  grid_dep_launch();
  T sum, unused;
  fold_slots(ss, static_cast<const T*>(nullptr), n_shards, sum, unused);
  const T b = sqrt_rn(sum);
  const bool ok = b > T(0);
  if (first) {
    if (early == 0) {
      ldv(v, it.g, x0);
    }
    normalize_chunk(v, row, it.g, x0, ok, b);
  }
  for (int64_t c = it.g + it.stride; c < it.nv; c += it.stride) {
    T x[V];
    ldv(v, c, x);
    normalize_chunk(v, row, c, x, ok, b);
  }
  const int64_t i = it.tail(n, V);
  if (i >= 0) {
    const T xi = ok ? div_rn(v[i], b) : T(0);
    v[i] = xi;
    if (row != nullptr) {
      row[i] = xi;
    }
  }
  if (beta != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    beta[j] = b;
  }
}

// ------------------------------------------------------------- row 5cd
// Row 5c's step per shard, split likewise.  The dot pass is df_dot_kernel
// on the shard's n_loc elements (df_geometry's map, so its hi word is the
// plain tree's on the shard's slice); the update pass computes v' in the
// same map and reduces ||v'||^2 on the same tree; the normalize pass needs
// no reduction and walks contiguous memory.  Their slots are (hi, lo)
// pairs, slots[2 * shard] and slots[2 * shard + 1] of (n_shards, 2), and a
// consuming pass folds them as _df_allsum does (fold_df_slots, df_fold).

// slot 0's (hi, lo) pair df_added with each later shard's, in shard order;
// `Ld` reads float i of the (n_shards, 2) slots
template <typename Ld>
__device__ __forceinline__ Df df_fold(int n_shards, Ld ld) {
  Df acc{ld(0), ld(1)};
  for (int i = 1; i < n_shards; ++i) {
    acc = df_add(acc, Df{ld(2 * i), ld(2 * i + 1)});
  }
  return acc;
}

// fold_slots for (hi, lo) pairs: the df folds of a's and b's slots (b may
// be null), staged in shared memory in one round trip when they fit
__device__ void fold_df_slots(const float* a, const float* b, int n_shards,
                              Df& fa, Df& fb) {
  __shared__ float sm[kThreads];
  const int t = threadIdx.x;
  const int w = 2 * n_shards;
  if (2 * w > kThreads) {
    fa = df_fold(n_shards, [&](int i) { return __ldcg(a + i); });
    if (b != nullptr) {
      fb = df_fold(n_shards, [&](int i) { return __ldcg(b + i); });
    }
    return;
  }
  if (t < w) {
    sm[t] = __ldcg(a + t);
  } else if (b != nullptr && t < 2 * w) {
    sm[t] = __ldcg(b + t - w);
  }
  __syncthreads();
  fa = df_fold(n_shards, [&](int i) { return sm[i]; });
  if (b != nullptr) {
    fb = df_fold(n_shards, [&](int i) { return sm[w + i]; });
  }
}

// update pass: v' = df_sub(v * mask, df_add(df_mul(a, q), df_mul(b_prev,
// q_prev))) over v, a the fold of the dot slots and b_prev = df_sqrt of
// the fold of the last step's norm slots (0 when ssp is null); (ah,
// al)[j] = a when ah is not null; the shard's df dot of v' with itself to
// (out_h[0], out_l[0]).  With `early`, row 0's v, q, q_prev and mask are
// loaded before the wait.
template <int Depth>
__global__ void __launch_bounds__(kThreads)
df_update_kernel(float* vh, float* vl, const float* __restrict__ mask,
                 const float* __restrict__ qh, const float* __restrict__ ql,
                 const float* __restrict__ ph, const float* __restrict__ pl,
                 int64_t n, int rows_log, const float* a_slots,
                 const float* ssp, int n_shards, float* ah, float* al, int j,
                 float* out_h, float* out_l, int early,
                 unsigned char* work) {
  float v0[kDfVec], v1[kDfVec], q0[kDfVec], q1[kDfVec], p0[kDfVec],
      p1[kDfVec], mk[kDfVec];
  const bool pre = early != 0 && df_base(0) < n;
  if (pre) {
    const int64_t i0 = df_base(0);
    load8(vh, i0, n, v0);
    load8(vl, i0, n, v1);
    load8(qh, i0, n, q0);
    load8(ql, i0, n, q1);
    load8(ph, i0, n, p0);
    load8(pl, i0, n, p1);
    if (mask != nullptr) {
      load8(mask, i0, n, mk);
    }
  }
  grid_dep_wait();
  grid_dep_launch();
  Df a, ss{0.0f, 0.0f};
  fold_df_slots(a_slots, ssp, n_shards, a, ss);
  const Df bp = ssp != nullptr ? df_sqrt(ss) : Df{0.0f, 0.0f};
  TreeStack<kDfVec, Depth> stack;
  float x[kDfVec];
  float err = 0.0f;
  for (int m = 0; m < (1 << rows_log); ++m) {
    const int64_t i0 = df_base(bit_reverse(m, rows_log));
    if (i0 < n) {
      if (!pre || m != 0) {
        load8(vh, i0, n, v0);
        load8(vl, i0, n, v1);
        load8(qh, i0, n, q0);
        load8(ql, i0, n, q1);
        load8(ph, i0, n, p0);
        load8(pl, i0, n, p1);
        if (mask != nullptr) {
          load8(mask, i0, n, mk);
        }
      }
      if (mask != nullptr) {
        mask8(v0, v1, mk);
      }
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        const Df w = df_update(Df{v0[r], v1[r]}, Df{q0[r], q1[r]},
                               Df{p0[r], p1[r]}, a, bp);
        v0[r] = w.h;
        v1[r] = w.l;
        float e;
        x[r] = dot_term(w, w, e);
        if (i0 + r < n) {
          err = __fadd_rn(err, e);
        } else {
          x[r] = 0.0f;
        }
      }
      storek<8>(vh, i0, n, v0);
      storek<8>(vl, i0, n, v1);
    } else {
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        x[r] = 0.0f;
      }
    }
    stack.push(m, x, err);
  }
  if (ah != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    ah[j] = a.h;
    al[j] = a.l;
  }
  df_grid_tree(x, err, out_h, out_l, false, work);
}

// The df normalize pass's loads of 4 elements at i0: v, and ans when
// the recombine folds into it.
__device__ __forceinline__ void df_normalize_loads(
    const float* vh, const float* vl, const float* ans_h, const float* ans_l,
    int64_t i0, int64_t n, float (&w0)[4], float (&w1)[4], float (&s0)[4],
    float (&s1)[4]) {
  loadk<4>(vh, i0, n, w0);
  loadk<4>(vl, i0, n, w1);
  if (ans_h != nullptr) {
    loadk<4>(ans_h, i0, n, s0);
    loadk<4>(ans_l, i0, n, s1);
  }
}

// q = where(ok, df_mul(inv, v), 0) over v's 4 elements at i0, and with
// ans, ans = df_add(ans, df_mul(c, q))
__device__ __forceinline__ void df_normalize_chunk(
    float* vh, float* vl, float* ans_h, float* ans_l, int64_t i0, int64_t n,
    float (&w0)[4], float (&w1)[4], float (&s0)[4], float (&s1)[4], Df inv,
    bool ok, Df c) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const Df q = df_mul(inv, Df{w0[k], w1[k]});
    w0[k] = ok ? q.h : 0.0f;
    w1[k] = ok ? q.l : 0.0f;
  }
  storek<4>(vh, i0, n, w0);
  storek<4>(vl, i0, n, w1);
  if (ans_h != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const Df sum = df_add(Df{s0[k], s1[k]}, df_mul(c, Df{w0[k], w1[k]}));
      s0[k] = sum.h;
      s1[k] = sum.l;
    }
    storek<4>(ans_h, i0, n, s0);
    storek<4>(ans_l, i0, n, s1);
  }
}

// normalize pass: b = df_sqrt of the fold of the norm slots, q =
// where(b > 0, df_mul(df_div(1, b), v'), 0) over v; (bh, bl)[j] = b when
// bh is not null; with ans, ans = df_add(ans, df_mul(coeff[jc], q)).
// `early` as in shard_normalize_kernel (v's and ans's first 4 elements).
__global__ void __launch_bounds__(kThreads)
df_normalize_kernel(float* vh, float* vl, int64_t n, const float* ss,
                    int n_shards, float* bh, float* bl, int j, float* ans_h,
                    float* ans_l, const float* ch, const float* cl, int jc,
                    int early) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * 4;
  const int64_t i00 =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 4;
  const bool first = i00 < n;
  float w0[4], w1[4], s0[4], s1[4];
  if (early != 0 && first) {
    df_normalize_loads(vh, vl, ans_h, ans_l, i00, n, w0, w1, s0, s1);
  }
  grid_dep_wait();
  grid_dep_launch();
  Df total, unused;
  fold_df_slots(ss, nullptr, n_shards, total, unused);
  const Df b = df_sqrt(total);
  const bool ok = b.h > 0.0f;
  const Df inv = df_div(Df{1.0f, 0.0f}, ok ? b : Df{1.0f, 0.0f});
  const Df c = ans_h != nullptr ? Df{ch[jc], cl[jc]} : Df{0.0f, 0.0f};
  if (first) {
    if (early == 0) {
      df_normalize_loads(vh, vl, ans_h, ans_l, i00, n, w0, w1, s0, s1);
    }
    df_normalize_chunk(vh, vl, ans_h, ans_l, i00, n, w0, w1, s0, s1, inv,
                       ok, c);
  }
  for (int64_t i0 = i00 + step; i0 < n; i0 += step) {
    float x0[4], x1[4], t0[4], t1[4];
    df_normalize_loads(vh, vl, ans_h, ans_l, i0, n, x0, x1, t0, t1);
    df_normalize_chunk(vh, vl, ans_h, ans_l, i0, n, x0, x1, t0, t1, inv, ok,
                       c);
  }
  if (bh != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    bh[j] = b.h;
    bl[j] = b.l;
  }
}

// ------------------------------------------------------------- launches

int grid_for(int64_t n, int vec) {
  const int64_t chunks = (n / vec + kThreads - 1) / kThreads;
  return chunks < 1 ? 1 : (chunks > kGrid ? kGrid : static_cast<int>(chunks));
}

template <typename T>
int launch_head(void* v, const void* q, const void* qp, void* alpha,
                void* beta, int64_t n, int j, int norm, void* work,
                cudaStream_t s) {
  const int grid = grid_for(n, Vec<T>::n);
  unsigned char* w = static_cast<unsigned char*>(work);
  unsigned int* counter = reinterpret_cast<unsigned int*>(w);
  T* part = reinterpret_cast<T*>(w + kPartOff);
  step_dot_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(v), static_cast<const T*>(q), n,
      static_cast<T*>(alpha), j, part, counter);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  step_update_kernel<T><<<grid, kThreads, 0, s>>>(
      static_cast<T*>(v), static_cast<const T*>(q),
      static_cast<const T*>(qp), n, static_cast<const T*>(alpha),
      static_cast<T*>(beta), j, norm, part, counter);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_normalize(void* v, void* beta, int64_t n, int j, void* row,
                     void* ans, const void* coeff, int jc, cudaStream_t s) {
  step_normalize_kernel<T><<<grid_for(n, Vec<T>::n), kThreads, 0, s>>>(
      static_cast<T*>(v), n, static_cast<const T*>(beta), j,
      static_cast<T*>(row), static_cast<T*>(ans),
      static_cast<const T*>(coeff), jc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tail(void* v, const void* w, void* beta, int64_t n, int j,
                void* row, void* ans, const void* coeff, int jc, void* work,
                cudaStream_t s) {
  unsigned char* wk = static_cast<unsigned char*>(work);
  step_sub_norm_kernel<T><<<grid_for(n, Vec<T>::n), kThreads, 0, s>>>(
      static_cast<T*>(v), static_cast<const T*>(w), n, static_cast<T*>(beta),
      j, reinterpret_cast<T*>(wk + kPartOff),
      reinterpret_cast<unsigned int*>(wk));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  return launch_normalize<T>(v, beta, n, j, row, ans, coeff, jc, s);
}

// df_norm's grid: P = the padded length (a power of 2, at least kDfSpan),
// G = min(P / kDfSpan, kDfMaxBlocks) blocks, P / (G * kDfSpan) rows.
// False past P = 2^31.  bn1M: P = 2^20, 512 blocks, one row; a 2600^2
// mesh 4,096 blocks, one row; 51M nodes 4,096 blocks, 8 rows.
bool df_geometry(int64_t n, int& blocks, int& rows_log) {
  int64_t p = kDfSpan;
  while (p < n) {
    p <<= 1;
  }
  const int64_t g = p / kDfSpan;
  blocks = g > kDfMaxBlocks ? kDfMaxBlocks : static_cast<int>(g);
  rows_log = 0;
  while ((static_cast<int64_t>(blocks) * kDfSpan << rows_log) < p) {
    ++rows_log;
  }
  return rows_log <= kDfMaxDepth;
}

template <typename T>
struct Id {
  using type = T;
};

// One launch of a pass kernel on `s`, `grid` blocks, as a programmatic
// dependent of the kernel before it on the stream (the attribute
// cudaLaunchAttributeProgrammaticStreamSerialization: it may start once
// that kernel's blocks have all called grid_dep_launch() or exited, and
// waits in grid_dep_wait()).  A refused launch returns its error (cleared)
// and is never retried without the attribute.
template <typename... P>
int launch_pass(void (*fn)(P...), int grid, cudaStream_t s,
                typename Id<P>::type... args) {
  void* ptrs[] = {static_cast<void*>(&args)...};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(fn), ptrs);
  if (err != cudaSuccess) {
    cudaGetLastError();
  }
  return static_cast<int>(err);
}

// the workspace's counter and first partials region, as a pass uses them
template <typename T>
T* part_of(void* work) {
  return reinterpret_cast<T*>(static_cast<unsigned char*>(work) + kPartOff);
}
unsigned int* counter_of(void* work) {
  return static_cast<unsigned int*>(work);
}

// df_dot_kernel on df_geometry's map, its node stack sized to the rows
// (registers only where rows need them)
int launch_df_dot(const float* xh, const float* xl, const float* mask,
                  const float* yh, const float* yl, int64_t n, float* out_h,
                  float* out_l, int root_sqrt, int early, void* work,
                  cudaStream_t s) {
  int blocks, rows_log;
  if (!df_geometry(n, blocks, rows_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* w = static_cast<unsigned char*>(work);
  auto go = [&](auto fn) {
    return launch_pass(fn, blocks, s, xh, xl, mask, yh, yl, n,
                       rows_log, out_h, out_l, root_sqrt, early, w);
  };
  if (rows_log == 0) {
    return go(df_dot_kernel<0>);
  }
  if (rows_log <= 3) {
    return go(df_dot_kernel<3>);
  }
  return go(df_dot_kernel<kDfMaxDepth>);
}

int launch_df_update(float* vh, float* vl, const float* mask,
                     const float* qh, const float* ql, const float* ph,
                     const float* pl, int64_t n, const float* a_slots,
                     const float* ssp, int n_shards, float* ah, float* al,
                     int j, float* out_h, float* out_l, int early,
                     void* work, cudaStream_t s) {
  int blocks, rows_log;
  if (!df_geometry(n, blocks, rows_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* w = static_cast<unsigned char*>(work);
  auto go = [&](auto fn) {
    return launch_pass(fn, blocks, s, vh, vl, mask, qh, ql, ph, pl, n,
                       rows_log, a_slots, ssp, n_shards, ah, al, j, out_h,
                       out_l, early, w);
  };
  if (rows_log == 0) {
    return go(df_update_kernel<0>);
  }
  if (rows_log <= 3) {
    return go(df_update_kernel<3>);
  }
  return go(df_update_kernel<kDfMaxDepth>);
}

// Row 5d's launches: V = Vec<T>::n with `vec`, else 1
template <typename T>
int launch_shard_dot(const void* v, const void* mask, const void* q,
                     void* out, int64_t n, bool vec, int early, void* work,
                     cudaStream_t s) {
  constexpr int W = Vec<T>::n;
  auto go = [&](auto fn) {
    return launch_pass(fn, grid_for(n, vec ? W : 1), s,
                       static_cast<const T*>(v),
                       static_cast<const float*>(mask),
                       static_cast<const T*>(q), n, static_cast<T*>(out),
                       part_of<T>(work), counter_of(work), early);
  };
  return vec ? go(shard_dot_kernel<T, W>) : go(shard_dot_kernel<T, 1>);
}

template <typename T>
int launch_shard_update(void* v, const void* mask, const void* q,
                        const void* qp, const void* a, const void* ss_prev,
                        int n_shards, void* alpha, int j, void* out,
                        int64_t n, bool vec, int early, void* work,
                        cudaStream_t s) {
  constexpr int W = Vec<T>::n;
  auto go = [&](auto fn) {
    return launch_pass(fn, grid_for(n, vec ? W : 1), s,
                       static_cast<T*>(v), static_cast<const float*>(mask),
                       static_cast<const T*>(q), static_cast<const T*>(qp),
                       n, static_cast<const T*>(a),
                       static_cast<const T*>(ss_prev), n_shards,
                       static_cast<T*>(alpha), j, static_cast<T*>(out),
                       part_of<T>(work), counter_of(work), early);
  };
  return vec ? go(shard_update_kernel<T, W>) : go(shard_update_kernel<T, 1>);
}

template <typename T>
int launch_shard_sub_norm(void* v, const void* w, void* out, int64_t n,
                          bool vec, void* work, cudaStream_t s) {
  constexpr int W = Vec<T>::n;
  auto go = [&](auto fn) {
    return launch_pass(fn, grid_for(n, vec ? W : 1), s,
                       static_cast<T*>(v), static_cast<const T*>(w), n,
                       static_cast<T*>(out), part_of<T>(work),
                       counter_of(work));
  };
  return vec ? go(shard_sub_norm_kernel<T, W>) : go(shard_sub_norm_kernel<T, 1>);
}

template <typename T>
int launch_shard_normalize(void* v, const void* ss, int n_shards, void* beta,
                           int j, void* row, int64_t n, bool vec, int early,
                           cudaStream_t s) {
  constexpr int W = Vec<T>::n;
  auto go = [&](auto fn) {
    return launch_pass(fn, grid_for(n, vec ? W : 1), s,
                       static_cast<T*>(v), n, static_cast<const T*>(ss),
                       n_shards, static_cast<T*>(beta), j,
                       static_cast<T*>(row), early);
  };
  return vec ? go(shard_normalize_kernel<T, W>)
             : go(shard_normalize_kernel<T, 1>);
}

// the one-launch row 5 kernel for value_bytes 4 or 8
const void* step_fn(int value_bytes) {
  return value_bytes == 4
      ? reinterpret_cast<const void*>(lanczos_step_kernel<float>)
      : (value_bytes == 8
             ? reinterpret_cast<const void*>(lanczos_step_kernel<double>)
             : nullptr);
}

// Lets fn take all the dynamic shared memory the device's opt-in limit
// leaves beside its static shared memory (past 48 KB a launch needs it).
cudaError_t allow_smem(const void* fn) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes fa;
  if (err == cudaSuccess) {
    err = cudaFuncGetAttributes(&fa, fn);
  }
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        optin - static_cast<int>(fa.sharedSizeBytes));
  }
  return err;
}

// A cooperative launch of fn with one argument: refused (and the error
// cleared, so no later launch check reports it) when the grid cannot be
// co-resident.
int launch_coop(const void* fn, void* arg, int grid, size_t smem,
                cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = allow_smem(fn);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
  }
  void* args[] = {arg};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      fn, dim3(grid), dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) {
    cudaGetLastError();
  }
  return static_cast<int>(err);
}

// the dynamic shared memory of a launch (kernels/lanczos_step.py mirrors
// these): row 5, smem_chunks 16-byte chunks of v and of q a thread; row
// 5c, rows_log node-stack levels and, with hold, row 0's four arrays, 8
// floats a thread each
size_t step_smem(int smem_chunks) {
  return static_cast<size_t>(smem_chunks) * kThreads * 16 * 2;
}
size_t df_step_smem(int rows_log, int hold) {
  return static_cast<size_t>(rows_log + 4 * hold) * kDfVec * kThreads * 4;
}

template <typename T>
int launch_step(void* v, const void* mask, const void* q, const void* qp,
                void* alpha, void* beta, int64_t n, int j, void* row,
                void* ans, const void* coeff, int jc, void* work, int grid,
                int smem_chunks, cudaStream_t s) {
  unsigned char* w = static_cast<unsigned char*>(work);
  StepArgs<T> a{static_cast<T*>(v), static_cast<const float*>(mask),
                static_cast<const T*>(q), static_cast<const T*>(qp),
                static_cast<T*>(alpha), static_cast<T*>(beta),
                static_cast<T*>(row), static_cast<T*>(ans),
                static_cast<const T*>(coeff),
                reinterpret_cast<T*>(w + kPartOff),
                reinterpret_cast<T*>(w + kPartOff + kRegionBytes), n, j, jc,
                smem_chunks};
  return launch_coop(step_fn(sizeof(T)), &a, grid, step_smem(smem_chunks),
                     s);
}

}  // namespace

// The workspace one loop of steps needs (bytes, zeroed once).
extern "C" int tlt_lanczos_step_workspace_bytes() { return kWorkspaceBytes; }

// Blocks of the one-launch kernel that fit an SM (the occupancy
// calculator), or a negative CUDA error: kind 0 row 5 (value_bytes 4 or
// 8), kind 1 row 5c; smem_bytes its dynamic shared memory.
// kernels/lanczos_step.py sizes the grids from it.
extern "C" int tlt_lanczos_step_occupancy(int kind, int value_bytes,
                                          long long smem_bytes) {
  const void* fn = kind == 0
      ? step_fn(value_bytes)
      : (kind == 1 ? reinterpret_cast<const void*>(lanczos_step_df_kernel)
                   : nullptr);
  if (fn == nullptr || smem_bytes < 0) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_smem(fn);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fn, kThreads, static_cast<size_t>(smem_bytes));
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Row 5, one step on `stream` in one cooperative launch of `grid` blocks
// (all co-resident, or the launch is refused), holding 4 (registers) and
// smem_chunks (shared memory) 16-byte chunks of v and q a thread on chip.
// value_bytes 4 (float) or 8 (double); v (times mask, a float 0/1 vector,
// when mask is not null) is read and overwritten with q_{j+1}; alpha[j]
// and beta[j] written; beta[j-1] read (0 at j=0); row (or null) receives
// q_{j+1}; with ans non-null, ans += coeff[jc] * q_{j+1}.  Every vector
// 16-byte aligned.  Returns the launch's CUDA error (0 = launched).
extern "C" int tlt_lanczos_step(void* v, const void* mask, const void* q,
                                const void* q_prev, void* alpha, void* beta,
                                long long n, int j, int value_bytes,
                                void* row, void* ans, const void* coeff,
                                int jc, void* work, int grid,
                                int smem_chunks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || j < 0 || (value_bytes != 4 && value_bytes != 8) ||
      grid < 1 || grid > kMaxGrid || smem_chunks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return value_bytes == 4
      ? launch_step<float>(v, mask, q, q_prev, alpha, beta, n, j, row, ans,
                           coeff, jc, work, grid, smem_chunks, s)
      : launch_step<double>(v, mask, q, q_prev, alpha, beta, n, j, row, ans,
                            coeff, jc, work, grid, smem_chunks, s);
}

// Row 5 with reorthogonalization, before the caller's GEMVs: the dot and
// update passes (no norm).
extern "C" int tlt_lanczos_step_head(void* v, const void* q,
                                     const void* q_prev, void* alpha,
                                     void* beta, long long n, int j,
                                     int value_bytes, void* work,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || j < 0 || (value_bytes != 4 && value_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return value_bytes == 4
      ? launch_head<float>(v, q, q_prev, alpha, beta, n, j, 0, work, s)
      : launch_head<double>(v, q, q_prev, alpha, beta, n, j, 0, work, s);
}

// ... and after them: v -= w with beta[j] = ||v||, then the normalize pass.
extern "C" int tlt_lanczos_step_tail(void* v, const void* w, void* beta,
                                     long long n, int j, int value_bytes,
                                     void* row, void* ans, const void* coeff,
                                     int jc, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || j < 0 || (value_bytes != 4 && value_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return value_bytes == 4
      ? launch_tail<float>(v, w, beta, n, j, row, ans, coeff, jc, work, s)
      : launch_tail<double>(v, w, beta, n, j, row, ans, coeff, jc, work, s);
}

// Row 5c, one df64 step on `stream` in one cooperative launch of `grid`
// blocks (a power of 2, all co-resident) over 2^rows_log rows of the
// element map (grid * 2048 << rows_log >= n), row 0 held in shared memory
// with `hold`.  v (times mask when mask is not null) is read and
// overwritten with q_{j+1}; (ah, al)[j] and (bh, bl)[j] written, (bh,
// bl)[j-1] read (0 at j=0).  With n_ans > 0, ans rows m (n_ans of n
// floats each) += coeff[m * c_stride + jc] * q_{j+1}.  Every vector
// 16-byte aligned.  Returns the launch's CUDA error.
extern "C" int tlt_lanczos_step_df(
    void* vh, void* vl, const void* mask, const void* qh, const void* ql,
    const void* ph, const void* pl, void* ah, void* al, void* bh, void* bl,
    long long n, int j, void* ans_h, void* ans_l, const void* ch,
    const void* cl, int jc, int n_ans, long long c_stride, void* work,
    int grid, int rows_log, int hold, void* stream) {
  if (n < 1 || j < 0 || n_ans < 0 || grid < 1 || grid > kDfStepMaxGrid ||
      (grid & (grid - 1)) != 0 || rows_log < 0 || rows_log > kDfMaxRowsLog ||
      (hold != 0 && hold != 1) ||
      (static_cast<int64_t>(grid) * kDfSpan << rows_log) < n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* w = static_cast<unsigned char*>(work);
  DfStepArgs a{static_cast<float*>(vh), static_cast<float*>(vl),
               static_cast<const float*>(mask), static_cast<const float*>(qh),
               static_cast<const float*>(ql), static_cast<const float*>(ph),
               static_cast<const float*>(pl), static_cast<float*>(ah),
               static_cast<float*>(al), static_cast<float*>(bh),
               static_cast<float*>(bl), static_cast<float*>(ans_h),
               static_cast<float*>(ans_l), static_cast<const float*>(ch),
               static_cast<const float*>(cl),
               reinterpret_cast<float*>(w + kPartOff),
               reinterpret_cast<float*>(w + kPartOff + kRegionBytes), n,
               c_stride, j, jc, n_ans, rows_log, hold};
  return launch_coop(reinterpret_cast<const void*>(lanczos_step_df_kernel),
                     &a, grid, df_step_smem(rows_log, hold),
                     static_cast<cudaStream_t>(stream));
}

// The df64 norm of (xh, xl) (df_norm: df_sqrt of the df_dot tree) into
// (out_h[0], out_l[0]), in one launch on `stream`.
extern "C" int tlt_df_norm(const void* xh, const void* xl, void* out_h,
                           void* out_l, long long n, void* work,
                           void* stream) {
  if (n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* h = static_cast<const float*>(xh);
  const float* l = static_cast<const float*>(xl);
  return launch_df_dot(h, l, nullptr, h, l, n, static_cast<float*>(out_h),
                       static_cast<float*>(out_l), 1, 0, work,
                       static_cast<cudaStream_t>(stream));
}

// ---- row 5d: one pass of one shard on `stream`, value_bytes 4 (float)
// or 8 (double); `vec` 1 when every vector is 16-byte aligned (16-byte
// accesses), else 0.  A reducing pass writes the shard's partial to
// `out` (its slot); a consuming pass folds the n_shards slots of `a`,
// `ss_prev` or `ss` in shard order.  With `early` 1 the pass loads q,
// q_prev and the mask (and in the update pass v) before it waits on the
// kernel before it, which must not write them.  Each returns the launch's
// CUDA error (0 = launched).

namespace {
bool pass_args_ok(long long n, int value_bytes) {
  return n >= 1 && (value_bytes == 4 || value_bytes == 8);
}
}  // namespace

// *out = <v * mask, q> (mask: float 0/1, or null)
extern "C" int tlt_shard_step_dot(const void* v, const void* mask,
                                  const void* q, void* out, long long n,
                                  int value_bytes, int vec, int early,
                                  void* work, void* stream) {
  if (!pass_args_ok(n, value_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_bytes == 4
      ? launch_shard_dot<float>(v, mask, q, out, n, vec, early, work, s)
      : launch_shard_dot<double>(v, mask, q, out, n, vec, early, work, s);
}

// v = v * mask - a q - sqrt(ss) q_prev, a and ss the folds of the n_shards
// slots of a and ss_prev (ss_prev null: 0); alpha[j] = a when alpha is not
// null; *out = ||v||^2 when out is not null
extern "C" int tlt_shard_step_update(void* v, const void* mask,
                                     const void* q, const void* q_prev,
                                     const void* a, const void* ss_prev,
                                     int n_shards, void* alpha, int j,
                                     void* out, long long n, int value_bytes,
                                     int vec, int early, void* work,
                                     void* stream) {
  if (!pass_args_ok(n, value_bytes) || j < 0 || n_shards < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_bytes == 4
      ? launch_shard_update<float>(v, mask, q, q_prev, a, ss_prev, n_shards,
                                   alpha, j, out, n, vec, early, work, s)
      : launch_shard_update<double>(v, mask, q, q_prev, a, ss_prev, n_shards,
                                    alpha, j, out, n, vec, early, work, s);
}

// v -= w; *out = ||v||^2 (reorthogonalization)
extern "C" int tlt_shard_step_sub_norm(void* v, const void* w, void* out,
                                       long long n, int value_bytes, int vec,
                                       void* work, void* stream) {
  if (!pass_args_ok(n, value_bytes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_bytes == 4
      ? launch_shard_sub_norm<float>(v, w, out, n, vec, work, s)
      : launch_shard_sub_norm<double>(v, w, out, n, vec, work, s);
}

// b = sqrt of the fold of the n_shards slots of ss; v = b > 0 ? v / b : 0,
// also into row (if not null); beta[j] = b when beta is not null; with
// `early` 1, v is loaded before the wait (the kernel before must not
// write it)
extern "C" int tlt_shard_step_normalize(void* v, const void* ss,
                                        int n_shards, void* beta, int j,
                                        void* row, long long n,
                                        int value_bytes, int vec, int early,
                                        void* stream) {
  if (!pass_args_ok(n, value_bytes) || j < 0 || n_shards < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return value_bytes == 4
      ? launch_shard_normalize<float>(v, ss, n_shards, beta, j, row, n, vec,
                                      early, s)
      : launch_shard_normalize<double>(v, ss, n_shards, beta, j, row, n, vec,
                                       early, s);
}

// ---- row 5cd: one df64 pass of one shard on `stream`; every vector
// 16-byte aligned; slots of (hi, lo) pairs, `early` as in row 5d.

// (out_h[0], out_l[0]) = df_dot((xh, xl) * mask, (yh, yl)) on df64.py's
// tree over the n elements
extern "C" int tlt_shard_df_dot(const void* xh, const void* xl,
                                const void* mask, const void* yh,
                                const void* yl, void* out_h, void* out_l,
                                long long n, int early, void* work,
                                void* stream) {
  if (n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_df_dot(static_cast<const float*>(xh),
                       static_cast<const float*>(xl),
                       static_cast<const float*>(mask),
                       static_cast<const float*>(yh),
                       static_cast<const float*>(yl), n,
                       static_cast<float*>(out_h), static_cast<float*>(out_l),
                       0, early, work, static_cast<cudaStream_t>(stream));
}

// v = df_sub(v * mask, df_add(df_mul(a, q), df_mul(df_sqrt(ss), q_prev)))
// with a and ss the folds of the n_shards pairs of a_slots and ssp (ssp
// null: 0); (ah, al)[j] = a when ah is not null; (out_h, out_l) = the df
// dot of v with itself
extern "C" int tlt_shard_df_update(
    void* vh, void* vl, const void* mask, const void* qh, const void* ql,
    const void* ph, const void* pl, const void* a_slots, const void* ssp,
    int n_shards, void* ah, void* al, int j, void* out_h, void* out_l,
    long long n, int early, void* work, void* stream) {
  if (n < 1 || j < 0 || n_shards < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_df_update(
      static_cast<float*>(vh), static_cast<float*>(vl),
      static_cast<const float*>(mask), static_cast<const float*>(qh),
      static_cast<const float*>(ql), static_cast<const float*>(ph),
      static_cast<const float*>(pl), n, static_cast<const float*>(a_slots),
      static_cast<const float*>(ssp), n_shards, static_cast<float*>(ah),
      static_cast<float*>(al), j, static_cast<float*>(out_h),
      static_cast<float*>(out_l), early, work,
      static_cast<cudaStream_t>(stream));
}

// b = df_sqrt of the fold of the n_shards pairs of ss; v = where(b > 0,
// df_mul(df_div(1, b), v), 0); (bh, bl)[j] = b when bh is not null; with
// ans_h, ans = df_add(ans, df_mul((ch, cl)[jc], v)); `early` as in
// tlt_shard_step_normalize (v and ans)
extern "C" int tlt_shard_df_normalize(void* vh, void* vl, const void* ss,
                                      int n_shards, void* bh, void* bl,
                                      int j, void* ans_h, void* ans_l,
                                      const void* ch, const void* cl, int jc,
                                      long long n, int early, void* stream) {
  if (n < 1 || j < 0 || jc < 0 || n_shards < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_pass(df_normalize_kernel, grid_for(n, 4),
                     static_cast<cudaStream_t>(stream),
                     static_cast<float*>(vh), static_cast<float*>(vl), n,
                     static_cast<const float*>(ss), n_shards,
                     static_cast<float*>(bh), static_cast<float*>(bl), j,
                     static_cast<float*>(ans_h), static_cast<float*>(ans_l),
                     static_cast<const float*>(ch),
                     static_cast<const float*>(cl), jc, early);
}
