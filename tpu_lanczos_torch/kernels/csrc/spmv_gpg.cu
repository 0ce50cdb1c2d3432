// One level of the GPG SpMV on Hopper (sm_90a), bound through ctypes.
//
// Replaces the Pallas TPU kernel tpu_lanczos/kernels/spmv_gpg.py::
// _make_kernel (:46), launched by _run_level (:149, pallas_call :154).
// For dest chunk d, dest lane c and dest row j, over the chunk's tiles t
// in [starts[d], starts[d] + counts[d]) in order:
//
//   r    = l2[t*128 + c, j]                  staging row (uint8)
//   g    = g_ids[t*n_slots + r / g_s]        granule of that row
//   lane = l1[t*sub_s + r, c]                source lane (int8)
//   yt[d*128 + c, j] += x[g*g_s + r % g_s, lane]
//
// from +0.0.  yt is the Pallas kernel's (n_chunks*128, sub_d) output
// layout; spmv_gpg untransposes it in torch, as the reference does.
//
// Why the direct index is exact.  The TPU kernel stages n_slots granule
// windows of x into a (sub_s, 128) buffer, lane-gathers by l1, transposes
// and, for sub_s or sub_d above 128, picks the second gather slab by slab
// with clip and where (:103-119); for every r < sub_s that selects the same
// element as the chain above.  Its clamped padding iterations past
// counts[d] (:58-61, :137-138) add +0.0, which leaves a sum started at
// +0.0 unchanged.  Ghost staging cells hold l1 = 127, a structural zero
// of x (+0.0 or -0.0), and the sum starts at +0.0: in round-to-nearest a
// sum is -0.0 only if both addends are, so it is never -0.0 and adding a
// ghost's zero leaves it unchanged.  So this kernel is bit-identical to
// the interpret run.
//
// Design.
// - What bounds it.  The index bytes: per real tile sub_s*128 B of l1,
//   128*sub_d B of l2 and 4*n_slots B of g_ids (at bn1M, BA n=1M m=10,
//   sub_s=256 and sub_d=512: 96 KB a tile, ~1.08 GB a SpMV), read once per
//   SpMV, plus x and yt.  ~97% of the (tile, dest cell) steps are ghosts.
//   The time goes to the heaviest chunk: the degree-sorted pack puts 4,851
//   of bn1M's 10,910 main-level tiles in chunk 0, and each of its cells
//   walks all of them in order.
// - Work split.  A block owns dest chunk d, a group of kGroup = 16 lanes
//   (16 bytes, TMA's least box width for int8 l1) and kRows = 64 rows; a
//   chunk has 8 lane groups x sub_d/64 row parts (64 blocks at sub_d
//   512).  Each consumer thread owns four cells (one 4-row word of l2).
// - Staging.  Per tile, one producer thread brings the block's share of
//   the index bytes into a ring of kStages shared-memory stages, each
//   completing on an mbarrier: the l2 box (16 lanes x 64 rows) and the
//   l1 box (sub_s rows x 16 lanes), both 2-D TMA boxes, and the tile's
//   g_ids (a 16-byte aligned window, 1-D bulk copy).  The row parts of a
//   lane group need the same l1 box: cs of them (8 at sub_d 512) form a
//   cluster, and each brings sub_s/cs of the box's rows to all of them in
//   one multicast, so an l1 byte leaves L2 once per cluster.  A stage is
//   refilled once every consumer warp of the cluster has read it.
// - Loads in flight.  A thread issues tile i+kAhead's x loads before it
//   adds tile i's values, so kAhead tiles of gathers are in flight and
//   the adds still run in tile order.  r, the lane and the granule come
//   from shared memory; only x is gathered from global memory.
// - Ghosts load x too (at lane 127, one address per lane and tile, so a
//   warp's ghosts share a sector): skipping their load measured slower.
// - Heaviest chunks first (heavy_first.cuh), as in spmv_cpg.cu.
// - The granule DMAs, semaphores and _pick_unroll only scheduled the
//   TPU's VMEM; nothing of them is needed here.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "heavy_first.cuh"
#include "tma.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kGroup = 16;   // dest lanes a block owns
constexpr int kRows = 64;    // dest rows a block owns
constexpr int kConsumers = kGroup * kRows / 4;  // four cells a thread
constexpr int kThreads = kConsumers + 32;       // and one producer warp
constexpr int kMaxCluster = 8;  // row parts sharing l1 boxes (portable)
constexpr int kStages = 8;      // shared-memory ring of tiles
constexpr int kAhead = 8;       // tiles whose x loads are in flight

// Bytes of one stage: the l1 box, the l2 box, the g_ids window.
struct Stage {
  int l2_off, gid_off, bytes;
  __host__ __device__ explicit Stage(int sub_s, int n_slots) {
    l2_off = tlt::align128(sub_s * kGroup);
    gid_off = l2_off + tlt::align128(kGroup * kRows);
    bytes = gid_off + tlt::align128(n_slots * 4 + 16);
  }
};

// CTAs of a cluster: the largest power of two up to kMaxCluster that
// divides a lane group's sub_d / kRows row parts (an even count).
__host__ __device__ constexpr int cluster_size(int sub_d) {
  return (sub_d / kRows & -(sub_d / kRows)) < kMaxCluster
             ? (sub_d / kRows & -(sub_d / kRows))
             : kMaxCluster;
}

// Four consecutive values to a 16-byte aligned address.
__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(double* o, const double (&v)[4]) {
  reinterpret_cast<double2*>(o)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(o)[1] = make_double2(v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gpg_level_kernel(const __grid_constant__ CUtensorMap l1_map,
                 const __grid_constant__ CUtensorMap l2_map,
                 const T* __restrict__ x, const int32_t* __restrict__ g_ids,
                 const int32_t* __restrict__ starts,
                 const int32_t* __restrict__ counts, T* __restrict__ out,
                 int n_chunks, int g_shift, int sub_s, int sub_d) {
  // consumer thread tid owns word tid of the (16, kRows) l2 box: lane
  // tid / (kRows/4), rows 4*(tid % (kRows/4)) + 0..3.  A cluster is cs
  // row parts of one lane group; each CTA brings sub_s / cs of the l1 box
  // rows to all of them.
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t full[kStages], empty[kStages];

  const int n_slots = sub_s >> g_shift;
  const Stage st(sub_s, n_slots);
  const int row_parts = sub_d / kRows;
  const int cs = cluster_size(sub_d);
  const int rank = static_cast<int>(tlt::cluster_rank());
  const int c0 = static_cast<int>(blockIdx.x) / row_parts * kGroup;
  const int j0 = static_cast<int>(blockIdx.x) % row_parts * kRows;
  const int slice = sub_s / cs;  // l1 rows this CTA brings
  const int d = tlt::heavy_first_chunk(counts, n_chunks);
  const int64_t start = starts[d];
  const int count = counts[d];
  const int tid = static_cast<int>(threadIdx.x);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tlt::mbar_init(&full[s], 1);
      // every consumer warp of every CTA of the cluster releases a stage
      tlt::mbar_init(&empty[s], kConsumers / 32 * cs);
    }
    tlt::mbar_fence_init();
  }
  __syncthreads();
  tlt::cluster_sync();  // the cluster's barriers are ready

  if (tid == kConsumers) {  // the producer
    const uint16_t all = static_cast<uint16_t>((1u << cs) - 1);
    for (int i = 0; i < count; ++i) {
      const int s = i % kStages;
      const int use = i / kStages;
      // stage s is free in every CTA of the cluster
      if (use > 0) tlt::mbar_wait(&empty[s], (use - 1) & 1);
      uint8_t* buf = smem + s * st.bytes;
      const int64_t t = start + i;
      const int64_t g0 = t * n_slots * 4;  // byte offset of t's g_ids
      const int64_t ga = g0 & ~int64_t{15};
      const uint32_t gb = static_cast<uint32_t>(
          ((g0 + n_slots * 4 + 15) & ~int64_t{15}) - ga);
      tlt::mbar_arrive_expect_tx(
          &full[s], static_cast<uint32_t>(sub_s * kGroup + kGroup * kRows) +
                        gb);
      tlt::tma_load_2d_multicast(buf + rank * slice * kGroup, &l1_map, c0,
                                 static_cast<int>(t * sub_s) + rank * slice,
                                 &full[s], all);
      tlt::tma_load_2d(buf + st.l2_off, &l2_map, j0,
                       static_cast<int>(t * kLane + c0), &full[s]);
      tlt::bulk_load(buf + st.gid_off,
                     reinterpret_cast<const uint8_t*>(g_ids) + ga, gb,
                     &full[s]);
    }
  } else if (tid < kConsumers) {
    const int lane = tid % 32;
    const int cl = tid / (kRows / 4);
    const int g_mask = (1 << g_shift) - 1;
    // tile i's values for this thread's four cells (+0.0 past the
    // chunk's tiles); the tile's stage is released in every CTA of the
    // cluster once read
    auto fetch = [&](int i, T (&v)[4]) {
      if (i >= count) {
#pragma unroll
        for (int b = 0; b < 4; ++b) v[b] = T(0);
        return;
      }
      const int s = i % kStages;
      tlt::mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* buf = smem + s * st.bytes;
      const uint32_t word =
          reinterpret_cast<const uint32_t*>(buf + st.l2_off)[tid];
      const int32_t* gs =
          reinterpret_cast<const int32_t*>(buf + st.gid_off) +
          (((start + i) * n_slots) & 3);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int r = (word >> (8 * b)) & 0xff;
        const int src_lane = buf[r * kGroup + cl];  // l1 box [sub_s][16]
        const int row = (gs[r >> g_shift] << g_shift) | (r & g_mask);
        v[b] = x[row * kLane + src_lane];
      }
      __syncwarp();
      if (lane < cs) tlt::mbar_arrive_cluster(&empty[s], lane);
    };

    // tile i+u's loads are issued kAhead tiles before its adds, which
    // run in tile order
    T acc[4] = {T(0), T(0), T(0), T(0)};
    T v[kAhead][4];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) fetch(u, v[u]);
    for (int i = 0; i < count; i += kAhead) {
#pragma unroll
      for (int u = 0; u < kAhead; ++u) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[b] += v[u][b];
        fetch(i + u + kAhead, v[u]);
      }
    }
    store4(out + (static_cast<int64_t>(d) * kLane + c0 + cl) * sub_d + j0 +
               tid % (kRows / 4) * 4,
           acc);
  }
  // no CTA leaves while a peer may still arrive on its barriers
  tlt::cluster_sync();
}

template <typename T>
int launch(const void* x, const void* l1, const void* l2, const void* g_ids,
           const void* starts, const void* counts, void* out, int n_chunks,
           int n_tiles, int g_s, int sub_s, int sub_d, cudaStream_t stream) {
  const int cs = cluster_size(sub_d);
  CUtensorMap l1_map, l2_map;
  // l1 (n_tiles*sub_s, 128) int8 in (sub_s/cs, 16) boxes; l2 (n_tiles*128,
  // sub_d) uint8 in (16, kRows) boxes
  if (!tlt::encode_2d(&l1_map, l1, 1, kLane,
                      static_cast<uint64_t>(n_tiles) * sub_s, kLane, kGroup,
                      sub_s / cs) ||
      !tlt::encode_2d(&l2_map, l2, 1, sub_d,
                      static_cast<uint64_t>(n_tiles) * kLane, sub_d, kRows,
                      kGroup)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int g_shift = 0;
  while ((1 << g_shift) < g_s) ++g_shift;
  const int smem = kStages * Stage(sub_s, sub_s / g_s).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gpg_level_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kLane / kGroup * (sub_d / kRows)),
                     static_cast<unsigned>(n_chunks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(cs);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, gpg_level_kernel<T>, l1_map, l2_map, static_cast<const T*>(x),
      static_cast<const int32_t*>(g_ids), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(counts), static_cast<T*>(out), n_chunks,
      g_shift, sub_s, sub_d);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches one GPG level on `stream`.  n_tiles is the level's padded
// tile count (l1 has n_tiles*sub_s rows).  value_bytes is 4 (float) or 8
// (double).  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int tlt_spmv_gpg_level(const void* x, const void* l1,
                                  const void* l2, const void* g_ids,
                                  const void* starts, const void* counts,
                                  void* out, int n_chunks, int n_tiles,
                                  int g_s, int sub_s, int sub_d,
                                  int value_bytes, void* stream) {
  if (n_chunks <= 0 || n_chunks > 65535 || n_tiles <= 0 || g_s <= 0 ||
      (g_s & (g_s - 1)) != 0 || sub_s % g_s != 0 ||
      (sub_s != 128 && sub_s != 256) || sub_d <= 0 || sub_d % kLane != 0 ||
      static_cast<int64_t>(n_tiles) * sub_s > INT_MAX ||
      static_cast<int64_t>(n_chunks) * sub_d * kLane > INT_MAX ||
      !tlt::aligned16(l1) || !tlt::aligned16(l2) || !tlt::aligned16(g_ids) ||
      !tlt::aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (value_bytes == 4) {
    return launch<float>(x, l1, l2, g_ids, starts, counts, out, n_chunks,
                         n_tiles, g_s, sub_s, sub_d, s);
  }
  if (value_bytes == 8) {
    return launch<double>(x, l1, l2, g_ids, starts, counts, out, n_chunks,
                          n_tiles, g_s, sub_s, sub_d, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
