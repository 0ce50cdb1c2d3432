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
// - What bounds it.  The block bytes: B * 32 KB, 512 MB at the default
//   16,384 blocks, 0.16 ms at 3.35 TB/s.  The tensor work (about 8.6
//   GFLOP with M padded to 16, twice that for mxu2) is far below the
//   card's bf16 rate.  So the design is a copy pipeline that keeps
//   enough bytes in flight on every SM, with the consumers out of its way.
// - One persistent CTA per SM takes a contiguous run of whole groups of u
//   blocks (the wrapper's partition).  A producer thread streams its
//   blocks into a ring of kStages 32 KB shared-memory stages, each block
//   as two 2-D TMA boxes of 64 columns with the 128-byte swizzle, each
//   stage completing on a full mbarrier; eight consumer warps read a
//   stage and release it on an empty mbarrier, one arrival a warp.  No
//   block-wide barrier per block: a slow warp holds back only the stage
//   it reads.  (The first port: three CTAs an SM, a 2-slot cp.async ring
//   filled by all threads, two __syncthreads() a block.)
// - The tensor-core product is mma.sync m16n8k16 bf16 with a float
//   accumulator.  x's rows are zero-padded from m_rows (<= 16) to 16 and
//   held in registers as A fragments for the whole run; each warp owns 16
//   output columns and, per block, loads its B fragments with one
//   ldmatrix.x4.trans a k-step: the swizzle puts a fragment's eight
//   256-byte-strided rows in eight different bank groups, where the
//   unswizzled block read by wmma conflicted eight ways.  mxu2 issues the
//   second product, against x_lo, into a second accumulator, added to the
//   first once at the end: the tensor cores align a sum to its largest
//   term and drop the bits below, so x_lo's terms, ~2^-9 of x_hi's, keep
//   their precision only in an accumulator of their own scale.  dma adds
//   rows :m_rows of the staged block in float on the CUDA cores, after
//   the whole block was copied, as the TPU kernel DMAs the whole block
//   and touches a row band.
// - Each CTA writes one (16, 128) float partial; probe_reduce_kernel, a
//   second launch, sums the partials in a fixed order (8 interleaved
//   strands a column, then the strands in order), so the result does not
//   depend on scheduling.  dma's sums are integers below 2^24: exact in
//   any order.

#include <atomic>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kLane = 128;
constexpr int kM = 16;                      // mma rows; m_rows <= kM
constexpr int kConsumers = 256;             // 8 warps x 16 output columns
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kBlockBytes = kLane * kLane * 2;  // one bf16 block: 32 KB
constexpr int kHalfBytes = kBlockBytes / 2;     // one 64-column box
constexpr int kStages = 6;                  // 192 KB of blocks in flight
constexpr int kPartial = kM * kLane;        // floats per CTA partial
// the ring, 1024-byte aligned for the 128-byte swizzle
constexpr size_t kSmemBytes = kStages * kBlockBytes + 1024;
constexpr int kStrands = 8;                 // the reduce's strands a column
static_assert(kSmemBytes <= 232448, "the ring fits one SM's shared memory");

enum Variant { kDma = 0, kMxu1 = 1, kMxu2 = 2 };

// Byte offset in a staged block of the 16-byte chunk holding row r,
// columns 8j .. 8j+7: box j / 8, swizzled chunk (j % 8) ^ (r % 8).
__device__ __forceinline__ int chunk_offset(int r, int j) {
  return (j >> 3) * kHalfBytes + r * 128 + (((j & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16;
}

// The A fragments of x's 16 (zero-padded) rows for the 8 k-steps:
// a[kk] = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)} of
// columns kk*16.., g = lane / 4, t = lane % 4.
__device__ __forceinline__ void load_x(const __nv_bfloat16* __restrict__ x,
                                       int m_rows, uint32_t (&a)[8][4]) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  auto at = [&](int r, int c) {
    return r < m_rows ? x[r * kLane + c] : zero;
  };
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int c = kk * 16 + 2 * t;
    a[kk][0] = pack_bf16(at(g, c), at(g, c + 1));
    a[kk][1] = pack_bf16(at(g + 8, c), at(g + 8, c + 1));
    a[kk][2] = pack_bf16(at(g, c + 8), at(g, c + 9));
    a[kk][3] = pack_bf16(at(g + 8, c + 8), at(g + 8, c + 9));
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int kVariant>
__global__ void __launch_bounds__(kThreads)
probe_kernel(const __grid_constant__ CUtensorMap a_map,
             const __nv_bfloat16* __restrict__ xh,
             const __nv_bfloat16* __restrict__ xl,
             float* __restrict__ partial, int n_blocks, int per_cta,
             int m_rows) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t full[kStages], empty[kStages];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  const int tid = static_cast<int>(threadIdx.x);
  const int b0 = static_cast<int>(blockIdx.x) * per_cta;
  const int nb = max(0, min(n_blocks, b0 + per_cta) - b0);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      tlt::mbar_init(&full[s], 1);
      tlt::mbar_init(&empty[s], kConsumers / 32);
    }
    tlt::mbar_fence_init();
  }
  __syncthreads();
  float* mine = partial + static_cast<int64_t>(blockIdx.x) * kPartial;

  if (tid == kConsumers) {  // the producer
    for (int i = 0; i < nb; ++i) {
      const int s = i % kStages;
      if (i >= kStages) tlt::mbar_wait(&empty[s], (i / kStages - 1) & 1);
      uint8_t* buf = ring + s * kBlockBytes;
      const int row = (b0 + i) * kLane;
      tlt::mbar_arrive_expect_tx(&full[s], kBlockBytes);
      tlt::tma_load_2d(buf, &a_map, 0, row, &full[s]);
      tlt::tma_load_2d(buf + kHalfBytes, &a_map, 64, row, &full[s]);
    }
    return;
  }
  if (tid > kConsumers) return;

  const int warp = tid / 32;
  const int lane = tid % 32;
  if (kVariant == kDma) {
    // this thread's chunk: row tid / 16, columns 8 * (tid % 16) ..
    const int r = tid / 16;
    const int j = tid % 16;
    const int off = chunk_offset(r, j);
    float acc[8] = {};
    for (int i = 0; i < nb; ++i) {
      const int s = i % kStages;
      tlt::mbar_wait(&full[s], (i / kStages) & 1);
      if (r < m_rows) {
        const uint4 w =
            *reinterpret_cast<const uint4*>(ring + s * kBlockBytes + off);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[2 * q] += __bfloat162float(
              __ushort_as_bfloat16(static_cast<unsigned short>(ws[q])));
          acc[2 * q + 1] += __bfloat162float(
              __ushort_as_bfloat16(static_cast<unsigned short>(ws[q] >> 16)));
        }
      }
      __syncwarp();
      if (lane == 0) tlt::mbar_arrive(&empty[s]);
    }
    float4* o = reinterpret_cast<float4*>(mine + r * kLane + 8 * j);
    o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    return;
  }

  uint32_t ah[8][4], al[8][4];
  load_x(xh, m_rows, ah);
  if (kVariant == kMxu2) load_x(xl, m_rows, al);
  // two n8 tiles of output columns warp*16 .. warp*16+15
  float acc[2][4] = {}, acc_lo[2][4] = {};
  // ldmatrix row of this thread: matrix q = lane / 8 holds k rows
  // (q % 2) * 8 .. +7 of column chunk 2 * warp + q / 2
  const int q = lane / 8;
  const int kr = (q % 2) * 8 + lane % 8;
  const int jc = 2 * warp + q / 2;
  for (int i = 0; i < nb; ++i) {
    const int s = i % kStages;
    tlt::mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t base = tlt::smem_addr(ring + s * kBlockBytes);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, base + chunk_offset(kk * 16 + kr, jc));
      mma_bf16(acc[0], ah[kk], b[0], b[1]);
      mma_bf16(acc[1], ah[kk], b[2], b[3]);
      if (kVariant == kMxu2) {
        mma_bf16(acc_lo[0], al[kk], b[0], b[1]);
        mma_bf16(acc_lo[1], al[kk], b[2], b[3]);
      }
    }
    __syncwarp();
    if (lane == 0) tlt::mbar_arrive(&empty[s]);
  }
  // C fragment: (g, 2t..2t+1) and (g+8, 2t..) of each n8 tile
  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    if (kVariant == kMxu2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += acc_lo[n][e];
    }
    const int c = warp * 16 + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(mine + g * kLane + c) =
        make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(mine + (g + 8) * kLane + c) =
        make_float2(acc[n][2], acc[n][3]);
  }
}

// out[r, c] = sum over CTAs of partial[cta, r, c] for r < m_rows, 0 for
// m_rows <= r < out_rows.  A block takes 32 columns of out: thread
// (strand, col) sums CTAs strand, strand + 8, ... in order, and the
// strands are then summed in order: a fixed order, whatever the schedule.
__global__ void __launch_bounds__(32 * kStrands)
probe_reduce_kernel(const float* __restrict__ partial,
                    float* __restrict__ out, int n_cta, int m_rows,
                    int out_rows) {
  __shared__ float strands[kStrands][32];
  const int col = static_cast<int>(threadIdx.x) % 32;
  const int strand = static_cast<int>(threadIdx.x) / 32;
  const int e = static_cast<int>(blockIdx.x) * 32 + col;
  float s = 0.0f;
  if (e / kLane < m_rows) {
    for (int c = strand; c < n_cta; c += kStrands) {
      s += partial[static_cast<int64_t>(c) * kPartial + e];
    }
  }
  strands[strand][col] = s;
  __syncthreads();
  if (strand == 0) {
    float t = 0.0f;
#pragma unroll
    for (int k = 0; k < kStrands; ++k) t += strands[k][col];
    out[e] = t;
  }
}

template <int kVariant>
int launch(const CUtensorMap& a_map, const void* xh, const void* xl,
           void* partial, int n_blocks, int per_cta, int n_cta, int m_rows,
           cudaStream_t stream) {
  static std::atomic<uint64_t> smem_raised{0};
  const cudaError_t set = tlt::once_per_device(smem_raised, [] {
    return cudaFuncSetAttribute(probe_kernel<kVariant>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(kSmemBytes));
  });
  if (set != cudaSuccess) return static_cast<int>(set);
  probe_kernel<kVariant><<<n_cta, kThreads, kSmemBytes, stream>>>(
      a_map, static_cast<const __nv_bfloat16*>(xh),
      static_cast<const __nv_bfloat16*>(xl), static_cast<float*>(partial),
      n_blocks, per_cta, m_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the probe on `stream`: a (n_blocks*128, 128) bf16 (16-byte
// aligned), xh and xl (>= m_rows, 128) bf16, partial (n_cta, 16, 128)
// float scratch, out (out_rows, 128) float.  CTA i takes blocks
// [i*per_cta, (i+1)*per_cta).  variant: 0 dma, 1 mxu1, 2 mxu2.  Returns
// the first CUDA error of the two launches (0 = launched).
extern "C" int tlt_mxu_probe(const void* a, const void* xh, const void* xl,
                             void* partial, void* out, int n_blocks,
                             int per_cta, int n_cta, int m_rows, int out_rows,
                             int variant, void* stream) {
  if (n_blocks <= 0 || per_cta <= 0 || n_cta <= 0 ||
      static_cast<int64_t>(per_cta) * n_cta < n_blocks ||
      static_cast<int64_t>(n_blocks) * kLane > INT32_MAX || m_rows <= 0 ||
      m_rows > kM || out_rows < m_rows || out_rows > kM ||
      !tlt::aligned16(a) || !tlt::aligned16(partial)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // a as (n_blocks*128, 128) bf16 in (128, 64) boxes, 128-byte swizzle
  CUtensorMap a_map;
  if (!tlt::encode_2d(&a_map, a, 2, kLane,
                      static_cast<uint64_t>(n_blocks) * kLane, kLane * 2, 64,
                      kLane, CU_TENSOR_MAP_SWIZZLE_128B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (variant == kDma) {
    err = launch<kDma>(a_map, xh, xl, partial, n_blocks, per_cta, n_cta,
                       m_rows, s);
  } else if (variant == kMxu1) {
    err = launch<kMxu1>(a_map, xh, xl, partial, n_blocks, per_cta, n_cta,
                        m_rows, s);
  } else if (variant == kMxu2) {
    err = launch<kMxu2>(a_map, xh, xl, partial, n_blocks, per_cta, n_cta,
                        m_rows, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  probe_reduce_kernel<<<out_rows * kLane / 32, 32 * kStrands, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), n_cta,
      m_rows, out_rows);
  return static_cast<int>(cudaGetLastError());
}
