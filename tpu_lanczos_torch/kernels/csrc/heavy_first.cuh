// The dest-chunk order of the CPG and GPG level kernels (spmv_cpg.cu,
// spmv_gpg.cu): dest chunks hold very different tile counts, and a block
// row walks the chunk of its place in the tile-count order, most first,
// so the longest walks start first and do not form the tail.

#pragma once

#include <cstdint>

namespace tlt {

constexpr int kHeavyFirstMax = 64;  // chunks ordered by tile count

// The dest chunk of this block: the chunk in place blockIdx.y when the
// chunks are sorted by tile count, most first (ties by index); blockIdx.y
// itself past kHeavyFirstMax chunks.  Every thread must call it.
__device__ __forceinline__ int heavy_first_chunk(
    const int32_t* __restrict__ counts, int n_chunks) {
  if (n_chunks > kHeavyFirstMax) return static_cast<int>(blockIdx.y);
  __shared__ int chunk;
  const int t = static_cast<int>(threadIdx.x);
  if (t < n_chunks) {
    const int own = counts[t];
    int place = 0;
    for (int j = 0; j < n_chunks; ++j) {
      const int other = counts[j];
      place += other > own || (other == own && j < t);
    }
    if (place == static_cast<int>(blockIdx.y)) chunk = t;
  }
  __syncthreads();
  return chunk;
}

}  // namespace tlt
