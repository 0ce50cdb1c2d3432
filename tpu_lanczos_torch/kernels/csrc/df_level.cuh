// The folds of a df64 CPG level, done in the threads that write its cells
// (spmv_cpg_shard.cu: a shard's level and a single device's classic
// level; spmv_cpg.cu: the single device's slab level).  They replace the
// eager two-sums and adds between the level launches of the reference's
// double-word SpMV, tpu_lanczos/kernels/spmv_cpg.py::spmv_cpg_df
// (:450-483: the broadcast adds, e = err + lo, the reduce levels' folds
// and the finish), and of its row-sharded form, tpu_lanczos/dist/
// lanczos_df.py::_local_spmv_df (:124-131, :163-166), in their order.
//
// A walk of a level gives each dest cell three sums: kernel 1c's
// compensated sum of the hi stream (acc, err) and kernel 1's plain sum of
// the lo stream (lo).  Every add rounds as written (the _rn intrinsics):
// no flag that contracts or reassociates adds may build a file that
// includes this one.

#pragma once

#include <cstdint>

namespace tlt {

// What a single device's df64 level writes (kernels/spmv_cpg.py,
// _DF_MODES):
// - kDfBcast, a broadcast level: (hi + acc, lo + lo_sum), plain adds onto
//   the level's source (x_hi, x_lo);
// - kDfMain, the main level: (y, e) = (acc, err + lo_sum);
// - kDfReduce, a reduce level, onto its source (y, e): df_fold.
// The main and reduce levels finish the last level of the SpMV: df_finish.
enum DfMode : int { kDfBcast = 0, kDfMain = 1, kDfReduce = 2 };

// y, t = two_sum(y, acc);  e = ((e + t) + err) + lo
__device__ __forceinline__ void df_fold(float& y, float& e, float acc,
                                        float err, float lo) {
  const float sy = __fadd_rn(y, acc);
  const float z = __fsub_rn(sy, y);
  const float t =
      __fadd_rn(__fsub_rn(y, __fsub_rn(sy, z)), __fsub_rn(acc, z));
  y = sy;
  e = __fadd_rn(__fadd_rn(__fadd_rn(e, t), err), lo);
}

// hi, lo = two_sum(y, e), times mask[o] where a mask is given (exact
// 0/1), written at o.  two_sum, not fast_two_sum: after cancellation in
// the hi stream |e| can exceed |y|.
__device__ __forceinline__ void df_finish(float y, float e,
                                          const float* __restrict__ mask,
                                          int64_t o, float* __restrict__ hi_out,
                                          float* __restrict__ lo_out) {
  float hi = __fadd_rn(y, e);
  const float z = __fsub_rn(hi, y);
  float lo = __fadd_rn(__fsub_rn(y, __fsub_rn(hi, z)), __fsub_rn(e, z));
  if (mask != nullptr) {
    const float m = mask[o];
    hi = __fmul_rn(hi, m);
    lo = __fmul_rn(lo, m);
  }
  hi_out[o] = hi;
  lo_out[o] = lo;
}

// Cell o of a single device's df64 level in `mode` from its walk's sums
// and the level's source (src_a, src_b): the broadcast level's pair, or
// (y, e), finished where `finish`.  The outputs are other buffers than
// the source, which other blocks may still be gathering from.
__device__ __forceinline__ void df_level_cell(
    int mode, bool finish, float acc, float err, float lo,
    const float* __restrict__ src_a, const float* __restrict__ src_b,
    const float* __restrict__ mask, int64_t o, float* __restrict__ out_a,
    float* __restrict__ out_b) {
  if (mode == kDfBcast) {
    // the order of kernel 1's base add, base + sum
    out_a[o] = __fadd_rn(src_a[o], acc);
    out_b[o] = __fadd_rn(src_b[o], lo);
    return;
  }
  float y, e;
  if (mode == kDfMain) {
    y = acc;
    e = __fadd_rn(err, lo);
  } else {
    y = src_a[o];
    e = src_b[o];
    df_fold(y, e, acc, err, lo);
  }
  if (finish) {
    df_finish(y, e, mask, o, out_a, out_b);
  } else {
    out_a[o] = y;
    out_b[o] = e;
  }
}

}  // namespace tlt
