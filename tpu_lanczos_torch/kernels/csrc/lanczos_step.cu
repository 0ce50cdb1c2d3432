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
// in float or double (row 5), or in df64 pairs of floats (row 5c).  Each
// step is three launches on the caller's stream:
//   1. the dot pass: alpha_j -> alpha[j];
//   2. the update pass: v' written over v, and ||v'|| -> beta[j] (row 5c
//      also 1/beta_j and the breakdown flag, into the workspace);
//   3. the normalize pass: q_{j+1} written over v (and, if asked, into a
//      row of the stored basis, and ans += coeff[jc] * q_{j+1} for the
//      recombine pass).
// With reorthogonalization (row 5 only) the caller runs its two GEMVs
// between passes 2 and 3, and a fourth pass subtracts their result and
// takes the norm: head (1, 2 without the norm), tail (sub+norm, 3).
//
// What bounds it: bytes.  A step must read v, q_j and q_{j-1} and write
// q_{j+1}: 4n values (8n floats in df64).  The three passes move 8n (16n)
// values, half of them from the L2 cache when the vectors fit its 50 MB.
// Each pass streams 16-byte vector loads in a grid sized to the 132 SMs.
//
// Reductions are deterministic: no floating-point atomics.  Each block
// reduces its part in a fixed order and writes one partial; the block that
// arrives last (an integer atomic counter in the workspace) folds the
// partials in index order, writes the scalar and resets the counter.  So
// two runs, and the two passes of the two-pass mode, agree bit for bit.
// Row 5 accumulates in the vector's dtype with fused multiply-adds.
//
// Rounding.  The elementwise arithmetic rounds as the eager torch ops do:
// every add, multiply, divide and square root is written with the _rn
// intrinsics, which nvcc never contracts into a fused multiply-add, so
// given the same scalars q_{j+1} (and v', ans) equal the plain version's
// bit for bit.  Row 5c keeps core/df64.py's forms: the bit-mask split,
// the four-product two_prod, Knuth's two-sum; nothing here may be built
// with -use_fast_math or any flag that reassociates.
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
// order and summed by a binary counter of partial nodes), threads (inside
// the block, in shared memory), then blocks and r (the last block's fold
// over the 8*G partials in index order).  Every level pairs the same
// indices as the plain tree, and two_sum's sum is symmetric, so the hi sum
// equals the plain version's (up to the sign of an all-zero sum below P =
// 2048).  The error terms are summed in the kernel's own fixed order,
// which differs from the plain torch.sum's at second order (df64.py
// _tree_sum_df).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
// row 5: four blocks on each of the H100's 132 SMs, grid-stride
constexpr int kGrid = 4 * 132;
// row 5c's geometry (above): 8 elements a thread a row, at most
// kDfMaxBlocks blocks and 2^kDfMaxDepth rows (P <= 2^31); the fold's
// threads hold at most 8 * kDfMaxBlocks / kThreads = 2^kFoldDepth values
constexpr int kDfVec = 8;
constexpr int kDfSpan = kThreads * kDfVec;
constexpr int kDfMaxBlocks = 4096;
constexpr int kDfMaxDepth = 8;
constexpr int kFoldDepth = 7;

// the workspace: the arrival counter, row 5c's scalars (1/beta hi, lo and
// the breakdown flag), then the partials (row 5: kGrid values; row 5c:
// 8 hi values and one error sum a block)
constexpr int kScalarOff = 64;
constexpr int kPartOff = 256;
constexpr int kWorkspaceBytes = kPartOff + kDfMaxBlocks * (kDfVec + 1) * 4;
static_assert(kGrid * 8 <= kDfMaxBlocks * (kDfVec + 1) * 4,
              "row 5's partials fit the workspace");

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

// The block's sum of x, in a fixed tree order; every thread gets it.
template <typename T>
__device__ T block_sum(T x, T* sm) {
  __syncthreads();
  sm[threadIdx.x] = x;
  __syncthreads();
#pragma unroll
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sm[threadIdx.x] = add_rn(sm[threadIdx.x], sm[threadIdx.x + s]);
    }
    __syncthreads();
  }
  return sm[0];
}

// Every thread's writes are fenced, then the block arrives on the
// counter.  True in every thread of the block that arrives last, which
// then sees every other block's partials.
__device__ bool arrive_last(unsigned int* counter) {
  __shared__ bool last;
  __threadfence();
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
  if (!arrive_last(counter)) {
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

__device__ __forceinline__ void store8(float* p, int64_t i0, int64_t n,
                                       const float (&e)[kDfVec]) {
  if (i0 + kDfVec <= n) {
    *reinterpret_cast<float4*>(p + i0) = make_float4(e[0], e[1], e[2], e[3]);
    *reinterpret_cast<float4*>(p + i0 + 4) =
        make_float4(e[4], e[5], e[6], e[7]);
  } else {
#pragma unroll
    for (int r = 0; r < kDfVec; ++r) {
      if (i0 + r < n) {
        p[i0 + r] = e[r];
      }
    }
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

// What the last block does with a df reduction: mode 0 writes the dot to
// (out_h[j], out_l[j]); mode 1 its df_sqrt; mode 2 the df_sqrt and, in
// the workspace's scalars, 1/beta (df_div of 1 by the guarded beta) and
// the breakdown flag (lanczos_df.py _body_core).
__device__ void df_finish(Df d, int mode, float* out_h, float* out_l, int j,
                          float* scalars) {
  if (mode == 0) {
    out_h[j] = d.h;
    out_l[j] = d.l;
    return;
  }
  const Df b = df_sqrt(d);
  out_h[j] = b.h;
  out_l[j] = b.l;
  if (mode == 2) {
    const bool ok = b.h > 0.0f;
    const Df inv = df_div(Df{1.0f, 0.0f}, ok ? b : Df{1.0f, 0.0f});
    scalars[0] = inv.h;
    scalars[1] = inv.l;
    scalars[2] = ok ? 1.0f : 0.0f;
  }
}

// The tree after the rows: the thread's 8 nodes in x, its error sum in
// err.  Reduces over the block's threads, writes the block's 8 partials
// and its error sum, and lets the last block fold every block's partials
// in index order and finish (df_finish).
__device__ void df_grid_tree(float (&x)[kDfVec], float err, int mode,
                             float* out_h, float* out_l, int j,
                             unsigned char* work) {
  __shared__ float sm[kDfVec][kThreads];
  __shared__ float sm_err[kThreads];
  unsigned int* counter = reinterpret_cast<unsigned int*>(work);
  float* scalars = reinterpret_cast<float*>(work + kScalarOff);
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
  if (!arrive_last(counter)) {
    return;
  }
  // the fold: the tree over the 8*G partials, index i with i + 4G first;
  // thread t holds t + m*tf, summed over m in the binary counter
  const int nf = kDfVec * gridDim.x;
  const int tf = nf < kThreads ? nf : kThreads;
  const int mf = nf / tf;
  const int mf_log = __ffs(mf) - 1;
  float e2 = 0.0f;
  if (threadIdx.x < tf) {
    TreeStack<1, kFoldDepth> stack;
    float y[1] = {0.0f};
    for (int m = 0; m < mf; ++m) {
      y[0] = __ldcg(part + threadIdx.x + bit_reverse(m, mf_log) * tf);
      stack.push(m, y, e2);
    }
    sm[0][threadIdx.x] = y[0];
  }
  smem_tree(sm, 1, tf, e2);
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) {
    e2 = __fadd_rn(e2, __ldcg(part_err + i));
  }
  const float total_err = block_sum(e2, sm_err);
  if (threadIdx.x == 0) {
    df_finish(fast_two_sum(sm[0][0], total_err), mode, out_h, out_l, j,
              scalars);
    *counter = 0u;
  }
}

// Pass 1 of row 5c (and the start vector's norm): df_dot(x, y), finished
// by df_finish's `mode`.
template <int Depth>
__global__ void __launch_bounds__(kThreads)
df_dot_kernel(const float* __restrict__ xh, const float* __restrict__ xl,
              const float* __restrict__ yh, const float* __restrict__ yl,
              int64_t n, int rows_log, float* out_h, float* out_l, int j,
              int mode, unsigned char* work) {
  TreeStack<kDfVec, Depth> stack;
  float x[kDfVec];
  float err = 0.0f;
  for (int m = 0; m < (1 << rows_log); ++m) {
    const int64_t i0 = df_base(bit_reverse(m, rows_log));
    if (i0 < n) {
      float a[kDfVec], b[kDfVec], c[kDfVec], d[kDfVec];
      load8(xh, i0, n, a);
      load8(xl, i0, n, b);
      load8(yh, i0, n, c);
      load8(yl, i0, n, d);
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
  df_grid_tree(x, err, mode, out_h, out_l, j, work);
}

// Pass 2 of row 5c: v' = df_sub(v, df_add(df_scale(a, q), df_scale(b_prev,
// q_prev))) over v, then beta[j] = df_norm(v') and 1/beta[j].
template <int Depth>
__global__ void __launch_bounds__(kThreads)
df_update_kernel(float* vh, float* vl, const float* __restrict__ qh,
                 const float* __restrict__ ql, const float* __restrict__ ph,
                 const float* __restrict__ pl, int64_t n, int rows_log,
                 const float* ah, const float* al, float* bh, float* bl,
                 int j, unsigned char* work) {
  const Df a{ah[j], al[j]};
  const Df bp = j > 0 ? Df{bh[j - 1], bl[j - 1]} : Df{0.0f, 0.0f};
  TreeStack<kDfVec, Depth> stack;
  float x[kDfVec];
  float err = 0.0f;
  for (int m = 0; m < (1 << rows_log); ++m) {
    const int64_t i0 = df_base(bit_reverse(m, rows_log));
    if (i0 < n) {
      float v0[kDfVec], v1[kDfVec], q0[kDfVec], q1[kDfVec], p0[kDfVec],
          p1[kDfVec];
      load8(vh, i0, n, v0);
      load8(vl, i0, n, v1);
      load8(qh, i0, n, q0);
      load8(ql, i0, n, q1);
      load8(ph, i0, n, p0);
      load8(pl, i0, n, p1);
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        const Df w = df_sub(Df{v0[r], v1[r]},
                            df_add(df_mul(a, Df{q0[r], q1[r]}),
                                   df_mul(bp, Df{p0[r], p1[r]})));
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
      store8(vh, i0, n, v0);
      store8(vl, i0, n, v1);
    } else {
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        x[r] = 0.0f;
      }
    }
    stack.push(m, x, err);
  }
  df_grid_tree(x, err, 2, bh, bl, j, work);
}

// Pass 3 of row 5c: q = where(ok, df_scale(1/beta, v'), 0) over v, and
// for each of n_ans answers ans_m = df_add(ans_m, df_scale(c_m, q)) with
// c_m = coeff[m * c_stride + jc] (the recombine pass's accumulation).
__global__ void __launch_bounds__(kThreads)
df_normalize_kernel(float* vh, float* vl, int64_t n,
                    const unsigned char* work, float* ans_h, float* ans_l,
                    const float* ch, const float* cl, int jc, int n_ans,
                    int64_t c_stride) {
  const float* scalars = reinterpret_cast<const float*>(work + kScalarOff);
  const Df inv{scalars[0], scalars[1]};
  const bool ok = scalars[2] != 0.0f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads * kDfVec;
  for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x) * kDfVec;
       i0 < n; i0 += stride) {
    float q0[kDfVec], q1[kDfVec];
    load8(vh, i0, n, q0);
    load8(vl, i0, n, q1);
#pragma unroll
    for (int r = 0; r < kDfVec; ++r) {
      const Df q = df_mul(inv, Df{q0[r], q1[r]});
      q0[r] = ok ? q.h : 0.0f;
      q1[r] = ok ? q.l : 0.0f;
    }
    store8(vh, i0, n, q0);
    store8(vl, i0, n, q1);
    for (int m = 0; m < n_ans; ++m) {
      const Df c{ch[m * c_stride + jc], cl[m * c_stride + jc]};
      float s0[kDfVec], s1[kDfVec];
      load8(ans_h + m * n, i0, n, s0);
      load8(ans_l + m * n, i0, n, s1);
#pragma unroll
      for (int r = 0; r < kDfVec; ++r) {
        const Df s = df_add(Df{s0[r], s1[r]}, df_mul(c, Df{q0[r], q1[r]}));
        s0[r] = s.h;
        s1[r] = s.l;
      }
      store8(ans_h + m * n, i0, n, s0);
      store8(ans_l + m * n, i0, n, s1);
    }
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

// row 5c's grid: P = the padded length (a power of 2, at least kDfSpan),
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

int launch_df_dot(const float* xh, const float* xl, const float* yh,
                  const float* yl, int64_t n, float* out_h, float* out_l,
                  int j, int mode, unsigned char* work, cudaStream_t s) {
  int blocks, rows_log;
  if (!df_geometry(n, blocks, rows_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the node stack sized to the rows: registers only where rows need them
  if (rows_log == 0) {
    df_dot_kernel<0><<<blocks, kThreads, 0, s>>>(xh, xl, yh, yl, n, 0, out_h,
                                                 out_l, j, mode, work);
  } else if (rows_log <= 3) {
    df_dot_kernel<3><<<blocks, kThreads, 0, s>>>(
        xh, xl, yh, yl, n, rows_log, out_h, out_l, j, mode, work);
  } else {
    df_dot_kernel<kDfMaxDepth><<<blocks, kThreads, 0, s>>>(
        xh, xl, yh, yl, n, rows_log, out_h, out_l, j, mode, work);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The workspace one loop of steps needs (bytes, zeroed once).
extern "C" int tlt_lanczos_step_workspace_bytes() { return kWorkspaceBytes; }

// Row 5, one step on `stream`: the dot, update and normalize passes.
// value_bytes 4 (float) or 8 (double); v is overwritten with q_{j+1};
// alpha[j] and beta[j] written; beta[j-1] read (0 at j=0); row (or null)
// receives q_{j+1}; with ans non-null, ans += coeff[jc] * q_{j+1}.  Every
// vector 16-byte aligned.  Returns cudaGetLastError() (0 = launched).
extern "C" int tlt_lanczos_step(void* v, const void* q, const void* q_prev,
                                void* alpha, void* beta, long long n, int j,
                                int value_bytes, void* row, void* ans,
                                const void* coeff, int jc, void* work,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 1 || j < 0 || (value_bytes != 4 && value_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int err = value_bytes == 4
      ? launch_head<float>(v, q, q_prev, alpha, beta, n, j, 1, work, s)
      : launch_head<double>(v, q, q_prev, alpha, beta, n, j, 1, work, s);
  if (err != 0) {
    return err;
  }
  return value_bytes == 4
      ? launch_normalize<float>(v, beta, n, j, row, ans, coeff, jc, s)
      : launch_normalize<double>(v, beta, n, j, row, ans, coeff, jc, s);
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

// Row 5c, one df64 step on `stream`: the dot, update and normalize passes
// on (hi, lo) float vectors.  v is overwritten with q_{j+1}; (ah, al)[j]
// and (bh, bl)[j] written, (bh, bl)[j-1] read (0 at j=0).  With n_ans > 0,
// ans rows m (n_ans of n floats each) += coeff[m * c_stride + jc] *
// q_{j+1}.  Every vector 16-byte aligned.  Returns cudaGetLastError().
extern "C" int tlt_lanczos_step_df(
    void* vh, void* vl, const void* qh, const void* ql, const void* ph,
    const void* pl, void* ah, void* al, void* bh, void* bl, long long n,
    int j, void* ans_h, void* ans_l, const void* ch, const void* cl, int jc,
    int n_ans, long long c_stride, void* work, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int blocks, rows_log;
  if (n < 1 || j < 0 || n_ans < 0 || !df_geometry(n, blocks, rows_log)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned char* w = static_cast<unsigned char*>(work);
  int err = launch_df_dot(static_cast<const float*>(vh),
                          static_cast<const float*>(vl),
                          static_cast<const float*>(qh),
                          static_cast<const float*>(ql), n,
                          static_cast<float*>(ah), static_cast<float*>(al), j,
                          0, w, s);
  if (err != 0) {
    return err;
  }
  auto* v0 = static_cast<float*>(vh);
  auto* v1 = static_cast<float*>(vl);
  auto* q0 = static_cast<const float*>(qh);
  auto* q1 = static_cast<const float*>(ql);
  auto* p0 = static_cast<const float*>(ph);
  auto* p1 = static_cast<const float*>(pl);
  auto* a0 = static_cast<const float*>(ah);
  auto* a1 = static_cast<const float*>(al);
  auto* b0 = static_cast<float*>(bh);
  auto* b1 = static_cast<float*>(bl);
  if (rows_log == 0) {
    df_update_kernel<0><<<blocks, kThreads, 0, s>>>(
        v0, v1, q0, q1, p0, p1, n, 0, a0, a1, b0, b1, j, w);
  } else if (rows_log <= 3) {
    df_update_kernel<3><<<blocks, kThreads, 0, s>>>(
        v0, v1, q0, q1, p0, p1, n, rows_log, a0, a1, b0, b1, j, w);
  } else {
    df_update_kernel<kDfMaxDepth><<<blocks, kThreads, 0, s>>>(
        v0, v1, q0, q1, p0, p1, n, rows_log, a0, a1, b0, b1, j, w);
  }
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) {
    return err;
  }
  df_normalize_kernel<<<grid_for(n, kDfVec), kThreads, 0, s>>>(
      v0, v1, n, w, static_cast<float*>(ans_h), static_cast<float*>(ans_l),
      static_cast<const float*>(ch), static_cast<const float*>(cl), jc, n_ans,
      c_stride);
  return static_cast<int>(cudaGetLastError());
}

// The df64 norm of (xh, xl) (df_norm: df_sqrt of the df_dot tree) into
// (out_h[0], out_l[0]), in one launch on `stream`.
extern "C" int tlt_df_norm(const void* xh, const void* xl, void* out_h,
                           void* out_l, long long n, void* work,
                           void* stream) {
  if (n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* x0 = static_cast<const float*>(xh);
  const float* x1 = static_cast<const float*>(xl);
  return launch_df_dot(x0, x1, x0, x1, n, static_cast<float*>(out_h),
                       static_cast<float*>(out_l), 0, 1,
                       static_cast<unsigned char*>(work),
                       static_cast<cudaStream_t>(stream));
}
