// Barabasi-Albert preferential attachment straight to value-free CSR.
//
// A frozen copy of the port's native generator (gc_barabasi and
// build_csr of tpu_lanczos_torch/graphs/native/graphcore.cc), kept here so
// that the benchmark's graphs stay the same whatever the port later does
// to its own copy.  The same seed gives the same graph, array for array,
// as tpu_lanczos_torch.graphs.native.barabasi_albert.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC ba_csr.cc -o libba_csr.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

namespace {

struct CSR {
  int64_t n = 0;
  std::vector<int64_t> indptr;   // n+1
  std::vector<int32_t> indices;  // nnz
};

// complete seed graph on m+1 nodes, then each new node attaches m edges to
// distinct existing nodes, drawn degree-proportionally from the endpoint pool
void barabasi_edges(int64_t n, int64_t m, uint64_t seed,
                    std::vector<int64_t> &src, std::vector<int64_t> &dst) {
  std::mt19937_64 rng(seed);
  const int64_t seed_nodes = m + 1;
  const int64_t seed_edges = m * (m + 1) / 2;
  const int64_t total = seed_edges + (n - seed_nodes) * m;
  src.resize(static_cast<size_t>(total));
  dst.resize(static_cast<size_t>(total));
  std::vector<int64_t> pool(2 * static_cast<size_t>(total));
  int64_t e = 0;
  for (int64_t i = 0; i < seed_nodes; ++i)
    for (int64_t j = i + 1; j < seed_nodes; ++j) {
      src[e] = i; dst[e] = j;
      pool[2 * e] = i; pool[2 * e + 1] = j;
      ++e;
    }
  std::vector<int64_t> targets;
  targets.reserve(static_cast<size_t>(m));
  for (int64_t v = seed_nodes; v < n; ++v) {
    targets.clear();
    while (static_cast<int64_t>(targets.size()) < m) {
      const int64_t t = pool[rng() % static_cast<uint64_t>(2 * e)];
      if (std::find(targets.begin(), targets.end(), t) == targets.end())
        targets.push_back(t);
    }
    for (int64_t i = 0; i < m; ++i) {
      src[e] = v; dst[e] = targets[static_cast<size_t>(i)];
      pool[2 * e] = v; pool[2 * e + 1] = targets[static_cast<size_t>(i)];
      ++e;
    }
  }
}

// both orientations, self-loops dropped, sorted, deduplicated
CSR *build_csr(int64_t n, const std::vector<int64_t> &src,
               const std::vector<int64_t> &dst) {
  std::vector<uint64_t> keys;
  keys.reserve(2 * src.size());
  const uint64_t un = static_cast<uint64_t>(n);
  for (size_t i = 0; i < src.size(); ++i) {
    const int64_t a = src[i], b = dst[i];
    if (a == b) continue;
    keys.push_back(static_cast<uint64_t>(a) * un + static_cast<uint64_t>(b));
    keys.push_back(static_cast<uint64_t>(b) * un + static_cast<uint64_t>(a));
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  auto *h = new CSR;
  h->n = n;
  h->indptr.assign(static_cast<size_t>(n) + 1, 0);
  h->indices.resize(keys.size());
  for (size_t i = 0; i < keys.size(); ++i) {
    h->indptr[keys[i] / un + 1]++;
    h->indices[i] = static_cast<int32_t>(keys[i] % un);
  }
  for (int64_t i = 0; i < n; ++i) h->indptr[i + 1] += h->indptr[i];
  return h;
}

}  // namespace

extern "C" {

// the graph as an opaque handle, or null for bad sizes or no memory
void *lb_barabasi_csr(int64_t n, int64_t m, uint64_t seed) {
  if (m < 1 || n < m + 1) return nullptr;
  try {
    std::vector<int64_t> src, dst;
    barabasi_edges(n, m, seed, src, dst);
    return build_csr(n, src, dst);
  } catch (...) {  // bad_alloc must not unwind through ctypes
    return nullptr;
  }
}

int64_t lb_csr_nnz(void *h) {
  return static_cast<int64_t>(static_cast<CSR *>(h)->indices.size());
}

void lb_csr_fill(void *h, int64_t *indptr, int32_t *indices) {
  auto *c = static_cast<CSR *>(h);
  std::memcpy(indptr, c->indptr.data(), c->indptr.size() * sizeof(int64_t));
  std::memcpy(indices, c->indices.data(), c->indices.size() * sizeof(int32_t));
}

void lb_csr_free(void *h) { delete static_cast<CSR *>(h); }

}  // extern "C"
