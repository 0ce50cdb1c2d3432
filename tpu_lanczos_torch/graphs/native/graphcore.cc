// graphcore — native graph construction/parsing core for tpu_lanczos.
//
// TPU-native re-design of the reference's host-side graph layer
// (reference: serial/lib/adjMatrix.cc:18-52 set-based .mtx reader,
// serial/lib/make_graph.cc:19-113 generators).  The reference built graphs
// with std::set<Edge> insertion (O(E log E) with poor constants); this core
// uses flat arrays + one sort + linear dedup, and is exposed to Python via
// a plain C ABI consumed with ctypes (no pybind11 dependency).
//
// All functions are single-call, handle-based: build returns an opaque
// handle whose array sizes can be queried and copied out into
// caller-allocated (numpy) buffers.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <thread>
#include <random>
#include <vector>

namespace {

struct CSRHandle {
  int64_t n = 0;
  std::vector<int64_t> indptr;  // n+1
  std::vector<int32_t> indices; // nnz
};

struct EdgeListHandle {
  int64_t n = 0;
  std::vector<int64_t> src;
  std::vector<int64_t> dst;
};

// Build value-free CSR from an undirected edge list: insert both
// orientations, drop self-loops, sort, dedup (the reference's std::set
// semantics, adjMatrix.cc:21-46, done as sort+unique).
CSRHandle *build_csr(int64_t n, int64_t e, const int64_t *src,
                     const int64_t *dst) {
  std::vector<uint64_t> keys;
  keys.reserve(2 * static_cast<size_t>(e));
  const uint64_t un = static_cast<uint64_t>(n);
  for (int64_t i = 0; i < e; ++i) {
    const int64_t a = src[i], b = dst[i];
    if (a == b) continue;  // self-loops dropped (reference semantics)
    // out-of-range endpoints are an error, matching the numpy oracle
    // CSRGraph.from_edges (silent dropping hid corrupt inputs)
    if (a < 0 || b < 0 || a >= n || b >= n) return nullptr;
    keys.push_back(static_cast<uint64_t>(a) * un + static_cast<uint64_t>(b));
    keys.push_back(static_cast<uint64_t>(b) * un + static_cast<uint64_t>(a));
  }
  std::sort(keys.begin(), keys.end());
  keys.erase(std::unique(keys.begin(), keys.end()), keys.end());

  auto *h = new CSRHandle;
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

} // namespace

extern "C" {

// ---------------------------------------------------------------- CSR API

void *gc_csr_from_edges(int64_t n, int64_t e, const int64_t *src,
                        const int64_t *dst) {
  try {
    return build_csr(n, e, src, dst);
  } catch (...) {  // bad_alloc etc. must not unwind through ctypes
    return nullptr;
  }
}

int64_t gc_csr_n(void *h) { return static_cast<CSRHandle *>(h)->n; }
int64_t gc_csr_nnz(void *h) {
  return static_cast<int64_t>(static_cast<CSRHandle *>(h)->indices.size());
}
void gc_csr_fill(void *h, int64_t *indptr, int32_t *indices) {
  auto *c = static_cast<CSRHandle *>(h);
  std::memcpy(indptr, c->indptr.data(), c->indptr.size() * sizeof(int64_t));
  std::memcpy(indices, c->indices.data(), c->indices.size() * sizeof(int32_t));
}
void gc_csr_free(void *h) { delete static_cast<CSRHandle *>(h); }

// ---------------------------------------------------------- .mtx parsing

// Reads the reference's .mtx dialect (parallel-final/lib/adjMatrix.cc:21-46):
// '%' comments, an "n n E" header, then E lines of 1-indexed pairs (a third
// column, if present, is ignored).  Returns an edge-list handle (0-indexed,
// unsymmetrized — CSR construction symmetrizes), or nullptr on error.
static void *parse_mtx_impl(const char *path) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  const long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  if (std::fread(buf.data(), 1, static_cast<size_t>(size), f) !=
      static_cast<size_t>(size)) {
    std::fclose(f);
    return nullptr;
  }
  std::fclose(f);
  buf[static_cast<size_t>(size)] = '\0';

  const char *p = buf.data();
  const char *end = p + size;
  auto skip_ws = [&] {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n'))
      ++p;
  };
  auto skip_line = [&] {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  };
  auto parse_int = [&]() -> int64_t {
    skip_ws();
    bool neg = false;
    if (p < end && *p == '-') { neg = true; ++p; }
    int64_t v = 0;
    while (p < end && *p >= '0' && *p <= '9') v = v * 10 + (*p++ - '0');
    // swallow a fractional part / exponent if the file carries float weights
    if (p < end && *p == '.') { ++p; while (p < end && *p >= '0' && *p <= '9') ++p; }
    if (p < end && (*p == 'e' || *p == 'E')) {
      ++p; if (p < end && (*p == '+' || *p == '-')) ++p;
      while (p < end && *p >= '0' && *p <= '9') ++p;
    }
    return neg ? -v : v;
  };

  auto skip_token = [&] {  // any non-ws run (float/nan/inf weights)
    skip_ws();
    while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n')
      ++p;
  };

  // comments
  skip_ws();
  while (p < end && *p == '%') { skip_line(); skip_ws(); }
  const int64_t n = parse_int();
  const int64_t n2 = parse_int();
  const int64_t declared_e = parse_int();
  // a data line needs >= 4 bytes, so a sane count is bounded by the
  // file size — this also stops a corrupt header's reserve() from
  // throwing bad_alloc (or a >int64 count wrapping negative)
  if (n <= 0 || n != n2 || declared_e < 0 || declared_e > size)
    return nullptr;
  skip_line();

  // detect tokens-per-line from the first data line (2 = pattern, 3 = weighted)
  int cols = 0;
  {
    const char *q = p;
    while (q < end && *q != '\n') {
      while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) ++q;
      if (q < end && *q != '\n') {
        ++cols;
        while (q < end && *q != ' ' && *q != '\t' && *q != '\r' && *q != '\n')
          ++q;
      }
    }
    if (cols < 2) cols = 2;
  }

  auto *h = new EdgeListHandle;
  h->n = n;
  h->src.reserve(static_cast<size_t>(declared_e));
  h->dst.reserve(static_cast<size_t>(declared_e));
  while (true) {
    skip_ws();
    if (p >= end) break;
    if (!(*p >= '0' && *p <= '9')) {
      // malformed token (incl. mid-file '%' comments, which the numpy
      // fallback also rejects): ERROR, never a silently truncated list
      delete h;
      return nullptr;
    }
    const int64_t a = parse_int();
    const int64_t b = parse_int();
    for (int c = 2; c < cols; ++c) skip_token();
    if (a < 1 || b < 1 || a > n || b > n) {  // 1-indexed on disk
      delete h;
      return nullptr;
    }
    h->src.push_back(a - 1);
    h->dst.push_back(b - 1);
  }
  return h;
}

void *gc_parse_mtx(const char *path) {
  try {
    return parse_mtx_impl(path);
  } catch (...) {  // bad_alloc etc. must not unwind through ctypes
    return nullptr;
  }
}

int64_t gc_edges_n(void *h) { return static_cast<EdgeListHandle *>(h)->n; }
int64_t gc_edges_count(void *h) {
  return static_cast<int64_t>(static_cast<EdgeListHandle *>(h)->src.size());
}
void gc_edges_fill(void *h, int64_t *src, int64_t *dst) {
  auto *e = static_cast<EdgeListHandle *>(h);
  std::memcpy(src, e->src.data(), e->src.size() * sizeof(int64_t));
  std::memcpy(dst, e->dst.data(), e->dst.size() * sizeof(int64_t));
}
void gc_edges_free(void *h) { delete static_cast<EdgeListHandle *>(h); }

// ------------------------------------------------------------- generators

// Barabasi-Albert preferential attachment (reference:
// serial/lib/make_graph.cc "barabasi"): complete seed graph on m+1 nodes,
// then each new node attaches m edges to distinct existing nodes with
// probability proportional to degree, via the endpoint-pool trick.
void *gc_barabasi(int64_t n, int64_t m, uint64_t seed) {
  if (m < 1 || n < m + 1) return nullptr;
  std::mt19937_64 rng(seed);
  const int64_t seed_nodes = m + 1;
  const int64_t seed_edges = m * (m + 1) / 2;
  const int64_t total = seed_edges + (n - seed_nodes) * m;

  auto *h = new EdgeListHandle;
  h->n = n;
  h->src.resize(static_cast<size_t>(total));
  h->dst.resize(static_cast<size_t>(total));
  std::vector<int64_t> pool(2 * static_cast<size_t>(total));

  int64_t e = 0;
  for (int64_t i = 0; i < seed_nodes; ++i)
    for (int64_t j = i + 1; j < seed_nodes; ++j) {
      h->src[e] = i; h->dst[e] = j;
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
      h->src[e] = v; h->dst[e] = targets[static_cast<size_t>(i)];
      pool[2 * e] = v; pool[2 * e + 1] = targets[static_cast<size_t>(i)];
      ++e;
    }
  }
  return h;
}

// Uniform-random graph with exactly num_edges distinct undirected edges
// (reference: serial/lib/make_graph.cc "random_adj").
void *gc_uniform(int64_t n, int64_t num_edges, uint64_t seed) {
  if (n < 2 || num_edges < 0 || num_edges > n * (n - 1) / 2) return nullptr;
  std::mt19937_64 rng(seed);
  const uint64_t un = static_cast<uint64_t>(n);
  std::vector<uint64_t> keys;
  keys.reserve(static_cast<size_t>(num_edges) * 2);
  while (true) {
    const int64_t need = num_edges - static_cast<int64_t>(keys.size());
    if (need <= 0) break;
    for (int64_t i = 0; i < need + need / 2 + 16; ++i) {
      const uint64_t a = rng() % un, b = rng() % un;
      if (a == b) continue;
      const uint64_t lo = a < b ? a : b, hi = a < b ? b : a;
      keys.push_back(lo * un + hi);
    }
    std::sort(keys.begin(), keys.end());
    keys.erase(std::unique(keys.begin(), keys.end()), keys.end());
  }
  // deterministic truncation to exactly num_edges via shuffle of the tail
  std::shuffle(keys.begin(), keys.end(), rng);
  keys.resize(static_cast<size_t>(num_edges));

  auto *h = new EdgeListHandle;
  h->n = n;
  h->src.resize(keys.size());
  h->dst.resize(keys.size());
  for (size_t i = 0; i < keys.size(); ++i) {
    h->src[i] = static_cast<int64_t>(keys[i] / un);
    h->dst[i] = static_cast<int64_t>(keys[i] % un);
  }
  return h;
}

} // extern "C"

// ------------------------------------------------------- edge coloring
//
// Proper edge coloring of a bipartite multigraph with Delta colors
// (Konig's theorem, constructive: alternating-path recoloring).  Used by
// the CPG packer's tier assignment (tpu_lanczos/kernels/cpg.py): every
// color class becomes one (128,128) routing tile, so Delta-optimal
// coloring minimizes tile count vs the ~2x-Delta python greedy.
//
// a_ids / b_ids are pre-compacted endpoint ids in [0, n_a) / [0, n_b).
// colors_out[e] receives edge e's color. Returns #colors used, -1 on error.

namespace {

int64_t edge_color_impl(int64_t n_edges, int64_t n_a, int64_t n_b,
                        const int32_t *a_ids, const int32_t *b_ids,
                        int32_t *colors_out, int64_t max_path);

}  // namespace

extern "C" int64_t gc_edge_color(int64_t n_edges, int64_t n_a, int64_t n_b,
                                 const int32_t *a_ids, const int32_t *b_ids,
                                 int32_t *colors_out) {
  return edge_color_impl(n_edges, n_a, n_b, a_ids, b_ids, colors_out, 0);
}

namespace {

// Konig alternating-path edge coloring.  max_path == 0: exact
// (Delta-optimal; path walks unbounded -- can go superlinear on huge
// dense levels).  max_path > 0: walks are capped at max_path steps; a
// capped insertion falls back to the first color free at BOTH endpoints
// in [0, 2*Delta) (always exists: each endpoint uses < Delta colors).
// Bounded O(E * max_path * Delta_scan) work, measured within ~1-3%% of
// the exact Konig tile count on power-law CPG levels.
int64_t edge_color_impl(int64_t n_edges, int64_t n_a, int64_t n_b,
                        const int32_t *a_ids, const int32_t *b_ids,
                        int32_t *colors_out, int64_t max_path) {
  if (n_edges == 0) return 0;
  // per-node CSR of incident edge ids
  std::vector<int64_t> a_ptr(static_cast<size_t>(n_a) + 1, 0);
  std::vector<int64_t> b_ptr(static_cast<size_t>(n_b) + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    a_ptr[a_ids[e] + 1]++;
    b_ptr[b_ids[e] + 1]++;
  }
  int64_t delta = 0;
  for (int64_t i = 0; i < n_a; ++i) {
    delta = std::max(delta, a_ptr[i + 1]);
    a_ptr[i + 1] += a_ptr[i];
  }
  for (int64_t i = 0; i < n_b; ++i) {
    delta = std::max(delta, b_ptr[i + 1]);
    b_ptr[i + 1] += b_ptr[i];
  }
  std::vector<int64_t> a_adj(static_cast<size_t>(n_edges));
  std::vector<int64_t> b_adj(static_cast<size_t>(n_edges));
  {
    std::vector<int64_t> ca(a_ptr.begin(), a_ptr.end() - 1);
    std::vector<int64_t> cb(b_ptr.begin(), b_ptr.end() - 1);
    for (int64_t e = 0; e < n_edges; ++e) {
      a_adj[static_cast<size_t>(ca[a_ids[e]]++)] = e;
      b_adj[static_cast<size_t>(cb[b_ids[e]]++)] = e;
    }
  }

  const int64_t cap_colors = max_path > 0 ? 2 * delta : delta;
  const int64_t words = (cap_colors + 63) / 64;
  std::vector<uint64_t> a_used(static_cast<size_t>(n_a) * words, 0);
  std::vector<uint64_t> b_used(static_cast<size_t>(n_b) * words, 0);
  std::fill(colors_out, colors_out + n_edges, -1);

  auto first_free = [&](const uint64_t *m) -> int64_t {
    for (int64_t w = 0; w < words; ++w)
      if (~m[w]) {
        const int64_t c = w * 64 + __builtin_ctzll(~m[w]);
        if (c < delta) return c;
      }
    return -1;
  };
  auto first_free_common = [&](const uint64_t *ma, const uint64_t *mb,
                               int64_t limit) -> int64_t {
    for (int64_t w = 0; w < words; ++w) {
      const uint64_t f = ~(ma[w] | mb[w]);
      if (f) {
        const int64_t c = w * 64 + __builtin_ctzll(f);
        if (c < limit) return c;
      }
    }
    return -1;
  };
  auto set_bit = [&](uint64_t *m, int64_t c, bool v) {
    if (v) m[c / 64] |= 1ull << (c % 64);
    else   m[c / 64] &= ~(1ull << (c % 64));
  };
  auto edge_at_a = [&](int64_t v, int64_t c) -> int64_t {
    for (int64_t i = a_ptr[v]; i < a_ptr[v + 1]; ++i) {
      const int64_t e2 = a_adj[static_cast<size_t>(i)];
      if (colors_out[e2] == c) return e2;
    }
    return -1;
  };
  auto edge_at_b = [&](int64_t v, int64_t c) -> int64_t {
    for (int64_t i = b_ptr[v]; i < b_ptr[v + 1]; ++i) {
      const int64_t e2 = b_adj[static_cast<size_t>(i)];
      if (colors_out[e2] == c) return e2;
    }
    return -1;
  };

  std::vector<int64_t> path;
  for (int64_t e = 0; e < n_edges; ++e) {
    const int64_t va = a_ids[e], vb = b_ids[e];
    uint64_t *ma = &a_used[static_cast<size_t>(va) * words];
    uint64_t *mb = &b_used[static_cast<size_t>(vb) * words];
    int64_t c = first_free_common(ma, mb, delta);
    if (c < 0) {
      // alpha free at a (used at b); beta free at b (used at a).
      // The alpha/beta alternating path from b never reaches a (bipartite:
      // arrival at an A-node is via an alpha edge, and a has none), so
      // swapping colors along it frees alpha at b.
      const int64_t alpha = first_free(ma);
      const int64_t beta = first_free(mb);
      if (alpha < 0 || beta < 0) return -1;
      path.clear();
      bool on_b = true;
      int64_t node = vb;
      int64_t want = alpha;
      bool capped = false;
      while (true) {
        const int64_t f = on_b ? edge_at_b(node, want) : edge_at_a(node, want);
        if (f < 0) break;
        if (max_path > 0 &&
            static_cast<int64_t>(path.size()) >= max_path) {
          capped = true;
          break;
        }
        path.push_back(f);
        node = on_b ? a_ids[f] : b_ids[f];
        on_b = !on_b;
        want = (want == alpha) ? beta : alpha;
      }
      if (capped) {
        // leave existing colors untouched; take an overflow color free
        // at both endpoints (exists below 2*Delta)
        c = first_free_common(ma, mb, cap_colors);
        if (c < 0) return -1;
        colors_out[e] = static_cast<int32_t>(c);
        set_bit(ma, c, true);
        set_bit(mb, c, true);
        continue;
      }
      for (const int64_t f : path) {
        const int64_t old_c = colors_out[f];
        const int64_t new_c = (old_c == alpha) ? beta : alpha;
        set_bit(&a_used[static_cast<size_t>(a_ids[f]) * words], old_c, false);
        set_bit(&a_used[static_cast<size_t>(a_ids[f]) * words], new_c, true);
        set_bit(&b_used[static_cast<size_t>(b_ids[f]) * words], old_c, false);
        set_bit(&b_used[static_cast<size_t>(b_ids[f]) * words], new_c, true);
        colors_out[f] = static_cast<int32_t>(new_c);
      }
      c = alpha;
    }
    colors_out[e] = static_cast<int32_t>(c);
    set_bit(ma, c, true);
    set_bit(mb, c, true);
  }
  int64_t used = 0;
  for (int64_t e = 0; e < n_edges; ++e)
    used = std::max<int64_t>(used, colors_out[e] + 1);
  return used;
}

// LSD radix argsort of non-negative int64 keys (16-bit digits, skipping
// digit positions where all keys agree).  ~5x the throughput of a
// comparator std::sort over index indirection at the 20-70M sizes the
// packer runs at.
void radix_argsort(int64_t n, const int64_t *keys, std::vector<int64_t> &order) {
  // sort (key, index) pairs so every pass streams sequentially instead of
  // chasing order[i] -> keys[...] indirections (the cache-miss hot spot).
  // Each 16-bit pass runs parallel per-thread histograms + a stable
  // per-(digit, thread) offset scatter: identical output to the serial
  // LSD sort, ~3x faster on the 4-core host for the 70M-entry levels.
  struct KV { uint64_t k; int64_t v; };
  std::vector<KV> a(static_cast<size_t>(n)), b(static_cast<size_t>(n));
  const int P = static_cast<int>(std::max(
      1u, std::min(4u, std::thread::hardware_concurrency())));
  const auto block = [&](int t) {
    return std::pair<int64_t, int64_t>{n * t / P, n * (t + 1) / P};
  };
  std::vector<uint64_t> ors(static_cast<size_t>(P), 0);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < P; ++t)
      ts.emplace_back([&, t] {
        const auto [lo, hi] = block(t);
        uint64_t o = 0;
        for (int64_t i = lo; i < hi; ++i) {
          a[static_cast<size_t>(i)] = {static_cast<uint64_t>(keys[i]), i};
          o |= static_cast<uint64_t>(keys[i]);
        }
        ors[static_cast<size_t>(t)] = o;
      });
    for (auto &th : ts) th.join();
  }
  uint64_t all_or = 0;
  for (uint64_t o : ors) all_or |= o;

  std::vector<int64_t> hist(static_cast<size_t>(P) << 16);
  for (int shift = 0; shift < 64; shift += 16) {
    if (((all_or >> shift) & 0xffff) == 0) continue;
    std::fill(hist.begin(), hist.end(), 0);
    {
      std::vector<std::thread> ts;
      for (int t = 0; t < P; ++t)
        ts.emplace_back([&, t] {
          const auto [lo, hi] = block(t);
          int64_t *h = hist.data() + (static_cast<size_t>(t) << 16);
          for (int64_t i = lo; i < hi; ++i)
            h[(a[static_cast<size_t>(i)].k >> shift) & 0xffff]++;
        });
      for (auto &th : ts) th.join();
    }
    int64_t acc = 0;
    for (int64_t d = 0; d < (1 << 16); ++d)
      for (int t = 0; t < P; ++t) {
        int64_t &h = hist[(static_cast<size_t>(t) << 16) +
                          static_cast<size_t>(d)];
        const int64_t c = h;
        h = acc;
        acc += c;
      }
    {
      std::vector<std::thread> ts;
      for (int t = 0; t < P; ++t)
        ts.emplace_back([&, t] {
          const auto [lo, hi] = block(t);
          int64_t *h = hist.data() + (static_cast<size_t>(t) << 16);
          for (int64_t i = lo; i < hi; ++i) {
            const KV kv = a[static_cast<size_t>(i)];
            b[static_cast<size_t>(h[(kv.k >> shift) & 0xffff]++)] = kv;
          }
        });
      for (auto &th : ts) th.join();
    }
    a.swap(b);
  }
  order.resize(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    order[static_cast<size_t>(i)] = a[static_cast<size_t>(i)].v;
}

// Sorted-rank compaction of int64 keys into [0, n_uniq); optionally
// collects the sorted unique keys.  Shared by gc_compact_i64 and the
// native CPG level builder.
int64_t compact_impl(int64_t n, const int64_t *keys, int32_t *out_ranks,
                     std::vector<int64_t> *out_uniq) {
  if (n == 0) return 0;
  std::vector<int64_t> order;
  radix_argsort(n, keys, order);
  int64_t rank = -1;
  int64_t prev = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t e = order[static_cast<size_t>(i)];
    if (rank < 0 || keys[e] != prev) {
      ++rank;
      prev = keys[e];
      if (out_uniq) out_uniq->push_back(prev);
    }
    out_ranks[e] = static_cast<int32_t>(rank);
  }
  return rank + 1;
}

}  // namespace

// ------------------------------------------------ native CPG level builder
//
// Full native port of the CPG packer's per-level hot path
// (tpu_lanczos/kernels/cpg.py _build_cpg_level): block keys, endpoint
// compaction, Konig tier coloring, tile compaction, l1/l2 index-tile
// construction including the ghost-dest mex fill.  This was the round-1
// pack-time pathology (84s for the 20M-entry flagship graph in
// numpy; the reference builds the same graph's CSR in seconds,
// serial/lib/adjMatrix.cc:18-52).

namespace {

// O(E) smallest-free-color greedy edge coloring with one inline uint64
// bitmap per endpoint (colors 0-63) and a sparse overflow table for the
// rare hot cells needing more.  Uses <= 2*Delta - 1 colors in theory,
// ~Delta + O(1) on the packer's workloads; chosen over Konig for very
// large levels where the alternating-path walks go superlinear.
int64_t edge_color_greedy_impl(int64_t n_edges, int64_t n_a, int64_t n_b,
                               const int32_t *a_ids, const int32_t *b_ids,
                               int32_t *colors_out) {
  std::vector<uint64_t> a_used(static_cast<size_t>(n_a), 0);
  std::vector<uint64_t> b_used(static_cast<size_t>(n_b), 0);
  // overflow: per node, extra words for colors >= 64 (rare)
  std::vector<std::vector<uint64_t>> a_over, b_over;
  std::vector<int32_t> a_over_id(static_cast<size_t>(n_a), -1);
  std::vector<int32_t> b_over_id(static_cast<size_t>(n_b), -1);
  int64_t used_max = 0;
  for (int64_t e = 0; e < n_edges; ++e) {
    const int32_t a = a_ids[e], b = b_ids[e];
    const uint64_t f0 = ~(a_used[static_cast<size_t>(a)] |
                          b_used[static_cast<size_t>(b)]);
    int64_t c;
    if (f0) {
      c = __builtin_ctzll(f0);
      a_used[static_cast<size_t>(a)] |= 1ull << c;
      b_used[static_cast<size_t>(b)] |= 1ull << c;
    } else {
      // overflow path
      if (a_over_id[static_cast<size_t>(a)] < 0) {
        a_over_id[static_cast<size_t>(a)] =
            static_cast<int32_t>(a_over.size());
        a_over.emplace_back();
      }
      if (b_over_id[static_cast<size_t>(b)] < 0) {
        b_over_id[static_cast<size_t>(b)] =
            static_cast<int32_t>(b_over.size());
        b_over.emplace_back();
      }
      auto &ao = a_over[static_cast<size_t>(a_over_id[static_cast<size_t>(a)])];
      auto &bo = b_over[static_cast<size_t>(b_over_id[static_cast<size_t>(b)])];
      const size_t wmax = std::max(ao.size(), bo.size()) + 1;
      ao.resize(wmax, 0);
      bo.resize(wmax, 0);
      size_t w = 0;
      while (w < wmax && !~(ao[w] | bo[w])) ++w;
      const uint64_t f = ~(ao[w] | bo[w]);
      c = 64 + static_cast<int64_t>(w) * 64 + __builtin_ctzll(f);
      ao[w] |= 1ull << (c % 64);
      bo[w] |= 1ull << (c % 64);
    }
    colors_out[e] = static_cast<int32_t>(c);
    if (c + 1 > used_max) used_max = c + 1;
  }
  return used_max;
}

struct CPGLevelHandle {
  int64_t sub = 0;
  int64_t tiles = 0;
  bool slabm = false;
  std::vector<int32_t> s_ids;  // (T,)
  std::vector<int32_t> d_ids;  // (T,)
  // (T,) per-tile slab-pair occupancy: bit (j * n_slab + si) set iff a
  // real entry routes dest slab j <- staging slab si (classic layout;
  // slab layout uses bit j only).  The kernel skips unset units.
  std::vector<int32_t> mask;
  // retained per-entry routing data: the l1/l2 index tiles are scattered
  // DIRECTLY into the caller's numpy buffers by gc_cpgl_fill (building
  // them here and memcpy'ing out cost an extra ~3.3 GB of traffic and
  // first-touch faults per 70M-entry level)
  std::vector<int32_t> tile_of, ss, rd, ld;
  std::vector<int8_t> sl;
};

}  // namespace

// slab_mode != 0: source-slab-pure tiles (cpg.py layout="slab") —
// block key = (dest chunk, global source slab), l1 is (T*128, 128),
// l2 is uint8 with bit7 flagging ghost dest cells (no mex fill).
extern "C" void *gc_cpg_build_level(int64_t n_entries, int64_t sub,
                                    int64_t slab_mode,
                                    const int64_t *src_pos,
                                    const int64_t *dst_pos) {
  const bool verbose = std::getenv("GC_VERBOSE") != nullptr;
  const auto tick = [] { return std::chrono::steady_clock::now(); };
  auto t0 = tick();
  const auto lap = [&](const char *msg) {
    if (!verbose) return;
    const auto t1 = tick();
    std::fprintf(stderr, "  gc level %s: %.1fs\n", msg,
                 std::chrono::duration<double>(t1 - t0).count());
    t0 = t1;
  };
  const int64_t LANE = 128;
  const int64_t cells = sub * LANE;
  const int64_t n_slab = sub / LANE;
  const bool slabm = slab_mode != 0;
  const int64_t E = n_entries;

  std::vector<int64_t> a_key(static_cast<size_t>(E));
  std::vector<int64_t> b_key(static_cast<size_t>(E));
  std::vector<int32_t> ss(static_cast<size_t>(E));
  std::vector<int8_t> sl(static_cast<size_t>(E));
  std::vector<int32_t> rd(static_cast<size_t>(E));
  std::vector<int32_t> ld(static_cast<size_t>(E));
  const int P = static_cast<int>(std::max(
      1u, std::min(4u, std::thread::hardware_concurrency())));
  const auto blk = [&](int t) {
    return std::pair<int64_t, int64_t>{E * t / P, E * (t + 1) / P};
  };
  // D-major block ordering via COMPACT block ids block = d_chunk * SB +
  // s_comp (same order as cpg.py's d_chunk * 2^32 + s_chunk for
  // s_comp < SB): compact keys need only 2 radix passes instead of 4.
  int64_t max_chunk = 0;
  {
    std::vector<int64_t> maxes(static_cast<size_t>(P), 0);
    std::vector<std::thread> ts;
    for (int t = 0; t < P; ++t)
      ts.emplace_back([&, t] {
        const auto [lo, hi] = blk(t);
        int64_t m = 0;
        for (int64_t e = lo; e < hi; ++e)
          m = std::max({m, src_pos[e] / cells, dst_pos[e] / cells});
        maxes[static_cast<size_t>(t)] = m;
      });
    for (auto &th : ts) th.join();
    for (int64_t m : maxes) max_chunk = std::max(max_chunk, m);
  }
  const int64_t SB = (max_chunk + 1) * (slabm ? n_slab : 1);
  {
    std::vector<std::thread> ts;
    for (int t = 0; t < P; ++t)
      ts.emplace_back([&, t] {
        const auto [lo, hi] = blk(t);
        for (int64_t e = lo; e < hi; ++e) {
          const int64_t sp = src_pos[e], dp = dst_pos[e];
          const int64_t s_chunk = sp / cells;
          const int64_t d_chunk = dp / cells;
          int64_t ss_e = (sp / LANE) % sub;
          const int64_t sl_e = sp % LANE;
          const int64_t rd_e = (dp / LANE) % sub;
          const int64_t ld_e = dp % LANE;
          int64_t block;
          if (slabm) {
            const int64_t slab_g = s_chunk * n_slab + ss_e / LANE;
            ss_e %= LANE;  // sublane within the slab
            block = d_chunk * SB + slab_g;
            a_key[static_cast<size_t>(e)] = block * (LANE * LANE) +
                                            ss_e * LANE + ld_e;
          } else {
            block = d_chunk * SB + s_chunk;
            a_key[static_cast<size_t>(e)] =
                block * cells + ss_e * LANE + ld_e;
          }
          b_key[static_cast<size_t>(e)] = block * cells + rd_e * LANE + ld_e;
          ss[static_cast<size_t>(e)] = static_cast<int32_t>(ss_e);
          sl[static_cast<size_t>(e)] = static_cast<int8_t>(sl_e);
          rd[static_cast<size_t>(e)] = static_cast<int32_t>(rd_e);
          ld[static_cast<size_t>(e)] = static_cast<int32_t>(ld_e);
        }
      });
    for (auto &th : ts) th.join();
  }

  std::vector<int32_t> a_c(static_cast<size_t>(E));
  std::vector<int32_t> b_c(static_cast<size_t>(E));
  const int64_t n_a = compact_impl(E, a_key.data(), a_c.data(), nullptr);
  lap("compact_a");
  const int64_t n_b = compact_impl(E, b_key.data(), b_c.data(), nullptr);
  lap("compact_b");
  a_key.clear(); a_key.shrink_to_fit();

  std::vector<int32_t> tier(static_cast<size_t>(E));
  // Konig (Delta-optimal) for normal sizes; its alternating-path walks go
  // superlinear on the largest power-law levels, where the path-capped
  // variant (bounded walks, rare overflow colors below 2*Delta) keeps
  // near-Delta tile counts at bounded cost.  The pure O(E) greedy used
  // here before cost ~40% extra tiles on the 4M-node packs.
  const bool huge = E > 30'000'000;
  int64_t cap = huge ? 2048 : 0;
  if (const char *s = std::getenv("GC_KONIG_CAP")) cap = std::atoll(s);
  const int64_t rc = edge_color_impl(E, n_a, n_b, a_c.data(), b_c.data(),
                                     tier.data(), cap);
  if (rc < 0) return nullptr;
  lap("konig");
  a_c.clear(); a_c.shrink_to_fit();
  b_c.clear(); b_c.shrink_to_fit();

  int64_t tier_mult = 1;
  for (int64_t e = 0; e < E; ++e)
    tier_mult = std::max<int64_t>(tier_mult, tier[e] + 1);
  // tkey = block * tier_mult + tier, with block recovered from b_key
  std::vector<int64_t> tkey(static_cast<size_t>(E));
  for (int64_t e = 0; e < E; ++e)
    tkey[static_cast<size_t>(e)] =
        (b_key[static_cast<size_t>(e)] / cells) * tier_mult + tier[e];
  b_key.clear(); b_key.shrink_to_fit();
  tier.clear(); tier.shrink_to_fit();

  std::vector<int32_t> tile_of(static_cast<size_t>(E));
  std::vector<int64_t> uniq_t;
  const int64_t T = compact_impl(E, tkey.data(), tile_of.data(), &uniq_t);
  lap("compact_t");
  tkey.clear(); tkey.shrink_to_fit();

  auto *h = new CPGLevelHandle;
  h->sub = sub;
  h->tiles = T;
  h->slabm = slabm;
  h->s_ids.resize(static_cast<size_t>(T));
  h->d_ids.resize(static_cast<size_t>(T));
  for (int64_t t = 0; t < T; ++t) {
    const int64_t block = uniq_t[static_cast<size_t>(t)] / tier_mult;
    h->d_ids[static_cast<size_t>(t)] = static_cast<int32_t>(block / SB);
    h->s_ids[static_cast<size_t>(t)] = static_cast<int32_t>(block % SB);
  }

  // per-tile slab-pair occupancy mask (kernel unit-skip predicate);
  // past int32 capacity (sub >= 768 classic, sub >= 3968 slab: the slab
  // layout uses one bit per OUTPUT slab) the kernel is always dense, so
  // emit the all-ones sentinel instead of shifting past 31 (signed
  // shift UB)
  if ((slabm ? n_slab : n_slab * n_slab) > 30) {
    h->mask.assign(static_cast<size_t>(T), -1);
  } else {
    h->mask.assign(static_cast<size_t>(T), 0);
    for (int64_t e = 0; e < E; ++e) {
      const int64_t bit = slabm
          ? rd[e] / LANE
          : (rd[e] / LANE) * n_slab + ss[e] / LANE;
      h->mask[static_cast<size_t>(tile_of[e])] |= 1 << bit;
    }
  }
  lap("mask");

  // retain the per-entry routing data; gc_cpgl_fill scatters the l1/l2
  // index tiles straight into the caller's numpy buffers
  h->tile_of = std::move(tile_of);
  h->ss = std::move(ss);
  h->rd = std::move(rd);
  h->ld = std::move(ld);
  h->sl = std::move(sl);
  return h;
}

extern "C" int64_t gc_cpgl_tiles(void *h) {
  return static_cast<CPGLevelHandle *>(h)->tiles;
}
extern "C" void gc_cpgl_fill(void *hh, int8_t *l1, void *l2,
                             int32_t *s_ids, int32_t *d_ids) {
  auto *h = static_cast<CPGLevelHandle *>(hh);
  const int64_t LANE = 128;
  const int64_t sub = h->sub;
  const int64_t T = h->tiles;
  const int64_t E = static_cast<int64_t>(h->tile_of.size());
  const bool slabm = h->slabm;
  const int64_t rows = slabm ? LANE : sub;
  const int32_t *tile_of = h->tile_of.data();
  const int32_t *ss = h->ss.data();
  const int32_t *rd = h->rd.data();
  const int32_t *ld = h->ld.data();
  const int8_t *sl = h->sl.data();

  // l1: ghost lane 127 everywhere, then scatter real source lanes
  std::memset(l1, LANE - 1, static_cast<size_t>(T) * rows * LANE);
  for (int64_t e = 0; e < E; ++e) {
    const int64_t row = static_cast<int64_t>(tile_of[e]) * rows + ss[e];
    l1[static_cast<size_t>(row * LANE + ld[e])] = sl[e];
  }

  if (slabm) {
    // slab mode: uint8 l2, 255 = ghost (bit7 masks to zero in-kernel)
    auto *l2b = static_cast<uint8_t *>(l2);
    std::memset(l2b, 255, static_cast<size_t>(T) * LANE * sub);
    for (int64_t e = 0; e < E; ++e) {
      const int64_t col = static_cast<int64_t>(tile_of[e]) * LANE + ld[e];
      l2b[static_cast<size_t>(col * sub + rd[e])] =
          static_cast<uint8_t>(ss[e]);
    }
  } else {
    // l2: per-(tile, ld) column, ghost dest cells select the first
    // staging row whose l1 is ghost in that column (mex of the staged
    // ss set)
    const int64_t words = (sub + 63) / 64;
    std::vector<uint64_t> bits(static_cast<size_t>(T) * LANE * words, 0);
    for (int64_t e = 0; e < E; ++e) {
      const int64_t col = static_cast<int64_t>(tile_of[e]) * LANE + ld[e];
      bits[static_cast<size_t>(col * words + ss[e] / 64)] |=
          1ull << (ss[e] % 64);
    }
    const bool wide = sub > 256;  // int16 elements past the uint8 range
    auto *l2b = static_cast<uint8_t *>(l2);
    auto *l2w = static_cast<int16_t *>(l2);
    // per-column mex + fill is embarrassingly parallel (disjoint column
    // ranges) and writes T*LANE*sub elements — the widest stream of the
    // whole fill phase
    {
      const int P = static_cast<int>(std::max(
          1u, std::min(4u, std::thread::hardware_concurrency())));
      const int64_t n_cols = T * LANE;
      std::vector<std::thread> ts;
      for (int t = 0; t < P; ++t)
        ts.emplace_back([&, t] {
          const int64_t lo = n_cols * t / P, hi = n_cols * (t + 1) / P;
          for (int64_t col = lo; col < hi; ++col) {
            int64_t ff = sub - 1;  // fully-staged: no ghost cells
            for (int64_t w = 0; w < words; ++w) {
              const uint64_t f = ~bits[static_cast<size_t>(col * words + w)];
              if (f) {
                const int64_t c = w * 64 + __builtin_ctzll(f);
                if (c < sub) { ff = c; break; }
              }
            }
            if (wide) {
              std::fill(l2w + col * sub, l2w + (col + 1) * sub,
                        static_cast<int16_t>(ff));
            } else {
              std::memset(l2b + col * sub, static_cast<int>(ff),
                          static_cast<size_t>(sub));
            }
          }
        });
      for (auto &th : ts) th.join();
    }
    for (int64_t e = 0; e < E; ++e) {
      const int64_t col = static_cast<int64_t>(tile_of[e]) * LANE + ld[e];
      if (wide) {
        l2w[static_cast<size_t>(col * sub + rd[e])] =
            static_cast<int16_t>(ss[e]);
      } else {
        l2b[static_cast<size_t>(col * sub + rd[e])] =
            static_cast<uint8_t>(ss[e]);
      }
    }
  }
  std::memcpy(s_ids, h->s_ids.data(), h->s_ids.size() * sizeof(int32_t));
  std::memcpy(d_ids, h->d_ids.data(), h->d_ids.size() * sizeof(int32_t));
}
extern "C" void gc_cpgl_fill_mask(void *hh, int32_t *mask) {
  auto *h = static_cast<CPGLevelHandle *>(hh);
  std::memcpy(mask, h->mask.data(), h->mask.size() * sizeof(int32_t));
}
extern "C" void gc_cpgl_free(void *h) {
  delete static_cast<CPGLevelHandle *>(h);
}

// ------------------------------------------------------ virtual-row split
//
// Native port of the theta-split (cst.py _split_rows): units with degree
// > theta spawn virtual units; entries must arrive sorted by row.
// Outputs unit_of_entry (E,) and parents (n_extra,) mapping each new
// virtual unit (ids n_units0..) to its parent.  Returns n_units_total.

extern "C" int64_t gc_split_rows(int64_t n_entries, int64_t n_units0,
                                 int64_t theta, const int64_t *rows,
                                 int64_t *unit_out, int64_t *parents_out) {
  if (theta < 1 || n_entries < 0) return -1;  // no SIGFPE on theta=0
  int64_t n_units = n_units0;
  int64_t e = 0;
  int64_t n_extra = 0;
  while (e < n_entries) {
    const int64_t r = rows[e];
    int64_t e1 = e;
    while (e1 < n_entries && rows[e1] == r) ++e1;
    const int64_t deg = e1 - e;
    const int64_t parts = std::max<int64_t>((deg + theta - 1) / theta, 1);
    for (int64_t i = e; i < e1; ++i) {
      const int64_t part = (i - e) / theta;
      unit_out[i] = part == 0 ? r : n_units + part - 1;
    }
    for (int64_t p = 1; p < parts; ++p) parents_out[n_extra++] = r;
    n_units += parts - 1;
    e = e1;
  }
  return n_units;
}

// ------------------------------------------------------ GPG edge coloring
//
// Color-concentrating greedy edge coloring for the GPG packer
// (tpu_lanczos/kernels/gpg.py).  Entries arrive grouped by (dest chunk D,
// source granule g) — the "group" rank — with D-major group order.  Each
// entry gets the smallest color free on BOTH its staging cell (a-side,
// per-group: (ur, ld)) and its dest cell (b-side, per-D: (rd, ld)).
//
// Tiles are then formed from slots (= (group, color) classes) of the SAME
// color, so any two entries in a tile have distinct dest cells by b-side
// properness — no bin-packing or conflict probing needed.  First-fit
// greedy (not Konig) is deliberate: it concentrates each group's entries
// in a color prefix ~ its own local degree, which is what keeps slots per
// group (and thus tile count) near the per-group optimum.
//
//   group (E,) int32  — compact (D, g) rank, D-major ascending
//   d_of  (E,) int32  — dest chunk of each entry
//   a_cell (E,) int32 — staging cell within group: ur * 128 + ld
//   b_cell (E,) int32 — dest cell within chunk: rd * 128 + ld
// Returns max color + 1 (<= cap 4096), or -1 on error.

extern "C" int64_t gc_gpg_color(int64_t n_entries, int64_t n_a_cells,
                                int64_t n_b_cells, const int32_t *group,
                                const int32_t *d_of, const int32_t *a_cell,
                                const int32_t *b_cell, int32_t *colors_out) {
  if (n_entries == 0) return 0;
  constexpr int64_t kMaxColors = 4096;
  const int64_t words = kMaxColors / 64;
  std::vector<uint64_t> a_used(static_cast<size_t>(n_a_cells) * words, 0);
  std::vector<uint64_t> b_used(static_cast<size_t>(n_b_cells) * words, 0);
  std::vector<uint8_t> a_touched(static_cast<size_t>(n_a_cells), 0);
  std::vector<uint8_t> b_touched(static_cast<size_t>(n_b_cells), 0);
  std::vector<int32_t> a_dirty, b_dirty;
  a_dirty.reserve(4096);
  b_dirty.reserve(65536);

  auto clear_dirty = [&](std::vector<uint64_t> &used,
                         std::vector<uint8_t> &touched,
                         std::vector<int32_t> &dirty) {
    for (const int32_t c : dirty) {
      std::memset(&used[static_cast<size_t>(c) * words], 0,
                  static_cast<size_t>(words) * 8);
      touched[static_cast<size_t>(c)] = 0;
    }
    dirty.clear();
  };

  int64_t max_color = -1;
  int32_t cur_group = group[0];
  int32_t cur_d = d_of[0];
  for (int64_t e = 0; e < n_entries; ++e) {
    if (group[e] != cur_group) {
      clear_dirty(a_used, a_touched, a_dirty);
      cur_group = group[e];
    }
    if (d_of[e] != cur_d) {
      clear_dirty(b_used, b_touched, b_dirty);
      cur_d = d_of[e];
    }
    const int32_t a = a_cell[e], b = b_cell[e];
    uint64_t *ma = &a_used[static_cast<size_t>(a) * words];
    uint64_t *mb = &b_used[static_cast<size_t>(b) * words];
    int64_t c = -1;
    for (int64_t w = 0; w < words; ++w) {
      const uint64_t f = ~(ma[w] | mb[w]);
      if (f) { c = w * 64 + __builtin_ctzll(f); break; }
    }
    if (c < 0) return -1;  // > kMaxColors on one cell: theta far too large
    if (!a_touched[static_cast<size_t>(a)]) {
      a_touched[static_cast<size_t>(a)] = 1;
      a_dirty.push_back(a);
    }
    if (!b_touched[static_cast<size_t>(b)]) {
      b_touched[static_cast<size_t>(b)] = 1;
      b_dirty.push_back(b);
    }
    ma[c / 64] |= 1ull << (c % 64);
    mb[c / 64] |= 1ull << (c % 64);
    colors_out[e] = static_cast<int32_t>(c);
    if (c > max_color) max_color = c;
  }
  return max_color + 1;
}

// ------------------------------------------------------------ compaction
//
// Sorted-rank key compaction: the native replacement for
// np.unique(keys, return_inverse=True) in the CPG packer (ranks are
// assigned in sorted-key order, matching np.unique's inverse semantics,
// which the packer's d-major tile ordering relies on).
// Returns the number of distinct keys; out_ranks[e] gets the rank of
// keys[e]; out_uniq (if non-null, sized n) receives the sorted uniques.

extern "C" int64_t gc_compact_i64(int64_t n, const int64_t *keys,
                                  int32_t *out_ranks, int64_t *out_uniq) {
  if (n == 0) return 0;
  std::vector<int64_t> uniq;
  const int64_t n_u =
      compact_impl(n, keys, out_ranks, out_uniq ? &uniq : nullptr);
  if (out_uniq)
    std::memcpy(out_uniq, uniq.data(), uniq.size() * sizeof(int64_t));
  return n_u;
}



// Block-aware dealing (cpg.py _group_deal): within each
// (parent, opposite-chunk) group — groups ordered by sorted key,
// entries in original order (stable) — deal entries round-robin over
// the parent's parts, staggered by the global group counter.
// part_out[e] in [0, n_parts_of[parent[e]]); 0 means "ride the parent".
extern "C" void gc_group_deal(int64_t n, const int64_t *parent,
                              const int64_t *opp_chunk,
                              const int64_t *n_parts_of,
                              int64_t *part_out) {
  if (n == 0) return;
  std::vector<int64_t> keys(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i)
    keys[static_cast<size_t>(i)] = (parent[i] << 24) + opp_chunk[i];
  std::vector<int64_t> order;
  radix_argsort(n, keys.data(), order);
  int64_t gid = -1, within = 0;
  int64_t prev = INT64_MIN;
  for (int64_t k = 0; k < n; ++k) {
    const int64_t i = order[static_cast<size_t>(k)];
    const int64_t key = keys[static_cast<size_t>(i)];
    if (key != prev) {
      ++gid;
      within = 0;
      prev = key;
    }
    int64_t np = n_parts_of[parent[i]];
    if (np < 1) np = 1;
    part_out[i] = (within + gid) % np;
    ++within;
  }
}
