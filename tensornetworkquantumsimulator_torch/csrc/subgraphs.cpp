// Leaf-free edge-induced subgraph enumeration (the "generalized loops" of
// the BP loop-correction series), a copy of the JAX package's
// native/subgraphs.cpp for the PyTorch port (loaded by
// tensornetworkquantumsimulator_torch/native.py, built with g++ into
// build/native/ at the root of the checkout).  Native counterpart of the
// pure-Python utils/graphs.py::edgeinduced_subgraphs_no_leaves, which itself
// mirrors NamedGraphs.edgeinduced_subgraphs_no_leaves as the reference uses
// it in loopcorrection.jl:11-12.
//
// Two stages, both over edge bitsets:
//   1. enumerate every CONNECTED edge subset with <= max_edges edges via
//      the ordered-extension scheme (start edge = minimum index, banned set
//      accumulates iterated siblings — each connected subset is generated
//      exactly once, no dedup table needed), keeping the leaf-free ones
//      (every touched vertex has degree >= 2, and >= 3 edges);
//   2. enumerate vertex-disjoint unions of those components (the full
//      configuration series), bounded by the same max_edges budget.
//
// The Python implementation is O(minutes) at max_edges=10 on a 5x5 grid;
// this runs the same enumeration in milliseconds.  The Python version
// remains as the no-toolchain path and the parity oracle
// (tests/test_torch_loopcorrection.py).
//
// C interface (ctypes):
//   long long enumerate_leaffree(
//       int n_vertices, int n_edges, const int* src, const int* dst,
//       int max_edges, unsigned long long* out, long long cap, int words)
// Writes each union subset as `words` little-endian uint64 edge-mask words
// into `out` (cap entries available).  Returns the TOTAL number of unions
// found (callers re-call with a larger cap when total > cap), or -1 on
// unsupported input.

#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

namespace {

constexpr int kMaxWords = 4;  // up to 256 edges / 256 vertices

struct Mask {
  uint64_t w[kMaxWords];
  void clear() { std::memset(w, 0, sizeof(w)); }
  void set(int i) { w[i >> 6] |= 1ull << (i & 63); }
  bool test(int i) const { return (w[i >> 6] >> (i & 63)) & 1ull; }
  void orWith(const Mask& o) {
    for (int i = 0; i < kMaxWords; ++i) w[i] |= o.w[i];
  }
  bool intersects(const Mask& o) const {
    for (int i = 0; i < kMaxWords; ++i)
      if (w[i] & o.w[i]) return true;
    return false;
  }
};

struct Enumerator {
  int n_vertices, n_edges, max_edges, words;
  const int* src;
  const int* dst;
  const unsigned char* leaf_ok = nullptr;  // per-vertex: degree-1 allowed
  std::vector<Mask> adj;      // per edge: adjacent edges (shared vertex)
  std::vector<int> degree;    // per vertex, for the current subset
  std::vector<int> cur;       // current edge indices (stack)
  int n_deg1 = 0;             // vertices at degree exactly 1 in current
  int n_bad1 = 0;             // ... of which degree-1 is NOT allowed
  // stage-1 results: connected leaf-free components
  std::vector<Mask> comp_edges;
  std::vector<Mask> comp_verts;
  std::vector<int> comp_size;

  bool allowed(int v) const { return leaf_ok && leaf_ok[v]; }

  void add_edge_to_cur(int k) {
    cur.push_back(k);
    for (int v : {src[k], dst[k]}) {
      int d = ++degree[v];
      if (d == 1) {
        ++n_deg1;
        if (!allowed(v)) ++n_bad1;
      } else if (d == 2) {
        --n_deg1;
        if (!allowed(v)) --n_bad1;
      }
    }
  }
  void pop_edge_from_cur(int k) {
    cur.pop_back();
    for (int v : {src[k], dst[k]}) {
      int d = --degree[v];
      if (d == 0) {
        --n_deg1;
        if (!allowed(v)) --n_bad1;
      } else if (d == 1) {
        ++n_deg1;
        if (!allowed(v)) ++n_bad1;
      }
    }
  }

  void record_component() {
    Mask em, vm;
    em.clear();
    vm.clear();
    for (int k : cur) {
      em.set(k);
      vm.set(src[k]);
      vm.set(dst[k]);
    }
    comp_edges.push_back(em);
    comp_verts.push_back(vm);
    comp_size.push_back((int)cur.size());
  }

  // S = current subset (cur/curmask), X = banned, adjmask = union of
  // adj[e] for e in S.  Emits every connected superset of S reachable by
  // adding non-banned adjacent edges exactly once.
  void grow(Mask curmask, Mask banned, Mask adjmask) {
    // leaf-free (n_deg1 == 0, >= 3 edges) or every leaf at an allowed
    // vertex (op-anchored excitation components of the observable series)
    if (n_bad1 == 0 && ((int)cur.size() >= 3 || n_deg1 > 0))
      record_component();
    if ((int)cur.size() >= max_edges) return;
    // candidates = adjacent \ current \ banned
    Mask cand;
    for (int i = 0; i < kMaxWords; ++i)
      cand.w[i] = adjmask.w[i] & ~curmask.w[i] & ~banned.w[i];
    for (int wi = 0; wi < words; ++wi) {
      uint64_t bits = cand.w[wi];
      while (bits) {
        int k = wi * 64 + __builtin_ctzll(bits);
        bits &= bits - 1;
        Mask nm = curmask, na = adjmask;
        nm.set(k);
        na.orWith(adj[k]);
        add_edge_to_cur(k);
        grow(nm, banned, na);
        pop_edge_from_cur(k);
        banned.set(k);  // iterated sibling: exclude from deeper levels
      }
    }
  }

  void run_stage1() {
    degree.assign(n_vertices, 0);
    Mask banned;
    banned.clear();
    for (int k = 0; k < n_edges; ++k) {
      Mask curmask;
      curmask.clear();
      curmask.set(k);
      add_edge_to_cur(k);
      grow(curmask, banned, adj[k]);
      pop_edge_from_cur(k);
      banned.set(k);
    }
  }

  // stage 2: vertex-disjoint unions of connected components
  long long total = 0;
  uint64_t* out;
  long long cap;
  void unions(size_t start, Mask acc_e, Mask acc_v, int acc_n) {
    for (size_t i = start; i < comp_edges.size(); ++i) {
      if (acc_n + comp_size[i] > max_edges) continue;
      if (comp_verts[i].intersects(acc_v)) continue;
      Mask ne = acc_e, nv = acc_v;
      ne.orWith(comp_edges[i]);
      nv.orWith(comp_verts[i]);
      if (total < cap)
        std::memcpy(out + total * words, ne.w, words * sizeof(uint64_t));
      ++total;
      unions(i + 1, ne, nv, acc_n + comp_size[i]);
    }
  }
};

}  // namespace

// `leaf_ok` (may be null) flags vertices where configuration leaves are
// allowed — the numerator series of loop-corrected expectation values
// anchors excitation paths/tadpoles at the observable vertices; null
// reproduces the strict leaf-free enumeration.
extern "C" long long enumerate_leaffree2(
    int n_vertices, int n_edges, const int* src, const int* dst,
    int max_edges, const unsigned char* leaf_ok, unsigned long long* out_raw,
    long long cap, int words) {
  uint64_t* out = reinterpret_cast<uint64_t*>(out_raw);
  if (n_vertices <= 0 || n_edges <= 0 || max_edges <= 0) return 0;
  if (n_edges > 64 * kMaxWords || n_vertices > 64 * kMaxWords) return -1;
  if (words != (n_edges + 63) / 64) return -1;

  Enumerator en;
  en.n_vertices = n_vertices;
  en.n_edges = n_edges;
  en.max_edges = max_edges;
  en.words = words;
  en.src = src;
  en.dst = dst;
  en.leaf_ok = leaf_ok;

  // edge-edge adjacency via per-vertex incidence masks
  std::vector<Mask> incident(n_vertices);
  for (auto& m : incident) m.clear();
  for (int k = 0; k < n_edges; ++k) {
    incident[src[k]].set(k);
    incident[dst[k]].set(k);
  }
  en.adj.resize(n_edges);
  for (int k = 0; k < n_edges; ++k) {
    en.adj[k] = incident[src[k]];
    en.adj[k].orWith(incident[dst[k]]);
    // an edge is not its own neighbor; harmless either way (masked by
    // ~curmask), but keep the sets clean
    en.adj[k].w[k >> 6] &= ~(1ull << (k & 63));
  }

  en.run_stage1();

  // deterministic component order: by size, then lexicographic edge mask
  // (matches the Python sort by (len, sorted indices) closely enough —
  // the wrapper re-sorts final results anyway)
  std::vector<size_t> order(en.comp_edges.size());
  for (size_t i = 0; i < order.size(); ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](size_t a, size_t b) {
    if (en.comp_size[a] != en.comp_size[b])
      return en.comp_size[a] < en.comp_size[b];
    for (int i = 0; i < kMaxWords; ++i)
      if (en.comp_edges[a].w[i] != en.comp_edges[b].w[i])
        return en.comp_edges[a].w[i] < en.comp_edges[b].w[i];
    return false;
  });
  std::vector<Mask> ce, cv;
  std::vector<int> cs;
  for (size_t i : order) {
    ce.push_back(en.comp_edges[i]);
    cv.push_back(en.comp_verts[i]);
    cs.push_back(en.comp_size[i]);
  }
  en.comp_edges.swap(ce);
  en.comp_verts.swap(cv);
  en.comp_size.swap(cs);

  en.out = out;
  en.cap = cap;
  Mask z;
  z.clear();
  en.unions(0, z, z, 0);
  return en.total;
}

// backward-compatible strict leaf-free entry point
extern "C" long long enumerate_leaffree(
    int n_vertices, int n_edges, const int* src, const int* dst,
    int max_edges, unsigned long long* out_raw, long long cap, int words) {
  return enumerate_leaffree2(n_vertices, n_edges, src, dst, max_edges,
                             nullptr, out_raw, cap, words);
}
