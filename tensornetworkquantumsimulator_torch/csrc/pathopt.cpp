// Optimal contraction-order search: exact dynamic programming.
//
// Native counterpart of the reference's TensorOperations.optimaltree
// (`contraction_sequences.jl:15-26`).  The generic engine calls this for
// every BP message/vertex contraction; results are memoised Python-side,
// but cold-cache workloads (new circuits, new graphs) hit the search often
// enough that the Python DP in opt_einsum shows up in profiles.
//
// Two regimes behind one entry point (`optimal_path2`):
//   n <= 16  — Held-Karp DP over ALL subsets (3^n sub-subset scan);
//              handles disconnected lists and outer products exactly.
//   n <= 64  — netcon-style DP over CONNECTED subsets only (Pfeifer/
//              Haegeman/Evenbly; what optimaltree implements): enumerate
//              the connected subsets of each tensor-adjacency component,
//              then combine adjacent disjoint connected pairs by size.
//              Optimal over contraction trees without outer products
//              (optimaltree's own default search space).  Enumeration
//              and pair-combination budgets bound worst-case time; on
//              overflow the caller falls back to greedy.
// Index metadata comes in flattened arrays via the C ABI (ctypes);
// index masks are 128-bit (two uint64 words per tensor) so sandwich
// networks with up to 128 distinct indices qualify.
//
// Build: g++ -O2 -shared -fPIC -o libpathopt.so pathopt.cpp

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

typedef unsigned __int128 imask;

struct Entry {
  double cost;
  uint64_t left;   // subset bitmask of the left operand (0 = leaf)
  uint64_t right;  // subset bitmask of the right operand
  uint64_t adjm;   // tensors adjacent to (and outside) the subset
  imask ext;       // external (surviving) index mask of the subset
};

struct Ctx {
  int n, num_inds;
  const double* ind_dims;
  std::vector<imask> tinds;     // index mask per tensor
  std::vector<imask> tmask_hi;  // unused
  std::vector<uint64_t> ind_tensors;  // per index: mask of tensors using it
  imask output_mask;
  uint64_t full;

  imask inds_of(uint64_t s) const {
    imask out = 0;
    while (s) {
      int i = __builtin_ctzll(s);
      out |= tinds[i];
      s &= s - 1;
    }
    return out;
  }
  double size_of(imask m) const {
    double sz = 1.0;
    uint64_t lo = (uint64_t)m, hi = (uint64_t)(m >> 64);
    while (lo) {
      int k = __builtin_ctzll(lo);
      sz *= ind_dims[k];
      lo &= lo - 1;
    }
    while (hi) {
      int k = __builtin_ctzll(hi);
      sz *= ind_dims[64 + k];
      hi &= hi - 1;
    }
    return sz;
  }
  // external indices of a subset: shared with the complement or output
  imask external_of(uint64_t s) const {
    imask inside = inds_of(s);
    imask outside = inds_of(full & ~s) | output_mask;
    return inside & outside;
  }
  // external indices of a UNION given the children's externals: an index of
  // el|er survives iff some tensor outside the union uses it, or it is a
  // final output index.  Only boundary indices are scanned — O(|el|er|).
  imask external_of_union(uint64_t u, imask el_er) const {
    imask out = 0;
    uint64_t lo = (uint64_t)el_er, hi = (uint64_t)(el_er >> 64);
    while (lo) {
      int k = __builtin_ctzll(lo);
      if ((ind_tensors[k] & ~u) || ((output_mask >> k) & 1))
        out |= (imask)1 << k;
      lo &= lo - 1;
    }
    while (hi) {
      int k = __builtin_ctzll(hi);
      if ((ind_tensors[64 + k] & ~u) || ((output_mask >> (64 + k)) & 1))
        out |= (imask)1 << (64 + k);
      hi &= hi - 1;
    }
    return out;
  }
};

// --- exact DP over all subsets (n <= 16): proven small-n path ---------------

bool dp_allsubsets(const Ctx& c, std::unordered_map<uint64_t, Entry>& best) {
  const int n = c.n;
  std::vector<std::vector<uint64_t>> by_size(n + 1);
  for (uint64_t s = 1; s <= c.full; ++s)
    by_size[__builtin_popcountll(s)].push_back(s);

  for (int sz = 2; sz <= n; ++sz) {
    for (uint64_t s : by_size[sz]) {
      double best_cost = -1.0;
      uint64_t best_l = 0, best_r = 0;
      for (uint64_t l = (s - 1) & s; l; l = (l - 1) & s) {
        uint64_t r = s & ~l;
        if (l > r) continue;
        auto it_l = best.find(l), it_r = best.find(r);
        if (it_l == best.end() || it_r == best.end()) continue;
        double cost = c.size_of(it_l->second.ext | it_r->second.ext) +
                      it_l->second.cost + it_r->second.cost;
        if (best_cost < 0 || cost < best_cost) {
          best_cost = cost;
          best_l = l;
          best_r = r;
        }
      }
      if (best_cost >= 0)
        best[s] = {best_cost, best_l, best_r, 0, c.external_of(s)};
    }
  }
  return best.find(c.full) != best.end();
}

// --- connected-subset DP (17 <= n <= 64) ------------------------------------

// enumerate all connected subsets of `allowed` containing vertex v with no
// vertex below v; standard polynomial-delay branch (include/exclude each
// frontier candidate, excluded candidates forbidden in later branches).
bool enum_connected(const std::vector<uint64_t>& adj, uint64_t allowed, int v,
                    std::vector<std::vector<uint64_t>>& by_size,
                    long long& budget) {
  struct Frame {
    uint64_t sub, ext, forb;
  };
  std::vector<Frame> stack;
  uint64_t s0 = 1ull << v;
  stack.push_back({s0, adj[v] & allowed & ~s0, 0});
  if (--budget < 0) return false;
  by_size[1].push_back(s0);
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    uint64_t ext = f.ext, forb = f.forb;
    while (ext) {
      uint64_t ubit = ext & (~ext + 1);
      int u = __builtin_ctzll(ubit);
      ext &= ext - 1;
      uint64_t sub2 = f.sub | ubit;
      uint64_t ext2 = (ext | (adj[u] & allowed)) & ~sub2 & ~forb & ~ubit;
      if (--budget < 0) return false;
      by_size[__builtin_popcountll(sub2)].push_back(sub2);
      stack.push_back({sub2, ext2, forb});
      forb |= ubit;  // u excluded in all later branches of this frame
    }
  }
  return true;
}

bool dp_connected(const Ctx& c, const std::vector<uint64_t>& adj,
                  uint64_t comp, std::unordered_map<uint64_t, Entry>& best,
                  long long& subset_budget, long long& pair_budget) {
  int m = __builtin_popcountll(comp);
  std::vector<std::vector<uint64_t>> by_size(m + 1);
  // canonical enumeration: for each vertex v in comp ascending, connected
  // subsets whose minimum vertex is v
  uint64_t rest = comp;
  while (rest) {
    int v = __builtin_ctzll(rest);
    rest &= rest - 1;
    // allowed = v and everything after it in comp
    uint64_t allowed = comp & ~((1ull << v) - 1);
    if (!enum_connected(adj, allowed, v, by_size, subset_budget)) return false;
  }

  // fail FAST on dense components: estimate the pair-combination work
  // before running it (the caller falls back to opt_einsum's cost-capped
  // DP / greedy; burning seconds before declining defeats the purpose)
  {
    long long est = 0;
    for (int sz = 2; sz <= m; ++sz)
      for (int d1 = 1; 2 * d1 <= sz; ++d1) {
        est += (long long)by_size[d1].size() * by_size[sz - d1].size();
        if (est > pair_budget) return false;
      }
  }

  for (int sz = 2; sz <= m; ++sz) {
    for (int d1 = 1; 2 * d1 <= sz; ++d1) {
      int d2 = sz - d1;
      for (uint64_t s1 : by_size[d1]) {
        auto it1 = best.find(s1);
        if (it1 == best.end()) continue;
        double c1 = it1->second.cost;
        uint64_t adj1 = it1->second.adjm;
        imask e1 = it1->second.ext;
        for (uint64_t s2 : by_size[d2]) {
          if (--pair_budget < 0) return false;
          if (s1 & s2) continue;
          if (!(adj1 & s2)) continue;  // not adjacent -> union disconnected
          if (d1 == d2 && s1 > s2) continue;
          auto it2 = best.find(s2);
          if (it2 == best.end()) continue;
          imask el_er = e1 | it2->second.ext;
          double cost = c.size_of(el_er) + c1 + it2->second.cost;
          uint64_t u = s1 | s2;
          auto itu = best.find(u);
          if (itu == best.end()) {
            Entry e;
            e.cost = cost;
            e.left = s1;
            e.right = s2;
            e.adjm = (adj1 | it2->second.adjm) & ~u;
            e.ext = c.external_of_union(u, el_er);
            best.emplace(u, e);
          } else if (cost < itu->second.cost) {
            itu->second.cost = cost;
            itu->second.left = s1;
            itu->second.right = s2;
          }
        }
      }
    }
  }
  return best.find(comp) != best.end();
}

}  // namespace

extern "C" {

// inputs:
//   n             — number of tensors (n <= 64; 64-bit subset masks)
//   num_inds      — number of distinct indices (<= 128)
//   ind_dims      — dims of each index [num_inds]
//   tensor_inds2  — two 64-bit words (lo, hi) of the index bitmask per
//                   tensor [2*n]
// output:
//   path_out      — 2*(n-1) ints: pairs (i, j) in SSA numbering
//                   (operands 0..n-1, results n, n+1, ...)
// returns 0 on success, nonzero on failure (caller falls back).
int optimal_path2(int n, int num_inds, const double* ind_dims,
                  const uint64_t* tensor_inds2, int* path_out) {
  if (n < 2 || n > 64 || num_inds > 128) return 1;
  Ctx c;
  c.n = n;
  c.num_inds = num_inds;
  c.ind_dims = ind_dims;
  c.tinds.resize(n);
  for (int i = 0; i < n; ++i)
    c.tinds[i] =
        ((imask)tensor_inds2[2 * i + 1] << 64) | (imask)tensor_inds2[2 * i];
  c.ind_tensors.assign(num_inds, 0);
  for (int i = 0; i < n; ++i)
    for (int k = 0; k < num_inds; ++k)
      if ((c.tinds[i] >> k) & 1) c.ind_tensors[k] |= 1ull << i;
  c.output_mask = 0;
  for (int k = 0; k < num_inds; ++k)
    if (__builtin_popcountll(c.ind_tensors[k]) == 1)
      c.output_mask |= (imask)1 << k;
  c.full = (n == 64) ? ~0ull : ((1ull << n) - 1);

  std::unordered_map<uint64_t, Entry> best;
  std::vector<uint64_t> adj(n, 0);
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j)
      if (c.tinds[i] & c.tinds[j]) {
        adj[i] |= 1ull << j;
        adj[j] |= 1ull << i;
      }
  for (int i = 0; i < n; ++i)
    best[1ull << i] = {0.0, 0, 0, adj[i], c.external_of(1ull << i)};

  // connected components of the tensor-adjacency graph
  std::vector<uint64_t> comps;
  uint64_t seen = 0;
  for (int i = 0; i < n; ++i) {
    if ((seen >> i) & 1) continue;
    uint64_t comp = 1ull << i, frontier = adj[i];
    while (frontier & ~comp) {
      uint64_t add = frontier & ~comp;
      comp |= add;
      uint64_t nf = 0;
      while (add) {
        int j = __builtin_ctzll(add);
        nf |= adj[j];
        add &= add - 1;
      }
      frontier = nf;
    }
    comps.push_back(comp);
    seen |= comp;
  }

  if (n <= 16) {
    if (!dp_allsubsets(c, best)) return 2;
  } else {
    long long subset_budget = 500000, pair_budget = 40000000;
    for (uint64_t comp : comps)
      if (__builtin_popcountll(comp) >= 2 &&
          !dp_connected(c, adj, comp, best, subset_budget, pair_budget))
        return 4;  // budget exceeded or component not solvable
    // join components by outer products, cheapest external size first
    if (comps.size() > 1) {
      std::vector<uint64_t> order(comps);
      for (size_t a = 0; a < order.size(); ++a)
        for (size_t b = a + 1; b < order.size(); ++b)
          if (c.size_of(best[order[b]].ext) < c.size_of(best[order[a]].ext))
            std::swap(order[a], order[b]);
      uint64_t acc = order[0];
      for (size_t a = 1; a < order.size(); ++a) {
        uint64_t u = acc | order[a];
        Entry e;
        e.cost = best[acc].cost + best[order[a]].cost +
                 c.size_of(best[acc].ext | best[order[a]].ext);
        e.left = acc;
        e.right = order[a];
        e.adjm = 0;
        e.ext = best[acc].ext | best[order[a]].ext;
        best[u] = e;
        acc = u;
      }
    }
    if (best.find(c.full) == best.end()) return 2;
  }

  // emit SSA pairs by post-order traversal
  std::unordered_map<uint64_t, int> ssa;
  for (int i = 0; i < n; ++i) ssa[1ull << i] = i;
  int next_id = n;
  int pos = 0;
  std::vector<uint64_t> stack = {c.full};
  std::vector<uint64_t> order;
  while (!stack.empty()) {
    uint64_t s = stack.back();
    stack.pop_back();
    if (__builtin_popcountll(s) < 2) continue;
    order.push_back(s);
    stack.push_back(best[s].left);
    stack.push_back(best[s].right);
  }
  for (auto it = order.rbegin(); it != order.rend(); ++it) {
    uint64_t s = *it;
    int a = ssa[best[s].left];
    int b = ssa[best[s].right];
    path_out[2 * pos] = a;
    path_out[2 * pos + 1] = b;
    ssa[s] = next_id++;
    ++pos;
  }
  return pos == n - 1 ? 0 : 3;
}
}
