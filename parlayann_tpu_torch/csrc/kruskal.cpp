// The port's copy of native/kruskal.cpp (the JAX package's degree-bounded
// Kruskal), built by parlayann_tpu_torch/native.py into
// parlayann_tpu_torch/_build/ with g++ -O3 -shared -fPIC -fopenmp.
//
// Degree-bounded Kruskal over many leaves — the sequential-island stage of
// the HCNNG builder (reference: algorithms/HCNNG/hcnng_index.h:134-229,
// MSTk: union-find Kruskal with a per-vertex degree cap, run independently
// per cluster-tree leaf).
//
// The device computes each leaf's candidate edges (top-m per point, sorted by
// weight); this native routine runs the inherently sequential union-find
// pass for all leaves in parallel on host cores (the reference's
// parallel-across-leaves / sequential-within-leaf structure).
//

#include <cstdint>
#include <cstring>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

struct DisjointSet {
  // path-halving find + union by size (reference hcnng_index.h:36-89)
  std::vector<int32_t> parent;
  std::vector<int32_t> size;
  int32_t n_components;

  void reset(int32_t n) {
    parent.resize(n);
    size.assign(n, 1);
    n_components = n;
    for (int32_t i = 0; i < n; i++) parent[i] = i;
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  bool unite(int32_t a, int32_t b) {
    int32_t ra = find(a), rb = find(b);
    if (ra == rb) return false;
    if (size[ra] < size[rb]) std::swap(ra, rb);
    parent[rb] = ra;
    size[ra] += size[rb];
    n_components--;
    return true;
  }
};

}  // namespace

extern "C" {

// edges are leaf-local vertex indices in [0, leaf_size), already sorted by
// ascending weight within each leaf (invalid slots marked u < 0).
//
//   edges_u/v : (n_leaves * n_edges_per_leaf) int32
//   leaf_sizes: (n_leaves,) int32
//   out_u/v   : same shape as edges_u; selected MST edges compacted to the
//               front of each leaf's slice
//   out_count : (n_leaves,) int32 — number selected per leaf
void kruskal_leaves(const int32_t* edges_u, const int32_t* edges_v,
                    const int32_t* leaf_sizes, int64_t n_leaves,
                    int64_t n_edges_per_leaf, int32_t max_leaf_size,
                    int32_t mst_deg, int32_t* out_u, int32_t* out_v,
                    int32_t* out_count) {
#pragma omp parallel
  {
    DisjointSet ds;
    std::vector<int32_t> deg(max_leaf_size);
#pragma omp for schedule(dynamic, 1)
    for (int64_t leaf = 0; leaf < n_leaves; leaf++) {
      const int32_t s = leaf_sizes[leaf];
      ds.reset(s);
      std::memset(deg.data(), 0, sizeof(int32_t) * (size_t)s);
      const int64_t base = leaf * n_edges_per_leaf;
      int32_t taken = 0;
      for (int64_t e = base; e < base + n_edges_per_leaf; e++) {
        int32_t u = edges_u[e], v = edges_v[e];
        if (u < 0 || v < 0 || u >= s || v >= s || u == v) continue;
        // per-vertex degree cap, then component check
        // (hcnng_index.h:208-226)
        if (deg[u] >= mst_deg || deg[v] >= mst_deg) continue;
        if (!ds.unite(u, v)) continue;
        deg[u]++;
        deg[v]++;
        out_u[base + taken] = u;
        out_v[base + taken] = v;
        taken++;
        if (ds.n_components == 1) break;  // forest complete (is_full)
      }
      out_count[leaf] = taken;
    }
  }
}

// Blocked binary graph writer/reader helpers live in Python (numpy is
// already memory-bandwidth bound there); this library hosts the truly
// sequential algorithms only.

}  // extern "C"
