// The port's copy of native/balance.cpp (the JAX package's capacity
// balancer), built by parlayann_tpu_torch/native.py with csrc/kruskal.cpp
// into one library in parlayann_tpu_torch/_build/.
//
// Capacity-balanced cluster assignment — the host-side hot spot of the
// ClusterIndex build (build/clusterindex.py balance_assign).
//
// Exact same semantics as the vectorized numpy implementation (kept as
// the fallback + test oracle): BFS over choice ranks — round j places
// every still-unplaced point at its j-th choice centroid while capacity
// remains, accepting by global distance priority (the caller passes the
// stable priority permutation); leftovers spill to the emptiest
// clusters' free slots, emptiest-first with stable (cluster, slot)
// order. Sequential scans in priority order are equivalent to the numpy
// per-round grouped-rank acceptance and run ~10-50x faster at 10M
// (the numpy path re-argsorts up to n keys per round).
//
// Reference counterpart: none — the reference has no cluster index;
// this is runtime support for the TPU-native two-level structure.

#include <cstdint>
#include <vector>
#include <algorithm>

extern "C" {

// Returns 0 on success, -1 if total capacity C*m < n (slack too low).
int balance_assign(
    const int32_t* nbr_ids,   // (n, k) candidate centroids per point
    const int64_t* order,     // (n,) stable priority permutation
    int64_t n, int32_t k, int32_t C, int32_t m,
    int32_t* members          // (C, m) out, pre-filled with -1
) {
    std::vector<int32_t> fill(C, 0);
    std::vector<int64_t> pending(order, order + n);
    std::vector<int64_t> next;
    next.reserve(n);

    for (int32_t j = 0; j < k && !pending.empty(); ++j) {
        next.clear();
        for (int64_t p : pending) {
            int32_t c = nbr_ids[p * k + j];
            if (c >= 0 && c < C && fill[c] < m) {
                members[(int64_t)c * m + fill[c]] = (int32_t)p;
                ++fill[c];
            } else {
                next.push_back(p);
            }
        }
        pending.swap(next);
    }

    if (!pending.empty()) {
        // spill: free slots ordered emptiest-first, stable by
        // (cluster id, slot) — matches the numpy repeat + stable argsort
        std::vector<std::pair<int32_t, int32_t>> free_slots;  // (fill, c)
        free_slots.reserve((size_t)C);
        for (int32_t c = 0; c < C; ++c)
            for (int32_t s = fill[c]; s < m; ++s)
                free_slots.emplace_back(fill[c], c);
        if (free_slots.size() < pending.size()) return -1;
        std::stable_sort(
            free_slots.begin(), free_slots.end(),
            [](const std::pair<int32_t, int32_t>& a,
               const std::pair<int32_t, int32_t>& b) {
                return a.first < b.first;
            });
        for (size_t i = 0; i < pending.size(); ++i) {
            int32_t c = free_slots[i].second;
            members[(int64_t)c * m + fill[c]] = (int32_t)pending[i];
            ++fill[c];
        }
    }
    return 0;
}

}  // extern "C"
