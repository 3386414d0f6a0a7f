"""pyNNDescent builder — a k-NN graph by nn-descent.

Counterpart of parlayann_tpu/build/pynndescent.py (pyNNDescent/pynn_index.h
+ clusterPynn.h), with its semantics:

  1. init: random cluster trees whose leaves run all-pairs, each point
     keeping its K nearest across trees (clusterPynn.h:52-175);
  2. pull-style descent rounds until fewer than delta * n entries change
     (pynn_index.h:178-196): each vertex samples neighbours of its
     neighbours over the forward and capped reverse lists and merges the K
     nearest unique ids; then one exact round over all J * J two-hop
     candidates (the polish, BENCHES.md:261-283);
  3. finish: the union with the reversed edges, pruned by robustPrune to K
     (undirect_and_prune, pynn_index.h:198-239) on kernel 2.

The rounds and the polish gather (rows, candidates, d) vector blocks; they
run in row chunks of about ``GATHER_BYTES`` each, which changes no result.
``quantize_build`` runs every distance on the q8 tier of float32 points
(JAX pynndescent.py:216); other points build as they are, uint8 on an
exact float32 copy (``ops/quantize.py:build_tier``).
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.ops import distance, quantize
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.build.prune import robust_prune_chunked, sort_dedup_candidates
from parlayann_tpu_torch.build.cluster import (
    cluster_tree_labels, leaf_distances, leaf_members)
from parlayann_tpu_torch.utils.arrays import segment_bounds
from parlayann_tpu_torch.utils.draws import Draws
from parlayann_tpu_torch.utils.timing import fence

# float32 bytes of one gathered (rows, candidates, d) block
GATHER_BYTES = 1 << 30
# elements of one (leaves, S, S) distance block of the init
LEAF_BLOCK = 1 << 24
S1 = S2 = 16  # the sampled round's first and second hops a vertex


def _merge_rows(ids_a, dists_a, ids_b, dists_b, K: int, n_valid: int):
    """Row-aligned bounded merge: the K closest unique ids a row, -1 where
    fewer (the reference's seq_union_bounded, union.h:13-71)."""
    ids, dists = sort_dedup_candidates(torch.cat([ids_a, ids_b], dim=1),
                                       torch.cat([dists_a, dists_b], dim=1), n_valid)
    out_i, out_d = ids[:, :K], dists[:, :K]
    return torch.where(out_d < INF, out_i, -1), out_d


def _leaf_topk(points_data, members, sizes, cur_ids, cur_dists, *, S: int, K: int,
               metric: Metric, n_valid: int):
    """All-pairs inside each (Lc, S) leaf; each member's K nearest merge into
    its running list (clusterPynn.h:52-87 naive_neighbors) -> (ids, dists).
    The K nearest come from a stable row sort (``lax.top_k``'s ties to the
    lower index); only the members' rows are written."""
    n_pad = cur_ids.shape[0]
    D, ok = leaf_distances(points_data, members, sizes, metric)
    kk = min(K, S)
    d, loc = torch.sort(D, dim=2, stable=True)
    d, loc = d[:, :, :kk], loc[:, :, :kk]
    gl = torch.gather(members[:, None, :].expand(-1, S, -1), 2, loc)
    gl = torch.where(d < INF, gl, -1)
    rows = members.reshape(-1)
    safe = rows.clamp(0, n_pad - 1).long()
    new_i, new_d = _merge_rows(cur_ids[safe], cur_dists[safe], gl.reshape(-1, kk),
                               d.reshape(-1, kk), K, n_valid)
    write = (rows >= 0) & ok.reshape(-1)
    at = (rows[write].long(),)
    return (cur_ids.index_put(at, new_i[write]),
            cur_dists.index_put(at, new_d[write]))


def _reverse_capped(nbr_ids, rnd, *, K: int, n_valid: int):
    """Reversed adjacency, shuffled by the (n_pad * Kf,) int32 keys ``rnd``
    and truncated to K a target (pynn_index.h:157-176) -> (n_pad, K), -1
    padded."""
    n_pad, Kf = nbr_ids.shape
    dev = nbr_ids.device
    src = torch.arange(n_pad, dtype=torch.int32, device=dev).repeat_interleave(Kf)
    dst = nbr_ids.reshape(-1)
    valid = (dst >= 0) & (dst < n_valid) & (src < n_valid)
    dkey = torch.where(valid, dst, n_pad)
    sdst, _, ssrc = lexsort((dkey, rnd), src)
    pos = torch.arange(sdst.shape[0], dtype=torch.int32, device=dev)
    left, _ = segment_bounds(sdst)
    rank = pos - left
    keep = (rank < K) & (sdst < n_pad)
    rev = torch.full((n_pad, K), -1, dtype=torch.int32, device=dev)
    rev[sdst[keep].long(), rank[keep].long()] = ssrc[keep]
    return rev


def _chunk_rows(n_cand: int, d: int) -> int:
    return max(1, GATHER_BYTES // (n_cand * d * 4))


def _join_round(points_data, nbr_ids, nbr_dists, candidates, *, K: int,
                metric: Metric, n_valid: int, n_cand: int):
    """Merge each row's candidates into its list, in row chunks ->
    (ids, dists, changed). ``candidates(lo, hi)`` gives rows lo..hi's
    (rows, n_cand) candidate ids, -1 where none."""
    n_pad = nbr_ids.shape[0]
    dev = nbr_ids.device
    chunk = _chunk_rows(n_cand, points_data.shape[1])
    out_i, out_d = [], []
    for lo in range(0, n_pad, chunk):
        hi = min(lo + chunk, n_pad)
        rows = torch.arange(lo, hi, dtype=torch.int32, device=dev)
        cand = candidates(lo, hi)
        vecs = points_data[cand.clamp(0, points_data.shape[0] - 1).long()]
        d = distance.gathered(points_data[lo:hi], vecs, metric)
        bad = (cand < 0) | (cand >= n_valid) | (cand == rows[:, None])
        d = torch.where(bad, INF, d)
        del vecs
        i, dd = _merge_rows(nbr_ids[lo:hi], nbr_dists[lo:hi], cand, d, K, n_valid)
        out_i.append(i)
        out_d.append(dd)
    new_i, new_d = torch.cat(out_i), torch.cat(out_d)
    changed = ((new_i != nbr_ids) & (new_i >= 0)).sum()
    return new_i, new_d, changed


def _descent_round(points_data, nbr_ids, nbr_dists, rev, c1, c2, *, K: int,
                   metric: Metric, n_valid: int):
    """One pull-style sampled neighbours-of-neighbours round over the join
    lists (forward, then reverse), with the round's draws ``c1`` (n_pad,
    s1) and ``c2`` (n_pad, s1, s2) of join slots -> (ids, dists, changed)."""
    n_pad = nbr_ids.shape[0]
    join = torch.cat([nbr_ids, rev], dim=1)
    s1, s2 = c2.shape[1], c2.shape[2]

    def candidates(lo, hi):
        hop1 = torch.gather(join[lo:hi], 1, c1[lo:hi])
        cand = join[hop1.clamp(0, n_pad - 1).long()[:, :, None], c2[lo:hi]]
        return torch.where((hop1 >= 0)[:, :, None], cand, -1).reshape(hi - lo, s1 * s2)

    return _join_round(points_data, nbr_ids, nbr_dists, candidates, K=K,
                       metric=metric, n_valid=n_valid, n_cand=s1 * s2)


def _descent_round_exact(points_data, nbr_ids, nbr_dists, rev, *, K: int,
                         metric: Metric, n_valid: int):
    """One exact two-hop pull round: every vertex evaluates all J * J
    neighbours of its join list (J = K forward + K reverse), the polish
    after the sampled rounds -> (ids, dists, changed)."""
    n_pad = nbr_ids.shape[0]
    join = torch.cat([nbr_ids, rev], dim=1)
    J = join.shape[1]

    def candidates(lo, hi):
        j1 = join[lo:hi]
        j2 = join[j1.clamp(0, n_pad - 1).long()]
        return torch.where((j1 >= 0)[:, :, None], j2, -1).reshape(hi - lo, J * J)

    return _join_round(points_data, nbr_ids, nbr_dists, candidates, K=K,
                       metric=metric, n_valid=n_valid, n_cand=J * J)


def build_pynndescent_graph(points: PointSet, bp: BuildParams, verbose: bool = False,
                            polish: bool = True, quantize_build: bool = False,
                            draws: Optional[Draws] = None,
                            stats: Optional[dict] = None):
    """Build the pyNNDescent graph on ``points.device`` -> (GraphIndexData,
    seconds). ``polish``: one exact two-hop round after the sampled rounds.
    ``quantize_build``: every distance, the final prune's included, on the
    q8 tier (float32 points only). ``draws`` defaults to ``Draws(bp.seed,
    device)``. ``stats``, if given, receives the fenced seconds of the init
    (``init_s``), the descent rounds and polish (``rounds_s``) and the final
    prune (``prune_s``), each round's changed count (``changed``) and the
    polish's (``polish_changed``)."""
    n, n_pad = points.n, points.n_pad
    K = bp.R
    S = bp.cluster_size
    dev = points.device
    draws = draws if draws is not None else Draws(bp.seed, dev)
    out = dict(changed=[], polish_changed=None)
    t0 = time.perf_counter()
    build_ps = quantize.build_tier(
        points, quantize_build and points.data.dtype == torch.float32)
    data = build_ps.data

    nbr_ids = torch.full((n_pad, K), -1, dtype=torch.int32, device=dev)
    nbr_dists = torch.full((n_pad, K), INF, dtype=torch.float32, device=dev)

    # init: cluster trees with all-pairs leaves (clusterPynn.h)
    for t in range(max(bp.num_clusters, 1)):
        ids, labels = cluster_tree_labels(
            data, lambda lvl, m, t=t: draws.tree_bits(t, lvl, m), metric=points.metric,
            cluster_size=S, n_valid=n)
        members, sizes = leaf_members(ids.cpu().numpy(), labels.cpu().numpy(), S)
        chunk = max(1, min(len(members), LEAF_BLOCK // (S * S)))
        for lo in range(0, len(members), chunk):
            nbr_ids, nbr_dists = _leaf_topk(
                data, torch.from_numpy(members[lo:lo + chunk]).to(dev),
                torch.from_numpy(sizes[lo:lo + chunk]).to(dev), nbr_ids, nbr_dists,
                S=S, K=K, metric=points.metric, n_valid=n)
        if verbose:
            print(f"pynn init: tree {t + 1}/{bp.num_clusters}", flush=True)
    fence(dev)
    t1 = time.perf_counter()

    # nn-descent rounds (pynn_index.h:178-196)
    max_rounds = max(10, int(np.ceil(np.log2(max(points.d, 2)))))
    delta = bp.delta if bp.delta > 0 else 0.05
    for r in range(max_rounds):
        rev = _reverse_capped(nbr_ids, draws.reverse_bits(r, n_pad * K), K=K, n_valid=n)
        c1, c2 = draws.hops(r, n_pad, S1, S2, 2 * K)
        nbr_ids, nbr_dists, changed = _descent_round(
            data, nbr_ids, nbr_dists, rev, c1, c2, K=K, metric=points.metric, n_valid=n)
        ch = int(changed)
        out["changed"].append(ch)
        if verbose:
            print(f"pynn round {r}: changed {ch}", flush=True)
        if ch < delta * n:
            break

    if polish:
        rev = _reverse_capped(nbr_ids, draws.reverse_bits("polish", n_pad * K), K=K,
                              n_valid=n)
        nbr_ids, nbr_dists, chp = _descent_round_exact(
            data, nbr_ids, nbr_dists, rev, K=K, metric=points.metric, n_valid=n)
        out["polish_changed"] = int(chp)
        if verbose:
            print(f"pynn exact polish: changed {out['polish_changed']}", flush=True)
    fence(dev)
    t2 = time.perf_counter()

    # undirect + alpha prune (pynn_index.h:198-239)
    rev = _reverse_capped(nbr_ids, draws.reverse_bits("final", n_pad * K), K=K, n_valid=n)
    rev_d = distance.gathered(data, data[rev.clamp(0, n_pad - 1).long()], points.metric)
    rev_d = torch.where(rev >= 0, rev_d, INF)
    pr = robust_prune_chunked(
        torch.arange(n_pad, dtype=torch.int32, device=dev),
        torch.cat([nbr_ids, rev], dim=1), torch.cat([nbr_dists, rev_d], dim=1), data,
        bp.alpha if bp.alpha > 0 else 1.2, R=K, metric=points.metric, n_valid=n)
    g = GraphIndexData(neighbors=pr.ids, degrees=pr.degree, n=n, max_degree=K)
    fence(dev)
    t3 = time.perf_counter()
    if stats is not None:
        stats.update(out, init_s=t1 - t0, rounds_s=t2 - t1, prune_s=t3 - t2)
    return g, t3 - t0


def build_pynndescent_index(data, metric: Metric = Metric.L2, K: int = 40,
                            cluster_size: int = 100, num_clusters: int = 10,
                            alpha: float = 1.2, delta: float = 0.05,
                            verbose: bool = False, seed: int = 0,
                            quantize_build: bool = False, device=None,
                            stats: Optional[dict] = None):
    """Convenience wrapper (python/builder.cpp:158-184; defaults from
    docs/algorithms.md:110-114) -> (graph, PointSet, build seconds).
    ``data`` is an array, placed on ``device`` (None: the card), or a
    PointSet (which keeps its own device); ``stats`` as in
    :func:`build_pynndescent_graph`. Search the graph with
    ``random_starts``: a k-NN graph has no navigable entry."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric, device=device)
    bp = BuildParams(R=K, cluster_size=cluster_size, num_clusters=num_clusters,
                     alpha=alpha, delta=delta, seed=seed)
    g, dt = build_pynndescent_graph(ps, bp, verbose=verbose,
                                    quantize_build=quantize_build, stats=stats)
    return g, ps, dt
