"""HCNNG builder — hierarchical-cluster nearest-neighbour graph.

Counterpart of parlayann_tpu/build/hcnng.py (HCNNG/hcnng_index.h +
clusterEdge.h). ``num_clusters`` random cluster trees (build/cluster.py);
in each leaf of at most ``cluster_size`` points, a degree-bounded spanning
forest (Kruskal over each point's 10 nearest leaf-mates,
hcnng_index.h:134-229) whose edges go in both directions; at most
``num_clusters * MST_deg`` edges a point (types.h:211), duplicates
removed.

  * label trees      -> all trees on the device, one readback
  * leaf candidates  -> (leaves, S, S) distance blocks (``_pairwise``, one
                        batched product), each point's first m by a stable
                        row sort, the (leaf, S * m) edges stable-sorted by
                        weight
  * per-leaf Kruskal -> the host C++ library (native.py), parallel across
                        leaves; tree t + 1's candidate pass is queued on the
                        stream before tree t's Kruskal runs
  * edge assembly    -> numpy grouping on the host, as in JAX
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch import native
from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.build.cluster import (
    cluster_tree_labels, leaf_distances, leaf_members)
from parlayann_tpu_torch.utils.draws import Draws
from parlayann_tpu_torch.utils.timing import fence

_CAND_PER_POINT = 10  # the reference's m = 10 candidate edges a point (hcnng_index.h:144)
# elements of one (leaves, S, S) distance block of the candidate pass
CAND_BLOCK = 1 << 26


def _leaf_candidate_edges(points_data, members, sizes, *, S: int, m: int,
                          metric: Metric):
    """(Lc, S) leaf member ids (-1 padded) and (Lc,) sizes -> per-leaf
    weight-sorted candidate edges (u_local, v_local, weight), each (Lc, S * m);
    invalid slots carry -1 ids and weight INF. Each point's m nearest
    leaf-mates come from one stable row sort (JAX's m argmin passes: ties
    to the lower index), then a stable sort by weight orders the edges."""
    Lc = members.shape[0]
    D, _ = leaf_distances(points_data, members, sizes, metric)  # (Lc, S, S)
    col = torch.arange(S, dtype=torch.int32, device=points_data.device)
    w, v = torch.sort(D, dim=2, stable=True)
    w = w[:, :, :m].reshape(Lc, S * m)
    v = v[:, :, :m].reshape(Lc, S * m).to(torch.int32)
    u = col[None, :, None].expand(Lc, S, m).reshape(Lc, S * m)
    sw, order = torch.sort(w, dim=1, stable=True)
    ok = sw < INF
    su = torch.where(ok, torch.gather(u, 1, order), -1)
    sv = torch.where(ok, torch.gather(v, 1, order), -1)
    return su, sv, sw


class _Pending:
    """One tree's queued candidate pass: its (u, v) edges copied to host
    memory behind an event, so the host can run Kruskal on the tree before
    while the device works on this one."""

    def __init__(self, points_data, members, sizes, *, S, m, metric):
        self.members, self.sizes = members, sizes
        dev = points_data.device
        chunk = max(1, min(len(members), CAND_BLOCK // (S * S)))
        su, sv = [], []
        for lo in range(0, len(members), chunk):
            u, v, _ = _leaf_candidate_edges(
                points_data, torch.from_numpy(members[lo:lo + chunk]).to(dev),
                torch.from_numpy(sizes[lo:lo + chunk]).to(dev), S=S, m=m,
                metric=metric)
            su.append(u)
            sv.append(v)
        uv = torch.stack([torch.cat(su), torch.cat(sv)])
        self.event = None
        if dev.type == "cuda":
            self.uv = torch.empty(uv.shape, dtype=uv.dtype, pin_memory=True)
            self.uv.copy_(uv, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.uv = uv

    def edges(self):
        if self.event is not None:
            self.event.synchronize()
        uv = self.uv.numpy()
        return uv[0], uv[1]


def build_hcnng_graph(points: PointSet, bp: BuildParams, verbose: bool = False,
                      draws: Optional[Draws] = None,
                      stats: Optional[dict] = None):
    """Build the HCNNG graph on ``points.device`` -> (GraphIndexData,
    seconds). ``draws`` defaults to ``Draws(bp.seed, device)``; ``stats``,
    if given, receives the fenced seconds of the label trees
    (``labels_s``), the host's time queueing candidate passes and waiting
    for them (``candidates_s``), Kruskal with each tree's edge mapping
    (``kruskal_s``) and the edge assembly (``assembly_s``), which sum to
    the build's seconds."""
    n = points.n
    S = bp.cluster_size
    if (1 << (S - 1).bit_length()) ** 2 >= 2 ** 31:
        # the JAX package packs a (u, v) pair into one int32 word
        raise ValueError(f"cluster_size {S} too large")
    mst_deg = bp.MST_deg
    max_deg = bp.max_degree  # num_clusters * MST_deg (types.h:211)
    m = min(_CAND_PER_POINT, max(S - 1, 1))
    dev = points.device
    draws = draws if draws is not None else Draws(bp.seed, dev)
    times = dict(labels_s=0.0, candidates_s=0.0, kruskal_s=0.0, assembly_s=0.0)
    t0 = time.perf_counter()

    # every label tree on the device, then one readback
    lab = [cluster_tree_labels(points.data, lambda lvl, n_pad, t=t: draws.tree_bits(t, lvl, n_pad),
                               metric=points.metric, cluster_size=S, n_valid=n)
           for t in range(bp.num_clusters)]
    lab_h = torch.stack([torch.stack(o) for o in lab]).cpu().numpy()  # (T, 2, n_pad)
    del lab
    t1 = time.perf_counter()
    times["labels_s"] = t1 - t0

    def queue(t):
        members, sizes = leaf_members(lab_h[t, 0], lab_h[t, 1], S)
        return _Pending(points.data, members, sizes, S=S, m=m, metric=points.metric)

    srcs, dsts = [], []
    pending = queue(0) if bp.num_clusters else None
    for t in range(bp.num_clusters):
        cur = pending
        if t + 1 < bp.num_clusters:
            pending = queue(t + 1)
        su, sv = cur.edges()
        tb = time.perf_counter()
        # the sequential island: degree-bounded Kruskal per leaf (C++)
        ou, ov, cnt = native.kruskal_leaves(su, sv, cur.sizes, S, mst_deg)
        members = cur.members
        keep = np.arange(ou.shape[1])[None, :] < cnt[:, None]
        rowi = np.broadcast_to(np.arange(len(members))[:, None], ou.shape)[keep]
        eu = members[rowi, np.clip(ou, 0, S - 1)[keep]]
        ev = members[rowi, np.clip(ov, 0, S - 1)[keep]]
        # both directions (hcnng_index.h:208-218)
        srcs.append(np.concatenate([eu, ev]))
        dsts.append(np.concatenate([ev, eu]))
        times["kruskal_s"] += time.perf_counter() - tb
        if verbose:
            print(f"hcnng: tree {t + 1}/{bp.num_clusters} ({len(members)} leaves)",
                  flush=True)

    t2 = time.perf_counter()
    times["candidates_s"] = t2 - t1 - times["kruskal_s"]
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    # order-preserving (src, dst) dedup, then the first max_deg per source
    # (process_edges + remove_all_duplicates, hcnng_index.h:102-131)
    pairs = src.astype(np.int64) * n + dst
    _, first = np.unique(pairs, return_index=True)
    first.sort()
    src, dst = src[first], dst[first]
    order = np.argsort(src, kind="stable")
    src, dst = src[order], dst[order]
    starts = np.searchsorted(src, np.arange(n), side="left")
    ends = np.searchsorted(src, np.arange(n), side="right")
    degs = np.minimum(ends - starts, max_deg).astype(np.int32)
    rank = np.arange(len(src)) - starts[src]
    keep = rank < max_deg
    rows = np.zeros((n, max_deg), dtype=np.int32)
    rows[src[keep], rank[keep]] = dst[keep]
    g = GraphIndexData.from_numpy(rows, degs, n=n, device=dev)
    fence(dev)
    t3 = time.perf_counter()
    times["assembly_s"] = t3 - t2
    if stats is not None:
        stats.update(times)
    return g, t3 - t0


def build_hcnng_index(data, metric: Metric = Metric.L2, num_clusters: int = 30,
                      cluster_size: int = 1000, mst_deg: int = 3,
                      verbose: bool = False, seed: int = 0, device=None,
                      stats: Optional[dict] = None):
    """Convenience wrapper (python/builder.cpp:114-140; defaults from
    docs/algorithms.md:92-97) -> (graph, PointSet, build seconds). ``data``
    is an array, placed on ``device`` (None: the card), or a PointSet
    (which keeps its own device); ``stats`` as in
    :func:`build_hcnng_graph`."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric, device=device)
    bp = BuildParams(num_clusters=num_clusters, cluster_size=cluster_size,
                     MST_deg=mst_deg, seed=seed)
    g, dt = build_hcnng_graph(ps, bp, verbose=verbose, stats=stats)
    return g, ps, dt
