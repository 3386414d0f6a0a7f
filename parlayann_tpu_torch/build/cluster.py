"""Random cluster trees — the partitioning shared by HCNNG and pyNNDescent.

Counterpart of parlayann_tpu/build/cluster.py (clusterEdge.h:66-153,
clusterPynn.h:52-175), ported as it is written there: level-synchronous,
not fork-join. Each point carries a cluster label; one level

  1. sorts the points by (label, random key): the first two points of each
     label's segment are its two random pivots,
  2. measures every point against its segment's two pivots,
  3. labels it 2 * segment start + the nearer pivot's bit, the point's rank
     parity when the two distances are equal (the duplicate-pivot
     fallback, clusterEdge.h:108-127).

Clusters at or below ``cluster_size`` freeze; the loop runs while any
cluster split and fewer than ``max_levels`` levels ran.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import distance
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.build.prune import _pairwise

BIG = 2 ** 30  # the sort key of unlabelled (pad) rows


def _split_level(points_data, ids, labels, active, rnd, *, metric: Metric,
                 cluster_size: int):
    """One level -> (ids, labels, active, d1, d2) in the new sorted order;
    d1 and d2 are each point's distances to its segment's two pivots."""
    n_pad = points_data.shape[0]
    dev = points_data.device
    pos = torch.arange(n_pad, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    slab = torch.where(labels < 0, BIG, labels)
    slab, _, ids, active = lexsort((slab, rnd), ids, active)
    first = torch.cat([one, slab[1:] != slab[:-1]])
    seg_start = torch.cummax(torch.where(first, pos, 0), dim=0).values
    rank = pos - seg_start
    # segment ends by one reverse cummin
    nxt_first = torch.cat([first[1:], one])
    right = torch.flip(torch.cummin(torch.flip(
        torch.where(nxt_first, pos + 1, n_pad), [0]), dim=0).values, [0])
    seg_size = right - seg_start

    p1 = points_data[ids[seg_start.long()].long()]
    p2 = points_data[ids[torch.clamp(seg_start + 1, max=n_pad - 1).long()].long()]
    pts = points_data[ids.long()]
    d1 = distance.gathered(pts, p1[:, None, :], metric)[:, 0]
    d2 = distance.gathered(pts, p2[:, None, :], metric)[:, 0]
    bit = torch.where(d1 == d2, rank % 2, (d2 < d1).to(torch.int32))

    split = active & (seg_size > cluster_size) & (slab < BIG)
    new_labels = torch.where(split, seg_start * 2 + bit,
                             torch.where(slab < BIG, seg_start * 2, -1))
    return ids, new_labels.to(torch.int32), split, d1, d2


def cluster_tree_labels(points_data: torch.Tensor,
                        bits: Callable[[int, int], torch.Tensor], *,
                        metric: Metric, cluster_size: int, n_valid: int,
                        max_levels: int = 24):
    """One random cluster tree -> (ids (n_pad,), labels (n_pad,)) int32
    pairs on the points' device. ``bits(level, n_pad)`` gives each level's
    (n_pad,) int32 random keys (``Draws.tree_bits`` of this tree).

    ``labels[i]`` is the leaf label of point ``ids[i]``; pad rows carry
    label -1 and sort last. Sibling leaves never share a label."""
    n_pad = points_data.shape[0]
    pos = torch.arange(n_pad, dtype=torch.int32, device=points_data.device)
    ids = pos
    labels = torch.where(pos < n_valid, 0, -1).to(torch.int32)
    active = pos < n_valid
    lvl = 0
    while lvl < max_levels and bool(active.any()):
        ids, labels, active, _, _ = _split_level(
            points_data, ids, labels, active, bits(lvl, n_pad), metric=metric,
            cluster_size=cluster_size)
        lvl += 1
    return ids, labels


def leaf_members(ids, labels, cluster_size: int):
    """Host helper: (ids, labels) pairs -> (n_leaves, cluster_size) member
    matrix padded with -1, plus (n_leaves,) sizes."""
    ids, labels = np.asarray(ids), np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    ids, labels = ids[order], labels[order]
    keep = labels >= 0
    ids, labels = ids[keep], labels[keep]
    starts = np.flatnonzero(np.concatenate([[True], labels[1:] != labels[:-1]]))
    ends = np.concatenate([starts[1:], [len(labels)]])
    n_leaves = len(starts)
    out = np.full((n_leaves, cluster_size), -1, dtype=np.int32)
    sizes = np.zeros(n_leaves, dtype=np.int32)
    for i, (s, e) in enumerate(zip(starts, ends)):
        m = min(e - s, cluster_size)
        out[i, :m] = ids[s : s + m]
        sizes[i] = m
    return out, sizes


def leaf_distances(points_data: torch.Tensor, members: torch.Tensor,
                   sizes: torch.Tensor, metric: Metric):
    """(Lc, S) leaf member ids (-1 padded) and (Lc,) sizes -> ((Lc, S, S)
    all-pairs distances inside each leaf, INF on the diagonal and wherever
    a slot is past its leaf's size; (Lc, S) valid slots)."""
    S = members.shape[1]
    vecs = points_data[members.clamp(0, points_data.shape[0] - 1).long()]
    D = _pairwise(vecs, metric)
    col = torch.arange(S, dtype=torch.int32, device=points_data.device)
    valid = col[None, :] < sizes[:, None]
    D = torch.where(valid[:, None, :] & valid[:, :, None], D, INF)
    return torch.where(col[:, None] == col[None, :], INF, D), valid
