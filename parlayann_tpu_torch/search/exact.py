"""Exact k-NN (ground truth) through the flat scan.

Counterpart of parlayann_tpu/search/exact.py: ``exact_knn`` delegates to
``flat_search_batch(select="sort", precision="exact")``, as the JAX
package does. That path is plain PyTorch on every device (chunked float32
matmuls and a stable sort), so ground truth never rests on a hand-written
kernel, and its results are ordered by (distance, id).
``compute_range_groundtruth`` thresholds the same float32 ``all_pairs``
matrix as the JAX package, on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import distance
from parlayann_tpu_torch.search.flat import flat_search_batch


def exact_knn(queries, points: PointSet, k: int, chunk: int = 32768):
    """Exact top-k for each query row -> (ids (B, k) int32, dists (B, k)
    f32), ascending, ties in id order; -1 / INF past the last point."""
    q = torch.as_tensor(queries).to(points.device, torch.float32)
    return flat_search_batch(q, points.data, k=k, metric=points.metric,
                             n_valid=points.n, chunk=min(chunk, points.n_pad),
                             select="sort", precision="exact")


def compute_groundtruth(base: PointSet, queries: np.ndarray, k: int,
                        query_batch: int = 8192):
    """Exact top-k over query batches -> numpy (ids, dists)
    (compute_groundtruth.cpp:104)."""
    out_i, out_d = [], []
    for lo in range(0, len(queries), query_batch):
        ids, dists = exact_knn(queries[lo:lo + query_batch], base, k)
        out_i.append(ids.cpu().numpy())
        out_d.append(dists.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_d)


# the largest (query batch, base chunk) float32 distance block of
# compute_range_groundtruth
RANGE_BLOCK_BYTES = 1 << 30


def compute_range_groundtruth(base: PointSet, queries, radius: float,
                              query_batch: int = 2048) -> list:
    """Exact range ground truth (data_tools/compute_range_groundtruth.cpp):
    the ascending ids of the valid base points whose ``all_pairs`` distance
    (float32 norm expansion, as the JAX package computes it) is at most
    ``radius``, one int32 array a query. The threshold runs on the device
    (``nonzero``, then a split by counts); the base goes in chunks so that
    one (query_batch, chunk) block stays under ``RANGE_BLOCK_BYTES``."""
    dev = base.device
    r = torch.tensor(float(radius), dtype=torch.float32, device=dev)
    chunk = max(1, RANGE_BLOCK_BYTES // (4 * query_batch))
    out = []
    for lo in range(0, len(queries), query_batch):
        q = torch.as_tensor(queries[lo:lo + query_batch]).to(dev)
        rows, cols = [], []
        for c0 in range(0, base.n, chunk):
            d = distance.all_pairs(q, base.data[c0:min(c0 + chunk, base.n)],
                                   base.metric)
            i, j = torch.nonzero(d <= r, as_tuple=True)
            rows.append(i)
            cols.append(j + c0)
        rows, cols = torch.cat(rows), torch.cat(cols)
        # chunks come in ascending order and ``nonzero`` is row-major, so a
        # stable sort by row leaves each row's ids ascending
        order = torch.sort(rows, stable=True).indices
        counts = torch.bincount(rows, minlength=q.shape[0]).cpu().numpy()
        ids = cols[order].to(torch.int32).cpu().numpy()
        out.extend(np.split(ids, np.cumsum(counts)[:-1]))
    return out
