"""Exact k-NN (ground truth) through the flat scan.

Counterpart of parlayann_tpu/search/exact.py: ``exact_knn`` delegates to
``flat_search_batch(select="sort", precision="exact")``, as the JAX
package does. That path is plain PyTorch on every device (chunked float32
matmuls and a stable sort), so ground truth never rests on a hand-written
kernel, and its results are ordered by (distance, id).
"""

from __future__ import annotations

import numpy as np
import torch

from parlayann_tpu_torch.data.pointset import PointSet
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
