"""Exact nearest neighbours and float64 distances, in blocks.

Candidates come from a float32 product with TF32 off (||x||^2 - 2 q.x,
the ``k + margin`` smallest of each row), and are scored again in float64
and sorted by (distance, id). A float32 rounding error large enough to
push a true neighbour past ``k + margin`` candidates does not occur at
these scales: it would have to exceed the gap between the k-th and the
(k + margin)-th distance.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def full_f32():
    """Float32 products in float32: TF32 off for the duration."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _rows(n: int, budget: int = 1 << 32) -> int:
    """Queries a block: a (rows, n) float32 block of about ``budget`` bytes."""
    return max(1, min(8192, budget // (4 * max(n, 1))))


def sq_dist64(points: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(n_pad, d) points, (B, d) queries, (B, m) ids >= 0 -> (B, m) float64
    squared L2 distances."""
    v = points[ids].double()
    return ((v - queries.double()[:, None, :]) ** 2).sum(-1)


def exact_knn(points: torch.Tensor, n: int, queries: torch.Tensor, k: int,
              margin: int | None = None):
    """The exact k nearest of the first ``n`` points to every query ->
    numpy (ids (B, k) int64, squared distances (B, k) float64), sorted by
    (distance, id)."""
    dev = points.device
    xs = points[:n]
    m = min(n, k + (margin if margin is not None else max(k, 32)))
    ids_out = np.empty((queries.shape[0], k), np.int64)
    d_out = np.empty((queries.shape[0], k), np.float64)
    with full_f32():
        xn = (xs.float() ** 2).sum(1)
        step = _rows(n)
        for lo in range(0, queries.shape[0], step):
            q = queries[lo:lo + step].float().to(dev)
            d32 = torch.addmm(xn[None, :], q, xs.float().T, alpha=-2.0)
            cand = torch.topk(d32, m, dim=1, largest=False).indices
            del d32
            d64 = sq_dist64(xs, q, cand)
            # (distance, id) order: sort by id, then stably by distance
            cand, o = torch.sort(cand, dim=1)
            d64 = d64.gather(1, o)
            d64, o = torch.sort(d64, dim=1, stable=True)
            cand = cand.gather(1, o)
            ids_out[lo:lo + step] = cand[:, :k].cpu().numpy()
            d_out[lo:lo + step] = d64[:, :k].cpu().numpy()
    return ids_out, d_out


def answer_dist64(points: torch.Tensor, n: int, queries: torch.Tensor,
                  ids: np.ndarray, block: int = 8192) -> np.ndarray:
    """Float64 squared distances of answered ids (B, k); NaN where an id is
    not one of the ``n`` points."""
    out = np.full(ids.shape, np.nan)
    dev = points.device
    for lo in range(0, ids.shape[0], block):
        blk = torch.as_tensor(ids[lo:lo + block]).to(dev).long()
        ok = (blk >= 0) & (blk < n)
        d = sq_dist64(points, queries[lo:lo + block].to(dev), blk.clamp(0, n - 1))
        out[lo:lo + block] = torch.where(ok, d, torch.nan).cpu().numpy()
    return out
