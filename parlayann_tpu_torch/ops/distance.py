"""Distances: squared L2 or negated inner product, "smaller is closer".

Counterpart of parlayann_tpu/ops/distance.py. Inputs of any storage dtype
are cast to float32 first: ``torch.matmul`` on int8 tensors would
accumulate in int8 and wrap.
"""

from __future__ import annotations

import torch

from parlayann_tpu_torch.types import Metric

# Large-but-finite sentinel distance for masked slots (the JAX package's
# value). Finite so sorts are total-order stable and arithmetic on it cannot
# produce NaN.
INF = 3.0e38


def _to_f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float32 else x.float()


def all_pairs(queries: torch.Tensor, points: torch.Tensor,
              metric: Metric) -> torch.Tensor:
    """(B, d), (N, d) -> (B, N) distance matrix via one float32 matmul.

    L2: max(||q||^2 - 2 q.x + ||x||^2, 0); MIPS: -q.x.
    """
    q = _to_f32(queries)
    x = _to_f32(points)
    dot = q @ x.T
    if metric is Metric.MIPS:
        return -dot
    qn = (q * q).sum(-1, keepdim=True)
    xn = (x * x).sum(-1)
    return torch.clamp(qn - 2.0 * dot + xn[None, :], min=0.0)


def gathered(queries: torch.Tensor, cand_vecs: torch.Tensor,
             metric: Metric) -> torch.Tensor:
    """(B, d), (B, K, d) -> (B, K) distances of per-query gathered
    candidates, as sum((c - q)^2) (L2) or -sum(c * q) (MIPS).

    int16 rows (the 16-bit tiers, whose float32 sums would not be exact: a
    square of a 16-bit difference passes 2^31) take the queries as integer
    levels (rounded half to even) and sum each distance exactly in int64,
    rounded once to float32. Kernel 1's int16 mode computes the same value,
    so a vertex's distance is one number on every path and device."""
    if cand_vecs.dtype == torch.int16:
        c = cand_vecs.long()
        q = torch.round(queries.float()).long()[:, None, :]
        s = -(c * q).sum(-1) if metric is Metric.MIPS else ((c - q) ** 2).sum(-1)
        return s.float()
    q = _to_f32(queries)
    c = _to_f32(cand_vecs)
    if metric is Metric.MIPS:
        return -(c * q[:, None, :]).sum(-1)
    diff = c - q[:, None, :]
    return (diff * diff).sum(-1)


def gathered_lane_order(queries: torch.Tensor, cand_vecs: torch.Tensor,
                        metric: Metric, chunk: int) -> torch.Tensor:
    """:func:`gathered` with its float32 sums in the warp-scoring kernels'
    order (``csrc/warp.cuh``), so the two agree bit for bit: the values
    split into chunks of ``chunk`` (16 bytes of the rows' storage type: 4
    float32 or 16 int8 values), chunk k to sub-lane k % 8; each sub-lane
    adds its chunks' terms in order from 0, each term one rounded product
    and each addition rounded; then the 8 partial sums p0..p7 make
    ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7))."""
    q = _to_f32(queries)[:, None, :]
    c = _to_f32(cand_vecs)
    t = c * q if metric is Metric.MIPS else (c - q) * (c - q)
    B, K, d = t.shape
    span = 8 * chunk
    t = torch.nn.functional.pad(t, (0, -d % span))
    # (B, K, pass, sub-lane, value) -> (B, K, sub-lane, pass and value)
    t = t.view(B, K, t.shape[2] // span, 8, chunk).transpose(2, 3).reshape(
        B, K, 8, t.shape[2] // 8)
    acc = torch.zeros(t.shape[:3], dtype=torch.float32, device=t.device)
    for i in range(t.shape[3]):
        acc = acc + t[..., i]
    p = acc.unbind(-1)
    total = ((p[0] + p[4]) + (p[2] + p[6])) + ((p[1] + p[5]) + (p[3] + p[7]))
    return -total if metric is Metric.MIPS else total
