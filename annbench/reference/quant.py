"""The Euclidean scalar tier from its published formula
(euclidian_point.h:183-235): the global min and max of the valid rows,
``slope = (2^bits - 1) / (max - min)``, level ``round((x - min) *
slope)`` (half to even) clamped to [0, 2^bits - 1], each step a float32
operation."""

from __future__ import annotations

import torch


def scalar_tier(points: torch.Tensor, n: int, bits: int):
    """-> (levels of every row as float32 (n_pad, d), slope, min), the
    last two 0-d float32 tensors."""
    valid = points[:n].float()
    lo, hi = valid.min(), valid.max()
    top = torch.tensor(2.0 ** bits - 1.0, dtype=torch.float32, device=points.device)
    slope = top / torch.clamp(hi - lo, min=1e-30)
    levels = torch.clamp(torch.round((points.float() - lo) * slope), 0.0, float(top))
    return levels, slope, lo


def query_levels(queries: torch.Tensor, slope, lo, bits: int) -> torch.Tensor:
    """Queries in the tier's levels, clamped as the points are."""
    return torch.clamp(torch.round((queries.float() - lo) * slope), 0.0, 2.0 ** bits - 1.0)
