"""The lock-step search of the scalar and f32 tiers: translate -> beam ->
rerank or top-k.

Counterpart of parlayann_tpu/search/fused.py:fused_search, which serves
the full-precision tier (no rerank: the beam is already exact), the
scalar tiers of 9 to 16 bits (int16 levels) and the q8 tier at ``expand >
1`` or ``degree_limit < R`` (index.py:384-446). The steps:

  1. translate the queries into the tier's domain
     (``quantize.translate_query``, then float32: integer levels for the
     scalar tiers; the points themselves take them as they are),
  2. one ``beam_search_batch`` with ``expand`` and ``degree_limit``, its
     candidate distances from kernel 1 over the tier's inline array (int8,
     int16 or f32 rows) when one is given, else by gathering rows,
  3. ``rerank_topk`` at full precision when the tier is not the points,
     else the first k beam entries (``top_k_from_beam``).

The JAX function's two-phase straggler compaction (fused.py:97-142; at
most ``compact_w`` unconverged queries resume after ``t1`` visits, the
rest keep their phase-1 result) is a schedule for the TPU's lock-step
batch and is not ported: every query runs its untruncated search, so
``n_truncated`` is always 0.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu_torch.search.rerank import rerank_topk


class FusedResult(NamedTuple):
    ids: torch.Tensor  # (B, k)
    dists: torch.Tensor  # (B, k) full precision when reranked
    num_visited: torch.Tensor  # (B,)
    dist_cmps: torch.Tensor  # (B,)
    n_truncated: torch.Tensor  # () queries cut short: always 0 here


def fused_search(
    q_full: torch.Tensor,  # (B, d) raw f32 queries
    tier: PointSet,  # the search tier: the points, or their q8 tier
    points_data: torch.Tensor,  # (n_pad, d) full-precision points (rerank)
    nbrs: torch.Tensor,
    degs: torch.Tensor,
    start: torch.Tensor,  # (S,) or (B, S) start ids
    inline: Optional[torch.Tensor] = None,  # (n_pad, R8, d) rows of the tier
    *,
    k: int,
    L: int,
    cut: float,
    limit: int,
    degree_limit: int,
    expand: int = 1,
    rerank_pool: int = 0,
    do_rerank: bool = False,
) -> FusedResult:
    """(See module docstring.)"""
    q = quantize.translate_query(q_full, tier).float()
    res = beam_search_batch(
        q, tier.data, nbrs, degs, start, None, inline, metric=tier.metric,
        n_valid=tier.n, k=k, L=L, cut=cut, limit=limit,
        degree_limit=degree_limit, expand=expand)
    if do_rerank:
        ids, dists = rerank_topk(q_full.float(), points_data, res.beam_ids, k=k,
                                 pool=min(max(rerank_pool, k), L), metric=tier.metric)
    else:
        ids, dists = top_k_from_beam(res, k)
    n_trunc = torch.zeros((), dtype=torch.int32, device=q_full.device)
    return FusedResult(ids, dists, res.num_visited, res.dist_cmps, n_trunc)
