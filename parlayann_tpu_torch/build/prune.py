"""Batched robustPrune — vectorized α-occlusion pruning.

Counterpart of parlayann_tpu/build/prune.py (vamana/index.h:63-120).
Candidate lists are sorted by (dist, id) and deduplicated by id with two
stable sorts (the reference's sort + unique, index.h:79-87); the R greedy
rounds run in kernel 2 (``ops/kernels/occlude.py``), which returns each
candidate's selection round, and one stable sort by round recovers the
(B, R) selection in distance order. This is exact: the same neighbours the
reference selects, in the same order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
from parlayann_tpu_torch.ops.topk import lexsort


class PruneResult(NamedTuple):
    ids: torch.Tensor  # (B, R) selected neighbor ids, -1 padded, dist-ascending
    dists: torch.Tensor  # (B, R) their distances to p (INF padded)
    degree: torch.Tensor  # (B,) number selected


def _first_col(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(x[:, :1], dtype=torch.bool)


def sort_dedup_candidates(cand_ids, cand_dists, n_valid: int):
    """Sort rows by (dist, id) ascending with duplicate ids masked to INF.

    Invalid entries must already carry dist INF. Returns (ids, dists) with
    unique sentinel ids (>= n_valid) in masked slots.
    """
    C = cand_ids.shape[1]
    sent = n_valid + torch.arange(C, dtype=torch.int32, device=cand_ids.device)
    ids = torch.where(cand_dists < INF, cand_ids, sent[None, :])
    sid, sdist = lexsort((ids, cand_dists))
    dup = torch.cat([_first_col(sid), sid[:, 1:] == sid[:, :-1]], dim=1)
    sdist = torch.where(dup, INF, sdist)
    sdist, sid = lexsort((sdist, sid))
    return sid, sdist


def _pairwise(cand_vecs: torch.Tensor, metric: Metric) -> torch.Tensor:
    """(B, C, d) -> (B, C, C) all candidate-candidate distances in one
    float32 ``torch.bmm`` with TF32 off (JAX prune.py:56): -dot for MIPS,
    max(n_i - 2 dot + n_j, 0) for L2."""
    v = cand_vecs.float()
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        dot = torch.bmm(v, v.transpose(1, 2))
    finally:
        torch.set_float32_matmul_precision(prev)
    if metric is Metric.MIPS:
        return -dot
    nrm = (v * v).sum(-1)
    return torch.clamp(nrm[:, :, None] - 2.0 * dot + nrm[:, None, :], min=0.0)


def _occlusion_loop(cand_ids, cand_dists, cand_vecs, alpha, R: int, metric: Metric):
    """R rounds of α-occlusion -> (sel_ids, sel_dists), both (B, R) in
    selection (= distance) order."""
    C = cand_ids.shape[1]
    rounds = occlusion_rounds(cand_dists, cand_vecs, alpha, R=R, metric=metric)
    # selection order == round order; unselected candidates carry R + C
    srounds, sel_ids, sel_dists = lexsort((rounds,), cand_ids, cand_dists)
    picked = srounds[:, :R] < R + C
    return (torch.where(picked, sel_ids[:, :R], -1),
            torch.where(picked, sel_dists[:, :R], INF))


def robust_prune_batch(
    p_ids: torch.Tensor,  # (B,) the points being pruned (-1 = inactive row)
    cand_ids: torch.Tensor,  # (B, C)
    cand_dists: torch.Tensor,  # (B, C) distances d(p, cand); INF = invalid
    points_data: torch.Tensor,  # (n_pad, d)
    alpha,
    *,
    R: int,
    metric: Metric,
    n_valid: int,
) -> PruneResult:
    """One robustPrune over B points. Candidates with dist INF are ignored;
    candidates equal to p are dropped (index.h:98-100)."""
    cand_dists = torch.where(cand_ids == p_ids[:, None], INF, cand_dists)
    cand_dists = torch.where((cand_ids >= 0) & (cand_ids < n_valid),
                             cand_dists, INF)
    sid, sdist = sort_dedup_candidates(cand_ids, cand_dists, n_valid)
    vecs = points_data[sid.long().clamp(0, points_data.shape[0] - 1)]
    sel_ids, sel_dists = _occlusion_loop(sid, sdist.contiguous(), vecs, alpha,
                                         R, metric)
    inactive = (p_ids < 0)[:, None]
    sel_ids = torch.where(inactive, -1, sel_ids)
    sel_dists = torch.where(inactive, INF, sel_dists)
    return PruneResult(sel_ids, sel_dists,
                       (sel_ids >= 0).sum(dim=1, dtype=torch.int32))


def robust_prune_chunked(p_ids, cand_ids, cand_dists, points_data, alpha, *,
                         R, metric, n_valid, chunk=2048):
    """robust_prune_batch over row chunks, bounding the (chunk, C, d)
    candidate-vector gather."""
    parts = [
        robust_prune_batch(
            p_ids[lo:lo + chunk], cand_ids[lo:lo + chunk],
            cand_dists[lo:lo + chunk], points_data, alpha,
            R=R, metric=metric, n_valid=n_valid)
        for lo in range(0, max(p_ids.shape[0], 1), chunk)
    ]
    return PruneResult(*(torch.cat(t) for t in zip(*parts)))
