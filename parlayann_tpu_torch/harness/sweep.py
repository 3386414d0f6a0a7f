"""search_and_parse — the recall/QPS sweep harness.

Counterpart of parlayann_tpu/harness/sweep.py (check_nn_recall.h:180-283).
Same protocol: a beam sweep over the reference's 43 beam widths at
cut=1.35, a visited-limit sweep {10..35} with degree_limit = min(max_degree,
5*limit), a best-accuracy probe (k=100 in the reference; here the sweep's k,
Q=1000, cut=10), then recall-bucketed best-QPS selection
(parse_results.h:192-218). QPS is steady state: ``Index.batch_search_timed``
uploads the queries, warms up once and fences its timed search with
``torch.cuda.synchronize`` on the card.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from parlayann_tpu_torch.harness.recall import NNResult, compute_recall, mean_p99

BEAMS = [10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 22, 24, 26, 28, 30, 32,
         34, 36, 38, 40, 45, 50, 55, 60, 65, 70, 80, 90, 100, 120, 140, 160,
         180, 200, 225, 250, 275, 300, 375, 500, 750, 1000]
LIMITS = [10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26,
          28, 30, 35]
BUCKETS = [.1, .2, .3, .4, .5, .6, .7, .75, .8, .85, .9, .93, .95, .97, .98,
           .99, .995, .999, .9995, .9999, .99995, .99999]


def check_recall(
    index,
    queries: np.ndarray,
    gt_ids: Optional[np.ndarray],
    gt_dists: Optional[np.ndarray],
    k: int,
    beam_size: int,
    cut: float = 1.35,
    limit: Optional[int] = None,
    degree_limit: Optional[int] = None,
    expand: int = 1,
    verbose: bool = False,
) -> NNResult:
    """One timed sweep point (checkRecall, check_nn_recall.h:18-125)."""
    ids, _, res, dt = index.batch_search_timed(
        queries, k=k, beam_size=beam_size, cut=cut, limit=limit,
        degree_limit=degree_limit, expand=expand,
    )
    # no ground truth -> recall stays 0 (check_nn_recall.h: GT.size()==0)
    rec = (compute_recall(ids.cpu().numpy(), gt_ids, gt_dists, k)
           if gt_ids is not None else 0.0)
    ac, tc = mean_p99(res.dist_cmps.cpu().numpy())
    av, tv = mean_p99(res.num_visited.cpu().numpy())
    out = NNResult(
        recall=rec, QPS=len(queries) / dt, avg_cmps=ac, tail_cmps=tc,
        avg_visited=av, tail_visited=tv, k=k, beamQ=beam_size, cut=cut,
        limit=limit if limit is not None else index.points.n,
        degree_limit=(degree_limit if degree_limit is not None
                      else index.graph.max_degree),
        num_queries=len(queries),
    )
    if verbose:
        out.print()
    return out


def search_and_parse(
    index,
    queries: np.ndarray,
    gt_ids: Optional[np.ndarray],
    gt_dists: Optional[np.ndarray] = None,
    k: int = 10,
    beams: Optional[list[int]] = None,
    limits: Optional[list[int]] = None,
    best_accuracy_probe: bool = True,
    expand: int = 1,
    verbose: bool = False,
):
    """Full sweep -> (all_results, bucketed_best) (check_nn_recall.h:214-261)."""
    results: list[NNResult] = []
    maxdeg = index.graph.max_degree
    for q in (beams if beams is not None else BEAMS):
        if q >= k:
            results.append(check_recall(index, queries, gt_ids, gt_dists, k, q,
                                        expand=expand, verbose=verbose))
    for l in (limits if limits is not None else LIMITS):
        results.append(check_recall(
            index, queries, gt_ids, gt_dists, k, beam_size=max(l, k), limit=l,
            degree_limit=min(maxdeg, 5 * l), expand=expand, verbose=verbose))
    if best_accuracy_probe:
        results.append(check_recall(index, queries, gt_ids, gt_dists, k,
                                    beam_size=1000, cut=10.0, expand=expand,
                                    verbose=verbose))
    return results, parse_result(results, BUCKETS)


def parse_result(results: list[NNResult], buckets: list[float]):
    """Per recall bucket keep the max-QPS setting (parse_results.h:192-218)."""
    out = []
    for i, b in enumerate(buckets):
        cands = [r for r in results if r.recall >= b]
        if i < len(buckets) - 1 and cands:
            upper = [r for r in cands if r.recall <= buckets[i + 1]]
            cands = upper if upper else []
        if cands:
            out.append((b, max(cands, key=lambda r: r.QPS)))
    return out


def best_qps_at_recall(results: list[NNResult], target: float) -> Optional[NNResult]:
    cands = [r for r in results if r.recall >= target]
    return max(cands, key=lambda r: r.QPS) if cands else None
