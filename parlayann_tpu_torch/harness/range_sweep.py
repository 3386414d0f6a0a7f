"""Range-search sweep harness: a per-beam range recall/QPS table.

Counterpart of parlayann_tpu/harness/range_sweep.py. Reference:
``range_search_wrapper`` (check_range_recall.h:67-84) sweeps initial beams
{10, 20, 30, 40, 50, 100, 1000, 2000, 3000}; per beam,
``checkRangeRecall`` (check_range_recall.h:22-63) runs the query-driven
range search and prints pointwise recall (the mean over queries with a
non-empty ground-truth set of the share of it reported), cumulative recall
(total reported over total ground truth) and QPS; driven by
rangeSearch/vamanaRange/range.h:40-69.

The queries run as one batch a beam. They are uploaded once, before any
timing; rep 0 warms up and the steady reps are timed between two fences
(``torch.cuda.synchronize`` on the card), the best rep kept. The BFS set is
capped, and the cap rises to cover the largest ground-truth set, so a cut
set never shows as a recall loss.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from parlayann_tpu_torch.harness.recall import range_recall
from parlayann_tpu_torch.search.range import range_query
from parlayann_tpu_torch.utils.timing import fence

RANGE_BEAMS = (10, 20, 30, 40, 50, 100, 1000, 2000, 3000)


@dataclasses.dataclass
class RangeRow:
    initial_beam: int
    pointwise_recall: float
    cumulative_recall: float
    QPS: float
    avg_cmps: float

    def print(self) -> str:
        s = (
            f"For initial beam = {self.initial_beam}, "
            f"Pointwise Recall = {self.pointwise_recall:.6g}, "
            f"Cumulative Recall = {self.cumulative_recall:.6g}, "
            f"QPS = {self.QPS:.6g}"
        )
        print(s, flush=True)
        return s


def range_search_wrapper(queries, points_data, nbrs, degs, gt: list, rad: float,
                         start_point: int = 0, beams=RANGE_BEAMS, *, metric,
                         n_valid: int, cap: int = 0, verbose: bool = True,
                         repeats: int = 1) -> list[RangeRow]:
    """Sweep initial beams -> list of RangeRow (printed as it goes). The
    queries go to the points' device as float32."""
    dev = points_data.device
    q = (queries.to(dev, torch.float32) if torch.is_tensor(queries) else
         torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(dev))
    nq = q.shape[0]
    max_gt = max((len(g) for g in gt), default=0)
    if cap <= 0:
        cap = 256
    while cap < max_gt:
        cap *= 2

    rows = []
    for beam in beams:
        if beam > n_valid:
            continue
        dt = float("inf")
        rr = None
        for rep in range(max(1, repeats) + 1):
            fence(dev)
            t0 = time.perf_counter()
            rr = range_query(q, points_data, nbrs, degs, start_point, rad,
                             initial_beam=beam, cap=cap, metric=metric,
                             n_valid=n_valid)
            fence(dev)
            if rep > 0:  # rep 0 warms up
                dt = min(dt, time.perf_counter() - t0)
        ids = rr.ids.cpu().numpy()
        ds = rr.dists.cpu().numpy()
        reported = [ids[i][(ids[i] >= 0) & (ds[i] <= rad)] for i in range(nq)]
        pw, cum = range_recall(reported, gt)
        row = RangeRow(initial_beam=beam, pointwise_recall=pw,
                       cumulative_recall=cum, QPS=nq / dt,
                       avg_cmps=float(rr.dist_cmps.double().mean()))
        if verbose:
            row.print()
        rows.append(row)
    return rows
