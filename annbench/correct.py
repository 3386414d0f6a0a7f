"""The comparison that decides ``correct``.

After the window, the answers of every pool query (the last answers of
each pool slot) are judged against the plain reference: exact ground
truth in float64, and the float64 distance of every answered id. Each
number compared is ``checks/<name>.py``; the cell's limits file names
the numbers and their limits, and the run is correct when every number
is at or under its limit (a NaN never is).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from annbench import spec
from annbench.reference import knn, recall


@dataclasses.dataclass
class Ctx:
    k: int
    n: int
    ids: np.ndarray  # (P, k) answered ids
    dists: np.ndarray  # (P, k) answered distances
    gt_ids: np.ndarray  # (P, k) exact, by (distance, id)
    gt_d: np.ndarray  # (P, k) float64
    d64: np.ndarray  # (P, k) float64 distances of the answered ids, NaN if invalid
    points: torch.Tensor
    state: dict | None = None  # what the program's set-up derived

    @functools.cached_property
    def well_formed(self) -> np.ndarray:
        """(P,) answers of k distinct valid ids with finite distances in
        nondecreasing order."""
        ids = self.ids.astype(np.int64)
        ok = ((ids >= 0) & (ids < self.n)).all(axis=1)
        s = np.sort(ids, axis=1)
        ok &= ~(s[:, 1:] == s[:, :-1]).any(axis=1)
        d = self.dists.astype(np.float64)
        ok &= np.isfinite(d).all(axis=1)
        with np.errstate(invalid="ignore"):  # inf - inf in a row already refused
            ok &= ~(np.diff(d, axis=1) < 0).any(axis=1)
        return ok

    @functools.cached_property
    def recall(self) -> float:
        return recall.compute_recall(self.ids, self.gt_ids, self.gt_d, self.k)

    @property
    def scale(self) -> np.ndarray:
        """(P,) each query's exact k-th distance: the scale of its errors."""
        return np.maximum(self.gt_d[:, self.k - 1], 1e-30)


def context(points, n, queries, ids, dists, gt, state=None) -> Ctx:
    k = ids.shape[1]
    return Ctx(k=k, n=n, ids=ids, dists=dists, gt_ids=gt[0][:, :k], gt_d=gt[1][:, :k],
               d64=knn.answer_dist64(points, n, queries, ids), points=points,
               state=state)


def numbers(ctx: Ctx, names) -> dict:
    return {name: float(spec.check(name).compute(ctx)) for name in names}


def judge(values: dict, limits: dict) -> bool:
    return all(not math.isnan(values[k]) and values[k] <= limits[k] for k in limits)
