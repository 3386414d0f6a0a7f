"""Tie-aware recall, a frozen copy of the port's
``harness/recall.py:compute_recall`` (the reference's checkRecall,
check_nn_recall.h:83-109): ground-truth entries past position k whose
distance equals the k-th distance also count as correct. Computed in
blocks of queries so that the (B, k, kg) comparison stays small."""

from __future__ import annotations

import numpy as np


def compute_recall(result_ids: np.ndarray, gt_ids: np.ndarray,
                   gt_dists: np.ndarray | None = None, k: int = 10,
                   block: int = 4096) -> float:
    """k@k recall of (B, >= k) answers against (B, kg >= k) ground truth."""
    B = result_ids.shape[0]
    if gt_ids.shape[1] < k:
        raise ValueError(f"{k}@{k} too large for ground truth of size {gt_ids.shape[1]}")
    kg = gt_ids.shape[1]
    correct = 0
    for lo in range(0, B, block):
        res = result_ids[lo:lo + block, :k]
        gi = gt_ids[lo:lo + block]
        b = res.shape[0]
        if gt_dists is not None and kg > k:
            gd = gt_dists[lo:lo + block]
            tie = np.concatenate([np.ones((b, k), dtype=bool), gd[:, k:] == gd[:, k - 1:k]],
                                 axis=1)
        else:
            tie = np.zeros((b, kg), dtype=bool)
            tie[:, :k] = True
        match = res[:, :, None] == gi[:, None, :]
        match &= tie[:, None, :]
        match &= res[:, :, None] >= 0
        correct += int(match.any(axis=2).sum())
    return correct / (B * k)
