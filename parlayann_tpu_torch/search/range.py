"""Range search: every point within a radius.

Counterpart of parlayann_tpu/search/range.py (range_search, beamSearch.h:
245-306; the reference's self-join, vamanaRange/neighbors.h:93-117). The
BFS is the lock-step machinery of search/beam.py with radius admission in
place of top-L trimming. Its state is a capped in-range set with
expanded flags. Each step

  1. selects the first E unexpanded in-range entries of each active query
     (cumsum over the unexpanded mask, then one stable sort by position),
  2. gathers their neighbours' rows and computes the E*R candidate
     distances in the diff² form (``ops/distance.gathered``),
  3. admits candidates with ``dd <= radius_2`` and merges them into the
     set with the hashless dedup of search/beam.py:_merge.

A query is done when its set holds no unexpanded entry. The set is capped
at ``cap`` entries (the reference's is unbounded): ``counts == cap`` means
the set may have been cut, so callers raise the cap. No hand-written
kernel runs here; the JAX package runs no Pallas kernel on this path
either. Tensors stay on the device the caller put them on.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import distance
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.search.beam import _merge, beam_search_batch


class RangeResult(NamedTuple):
    ids: torch.Tensor  # (B, cap) in-range ids, -1 padded, dist-ascending
    dists: torch.Tensor  # (B, cap) f32 (INF in empty slots)
    counts: torch.Tensor  # (B,) number found (== cap: possibly truncated)
    dist_cmps: torch.Tensor  # (B,) int32


def _on(x, device: torch.device) -> torch.Tensor:
    """A tensor as it is; an array placed on ``device``."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x)).to(device)


def range_search_batch(
    queries: torch.Tensor,  # (B, d)
    points_data: torch.Tensor,  # (n_pad, d)
    nbrs: torch.Tensor,  # (n_pad, R) int32
    degs: torch.Tensor,  # (n_pad,) int32
    starts: torch.Tensor,  # (S,) or (B, S) per-query seeds, -1 for none
    radius_2,
    self_ids: Optional[torch.Tensor] = None,  # (B,) id to exclude
    *,
    metric: Metric,
    n_valid: int,
    cap: int = 256,
    expand: int = 2,
    exclude_self: bool = False,
) -> RangeResult:
    """Batched BFS within ``radius_2`` (beamSearch.h:245-306). With
    ``exclude_self``, ``self_ids`` are dropped from the seeds and from
    every step's candidates."""
    B = queries.shape[0]
    dev = queries.device
    R = int(nbrs.shape[1])
    E = expand
    K = E * R
    n_pad = points_data.shape[0]
    r2 = torch.tensor(float(radius_2), dtype=torch.float32, device=dev)
    excl = exclude_self and self_ids is not None

    def cand_distances(ids, valid):
        vecs = points_data[ids.long().clamp(0, n_pad - 1)]
        dd = distance.gathered(queries, vecs, metric)
        return torch.where(valid & (dd <= r2), dd, INF)

    if starts.dim() == 1:
        starts = starts[None, :].expand(B, -1)
    S = starts.shape[1]
    sv = (starts >= 0) & (starts < n_valid)
    if excl:
        sv &= starts != self_ids[:, None]
    sd = cand_distances(starts, sv)
    sids = torch.where(sd < INF, starts.to(torch.int32),
                       n_valid + torch.arange(S, dtype=torch.int32, device=dev)[None, :])

    set_ids = (n_valid + S + torch.arange(cap, dtype=torch.int32, device=dev)
               )[None, :].expand(B, cap)
    set_dists = torch.full((B, cap), INF, device=dev)
    set_exp = torch.zeros((B, cap), dtype=torch.int32, device=dev)
    set_ids, set_dists, set_exp = _merge(set_ids, set_dists, set_exp, sids, sd, cap)
    dist_cmps = sv.sum(dim=1, dtype=torch.int32)
    done = ~((set_exp == 0) & (set_dists < INF)).any(dim=1)
    pos_c = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    slot = torch.arange(R, device=dev)[None, None, :]
    sent_c = n_valid + torch.arange(K, dtype=torch.int32, device=dev)[None, :]

    # one host sync a step, as the lock-step beam search
    while bool((~done).any()):
        active = ~done
        # -- 1. the first E unexpanded in-range entries, in set order --
        unexp = (set_exp == 0) & (set_dists < INF)
        cum = torch.cumsum(unexp.to(torch.int32), dim=1)
        newly = unexp & (cum <= (active.to(torch.int32) * E)[:, None])
        set_exp = set_exp + newly.to(torch.int32)
        skey, sidv = lexsort((torch.where(newly, pos_c, cap),), set_ids)
        valid_e = skey[:, :E] < cap
        exp_ids = torch.where(valid_e, sidv[:, :E], 0)

        # -- 2. candidate ids and distances --
        erow = exp_ids.long().clamp(0, nbrs.shape[0] - 1)
        v = (slot < degs[erow][:, :, None]) & valid_e[:, :, None]
        cand_ids = nbrs[erow].reshape(B, K)
        cand_valid = v.reshape(B, K) & (cand_ids >= 0) & (cand_ids < n_valid)
        if excl:
            cand_valid &= cand_ids != self_ids[:, None]
        dist_cmps = dist_cmps + torch.where(
            active, cand_valid.sum(dim=1, dtype=torch.int32), 0).to(torch.int32)
        cand_d = cand_distances(cand_ids, cand_valid)
        cand_ids = torch.where(cand_d < INF, cand_ids, sent_c)

        # -- 3. radius-admitted merge --
        ni, nd, ne = _merge(set_ids, set_dists, set_exp, cand_ids, cand_d, cap)
        new_done = done | ~((ne == 0) & (nd < INF)).any(dim=1)
        sel = active[:, None]
        set_ids = torch.where(sel, ni, set_ids)
        set_dists = torch.where(sel, nd, set_dists)
        set_exp = torch.where(sel, ne, set_exp)
        done = new_done

    found = set_dists < INF
    return RangeResult(torch.where(found, set_ids, -1), set_dists,
                       found.sum(dim=1, dtype=torch.int32), dist_cmps)


def range_query(queries, points_data, nbrs, degs, start_point: int, rad: float,
                initial_beam: int = 45, cap: int = 256, *, metric: Metric,
                n_valid: int) -> RangeResult:
    """Query-driven range search (RangeParams, check_range_recall.h): a
    beam search of width ``initial_beam`` from ``start_point`` finds the
    in-range seeds, then the BFS collects the rest of the range. An array
    of queries goes to the points' device; a tensor stays where it is."""
    q = _on(queries, points_data.device)
    res = beam_search_batch(
        q, points_data, nbrs, degs,
        torch.tensor([start_point], dtype=torch.int32, device=q.device),
        metric=metric, n_valid=n_valid, k=0, L=initial_beam)
    rad32 = torch.tensor(float(rad), dtype=torch.float32, device=q.device)
    seeds = torch.where(res.beam_dists <= rad32, res.beam_ids, -1)
    return range_search_batch(q, points_data, nbrs, degs, seeds, rad,
                              metric=metric, n_valid=n_valid, cap=cap)


def self_join_rows(points_data, nbrs, degs, ids: torch.Tensor, radius_2, *,
                   metric: Metric, n_valid: int, cap: int = 256) -> RangeResult:
    """The self-join's BFS for the base rows ``ids`` (any order, ids past
    the last point allowed): each row is its own query, seeded by its own
    out-neighbours, itself excluded. A row's result does not depend on the
    other rows of the call."""
    n_pad = points_data.shape[0]
    rows = ids.long().clamp(0, n_pad - 1)
    own = nbrs[rows]
    own = torch.where(
        torch.arange(own.shape[1], device=own.device)[None, :] < degs[rows][:, None],
        own, -1)
    return range_search_batch(points_data[rows], points_data, nbrs, degs, own,
                              radius_2, ids, metric=metric, n_valid=n_valid,
                              cap=cap, exclude_self=True)


def self_join(points_data, nbrs, degs, radius: float, radius_2: float, *,
              metric: Metric, n_valid: int, cap: int = 256, batch: int = 4096):
    """Range self-join (vamanaRange/neighbors.h:93-117): for every base
    point, BFS from its own out-neighbours within ``radius_2``, then report
    the matches within ``radius``. Returns (list of int32 id arrays, one a
    point, total distance comparisons)."""
    out = []
    total_cmps = 0
    for lo in range(0, n_valid, batch):
        hi = min(lo + batch, n_valid)
        idxs = torch.arange(lo, lo + batch, dtype=torch.int32, device=points_data.device)
        rr = self_join_rows(points_data, nbrs, degs, idxs, radius_2,
                            metric=metric, n_valid=n_valid, cap=cap)
        ids = rr.ids[: hi - lo].cpu().numpy()
        ds = rr.dists[: hi - lo].cpu().numpy()
        total_cmps += int(rr.dist_cmps[: hi - lo].sum())
        # vectorised row split: one mask and cumsum offsets a batch (a
        # per-row loop costs minutes at SSNPP's n)
        m = (ids >= 0) & (ds <= radius)
        flat = ids[m].astype(np.int32)  # row-major: rows stay contiguous
        offs = np.cumsum(m.sum(axis=1))[:-1]
        out.extend(np.split(flat, offs))
    return out, total_cmps
