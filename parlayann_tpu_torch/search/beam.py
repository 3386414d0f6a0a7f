"""Batched beam search — the build's read phase.

Counterpart of parlayann_tpu/search/beam.py:beam_search_batch. B queries
advance in lock-step; each step

  1. selects the E closest unexpanded beam entries per query (cumsum over
     the unexpanded mask, no scatter),
  2. computes the E*R candidate distances, through kernel 1
     (``expand_distances`` over an inline neighbour-vector array) when one
     is given, else by gathering the candidate rows,
  3. drops candidates at or beyond the beam's L-th distance and merges the
     rest into the beam with two stable sorts: by packed (id, unexpanded
     bit), where an adjacent equal id is a duplicate and the expanded copy
     wins, then by distance — the hashless dedup of the JAX package,
  4. stops a query when no unexpanded entry lies within ``cut`` times the
     k-th distance (metric, k > 0 only) or when ``limit`` expansions are
     spent.

With ``record_visited`` it runs exactly ceil(limit / E) steps and returns
the expansion sequence as the visited list (the candidates robustPrune
reads). ``bits=1`` searches a packed 1-bit tier: queries and points are
int32 words and distances are XOR + popcount hamming counts, through
``expand_distances(bits=1)`` (kernel 6) when an inline word array is given.
``bits=2`` and ``bits=4`` search the MIPS 2-bit and 4-bit tiers by
gathering their rows (ternary words, packed nibbles), as the JAX package
does.

``filter_data``/``filter_queries`` turn on the reference's two-tier filter
(beamSearch.h:119-146): once the frontier is full, each step adds the
cheap-tier distance from the query to the frontier's worst entry to a
running mean, and candidates whose cheap-tier distance is at or beyond that
mean are dropped before their distance is kept.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import distance, quantize
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels.expand import expand_distances
from parlayann_tpu_torch.ops.topk import lexsort


class BeamResult(NamedTuple):
    beam_ids: torch.Tensor  # (B, L) int32, dist-sorted; -1 in empty slots
    beam_dists: torch.Tensor  # (B, L) f32 (INF in empty slots)
    visited_ids: torch.Tensor  # (B, vmax) int32 in expansion order
    visited_dists: torch.Tensor  # (B, vmax) f32
    num_visited: torch.Tensor  # (B,) int32
    dist_cmps: torch.Tensor  # (B,) int32


def _has_work(beam_dists, beam_exp, k: int, L: int, cut: float, metric: Metric):
    """Any unexpanded beam entry worth expanding (cut rule included)?"""
    unexp = (beam_exp == 0) & (beam_dists < INF)
    if k > 0 and metric.is_metric and k < L:
        thr = torch.clamp(cut * beam_dists[:, k:k + 1], max=INF)
        return (unexp & (beam_dists < thr)).any(dim=1)
    return unexp.any(dim=1)


def _merge(beam_ids, beam_dists, beam_exp, cand_ids, cand_dists, L: int):
    """Dedup-union beam with candidates, keep the L closest. The first
    stable sort by packed (id, unexpanded bit) puts copies of one id
    adjacent with the expanded copy first; later copies become INF. The
    array is then in packed order, so a stable sort by distance yields the
    lexicographic (dist, packed) order."""
    ids = torch.cat([beam_ids, cand_ids], dim=1)
    dists = torch.cat([beam_dists, cand_dists], dim=1)
    exp = torch.cat([beam_exp, torch.zeros_like(cand_ids)], dim=1)
    packed = ids * 2 + (1 - exp.clamp(max=1))
    spacked, sdist = lexsort((packed,), dists)
    sid = spacked >> 1
    dup = torch.cat([torch.zeros_like(sid[:, :1], dtype=torch.bool),
                     sid[:, 1:] == sid[:, :-1]], dim=1)
    sdist = torch.where(dup, INF, sdist)
    ndist, npacked = lexsort((sdist,), spacked)
    return npacked[:, :L] >> 1, ndist[:, :L], 1 - (npacked[:, :L] & 1)


def beam_search_batch(
    queries: torch.Tensor,  # (B, d) in the points' storage domain
    points_data: torch.Tensor,  # (n_pad, d)
    nbrs: torch.Tensor,  # (n_pad, R) int32
    degs: torch.Tensor,  # (n_pad,) int32
    starts: torch.Tensor,  # (S,) or (B, S) int32 start vertices
    self_ids: Optional[torch.Tensor] = None,  # (B,) id to exclude
    inline: Optional[torch.Tensor] = None,  # (n_pad, R8, d or W) inline rows
    *,
    metric: Metric,
    n_valid: int,
    k: int = 10,
    L: int = 128,
    cut: float = 1.35,
    limit: int = 2**30,
    degree_limit: int = 2**30,
    expand: int = 1,
    record_visited: bool = False,
    exclude_self: bool = False,
    bits: int = 32,
    filter_data: Optional[torch.Tensor] = None,  # (n_pad, d) cheap-tier rows
    filter_queries: Optional[torch.Tensor] = None,  # (B, d) tier-domain queries
) -> BeamResult:
    """(See module docstring.)"""
    B = queries.shape[0]
    dev = queries.device
    R = int(nbrs.shape[1])
    rwidth = min(R, degree_limit)
    E = expand
    K = E * rwidth
    limit = min(limit, n_valid)
    cut = torch.tensor(cut, dtype=torch.float32, device=dev)
    n_pad = points_data.shape[0]

    if starts.dim() == 1:
        starts = starts[None, :].expand(B, -1)
    S = starts.shape[1]

    tier_distance = {1: quantize.hamming_distance, 2: quantize.mips_2bit_distance,
                     4: quantize.mips_4bit_distance}.get(
        bits, lambda q, v: distance.gathered(q, v, metric))
    use_filter = filter_data is not None and filter_queries is not None

    def gather_distances(ids, valid):
        vecs = points_data[ids.long().clamp(0, n_pad - 1)]
        return torch.where(valid, tier_distance(queries, vecs), INF)

    # ---- init: seed the beam with the start points. Self-exclusion applies
    # to neighbour candidates only, never to seeds. ----
    start_valid = (starts >= 0) & (starts < n_valid)
    start_dists = gather_distances(starts, start_valid)
    sent_s = n_valid + torch.arange(S, dtype=torch.int32, device=dev)[None, :]
    start_ids = torch.where(start_valid, starts.to(torch.int32), sent_s)
    beam_ids = (n_valid + S + torch.arange(L, dtype=torch.int32, device=dev)
                )[None, :].expand(B, L)
    beam_dists = torch.full((B, L), INF, device=dev)
    beam_exp = torch.zeros((B, L), dtype=torch.int32, device=dev)
    beam_ids, beam_dists, beam_exp = _merge(
        beam_ids, beam_dists, beam_exp, start_ids, start_dists, L)
    num_visited = torch.zeros(B, dtype=torch.int32, device=dev)
    dist_cmps = start_valid.sum(dim=1, dtype=torch.int32)
    done = ~(beam_dists < INF).any(dim=1)
    f_sum = torch.zeros(B, dtype=torch.float32, device=dev)
    f_cnt = torch.zeros(B, dtype=torch.int32, device=dev)

    slot = torch.arange(rwidth, device=dev)[None, None, :]
    sent_c = n_valid + torch.arange(K, dtype=torch.int32, device=dev)[None, :]
    brow_l = torch.arange(L, dtype=torch.int32, device=dev)[None, :]

    def step():
        nonlocal beam_ids, beam_dists, beam_exp, num_visited, dist_cmps, done
        nonlocal f_sum, f_cnt
        active = ~done
        # -- 1. the first E unexpanded entries in beam order --
        unexp = (beam_exp == 0) & (beam_dists < INF)
        budget = torch.where(active, (limit - num_visited).clamp(max=E), 0)
        cum = torch.cumsum(unexp.to(torch.int32), dim=1)
        newly = unexp & (cum <= budget[:, None])
        beam_exp = beam_exp + newly.to(torch.int32)
        n_new = newly.sum(dim=1, dtype=torch.int32)
        if E == 1:
            pos = newly.to(torch.int32).argmax(dim=1)[:, None]
            exp_ids = beam_ids.gather(1, pos)
            exp_dists = beam_dists.gather(1, pos)
            valid_e = n_new[:, None] > 0
        else:
            key = torch.where(newly, brow_l, L)
            skey, sids, sdists = lexsort((key,), beam_ids, beam_dists)
            exp_ids, exp_dists = sids[:, :E], sdists[:, :E]
            valid_e = skey[:, :E] < L
        exp_ids_c = torch.where(valid_e, exp_ids, 0)

        # -- 2. candidate ids + distances --
        erow = exp_ids_c.long().clamp(0, n_pad - 1)
        rows = nbrs[erow][:, :, :rwidth]  # degree_limit (beamSearch.h:130)
        rdeg = degs[erow]
        v = (slot < rdeg[:, :, None]) & valid_e[:, :, None]
        cand_ids = rows.reshape(B, K)
        cand_valid = v.reshape(B, K) & (cand_ids >= 0) & (cand_ids < n_valid)
        if exclude_self and self_ids is not None:
            cand_valid &= cand_ids != self_ids[:, None]
        dist_cmps_new = dist_cmps + cand_valid.sum(dim=1, dtype=torch.int32)
        if use_filter:
            # the running mean of the cheap-tier distance to the frontier's
            # worst entry, updated before this step's candidates are dropped
            frontier_full = beam_dists[:, L - 1] < INF
            back = filter_data[beam_ids[:, L - 1].long().clamp(0, filter_data.shape[0] - 1)]
            cheap_back = distance.gathered(filter_queries, back[:, None, :], metric)[:, 0]
            upd = active & frontier_full
            f_sum = f_sum + torch.where(upd, cheap_back, 0.0)
            f_cnt = f_cnt + upd.to(torch.int32)
            thr = f_sum / f_cnt.clamp(min=1).float()
            cvec = filter_data[cand_ids.long().clamp(0, filter_data.shape[0] - 1)]
            cheap_c = distance.gathered(filter_queries, cvec, metric)
            cand_valid &= ~((frontier_full & (f_cnt > 0))[:, None] & (cheap_c >= thr[:, None]))
        if inline is not None:
            # packed words stay int32; the int8 kernel takes f32 queries
            qrep = queries if bits == 1 else queries.float()
            if E > 1:
                qrep = qrep.repeat_interleave(E, dim=0)
            dmat = expand_distances(inline, exp_ids_c.reshape(B * E).contiguous(),
                                    qrep.contiguous(), metric=metric, bits=bits)
            cand_dists = dmat.reshape(B, E, -1)[:, :, :rwidth].reshape(B, K)
            cand_dists = torch.where(cand_valid, cand_dists, INF)
        else:
            cand_dists = gather_distances(cand_ids, cand_valid)

        # -- 3. frontier-full cutoff (beamSearch.h:150-159) + merge --
        cand_dists = torch.where(cand_dists >= beam_dists[:, L - 1:L], INF,
                                 cand_dists)
        cand_ids = torch.where(cand_dists < INF, cand_ids, sent_c)
        nb_ids, nb_dists, nb_exp = _merge(
            beam_ids, beam_dists, beam_exp, cand_ids, cand_dists, L)

        # -- 4. cut-rule early stop + visit budget (beamSearch.h:185-195) --
        num_visited_new = num_visited + n_new
        new_done = done | ~_has_work(nb_dists, nb_exp, k, L, cut, metric)
        new_done |= num_visited_new >= limit
        sel = active[:, None]
        beam_ids = torch.where(sel, nb_ids, beam_ids)
        beam_dists = torch.where(sel, nb_dists, beam_dists)
        beam_exp = torch.where(sel, nb_exp, beam_exp)
        num_visited = torch.where(active, num_visited_new, num_visited)
        dist_cmps = torch.where(active, dist_cmps_new, dist_cmps)
        done = new_done
        return exp_ids, exp_dists, valid_e & active[:, None]

    if record_visited:
        T = max(1, math.ceil(limit / E))
        vis = [step() for _ in range(T)]
        vis_ids = torch.cat([v[0] for v in vis], dim=1)
        vis_dists = torch.cat(
            [torch.where(v[2], v[1], INF) for v in vis], dim=1)
    else:
        while bool((~done).any()):
            step()
        vis_ids = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        vis_dists = torch.full((B, 1), INF, device=dev)

    out_ids = torch.where(beam_dists < INF, beam_ids, -1)
    return BeamResult(out_ids, beam_dists, vis_ids, vis_dists, num_visited,
                      dist_cmps)


def top_k_from_beam(res: BeamResult, k: int):
    """First k frontier entries -> (ids, dists); -1 id for missing."""
    return res.beam_ids[:, :k], res.beam_dists[:, :k]


def beam_search_random(queries, points_data, nbrs, degs, *, n_starts: int = 1,
                       seed: int = 0, **kw) -> BeamResult:
    """beamSearchRandom (beamSearch.h:309-351): every query starts from
    ``n_starts`` uniformly random vertices,
    ``np.random.default_rng(seed).integers(0, n_valid, (B, n_starts),
    dtype=np.int32)``, the JAX package's draw (beam.py:392; an int32 draw,
    where ``Index.batch_search`` draws int64). Other keyword arguments go
    to :func:`beam_search_batch`."""
    B = queries.shape[0]
    n_valid = kw.get("n_valid", points_data.shape[0])
    rs = np.random.default_rng(seed).integers(0, n_valid, (B, n_starts), dtype=np.int32)
    return beam_search_batch(queries, points_data, nbrs, degs,
                             torch.from_numpy(rs).to(queries.device), **kw)
