"""Vamana / DiskANN builder — batch-synchronous prefix-doubling insertion.

Counterpart of parlayann_tpu/build/vamana.py (vamana/index.h:150-316). Each
batch runs four phases on the device:

  batched beam search, recording visited   index.h:247-266  (search/beam.py)
    -> robustPrune of the forward edges    index.h:63-120   (kernel 2)
    -> write the forward rows              index.h:268-270
    -> reverse-edge exchange + overflow
       α-prune                             index.h:278-300  (kernel 2)

The host slices the shuffled insert order into the prefix-doubling schedule
(1, 2, 4, ..., then batches of ``batch_cap_frac * n``). Passes: all but the
last run with alpha = 1, the last with ``alpha`` (index.h:171-176). Rows are
sorted by distance once at the end (index.h:180-185). Steady batches (at
least max(max_batch, 4096) wide) read candidate vectors through kernel 1
from an inline neighbour-vector array rebuilt for the batch, unless that
array would pass INLINE_BUDGET bytes (JAX vamana.py:524-534): then they
gather rows. Builds run on int8 points (the q8 tier, the default) or on
the float32 points themselves (``quantize_build=False``; uint8 points on
an exact float32 copy); distances are float32 either way.

Not ported yet: ``cand_mode="exact"``, the fused read phase
(``build_beam_fused``), ``single_batch`` and ``profile``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.ops import distance, quantize
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels.expand import build_inline
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.build.prune import robust_prune_chunked
from parlayann_tpu_torch.build.reverse import (
    prepare_reverse_append, prune_reverse_all, scatter_rows,
)

# read-phase vertices expanded per beam step: the JAX package's shipped
# default (vamana.py:590) — it shapes the graph, so parity needs it
READ_EXPAND = 2
# the largest inline array the read phase builds (JAX vamana.py:530): the
# f32 array at 100K x 128, R=32 is 1.64 GB, at 1M 16.4 GB, which gathers
INLINE_BUDGET = 6 << 30


class BuildStats(NamedTuple):
    """Wall seconds (fenced on CUDA) and the read phase's total visits
    and distance computations. The JAX package's t_beam/t_bidirect/t_prune
    split (its ``profile`` mode) is not ported."""

    build_time: float
    total_visited: int
    total_cmps: int


def _read_phase(nbrs, degs, points_data, batch_ids, start, inline, *, R, L,
                vmax, metric, n_valid):
    """Beam search from the start point with k = 0 (no cut), recording the
    visited list; candidates = visited ∪ current out-edges (index.h:70-76,
    :251-262)."""
    safe_ids = batch_ids.long().clamp(0, points_data.shape[0] - 1)
    queries = points_data[safe_ids]
    res = beam_search_batch(
        queries, points_data, nbrs, degs, start, batch_ids, inline,
        metric=metric, n_valid=n_valid, k=0, L=L, limit=vmax,
        expand=READ_EXPAND, record_visited=True, exclude_self=True,
    )
    old_row = nbrs[safe_ids]
    old_ok = torch.arange(R, device=nbrs.device)[None, :] < degs[safe_ids][:, None]
    old_vecs = points_data[old_row.long().clamp(0, points_data.shape[0] - 1)]
    old_d = torch.where(old_ok, distance.gathered(queries, old_vecs, metric), INF)
    cand_ids = torch.cat([res.visited_ids, old_row], dim=1)
    cand_d = torch.cat([res.visited_dists, old_d], dim=1)
    return cand_ids, cand_d, res.num_visited.sum(), res.dist_cmps.sum()


def _write_batch(nbrs, degs, points_data, batch_ids, cand_ids, cand_d, alpha,
                 *, R, metric, n_valid, chunk=2048, rev_chunk=4096):
    """Forward robustPrune + row write, reverse append, overflow α-prune."""
    n_pad = nbrs.shape[0]
    pr = robust_prune_chunked(batch_ids, cand_ids, cand_d, points_data, alpha,
                              R=R, metric=metric, n_valid=n_valid, chunk=chunk)
    wt = torch.where(batch_ids >= 0, batch_ids, n_pad)
    nbrs, degs = scatter_rows(nbrs, degs, wt, pr.ids, pr.degree)
    nbrs, degs, ctx = prepare_reverse_append(
        nbrs, degs, batch_ids, pr.ids, pr.dists, R=R, n_valid=n_valid)
    nbrs, degs = prune_reverse_all(nbrs, degs, ctx, points_data, alpha, R=R,
                                   metric=metric, n_valid=n_valid,
                                   chunk=rev_chunk)
    return nbrs, degs


def _sort_rows_by_distance(nbrs, degs, points_data, *, R, metric, chunk=8192):
    """Final per-row sort of neighbours by distance (index.h:180-185)."""
    n_pad = nbrs.shape[0]
    rcol = torch.arange(R, device=nbrs.device)[None, :]
    for lo in range(0, n_pad, chunk):
        row = nbrs[lo:lo + chunk]
        ok = rcol < degs[lo:lo + chunk][:, None]
        nvec = points_data[row.long().clamp(0, n_pad - 1)]
        d = torch.where(ok, distance.gathered(points_data[lo:lo + chunk], nvec,
                                              metric), INF)
        nbrs[lo:lo + chunk] = lexsort((d,), row)[1]
    return nbrs


def batch_schedule(m: int, n: int, max_fraction: float = 0.02, base: float = 2.0):
    """Prefix-doubling batch boundaries (index.h:206-233): [2^i-1, 2^{i+1}-1)
    until the max_fraction * n (at most 1M) cap, then fixed-size batches."""
    max_batch = min(int(max_fraction * n), 1_000_000)
    if max_batch == 0:
        max_batch = n
    out = []
    inc, count = 0, 0
    while count < m:
        if base**inc <= max_batch:
            floor = int(base**inc) - 1
            ceiling = min(int(base ** (inc + 1)) - 1, m)
            count = ceiling
        else:
            floor = count
            ceiling = min(count + max_batch, m)
            count = ceiling
        if ceiling > floor:
            out.append((floor, ceiling))
        inc += 1
    return out, max_batch


def _pad_pow2(ids: np.ndarray, cap: int, min_size: int = 256) -> np.ndarray:
    """Pad a batch to a power of two, at least ``min_size`` wide and at most
    ``cap`` (pad slots are -1 = inactive) — the JAX package's batch shapes,
    kept so both packages run the same searches and count the same visits."""
    b = len(ids)
    size = 1
    while size < b:
        size *= 2
    size = max(size, min_size)
    size = min(size, cap) if cap >= b else size
    if size < b:
        size = b
    out = np.full(size, -1, dtype=np.int32)
    out[:b] = ids
    return out


def build_vamana_graph(points: PointSet, bp: BuildParams,
                       verbose: bool = False) -> tuple[GraphIndexData, BuildStats]:
    """Build a Vamana graph over ``points`` (on ``points.device``)."""
    if bp.single_batch:
        raise NotImplementedError(
            "single_batch builds are not ported; see ROADMAP queue 1, "
            '"The rest of the Vamana builder"')
    n = points.n
    R, L = bp.R, bp.L
    dev = points.device
    # visit budget of the insertion search (vamana.py:477)
    vmax = max(L, R + 16)
    nbrs = torch.zeros((points.n_pad, R), dtype=torch.int32, device=dev)
    degs = torch.zeros((points.n_pad,), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(bp.seed)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)  # index.h:143
    sched, max_batch = batch_schedule(n, n, bp.batch_cap_frac)
    R8 = (R + 7) // 8 * 8
    inline_ok = (points.n_pad * R8 * points.d * points.data.element_size()
                 <= INLINE_BUDGET)

    t0 = time.perf_counter()
    tot_vis = torch.zeros((), dtype=torch.int64, device=dev)
    tot_cmp = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(bp.num_passes):
        alpha = bp.alpha if p == bp.num_passes - 1 else 1.0
        order = rng.permutation(n).astype(np.int32)
        for bi, (lo, hi) in enumerate(sched):
            batch = torch.from_numpy(_pad_pow2(order[lo:hi], max_batch)).to(dev)
            inline = (build_inline(points.data, nbrs)
                      if inline_ok and (hi - lo) >= max(max_batch, 4096) else None)
            cand_ids, cand_d, v, c = _read_phase(
                nbrs, degs, points.data, batch, start, inline,
                R=R, L=L, vmax=vmax, metric=points.metric, n_valid=n)
            del inline
            nbrs, degs = _write_batch(
                nbrs, degs, points.data, batch, cand_ids, cand_d, alpha,
                R=R, metric=points.metric, n_valid=n)
            tot_vis += v
            tot_cmp += c
            if verbose and bi % 8 == 0:
                print(f"pass {p}: batch {bi + 1}/{len(sched)} ({hi}/{n})",
                      flush=True)

    nbrs = _sort_rows_by_distance(nbrs, degs, points.data, R=R,
                                  metric=points.metric)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    graph = GraphIndexData(neighbors=nbrs, degrees=degs, n=n, max_degree=R)
    stats = BuildStats(dt, int(tot_vis), int(tot_cmp))
    if verbose:
        avg, mx = graph.stats()
        print(f"Vamana build: {dt:.2f}s  avg/max degree {avg:.2f}/{mx}  "
              f"visited {stats.total_visited}  cmps {stats.total_cmps}")
    return graph, stats


def build_vamana_index(
    data,
    metric: Metric = Metric.L2,
    R: int = 64,
    L: int = 128,
    alpha: float = 1.2,
    two_pass: bool = True,
    quantize_build: bool = True,
    verbose: bool = False,
    seed: int = 0,
    batch_cap_frac: float = 0.02,
    device=None,
):
    """diskannpy-style wrapper (python/builder.cpp:40-90): MIPS data is
    normalized with a dimension-dependent alpha, and float or uint8 inputs
    build on the q8 tier unless ``quantize_build=False``, which builds on
    the float32 points (uint8: an exact float32 copy); search reranks at
    full precision. Returns (graph, full-precision PointSet, BuildStats). ``data`` is an array, placed on
    ``device`` (None: the card), or a PointSet (which keeps its own
    device)."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric, normalize=(metric is Metric.MIPS),
        device=device)
    if metric is Metric.MIPS and ps.d <= 200:
        alpha = 1.0 if ps.d < 100 else 0.98
    build_ps = quantize.build_tier(ps, quantize_build)
    bp = BuildParams(R=R, L=L, alpha=alpha, num_passes=2 if two_pass else 1,
                     seed=seed, batch_cap_frac=batch_cap_frac)
    graph, stats = build_vamana_graph(build_ps, bp, verbose=verbose)
    return graph, ps, stats
