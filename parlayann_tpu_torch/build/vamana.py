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

The build modes of the JAX package:

- ``single_batch`` (index.h:156-169, :239; JAX vamana.py:500-511): random
  initial edges, ``min(single_batch, R)`` a row drawn from the build's
  generator before the pass permutations, then one batch of all n points a
  pass, each point's search starting at itself;
- ``cand_mode="exact"`` (JAX ``_exact_phase_impl``, vamana.py:177-266):
  the read phase's candidates are the exact top-k of the inserted prefix
  (a mask kept on the device) and of a ladder of uniform samples (drawn
  from ``seed + 7919``), through kernel 4's masked mode with each point's
  own id excluded, on the card; samples of up to 2048 rows take the plain
  scan, as JAX's "sort" select;
- ``profile=True``: the same build with a device fence after each phase,
  filling BuildStats' beam, bidirect and prune seconds (index.h:217-222);
  ``profile_one_batch`` times the three phases of one steady batch;
- ``fused_read=True`` (JAX ``PARLAYANN_BUILD_FUSED=1``, vamana.py:536-577;
  off by default there and here): steady batches read through
  ``_fused_read_phase``, one launch of kernel 3's build mode
  (``build_beam_fused``) a batch, walking each insert for up to vmax
  single expansions, in place of the lock-step read's kernel 1 launch a
  step. Ramp batches and the partial last batch keep the lock-step read,
  as in JAX.
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
from parlayann_tpu_torch.ops.kernels.fusedbeam import build_beam_fused
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.search.flat import flat_search_batch
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
    """The JAX package's fields in its order (vamana.py:99-106): wall
    seconds (fenced on CUDA); the beam, bidirect and prune seconds of a
    ``profile=True`` build (index.h:217-219; 0 otherwise); the read phase's
    total visits and distance computations; ``n_fallback`` (always 0, as in
    JAX)."""

    build_time: float
    beam_time: float
    bidirect_time: float
    prune_time: float
    total_visited: int
    total_cmps: int
    n_fallback: int


class _Laps:
    """The fenced phase split of a profiled build: ``laps(name)`` adds the
    seconds since the last lap, after a device fence, to ``times[name]``
    (``None``: restart the clock). Off (``on=False``), it does nothing and
    the times stay 0."""

    def __init__(self, dev: torch.device, on: bool = True):
        self.dev, self.on = dev, on
        self.times = {"beam": 0.0, "bidirect": 0.0, "prune": 0.0}
        self.t = time.perf_counter()

    def __call__(self, name):
        if not self.on:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        if name:
            self.times[name] += now - self.t
        self.t = now


def _old_candidates(nbrs, degs, points_data, safe_ids, queries, *, R, metric):
    """The current out-edges of the batch's points and their distances
    (add = true, index.h:70-76)."""
    old_row = nbrs[safe_ids]
    old_ok = torch.arange(R, device=nbrs.device)[None, :] < degs[safe_ids][:, None]
    old_vecs = points_data[old_row.long().clamp(0, points_data.shape[0] - 1)]
    return old_row, torch.where(old_ok, distance.gathered(queries, old_vecs, metric), INF)


def _read_phase(nbrs, degs, points_data, batch_ids, start, inline, *, R, L,
                vmax, metric, n_valid, expand=READ_EXPAND):
    """Beam search from the start point (or each point from itself, the
    ``(B, 1)`` starts of a single-batch build) with k = 0 (no cut),
    expanding ``expand`` vertices a step and recording the visited list;
    candidates = visited ∪ current out-edges (index.h:70-76, :251-262).
    The sharded replica build reads at ``expand=1`` (JAX sharded.py:109)."""
    safe_ids = batch_ids.long().clamp(0, points_data.shape[0] - 1)
    queries = points_data[safe_ids]
    res = beam_search_batch(
        queries, points_data, nbrs, degs, start, batch_ids, inline,
        metric=metric, n_valid=n_valid, k=0, L=L, limit=vmax,
        expand=expand, record_visited=True, exclude_self=True,
    )
    old_row, old_d = _old_candidates(nbrs, degs, points_data, safe_ids, queries,
                                     R=R, metric=metric)
    cand_ids = torch.cat([res.visited_ids, old_row], dim=1)
    cand_d = torch.cat([res.visited_dists, old_d], dim=1)
    return cand_ids, cand_d, res.num_visited.sum(), res.dist_cmps.sum()


def _fused_read_phase(nbrs, degs, points_data, batch_ids, *, R, L, vmax, metric,
                      n_valid):
    """The read phase on kernel 3's build mode (JAX vamana.py:59-93): each
    insert walks from point 0 at k = 0 for min(vmax, n_valid) single
    expansions over the int8 tier, its queries the batch's own rows. Self
    stays in the beam (a re-inserted point is expanded and costs one
    visit) and only its recorded distance is masked to INF on the way out,
    unlike the lock-step read's ``exclude_self``. Padded rows (batch id -1)
    get no valid start and do no work. Candidates = visited ∪ current
    out-edges; the visit and distance counts are the active rows'."""
    safe_ids = batch_ids.long().clamp(0, points_data.shape[0] - 1)
    queries = points_data[safe_ids]
    active = batch_ids >= 0
    starts = torch.where(active, 0, -1).to(torch.int32)[:, None]
    vis_ids, vis_d, nv, cmps = build_beam_fused(
        queries.float(), points_data, nbrs, degs, starts, metric=metric,
        n_valid=n_valid, L=L, vmax=vmax)
    vis_d = torch.where(vis_ids == batch_ids[:, None], INF, vis_d)
    old_row, old_d = _old_candidates(nbrs, degs, points_data, safe_ids, queries,
                                     R=R, metric=metric)
    return (torch.cat([vis_ids, old_row], dim=1), torch.cat([vis_d, old_d], dim=1),
            torch.where(active, nv, 0).sum(), torch.where(active, cmps, 0).sum())


def _exact_phase(nbrs, degs, points_data, batch_ids, inserted, samples, *, R,
                 L, vmax, metric, n_valid):
    """The multi-scale exact-candidate read phase (JAX vamana.py:177-242):
    the exact top-kc of the inserted prefix (``inserted``, an (n_pad,)
    bool mask on the device, without the batch's own points, which are
    excluded by id), the top-16 (top-8 below 4097 rows) of each waypoint
    sample, and the current out-edges."""
    safe_ids = batch_ids.long().clamp(0, points_data.shape[0] - 1)
    queries = points_data[safe_ids]
    qf = queries.float()
    kc = min(vmax, max(L, R + 8))
    # kernel 4 on the card; elsewhere the plain scan (JAX's "approx" off the TPU)
    sel = "pallas" if points_data.device.type == "cuda" else "approx"
    cids, cd = flat_search_batch(qf, points_data, inserted, batch_ids, k=kc,
                                 metric=metric, n_valid=n_valid, select=sel)
    scale_ids, scale_d = [cids], [torch.where(cids >= 0, cd, INF)]
    for sids, sdata in samples:
        kk = 16 if sdata.shape[0] > 4096 else 8
        rid, rd = flat_search_batch(
            qf, sdata, inserted[sids.long()], None, k=kk, metric=metric,
            n_valid=sdata.shape[0], select=sel if sdata.shape[0] > 2048 else "sort")
        gid = torch.where(rid >= 0, sids[rid.long().clamp(0, sids.shape[0] - 1)], -1)
        scale_ids.append(gid)
        scale_d.append(torch.where((gid >= 0) & (gid != batch_ids[:, None]), rd, INF))
    old_row, old_d = _old_candidates(nbrs, degs, points_data, safe_ids, queries,
                                     R=R, metric=metric)
    active = (batch_ids >= 0).sum()
    n_ins = inserted.sum()
    return (torch.cat(scale_ids + [old_row], dim=1), torch.cat(scale_d + [old_d], dim=1),
            active * kc, active * n_ins)


def _scale_samples(n: int, rng: np.random.Generator, points_data: torch.Tensor):
    """The waypoint sample ladder (JAX vamana.py:245-266): uniform samples
    at about 4x spacing from n / 4 down to about 512 rows (powers of two, at
    most 65536), each drawn by ``rng.choice(n, p, replace=False)`` and
    gathered once -> [(global ids, rows)]. Empty below 8192 points."""
    if n < 8192:
        return []
    sizes = []
    s = n // 4
    while s >= 384:
        p = min(65536, max(512, 1 << (s.bit_length() - 1)))
        if not sizes or p < sizes[-1]:
            sizes.append(p)
        s //= 4
    out = []
    for p in sizes:
        ids = torch.from_numpy(rng.choice(n, p, replace=False).astype(np.int32))
        ids = ids.to(points_data.device)
        out.append((ids, points_data[ids.long()]))
    return out


def _write_batch(nbrs, degs, points_data, batch_ids, cand_ids, cand_d, alpha,
                 laps, *, R, metric, n_valid, chunk=2048, rev_chunk=4096):
    """Forward robustPrune + row write, reverse append, overflow α-prune,
    timed by ``laps`` as prune, bidirect, prune."""
    n_pad = nbrs.shape[0]
    pr = robust_prune_chunked(batch_ids, cand_ids, cand_d, points_data, alpha,
                              R=R, metric=metric, n_valid=n_valid, chunk=chunk)
    wt = torch.where(batch_ids >= 0, batch_ids, n_pad)
    nbrs, degs = scatter_rows(nbrs, degs, wt, pr.ids, pr.degree)
    laps("prune")
    nbrs, degs, ctx = prepare_reverse_append(
        nbrs, degs, batch_ids, pr.ids, pr.dists, R=R, n_valid=n_valid)
    laps("bidirect")
    nbrs, degs = prune_reverse_all(nbrs, degs, ctx, points_data, alpha, R=R,
                                   metric=metric, n_valid=n_valid,
                                   chunk=rev_chunk)
    laps("prune")
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


def build_vamana_graph(points: PointSet, bp: BuildParams, verbose: bool = False,
                       profile: bool = False, cand_mode: str = "beam",
                       fused_read: bool = False) -> tuple[GraphIndexData, BuildStats]:
    """Build a Vamana graph over ``points`` (on ``points.device``).

    ``cand_mode``: "beam" (the reference's insertion search) or "exact"
    (the multi-scale exact candidates); a ``bp.single_batch`` build always
    searches ("beam"). ``profile=True`` fences every phase and fills the
    beam, bidirect and prune seconds: the same graph, a slower build.
    ``fused_read=True`` reads steady batches through kernel 3's build mode
    (``_fused_read_phase``); it raises ``ValueError`` wherever the JAX
    package never reads fused: points that are not int8, d < R rounded up
    to 8, ``cand_mode="exact"`` or ``single_batch``."""
    if cand_mode not in ("beam", "exact"):
        raise ValueError(f'cand_mode must be "beam" or "exact", got {cand_mode!r}')
    n = points.n
    R, L = bp.R, bp.L
    R8 = (R + 7) // 8 * 8
    if fused_read:
        why = [w for w, bad in (
            ("the build tier is not int8 (quantize_build=False)",
             points.data.dtype != torch.int8),
            (f"d = {points.d} < {R8} (R rounded up to 8)", points.d < R8),
            ('cand_mode="exact"', cand_mode == "exact"),
            ("single_batch", bool(bp.single_batch))) if bad]
        if why:
            raise ValueError("fused_read=True needs an int8 beam build with d >= R8 "
                             "and no single_batch: " + "; ".join(why))
    dev = points.device
    # visit budget of the insertion search (vamana.py:477)
    vmax = max(L, R + 16)
    nbrs = torch.zeros((points.n_pad, R), dtype=torch.int32, device=dev)
    degs = torch.zeros((points.n_pad,), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(bp.seed)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)  # index.h:143
    if bp.single_batch:
        # random initial edges (drawn before the pass permutations), one
        # batch a pass, each point searching from itself (index.h:156-169)
        deg0 = min(bp.single_batch, R)
        rnd = rng.integers(0, n, (points.n_pad, deg0)).astype(np.int32)
        nbrs[:, :deg0] = torch.from_numpy(rnd).to(dev)
        degs.fill_(deg0)
        sched, max_batch = [(0, n)], n
        cand_mode = "beam"
    else:
        sched, max_batch = batch_schedule(n, n, bp.batch_cap_frac)
    inserted, samples = None, []
    if cand_mode == "exact":
        inserted = torch.zeros((points.n_pad,), dtype=torch.bool, device=dev)
        inserted[0] = True
        samples = _scale_samples(n, np.random.default_rng(bp.seed + 7919), points.data)
    inline_ok = (cand_mode == "beam" and points.n_pad * R8 * points.d
                 * points.data.element_size() <= INLINE_BUDGET)

    t0 = time.perf_counter()
    laps = _Laps(dev, on=profile)
    tot_vis = torch.zeros((), dtype=torch.int64, device=dev)
    tot_cmp = torch.zeros((), dtype=torch.int64, device=dev)
    for p in range(bp.num_passes):
        alpha = bp.alpha if p == bp.num_passes - 1 else 1.0
        order = rng.permutation(n).astype(np.int32)
        for bi, (lo, hi) in enumerate(sched):
            batch = torch.from_numpy(_pad_pow2(order[lo:hi], max_batch)).to(dev)
            laps(None)
            steady = (hi - lo) >= max(max_batch, 4096)
            if cand_mode == "exact":
                cand_ids, cand_d, v, c = _exact_phase(
                    nbrs, degs, points.data, batch, inserted, samples,
                    R=R, L=L, vmax=vmax, metric=points.metric, n_valid=n)
            elif fused_read and steady:
                cand_ids, cand_d, v, c = _fused_read_phase(
                    nbrs, degs, points.data, batch, R=R, L=L, vmax=vmax,
                    metric=points.metric, n_valid=n)
            else:
                inline = build_inline(points.data, nbrs) if inline_ok and steady else None
                cand_ids, cand_d, v, c = _read_phase(
                    nbrs, degs, points.data, batch,
                    batch.clamp(min=0)[:, None] if bp.single_batch else start, inline,
                    R=R, L=L, vmax=vmax, metric=points.metric, n_valid=n)
                del inline
            laps("beam")
            nbrs, degs = _write_batch(
                nbrs, degs, points.data, batch, cand_ids, cand_d, alpha, laps,
                R=R, metric=points.metric, n_valid=n)
            if inserted is not None and p == 0:
                inserted[batch[batch >= 0].long()] = True
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
    t = laps.times
    stats = BuildStats(dt, t["beam"], t["bidirect"], t["prune"], int(tot_vis),
                       int(tot_cmp), 0)
    if verbose:
        avg, mx = graph.stats()
        print(f"Vamana build: {dt:.2f}s  avg/max degree {avg:.2f}/{mx}  "
              f"visited {stats.total_visited}  cmps {stats.total_cmps}")
    return graph, stats


def profile_one_batch(points: PointSet, bp: BuildParams, graph: GraphIndexData,
                      repeats: int = 2) -> tuple[float, float, float]:
    """The (beam, bidirect, prune) seconds of ONE steady batch inserted
    into copies of ``graph`` (JAX vamana.py:661-735): the batch is the
    first ``max_batch`` ids of ``default_rng(123).permutation(n)``, each
    phase fenced, best of ``repeats`` after one warm-up run. ``graph`` is
    not changed."""
    n, R, L = points.n, bp.R, bp.L
    dev = points.device
    vmax = max(L, R + 16)
    _, max_batch = batch_schedule(n, n, bp.batch_cap_frac)
    size = 1
    while size < max_batch:
        size *= 2
    perm = np.random.default_rng(123).permutation(n)[:max_batch].astype(np.int32)
    batch = torch.from_numpy(_pad_pow2(perm, size)).to(dev)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)
    R8 = (R + 7) // 8 * 8
    use_inline = (max_batch >= 4096 and points.n_pad * R8 * points.d
                  * points.data.element_size() <= INLINE_BUDGET)
    best = [float("inf")] * 3
    for _ in range(repeats + 1):  # the first run warms up
        nbrs, degs = graph.neighbors.clone(), graph.degrees.clone()
        laps = _Laps(dev)
        laps(None)
        inline = build_inline(points.data, nbrs) if use_inline else None
        cand_ids, cand_d, _, _ = _read_phase(
            nbrs, degs, points.data, batch, start, inline, R=R, L=L, vmax=vmax,
            metric=points.metric, n_valid=n)
        del inline
        laps("beam")
        _write_batch(nbrs, degs, points.data, batch, cand_ids, cand_d, bp.alpha, laps,
                     R=R, metric=points.metric, n_valid=n)
        t = laps.times
        best = [min(best[0], t["beam"]), min(best[1], t["bidirect"]),
                min(best[2], t["prune"])]
    return tuple(best)


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
    single_batch: int = 0,
    cand_mode: str = "beam",
    profile: bool = False,
    fused_read: bool = False,
):
    """diskannpy-style wrapper (python/builder.cpp:40-90): MIPS data is
    normalized with a dimension-dependent alpha, and float or uint8 inputs
    build on the q8 tier unless ``quantize_build=False``, which builds on
    the float32 points (uint8: an exact float32 copy); search reranks at
    full precision. Returns (graph, full-precision PointSet, BuildStats).
    ``data`` is an array, placed on ``device`` (None: the card), or a
    PointSet (which keeps its own device). ``single_batch``, ``cand_mode``,
    ``profile`` and ``fused_read`` are :func:`build_vamana_graph`'s build
    modes."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric, normalize=(metric is Metric.MIPS),
        device=device)
    if metric is Metric.MIPS and ps.d <= 200:
        alpha = 1.0 if ps.d < 100 else 0.98
    build_ps = quantize.build_tier(ps, quantize_build)
    bp = BuildParams(R=R, L=L, alpha=alpha, num_passes=2 if two_pass else 1,
                     seed=seed, batch_cap_frac=batch_cap_frac,
                     single_batch=single_batch)
    graph, stats = build_vamana_graph(build_ps, bp, verbose=verbose,
                                      profile=profile, cand_mode=cand_mode,
                                      fused_read=fused_read)
    return graph, ps, stats
