"""Kernel 5: the cluster-beam walk of the ClusterIndex search.

Counterpart of parlayann_tpu/ops/pallas/clusterbeam.py (``cluster_step``
:351, one lock-step expansion per launch, driven by ``cluster_search_fused``
:419). The CUDA kernel (``csrc/clusterbeam.cu``) runs each query's whole
walk in one warp, all queries in one launch; :func:`cluster_walk_plain` is
the same function in PyTorch, all queries in lock-step. :func:`cluster_search_fused`
is the whole search: the top-S centroid seed, the walk, the pool sort and
the rerank. The seed is exact up to ``ARGMIN_SEED_CUTOFF`` centroid rows;
past it an index with a seed quantizer (``ClusterIndex.seed_meta``) routes
it through :func:`meta_topk`: kernel 4's exact top-P over the
meta-centroids (``flat_topk``), then kernel 1's multi-probe mode
(``expand_distances_multi``) on the nearest cells' packed centroid blocks,
the build's ``approx_assign`` on the query side.

A query keeps two structures. The cluster beam (Wc = pow2(max(Lc, S, 8))
lanes of (distance, packed id), pack = id * 2 + unexpanded bit, live lanes
< Lc = n_probe + 4) navigates; the point pool, an M-deep sorted list for
each of the m member slots, collects results. One expansion reads one ext
row: the cluster's m member vectors and ids and its Rc adjacent centroids
and ids. Member distances bubble-insert into the pool (a strict ``<``, so
equal distances never displace); adjacent centroids that are valid and not
already in the beam (hashless dedup against every beam id) merge into the
beam, whose lanes >= Lc are then emptied. The next expansion is the first
unexpanded live lane; with ``cut`` > 0 (L2 only) a lane qualifies only if
its distance is below ``cut`` times the beam's best, unless fewer than
``min_probe`` expansions are done; the walk stops after ``n_probe``.
Empty lanes hold (INF, (C + lane) * 2 + 1).

The beam is ordered by (distance, pack), which makes every merge unique:
the kernel and the plain version agree exactly when their distances agree.
They always do: the plain version sums in the kernel's order
(:func:`~parlayann_tpu_torch.ops.distance.gathered_lane_order`), so even a
seed and a walked centroid at a near-tie are ordered alike by both. The JAX
bitonic networks compare the distance alone.

Ext layouts (byte-compatible with the JAX package's ``build_cluster_ext``
and ``build_cluster_ext_f32``):

- int8 (C_pad, m + Rc + 8, d): member vectors, 4 member-id byte planes
  (id of slot j at lane j, little-endian), Rc adjacent-centroid vectors, 4
  adjacent-id byte planes;
- f32 (C_pad, m + Rc + 2, d): member vectors, one plane of member ids as
  f32, adjacent vectors, one plane of adjacent ids as f32.
"""

from __future__ import annotations

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import distance, quantize
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels import _lib
from parlayann_tpu_torch.ops.kernels.expand import expand_distances_multi
from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
from parlayann_tpu_torch.ops.topk import lexsort, smallest_k
from parlayann_tpu_torch.search.flat import flat_search_batch
from parlayann_tpu_torch.search.rerank import rerank_topk
from parlayann_tpu_torch.utils import trace
from parlayann_tpu_torch.utils.arrays import pow2

# past this many centroid rows the "argmin" seed (one (B, C_pad) matmul)
# gives way to the meta router (ClusterIndex.seed_meta) or the streamed scan
ARGMIN_SEED_CUTOFF = 32768
# the widest cluster beam the kernel takes (past 32 lanes it runs the
# beam in shared memory)
MAX_WC = 1024
# M: the depth of each member slot's sorted pool list (the JAX default)
POOL_DEPTH = 4


def ext_layout(ext: torch.Tensor, m: int, Rc: int):
    """-> (member-id row, adjacent-vector row, adjacent-id row) of an ext
    row, checking the row count against the dtype's layout."""
    if ext.dtype == torch.int8:
        rows = (m, m + 4, m + 4 + Rc)
        want = m + Rc + 8
    elif ext.dtype == torch.float32:
        rows = (m, m + 1, m + 1 + Rc)
        want = m + Rc + 2
    else:
        raise ValueError(f"ext must be int8 or float32 (got {ext.dtype})")
    if ext.dim() != 3 or ext.shape[1] != want:
        raise ValueError(f"ext {tuple(ext.shape)} is not the {ext.dtype} layout "
                         f"for m={m}, Rc={Rc} ({want} rows)")
    if m > ext.shape[2] or Rc > ext.shape[2]:
        raise ValueError(f"id planes need d >= m and d >= Rc "
                         f"(d={ext.shape[2]}, m={m}, Rc={Rc})")
    return rows


def decode_ids(rows: torch.Tensor, base: int, width: int) -> torch.Tensor:
    """(B, rows, d) ext rows -> (B, width) int32 ids of one id plane (lanes
    < width; the pad lanes beyond hold id 0, not -1, and are never read)."""
    if rows.dtype == torch.float32:
        return rows[:, base, :width].to(torch.int32)
    b = rows[:, base:base + 4, :width].to(torch.int64) & 0xFF
    ids = b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    return torch.where(ids >= 2**31, ids - 2**32, ids).to(torch.int32)


def walk_sizes(n_probe: int, S: int):
    """-> (Lc, Wc): live beam lanes, n_probe + 4 (an expanded entry keeps
    its lane, so a beam of Lc supports at most Lc expansions), and the beam
    width."""
    Lc = n_probe + 4
    return Lc, pow2(max(Lc, S, 8))


def _sentinel(C: int, W: int, device) -> torch.Tensor:
    return ((C + torch.arange(W, device=device)) * 2 + 1).to(torch.int32)[None, :]


def _initial_beam(seed_d, seed_i, *, C, Lc, Wc):
    """Seeds in lanes < S, empty lanes elsewhere, lanes >= Lc emptied,
    sorted; then lane 0 (if live) is the first expansion: -> (bd, bp, e)."""
    B, S = seed_d.shape
    dev = seed_d.device
    lane = torch.arange(Wc, device=dev)[None, :]
    sent = _sentinel(C, Wc, dev).expand(B, -1)
    bd = torch.full((B, Wc), INF, dtype=torch.float32, device=dev)
    bp = sent.clone()
    S = min(S, Wc)
    bd[:, :S] = seed_d[:, :S]
    bp[:, :S] = seed_i[:, :S].to(torch.int32) * 2 + 1
    live = (lane < Lc) & (bd < INF)
    bd = torch.where(live, bd, INF)
    bp = torch.where(live, bp, sent)
    bd, bp = lexsort((bd, bp))
    e = torch.where(bd[:, 0] < INF, bp[:, 0] >> 1, -1)
    bp = bp - ((lane == 0) & (e[:, None] >= 0)).to(torch.int32)
    return bd, bp, e


def cluster_walk_plain(queries, ext, seed_d, seed_i, *, metric: Metric, C: int,
                       m: int, Rc: int, n_points: int, n_probe: int,
                       min_probe: int = 0, cut: float = 0.0,
                       expanded: list | None = None):
    """The kernel's function in PyTorch, all queries in lock-step. A list
    given as ``expanded`` receives each step's (B,) expanded cluster ids
    (-1 for a query whose walk has ended)."""
    mid_row, avec_row, aid_row = ext_layout(ext, m, Rc)
    B = queries.shape[0]
    dev = queries.device
    M = POOL_DEPTH
    Lc, Wc = walk_sizes(n_probe, seed_d.shape[1])
    use_cut = cut > 0.0 and metric.is_metric
    lane = torch.arange(Wc, device=dev)[None, :]
    sent_w = _sentinel(C, Wc, dev)
    sent_r = _sentinel(C, Rc, dev)
    bd, bp, e = _initial_beam(seed_d, seed_i, C=C, Lc=Lc, Wc=Wc)
    pd = torch.full((B, M * m), INF, dtype=torch.float32, device=dev)
    pi = torch.full((B, M * m), -1, dtype=torch.int32, device=dev)
    nv = torch.zeros(B, dtype=torch.int32, device=dev)
    chunk = 16 // ext.element_size()  # values a 16-byte load of a row
    while bool((e >= 0).any()):
        act = e >= 0
        if expanded is not None:
            expanded.append(e)
        rows = ext[e.clamp(min=0).long()]
        mid = decode_ids(rows, mid_row, m)
        aid = decode_ids(rows, aid_row, Rc)
        md = distance.gathered_lane_order(queries, rows[:, :m], metric, chunk)
        ad = distance.gathered_lane_order(queries, rows[:, avec_row:avec_row + Rc],
                                          metric, chunk)

        # members -> pool: per-slot bubble insert through M depths
        cv = torch.where((mid >= 0) & (mid < n_points) & act[:, None], md, INF)
        ci = mid
        for mm in range(M):
            sl = slice(mm * m, (mm + 1) * m)
            a, ai = pd[:, sl].clone(), pi[:, sl].clone()
            w = cv < a
            pd[:, sl], pi[:, sl] = torch.where(w, cv, a), torch.where(w, ci, ai)
            cv, ci = torch.where(w, a, cv), torch.where(w, ai, ci)

        # adjacent centroids -> beam: valid, not already in it, merged
        dup = (aid[:, :, None] == (bp >> 1)[:, None, :]).any(dim=2)
        keep = (aid >= 0) & (aid < C) & ~dup & act[:, None]
        cd = torch.where(keep, ad, INF)
        cp = torch.where(keep, aid * 2 + 1, sent_r)
        nd, npk = lexsort((torch.cat([bd, cd], 1), torch.cat([bp, cp], 1)))
        nd, npk = nd[:, :Wc], npk[:, :Wc]
        nd = torch.where(lane < Lc, nd, INF)
        npk = torch.where(lane < Lc, npk, sent_w)
        nv = nv + act.to(torch.int32)

        # next expansion: the first workable lane
        work = ((npk & 1) == 1) & (nd < INF)
        if use_cut:
            work &= (nd < cut * nd[:, :1]) | (nv[:, None] < min_probe)
        first = work.to(torch.int32).argmax(dim=1)
        go = act & work.any(dim=1) & (nv < n_probe)
        e_new = torch.where(go, npk.gather(1, first[:, None])[:, 0] >> 1, -1)
        npk = npk - ((lane == first[:, None]) & go[:, None]).to(torch.int32)
        bd = torch.where(act[:, None], nd, bd)
        bp = torch.where(act[:, None], npk, bp)
        e = e_new
    return pd, pi, nv


def cluster_walk(queries, ext, seed_d, seed_i, *, metric: Metric, C: int,
                 m: int, Rc: int, n_points: int, n_probe: int,
                 min_probe: int = 0, cut: float = 0.0):
    """The cluster-beam walk of B queries -> (pool dists (B, M * m) f32,
    INF where empty; pool ids (B, M * m) int32, slot ``mm * m + j`` = depth
    mm of member slot j, M = ``POOL_DEPTH``; expansions (B,) int32).

    ``queries`` (B, d) f32 in the ext's domain (q8-translated for the int8
    layout); ``ext`` the packed rows; ``seed_d``/``seed_i`` (B, S) the
    seed centroids, ascending, in the distance domain of the walk. CPU
    tensors run :func:`cluster_walk_plain`; CUDA tensors launch the
    kernel."""
    kw = dict(metric=metric, C=C, m=m, Rc=Rc, n_points=n_points,
              n_probe=n_probe, min_probe=min_probe, cut=cut)
    if not _lib.route(queries, ext, seed_d, seed_i):
        return cluster_walk_plain(queries, ext, seed_d, seed_i, **kw)
    ext_layout(ext, m, Rc)
    _lib.require(queries, "queries", torch.float32, 2)
    _lib.require(ext, "ext", ext.dtype, 3)
    _lib.require(seed_d, "seed_d", torch.float32, 2)
    _lib.require(seed_i, "seed_i", torch.int32, 2)
    B, d = queries.shape
    S = seed_d.shape[1]
    if ext.shape[2] != d or seed_d.shape[0] != B or seed_i.shape != seed_d.shape:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, ext "
            f"{tuple(ext.shape)}, seeds {tuple(seed_d.shape)} / "
            f"{tuple(seed_i.shape)}")
    Lc, Wc = walk_sizes(n_probe, S)
    M = POOL_DEPTH
    if Wc > MAX_WC:
        raise ValueError(f"cluster beam of {Wc} lanes exceeds the kernel's {MAX_WC}")
    if not (0 < C <= ext.shape[0] and 0 < n_points < 2**30):
        raise ValueError(f"C={C}, n_points={n_points} out of range")
    pd = torch.empty((B, M * m), dtype=torch.float32, device=queries.device)
    pi = torch.empty((B, M * m), dtype=torch.int32, device=queries.device)
    nv = torch.empty(B, dtype=torch.int32, device=queries.device)
    if B == 0:
        return pd, pi, nv
    fn = _lib.function("pa_cluster_walk", [_lib.VP] * 4 + [_lib.INT] * 12
                       + [_lib.FLOAT] + [_lib.INT] * 3 + [_lib.VP] * 5)
    # the persistent grid's query queue: the next query to take
    counter = torch.zeros(1, dtype=torch.int32, device=queries.device)
    rc = fn(queries.data_ptr(), ext.data_ptr(), seed_d.data_ptr(),
            seed_i.data_ptr(), B, d, S, C, m, Rc, Wc, Lc,
            M, n_points, n_probe, min_probe, float(cut),
            int(cut > 0.0 and metric.is_metric), int(metric is Metric.MIPS),
            int(ext.dtype == torch.float32), counter.data_ptr(), pd.data_ptr(),
            pi.data_ptr(), nv.data_ptr(), _lib.stream())
    cluster_walk.launches += 1
    _lib.check(rc, "cluster_walk")
    return pd, pi, nv


cluster_walk.launches = 0


def meta_topk(q: torch.Tensor, mcents: torch.Tensor, blocks: torch.Tensor,
              idtab: torch.Tensor, *, k: int, P: int, metric: Metric):
    """Meta-routed top-k centroids -> (ids (B, k) int32, dists (B, k) f32
    ascending): the exact top-P of the (Cm, d) meta-centroids by (distance,
    id) from one launch of kernel 4 (``flat_topk``, P <= ``MAX_K``; its
    plain version on the CPU), then one launch of kernel 1's multi-probe
    mode over the (Cm, cap, d) cell blocks for all B x P probes, whose
    ``idtab`` (Cm, cap) holds each slot's centroid id (-1 empty), and the k
    smallest of the B x P * cap candidates, probe-major (equal distances
    keep probe order). Distances are exact, in the blocks' domain. JAX
    clusterindex.py:208-236 and clusterbeam.py:522-556, which loop one
    launch a probe."""
    B, Cm, cap = q.shape[0], blocks.shape[0], blocks.shape[1]
    q = q.contiguous()
    mt_i, _ = flat_topk(q, mcents, k=P, metric=metric, n_valid=Cm)
    mi = mt_i.clamp(0, Cm - 1).to(torch.int32)
    dp = expand_distances_multi(blocks, mi, q, metric=metric)
    ip = idtab[mi.long()]
    dp = torch.where((ip >= 0) & (mt_i >= 0)[:, :, None], dp, INF)
    d, i = smallest_k(dp.reshape(B, P * cap), ip.reshape(B, P * cap), k)
    return i, d


def seed_centroids(q: torch.Tensor, centroids_q: torch.Tensor, *, C: int,
                   S: int, metric: Metric, seed_mode: str = "argmin",
                   meta=None, seed_probes: int = 8):
    """Top-S centroids per query -> (dists (B, S) f32 ascending, in the
    walk's domain: true squared L2 or -dot; ids (B, S) int32).

    "argmin" with S <= 4 and at most ``ARGMIN_SEED_CUTOFF`` centroid rows:
    one (B, C_pad) matmul and S argmin passes, the JAX package's ``cn - 2
    q.c + qn`` algebra. Otherwise, "argmin" or "meta" with a seed quantizer
    ``meta`` = (mcents, blocks, idtab): :func:`meta_topk` over
    ``min(seed_probes, Cm)`` cells. Otherwise ("stream", or no quantizer):
    the chunked exact flat scan."""
    if seed_mode not in ("argmin", "stream", "meta"):
        raise ValueError(f"unknown seed_mode {seed_mode!r}")
    C_pad = centroids_q.shape[0]
    if seed_mode == "argmin" and S <= 4 and C_pad <= ARGMIN_SEED_CUTOFF:
        return _argmin_seed(q, centroids_q, C=C, S=S, metric=metric)
    if meta is not None and seed_mode != "stream":
        mcents, blocks, idtab = meta
        sid, sd = meta_topk(q, mcents, blocks, idtab, k=S,
                            P=max(1, min(seed_probes, blocks.shape[0])), metric=metric)
        return sd, sid
    sid, sd = flat_search_batch(q, centroids_q, k=S, metric=metric,
                                n_valid=C, chunk=min(C_pad, 8192), select="sort")
    return sd, sid


def _argmin_seed(q, centroids_q, *, C: int, S: int, metric: Metric):
    """The exact top-S seed by one (B, C_pad) matmul and S argmin passes."""
    C_pad = centroids_q.shape[0]
    cf = centroids_q.float()
    dot = q @ cf.T
    if metric is Metric.MIPS:
        dall = -dot
    else:
        dall = (cf * cf).sum(dim=1)[None, :] - 2.0 * dot
    cid = torch.arange(C_pad, device=q.device)[None, :]
    dall = torch.where(cid < C, dall, INF)
    sd, sid = [], []
    for _ in range(S):
        v, am = dall.min(dim=1, keepdim=True)  # first index on ties
        sd.append(v)
        sid.append(am)
        dall = torch.where(cid == am, INF, dall)
    sd = torch.cat(sd, dim=1)
    sid = torch.cat(sid, dim=1).to(torch.int32)
    if metric is not Metric.MIPS:
        qn = (q * q).sum(dim=1, keepdim=True)
        sd = torch.where(sd < INF, torch.clamp(sd + qn, min=0.0), INF)
    return sd, sid


def cluster_search_fused(q_full, centroids_q, ext, points_full, slope=None,
                         offset=None, meta_cents=None, meta_blocks=None,
                         meta_idtab=None, *, metric: Metric, C: int, m: int,
                         Rc: int, n_points: int, k: int = 10, n_probe: int = 8,
                         min_probe: int = 0, cut: float = 0.0, S: int = 2,
                         pool: int = 20, tier_bits: int = 8, rerank: str = "full",
                         seed_mode: str = "argmin", select_mode: str = "sort",
                         seed_probes: int = 8):
    """Cluster search -> (ids (B, k) int32, -1 where empty; dists (B, k);
    (probes (B,), distance computations (B,))).

    The queries are translated into the q8 domain when ``tier_bits`` < 32
    and ``slope`` is given (the int8 layout), seeded with the top-S
    centroids (:func:`seed_centroids`; ``meta_*`` the index's seed
    quantizer, in the ext's domain), and walked (:func:`cluster_walk`). The pool is then sorted
    by (distance, id) ("sort" and "group" are the same exact selection
    here), and ``rerank="full"`` re-scores its ``pool`` best at full
    precision while ``"tier"`` returns its k best as they are (exact f32
    scores on the f32 layout, q8-domain scores on the int8 one).

    Under the recorder (``utils/trace.py``) the steps are the spans
    ``search.translate``, ``search.seed`` (counting kernel 4's
    ``launches``: 1 with a seed quantizer on the card, 0 on the CPU),
    ``search.walk`` (counting the walk's ``probes``, the expansions, and
    ``cmps``), ``search.pool`` (the pool's sort) and ``search.rerank``
    (the rerank, or the pool's k best on ``rerank="tier"``), on the
    queries' device."""
    if rerank not in ("full", "tier"):
        raise ValueError(f"rerank must be 'full' or 'tier', got {rerank!r}")
    if select_mode not in ("sort", "group"):
        raise ValueError(f"select_mode must be 'sort' or 'group', got {select_mode!r}")
    dev = q_full.device
    q_full = q_full.float()
    with trace.span("search.translate", dev):
        if tier_bits < 32 and slope is not None:
            if metric is Metric.L2:
                q = quantize.euclidean_translate(q_full, slope, offset, tier_bits)
            else:
                q = quantize.mips_translate(q_full, slope, offset, tier_bits)
            q = q.float()
        else:
            q = q_full
    meta = None if meta_cents is None else (meta_cents, meta_blocks, meta_idtab)
    with trace.span("search.seed", dev):
        before = flat_topk.launches
        sd, sid = seed_centroids(q, centroids_q, C=C, S=S, metric=metric,
                                 seed_mode=seed_mode, meta=meta, seed_probes=seed_probes)
        trace.count("launches", flat_topk.launches - before)
    with trace.span("search.walk", dev):
        pd, pi, nv = cluster_walk(q.contiguous(), ext, sd.contiguous(),
                                  sid.contiguous(), metric=metric, C=C, m=m, Rc=Rc,
                                  n_points=n_points, n_probe=n_probe,
                                  min_probe=min_probe, cut=cut)
        cmps = C + nv * (m + Rc)
        trace.count("probes", nv)
        trace.count("cmps", cmps)
    with trace.span("search.pool", dev):
        pd, pi = lexsort((pd, pi))
    with trace.span("search.rerank", dev):
        if rerank == "tier":
            ids = torch.where(pd[:, :k] < INF, pi[:, :k], -1)
            dists = pd[:, :k]
        else:
            cand = torch.where(pd[:, :pool] < INF, pi[:, :pool], -1)
            ids, dists = rerank_topk(q_full, points_full, cand, k=k, pool=pool,
                                     metric=metric)
    return ids, dists, (nv, cmps)
