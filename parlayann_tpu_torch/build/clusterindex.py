"""ClusterIndex: the two-level cluster structure (build side).

Counterpart of parlayann_tpu/build/clusterindex.py. The points are
partitioned into C = ceil(n * slack / m) clusters of at most m: centroids,
a capacity-balanced assignment over each point's ``cand`` nearest
centroids, a respill of the points it had to place arbitrarily into their
nearest clusters with free capacity, and centroids recentred on the final
membership. Each cluster's Rc nearest clusters form its adjacency, and one
packed ext row per cluster holds its member vectors and ids and its
adjacent centroids and ids (layouts in ops/kernels/clusterbeam.py). The
search walks clusters, not points (kernel 5).

Up to ``EXACT_LIMIT`` point-centroid pairs the centroids come from Lloyd
k-means over the flat scan and the assignment is exact (JAX :1090-1118).
Past it the build is hierarchical (JAX :910-1088): the C centroids are
clustered into balanced meta-cells (:func:`_meta_quantizer`), and a point
is assigned by scanning the meta-centroids and then, through kernel 1,
only its top-P cells' packed centroid blocks (:func:`approx_assign`).
Random seeds go through ``HIER_ROUNDS`` rounds of assign, balance at
``HIER_ROUND_CAP`` x m, recentre on the locally placed points and (but in
the last round) a capacity-aware teleport of empty centroids into starved
regions; the last round's cap tapers to ``HIER_SHAPE_CAP`` x m. A final
assignment at the true m, the respill and an exact polish of the worst
``POLISH`` share by assigned distance follow. The centroid adjacency runs
through ``approx_assign`` too when C^2 passes ``EXACT_LIMIT``. Past
``clusterbeam.ARGMIN_SEED_CUTOFF`` centroids ``_finish`` adds a query-seed
quantizer over the tier-domain centroids (``ClusterIndex.seed_meta``).

A cluster that ends the partition with no member is left out before the
adjacency, the ext rows and the seed quantizer are made
(:func:`drop_empty`), so ``C`` counts the clusters with members and no
seed or walk reaches an empty one. The JAX package keeps them with zero
centroids (its ``_recenter``): all at the origin, they are each other's
nearest neighbours, in data centred there they can be nearer a centroid
than its real neighbours and take its adjacency slots and the walk's
probes, and a query seeded among them can get fewer than k results
(PARITY.md).

Under the recorder (``utils/trace.py``) a build is the span ``build`` over
``build.assign`` (each assignment of the points to centroids: the k-means
and its assignment, or each routed assign of the hierarchical rounds and
the final one), ``build.balance`` (each capacity balance, with a round's
recentring and teleport), ``build.respill``, ``build.polish``,
``build.adjacency`` and ``build.finish``, on the points' device.

The partition is always L2 (clustering by inner product is degenerate);
MIPS indexes score by the true metric at query time. Every balance runs
the host library's ``native.balance_assign``; :func:`balance_assign` is its
plain numpy version. ``save``/``load`` write and read the JAX package's
npz file (the same keys). The JAX package's environment knobs are module
constants here at its defaults. The JAX respill pads its free centroids
with 1e15 rows and its pending points to powers of two, to fix compile
shapes; no result depends on the padding under L2, and the port pads
nothing.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch import native
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels import clusterbeam
from parlayann_tpu_torch.ops.kernels.clusterbeam import cluster_search_fused, meta_topk
from parlayann_tpu_torch.search.flat import flat_search_batch
from parlayann_tpu_torch.utils import trace
from parlayann_tpu_torch.utils.timing import fence, timed_rounds

# past this many point-centroid pairs (n x C) the build runs its
# hierarchical passes, and past it in C x C the adjacency is routed
EXACT_LIMIT = 4e10
# past this many pending-point x free-centroid pairs in one chunk the
# respill routes through a meta quantizer (the JAX literal, apart from
# EXACT_LIMIT), over chunks of RESPILL_CHUNK pending points
RESPILL_LIMIT = 4e10
RESPILL_CHUNK = 1 << 21
# the hierarchical build's settings (the JAX package's defaults of
# PARLAYANN_META_M, _HIER_ROUNDS, _HIER_P, _HIER_ROUND_CAP,
# _HIER_SHAPE_CAP, _HIER_TELEPORT, _POLISH and _SEED_META_M)
META_M = 96
HIER_ROUNDS = 3
HIER_P = 16
HIER_ROUND_CAP = 4
HIER_SHAPE_CAP = 1.5
HIER_TELEPORT = True
POLISH = 0.15
SEED_META_M = 16


def _kmeans_chunk_for(C: int) -> int:
    """Point-chunk width keeping the (chunk, C) f32 distance tile of the
    plain scan under ~256 MB."""
    step = 16384
    while step > 512 and step * max(C, 1) * 4 > 256 << 20:
        step //= 2
    return step


def _assign_all(data: torch.Tensor, n: int, cents: torch.Tensor, C: int,
                k: int, metric: Metric, step: int = 0):
    """Nearest-k centroids of the first n rows of ``data`` -> (ids (n, k),
    dists (n, k)) numpy, over point chunks of ``step``."""
    step = step or _kmeans_chunk_for(cents.shape[0])
    ids, ds = [], []
    for lo in range(0, n, step):
        i, d = flat_search_batch(data[lo:min(lo + step, n)], cents, k=k,
                                 metric=metric, n_valid=C,
                                 chunk=min(cents.shape[0], 32768), select="sort")
        ids.append(i)
        ds.append(d)
    return torch.cat(ids).cpu().numpy(), torch.cat(ds).cpu().numpy()


def kmeans(data: torch.Tensor, n: int, C: int, *, metric: Metric,
           iters: int = 6, seed: int = 0, step: int = 0) -> torch.Tensor:
    """Lloyd k-means -> (C, d) f32 centroids. The seeds are the JAX
    package's (``default_rng(seed).choice(n, C, replace=False)``); each
    iteration assigns every point to its nearest centroid (the k = 1 flat
    scan) and moves each centroid to its points' mean (``index_add_``; the
    one-hot matmul of the JAX package is a TPU idiom). A centroid that
    attracts no point stays where it is."""
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.choice(n, C, replace=False)).to(data.device)
    cents = data[pick].float()
    step = step or _kmeans_chunk_for(C)
    x = data[:n].float()
    for _ in range(iters):
        sums = torch.zeros_like(cents)
        cnts = torch.zeros(C, dtype=torch.float32, device=data.device)
        for lo in range(0, n, step):
            blk = x[lo:lo + step]
            aid, _ = flat_search_batch(blk, cents, k=1, metric=metric,
                                       n_valid=C, chunk=min(C, 32768),
                                       select="groupmin")
            aid = aid[:, 0].long()
            sums.index_add_(0, aid, blk)
            cnts.index_add_(0, aid, torch.ones_like(aid, dtype=torch.float32))
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        cents = torch.where((cnts > 0)[:, None], new, cents)
    return cents


def _place_rounds(members, fill, cand, order, items, m):
    """Distance-priority rank rounds: round j offers every still-unplaced
    item (in ``order``) its j-th candidate cluster, and each cluster
    accepts, in priority order, as many as it has free slots. Updates
    ``members``/``fill`` in place -> bool placed mask over ``items``."""
    C = members.shape[0]
    placed = np.zeros(len(items), bool)
    for j in range(cand.shape[1]):
        rem = order[~placed[order]]
        if not len(rem):
            break
        c = cand[rem, j].astype(np.int64)
        valid = c >= 0
        sidx = np.argsort(c, kind="stable")
        cs = c[sidx]
        newgrp = np.r_[True, cs[1:] != cs[:-1]]
        grp_start = np.maximum.accumulate(np.where(newgrp, np.arange(len(cs)), 0))
        rank = np.arange(len(cs)) - grp_start
        cap = np.where(valid[sidx], m - fill[np.clip(cs, 0, C - 1)], 0)
        acc = rank < cap
        cacc = cs[acc]
        members[cacc, fill[cacc] + rank[acc]] = items[rem[sidx[acc]]]
        fill += np.bincount(cacc, minlength=C)
        placed[rem[sidx[acc]]] = True
    return placed


def _spill_emptiest(members, fill, pending, m):
    """Place ``pending`` into the emptiest clusters' free slots, in order."""
    C = members.shape[0]
    free_c = np.repeat(np.arange(C), m - fill)
    if len(free_c) < len(pending):
        raise ValueError("capacity < n: raise slack")
    free_c = free_c[np.argsort(fill[free_c], kind="stable")]
    take = free_c[: len(pending)]
    for c_ in np.unique(take):
        idx = np.flatnonzero(take == c_)
        members[c_, fill[c_]: fill[c_] + len(idx)] = pending[idx]
        fill[c_] += len(idx)


def balance_assign(nbr_ids: np.ndarray, nbr_d: np.ndarray, C: int,
                   m: int) -> np.ndarray:
    """Capacity-balanced assignment -> members (C, m) int32, -1 padded.

    The JAX package's vectorised numpy version (clusterindex.py:340-377),
    the plain version of :func:`_balance` (the host library's
    ``csrc/balance.cpp``, bit-identical): points in order of their
    nearest-centroid distance take part in rank rounds (everyone's first
    choice before anyone's second); points whose candidates are all full
    spill to the emptiest clusters."""
    order = np.argsort(nbr_d[:, 0], kind="stable").astype(np.int64)
    members = np.full((C, m), -1, np.int32)
    fill = np.zeros(C, np.int64)
    items = np.arange(len(nbr_ids), dtype=np.int64)
    placed = _place_rounds(members, fill, nbr_ids, order, items, m)
    pending = order[~placed[order]]
    if len(pending):
        _spill_emptiest(members, fill, pending, m)
    return members


def _balance(nbr_ids: np.ndarray, nbr_d: np.ndarray, C: int, m: int) -> np.ndarray:
    """:func:`balance_assign` through the host library (every build path's
    balance)."""
    order = np.argsort(nbr_d[:, 0], kind="stable").astype(np.int64)
    return native.balance_assign(nbr_ids, order, C, m)


def _mask_spilled(members: np.ndarray, nbr_ids: np.ndarray) -> np.ndarray:
    """-1 out member slots whose cluster is not among the point's candidate
    centroids (placed by the spill path)."""
    C, m = members.shape
    pts = members.reshape(-1)
    cl = np.repeat(np.arange(C, dtype=np.int32), m)
    inlist = np.zeros(len(pts), bool)
    v = np.flatnonzero(pts >= 0)
    inlist[v] = (nbr_ids[pts[v]] == cl[v, None]).any(axis=1)
    return np.where(inlist.reshape(C, m), members, -1)


def _meta_sizes(C: int, meta_m: int) -> tuple[int, int]:
    """-> (Cm meta-cell count, cap block capacity): cap carries 40%
    headroom over the mean cell size, a multiple of 8, with room for C."""
    Cm = max(8, int(-(-C * 1.25 // meta_m)))
    cap = -(-int(C / Cm * 1.4 + 1) // 8) * 8
    while Cm * cap < C + Cm:
        cap += 8
    return Cm, cap


def _meta_quantizer(cents: torch.Tensor, C: int, metric: Metric, *,
                    meta_m: int = META_M, seed: int = 0, iters: int = 4):
    """Cluster the C centroids into balanced meta-cells -> (mcents (Cm, d)
    f32, blocks (Cm, cap, d) f32, idtab (Cm, cap) int32 tensors): exact
    k-means of the centroids, the balance at cap, the respill (a centroid
    the balance dumped into an arbitrary cell is one the router never
    finds) and the cells' means. A cell's block holds its centroids, zero
    where ``idtab`` is -1."""
    Cm, cap = _meta_sizes(C, meta_m)
    cj = cents[:C].float()
    mcents = kmeans(cj, C, Cm, metric=metric, iters=iters, seed=seed)
    ids, dd = _assign_all(cj, C, mcents, Cm, min(8, Cm), metric)
    memm = _balance(ids, dd, Cm, cap)
    memm = _respill_local(cj, C, memm, ids, mcents, Cm, cap, metric)
    mcents = _recenter(cj, memm, Cm)
    idtab = torch.from_numpy(memm).to(cj.device)
    return mcents, _gather_rows(cj, idtab), idtab


def approx_assign(data: torch.Tensor, n: int, cents: torch.Tensor, C: int,
                  k: int, metric: Metric, *, P: int = 2, meta_m: int = META_M,
                  seed: int = 0, quantizer=None):
    """Meta-routed nearest-k centroids -> (ids (n, k), dists (n, k)) numpy,
    :func:`_assign_all`'s contract with the candidates restricted to each
    point's top-P meta-cells: the distances are exact, to the true
    centroids (kernel 1 on the cells' blocks). ``quantizer``: a
    :func:`_meta_quantizer` result to reuse across calls against the same
    centroids."""
    mcents, blocks, idtab = quantizer if quantizer is not None else (
        _meta_quantizer(cents, C, metric, meta_m=meta_m, seed=seed))
    step = _kmeans_chunk_for(blocks.shape[0])
    ids = torch.empty((n, k), dtype=torch.int32, device=data.device)
    ds = torch.empty((n, k), dtype=torch.float32, device=data.device)
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        ids[lo:hi], ds[lo:hi] = meta_topk(data[lo:hi].float(), mcents, blocks, idtab,
                                          k=k, P=P, metric=metric)
    return ids.cpu().numpy(), ds.cpu().numpy()


def _respill_local(data: torch.Tensor, n: int, members: np.ndarray,
                   nbr_ids: np.ndarray, cents: torch.Tensor, C: int, m: int,
                   metric: Metric, *, verbose: bool = False) -> np.ndarray:
    """Re-place spilled points into their nearest clusters with free
    capacity -> members (C, m): search them against the free clusters'
    centroids and place them by the same rank rounds, widening the
    candidate count (8, 32, ..., 1024) until everyone fits. The pending
    points go in chunks of ``RESPILL_CHUNK``; past ``RESPILL_LIMIT`` pairs
    in a chunk the search is :func:`approx_assign` through one meta
    quantizer of the pass's free centroids."""
    local = _mask_spilled(members, nbr_ids)
    n_spill = int((members >= 0).sum() - (local >= 0).sum())
    if n_spill == 0:
        return members
    pending = members[(members >= 0) & (local < 0)].astype(np.int64)
    ordr = np.argsort(local < 0, axis=1, kind="stable")
    members = np.take_along_axis(local, ordr, axis=1)
    fill = (members >= 0).sum(axis=1).astype(np.int64)
    k = 8
    it = 0
    while len(pending):
        it += 1
        free = np.flatnonzero(fill < m).astype(np.int64)
        kk = int(min(k, len(free)))
        sub = cents[torch.from_numpy(free).to(cents.device)]
        quant = (_meta_quantizer(sub, len(free), metric, seed=it)
                 if float(min(RESPILL_CHUNK, len(pending))) * len(free) > RESPILL_LIMIT
                 else None)
        ids, d = [], []
        for off in range(0, len(pending), RESPILL_CHUNK):
            pc = pending[off:off + RESPILL_CHUNK]
            pvec = data[torch.from_numpy(pc).to(data.device)]
            if quant is not None and float(len(pc)) * len(free) > RESPILL_LIMIT:
                i_, d_ = approx_assign(pvec, len(pc), sub, len(free), kk, metric,
                                       seed=it, quantizer=quant)
            else:
                i_, d_ = _assign_all(pvec, len(pc), sub, len(free), kk, metric)
            ids.append(i_)
            d.append(d_)
        ids, d = np.concatenate(ids), np.concatenate(d)
        gids = np.where((ids >= 0) & (ids < len(free)),
                        free[np.clip(ids, 0, len(free) - 1)], -1)
        order = np.argsort(d[:, 0], kind="stable")
        placed = _place_rounds(members, fill, gids, order, pending, m)
        if verbose:
            print(f"respill pass {it} (k={kk}{', routed' if quant is not None else ''}): "
                  f"{n_spill} -> {int((~placed).sum())} left", flush=True)
        if not placed.any() and kk >= min(1024, len(free)):
            # no progress at the widest candidate set: the emptiest free
            # slots, termination over locality for a vanishing fraction
            _spill_emptiest(members, fill, pending[~placed], m)
            break
        pending = pending[~placed]
        k = min(k * 4, 1024)
    return members


def _recenter(data: torch.Tensor, members: np.ndarray, C: int) -> torch.Tensor:
    """Exact centroids of a membership -> (C, d) f32 (zero for an empty
    cluster, as in the JAX package), over blocks of 8192 clusters (the
    whole (C, m, d) gather is tens of GB at 10M points)."""
    block = 8192
    out = torch.empty((C, data.shape[1]), dtype=torch.float32, device=data.device)
    for lo in range(0, C, block):
        mm = torch.from_numpy(members[lo:min(lo + block, C)]).to(data.device)
        ok = mm >= 0
        vecs = data[mm.clamp(min=0).long()].float()
        s = torch.where(ok[:, :, None], vecs, 0.0).sum(dim=1)
        out[lo:lo + mm.shape[0]] = s / torch.clamp(ok.sum(dim=1, keepdim=True).float(),
                                                    min=1.0)
    return out


def _teleport_centroids(data: torch.Tensor, cents: torch.Tensor, nbr_ids: np.ndarray,
                        nbr_d: np.ndarray, C: int, m: int):
    """Capacity-aware empty-cluster reseeding -> (cents, n_moved).

    A trial balance at the true capacity m finds the mass no centroid
    region absorbs (its spill-placed points). Each starved region, keyed by
    its spilled points' nearest centroid, asks for ceil(spill / m) more
    centroids; donors are the clusters the trial left empty in regions
    with no spill; the k-th donation to a region lands on an evenly spread
    k-th spilled point of it."""
    trial = _balance(nbr_ids, nbr_d, C, m)
    local = _mask_spilled(trial, nbr_ids)
    sp_pts = trial[(trial >= 0) & (local < 0)].astype(np.int64)
    if not len(sp_pts):
        return cents, 0
    region = nbr_ids[sp_pts, 0].astype(np.int64)
    ok = region >= 0
    sp_pts, region = sp_pts[ok], region[ok]
    spill_mass = np.bincount(region, minlength=C)
    need = -(-spill_mass // m)  # extra centroids per starved region
    fill = (local >= 0).sum(axis=1).astype(np.int64)
    donors = np.flatnonzero((fill == 0) & (need == 0))
    if not len(donors) or not need.any():
        return cents, 0
    reg_ids = np.flatnonzero(need > 0)
    reg_ids = reg_ids[np.argsort(-spill_mass[reg_ids], kind="stable")]
    lens = need[reg_ids]
    receivers = np.repeat(reg_ids, lens)
    ends = np.cumsum(lens)
    occ = np.arange(len(receivers)) - np.repeat(ends - lens, lens)
    order = np.argsort(region, kind="stable")
    sp_sorted = sp_pts[order]
    starts = np.searchsorted(region[order], np.arange(C))
    nmove = int(min(len(donors), len(receivers)))
    recv, occ = receivers[:nmove], occ[:nmove]
    don = donors[:nmove].astype(np.int64)
    nrep = np.repeat(lens, lens)[:nmove]
    pts = sp_sorted[starts[recv] + (occ * spill_mass[recv]) // np.maximum(nrep, 1)]
    dev = cents.device
    cents = cents.clone()
    cents[torch.from_numpy(don).to(dev)] = data[torch.from_numpy(pts).to(dev)].float()
    return cents, int(len(don))


def _assigned_dist(data: torch.Tensor, cents: torch.Tensor, pt2c: np.ndarray) -> np.ndarray:
    """||x_i - c_assign(i)||^2 for every row of ``data`` -> (rows,) f32
    numpy (a row assigned nowhere measures against centroid 0), over blocks
    of 65,536 rows."""
    block = 1 << 16
    dev = data.device
    out = torch.empty(data.shape[0], dtype=torch.float32, device=dev)
    for lo in range(0, data.shape[0], block):
        c = torch.from_numpy(pt2c[lo:lo + block]).to(dev).clamp(min=0).long()
        diff = data[lo:lo + block].float() - cents[c]
        out[lo:lo + block] = (diff * diff).sum(dim=1)
    return out.cpu().numpy()


def _polish_misassigned(data: torch.Tensor, n: int, members: np.ndarray,
                        cents: torch.Tensor, C: int, m: int, metric: Metric, *,
                        frac: float = POLISH, kc: int = 8,
                        verbose: bool = False) -> np.ndarray:
    """Exact reassignment of the router's error tail -> members.

    A point the meta router missed sits far from its assigned centroid.
    The worst ``frac`` by assigned distance are scanned exactly against all
    C centroids (the flat scan, ``select="sort"``, in batches), and each
    whose exact nearest centroid is not its own moves by the balancer's
    rank rounds into its nearest cluster with free capacity; its current
    (vacated) cluster is a last-priority candidate, and only a mover whose
    slot a sibling took lands in the emptiest free cluster."""
    rows = data.shape[0]
    pt2c = np.full(rows, -1, np.int32)
    rowsc = np.repeat(np.arange(C, dtype=np.int32), members.shape[1])
    vmask = members.reshape(-1) >= 0
    pt2c[members.reshape(-1)[vmask]] = rowsc[vmask]
    ad = _assigned_dist(data, cents, pt2c)[:n]
    qidx = int(n * (1 - frac))
    thr = np.partition(ad, qidx)[qidx]
    flagged = np.flatnonzero((ad >= thr) & (pt2c[:n] >= 0)).astype(np.int64)
    if not len(flagged):
        return members
    eb = 16384
    ids, ds = [], []
    for off in range(0, len(flagged), eb):
        fv = data[torch.from_numpy(flagged[off:off + eb]).to(data.device)].float()
        i_, d_ = flat_search_batch(fv, cents, k=kc, metric=metric, n_valid=C,
                                   chunk=min(cents.shape[0], 8192), select="sort")
        ids.append(i_)
        ds.append(d_)
    eids, ed = torch.cat(ids).cpu().numpy(), torch.cat(ds).cpu().numpy()
    movers = eids[:, 0] != pt2c[flagged]
    flagged, eids, ed = flagged[movers], eids[movers], ed[movers]
    if not len(flagged):
        return members
    eids = np.concatenate([eids, pt2c[flagged][:, None].astype(eids.dtype)], axis=1)
    is_mover = np.zeros(rows, bool)
    is_mover[flagged] = True
    keep = ~((members >= 0) & is_mover[np.clip(members, 0, None)])
    members = np.where(keep, members, -1)
    ordr = np.argsort(members < 0, axis=1, kind="stable")
    members = np.take_along_axis(members, ordr, axis=1)
    fill = (members >= 0).sum(axis=1).astype(np.int64)
    order = np.argsort(ed[:, 0], kind="stable")
    placed = _place_rounds(members, fill, eids, order, flagged, m)
    if not placed.all():
        _spill_emptiest(members, fill, flagged[~placed], m)
    if verbose:
        print(f"polish: flagged {int((ad >= thr).sum())} moved {int(placed.sum())} "
              f"fallback {int((~placed).sum())}", flush=True)
    return members


def _hier_partition(data: torch.Tensor, n: int, C: int, m: int, cand: int,
                    seed: int, verbose: bool):
    """The hierarchical build's partition -> (members (C, m), cents (C, d)),
    JAX clusterindex.py:942-1088: random centroid seeds, ``HIER_ROUNDS``
    rounds of routed assign, balance at a relaxed cap, recentre on the
    locally placed points and teleport (but in the last round); then the
    final routed assign, the balance at m, the respill, and the polish."""
    cmetric = Metric.L2
    dev = data.device
    rng = np.random.default_rng(seed)
    cents = data[torch.from_numpy(rng.choice(n, C, replace=False)).to(dev)].float()
    m_round = m * HIER_ROUND_CAP
    caps = [m_round] * HIER_ROUNDS
    if HIER_ROUNDS > 1 and HIER_SHAPE_CAP > 0:
        # the taper never raises the cap
        caps[-1] = min(m_round, max(m, int(m * HIER_SHAPE_CAP)))
    for r in range(HIER_ROUNDS):
        t0 = time.perf_counter()
        cents_in = cents
        with trace.span("build.assign"):
            nbr_ids, nbr_d = approx_assign(data, n, cents, C, cand, cmetric, P=HIER_P,
                                           meta_m=META_M, seed=seed + r)
        with trace.span("build.balance"):
            members = _balance(nbr_ids, nbr_d, C, caps[r])
            # recentre on the locally placed points; keep the centroid of a
            # cluster left with none
            local = _mask_spilled(members, nbr_ids)
            nonempty = torch.from_numpy((local >= 0).any(axis=1)).to(dev)
            cents = torch.where(nonempty[:, None], _recenter(data, local, C), cents)
            moved = 0
            if HIER_TELEPORT and r < HIER_ROUNDS - 1:
                cents, moved = _teleport_centroids(data, cents, nbr_ids, nbr_d, C, m)
        if verbose:
            fence(dev)
            secs = time.perf_counter() - t0
            spilled = int((members >= 0).sum() - (local >= 0).sum())
            # the router's fidelity on a sample: top-1 agreement with the
            # exact scan, and the true top-1 among the candidates
            srng = np.random.default_rng(123 + r)
            sidx = srng.choice(n, min(4096, n), replace=False)
            sv = data[torch.from_numpy(sidx).to(dev)]
            eids, _ = _assign_all(sv, len(sidx), cents_in, C, 1, cmetric)
            agree = float((nbr_ids[sidx, 0] == eids[:, 0]).mean())
            incand = float((nbr_ids[sidx, :cand] == eids[:, :1]).any(1).mean())
            print(f"hier round {r + 1}/{HIER_ROUNDS}: {secs:.1f}s spilled {spilled} "
                  f"({spilled / n:.3f})" + (f" teleported {moved}" if moved else "")
                  + f" router top1-agree {agree:.3f} true-top1-in-cand {incand:.3f}",
                  flush=True)
    t0 = time.perf_counter()
    with trace.span("build.assign"):
        nbr_ids, nbr_d = approx_assign(data, n, cents, C, cand, cmetric, P=HIER_P,
                                       meta_m=META_M, seed=seed + HIER_ROUNDS)
    with trace.span("build.balance"):
        members = _balance(nbr_ids, nbr_d, C, m)
    if verbose:
        spilled = int((members >= 0).sum() - (_mask_spilled(members, nbr_ids) >= 0).sum())
        print(f"final assign: {time.perf_counter() - t0:.1f}s spilled {spilled} "
              f"({spilled / n:.3f})", flush=True)
    t1 = time.perf_counter()
    with trace.span("build.respill"):
        members = _respill_local(data, n, members, nbr_ids, cents, C, m, cmetric,
                                 verbose=verbose)
        cents = _recenter(data, members, C)
    if verbose:
        fence(dev)
        print(f"respill: {time.perf_counter() - t1:.1f}s", flush=True)
    if POLISH > 0:
        t1 = time.perf_counter()
        with trace.span("build.polish"):
            members = _polish_misassigned(data, n, members, cents, C, m, cmetric,
                                          frac=POLISH, verbose=verbose)
            cents = _recenter(data, members, C)
        if verbose:
            fence(dev)
            print(f"polish: {time.perf_counter() - t1:.1f}s", flush=True)
    if verbose:
        fence(dev)
        print(f"hier final: {time.perf_counter() - t0:.1f}s", flush=True)
    return members, cents


def _seed_quantizer(cents_tier: torch.Tensor, C: int, blocks_dtype=None):
    """The query seed's meta router over the (C, d) ext-domain centroids
    (JAX clusterindex.py:1131-1161) -> (mcents, blocks, idtab), or None up
    to ``clusterbeam.ARGMIN_SEED_CUTOFF`` centroids. Fine cells
    (``SEED_META_M``) keep the seed accurate. On the int8 layout the blocks
    hold q8-domain integers, so their int8 cast is exact."""
    if C <= clusterbeam.ARGMIN_SEED_CUTOFF:
        return None
    mc, blocks, idtab = _meta_quantizer(cents_tier, C, Metric.L2, meta_m=SEED_META_M,
                                        seed=1009, iters=3)
    if blocks_dtype is not None:
        blocks = blocks.to(blocks_dtype)
    return mc, blocks, idtab


def drop_empty(members: np.ndarray, cents: torch.Tensor, adj: Optional[np.ndarray] = None):
    """The clusters that have members -> (members, cents, adj): the rows
    of (C, m) ``members`` with no member left out, with their rows of
    ``cents``, and ``adj`` (if given) renumbered onto the kept clusters,
    an edge to a dropped cluster removed and each row compacted left, -1
    padded."""
    keep = (members >= 0).any(axis=1)
    if keep.all():
        return members, cents, adj
    members = np.ascontiguousarray(members[keep])
    cents = cents[torch.from_numpy(np.flatnonzero(keep)).to(cents.device)]
    if adj is not None:
        new_id = np.where(keep, np.cumsum(keep) - 1, -1).astype(np.int32)
        adj = np.where(adj >= 0, new_id[np.clip(adj, 0, None)], -1)[keep]
        ordr = np.argsort(adj < 0, axis=1, kind="stable")
        adj = np.ascontiguousarray(np.take_along_axis(adj, ordr, axis=1)).astype(np.int32)
    return members, cents, adj


def _c_pad(C: int) -> int:
    return -(-C // 8) * 8


def _pad_ids(ids: np.ndarray, C_pad: int, device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(ids, dtype=np.int32)).to(device)
    if C_pad != t.shape[0]:
        t = torch.nn.functional.pad(t, (0, 0, 0, C_pad - t.shape[0]), value=-1)
    return t


def _gather_rows(src: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(N, d) rows at (C, w) ids -> (C, w, d), zero where the id is -1."""
    vecs = src[ids.clamp(0, src.shape[0] - 1).long()]
    return torch.where((ids >= 0)[:, :, None], vecs, torch.zeros((), dtype=src.dtype,
                                                                 device=src.device))


def _byte_planes(ids: torch.Tensor, d: int) -> torch.Tensor:
    """(C, w) int32 ids -> (C, 4, d) int8 little-endian byte planes, the
    id of slot j at lane j, zero pad lanes."""
    w = ids.shape[1]
    planes = [((ids >> (8 * b)) & 0xFF).to(torch.uint8) for b in range(4)]
    out = torch.stack(planes, dim=1).view(torch.int8)
    return torch.nn.functional.pad(out, (0, d - w))


def build_cluster_ext(qdata: torch.Tensor, members: np.ndarray, adj: np.ndarray,
                      qcents: torch.Tensor) -> torch.Tensor:
    """The int8 ext rows -> (C_pad, m + Rc + 8, d) int8, byte-equal to the
    JAX package's ``build_cluster_ext``: member vectors (zero for empty
    slots), 4 member-id byte planes (-1 = 0xff), adjacent-centroid vectors,
    4 adjacent-id byte planes. Needs m <= d, Rc <= d, multiples of 8."""
    C, m = members.shape
    Rc = adj.shape[1]
    d = qdata.shape[1]
    if m % 8 or Rc % 8 or m > d or Rc > d:
        raise ValueError(f"m={m}, Rc={Rc} must be multiples of 8 and <= d={d}")
    C_pad = _c_pad(C)
    mm = _pad_ids(members, C_pad, qdata.device)
    aa = _pad_ids(adj, C_pad, qdata.device)
    return torch.cat([_gather_rows(qdata, mm), _byte_planes(mm, d),
                      _gather_rows(qcents.to(torch.int8), aa), _byte_planes(aa, d)],
                     dim=1)


def build_cluster_ext_f32(data: torch.Tensor, members: np.ndarray,
                          adj: np.ndarray, cents: torch.Tensor) -> torch.Tensor:
    """The f32 ext rows -> (C_pad, m + Rc + 2, d) f32, byte-equal to the
    JAX package's ``build_cluster_ext_f32``: member vectors, member ids as
    f32 (-1.0 empty), adjacent-centroid vectors, adjacent ids as f32. Ids
    as f32 are exact only below 2^24 points."""
    C, m = members.shape
    Rc = adj.shape[1]
    d = data.shape[1]
    if m % 8 or Rc % 8 or m > d or Rc > d:
        raise ValueError(f"m={m}, Rc={Rc} must be multiples of 8 and <= d={d}")
    if data.shape[0] >= 1 << 24:
        raise ValueError("f32 id lanes need n < 2^24")
    C_pad = _c_pad(C)
    mm = _pad_ids(members, C_pad, data.device)
    aa = _pad_ids(adj, C_pad, data.device)

    def plane(ids):
        return torch.nn.functional.pad(ids.float(), (0, d - ids.shape[1]),
                                       value=-1.0)[:, None, :]

    # pad rows: ids -1 give zero vectors and all -1.0 id planes
    return torch.cat([_gather_rows(data.float(), mm), plane(mm),
                      _gather_rows(cents.float(), aa), plane(aa)], dim=1)


@dataclasses.dataclass
class ClusterIndex:
    """Two-level cluster index handle. ``search`` runs the cluster-beam
    walk (kernel 5) and a full-precision rerank (int8 layout) or returns
    the walk's exact scores (f32 layout)."""

    points: PointSet  # full precision (rerank)
    qpoints: Optional[PointSet]  # q8 tier (None for the f32 layout)
    centroids_q: torch.Tensor  # (C_pad, d) in the ext's domain
    members: np.ndarray  # (C, m) int32, -1 padded
    adj: np.ndarray  # (C, Rc) int32, -1 padded
    ext: torch.Tensor  # (C_pad, m + Rc + 8, d) int8 or (C_pad, m + Rc + 2, d) f32
    C: int
    m: int
    Rc: int
    ext_dtype: str = "int8"
    # (mcents, blocks, idtab) over the ext-domain centroids: the query
    # seed's meta router past clusterbeam.ARGMIN_SEED_CUTOFF centroids
    seed_meta: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return self.points.device

    @staticmethod
    def build(points: PointSet, *, m: int = 64, Rc: int = 16, iters: int = 6,
              cand: int = 8, slack: float = 1.5, seed: int = 0,
              ext_dtype: str = "auto", verbose: bool = False) -> "ClusterIndex":
        """``slack``: cluster-count overprovision (C = ceil(n * slack / m));
        with none, the balancer must fill every cluster and displaces
        boundary points into far ones. ``ext_dtype``: "f32" (exact pool
        scores, no rerank), "int8" (q8 rows plus an f32 rerank) or "auto"
        (f32 when n < 2^24 and the f32 rows fit 6 GiB). Past
        ``EXACT_LIMIT`` point-centroid pairs the build is hierarchical
        (``iters`` is then unused: the rounds are ``HIER_ROUNDS``);
        ``verbose`` prints each round's seconds, spill share, teleports and
        router agreement, the respill passes, the polish and the build's
        split."""
        n = points.n
        C = max(8, int(-(-n * slack // m)))
        t0 = time.perf_counter()
        data = points.data[:n].float()
        cmetric = Metric.L2
        with trace.span("build", points.device):
            if float(n) * C > EXACT_LIMIT:
                members, cents = _hier_partition(data, n, C, m, cand, seed, verbose)
            else:
                step = _kmeans_chunk_for(C)
                with trace.span("build.assign"):
                    cents = kmeans(data, n, C, metric=cmetric, iters=iters, seed=seed,
                                   step=step)
                    nbr_ids, nbr_d = _assign_all(data, n, cents, C, cand, cmetric,
                                                 step=step)
                with trace.span("build.balance"):
                    members = _balance(nbr_ids, nbr_d, C, m)
                with trace.span("build.respill"):
                    members = _respill_local(data, n, members, nbr_ids, cents, C, m,
                                             cmetric, verbose=verbose)
                    del nbr_ids, nbr_d
                    cents = _recenter(data, members, C)
            members, cents, _ = drop_empty(members, cents)
            C = members.shape[0]
            t1 = time.perf_counter()
            with trace.span("build.adjacency"):
                if float(C) * C > EXACT_LIMIT:
                    aid, _ = approx_assign(cents, C, cents, C, Rc + 1, cmetric,
                                           meta_m=META_M, seed=seed + 101)
                else:
                    aid, _ = _assign_all(cents, C, cents, C, Rc + 1, cmetric, step=8192)
                # drop self (always the nearest) and compact each row left
                adj = np.where(aid == np.arange(C, dtype=aid.dtype)[:, None], -1, aid)
                ordr = np.argsort(adj < 0, axis=1, kind="stable")
                adj = np.ascontiguousarray(
                    np.take_along_axis(adj, ordr, axis=1)[:, :Rc]).astype(np.int32)
            t2 = time.perf_counter()
            with trace.span("build.finish"):
                out = ClusterIndex._finish(points, members, adj, cents, C, m, Rc,
                                           ext_dtype=ext_dtype)
        if verbose:
            fence(data.device)
            print(f"cluster build: C={C} in {time.perf_counter() - t0:.2f} s "
                  f"(adjacency {t2 - t1:.2f} s"
                  f"{', routed' if float(C) * C > EXACT_LIMIT else ''}, "
                  f"finish {time.perf_counter() - t2:.2f} s)", flush=True)
        return out

    @staticmethod
    def _finish(points: PointSet, members: np.ndarray, adj: np.ndarray,
                cents: torch.Tensor, C: int, m: int, Rc: int,
                ext_dtype: str = "auto") -> "ClusterIndex":
        """Pack the ext rows. int8 mode quantizes points and centroids into
        one q8 domain (one query translation serves both); f32 mode packs
        the raw vectors. Past ``ARGMIN_SEED_CUTOFF`` centroids the query
        seed's quantizer is built over the ext-domain centroids. Clusters
        with no member are dropped first (:func:`drop_empty`), so the
        index's ``C`` can be below the given one."""
        members, cents, adj = drop_empty(members, cents[:C], adj)
        C = members.shape[0]
        n, d = points.n, points.d
        C_pad = _c_pad(C)
        if ext_dtype == "auto":
            f32_bytes = C_pad * (m + Rc + 2) * d * 4
            ext_dtype = "f32" if n < (1 << 24) and f32_bytes <= 6 << 30 else "int8"
        if ext_dtype not in ("f32", "int8"):
            raise ValueError(
                f"ext_dtype must be 'auto', 'f32' or 'int8', got {ext_dtype!r}")
        cents = cents.to(points.device).float()
        pad = (0, 0, 0, C_pad - C)
        if ext_dtype == "f32":
            ext = build_cluster_ext_f32(points.data[:n], members, adj, cents)
            return ClusterIndex(points=points, qpoints=None,
                                centroids_q=torch.nn.functional.pad(cents[:C], pad),
                                members=members, adj=adj, ext=ext, C=C, m=m,
                                Rc=Rc, ext_dtype="f32",
                                seed_meta=_seed_quantizer(cents[:C], C))
        qps = quantize.quantize_pointset(points, bits=8)
        if points.metric is Metric.L2:
            cq = quantize.euclidean_translate(cents, qps.quant_slope,
                                              qps.quant_offset, 8)
        else:
            cq = quantize.mips_translate(cents, qps.quant_slope,
                                         qps.quant_offset, 8)
        ext = build_cluster_ext(qps.data, members, adj, cq)
        return ClusterIndex(points=points, qpoints=qps,
                            centroids_q=torch.nn.functional.pad(cq[:C], pad),
                            members=members, adj=adj, ext=ext, C=C, m=m, Rc=Rc,
                            ext_dtype="int8",
                            seed_meta=_seed_quantizer(cq[:C].float(), C, torch.int8))

    def save(self, path: str) -> None:
        """Persist the structure, members and adjacency (JAX
        clusterindex.py:1197-1205): the centroids, the ext rows and the q8
        tier are functions of (points, members, adj) and are rebuilt at
        load."""
        np.savez(path, members=self.members, adj=self.adj, m=np.int64(self.m),
                 Rc=np.int64(self.Rc), C=np.int64(self.C),
                 n=np.int64(self.points.n), ext_dtype=np.str_(self.ext_dtype))

    @staticmethod
    def load(path: str, points: PointSet) -> "ClusterIndex":
        """A ClusterIndex from a saved structure over ``points`` (on their
        device): the centroids recentred on the membership and the ext rows
        packed in the saved layout. A load is deterministic, even where the
        build's k-means on the card is not."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as z:
            members = z["members"].astype(np.int32)
            adj = z["adj"].astype(np.int32)
            C, m, Rc, n = int(z["C"]), int(z["m"]), int(z["Rc"]), int(z["n"])
            ext_dtype = str(z["ext_dtype"]) if "ext_dtype" in z else "int8"
        if n != points.n:
            raise ValueError(f"index was built on n={n}, points have {points.n}")
        cents = _recenter(points.data, members, C)
        return ClusterIndex._finish(points, members, adj, cents, C, m, Rc,
                                    ext_dtype=ext_dtype)

    def search(self, queries, k: int = 10, *, n_probe: int = 8,
               min_probe: int = 3, cut: float = 1.35, starts: int = 2,
               rerank_factor: int = 2, rerank: str = "auto",
               seed_mode: str = "argmin", select_mode: str = "sort",
               seed_probes: int = 8):
        """-> (ids (B, k), dists (B, k), (probes (B,), distance
        computations (B,))). ``n_probe`` bounds expansions; ``starts``
        seeds the beam with the top-S centroids (exact, or through
        ``seed_meta``'s ``seed_probes`` nearest cells past the argmin
        cutoff; ``seed_mode="stream"``: always exact); the adaptive default
        (cut 1.35 with a min_probe 3 floor) stops a query once its best
        remaining centroid is beyond cut x its best seen, and cut=0
        always runs n_probe probes. ``rerank="auto"`` is "tier" on the f32
        layout (its pool scores are exact) and "full" on the int8 one.

        Under the recorder (``utils/trace.py``) the call is a ``search``
        span (host time; counting its ``queries``) over the steps of
        :func:`~parlayann_tpu_torch.ops.kernels.clusterbeam.cluster_search_fused`."""
        with trace.span("search"):
            q_full = torch.as_tensor(queries).to(self.device, torch.float32)
            trace.count("queries", q_full.shape[0])
            pool = min(max(k * rerank_factor, k), 128)
            if rerank == "auto":
                rerank = "tier" if self.ext_dtype == "f32" else "full"
            qp = self.qpoints
            meta = self.seed_meta if seed_mode != "stream" else None
            return cluster_search_fused(
                q_full, self.centroids_q, self.ext, self.points.data,
                None if qp is None else qp.quant_slope,
                None if qp is None else qp.quant_offset, *(meta or (None,) * 3),
                metric=self.points.metric, C=self.C, m=self.m, Rc=self.Rc,
                n_points=self.points.n, k=k, n_probe=n_probe, min_probe=min_probe,
                cut=cut, S=starts, pool=pool, tier_bits=32 if qp is None else qp.bits,
                rerank=rerank, seed_mode=seed_mode, select_mode=select_mode,
                seed_probes=seed_probes)

    def search_timed(self, queries, *, rounds: int = 1, warmup: bool = True,
                     **kw):
        """Timed steady-state search -> (ids, dists, counters, seconds per
        round): queries uploaded first, one warm-up search, then ``rounds``
        back-to-back searches fenced by ``torch.cuda.synchronize``."""
        queries = torch.as_tensor(queries).to(self.device, torch.float32)
        out, secs = timed_rounds(lambda: self.search(queries, **kw),
                                 self.device, rounds, warmup)
        return (*out, secs)
