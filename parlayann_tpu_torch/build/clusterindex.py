"""ClusterIndex: the two-level cluster structure (build side).

Counterpart of parlayann_tpu/build/clusterindex.py, the exact build path
(:1090-1118). The points are partitioned into C = ceil(n * slack / m)
clusters of at most m: Lloyd k-means over the flat scan, a capacity-
balanced assignment over each point's ``cand`` nearest centroids, a
respill of the points it had to place arbitrarily into their nearest
clusters with free capacity, and centroids recentred on the final
membership. Each cluster's Rc nearest clusters form its adjacency, and one
packed ext row per cluster holds its member vectors and ids and its
adjacent centroids and ids (layouts in ops/kernels/clusterbeam.py). The
search walks clusters, not points (kernel 5).

The partition is always L2 (clustering by inner product is degenerate);
MIPS indexes score by the true metric at query time. Not ported yet
(ROADMAP queue 1, "The rest of ClusterIndex"), each raising
``NotImplementedError``: the hierarchical build past n * C > 4e10
(approx_assign, the meta quantizer, teleport and polish) and the
meta-routed query seed past 32768 centroids; ``save``/``load`` are
queue 1, "File I/O". The JAX package's environment knobs are not
read; the port ships their defaults. The JAX respill pads its free
centroids with 1e15 rows to fix compile shapes, a sentinel that would win
under MIPS; the port has no compile shapes and no padding.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.index import _not_ported
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.clusterbeam import cluster_search_fused
from parlayann_tpu_torch.search.flat import flat_search_batch
from parlayann_tpu_torch.utils.timing import timed_rounds

# past this many point-centroid pairs the JAX package switches to its
# hierarchical (meta-routed) passes
EXACT_LIMIT = 4e10
ITEM = 'queue 1, "The rest of ClusterIndex"'


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
        ids.append(i.cpu().numpy())
        ds.append(d.cpu().numpy())
    return np.concatenate(ids), np.concatenate(ds)


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
    which is bit-identical to its native/balance.cpp: points in order of
    their nearest-centroid distance take part in rank rounds (everyone's
    first choice before anyone's second); points whose candidates are all
    full spill to the emptiest clusters."""
    order = np.argsort(nbr_d[:, 0], kind="stable").astype(np.int64)
    members = np.full((C, m), -1, np.int32)
    fill = np.zeros(C, np.int64)
    items = np.arange(len(nbr_ids), dtype=np.int64)
    placed = _place_rounds(members, fill, nbr_ids, order, items, m)
    pending = order[~placed[order]]
    if len(pending):
        _spill_emptiest(members, fill, pending, m)
    return members


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


def _respill_local(data: torch.Tensor, n: int, members: np.ndarray,
                   nbr_ids: np.ndarray, cents: torch.Tensor, C: int, m: int,
                   metric: Metric, *, verbose: bool = False) -> np.ndarray:
    """Re-place spilled points into their nearest clusters with free
    capacity -> members (C, m): search them against the free clusters'
    centroids and place them by the same rank rounds, widening the
    candidate count (8, 32, ..., 1024) until everyone fits."""
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
        if float(len(pending)) * len(free) > EXACT_LIMIT:
            _not_ported("the hierarchical respill (pending x free > 4e10)",
                        ITEM)
        sub = cents[torch.from_numpy(free).to(cents.device)]
        pvec = data[torch.from_numpy(pending).to(data.device)]
        ids, d = _assign_all(pvec, len(pending), sub, len(free), kk, metric)
        gids = np.where((ids >= 0) & (ids < len(free)),
                        free[np.clip(ids, 0, len(free) - 1)], -1)
        order = np.argsort(d[:, 0], kind="stable")
        placed = _place_rounds(members, fill, gids, order, pending, m)
        if verbose:
            print(f"respill pass {it} (k={kk}): {n_spill} -> "
                  f"{int((~placed).sum())} left", flush=True)
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
    cluster, as in the JAX package)."""
    mm = torch.from_numpy(members[:C]).to(data.device)
    ok = mm >= 0
    vecs = data[mm.clamp(min=0).long()].float()
    s = torch.where(ok[:, :, None], vecs, 0.0).sum(dim=1)
    return s / torch.clamp(ok.sum(dim=1, keepdim=True).float(), min=1.0)


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
        (f32 when n < 2^24 and the f32 rows fit 6 GiB)."""
        n = points.n
        C = max(8, int(-(-n * slack // m)))
        if float(n) * C > EXACT_LIMIT:
            _not_ported(f"the hierarchical build (n x C = {float(n) * C:.3g}"
                        " > 4e10)", ITEM)
        t0 = time.perf_counter()
        step = _kmeans_chunk_for(C)
        data = points.data[:n].float()
        cmetric = Metric.L2
        cents = kmeans(data, n, C, metric=cmetric, iters=iters, seed=seed,
                       step=step)
        nbr_ids, nbr_d = _assign_all(data, n, cents, C, cand, cmetric, step=step)
        members = balance_assign(nbr_ids, nbr_d, C, m)
        members = _respill_local(data, n, members, nbr_ids, cents, C, m,
                                 cmetric, verbose=verbose)
        cents = _recenter(data, members, C)
        aid, _ = _assign_all(cents, C, cents, C, Rc + 1, cmetric, step=8192)
        # drop self (always the nearest) and compact each row left
        adj = np.where(aid == np.arange(C, dtype=aid.dtype)[:, None], -1, aid)
        ordr = np.argsort(adj < 0, axis=1, kind="stable")
        adj = np.ascontiguousarray(
            np.take_along_axis(adj, ordr, axis=1)[:, :Rc]).astype(np.int32)
        if verbose:
            print(f"cluster build: C={C} in {time.perf_counter() - t0:.2f} s",
                  flush=True)
        return ClusterIndex._finish(points, members, adj, cents, C, m, Rc,
                                    ext_dtype=ext_dtype)

    @staticmethod
    def _finish(points: PointSet, members: np.ndarray, adj: np.ndarray,
                cents: torch.Tensor, C: int, m: int, Rc: int,
                ext_dtype: str = "auto") -> "ClusterIndex":
        """Pack the ext rows. int8 mode quantizes points and centroids into
        one q8 domain (one query translation serves both); f32 mode packs
        the raw vectors."""
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
                                Rc=Rc, ext_dtype="f32")
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
                            ext_dtype="int8")

    def save(self, path: str) -> None:
        _not_ported("ClusterIndex.save", 'queue 1, "File I/O"')

    @staticmethod
    def load(path: str, points: PointSet) -> "ClusterIndex":
        _not_ported("ClusterIndex.load", 'queue 1, "File I/O"')

    def search(self, queries, k: int = 10, *, n_probe: int = 8,
               min_probe: int = 3, cut: float = 1.35, starts: int = 2,
               rerank_factor: int = 2, rerank: str = "auto",
               seed_mode: str = "argmin", select_mode: str = "sort"):
        """-> (ids (B, k), dists (B, k), (probes (B,), distance
        computations (B,))). ``n_probe`` bounds expansions; ``starts``
        seeds the beam with the exact top-S centroids; the adaptive default
        (cut 1.35 with a min_probe 3 floor) stops a query once its best
        remaining centroid is beyond cut x its best seen, and cut=0
        always runs n_probe probes. ``rerank="auto"`` is "tier" on the f32
        layout (its pool scores are exact) and "full" on the int8 one."""
        q_full = torch.as_tensor(queries).to(self.device, torch.float32)
        pool = min(max(k * rerank_factor, k), 128)
        if rerank == "auto":
            rerank = "tier" if self.ext_dtype == "f32" else "full"
        qp = self.qpoints
        return cluster_search_fused(
            q_full, self.centroids_q, self.ext, self.points.data,
            None if qp is None else qp.quant_slope,
            None if qp is None else qp.quant_offset,
            metric=self.points.metric, C=self.C, m=self.m, Rc=self.Rc,
            n_points=self.points.n, k=k, n_probe=n_probe, min_probe=min_probe,
            cut=cut, S=starts, pool=pool, tier_bits=32 if qp is None else qp.bits,
            rerank=rerank, seed_mode=seed_mode, select_mode=select_mode)

    def search_timed(self, queries, *, rounds: int = 1, warmup: bool = True,
                     **kw):
        """Timed steady-state search -> (ids, dists, counters, seconds per
        round): queries uploaded first, one warm-up search, then ``rounds``
        back-to-back searches fenced by ``torch.cuda.synchronize``."""
        queries = torch.as_tensor(queries).to(self.device, torch.float32)
        out, secs = timed_rounds(lambda: self.search(queries, **kw),
                                 self.device, rounds, warmup)
        return (*out, secs)
