"""Cluster-sharded search: the capacity mode of the two-level ClusterIndex.

Counterpart of parlayann_tpu/parallel/cluster_sharded.py. The member-vector
payload, the term that grows with n, shards over the mesh's ``d`` axis in
contiguous cluster blocks and never moves. The centroids (n / m rows)
replicate, so the navigation algebra (seed top-S, beam merge, the next
expansion) runs identically on every rank. Each step a query's expanded
cluster lives on one rank: the owner scores its m members in its int8
shard, and the scores reach every rank through an all-reduce (MIN) of
owner-masked values, the member and adjacency ids through one (MAX) each;
every rank then scores the adjacent centroids locally. The full-precision
rerank reads range-sharded float32 points with a MIN merge.

The search is the JAX package's per-step state machine (a cluster beam and
a point pool) in torch ops; the JAX package has no kernel here either. The
build runs Lloyd over row-sharded points with the (C, dim) sums and (C,)
counts all-reduced; the balance, recentering and packing run on every
rank, as the single-device build runs them (build/clusterindex.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.build.clusterindex import (
    ClusterIndex, _balance, _kmeans_chunk_for, _recenter,
)
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.distance import INF, gathered
from parlayann_tpu_torch.ops.topk import lexsort, smallest_k
from parlayann_tpu_torch.parallel.mesh import (
    Mesh, all_gather, any_rank, pmax, pmin, psum, to_mesh,
)
from parlayann_tpu_torch.parallel.sharded import shard_dataset
from parlayann_tpu_torch.search.flat import flat_search_batch
from parlayann_tpu_torch.utils.arrays import pow2


@dataclasses.dataclass
class ShardedClusterIndex:
    """This rank's part of a cluster-sharded index: its block of clusters'
    member payload and adjacency, its row range of the float32 points, and
    the replicated centroids."""

    mesh: Mesh
    centroids_q: torch.Tensor  # (C_pad, dim) int8, replicated (q8 domain)
    mvecs: torch.Tensor  # (Cl, m, dim) int8: this rank's clusters' members
    mids: torch.Tensor  # (Cl, m) int32, -1 padded
    adj: torch.Tensor  # (Cl, Rc) int32, -1 padded
    points: torch.Tensor  # (nl, dim) f32: this rank's row range (rerank)
    slope: torch.Tensor
    offset: torch.Tensor
    C: int
    m: int
    Rc: int
    n: int
    clusters_per_shard: int
    rows_per_shard: int
    metric: Metric
    tier_bits: int = 8

    @staticmethod
    def from_cluster_index(ci: ClusterIndex, mesh: Mesh) -> "ShardedClusterIndex":
        """Shard a built ClusterIndex: member payload by cluster block,
        float32 points by row range, centroids replicated."""
        D, s = mesh.shape["d"], mesh.index("d")
        if ci.qpoints is None:
            raise ValueError(
                "sharded capacity mode needs the int8 ext layout: "
                "build the ClusterIndex with ext_dtype='int8'")
        qdata = ci.qpoints.data
        C, m = ci.members.shape
        Cl = -(-C // D)
        memb = np.full((D * Cl, m), -1, np.int32)
        memb[:C] = ci.members
        adj = np.full((D * Cl, ci.Rc), -1, np.int32)
        adj[:C] = ci.adj
        mine = torch.from_numpy(memb[s * Cl:(s + 1) * Cl]).to(qdata.device)
        mv = qdata[mine.long().clamp(0, qdata.shape[0] - 1)]
        mv = torch.where((mine >= 0)[:, :, None], mv, torch.zeros_like(mv))
        n = ci.points.n
        pts, nl = shard_dataset(ci.points.data[:n].float().cpu().numpy(), mesh)
        dev = mesh.device
        return ShardedClusterIndex(
            mesh=mesh, centroids_q=ci.centroids_q.to(dev),
            mvecs=mv.to(torch.int8).to(dev), mids=mine.to(dev),
            adj=torch.from_numpy(adj[s * Cl:(s + 1) * Cl]).to(dev), points=pts,
            slope=ci.qpoints.quant_slope.to(dev), offset=ci.qpoints.quant_offset.to(dev),
            C=ci.C, m=m, Rc=ci.Rc, n=n, clusters_per_shard=Cl, rows_per_shard=nl,
            metric=ci.points.metric, tier_bits=ci.qpoints.bits)

    def to(self, mesh: Mesh) -> "ShardedClusterIndex":
        """The same shard on another mesh of the same shape (its device)."""
        return to_mesh(self, mesh)

    def search(self, queries, k: int = 10, *, n_probe: int = 8,
               min_probe: int = 0, cut: float = 0.0, starts: int = 2,
               pool: int = 128, rerank_pool: int = 20):
        """-> (ids (B, k), dists (B, k) full precision, n_probes (B,)), the
        same on every rank."""
        q_full = torch.as_tensor(np.asarray(queries)).to(self.mesh.device, torch.float32)
        return _sharded_cluster_search(
            self, q_full, k=k, n_probe=n_probe, min_probe=min_probe, cut=cut,
            S=starts, pool=pool, rerank_pool=rerank_pool)


def _sharded_kmeans_assign(pts, init_cents, *, mesh, metric, C, n, nl, iters, k):
    """Distributed Lloyd + final k-candidate assignment -> ((nl, k) ids,
    (nl, k) dists of this rank's rows, the final (C, dim) centroids).

    Points never move: each rank scores its row block against the
    replicated centroids and adds its valid rows into (C, dim) sums and
    (C,) counts; their all-reduce, the only traffic and independent of n,
    replicates the update. A centroid that attracts no point stays."""
    dev = pts.device
    valid = (mesh.index("d") * nl + torch.arange(nl, device=dev)) < n
    step = _kmeans_chunk_for(C)
    chunk = min(C, 32768)
    cents = init_cents
    for _ in range(iters):
        sums = torch.zeros_like(cents)
        cnts = torch.zeros(C, dtype=torch.float32, device=dev)
        for lo in range(0, nl, step):
            blk, ok = pts[lo:lo + step], valid[lo:lo + step]
            aid = flat_search_batch(blk, cents, k=1, metric=metric, n_valid=C,
                                    chunk=chunk, select="sort")[0][:, 0].long()
            sums.index_add_(0, aid[ok], blk[ok])
            cnts.index_add_(0, aid[ok], torch.ones_like(aid[ok], dtype=torch.float32))
        sums, cnts = psum(mesh, sums), psum(mesh, cnts)
        new = sums / torch.clamp(cnts, min=1.0)[:, None]
        cents = torch.where((cnts > 0)[:, None], new, cents)
    parts = [flat_search_batch(pts[lo:lo + step], cents, k=k, metric=metric,
                               n_valid=C, chunk=chunk, select="sort")
             for lo in range(0, nl, step)]
    return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]),
            cents)


def build_sharded_cluster(
    data: np.ndarray,
    mesh: Mesh,
    *,
    m: int = 64,
    Rc: int = 16,
    iters: int = 6,
    cand: int = 8,
    slack: float = 1.5,  # displacement rate sets the recall ceiling, as
    # in ClusterIndex.build
    seed: int = 0,
) -> ShardedClusterIndex:
    """Distributed ClusterIndex build: Lloyd k-means and the candidate
    assignment, the build's O(n) phases, run where the rows live, with
    all-reduced centroid statistics; the O(C) finishing passes (capacity
    balance, recentering, adjacency, quantization, payload sharding) run
    on every rank. Each rank passes the full host ``data``."""
    n, dim = data.shape
    dev = mesh.device
    C = max(8, int(-(-n * slack // m)))
    data = np.asarray(data, dtype=np.float32)
    pts, nl = shard_dataset(data, mesh)
    rng = np.random.default_rng(seed)
    init = torch.from_numpy(data[rng.choice(n, C, replace=False)]).to(dev)
    ids, ds, cents = _sharded_kmeans_assign(
        pts, init, mesh=mesh, metric=Metric.L2, C=C, n=n, nl=nl, iters=iters, k=cand)
    nbr_ids = all_gather(mesh, ids)[:n].cpu().numpy()
    nbr_d = all_gather(mesh, ds)[:n].cpu().numpy()
    members = _balance(nbr_ids, nbr_d, C, m)
    ps = PointSet.from_numpy(data, device=dev)
    cents = _recenter(ps.data[:n].float(), members, C)
    adj, _ = _assign_centroid_knn(cents, C, Rc)
    # sharding IS the capacity regime: always the int8 payload layout
    ci = ClusterIndex._finish(ps, members, adj, cents, C, m, Rc, ext_dtype="int8")
    return ShardedClusterIndex.from_cluster_index(ci, mesh)


def _assign_centroid_knn(cents, C: int, Rc: int):
    """Centroid k-NN adjacency without self -> ((C, Rc) int32, None)."""
    aid, _ = flat_search_batch(cents, cents, k=Rc + 1, metric=Metric.L2, n_valid=C,
                               chunk=min(cents.shape[0], 32768), select="sort")
    aid = aid.cpu().numpy()
    adj = np.where(aid == np.arange(C, dtype=np.int32)[:, None], -1, aid)
    # compact each row's kept ids to the left, in order
    order = np.argsort(adj < 0, axis=1, kind="stable")
    return np.ascontiguousarray(
        np.take_along_axis(adj, order, axis=1)[:, :Rc]).astype(np.int32), None


def _scores(vecs, q, metric):
    """(B, P, dim) rows, (B, dim) queries -> (B, P) float32 distances; the
    inner product as an einsum, in the order of JAX's dot_general."""
    if metric is Metric.MIPS:
        return -torch.einsum("bpd,bd->bp", vecs, q)
    return gathered(q, vecs, metric)


def _sharded_cluster_search(idx: ShardedClusterIndex, q_full, *, k, n_probe,
                            min_probe, cut, S, pool, rerank_pool):
    mesh, metric, C = idx.mesh, idx.metric, idx.C
    B = q_full.shape[0]
    dev = q_full.device
    Lc = n_probe + 4
    Cl, nl = idx.clusters_per_shard, idx.rows_per_shard
    if idx.tier_bits < 32 and idx.slope is not None:
        translate = (quantize.euclidean_translate if metric is Metric.L2
                     else quantize.mips_translate)
        q = translate(q_full, idx.slope, idx.offset, idx.tier_bits).float()
    else:
        q = q_full
    cf = idx.centroids_q.float()
    lo_c = mesh.index("d") * Cl  # first owned cluster
    lo_r = mesh.index("d") * nl  # first owned point row

    # seed: the exact top-S centroids (replicated algebra)
    dots = q @ cf.T
    cd0 = -dots if metric is Metric.MIPS else (cf * cf).sum(1)[None, :] - 2.0 * dots
    cid0 = torch.arange(cf.shape[0], dtype=torch.int32, device=dev)
    cd0 = torch.where(cid0[None, :] < C, cd0, INF)
    sd, sids = smallest_k(cd0, cid0.expand(B, -1), S)
    Wc = pow2(max(Lc, S, 8))
    lane = torch.arange(Wc, device=dev)[None, :]
    live = lane < Lc
    cbd = torch.where(live, torch.cat([sd, torch.full((B, Wc - S), INF, device=dev)], 1),
                      INF)
    cbi = torch.cat([sids, torch.full((B, Wc - S), -1, dtype=torch.int32, device=dev)], 1)
    cbx = torch.zeros((B, Wc), dtype=torch.bool, device=dev)  # expanded flags
    pd = torch.full((B, pool), INF, device=dev)
    pi = torch.full((B, pool), -1, dtype=torch.int32, device=dev)
    nv = torch.zeros(B, dtype=torch.int32, device=dev)

    def pick(cbd, cbi, cbx, nv):
        """First unexpanded in-cut lane -> (expand ids (B,) or -1, lane)."""
        unexp = ~cbx & (cbd < INF)
        if cut > 0.0 and metric.is_metric:
            # the fused kernel's adaptive rule: a centroid cut with a
            # min_probe floor
            unexp = unexp & ((cbd < cut * cbd[:, :1]) | (nv[:, None] < min_probe))
        has = unexp.any(1)
        first = unexp.to(torch.int32).argmax(1)
        e = cbi.gather(1, first[:, None])[:, 0]
        return torch.where(has & (nv < n_probe), e, -1), first

    e, first = pick(cbd, cbi, cbx, nv)
    # every rank holds the same state, and the all-reduce keeps the loop's
    # collectives aligned whatever happens
    while any_rank(mesh, e >= 0):
        act = e >= 0
        own = act & (e >= lo_c) & (e < lo_c + Cl)
        loc = (e - lo_c).clamp(0, Cl - 1).long()

        # the owner scores the members; the all-reduce replicates them
        rid = idx.mids[loc]
        md = _scores(idx.mvecs[loc].float(), q, metric)
        ok = own[:, None] & (rid >= 0) & (rid < idx.n)
        md = pmin(mesh, torch.where(ok, md, INF))
        rid = pmax(mesh, torch.where(ok, rid, -1))

        # pool merge: a sorted concat, keep the best ``pool``
        cd_, ci_ = lexsort((torch.cat([pd, md], 1),), torch.cat([pi, rid], 1))
        pd2, pi2 = cd_[:, :pool], ci_[:, :pool]

        # adjacency: the owner's ids, scored by every rank against the
        # replicated centroids
        aid = pmax(mesh, torch.where(own[:, None], idx.adj[loc], -1))
        avalid = (aid >= 0) & (aid < C) & act[:, None]
        avec = cf[aid.long().clamp(0, cf.shape[0] - 1)]
        adist = _scores(avec, q, metric)
        dup = (aid[:, :, None] == cbi[:, None, :]).any(-1)
        adist = torch.where(avalid & ~dup, adist, INF)

        # beam merge
        nx = torch.cat([cbx | ((lane == first[:, None]) & act[:, None]),
                        torch.zeros(aid.shape, dtype=torch.bool, device=dev)], 1)
        nd_s, ni_s, nx_s = lexsort((torch.cat([cbd, adist], 1),),
                                   torch.cat([cbi, aid], 1), nx.to(torch.int32))
        cbd2 = torch.where(live, nd_s[:, :Wc], INF)
        cbi2 = torch.where(live, ni_s[:, :Wc], -1)
        cbx2 = nx_s[:, :Wc].bool() & live

        sel = act[:, None]
        nv = nv + act.to(torch.int32)
        cbd = torch.where(sel, cbd2, cbd)
        cbi = torch.where(sel, cbi2, cbi)
        cbx = torch.where(sel, cbx2, cbx)
        pd = torch.where(sel, pd2, pd)
        pi = torch.where(sel, pi2, pi)
        e, first = pick(cbd, cbi, cbx, nv)

    # rerank: range-sharded float32 points, MIN merge
    cand = pi[:, :rerank_pool]
    cin = (cand >= lo_r) & (cand < lo_r + nl)
    cvec = idx.points[(cand - lo_r).long().clamp(0, nl - 1)]
    cd = pmin(mesh, torch.where(cin & (cand >= 0), _scores(cvec, q_full, metric), INF))
    pos = torch.arange(cand.shape[1], device=dev).expand_as(cand)
    dists, kidx = smallest_k(cd, pos, k)
    ids = torch.where(dists < INF, cand.gather(1, kidx), -1)
    return ids, dists, nv
