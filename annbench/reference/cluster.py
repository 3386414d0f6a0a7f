"""The ClusterIndex in the reference: the invariants of its structure and
its search, recomputed from the points.

``faults`` holds the structure the program built to what the search
relies on. ``search`` is the cluster-beam search as the walk kernel's
header (``csrc/clusterbeam.cu``) and the JAX package's docstrings state
it, over the program's structure: the members, the adjacency, the
centroids in the tier's levels and the seed quantizer's cells and
meta-centroids. Every distance is computed here, from the points' scalar
tier (``quant.scalar_tier``) and the centroids; the packed ext rows are
not read, so a packing fault shows as answers that differ.

The search, for each query:

1. the seed: with a seed quantizer, the ``seed_probes`` meta-cells whose
   meta-centroids are nearest (float64, ties by cell), then the
   ``starts`` nearest centroids among their members, cell by cell in
   that order (ties keep it); without one, the ``starts`` nearest of all
   centroids, by (distance, id);
2. the walk: a beam of ``n_probe + 4`` centroids ordered by (distance,
   id) holds the seeds; each of ``n_probe`` expansions takes its nearest
   unexpanded entry, offers the cluster's members to the pool and merges
   its adjacent centroids that are not in the beam, keeping the beam's
   width (cut 0: no early stop);
3. the pool: each member slot j keeps the ``POOL_DEPTH`` nearest members
   offered in slot j, earlier expansions first among equals; the pool is
   ordered by (tier distance, id);
4. the rerank: the first ``k * rerank_factor`` of the pool, scored in
   float64 (the stated float32, exactly rounded), the k nearest.

Walk distances are squared L2 between integer levels, exact in float64.
The control runs the same search on a 4-bit tier (the centroids' levels
scaled to it) with TF32 products in the rerank.
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference import control, quant

POOL_DEPTH = 4  # M: the depth of each member slot's list
INF = float("inf")


def faults(st: dict, n: int) -> int:
    """Faults of a ClusterIndex's structure ``st`` (``members`` (C, m),
    ``adj`` (C, Rc) numpy; ``centroids`` (C, d); ``seed`` None or
    (mcents, blocks, idtab)) over ``n`` points, counted one by one:

    - the membership: each of the n points in no cluster or in more than
      one, an id out of range, a row whose -1 padding is not at its end,
      a row of more than m slots;
    - an empty cluster the seed or an adjacency row can reach;
    - the adjacency: an id out of range, to the row itself or repeated, a
      row whose -1 padding is not at its end;
    - the seed quantizer: a centroid in no cell or in more than one, an
      id out of range, a block row other than the centroid its ``idtab``
      names (zero where it names none), a meta-centroid not finite."""
    mem = np.asarray(st["members"]).astype(np.int64)
    adj = np.asarray(st["adj"]).astype(np.int64)
    C, m = mem.shape
    bad = int(m > st["m"]) + int(adj.shape != (C, st["Rc"]))

    def padding(rows):
        # a -1 followed by an id in the same row
        v = rows >= 0
        return int((~v[:, :-1] & v[:, 1:]).any(axis=1).sum())

    ok = mem >= 0
    bad += int((mem >= n).sum()) + int((mem < -1).sum())
    inr = mem[ok & (mem < n)]
    cnt = np.bincount(inr, minlength=n)
    bad += int((cnt != 1).sum()) + padding(mem)
    empty = ~ok.any(axis=1)

    a_ok = adj >= 0
    bad += int(((adj >= C) | (adj < -1)).sum()) + padding(adj)
    bad += int((a_ok & (adj == np.arange(C)[:, None])).sum())
    s = np.sort(np.where(a_ok, adj, C + np.arange(adj.shape[1])[None, :]), axis=1)
    bad += int((s[:, 1:] == s[:, :-1]).sum())
    named = np.zeros(C, bool)
    named[adj[a_ok & (adj < C)]] = True

    seed = st.get("seed")
    if seed is None:
        named[:] = True  # the seed scans every centroid
    else:
        mcents, blocks, idtab = seed
        ids = idtab.long().cpu()
        i_ok = ids >= 0
        bad += int(((ids >= C) | (ids < -1)).sum())
        got = ids[i_ok & (ids < C)].numpy()
        bad += int((np.bincount(got, minlength=C) != 1).sum())
        named[got] = True
        cents = st["centroids"].float().cpu()
        want = torch.where(i_ok[:, :, None], cents[ids.clamp(0, C - 1)], 0.0)
        bad += int((blocks.float().cpu() != want).any(dim=2).sum())
        bad += int((~torch.isfinite(mcents.float())).any(dim=1).sum())
    bad += int((empty & named).sum())
    return bad


def _levels(points, n: int, queries, st: dict, bits: int):
    """The tier of the points as uint8 levels, the queries' levels and the
    centroids' and meta-centroids' levels at ``bits`` (the program's are
    in q8 levels less 128; a 4-bit level is an 8-bit one over 17, since
    2^4 - 1 = 255 / 17)."""
    lv, slope, lo = quant.scalar_tier(points, n, bits)
    tier = lv.to(torch.uint8)
    del lv
    q = quant.query_levels(queries, slope, lo, bits)
    scale = (2.0 ** bits - 1.0) / 255.0
    cents = (st["centroids"].double() + 128.0) * scale
    if bits < 8:
        cents = torch.round(cents)
    meta = None
    if st.get("seed") is not None:
        mcents, _, idtab = st["seed"]
        meta = ((mcents.double() + 128.0) * scale, idtab.long())
    return tier, q, cents, meta


def _sq(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, d), (B, w, d) -> (B, w) float64 squared L2."""
    return ((v.double() - q.double()[:, None, :]) ** 2).sum(-1)


def _seed(q, cents, meta, S: int, seed_probes: int):
    """The top-S centroids of each query -> (dists (B, S), ids (B, S))."""
    qd = q.double()
    if meta is None:
        # integer levels: the expanded form is exact in float64
        d = (cents * cents).sum(1)[None, :] - 2.0 * qd @ cents.T + (qd * qd).sum(1)[:, None]
        ids = torch.arange(cents.shape[0], device=q.device).expand_as(d)
    else:
        mc, idtab = meta
        Cm, cap = idtab.shape
        P = max(1, min(seed_probes, Cm))
        md = (mc * mc).sum(1)[None, :] - 2.0 * qd @ mc.T + (qd * qd).sum(1)[:, None]
        cells = torch.sort(md, dim=1, stable=True).indices[:, :P]  # ties by cell
        ids = idtab[cells].reshape(q.shape[0], P * cap)  # cell by cell
        ids = torch.where(ids < cents.shape[0], ids, -1)
        d = _sq(q, cents[ids.clamp(min=0)])
        d = torch.where(ids >= 0, d, INF)
        o = torch.sort(d, dim=1, stable=True).indices
        d, ids = d.gather(1, o), ids.gather(1, o)
        return d[:, :S], torch.where(torch.isfinite(d[:, :S]), ids[:, :S], -1)
    # (distance, id): the columns are in id order
    o = torch.sort(d, dim=1, stable=True).indices[:, :S]
    return d.gather(1, o), ids.gather(1, o)


def _order(d, i):
    """Rows ordered by (distance, id), empty entries (-1, INF) last."""
    key = torch.where(i >= 0, i, torch.iinfo(torch.int64).max)
    o = torch.sort(key, dim=1, stable=True).indices
    d, i = d.gather(1, o), i.gather(1, o)
    o = torch.sort(d, dim=1, stable=True).indices
    return d.gather(1, o), i.gather(1, o)


def _merge(bd, bi, cd, ci, width: int):
    """The beam and candidates ordered by (distance, id), the first
    ``width`` kept."""
    d, i = _order(torch.cat([bd, cd], 1), torch.cat([bi, ci], 1))
    return d[:, :width], i[:, :width]


def walk(tier, q, cents, members, adj, seed_d, seed_i, *, n: int, n_probe: int):
    """The walk of every query from its seeds, in lock-step -> (pool ids,
    their tier distances), at most m * POOL_DEPTH a query, ordered by
    (distance, id), -1 and INF where empty."""
    B, dev = q.shape[0], q.device
    C, m = members.shape
    Lc = n_probe + 4
    rows = torch.arange(B, device=dev)
    bd = torch.full((B, Lc), INF, dtype=torch.float64, device=dev)
    bi = torch.full((B, Lc), -1, dtype=torch.int64, device=dev)
    done = torch.zeros((B, Lc), dtype=torch.bool, device=dev)
    S = min(seed_d.shape[1], Lc)
    bd, bi = _merge(bd, bi, seed_d[:, :S].double(), seed_i[:, :S].long(), Lc)
    offered_d, offered_i = [], []
    for _ in range(n_probe):
        work = ~done & (bi >= 0)
        go = work.any(dim=1)
        if not bool(go.any()):
            break
        lane = work.to(torch.int8).argmax(dim=1)
        e = torch.where(go, bi[rows, lane], 0)
        done[rows, lane] |= go
        mid = members[e]
        md = _sq(q, tier[mid.clamp(0, tier.shape[0] - 1)])
        okm = (mid >= 0) & (mid < n) & go[:, None]
        offered_d.append(torch.where(okm, md, INF))
        offered_i.append(torch.where(okm, mid, -1))
        aid = adj[e]
        cd = _sq(q, cents[aid.clamp(0, C - 1)])
        ok = (aid >= 0) & (aid < C) & go[:, None]
        ok &= ~(aid[:, :, None] == bi[:, None, :]).any(dim=2)
        cd = torch.where(ok, cd, INF)
        ci = torch.where(ok, aid, -1)
        # expanded marks travel with their entries through the merge
        nd, ni = _merge(bd, bi, cd, ci, Lc)
        was = (ni[:, :, None] == torch.where(done, bi, -2)[:, None, :]).any(dim=2)
        bd, bi, done = nd, ni, was & (ni >= 0)
    # each slot keeps its POOL_DEPTH nearest, earlier expansions first
    od = torch.stack(offered_d, 1) if offered_d else torch.full((B, 1, m), INF, device=dev)
    oi = torch.stack(offered_i, 1) if offered_i else torch.full((B, 1, m), -1, device=dev)
    o = torch.sort(od, dim=1, stable=True).indices[:, :POOL_DEPTH]
    pd, pi = _order(od.gather(1, o).reshape(B, -1), oi.gather(1, o).reshape(B, -1))
    return pi, pd


def search(points: torch.Tensor, n: int, queries: torch.Tensor, st: dict, *, k: int,
           n_probe: int, starts: int, seed_probes: int, rerank_factor: int,
           bits: int = 8, tf32: bool = False, block: int = 1024):
    """The cluster-beam search over the program's structure ``st`` at
    ``bits`` (8: the configuration's tier) and a rerank in float64, or
    through TF32 products with ``tf32`` -> numpy (ids (B, k), dists (B,
    k)), -1 and INF where a query has fewer than k."""
    if st["centroids"].dtype != torch.int8:
        raise ValueError("the reference searches the int8 layout's structure")
    dev = points.device
    members = torch.as_tensor(np.asarray(st["members"])).to(dev).long()
    adj = torch.as_tensor(np.asarray(st["adj"])).to(dev).long()
    tier, ql, cents, meta = _levels(points, n, queries, st, bits)
    pool = min(max(k * rerank_factor, k), 128)
    out_i, out_d = [], []
    for s in range(0, queries.shape[0], block):
        q = ql[s:s + block]
        sd, si = _seed(q, cents, meta, starts, seed_probes)
        pi, _ = walk(tier, q, cents, members, adj, sd, si, n=n, n_probe=n_probe)
        qf = queries[s:s + block].float()
        cand = pi[:, :pool]
        v = points[cand.clamp(min=0)].float()
        if tf32:
            d = control._sq_tf32(qf, v).double()
        else:
            d = _sq(qf, v)
        d = torch.where(cand >= 0, d, INF)
        o = torch.sort(d, dim=1, stable=True).indices[:, :k]
        d, ids = d.gather(1, o), cand.gather(1, o)
        out_i.append(torch.where(torch.isfinite(d), ids, -1).cpu().numpy())
        out_d.append(d.float().cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_d)
