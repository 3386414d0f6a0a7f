"""The reference's own search, put in the program's place: the control.

At the precision the configuration states, these functions compute what
the program computes (an 8-bit walk with a float32 rerank, an exact
float32 scan); the control runs them one step below (a 4-bit walk, TF32
products), and that has to come out as not correct.

TF32 is emulated: each float32 operand is rounded to the nearest value
with a 10-bit mantissa (ties to even) and the products are summed in
float32, as the tensor cores do; so the control reads the same on every
device.

The graph walk follows the program's own graph: the reference cannot
build the same graph (the build is the program's), so it walks the
program's adjacency, which ``graph.faults`` checks by itself.
"""

from __future__ import annotations

import numpy as np
import torch

from annbench.reference import knn, quant


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to TF32's 10-bit mantissa (ties to even)."""
    b = x.float().contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _sq(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, d), (B, m, d) -> (B, m) float32 squared L2."""
    return ((v - q[:, None, :]) ** 2).sum(-1)


def _sq_tf32(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The same through TF32 products: ||v||^2 + ||q||^2 - 2 q.v."""
    q, v = round_tf32(q), round_tf32(v)
    return (v * v).sum(-1) + (q * q).sum(-1)[:, None] - 2.0 * (v * q[:, None, :]).sum(-1)


def entry_sample(n: int, device, sample: int = 4096, seed: int = 0) -> torch.Tensor:
    """A fixed uniform sample of ``sample`` point ids, the entry tier."""
    ids = np.random.default_rng(seed).choice(n, min(sample, n), replace=False)
    return torch.as_tensor(ids, device=device).long()


def entry_points(points: torch.Tensor, ids: torch.Tensor, queries: torch.Tensor,
                 tf32: bool = False) -> torch.Tensor:
    """Each query's nearest point of the sample ``ids`` -> (B,) int64 start
    ids."""
    ev = points[ids].float()
    q = queries.float()
    if tf32:
        ev, q = round_tf32(ev), round_tf32(q)
    with knn.full_f32():
        d = (ev * ev).sum(1)[None, :] - 2.0 * (q @ ev.T)
    return ids[d.argmin(dim=1)]


def beam_walk(tier: torch.Tensor, nbrs: torch.Tensor, degs: torch.Tensor,
              queries: torch.Tensor, starts: torch.Tensor, L: int,
              max_steps: int | None = None) -> torch.Tensor:
    """Greedy beam search of each query over the graph, all queries in
    lock-step: the beam holds the L nearest vertices seen, sorted by
    (distance, id); each step expands the nearest unexpanded one; a query
    stops when every vertex in its beam is expanded. Distances are squared
    L2 over ``tier`` (float32 rows). -> (B, L) beam ids, -1 where empty."""
    B, dev = queries.shape[0], queries.device
    R = nbrs.shape[1]
    q = queries.float()
    ids = torch.full((B, L), -1, dtype=torch.long, device=dev)
    dist = torch.full((B, L), float("inf"), device=dev)
    done = torch.ones((B, L), dtype=torch.bool, device=dev)
    ids[:, 0] = starts
    dist[:, 0] = _sq(q, tier[starts][:, None, :])[:, 0]
    done[:, 0] = False
    rows = torch.arange(B, device=dev)
    lanes = torch.arange(R, device=dev)[None, :]
    for _ in range(max_steps or 50 * L):
        todo = ~done
        live = todo.any(dim=1)
        if not bool(live.any()):
            break
        j = todo.to(torch.int8).argmax(dim=1)
        e = ids[rows, j].clamp(min=0)
        done[rows, j] = True
        nb = nbrs[e].long()
        ok = (lanes < degs[e].long()[:, None]) & live[:, None] & (nb >= 0) & (nb < tier.shape[0])
        nb = torch.where(ok, nb, 0)
        # a vertex already in the beam is not added again; one that left
        # the beam is farther than all it holds and cannot come back
        ok &= ~(nb[:, :, None] == ids[:, None, :]).any(dim=2)
        nd = torch.where(ok, _sq(q, tier[nb]), float("inf"))
        all_ids = torch.cat([ids, torch.where(ok, nb, -1)], dim=1)
        all_d = torch.cat([dist, nd], dim=1)
        all_done = torch.cat([done, ~ok], dim=1)
        all_ids, o = torch.sort(all_ids, dim=1)
        all_d, all_done = all_d.gather(1, o), all_done.gather(1, o)
        all_d, o = torch.sort(all_d, dim=1, stable=True)
        ids = all_ids.gather(1, o)[:, :L]
        done = all_done.gather(1, o)[:, :L]
        dist = all_d[:, :L]
        done |= ~torch.isfinite(dist)
    return torch.where(torch.isfinite(dist), ids, -1)


def rerank(points: torch.Tensor, queries: torch.Tensor, beam: torch.Tensor, k: int,
           pool: int, tf32: bool = False):
    """The k nearest of each query's first ``pool`` beam entries at full
    precision (TF32 products with ``tf32``) -> (ids (B, k), dists (B, k))."""
    cand = beam[:, :pool]
    v = points[cand.clamp(min=0)].float()
    d = (_sq_tf32 if tf32 else _sq)(queries.float(), v)
    d = torch.where(cand >= 0, d, float("inf"))
    d, o = torch.sort(d, dim=1, stable=True)
    ids = cand.gather(1, o)[:, :k]
    return torch.where(torch.isfinite(d[:, :k]), ids, -1), d[:, :k]


def graph_search(points: torch.Tensor, n: int, queries: torch.Tensor, nbrs, degs, *,
                 k: int, L: int, bits: int, tf32: bool, rerank_factor: int = 10,
                 block: int = 10_000):
    """The Vamana search in the reference: the entry top-1 over a fixed
    sample, a beam walk of width L over a ``bits``-bit scalar tier of the
    points, and the rerank of the first min(k * rerank_factor, L) beam
    entries -> numpy (ids (B, k), dists (B, k))."""
    levels, slope, lo = quant.scalar_tier(points, n, bits)
    sample = entry_sample(n, points.device)
    pool = min(max(k * rerank_factor, k), L)
    out_i, out_d = [], []
    for s in range(0, queries.shape[0], block):
        q = queries[s:s + block]
        starts = entry_points(points, sample, q, tf32=tf32)
        beam = beam_walk(levels, nbrs, degs, quant.query_levels(q, slope, lo, bits),
                         starts, max(L, k))
        i, d = rerank(points, q, beam, k, pool, tf32=tf32)
        out_i.append(i.cpu().numpy())
        out_d.append(d.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_d)


def flat_scan(points: torch.Tensor, n: int, queries: torch.Tensor, *, k: int,
              tf32: bool) -> tuple:
    """An exact top-k scan of float32 points, its products in float32 or
    (``tf32``) through TF32 -> numpy (ids (B, k), dists (B, k) float32)."""
    xs = points[:n].float()
    if tf32:
        xs = round_tf32(xs)
    xn = (xs * xs).sum(1)
    out_i, out_d = [], []
    with knn.full_f32():
        step = knn._rows(n)
        for s in range(0, queries.shape[0], step):
            q = queries[s:s + step].float()
            if tf32:
                q = round_tf32(q)
            d = torch.addmm(xn[None, :], q, xs.T, alpha=-2.0)
            d, i = torch.topk(d, k, dim=1, largest=False)
            d = d + (q * q).sum(1)[:, None]
            out_i.append(i.cpu().numpy())
            out_d.append(d.cpu().numpy())
    return np.concatenate(out_i), np.concatenate(out_d)
