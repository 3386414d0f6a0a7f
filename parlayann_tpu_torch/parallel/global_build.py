"""Cross-shard global Vamana build and search.

Counterpart of parlayann_tpu/parallel/global_build.py. Unlike
``parallel.sharded`` (independent per-shard graphs, merged at query time),
this builds ONE graph over all n points with its rows sharded over the
mesh's ``d`` axis: the distributed form of the reference's shared-memory
build (vamana/index.h:188-316), with ParlayLib's ``group_by_key`` semisort
replaced by collectives.

  * Each rank holds rows ``[d * nl, (d + 1) * nl)`` of the points and of
    the graph; global vertex v lives on rank v // nl, slot v % nl, and
    neighbour ids are global.
  * The insert batch splits over ``d``: each rank advances B / D queries.
  * A beam step all-gathers the expansion ids, every rank computes the
    neighbour ids and distances of the rows and vectors it owns, and one
    reduce-scatter hands each rank its queries' candidates. A query's
    vectors come through the same all-gather / owner-gather /
    reduce-scatter exchange (:func:`_exchange_rows`).
  * The forward robustPrune (kernel 2) runs on each rank for its queries,
    over candidate vectors from that exchange.
  * Reverse edges: the forward edges are all-gathered, every rank runs the
    same semisort and writes only the targets it owns.
  * Overflow α-prune (kernel 2): the replicated overflow list is dealt
    round-robin (entry i to rank i % D), in chunks of ``prune_chunk``
    targets; each chunk's rows return to their owners through an
    all-gather and owner-masked writes.

Every loop that JAX ends on a ``psum``'d flag ends here on an all-reduced
flag, and every chunk count derives from replicated values, so all ranks
issue the same collectives in the same order.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.build.prune import PruneResult, _occlusion_loop
from parlayann_tpu_torch.build.reverse import _union_rows
from parlayann_tpu_torch.build.vamana import _pad_pow2, batch_schedule
from parlayann_tpu_torch.ops.distance import INF, gathered
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.parallel.mesh import (
    Mesh, all_gather, any_rank, make_mesh_1d, psum, psum_scatter, to_mesh,
)
from parlayann_tpu_torch.parallel.sharded import _storage, shard_dataset
from parlayann_tpu_torch.search.beam import _has_work, _merge
from parlayann_tpu_torch.utils.arrays import segment_bounds

__all__ = ["make_mesh_1d", "GlobalIndex", "build_global_vamana", "global_search",
           "collective_volume_report"]

# overflow targets a rank prunes at once (JAX global_build.py:563)
PRUNE_CHUNK = 1024


@dataclasses.dataclass
class GlobalIndex:
    """This rank's rows of one global graph sharded over ``d``."""

    mesh: Mesh
    points: torch.Tensor  # (nl, dim)
    nbrs: torch.Tensor  # (nl, R) global neighbour ids
    degs: torch.Tensor  # (nl,)
    n: int
    rows_per_shard: int
    max_degree: int
    metric: Metric
    start_point: int = 0

    def to(self, mesh: Mesh) -> "GlobalIndex":
        """The same rows on another mesh of the same shape (its device)."""
        return to_mesh(self, mesh)


# ---------------------------------------------------------------------------
# collective helpers
# ---------------------------------------------------------------------------


def _own_rows(local, gids, shard, nl):
    """Local rows for global ids; zeros for ids other ranks own -> (rows,
    owned mask)."""
    lid = gids - shard * nl
    ok = (lid >= 0) & (lid < nl)
    rows = local[lid.long().clamp(0, nl - 1)]
    ok_b = ok.reshape(ok.shape + (1,) * (rows.dim() - ok.dim()))
    return torch.where(ok_b, rows, torch.zeros((), dtype=rows.dtype, device=rows.device)), ok


def _exchange_rows(mesh, local, gids_mine):
    """All-gather the ids, serve the owned rows, reduce-scatter back.

    ``gids_mine``: (b, ...) global ids this rank needs rows for;
    ``local``: (nl, ...) this rank's rows -> (b, ..., row...)."""
    nl = local.shape[0]
    all_ids = all_gather(mesh, gids_mine)
    rows, _ = _own_rows(local, all_ids, mesh.index("d"), nl)
    return psum_scatter(mesh, rows)


def _exchange_graph_rows(mesh, nbrs_l, degs_l, gids_mine):
    """(b,) global ids -> their (b, R) graph rows and (b,) degrees, from
    their owners in one exchange."""
    shard, nl = mesh.index("d"), nbrs_l.shape[0]
    all_ids = all_gather(mesh, gids_mine)
    rows, _ = _own_rows(nbrs_l, all_ids, shard, nl)
    deg, _ = _own_rows(degs_l, all_ids, shard, nl)
    out = psum_scatter(mesh, torch.cat([rows, deg[:, None]], 1))
    return out[:, :-1], out[:, -1]


def _scatter_owned(local, gids, rows, deg_local, new_deg, shard, nl):
    """Write the rows and degrees of the ids this rank owns, in place; the
    others drop (ids must be unique)."""
    lid = gids - shard * nl
    ok = (lid >= 0) & (lid < nl) & (gids >= 0)
    wt = lid[ok].long()
    local[wt] = rows[ok].to(local.dtype)
    deg_local[wt] = new_deg[ok].to(deg_local.dtype)
    return local, deg_local


# ---------------------------------------------------------------------------
# the sharded batched beam search over the global graph
# ---------------------------------------------------------------------------


def _global_beam(mesh, pts_l, nbrs_l, degs_l, q_mine, start_ids, self_ids, *,
                 metric, n_valid, nl, k, L, R, vmax, record_visited):
    """Beam search of this rank's (b, d) queries over the global graph ->
    (beam ids, beam dists, visited ids, visited dists). Each step's row
    fetch is the collective exchange; distances are computed where the
    vectors live."""
    b = q_mine.shape[0]
    dev = q_mine.device
    shard = mesh.index("d")
    q_all = all_gather(mesh, q_mine)
    B = q_all.shape[0]
    E = 1
    i32 = dict(dtype=torch.int32, device=dev)

    def fetch_cand(exp_ids_mine, valid_mine):
        """(b, E) expansion ids -> (b, E * R) global candidate ids, dists."""
        ids_all = all_gather(mesh, exp_ids_mine)
        rows, own = _own_rows(nbrs_l, ids_all, shard, nl)  # (B, E, R)
        rdeg, _ = _own_rows(degs_l, ids_all, shard, nl)  # (B, E)
        # replicate the candidate ids and the row's degree: only the row's
        # owner knows them and every vector owner needs them (+1 so absent
        # shares sum to 0); one all-reduce carries both
        rep = psum(mesh, torch.where(own[..., None], torch.cat([rows, rdeg[..., None]], -1) + 1,
                                     0)) - 1
        rows_m = rep[..., :R].reshape(B, E * R)
        # compute at the data: each rank scores the vectors it owns and the
        # reduce-scatter sums the disjoint shares into each rank's queries
        lid = rows_m - shard * nl
        vok = (lid >= 0) & (lid < nl) & (rows_m >= 0)
        d = gathered(q_all, pts_l[lid.long().clamp(0, nl - 1)], metric)
        d_m = psum_scatter(mesh, torch.where(vok, d, 0.0))
        cand_ids = rows_m[shard * b:(shard + 1) * b]
        deg_m = rep[..., R].reshape(B, E)[shard * b:(shard + 1) * b]
        slot = torch.arange(R, **i32).repeat(E)[None, :]
        v = (slot < deg_m.repeat_interleave(R, dim=1)) & (cand_ids >= 0)
        v &= cand_ids < n_valid
        v &= valid_mine.repeat_interleave(R, dim=1)
        if self_ids is not None:
            v &= cand_ids != self_ids[:, None]
        return cand_ids, torch.where(v, d_m, INF)

    # seed with the start point(s)
    s_ids = start_ids[None, :].expand(b, -1).contiguous()
    s_d = gathered(q_mine, _exchange_rows(mesh, pts_l, s_ids), metric)
    s_ok = (s_ids >= 0) & (s_ids < n_valid)
    beam_ids = (n_valid + 1 + torch.arange(L, **i32))[None, :].expand(b, L)
    beam_dists = torch.full((b, L), INF, device=dev)
    beam_exp = torch.zeros((b, L), **i32)
    beam_ids, beam_dists, beam_exp = _merge(
        beam_ids, beam_dists, beam_exp, torch.where(s_ok, s_ids, n_valid + 1),
        torch.where(s_ok, s_d, INF), L)
    num_visited = torch.zeros(b, **i32)
    done = ~(beam_dists < INF).any(1)
    sent_c = n_valid + 1 + torch.arange(E * R, **i32)[None, :]
    col = torch.arange(vmax if record_visited else 1, **i32)[None, :]
    vis_ids = torch.zeros((b, col.shape[1]), **i32)
    vis_d = torch.full((b, col.shape[1]), INF, device=dev)

    # a loop on an all-reduced done flag: every rank steps alike
    while any_rank(mesh, ~done):
        active = ~done
        unexp = (beam_exp == 0) & (beam_dists < INF)
        budget = torch.where(active, (vmax - num_visited).clamp(max=E), 0)
        cum = torch.cumsum(unexp.to(torch.int32), dim=1)
        newly = unexp & (cum <= budget[:, None])
        beam_exp = beam_exp + newly.to(torch.int32)
        n_new = newly.sum(1, dtype=torch.int32)
        pos = newly.to(torch.int32).argmax(1)[:, None]
        exp_ids = beam_ids.gather(1, pos)
        exp_d = beam_dists.gather(1, pos)
        valid_e = n_new[:, None] > 0
        cand_ids, cand_d = fetch_cand(torch.where(valid_e, exp_ids, 0), valid_e)
        cand_d = torch.where(cand_d >= beam_dists[:, L - 1:L], INF, cand_d)
        cand_ids = torch.where(cand_d < INF, cand_ids, sent_c)
        nb_i, nb_d, nb_e = _merge(beam_ids, beam_dists, beam_exp, cand_ids, cand_d, L)
        nv = num_visited + n_new
        new_done = done | ~_has_work(nb_d, nb_e, k, L, 1.35, metric)
        new_done |= nv >= vmax
        if record_visited:
            # the expansion joins the visited list at the query's count
            w = (col == num_visited[:, None]) & (valid_e & active[:, None])
            vis_ids = torch.where(w, exp_ids, vis_ids)
            vis_d = torch.where(w, exp_d, vis_d)
        sel = active[:, None]
        beam_ids = torch.where(sel, nb_i, beam_ids)
        beam_dists = torch.where(sel, nb_d, beam_dists)
        beam_exp = torch.where(sel, nb_e, beam_exp)
        num_visited = torch.where(active, nv, num_visited)
        done = new_done

    beam_ids = torch.where(beam_dists < INF, beam_ids, -1)
    return beam_ids, beam_dists, vis_ids, vis_d


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _prune_with_vecs(p_ids, cand_ids, cand_d, cand_vecs, alpha, R, metric, n_valid):
    """robustPrune over candidate vectors already at hand (they came
    through the exchange): the (dist, id) sort and dedup carry each
    candidate's column, which then orders the vectors. Rows with
    ``p_ids < 0`` (pad lanes) select nothing and are not pruned."""
    B = p_ids.shape[0]
    dev = p_ids.device
    sel_ids = torch.full((B, R), -1, dtype=torch.int32, device=dev)
    sel_dists = torch.full((B, R), INF, device=dev)
    live = torch.nonzero(p_ids >= 0)[:, 0]
    p, ci, cd, cv = p_ids, cand_ids, cand_d, cand_vecs
    if live.numel() < B:
        p, ci, cd, cv = p[live], ci[live], cd[live], cv[live]
    if live.numel():
        cd = torch.where(ci == p[:, None], INF, cd)
        cd = torch.where((ci >= 0) & (ci < n_valid), cd, INF)
        C = ci.shape[1]
        sent = n_valid + torch.arange(C, dtype=torch.int32, device=dev)[None, :]
        ids = torch.where(cd < INF, ci, sent)
        colidx = torch.arange(C, device=dev).expand(len(live), C)
        sid, sdist, scol = lexsort((ids, cd), colidx)
        dup = torch.cat([torch.zeros_like(sid[:, :1], dtype=torch.bool),
                         sid[:, 1:] == sid[:, :-1]], dim=1)
        sdist = torch.where(dup, INF, sdist)
        sdist, sid, scol = lexsort((sdist, sid), scol)
        svecs = cv.gather(1, scol[:, :, None].expand(-1, -1, cv.shape[2]))
        sel_ids[live], sel_dists[live] = _occlusion_loop(
            sid, sdist.contiguous(), svecs.contiguous(), alpha, R, metric)
    return PruneResult(sel_ids, sel_dists, (sel_ids >= 0).sum(1, dtype=torch.int32))


def _global_insert_step_body(mesh, pts_l, nbrs_l, degs_l, batch_mine, alpha, start_ids,
                             *, R, L, vmax, metric, n_valid, nl, prune_chunk):
    """One prefix-doubling batch, split over ``d``; ``nbrs_l`` and
    ``degs_l`` change in place."""
    shard, D = mesh.index("d"), mesh.shape["d"]
    dev = pts_l.device
    b = batch_mine.shape[0]
    safe = batch_mine.clamp(min=0)
    q_mine = _exchange_rows(mesh, pts_l, safe)

    # ---- read phase: the sharded beam search, visited list recorded ----
    _, _, vis_ids, vis_d = _global_beam(
        mesh, pts_l, nbrs_l, degs_l, q_mine, start_ids, batch_mine,
        metric=metric, n_valid=n_valid, nl=nl, k=0, L=L, R=R, vmax=vmax,
        record_visited=True)
    # the old out-edges join the candidates (index.h:70-76)
    old_row, odeg = _exchange_graph_rows(mesh, nbrs_l, degs_l, safe)
    old_ok = torch.arange(R, device=dev)[None, :] < odeg[:, None]
    old_vecs = _exchange_rows(mesh, pts_l, old_row.clamp(0, n_valid - 1).reshape(-1)
                              ).reshape(b, R, -1)
    old_d = gathered(q_mine, old_vecs, metric)
    old_d = torch.where(old_ok & (old_row >= 0), old_d, INF)
    cand_ids = torch.cat([vis_ids, old_row], 1)
    cand_d = torch.cat([vis_d, old_d], 1)

    # ---- forward robustPrune, each rank its queries ----
    cand_d = torch.where((cand_ids >= 0) & (cand_ids < n_valid), cand_d, INF)
    C = cand_ids.shape[1]
    cvecs = _exchange_rows(mesh, pts_l, cand_ids.clamp(0, n_valid - 1).reshape(-1)
                           ).reshape(b, C, -1)
    pr = _prune_with_vecs(batch_mine, cand_ids, cand_d, cvecs, alpha, R, metric, n_valid)
    del cvecs
    # every rank sees every forward row and writes the ones it owns
    fwd = all_gather(mesh, torch.cat([pr.ids, pr.degree[:, None],
                                      batch_mine[:, None]], 1))
    sel_all, deg_all, batch_all = fwd[:, :R], fwd[:, R], fwd[:, R + 1]
    seld_all = all_gather(mesh, pr.dists)
    _scatter_owned(nbrs_l, batch_all, sel_all, degs_l, deg_all, shard, nl)

    # ---- reverse edges: a replicated semisort, owner-masked writes ----
    M = batch_all.shape[0] * R
    tgt = sel_all.reshape(M)
    src = batch_all.repeat_interleave(R)
    dist = seld_all.reshape(M)
    valid = (tgt >= 0) & (src >= 0) & (dist < INF)
    sent = n_valid + D * nl  # beyond every shard
    tgt_key = torch.where(valid, tgt, sent).to(torch.int32)
    s_tgt, s_dist, s_src = lexsort((tgt_key, dist), src)
    s_valid = s_tgt < sent
    pos = torch.arange(M, dtype=torch.int32, device=dev)
    fo = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                    s_tgt[1:] != s_tgt[:-1]]) & s_valid
    left, right = segment_bounds(s_tgt)
    count = right - left
    lid_t = (s_tgt - shard * nl).long().clamp(0, nl - 1)
    own_t = (s_tgt - shard * nl >= 0) & (s_tgt - shard * nl < nl) & s_valid
    # degrees live on their owner: one all-reduce of owner-masked values
    old_deg_all = psum(mesh, torch.where(own_t, degs_l[lid_t], 0))
    overflow = (old_deg_all + count) > R

    # append: set-union for the group-first rows that stay within R and
    # that this rank owns (each row's union depends on that row only)
    cap = R
    jcol = torch.arange(cap, device=dev)[None, :]
    rows = torch.nonzero(fo & ~overflow & own_t)[:, 0]
    gpos = rows[:, None] + jcol
    g_src = s_src[gpos.clamp(max=M - 1)]
    g_ok = (jcol < count[rows].clamp(max=cap)[:, None]) & (gpos < M)
    lid = lid_t[rows]
    old_ok2 = torch.arange(R, device=dev)[None, :] < old_deg_all[rows][:, None]
    app_ids, app_deg = _union_rows(nbrs_l[lid], old_ok2, g_src, g_ok, n_valid, R)
    nbrs_l[lid] = app_ids
    degs_l[lid] = app_deg

    # overflow α-prune, dealt round-robin over the ranks: the list is
    # replicated, rank r takes entries r, r + D, r + 2D, ...; the chunk
    # count derives from the replicated total, so collectives stay aligned
    is_of = fo & overflow
    perm = lexsort((torch.where(is_of, 0, 1).to(torch.int32),), pos)[1]
    n_of = int(is_of.sum())
    n_mine_bound = -(-n_of // D)
    for off in range(0, n_mine_bound, prune_chunk):
        # the last chunk is as wide as the replicated bound needs
        width = min(prune_chunk, n_mine_bound - off)
        myk = off + torch.arange(width, dtype=torch.int32, device=dev)
        ppos = myk * D + shard
        pmask = ppos < n_of
        prows = perm[ppos.clamp(0, M - 1).long()].long()
        t = torch.where(pmask, s_tgt[prows], sent)
        g_idx = (prows[:, None] + jcol).clamp(0, M - 1)
        gs, gd = s_src[g_idx], s_dist[g_idx]
        gok = ((jcol < count[prows].clamp(max=cap)[:, None])
               & ((prows[:, None] + jcol) < M) & pmask[:, None])
        # the target's row and degree live on its owner
        t_c = t.clamp(0, n_valid - 1)
        o_row, o_deg = _exchange_graph_rows(mesh, nbrs_l, degs_l, t_c)
        o_deg = torch.where(pmask, o_deg, 0)
        ook = torch.arange(R, device=dev)[None, :] < o_deg[:, None]
        ci = torch.cat([o_row, gs], 1)
        # one exchange serves the target's vector, the old row's distances
        # and the prune's vectors (the old row is ci's first R columns)
        v = _exchange_rows(mesh, pts_l, torch.cat([t_c[:, None], ci], 1).clamp(0, n_valid - 1)
                           .reshape(-1)).reshape(width, ci.shape[1] + 1, -1)
        tv, cv = v[:, 0], v[:, 1:]
        od = gathered(tv, cv[:, :R], metric)
        od = torch.where(ook & (o_row >= 0), od, INF)
        cd = torch.cat([od, torch.where(gok, gd, INF)], 1)
        p_ids = torch.where(pmask, t, -1)
        prr = _prune_with_vecs(p_ids, ci, cd, cv, alpha, R, metric, n_valid)
        # the owners write back everyone's results (masked lanes are -1)
        res = all_gather(mesh, torch.cat([p_ids[:, None], prr.ids, prr.degree[:, None]], 1))
        _scatter_owned(nbrs_l, res[:, 0], res[:, 1:R + 1], degs_l, res[:, R + 1], shard, nl)
    return nbrs_l, degs_l


def build_global_vamana(
    data: np.ndarray,
    mesh: Mesh,
    bp: BuildParams,
    metric: Metric = Metric.L2,
    verbose: bool = False,
) -> GlobalIndex:
    """Build ONE Vamana graph over all rows, sharded over ``d``. Each rank
    passes the full host ``data``."""
    metric = Metric.coerce(metric)
    D = mesh.shape["d"]
    n = data.shape[0]
    pts, nl = shard_dataset(_storage(data), mesh)
    dev = mesh.device
    R, L = bp.R, bp.L
    vmax = max((3 * L) // 2, R + 16)
    nbrs = torch.zeros((nl, R), dtype=torch.int32, device=dev)
    degs = torch.zeros((nl,), dtype=torch.int32, device=dev)
    rng = np.random.default_rng(bp.seed)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)

    sched, max_batch = batch_schedule(n, n, bp.batch_cap_frac)
    for p in range(bp.num_passes):
        alpha = bp.alpha if p == bp.num_passes - 1 else 1.0
        order = rng.permutation(n).astype(np.int32)
        for bi, (lo, hi) in enumerate(sched):
            batch = _pad_pow2(order[lo:hi], max_batch)
            # round the width up so the batch splits evenly over d
            width = -(-len(batch) // D) * D
            batch = np.concatenate([batch, np.full(width - len(batch), -1, np.int32)])
            mine = torch.from_numpy(batch.reshape(D, width // D)[mesh.index("d")]
                                    .copy()).to(dev)
            nbrs, degs = _global_insert_step_body(
                mesh, pts, nbrs, degs, mine, alpha, start, R=R, L=L, vmax=vmax,
                metric=metric, n_valid=n, nl=nl,
                prune_chunk=min(width * R, PRUNE_CHUNK))
            if verbose and bi % 8 == 0:
                print(f"global pass {p}: batch {bi + 1}/{len(sched)}", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return GlobalIndex(mesh=mesh, points=pts, nbrs=nbrs, degs=degs, n=n,
                       rows_per_shard=nl, max_degree=R, metric=metric)


def global_search(idx: GlobalIndex, queries: np.ndarray, k: int = 10,
                  beam_size: int = 64):
    """Search the global sharded graph -> (ids (B, k), dists (B, k)) numpy
    on every rank. Queries split over ``d``; every hop rides the
    all-gather, compute-at-data, reduce-scatter exchange."""
    mesh = idx.mesh
    D = mesh.shape["d"]
    queries = np.asarray(queries)
    B0 = len(queries)
    b = -(-B0 // D)
    qpad = np.zeros((b * D, queries.shape[1]), dtype=queries.dtype)
    qpad[:B0] = queries
    s = mesh.index("d")
    q_mine = torch.from_numpy(qpad[s * b:(s + 1) * b]).to(mesh.device)
    L = max(beam_size, k)
    bi, bd, _, _ = _global_beam(
        mesh, idx.points, idx.nbrs, idx.degs, q_mine,
        torch.tensor([idx.start_point], dtype=torch.int32, device=mesh.device), None,
        metric=idx.metric, n_valid=idx.n, nl=idx.rows_per_shard, k=k, L=L,
        R=idx.max_degree, vmax=idx.n, record_visited=False)
    ids = all_gather(mesh, bi[:, :k].contiguous())
    dists = all_gather(mesh, bd[:, :k].contiguous())
    return ids[:B0].cpu().numpy(), dists[:B0].cpu().numpy()


def collective_volume_report(
    n: int, D: int, *, R: int, L: int, dim: int, batch: int,
    itemsize: int = 4, itemsize_vec: int | None = None,
    hops: int | None = None, overflow_targets: int | None = None,
    print_table: bool = True,
):
    """Static per-device collective volume estimate per max-width batch of
    the global build -> ({site: bytes}, worst-case total); prints the
    worst-case table and a typical-case total.

    Convention: ring-model per-device traffic, (D-1)/D of the full
    gathered array for an all-gather or reduce-scatter, 2(D-1)/D for an
    all-reduce. The overflow prune is dealt round-robin, so each device
    walks at most ceil(n_of/D) targets.

    ``itemsize_vec``: bytes per vector component on the wire (1 for q8
    builds); ``hops``: beam hops (default the vmax worst case; builds
    converge near L); ``overflow_targets``: overflow targets per device
    per batch (default the worst case ceil(min(M, n)/D); typically about
    batch/D)."""
    B = batch
    E = 1
    vmax = max((3 * L) // 2, R + 16)
    hops_wc = hops or vmax
    C = vmax + R  # forward-prune candidate width (visited + old row)
    M = B * R
    pchunk = min(M, PRUNE_CHUNK)
    of_wc = (overflow_targets if overflow_targets is not None
             else -(-min(M, n) // D))
    nchunks = max(1, -(-of_wc // pchunk))
    iv = itemsize_vec if itemsize_vec is not None else itemsize
    ag = (D - 1) / D  # ring all-gather / reduce-scatter factor
    ps = 2 * (D - 1) / D  # all-reduce = reduce-scatter + all-gather

    def make_sites(hops, nch):
        return [
            ("beam: all_gather exp ids      (B,E)", hops * ag * B * E * itemsize),
            ("beam: psum cand ids+deg   (B,E,R+1)", hops * ps * B * E * (R + 1) * itemsize),
            ("beam: psum_scatter dists    (B,E*R)", hops * ag * B * E * R * itemsize),
            ("fwd prune: all_gather ids     (B,C)", ag * B * C * itemsize),
            ("fwd prune: psum_scatter vecs (B,C,d)", ag * B * C * dim * iv),
            ("reverse: all_gather edges (B,R)x2  ", ag * B * R * 2 * itemsize),
            ("overflow: all_gather ids (D,ch,2R)", nch * ag * D * pchunk * (2 * R) * itemsize),
            ("overflow: psum_scatter vecs        ", nch * ag * D * pchunk * 2 * R * dim * iv),
            ("overflow: target row+deg+vec fetch ", nch * ag * D * pchunk * ((R + 1) * itemsize + dim * iv)),
            ("overflow: all_gather results (D,ch,R+2)", nch * ag * D * pchunk * (R + 2) * itemsize),
        ]

    sites = make_sites(hops_wc, nchunks)
    total = sum(v for _, v in sites)
    # typical case: converged hop count ~L+8, overflow targets ~B/D
    hops_ty = hops or min(vmax, L + 8)
    nch_ty = max(1, -(-(overflow_targets or -(-B // D)) // pchunk))
    total_ty = sum(v for _, v in make_sites(hops_ty, nch_ty))
    if print_table:
        print(f"per-device collective volume per max-width batch (B={B}, D={D}, "
              f"R={R}, L={L}, dim={dim}, vec itemsize={iv}, "
              f"hops<={hops_wc}, overflow/dev<={of_wc}):", flush=True)
        for name, v in sites:
            print(f"  {name}: {v/1e6:10.2f} MB", flush=True)
        print(f"  TOTAL (worst case): {total/1e6:.2f} MB/batch  "
              f"(~{total * (n // max(B, 1)) / 1e9:.2f} GB/pass)", flush=True)
        print(f"  TOTAL (typical: hops~{hops_ty}, overflow/dev~"
              f"{overflow_targets or -(-B // D)}): {total_ty/1e6:.2f} "
              f"MB/batch", flush=True)
    return dict(sites), total
