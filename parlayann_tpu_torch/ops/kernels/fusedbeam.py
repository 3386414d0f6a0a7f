"""Kernel 3: the fused beam search, its build mode, and a test launch of
the block-level bitonic networks (``csrc/bitonic.cuh``, device code of
kernel 5).

Counterpart of parlayann_tpu/ops/pallas/fusedbeam.py (``fused_step`` :627
as called from ``beam_search_fused`` :700 and ``build_beam_fused`` :952,
the Vamana build's fused read phase) at E = 1 with loop dedup, and of
ops/pallas/bitonic.py. ``build_beam_fused`` is the same walk at k = 0
recording each expansion's (id, beam distance). The CUDA kernel
(``csrc/fusedbeam.cu``) runs each query's whole search in one warp, its
beam in registers (L <= 128 and R <= 64; :func:`walk_info` says which walk
a shape takes) or in the warp's shared memory (up to ``MAX_WB`` lanes), on
a persistent grid whose warps take queries from a counter. So the TPU's
per-step launches, straggler ladder and inline-ext id byte planes have no
counterpart: ids come from ``graph.neighbors`` and vectors straight from
the int8 tier.

Beam entries are (dist, pack) pairs, pack = id * 2 + unexpanded bit, kept
sorted lexicographically; every INF entry carries the one pack
``2 * n_valid + 1``. That makes the merged order unique, so the kernel and
``beam_search_fused_plain`` agree exactly when distances do (always on int8
tiers with integer-valued queries), and it is the order of the JAX
package's ``beam_search_batch``.
"""

from __future__ import annotations

import ctypes

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import distance
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels import _lib
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.utils.arrays import pow2

# the widest beam the kernel takes: Wb = pow2(L) lanes, 8 bytes a lane of
# the warp's shared memory past 256 lanes
MAX_WB = 4096


def _tier_dist(queries, tier_data, ids, metric):
    """(B, d) f32 queries, (B, K) ids -> (B, K) distances to tier rows."""
    vecs = tier_data[ids.long().clamp(0, tier_data.shape[0] - 1)]
    return distance.gathered(queries, vecs, metric)


def _select_next(bd, bp, nv, *, k, L, cut, limit, use_cut):
    """Nearest workable lane -> (expand ids (B,), packs with its bit
    cleared); -1 where nothing is workable or the budget is spent."""
    Wb = bd.shape[1]
    lane = torch.arange(Wb, device=bd.device)[None, :]
    workable = ((bp & 1) == 1) & (bd < INF) & (lane < L)
    if use_cut:
        thr = torch.clamp(cut * bd[:, k:k + 1], max=INF)
        workable &= bd < thr
    first = workable.to(torch.int32).argmax(dim=1)
    ok = workable.any(dim=1) & (nv < limit)
    e = torch.where(ok, bp.gather(1, first[:, None])[:, 0] >> 1, -1)
    flip = (lane == first[:, None]) & ok[:, None]
    return e, bp - flip.to(bp.dtype)


def beam_search_fused_plain(queries, tier_data, nbrs, degs, starts, *,
                            metric: Metric, n_valid: int, k: int, L: int,
                            cut: float = 1.35, limit: int = 2**30, expanded=None,
                            expanded_dists=None):
    """The kernel's function in PyTorch, all queries in lock-step. A list
    given as ``expanded`` receives each step's expanded ids (B,), -1 for a
    query that has stopped; one given as ``expanded_dists`` their beam
    distances (B,), INF for a stopped query."""
    B = queries.shape[0]
    dev = queries.device
    R = nbrs.shape[1]
    Wb = pow2(max(L, 8))
    sent = 2 * n_valid + 1
    limit = min(limit, n_valid)
    use_cut = k > 0 and metric.is_metric and k < L
    cut = torch.tensor(cut, dtype=torch.float32, device=dev)
    if starts.dim() == 1:
        starts = starts[None, :].expand(B, -1)
    S = starts.shape[1]
    lane = torch.arange(Wb, device=dev)[None, :]

    # seed: valid starts, sorted, duplicate starts dropped, lanes >= L empty
    sv = (starts >= 0) & (starts < n_valid)
    sd = torch.where(sv, _tier_dist(queries, tier_data, starts, metric), INF)
    sp = torch.where(sv, starts * 2 + 1, sent).to(torch.int32)
    W0 = max(Wb, S)
    bd = torch.cat([sd, torch.full((B, W0 - S), INF, device=dev)], dim=1)
    bp = torch.cat([sp, torch.full((B, W0 - S), sent, dtype=torch.int32,
                                   device=dev)], dim=1)
    bd, bp = lexsort((bd, bp))
    first = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    dup = torch.cat([first, (bp[:, 1:] == bp[:, :-1]) & (bd[:, 1:] < INF)], dim=1)
    bd = torch.where(dup, INF, bd)
    bp = torch.where(dup, sent, bp)
    bd, bp = lexsort((bd, bp))
    bd = torch.where(lane < L, bd[:, :Wb], INF)
    bp = torch.where(lane < L, bp[:, :Wb], sent)

    nv = torch.zeros(B, dtype=torch.int32, device=dev)
    cmps = sv.sum(dim=1, dtype=torch.int32)
    sel = dict(k=k, L=L, cut=cut, limit=limit, use_cut=use_cut)
    e, bp = _select_next(bd, bp, nv, **sel)
    slot = torch.arange(R, device=dev)[None, :]
    while bool((e >= 0).any()):
        if expanded is not None:
            expanded.append(e)
        if expanded_dists is not None:
            # the expanded vertex's beam copy, read before the step merges
            expanded_dists.append(torch.where((bp >> 1) == e[:, None], bd, INF).amin(dim=1))
        active = e >= 0
        ec = e.clamp(min=0).long()
        cid = torch.where(slot < degs[ec][:, None], nbrs[ec], -1)
        cvalid = (cid >= 0) & (cid < n_valid) & active[:, None]
        cdist = _tier_dist(queries, tier_data, cid, metric)
        cmps = cmps + cvalid.sum(dim=1, dtype=torch.int32)
        keep = cvalid & (cdist < bd[:, L - 1:L])
        keep &= ~(cid[:, :, None] == (bp >> 1)[:, None, :]).any(dim=2)
        cd = torch.where(keep, cdist, INF)
        cp = torch.where(keep, cid * 2 + 1, sent).to(torch.int32)
        md, mp = lexsort((torch.cat([bd, cd], 1), torch.cat([bp, cp], 1)))
        nd = torch.where(lane < L, md[:, :Wb], INF)
        npk = torch.where(lane < L, mp[:, :Wb], sent)
        bd = torch.where(active[:, None], nd, bd)
        bp = torch.where(active[:, None], npk, bp)
        nv = nv + active.to(torch.int32)
        e_new, bp_new = _select_next(bd, bp, nv, **sel)
        e = torch.where(active, e_new, -1)
        bp = torch.where(active[:, None], bp_new, bp)
    ids = torch.where(bd[:, :L] < INF, bp[:, :L] >> 1, -1)
    return ids, bd[:, :L], nv, cmps


def build_beam_fused_plain(queries, tier_data, nbrs, degs, starts, *,
                           metric: Metric, n_valid: int, L: int, vmax: int):
    """:func:`build_beam_fused`'s function in PyTorch: the plain walk at
    k = 0 with a budget of ``vmax``, its expansions stacked."""
    B, dev = queries.shape[0], queries.device
    exp_ids, exp_d = [], []
    _, _, nv, cmps = beam_search_fused_plain(
        queries, tier_data, nbrs, degs, starts, metric=metric, n_valid=n_valid,
        k=0, L=L, limit=vmax, expanded=exp_ids, expanded_dists=exp_d)
    vis_ids = torch.full((B, vmax), -1, dtype=torch.int32, device=dev)
    vis_d = torch.full((B, vmax), INF, dtype=torch.float32, device=dev)
    if exp_ids:
        ids = torch.stack(exp_ids, dim=1).to(torch.int32)
        vis_ids[:, :ids.shape[1]] = ids
        vis_d[:, :ids.shape[1]] = torch.where(ids >= 0, torch.stack(exp_d, dim=1), INF)
    return vis_ids, vis_d, nv, cmps


def _launch(queries, tier_data, nbrs, degs, starts, *, metric, n_valid, k, L, cut,
            limit, vmax=None, counts=None):
    """Check the inputs and launch kernel 3 -> ((ids, dists, nv, cmps), the
    launch's return code, None if there were no queries to launch for);
    given ``vmax``, its build mode, whose ids and dists are the visited
    rows (the beam is left unwritten)."""
    _lib.require(queries, "queries", torch.float32, 2)
    _lib.require(tier_data, "tier_data", torch.int8, 2)
    _lib.require(nbrs, "nbrs", torch.int32, 2)
    _lib.require(degs, "degs", torch.int32, 1)
    B, d = queries.shape
    n_pad, R = nbrs.shape
    dev = queries.device
    if tier_data.shape != (n_pad, d) or degs.shape[0] != n_pad:
        raise ValueError(
            f"shape mismatch: queries {tuple(queries.shape)}, tier "
            f"{tuple(tier_data.shape)}, nbrs {tuple(nbrs.shape)}, degs "
            f"{tuple(degs.shape)}")
    if not 0 < n_valid <= n_pad < 2**30:
        raise ValueError(f"n_valid={n_valid}, n_pad={n_pad} out of range")
    Wb = pow2(max(L, 8))
    if Wb > MAX_WB:
        raise ValueError(f"beam L={L} exceeds the kernel's {MAX_WB} lanes")
    starts = starts.to(torch.int32).contiguous()
    if starts.dim() == 1:
        stride, S = 0, starts.shape[0]
    else:
        if starts.shape[0] != B:
            raise ValueError(f"starts {tuple(starts.shape)} for {B} queries")
        stride = S = starts.shape[1]
    if S > Wb:
        raise ValueError(f"{S} start vertices exceed the beam's {Wb} lanes")
    if counts is not None:
        _lib.require(counts, "counts", torch.int64, 1)
        if counts.numel() != 2 or counts.device != dev:
            raise ValueError("counts must hold 2 int64 on the inputs' device")
    limit = min(limit, n_valid)
    nv = torch.empty(B, dtype=torch.int32, device=dev)
    cmps = torch.empty(B, dtype=torch.int32, device=dev)
    if vmax is None:
        ids = torch.empty((B, L), dtype=torch.int32, device=dev)
        dists = torch.empty((B, L), dtype=torch.float32, device=dev)
        beam, vis, vstride = (ids, dists), (None, None), 0
    else:
        limit = min(limit, vmax)
        ids = torch.empty((B, vmax), dtype=torch.int32, device=dev)
        dists = torch.empty((B, vmax), dtype=torch.float32, device=dev)
        beam, vis, vstride = (None, None), (ids, dists), vmax
    if B == 0:
        return (ids, dists, nv, cmps), None
    fn = _lib.function(
        "pa_fused_beam",
        [_lib.VP] * 5 + [_lib.INT] * 10 + [_lib.FLOAT] + [_lib.INT] * 3
        + [_lib.VP] * 7 + [_lib.INT, _lib.VP, _lib.VP])
    use_cut = k > 0 and metric.is_metric and k < L
    # the persistent grid's query queue: the next query to take
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    ptr = [None if x is None else x.data_ptr() for x in (*beam, *vis)]
    rc = fn(queries.data_ptr(), tier_data.data_ptr(), nbrs.data_ptr(),
            degs.data_ptr(), starts.data_ptr(), stride, B, d, R, S, n_valid,
            k, L, Wb, pow2(R), cut, limit, int(use_cut),
            int(metric is Metric.MIPS), counter.data_ptr(), ptr[0], ptr[1],
            nv.data_ptr(), cmps.data_ptr(), ptr[2], ptr[3], vstride,
            None if counts is None else counts.data_ptr(), _lib.stream())
    return (ids, dists, nv, cmps), rc


def beam_search_fused(queries, tier_data, nbrs, degs, starts, *,
                      metric: Metric, n_valid: int, k: int, L: int,
                      cut: float = 1.35, limit: int = 2**30):
    """Beam search of B queries to convergence -> (ids (B, L) int32 with -1
    in empty slots, dists (B, L) f32 INF-padded, num_visited (B,),
    dist_cmps (B,)).

    ``queries`` (B, d) f32 are in the tier's domain; ``tier_data``
    (n_pad, d) is the int8 tier; ``nbrs``/``degs`` the graph; ``starts``
    (S,) or (B, S) start vertices. CPU tensors run
    :func:`beam_search_fused_plain`; CUDA tensors launch the kernel."""
    if not _lib.route(queries, tier_data, nbrs, degs, starts):
        return beam_search_fused_plain(
            queries, tier_data, nbrs, degs, starts, metric=metric,
            n_valid=n_valid, k=k, L=L, cut=cut, limit=limit)
    out, rc = _launch(queries, tier_data, nbrs, degs, starts, metric=metric,
                      n_valid=n_valid, k=k, L=L, cut=cut, limit=limit)
    if rc is not None:
        beam_search_fused.launches += 1
        _lib.check(rc, "beam_search_fused")
    return out


beam_search_fused.launches = 0


def build_beam_fused(queries, tier_data, nbrs, degs, starts, *,
                     metric: Metric, n_valid: int, L: int, vmax: int,
                     counts: torch.Tensor | None = None):
    """The Vamana build's insertion search (JAX fusedbeam.py:952): the walk
    at k = 0 (no cut) with a budget of min(vmax, n_valid) expansions ->
    (visited ids (B, vmax) int32 in expansion order, -1-padded; their beam
    distances (B, vmax) f32, INF-padded; num_visited (B,); dist_cmps (B,)).

    Inputs as :func:`beam_search_fused`'s. CPU tensors run
    :func:`build_beam_fused_plain`; CUDA tensors launch kernel 3's build
    mode, counted in ``build_beam_fused.launches``. ``counts``, an int64
    tensor of 2 on the card, gains the register walk's valid candidates
    (the step distances its ``dist_cmps`` count) and those among them
    whose tier row it did not read, having scored them earlier in the same
    walk (the shared-memory walk adds nothing; the plain version leaves it
    as it is)."""
    if not _lib.route(queries, tier_data, nbrs, degs, starts):
        return build_beam_fused_plain(
            queries, tier_data, nbrs, degs, starts, metric=metric,
            n_valid=n_valid, L=L, vmax=vmax)
    if vmax < 1:
        raise ValueError(f"vmax must be >= 1, got {vmax}")
    out, rc = _launch(queries, tier_data, nbrs, degs, starts, metric=metric,
                      n_valid=n_valid, k=0, L=L, cut=0.0, limit=vmax, vmax=vmax,
                      counts=counts)
    if rc is not None:
        build_beam_fused.launches += 1
        _lib.check(rc, "build_beam_fused")
    return out


build_beam_fused.launches = 0


def walk_info(d: int, L: int, R: int) -> dict:
    """The walk kernel 3 takes on the current card for rows of d int8
    values, beam L and R neighbours -> dict(walk="walk_regs<P,CP>" or
    "walk_smem", threads (a CTA), regs and local_bytes (a thread, from the
    runtime), resident_warps (an SM, at the launch's shared memory))."""
    fn = _lib.function("pa_fused_beam_info", [_lib.INT] * 3 + [_lib.VP])
    out = (ctypes.c_int * 6)()
    _lib.check(fn(d, pow2(max(L, 8)), pow2(R), ctypes.addressof(out)), "walk_info")
    P, CP, threads, regs, local, ctas = out
    return dict(walk=f"walk_regs<{P},{CP}>" if P else "walk_smem", threads=threads,
                regs=regs, local_bytes=local, resident_warps=ctas * threads // 32)


def bitonic_sort_rows(keys: torch.Tensor, vals: torch.Tensor):
    """Ascending (key, val) lexicographic sort of each row of W (a power of
    two) lanes: a test launch of the block-level bitonic network.
    CPU tensors run the plain stable lexsort."""
    if not _lib.route(keys, vals):
        return lexsort((keys, vals))
    _lib.require(keys, "keys", torch.float32, 2)
    _lib.require(vals, "vals", torch.int32, 2)
    rows, W = keys.shape
    if vals.shape != keys.shape or W & (W - 1) or W > 16384:
        raise ValueError(f"rows of a power-of-two width <= 16384 expected, got "
                         f"{tuple(keys.shape)} and {tuple(vals.shape)}")
    k, v = keys.clone(), vals.clone()
    fn = _lib.function("pa_bitonic_rows", [_lib.VP, _lib.VP, _lib.INT, _lib.INT, _lib.VP])
    _lib.check(fn(k.data_ptr(), v.data_ptr(), rows, W, _lib.stream()),
               "bitonic_sort_rows")
    return k, v
