"""The full-precision (f32) tier and the lock-step search, port vs JAX
package: kernel 1 on f32 inline rows, kernel 2 on f32 candidate vectors
(both through their CPU plain versions; the JAX kernels in interpret
mode), ``fused_search`` on the q8 tier at ``expand=2`` and
``degree_limit < R`` and on the f32 tier, the f32 Vamana build under L2
and MIPS, ``Index.batch_search`` with no quantized tier, and the
``build_inline_cache`` budget.

f32 sums run in another order in the two packages, so:
- distances agree to rtol 1e-5 (a negated dot, which can cancel to near
  zero, to 1e-5 of the largest magnitude);
- ids agree except where two distances tie within that tolerance;
- kernel 2's rounds agree on every row where no α-test of a star,
  ``alpha * d(star, c)`` against ``d(p, c)``, lies within a relative 1e-5
  of its threshold (the margin in float64); the excluded rows are counted;
- the builds are held to the parity bar for graph builds (ROADMAP): average
  degree within 0.5 and recall@10 at a fixed beam within 0.01, each
  package's searcher also run over the other package's graph.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import parlayann_tpu as jpt
from parlayann_tpu.types import Metric as JMetric
from parlayann_tpu.data.graph import GraphIndexData as JGraph
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.ops.pallas.expand import (
    build_inline as jbuild_inline, expand_distances as jexpand_distances)
from parlayann_tpu.ops.pallas.occlude import occlusion_rounds as joccl_rounds
from parlayann_tpu.search.fused import fused_search as jfused_search

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.expand import build_inline, expand_distances
from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
from parlayann_tpu_torch.search.fused import fused_search
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, BEAM, R_BUILD, L_BUILD = 10, 10, 16, 32
INF32 = np.float32(3.0e38)
METRICS = [(Metric.L2, JMetric.L2), (Metric.MIPS, JMetric.MIPS)]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_same_up_to_ties(ids, dists, want_ids, want_d, rtol=1e-5):
    """(B, k) results: distances within rtol; where the id lists differ,
    every id on one side only lies within rtol of the other side's k-th
    distance (a tie at the cut)."""
    ids, dists = np.asarray(ids), np.asarray(dists)
    want_ids, want_d = np.asarray(want_ids), np.asarray(want_d)
    ok = want_ids >= 0
    assert ((ids >= 0) == ok).all()
    tol = rtol * np.abs(want_d) + 1e-30
    assert (np.abs(dists - want_d)[ok] <= tol[ok]).all()
    for r in np.flatnonzero((ids != want_ids).any(axis=1)):
        last = ok[r].sum() - 1
        for a, ad, b, bd in ((ids, dists, want_ids, want_d), (want_ids, want_d, ids, dists)):
            only = ~np.isin(a[r], b[r])
            assert (np.abs(ad[r][only] - bd[r, last]) <= tol[r, last]).all(), r


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_torch_f32_expand_distances_matches_jax(rng, metric, jmetric):
    """Kernel 1 on f32 inline rows (R=20, padded to R8=24; d=24)."""
    n, d, R, B = 90, 24, 20, 40
    pts = rng.standard_normal((n, d)).astype(np.float32)
    nbrs = rng.integers(0, n, (n, R)).astype(np.int32)
    jinl = np.asarray(jbuild_inline(jnp.asarray(pts), jnp.asarray(nbrs)))
    tinl = build_inline(t(pts), t(nbrs))
    assert tinl.shape == (n, 24, d) and tinl.dtype == torch.float32
    np.testing.assert_array_equal(tinl.numpy(), jinl)
    ids = rng.integers(0, n, B).astype(np.int32)  # the JAX kernel takes valid ids
    q = rng.standard_normal((B, d)).astype(np.float32)
    want = np.asarray(jexpand_distances(jnp.asarray(jinl), jnp.asarray(ids),
                                        jnp.asarray(q), metric=jmetric))
    got = expand_distances(tinl, t(ids), t(q), metric=metric).numpy()
    atol = 0.0 if metric is Metric.L2 else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


def near_threshold_rows(dist, vecs, rounds, alpha, R, metric, rel=1e-5):
    """Rows where an α-test of one of the reference's stars against a later
    valid candidate lies within ``rel`` of its threshold, in float64."""
    v = vecs.astype(np.float64)
    dot = np.einsum("bid,bjd->bij", v, v)
    if metric is Metric.MIPS:
        pair = -dot
    else:
        nrm = np.einsum("bid,bid->bi", v, v)
        pair = nrm[:, :, None] - 2.0 * dot + nrm[:, None, :]
    lhs = np.float64(np.float32(alpha)) * pair
    thr = dist.astype(np.float64)[:, None, :]
    C = dist.shape[1]
    star = (rounds < R)[:, :, None]
    later = np.arange(C)[None, :, None] < np.arange(C)[None, None, :]
    valid = (dist < INF32)[:, None, :]
    near = np.abs(lhs - thr) <= rel * np.maximum(np.abs(thr), np.abs(lhs))
    return (near & star & later & valid).any(axis=(1, 2))


@pytest.mark.parametrize("metric,jmetric", METRICS)
@pytest.mark.parametrize("C,R", [(40, 16), (64, 32)])
def test_torch_f32_occlusion_rounds_matches_jax(rng, C, R, metric, jmetric):
    """Kernel 2 on f32 candidate vectors: the rounds equal the JAX kernel's
    on every row without a near-threshold α-test."""
    B, d, alpha = 48, 24, 1.2
    p = rng.standard_normal((B, 1, d))
    vecs = rng.standard_normal((B, C, d))
    dist = ((vecs - p) ** 2).sum(-1) if metric is Metric.L2 else -(vecs * p).sum(-1)
    tail = np.arange(C)[None, :] >= C - rng.integers(0, C // 3, (B, 1))
    dist = np.where(tail, INF32, dist.astype(np.float32))
    order = np.argsort(dist, axis=1, kind="stable")
    dist = np.take_along_axis(dist, order, 1)
    vecs = np.take_along_axis(vecs, order[:, :, None], 1).astype(np.float32)
    want = np.asarray(joccl_rounds(jnp.asarray(dist), jnp.asarray(vecs), alpha,
                                   R=R, metric=jmetric))
    got = occlusion_rounds(t(dist), t(vecs), alpha, R=R, metric=metric).numpy()
    excl = near_threshold_rows(dist, vecs, want, alpha, R, metric)
    print(f"C={C} R={R} {metric.name}: {int(excl.sum())} of {B} rows excluded")
    assert excl.sum() <= B // 8
    np.testing.assert_array_equal(got[~excl], want[~excl])
    assert (want[~excl] < R).sum(axis=1).min() >= 2  # rows with several stars


@pytest.fixture(scope="module", params=METRICS, ids=["l2", "mips"])
def built(request):
    """Both packages' f32 builds of one set; exact ground truth over the
    points as the PointSet holds them (normalized under MIPS)."""
    metric, jmetric = request.param
    X, Q = synthetic.clustered(1500, 32, n_queries=64, n_clusters=24,
                               cluster_std=0.35, seed=3)
    kw = dict(R=R_BUILD, L=L_BUILD, alpha=1.2, quantize_build=False)
    jg, jps, jstats = jpt.build_vamana_index(X, metric=jmetric, **kw)
    tg, tps, stats = pt.build_vamana_index(X, metric=metric, device="cpu", **kw)
    base = tps.data[:tps.n].numpy().astype(np.float64)
    q64 = Q.astype(np.float64)
    if metric is Metric.MIPS:
        d64 = -(q64 @ base.T)
    else:
        d64 = ((q64[:, None, :] - base[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :2 * K]
    return dict(metric=metric, X=X, Q=Q, gt=gt, gt_d=np.take_along_axis(d64, gt, 1),
                jg=jg, jps=jps, tg=tg, tps=tps, jstats=jstats, stats=stats)


def _recall(ids, b):
    return compute_recall(np.asarray(ids), b["gt"], b["gt_d"], K)


def _graphs(b):
    """-> (the port's graph in JAX, the JAX graph in the port)."""
    tg, jg = b["tg"], b["jg"]
    tg_in_jax = JGraph.from_numpy(tg.neighbors.numpy(), tg.degrees.numpy(), n=tg.n)
    jg_in_torch = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                           jg.n, jg.max_degree, device="cpu")
    return tg_in_jax, jg_in_torch


def test_torch_f32_build_matches_jax(built):
    """The f32 build at n=1500 under the graph-build parity bar: average degree within
    0.5, f32-tier recall@10 at beam 10 within 0.01 of the JAX package's, on
    each package's graph and across."""
    b = built
    j_avg, _ = b["jg"].stats()
    t_avg, t_max = b["tg"].stats()
    assert b["tps"].data.dtype == torch.float32 and t_max <= R_BUILD
    assert abs(j_avg - t_avg) <= 0.5, (j_avg, t_avg)
    tg_in_jax, jg_in_torch = _graphs(b)

    def jax_search(graph):
        return jpt.Index(points=b["jps"], graph=graph).batch_search(
            b["Q"], k=K, beam_size=BEAM)[0]

    def torch_search(graph):
        ids, dists, res = pt.Index(points=b["tps"], graph=graph).batch_search(
            b["Q"], k=K, beam_size=BEAM)
        assert ids.shape == (len(b["Q"]), K) and bool(torch.isfinite(dists).all())
        assert int(res.n_truncated) == 0
        return ids.numpy()

    ref = _recall(jax_search(b["jg"]), b)
    recalls = {"torch/torch": _recall(torch_search(b["tg"]), b),
               "torch/jax-graph": _recall(torch_search(jg_in_torch), b),
               "jax/torch-graph": _recall(jax_search(tg_in_jax), b)}
    print(f"{b['metric'].name}: degree avg jax {j_avg:.3f} torch {t_avg:.3f}; "
          f"recall@{K} beam {BEAM}: jax/jax {ref:.4f}", recalls)
    for name, r in recalls.items():
        assert abs(r - ref) <= 0.01, (name, r, ref)


@pytest.mark.parametrize("tier", ["f32", "q8_unfused"])
def test_torch_f32_index_search_matches_jax(built, tier):
    """Index.batch_search on the JAX graph and Index carried across by
    interop (``use_inline`` and ``use_fused`` included): with no quantized
    tier, and on the q8 tier with ``use_fused=False`` (the lock-step search
    at expand=1). The same ids except ties, the same visits and distance
    counts."""
    b = built
    _, jg_in_torch = _graphs(b)
    jidx = jpt.Index(points=b["jps"], graph=b["jg"])
    if tier == "q8_unfused":
        jidx.use_fused = False
        jidx.enable_quantized(bits=8)
    j_ids, j_d, j_res = jidx.batch_search(b["Q"], k=K, beam_size=BEAM)
    jps = b["jps"]
    idx = interop.index_from_state(
        interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, jps.metric,
                                    device="cpu"),
        jg_in_torch, use_inline=jidx.use_inline, use_fused=jidx.use_fused)
    assert idx.qpoints is None and idx.use_fused == (tier == "f32")
    if tier == "q8_unfused":
        idx.enable_quantized(bits=8)
    ids, dists, res = idx.batch_search(b["Q"], k=K, beam_size=BEAM)
    assert_same_up_to_ties(ids, dists, j_ids, j_d)
    np.testing.assert_array_equal(res.num_visited.numpy(), np.asarray(j_res.num_visited))
    np.testing.assert_array_equal(res.dist_cmps.numpy(), np.asarray(j_res.dist_cmps))


@pytest.mark.parametrize("case", ["q8_expand2", "q8_degree_limit", "f32"])
def test_torch_f32_fused_search_matches_jax(built, case):
    """search/fused.py against the JAX fused_search on one graph, B=64 (one
    phase): (a) the q8 tier over its int8 inline rows at expand=2 and at
    degree_limit=R//2, both reranked; (b) the f32 tier over f32 inline rows,
    no rerank. ids equal except ties, distances within rtol 1e-5, visits
    and distance counts equal."""
    b = built
    jps, tps, jg = b["jps"], b["tps"], b["jg"]
    _, g = _graphs(b)
    expand, dl = {"q8_expand2": (2, R_BUILD), "q8_degree_limit": (1, R_BUILD // 2),
                  "f32": (1, R_BUILD)}[case]
    if case == "f32":
        jtier, ttier = jps, tps
    else:
        jtier = jquantize.quantize_pointset(jps, bits=8)
        ttier = quantize.quantize_pointset(tps, bits=8)
    q = b["Q"]
    jinl = jbuild_inline(jtier.data, jg.neighbors)
    start = np.zeros((1,), np.int32)
    common = dict(k=K, L=BEAM, cut=1.35, limit=jps.n, degree_limit=dl, expand=expand,
                  rerank_pool=K * 10, do_rerank=case != "f32")
    want = jfused_search(
        jnp.asarray(q), jtier.data, jps.data, jg.neighbors, jg.degrees, jnp.asarray(start),
        jinl, jtier.quant_slope, jtier.quant_offset, metric=jtier.metric, n_valid=jtier.n,
        tier_bits=jtier.bits, **common)
    got = fused_search(t(q), ttier, tps.data, g.neighbors, g.degrees, t(start),
                       build_inline(ttier.data, g.neighbors), **common)
    assert got.ids.shape == (len(q), K) and int(got.n_truncated) == 0
    assert_same_up_to_ties(got.ids, got.dists, want.ids, want.dists)
    np.testing.assert_array_equal(got.num_visited.numpy(), np.asarray(want.num_visited))
    np.testing.assert_array_equal(got.dist_cmps.numpy(), np.asarray(want.dist_cmps))


def test_torch_f32_inline_cache_budget_and_source(built):
    """build_inline_cache: past its byte budget it turns use_inline off and
    the search gathers rows, with the same ids; a q8 tier enabled after an
    f32 search rebuilds the cache in int8 for the lock-step q8 search."""
    b = built
    idx = pt.Index(points=b["tps"], graph=b["tg"])
    ids, dists, _ = idx.batch_search(b["Q"], k=K, beam_size=BEAM)
    assert idx.inline is not None and idx.inline.dtype == torch.float32
    small = pt.Index(points=b["tps"], graph=b["tg"])
    assert small.build_inline_cache(hbm_budget_bytes=1024) is None
    assert small.use_inline is False and small.inline is None
    g_ids, g_d, _ = small.batch_search(b["Q"], k=K, beam_size=BEAM)
    assert small.inline is None
    assert_same_up_to_ties(g_ids, g_d, ids, dists)
    idx.enable_quantized(bits=8)
    q_ids, _, _ = idx.batch_search(b["Q"], k=K, beam_size=BEAM, expand=2)
    assert idx.inline.dtype == torch.int8 and idx._inline_src is idx.qpoints
    fresh = pt.Index(points=b["tps"], graph=b["tg"]).enable_quantized(bits=8)
    assert torch.equal(q_ids, fresh.batch_search(b["Q"], k=K, beam_size=BEAM, expand=2)[0])


def test_torch_f32_uint8_build_equals_jax_row_for_row():
    """uint8 points with ``quantize_build=False``: the JAX package builds on
    them as they are, the port on an exact float32 copy (kernel 2's f32
    mode); every distance is an integer below 2^24, exact in both, so the
    graphs are equal row for row. A row that differs must hold the same
    multiset of distances to its point (a tie; none on this data). The
    returned PointSet stays uint8 in both."""
    X, _ = synthetic.clustered(1500, 32, n_queries=8, n_clusters=24, cluster_std=0.35, seed=3)
    U = np.round((X - X.min()) / (X.max() - X.min()) * 255).astype(np.uint8)
    kw = dict(R=R_BUILD, L=L_BUILD, alpha=1.2, quantize_build=False)
    jg, jps, _ = jpt.build_vamana_index(U, **kw)
    tg, tps, _ = pt.build_vamana_index(U, device="cpu", **kw)
    assert tps.data.dtype == torch.uint8 and np.asarray(jps.data).dtype == np.uint8

    def rows(nbrs, degs):
        nbrs, degs = np.array(nbrs)[:len(U)], np.asarray(degs)[:len(U)]
        nbrs[np.arange(nbrs.shape[1])[None, :] >= degs[:, None]] = -1
        return nbrs, degs

    (tn, td), (jn, jd) = rows(tg.neighbors.numpy(), tg.degrees.numpy()), rows(
        jg.neighbors, jg.degrees)
    u = U.astype(np.int64)
    differ = np.flatnonzero((tn != jn).any(axis=1) | (td != jd))
    for r in differ:
        def dists(row):
            return np.sort(((u[row[row >= 0]] - u[r]) ** 2).sum(1))
        np.testing.assert_array_equal(dists(tn[r]), dists(jn[r]))
    assert len(differ) == 0, f"{len(differ)} rows differ (all distance ties)"
