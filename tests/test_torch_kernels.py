"""The port's kernel modules (through their CPU plain versions) and the
search/prune layers above them, against the JAX package. On the CPU the
JAX side reaches its Pallas kernels in interpret mode, as the package's own
tests run them. The CUDA kernels themselves are held to these plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu.types import Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.ops.pallas.expand import (
    build_inline as jbuild_inline, expand_distances as jexpand_distances)
from parlayann_tpu.ops.pallas.occlude import occlusion_rounds as joccl_rounds
from parlayann_tpu.ops.pallas.fusedbeam import (
    build_inline_ext as jbuild_inline_ext, beam_search_fused as jbeam_fused)
from parlayann_tpu.build import prune as jprune
from parlayann_tpu.search.beam import beam_search_batch as jbeam_batch
from parlayann_tpu.search.rerank import rerank_topk as jrerank

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.expand import build_inline, expand_distances
from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds, pairwise
from parlayann_tpu_torch.ops.kernels.fusedbeam import (
    beam_search_fused, bitonic_sort_rows)
from parlayann_tpu_torch.build import prune
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.search.rerank import rerank_topk
from parlayann_tpu_torch.search.exact import exact_knn

torch.set_num_threads(1)
BIG = 1e37
METRICS = [(Metric.L2, JMetric.L2), (Metric.MIPS, JMetric.MIPS)]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def q8_points(rng, n, d, metric="l2"):
    """The same q8 tier in both packages (bit-equal, test_torch_ops)."""
    X = rng.standard_normal((n, d)).astype(np.float32)
    jps = jquantize.quantize_pointset(JPointSet.from_numpy(X, metric=metric), bits=8)
    tps = quantize.quantize_pointset(
        PointSet.from_numpy(X, metric=metric, device="cpu"), bits=8)
    return X, jps, tps


def random_graph(rng, n, R, min_deg=4):
    """Duplicate-free rows (the fused kernel's row contract)."""
    nbrs = np.stack([rng.choice(n, R, replace=False) for _ in range(n)])
    degs = rng.integers(min_deg, R + 1, n)
    return nbrs.astype(np.int32), degs.astype(np.int32)


def prune_rows(rng, B, C, d):
    """Candidate rows as robustPrune sees them: exact distances to a point,
    ascending, with an INF tail."""
    p = rng.integers(-128, 128, (B, 1, d))
    vecs = rng.integers(-128, 128, (B, C, d))
    dist = ((vecs - p) ** 2).sum(-1).astype(np.float32)
    bad = np.arange(C)[None, :] >= C - rng.integers(0, C // 3, (B, 1))
    dist = np.where(bad, np.float32(3.0e38), dist)
    order = np.argsort(dist, axis=1, kind="stable")
    dist = np.take_along_axis(dist, order, 1)
    vecs = np.take_along_axis(vecs, order[:, :, None], 1).astype(np.int8)
    return dist, vecs


@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_torch_expand_distances_matches_jax(rng, metric, jmetric):
    """int8 inline rows: integer-valued queries give equal distances (exact
    integers). f32 queries sum in another order: L2 sums agree to rtol 1e-5;
    a negated dot can cancel to near zero, so its error is bounded by 1e-5
    of the largest magnitude instead."""
    n, d, R, B = 120, 32, 12, 24
    pts = rng.integers(-128, 128, (n, d)).astype(np.int8)
    nbrs = rng.integers(0, n, (n, R)).astype(np.int32)
    jinl = np.asarray(jbuild_inline(jnp.asarray(pts), jnp.asarray(nbrs)))
    tinl = build_inline(t(pts), t(nbrs))
    np.testing.assert_array_equal(tinl.numpy(), jinl)
    ids = rng.integers(0, n, B).astype(np.int32)
    q_int = rng.integers(-128, 128, (B, d)).astype(np.float32)
    q_f32 = (rng.standard_normal((B, d)) * 40).astype(np.float32)
    for q, exact in ((q_int, True), (q_f32, False)):
        want = np.asarray(jexpand_distances(jnp.asarray(jinl), jnp.asarray(ids),
                                            jnp.asarray(q), metric=jmetric))
        got = expand_distances(tinl, t(ids), t(q), metric=metric).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            atol = 0.0 if metric is Metric.L2 else 1e-5 * np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("C,R", [(24, 8), (40, 16)])
def test_torch_occlusion_rounds_matches_jax(rng, C, R):
    """int8 candidates: rounds and the recovered selections are equal."""
    B, d, alpha = 16, 32, 1.2
    dist, vecs = prune_rows(rng, B, C, d)
    want = np.asarray(joccl_rounds(jnp.asarray(dist), jnp.asarray(vecs), alpha,
                                   R=R, metric=JMetric.L2))
    got = occlusion_rounds(t(dist), t(vecs), alpha, R=R, metric=Metric.L2)
    np.testing.assert_array_equal(got.numpy(), want)
    ids = rng.permutation(1000)[:B * C].reshape(B, C).astype(np.int32)
    j_ids, j_d = jprune._occlusion_loop(jnp.asarray(ids), jnp.asarray(dist),
                                        jnp.asarray(vecs), alpha, R, JMetric.L2)
    x_ids, x_d = jprune._occlusion_loop_xla(
        jnp.asarray(ids), jnp.asarray(dist), jnp.asarray(vecs), alpha, R, JMetric.L2)
    s_ids, s_d = prune._occlusion_loop(t(ids), t(dist), t(vecs), alpha, R, Metric.L2)
    for want_ids, want_d in ((j_ids, j_d), (x_ids, x_d)):
        np.testing.assert_array_equal(s_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(s_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("alpha", [1.2, 1.0], ids=["alpha1.2", "alpha1_ties"])
@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_torch_occlusion_rounds_metrics_and_ties_match_jax(rng, metric, jmetric, alpha):
    """Both metrics, and alpha = 1 on small integer vectors, where many
    d(star, c) equal d(p, c) exactly and the test's <= decides: the port's
    rounds equal the JAX kernel's (interpret mode)."""
    B, C, d, R = 12, 40, 16, 12
    lim = 3 if alpha == 1.0 else 128
    p = rng.integers(-lim, lim, (B, 1, d))
    vecs = rng.integers(-lim, lim, (B, C, d))
    dist = ((vecs - p) ** 2).sum(-1) if metric is Metric.L2 else -(vecs * p).sum(-1)
    dist = np.where(np.arange(C)[None, :] >= C - rng.integers(0, C // 3, (B, 1)),
                    np.float32(3.0e38), dist.astype(np.float32))
    order = np.argsort(dist, axis=1, kind="stable")
    dist = np.take_along_axis(dist, order, 1)
    vecs = np.take_along_axis(vecs, order[:, :, None], 1).astype(np.int8)
    if alpha == 1.0:
        pair = pairwise(t(vecs), metric).numpy()
        ties = np.triu(pair == dist[:, None, :], 1) & (dist[:, None, :] < BIG)
        assert ties.sum() >= B, ties.sum()
    want = np.asarray(joccl_rounds(jnp.asarray(dist), jnp.asarray(vecs), alpha,
                                   R=R, metric=jmetric))
    got = occlusion_rounds(t(dist), t(vecs), alpha, R=R, metric=metric)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [128, 258])
def test_torch_occlusion_strip_arithmetic_is_exact(rng, d):
    """The CUDA kernel's strip entry, n_i + n_j - 2 dot in int32 (tensor-core
    dot products, then the epilogue), equals sum((a - b)^2) and the plain
    version's pairwise() exactly on extreme int8 rows: all -128 against all
    127 is the largest distance, 65025 d, below 2^24 at d = 258, so its f32
    rounding is exact. MIPS's -dot equals pairwise() too."""
    rows = np.stack([np.full(d, -128), np.full(d, 127), np.full(d, -128),
                     np.zeros(d), rng.integers(-128, 128, d)]).astype(np.int8)
    v = rows.astype(np.int32)
    dot = v @ v.T
    n = (v * v).sum(1, dtype=np.int32)
    strip = n[:, None] + n[None, :] - np.int32(2) * dot
    assert strip.dtype == np.int32
    direct = ((v[:, None, :] - v[None, :, :]) ** 2).sum(-1)
    np.testing.assert_array_equal(strip, direct)
    assert strip.max() == 65025 * d < 2 ** 24
    f32 = strip.astype(np.float32)
    np.testing.assert_array_equal(f32.astype(np.int64), strip)
    cand = torch.from_numpy(rows)[None]
    np.testing.assert_array_equal(pairwise(cand, Metric.L2)[0].numpy(), f32)
    np.testing.assert_array_equal(pairwise(cand, Metric.MIPS)[0].numpy(),
                                  (-dot).astype(np.float32))


def test_torch_robust_prune_matches_jax(rng):
    """Self, duplicates and out-of-range ids in the candidate lists."""
    n, d, B, C, R = 200, 32, 12, 30, 8
    X, jps, tps = q8_points(rng, n, d)
    p_ids = rng.integers(0, n, B).astype(np.int32)
    p_ids[-1] = -1  # inactive row
    cand = rng.integers(0, n + 5, (B, C)).astype(np.int32)
    cand[:, 0] = p_ids
    cand[:, 1] = cand[:, 2]
    pts = np.asarray(jps.data).astype(np.float32)
    dist = ((pts[np.clip(cand, 0, n - 1)] - pts[np.clip(p_ids, 0, n - 1)][:, None]) ** 2
            ).sum(-1).astype(np.float32)
    want = jprune.robust_prune_batch(
        jnp.asarray(p_ids), jnp.asarray(cand), jnp.asarray(dist), jps.data, 1.2,
        R=R, metric=JMetric.L2, n_valid=n)
    got = prune.robust_prune_chunked(
        t(p_ids), t(cand), t(dist), tps.data, 1.2, R=R, metric=Metric.L2,
        n_valid=n, chunk=5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("expand", [1, 2])
def test_torch_beam_search_batch_visited_matches_jax(rng, expand):
    """The build's read phase on int8 data: visited lists (ids and
    distances, in expansion order), beams, visit and distance counts are
    equal — through the gather path and through kernel 1's inline path."""
    n, d, R, B, L, vmax = 300, 32, 12, 16, 16, 24
    X, jps, tps = q8_points(rng, n, d)
    nbrs, degs = random_graph(rng, n, R)
    self_ids = rng.choice(n, B, replace=False).astype(np.int32)
    queries = np.asarray(jps.data)[self_ids]
    starts = np.zeros(1, np.int32)
    kw = dict(n_valid=n, k=0, L=L, limit=vmax, expand=expand,
              record_visited=True, exclude_self=True)
    want = jbeam_batch(jnp.asarray(queries), jps.data, jnp.asarray(nbrs),
                       jnp.asarray(degs), jnp.asarray(starts),
                       jnp.asarray(self_ids), metric=JMetric.L2,
                       use_inline=False, **kw)
    inline = build_inline(tps.data, t(nbrs))
    for inl in (None, inline):
        got = beam_search_batch(t(queries), tps.data, t(nbrs), t(degs), t(starts),
                                t(self_ids), inl, metric=Metric.L2, **kw)
        ok = np.asarray(want.visited_dists) < BIG
        np.testing.assert_array_equal(got.visited_dists.numpy() < BIG, ok)
        np.testing.assert_array_equal(
            np.where(ok, got.visited_ids.numpy(), -1),
            np.where(ok, np.asarray(want.visited_ids), -1))
        np.testing.assert_array_equal(got.visited_dists.numpy(),
                                      np.asarray(want.visited_dists))
        for name in ("beam_ids", "beam_dists", "num_visited", "dist_cmps"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)), name)


def _fused_case(rng, n=400, d=128, R=16, B=32, metric="l2"):
    X, jps, tps = q8_points(rng, n, d, metric)
    nbrs, degs = random_graph(rng, n, R)
    Qf = rng.standard_normal((B, d)).astype(np.float32)
    q_t = np.asarray(jquantize.translate_query(jnp.asarray(Qf), jps)).astype(np.float32)
    return jps, tps, nbrs, degs, q_t


def _same_valid_sets(ids_a, d_a, ids_b, d_b):
    np.testing.assert_allclose(np.where(d_a > BIG, 0, d_a),
                               np.where(d_b > BIG, 0, d_b), rtol=1e-5)
    for b in range(ids_a.shape[0]):
        sa = sorted((d_a[b, i], ids_a[b, i]) for i in range(ids_a.shape[1]) if d_a[b, i] < BIG)
        sb = sorted((d_b[b, i], ids_b[b, i]) for i in range(ids_b.shape[1]) if d_b[b, i] < BIG)
        assert sa == sb, b


@pytest.mark.parametrize("R", [16, 32])
@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_torch_beam_search_fused_matches_jax(rng, metric, jmetric, R):
    """The bar of tests/test_fusedbeam.py:68-121: against the JAX fused
    kernel, valid (dist, id) sets equal, dists rtol 1e-5, nv and cmps
    equal; against the JAX beam_search_batch (the same tie order), equal."""
    L, k = 12, 10
    jps, tps, nbrs, degs, q_t = _fused_case(rng, R=R, metric=metric.value)
    n = tps.n
    starts = np.zeros(1, np.int32)
    fid, fdist, fnv, fcmps, n_left = jbeam_fused(
        jnp.asarray(q_t), jps.data,
        jbuild_inline_ext(jps.data, jnp.asarray(nbrs), jnp.asarray(degs)),
        jnp.asarray(starts), metric=jmetric, n_valid=n, k=k, L=L, G=8, block_b=32)
    assert int(n_left) == 0
    ids, dists, nv, cmps = beam_search_fused(
        t(q_t), tps.data, t(nbrs), t(degs), t(starts), metric=metric,
        n_valid=n, k=k, L=L)
    _same_valid_sets(ids.numpy(), dists.numpy(), np.asarray(fid), np.asarray(fdist))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(fnv))
    np.testing.assert_array_equal(cmps.numpy(), np.asarray(fcmps))
    ref = jbeam_batch(jnp.asarray(q_t), jps.data, jnp.asarray(nbrs),
                      jnp.asarray(degs), jnp.asarray(starts), metric=jmetric,
                      n_valid=n, k=k, L=L, use_inline=False)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref.beam_ids))
    np.testing.assert_array_equal(dists.numpy(), np.asarray(ref.beam_dists))


@pytest.mark.parametrize("limit,starts", [(3, [0]), (2**30, [7, 3, 7, -1, 402])],
                         ids=["limit3", "shared_starts"])
@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_torch_beam_search_fused_limit_and_starts_match_jax(rng, metric, jmetric,
                                                            limit, starts):
    """A visit budget of 3, and 1-D starts shared by every query with a
    repeat, -1 and an id >= n_valid: ids, dists, nv and cmps equal the JAX
    beam_search_batch (use_inline=False)."""
    L, k = 16, 10
    jps, tps, nbrs, degs, q_t = _fused_case(rng, B=16, metric=metric.value)
    n = tps.n
    st = np.asarray(starts, np.int32)
    kw = dict(n_valid=n, k=k, L=L, limit=limit)
    ids, dists, nv, cmps = beam_search_fused(
        t(q_t), tps.data, t(nbrs), t(degs), t(st), metric=metric, **kw)
    ref = jbeam_batch(jnp.asarray(q_t), jps.data, jnp.asarray(nbrs),
                      jnp.asarray(degs), jnp.asarray(st), metric=jmetric,
                      use_inline=False, **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref.beam_ids))
    np.testing.assert_array_equal(dists.numpy(), np.asarray(ref.beam_dists))
    np.testing.assert_array_equal(nv.numpy(), np.asarray(ref.num_visited))
    np.testing.assert_array_equal(cmps.numpy(), np.asarray(ref.dist_cmps))
    assert int(nv.max()) <= limit


def test_torch_beam_search_fused_multi_start(rng):
    """Per-query start rows with a repeated and an invalid start match the
    port's beam_search_batch (which the JAX package's merges mirror)."""
    L, k = 16, 10
    jps, tps, nbrs, degs, q_t = _fused_case(rng, B=12)
    n = tps.n
    starts = rng.integers(0, n, (12, 3)).astype(np.int32)
    starts[:, 2] = starts[:, 0]
    starts[0, 1] = -1
    ids, dists, nv, cmps = beam_search_fused(
        t(q_t), tps.data, t(nbrs), t(degs), t(starts), metric=Metric.L2,
        n_valid=n, k=k, L=L)
    ref = beam_search_batch(t(q_t), tps.data, t(nbrs), t(degs), t(starts),
                            metric=Metric.L2, n_valid=n, k=k, L=L)
    np.testing.assert_array_equal(ids.numpy(), ref.beam_ids.numpy())
    np.testing.assert_array_equal(dists.numpy(), ref.beam_dists.numpy())
    np.testing.assert_array_equal(nv.numpy(), ref.num_visited.numpy())
    np.testing.assert_array_equal(cmps.numpy(), ref.dist_cmps.numpy())


def test_torch_rerank_matches_jax(rng):
    n, d, B, L, k = 150, 16, 9, 20, 5
    X = rng.standard_normal((n + 2, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    beam = rng.integers(0, n, (B, L)).astype(np.int32)
    beam[:, -3:] = -1
    wi, wd = jrerank(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(beam), k=k,
                     pool=15, metric=JMetric.L2)
    gi, gd = rerank_topk(t(Q), t(X), t(beam), k=k, pool=15, metric=Metric.L2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), rtol=1e-5)


def test_torch_exact_knn_matches_float64(rng):
    X = rng.standard_normal((301, 24)).astype(np.float32)
    Q = rng.standard_normal((7, 24)).astype(np.float32)
    ids, dists = exact_knn(Q, PointSet.from_numpy(X, device="cpu"), 10, chunk=64)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    want = np.argsort(d64, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_allclose(dists.numpy(), np.take_along_axis(d64, want, 1),
                               rtol=1e-4, atol=1e-4)


def test_torch_bitonic_plain_is_lexsort(rng):
    keys = rng.integers(0, 8, (4, 64)).astype(np.float32)
    vals = np.stack([rng.permutation(64) for _ in range(4)]).astype(np.int32)
    sk, sv = bitonic_sort_rows(t(keys), t(vals))
    order = np.lexsort((vals, keys), axis=1)
    np.testing.assert_array_equal(sk.numpy(), np.take_along_axis(keys, order, 1))
    np.testing.assert_array_equal(sv.numpy(), np.take_along_axis(vals, order, 1))


def test_torch_kernel_wrappers_reject_mixed_devices():
    cpu = torch.zeros((4, 8), dtype=torch.int8)
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        expand_distances(cpu[None], meta, cpu.float(), metric=Metric.L2)
