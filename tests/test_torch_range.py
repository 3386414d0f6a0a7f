"""Range search, port vs JAX package: range_search_batch, range_query,
self_join, compute_range_groundtruth and range_search_wrapper on the same
numpy inputs and the same graph (built once by the JAX package).

The bar: on integer-valued data (uint8 points, or float32 points holding
integers) every distance is an exact float32 integer, so ids, dists,
counts and dist_cmps are equal. On float32 data dists agree within rtol
1e-5 and the id sets are equal except for ids whose distance lies within a
relative 1e-5 of the radius; the radii below are placed where no pair lies
that close, so the sets are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.build.vamana import build_vamana_graph as jbuild
from parlayann_tpu.search import exact as jexact, range as jrange
from parlayann_tpu.harness import range_sweep as jsweep
import parlayann_tpu.types as jtypes

import parlayann_tpu_torch as pt
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.search import exact, range as trange
from parlayann_tpu_torch.harness import range_sweep as tsweep

torch.set_num_threads(1)
N, D, NQ = 600, 12, 40


def _u8(X):
    """One affine map of X's range onto [0, 255], rounded: distances scale
    alike, so X's graph stays a graph of the uint8 points."""
    lo, hi = X.min(), X.max()
    return np.clip(np.rint((X - lo) * (255.0 / (hi - lo))), 0, 255).astype(np.uint8)


def _clear_radius(d, q, rel=1e-4):
    """A radius near quantile ``q`` of the pair distances ``d`` (float64)
    with no pair within a relative ``rel`` of it."""
    u = np.unique(d.ravel())
    i = int(np.searchsorted(u, np.quantile(u, q)))
    while i + 1 < len(u) and u[i + 1] - u[i] <= 2 * rel * abs(u[i]) + 1e-9:
        i += 1
    return float((u[i] + u[i + 1]) / 2)


def _pairs(A, B, metric):
    A, B = A.astype(np.float64), B.astype(np.float64)
    if metric == "mips":
        return -(A @ B.T)
    return ((A[:, None, :] - B[None]) ** 2).sum(-1)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((N, D)).astype(np.float32)
    Q = (X[rng.integers(0, N, NQ)]
         + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
    g, _ = jbuild(JPointSet.from_numpy(X),
                  JBuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25))
    nb, dg = np.asarray(g.neighbors)[:N], np.asarray(g.degrees)[:N]
    U = _u8(X)
    QU = _u8(np.concatenate([X, Q]))[N:]  # queries under another map: still integers
    data = {"f32": (X, Q), "int": (U.astype(np.float32), QU.astype(np.float32)),
            "uint8": (U, QU)}
    return dict(data=data, nbrs=nb, degs=dg)


def _both(setup, kind, metric):
    """(JAX (points, graph), port (points, graph)) for one data kind."""
    X, _ = setup["data"][kind]
    jps = JPointSet.from_numpy(X, metric=metric)
    tps = PointSet.from_numpy(X, metric=metric, device="cpu")
    from parlayann_tpu.data.graph import GraphIndexData as JGraph
    jg = JGraph.from_numpy(setup["nbrs"], setup["degs"], n=N)
    tg = GraphIndexData.from_numpy(setup["nbrs"], setup["degs"], n=N, device="cpu")
    return jps, jg, tps, tg


def _check_equal(jr, tr, exact_data, radius):
    """Hold a port RangeResult to the JAX one (module docstring's bar)."""
    j = [np.asarray(x) for x in jr]
    t = [x.numpy() for x in tr]
    np.testing.assert_array_equal(t[2], j[2])  # counts
    np.testing.assert_array_equal(t[3], j[3])  # dist_cmps
    if exact_data:
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        return
    found = j[0] >= 0
    np.testing.assert_array_equal(t[0] >= 0, found)
    np.testing.assert_allclose(t[1][found], j[1][found], rtol=1e-5)
    for r in range(len(j[0])):
        js, ts = set(j[0][r][found[r]].tolist()), set(t[0][r][found[r]].tolist())
        near = {i for i, dd in zip(j[0][r], j[1][r])
                if abs(dd - radius) <= 1e-5 * abs(radius)}
        assert js ^ ts <= near, (r, js ^ ts)


# (data kind, metric, seeds, cap): seeds "row" are the points' own graph
# rows with exclude_self, "beam" the in-range entries of a beam search
CASES = [("f32", "l2", "row", 256), ("uint8", "l2", "beam", 256),
         ("f32", "mips", "row", 256), ("int", "l2", "row", 4),
         ("uint8", "mips", "beam", 8)]


@pytest.mark.parametrize("kind,metric,seeds,cap", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_torch_range_search_batch_matches_jax(setup, kind, metric, seeds, cap):
    X, Q = setup["data"][kind]
    jps, jg, tps, tg = _both(setup, kind, metric)
    if seeds == "row":
        rows = np.arange(0, N, 7, dtype=np.int32)[:64]
        q = X[rows]
        st = np.where(np.arange(16)[None, :] < setup["degs"][rows][:, None],
                      setup["nbrs"][rows], -1).astype(np.int32)
        self_ids, excl = rows, True
    else:
        q, self_ids, excl = Q, None, False
    rad = _clear_radius(_pairs(q, X, metric), 0.03 if metric == "l2" else 0.02)
    if seeds == "beam":
        jb = jrange.beam_search_batch(
            jnp.asarray(q), jps.data, jg.neighbors, jg.degrees,
            jnp.asarray([0], jnp.int32), metric=jps.metric, n_valid=N, k=0, L=20)
        st = np.where(np.asarray(jb.beam_dists) <= rad, np.asarray(jb.beam_ids), -1
                      ).astype(np.int32)
    jr = jrange.range_search_batch(
        jnp.asarray(q), jps.data, jg.neighbors, jg.degrees, jnp.asarray(st), rad,
        None if self_ids is None else jnp.asarray(self_ids),
        metric=jps.metric, n_valid=N, cap=cap, exclude_self=excl)
    tr = trange.range_search_batch(
        torch.from_numpy(q), tps.data, tg.neighbors, tg.degrees, torch.from_numpy(st),
        rad, None if self_ids is None else torch.from_numpy(self_ids),
        metric=tps.metric, n_valid=N, cap=cap, exclude_self=excl)
    counts = tr.counts.numpy()
    assert counts.sum() > 0
    if cap < 16:
        assert (counts == cap).any()  # the set overflowed its cap
    if excl:
        assert not (tr.ids.numpy() == rows[:, None]).any()
    _check_equal(jr, tr, kind != "f32", rad)


@pytest.mark.parametrize("kind,beam", [("uint8", 10), ("f32", 45)])
def test_torch_range_query_matches_jax(setup, kind, beam):
    X, Q = setup["data"][kind]
    jps, jg, tps, tg = _both(setup, kind, "l2")
    rad = _clear_radius(_pairs(Q, X, "l2"), 0.03)
    jr = jrange.range_query(Q, jps.data, jg.neighbors, jg.degrees, 0, rad,
                            initial_beam=beam, metric=JMetric.L2, n_valid=N)
    tr = trange.range_query(Q, tps.data, tg.neighbors, tg.degrees, 0, rad,
                            initial_beam=beam, metric=Metric.L2, n_valid=N)
    assert tr.ids.device.type == "cpu" and int(tr.counts.sum()) > 0
    _check_equal(jr, tr, kind != "f32", rad)


def test_torch_self_join_matches_jax(setup):
    U, _ = setup["data"]["uint8"]
    jps, jg, tps, tg = _both(setup, "uint8", "l2")
    rad = _clear_radius(_pairs(U[:100], U, "l2"), 0.01)
    jrows, jcmps = jrange.self_join(jps.data, jg.neighbors, jg.degrees, rad, rad,
                                    metric=JMetric.L2, n_valid=N, batch=256)
    trows, tcmps = trange.self_join(tps.data, tg.neighbors, tg.degrees, rad, rad,
                                    metric=Metric.L2, n_valid=N, batch=256)
    assert tcmps == jcmps and len(trows) == len(jrows) == N
    assert sum(len(r) for r in trows) > 0
    for a, b in zip(trows, jrows):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("block_bytes", [1 << 30, 4 * 16 * 100],
                         ids=["one_chunk", "chunks_of_100"])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_range_groundtruth_matches_jax(setup, monkeypatch, metric, block_bytes):
    """n_pad > n (601 points pad to 608), query_batch < nq, and chunks of
    the base that split rows' results."""
    X, Q = setup["data"]["f32"]
    X = np.concatenate([X, Q[:1] + 0.5])  # 601 points
    rad = _clear_radius(_pairs(Q, X, metric), 0.05)
    jps = JPointSet.from_numpy(X, metric=metric)
    tps = PointSet.from_numpy(X, metric=metric, device="cpu")
    assert tps.n_pad == 608
    jgt = jexact.compute_range_groundtruth(jps, Q, rad, query_batch=16)
    monkeypatch.setattr(exact, "RANGE_BLOCK_BYTES", block_bytes)
    tgt = exact.compute_range_groundtruth(tps, Q, rad, query_batch=16)
    assert len(tgt) == len(jgt) == NQ and sum(len(g) for g in tgt) > 0
    for a, b in zip(tgt, jgt):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_torch_range_sweep_matches_jax(setup, monkeypatch):
    """Each row's beam, pointwise and cumulative recall and avg_cmps equal
    the JAX harness's; a query inside a dense clump of 300 points has a
    ground-truth set past 256, so the cap rises to 512."""
    U, QU = setup["data"]["uint8"]
    clump = np.clip(U[:1].astype(np.int32)
                    + np.random.default_rng(1).integers(-1, 2, (300, D)), 0, 255)
    X = np.concatenate([U[300:], clump]).astype(np.uint8)  # 600 points
    Q = np.concatenate([QU[:20], U[:1]]).astype(np.float32)
    g, _ = jbuild(JPointSet.from_numpy(X.astype(np.float32)),
                  JBuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25))
    jps = JPointSet.from_numpy(X)
    tps = PointSet.from_numpy(X, device="cpu")
    tg = GraphIndexData.from_numpy(np.asarray(g.neighbors)[:N], np.asarray(g.degrees)[:N],
                                   n=N, device="cpu")
    rad = 40.5  # exact integer distances: no pair at the radius
    gt = exact.compute_range_groundtruth(tps, Q, rad)
    assert max(len(g) for g in gt) > 256
    caps = []
    real = tsweep.range_query
    monkeypatch.setattr(tsweep, "range_query",
                        lambda *a, **kw: caps.append(kw["cap"]) or real(*a, **kw))
    beams = (10, 20, 45)
    jrows = jsweep.range_search_wrapper(Q, jps.data, g.neighbors, g.degrees, gt, rad,
                                        beams=beams, metric=JMetric.L2, n_valid=N,
                                        verbose=False)
    trows = tsweep.range_search_wrapper(Q, tps.data, tg.neighbors, tg.degrees, gt, rad,
                                        beams=beams, metric=Metric.L2, n_valid=N,
                                        verbose=False)
    assert set(caps) == {512}
    assert [r.initial_beam for r in trows] == list(beams)
    for a, b in zip(trows, jrows):
        assert (a.initial_beam, a.pointwise_recall, a.cumulative_recall, a.avg_cmps) == (
            b.initial_beam, b.pointwise_recall, b.cumulative_recall, b.avg_cmps)
        assert a.QPS > 0
    assert trows[-1].cumulative_recall > 0.5
    assert trows[0].print().startswith("For initial beam = 10, Pointwise Recall = ")


def test_torch_range_params_exported():
    assert pt.RangeParams is pt.types.RangeParams
    assert ([(f.name, f.default) for f in dataclasses.fields(pt.RangeParams)]
            == [(f.name, f.default) for f in dataclasses.fields(jtypes.RangeParams)])
