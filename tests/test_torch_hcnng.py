"""HCNNG and the random cluster trees, port vs JAX package.

The JAX builders draw from ``jax.random``; the port draws through
``utils/draws.py:Draws``. Here a replay of the JAX key schedule is handed
to the port (``split`` a tree per level, hcnng.py:90's ``split`` per
tree), so the modules take the same draws.

Bars.
- ``cluster_tree_labels``: (ids, labels) equal, except from a level where
  some point's two pivot distances lie within rtol 1e-5 of each other (the
  two packages sum distances in another order); such a point is shown.
- ``leaf_members``: equal. ``kruskal_leaves``: equal to the JAX package's
  and to the Python loop ``kruskal_leaves_plain``.
- ``_leaf_candidate_edges``: weights within rtol 1e-5 of the float64
  weights, edges equal except where two edges' weights tie within it.
- Whole builds with the JAX draws: the ROADMAP's graph-build parity bar, average
  degree within 0.5 and recall@10 at beam 10 within 0.01, each package's
  searcher also run over the other's graph. With the port's own draws: a
  sanity bound, degree within 1.0 and recall within 0.03. A uint8 build
  equals the build on its float32 copy.

Sizes are the JAX tests': n = 1200, d = 16, 8 trees of 150, mst_deg 3.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import parlayann_tpu as jpt
from parlayann_tpu import native as jnative
from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.data.graph import GraphIndexData as JGraph
from parlayann_tpu.build import cluster as jcluster
from parlayann_tpu.build import hcnng as jhcnng

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop, native
from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.build import cluster, hcnng
from parlayann_tpu_torch.build.cluster import _split_level
from parlayann_tpu_torch.search.exact import compute_groundtruth
from parlayann_tpu_torch.utils.draws import Draws
from parlayann_tpu_torch.harness.recall import compute_recall

torch.set_num_threads(1)
N, D, T, S, MST = 1200, 16, 8, 150, 3
K, BEAM = 10, 10
METRICS = {"l2": (Metric.L2, JMetric.L2), "mips": (Metric.MIPS, JMetric.MIPS)}


def data():
    rng = np.random.default_rng(42)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((100, D)).astype(np.float32))


def level_keys(key, lvl):
    """The key of level ``lvl`` of a tree whose key is ``key`` (cluster.py:58)."""
    for _ in range(lvl + 1):
        key, sub = jax.random.split(key)
    return sub


def jax_bits(key, n):
    return torch.from_numpy(np.array(
        jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))


class JaxTreeDraws:
    """The JAX HCNNG build's tree draws: ``split(key(seed), T)`` a tree
    (hcnng.py:90), then one ``split`` a level."""

    def __init__(self, seed, num_clusters):
        self.trees = jax.random.split(jax.random.key(seed), num_clusters)

    def tree_bits(self, tree, level, n):
        return jax_bits(level_keys(self.trees[tree], level), n)


def test_torch_hcnng_draws_are_signed_and_seeded():
    """The default draws: int32 keys over the whole signed range from the
    seed alone; join slots in [0, J)."""
    a, b = Draws(3), Draws(3)
    x = a.tree_bits(0, 0, 100_000)
    assert x.dtype == torch.int32 and torch.equal(x, b.tree_bits(0, 0, 100_000))
    assert int(x.min()) < -(2 ** 30) and int(x.max()) > 2 ** 30
    c1, c2 = a.hops(0, 50, 4, 5, 7)
    assert c1.shape == (50, 4) and c2.shape == (50, 4, 5) and c2.dtype == torch.int64
    assert int(c2.min()) == 0 and int(c2.max()) == 6
    assert not torch.equal(Draws(4).tree_bits(0, 0, 1000), Draws(3).tree_bits(0, 0, 1000))


def first_split_level(X, key, metric, jmetric):
    """Step both packages level by level from the start; -> (level, port
    state before it) at the first level whose (ids, labels) differ, else
    None."""
    n_pad = X.shape[0]
    pos = torch.arange(n_pad, dtype=torch.int32)
    state = (pos, torch.where(pos < N, 0, -1).to(torch.int32), pos < N)
    data_t = torch.from_numpy(X)
    for lvl in range(24):
        ids, labels, active, _, _ = _split_level(
            data_t, *state, jax_bits(level_keys(key, lvl), n_pad), metric=metric,
            cluster_size=S)
        jids, jlabels = jcluster.cluster_tree_labels(
            jnp.asarray(X), key, metric=jmetric, cluster_size=S, n_valid=N,
            max_levels=lvl + 1)
        if not (np.array_equal(ids.numpy(), np.asarray(jids))
                and np.array_equal(labels.numpy(), np.asarray(jlabels))):
            return lvl, state
        state = (ids, labels, active)
        if not bool(active.any()):
            return None
    return None


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_cluster_tree_labels_match_jax(metric):
    """Eight trees with the JAX keys: (ids, labels) equal to the JAX
    package's; where a tree differs, the first level that differs holds a
    point whose two pivot distances lie within rtol 1e-5 (shown), and the
    tree is not compared further. Every valid point is in exactly one leaf
    of at most S points."""
    tm, jm = METRICS[metric]
    X, _ = data()
    ps = PointSet.from_numpy(X, metric=tm, device="cpu")
    Xp = ps.data.numpy()
    draws = JaxTreeDraws(0, T)
    n_equal = 0
    for t in range(T):
        ids, labels = cluster.cluster_tree_labels(
            ps.data, lambda lvl, n, t=t: draws.tree_bits(t, lvl, n), metric=tm,
            cluster_size=S, n_valid=N)
        jids, jlabels = jcluster.cluster_tree_labels(
            jnp.asarray(Xp), draws.trees[t], metric=jm, cluster_size=S, n_valid=N)
        ids, labels = ids.numpy(), labels.numpy()
        valid = labels >= 0
        assert sorted(ids[valid].tolist()) == list(range(N))
        members, sizes = cluster.leaf_members(ids, labels, S)
        assert sizes.sum() == N and sizes.max() <= S
        if np.array_equal(ids, np.asarray(jids)) and np.array_equal(labels, np.asarray(jlabels)):
            n_equal += 1
            continue
        found = first_split_level(Xp, draws.trees[t], tm, jm)
        assert found is not None, f"tree {t}: the final labels differ, no level does"
        lvl, state = found
        _, _, _, d1, d2 = _split_level(
            torch.from_numpy(Xp), *state, draws.tree_bits(t, lvl, ps.n_pad), metric=tm,
            cluster_size=S)
        near = (d1 - d2).abs() <= 1e-5 * torch.maximum(d1.abs(), d2.abs())
        near &= d1 != d2
        print(f"tree {t} level {lvl}: near-equal pivot distances at sorted positions "
              f"{torch.nonzero(near)[:, 0].tolist()}")
        assert bool(near.any()), f"tree {t} level {lvl} differs without a near tie"
    assert n_equal >= T - 1, n_equal


def test_torch_leaf_members_match_jax():
    rng = np.random.default_rng(1)
    ids = rng.permutation(1000).astype(np.int32)
    labels = rng.integers(-1, 40, 1000).astype(np.int32)
    labels[rng.random(1000) < 0.1] = -1
    for cs in (8, 64):
        got = cluster.leaf_members(ids, labels, cs)
        want = jcluster.leaf_members(ids, labels, cs)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mst_deg", [1, 3])
def test_torch_kruskal_leaves_match_jax(mst_deg):
    """Leaves of 0, 1, 20 and 150 points over weight-sorted random edges
    with invalid slots, self loops and out-of-leaf ids: the C++ library
    equals the JAX package's and the Python loop."""
    rng = np.random.default_rng(2)
    sizes = np.array([20, 0, 1, 150, 150, 37], np.int32)
    E = 600
    eu = rng.integers(-1, 152, (len(sizes), E)).astype(np.int32)
    ev = rng.integers(-1, 152, (len(sizes), E)).astype(np.int32)
    eu[0, :30] = ev[0, :30]
    got = native.kruskal_leaves(eu, ev, sizes, 150, mst_deg)
    plain = native.kruskal_leaves_plain(eu, ev, sizes, 150, mst_deg)
    want = jnative.kruskal_leaves(eu, ev, sizes, 150, mst_deg)
    for a, b, c in zip(got, plain, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    ou, ov, cnt = got
    # a 150-point leaf joins most of its points (a matching at mst_deg 1)
    assert cnt[3] >= (100 if mst_deg == 3 else 40)
    for leaf in range(len(sizes)):
        deg = np.bincount(np.concatenate([ou[leaf, :cnt[leaf]], ov[leaf, :cnt[leaf]]]),
                          minlength=max(int(sizes[leaf]), 1))
        assert deg.max(initial=0) <= mst_deg
    with pytest.raises(ValueError, match="exceeds"):
        native.kruskal_leaves(eu, ev, sizes, 100, mst_deg)


def test_torch_kruskal_library_builds_into_build_dir(tmp_path, monkeypatch):
    """The library builds from the port's ``csrc/kruskal.cpp`` into
    ``_build/``; the CUDA library's sources leave the .cpp out; a source
    that does not compile raises."""
    from parlayann_tpu_torch.ops.kernels import _lib

    path = native.build()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libparlayann_host_")
    assert native.SOURCE.parent == _lib.SRC_DIR
    assert native.SOURCE.name not in [p.name for p in _lib.SRC_DIR.glob("*.cu")]
    bad = tmp_path / "kruskal.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def pair_weights(X, members, u, v, metric):
    """float64 weights of leaf-local edges (u, v); NaN where invalid."""
    uu, vv = np.clip(u, 0, None), np.clip(v, 0, None)
    a = X[np.take_along_axis(members, uu, 1)].astype(np.float64)
    b = X[np.take_along_axis(members, vv, 1)].astype(np.float64)
    w = -(a * b).sum(-1) if metric is Metric.MIPS else ((a - b) ** 2).sum(-1)
    return np.where(u >= 0, w, np.nan)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_leaf_candidate_edges_match_jax(metric):
    """One tree's leaves (JAX keys): the port's weight-sorted edges equal
    the JAX package's unpacked (u, v) words, except where two edges' weights
    tie within rtol 1e-5; weights within rtol 1e-5 of float64."""
    tm, jm = METRICS[metric]
    X, _ = data()
    ps = PointSet.from_numpy(X, metric=tm, device="cpu")
    Xp = ps.data.numpy()
    jids, jlabels = jcluster.cluster_tree_labels(
        jnp.asarray(Xp), JaxTreeDraws(0, T).trees[0], metric=jm, cluster_size=S, n_valid=N)
    members, sizes = cluster.leaf_members(np.asarray(jids), np.asarray(jlabels), S)
    m = 10
    su, sv, sw = hcnng._leaf_candidate_edges(
        ps.data, torch.from_numpy(members), torch.from_numpy(sizes), S=S, m=m, metric=tm)
    su, sv, sw = su.numpy(), sv.numpy(), sw.numpy()
    packed = np.asarray(jhcnng._leaf_candidate_edges(
        jnp.asarray(Xp), jnp.asarray(members), jnp.asarray(sizes), S=S, m=m, metric=jm))
    sp = 1 << (S - 1).bit_length()
    ju = np.where(packed >= 0, packed >> int(np.log2(sp)), -1)
    jv = np.where(packed >= 0, packed & (sp - 1), -1)
    np.testing.assert_array_equal(su >= 0, ju >= 0)
    ok = su >= 0
    assert ok.sum() == (sizes * np.minimum(m, sizes - 1)).sum()
    w_t = pair_weights(Xp, members, su, sv, tm)
    w_j = pair_weights(Xp, members, ju, jv, tm)
    scale = np.nanmax(np.abs(w_j))
    assert (np.abs(sw[ok] - w_t[ok]) <= 1e-5 * scale).all()
    differ = ok & ((su != ju) | (sv != jv))
    assert (np.abs(w_t[differ] - w_j[differ]) <= 1e-5 * scale).all()
    print(f"{metric}: {int(differ.sum())} of {int(ok.sum())} slots differ (ties)")


def search_recall(index_cls, points, graph, Q, gt, beam=BEAM):
    ids = index_cls(points=points, graph=graph).batch_search(Q, k=K, beam_size=beam)[0]
    return compute_recall(np.asarray(ids), *gt, K)


def builds(metric, draws):
    """The JAX build and the port's, with ``draws`` (None: the port's own)."""
    tm, jm = METRICS[metric]
    X, Q = data()
    bp = dict(num_clusters=T, cluster_size=S, MST_deg=MST)
    jps = JPointSet.from_numpy(X, metric=jm)
    jg, _ = jhcnng.build_hcnng_graph(jps, JBuildParams(**bp))
    tps = PointSet.from_numpy(X, metric=tm, device="cpu")
    tg, _ = hcnng.build_hcnng_graph(tps, BuildParams(**bp), draws=draws)
    gt = compute_groundtruth(tps, Q, 2 * K)
    return dict(Q=Q, jps=jps, jg=jg, tps=tps, tg=tg, gt=gt)


def cross_recalls(b):
    """recall@10 of each searcher on each graph -> (jax/jax, {others})."""
    tg, jg = b["tg"], b["jg"]
    tg_in_jax = JGraph.from_numpy(tg.neighbors.numpy(), tg.degrees.numpy(), n=tg.n)
    jg_in_torch = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                           jg.n, jg.max_degree, device="cpu")
    ref = search_recall(jpt.Index, b["jps"], jg, b["Q"], b["gt"])
    return ref, {"torch/torch": search_recall(pt.Index, b["tps"], tg, b["Q"], b["gt"]),
                 "torch/jax-graph": search_recall(pt.Index, b["tps"], jg_in_torch, b["Q"], b["gt"]),
                 "jax/torch-graph": search_recall(jpt.Index, b["jps"], tg_in_jax, b["Q"], b["gt"])}


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_hcnng_build_matches_jax(metric):
    """The JAX draws replayed: average degree within 0.5, recall@10 at beam
    10 within 0.01, on each package's graph and across."""
    b = builds(metric, JaxTreeDraws(0, T))
    j_avg, j_max = b["jg"].stats()
    t_avg, t_max = b["tg"].stats()
    assert t_max <= T * MST and b["tg"].max_degree == T * MST
    assert abs(j_avg - t_avg) <= 0.5, (j_avg, t_avg)
    ref, recalls = cross_recalls(b)
    print(f"{metric}: degree avg jax {j_avg:.3f} torch {t_avg:.3f}; "
          f"recall@{K} beam {BEAM}: jax/jax {ref:.4f}", recalls)
    for name, r in recalls.items():
        assert abs(r - ref) <= 0.01, (name, r, ref)


def test_torch_hcnng_build_own_draws():
    """The port's own draws (a CPU generator from the seed): degree within
    1.0 and recall@10 within 0.03 of the JAX build, at beam 24 (beam 10
    sits on the steep part of the recall curve, where another random graph
    moves the recall by more than that); the same seed gives the same
    graph, another seed another graph."""
    b = builds("l2", None)
    j_avg, _ = b["jg"].stats()
    t_avg, _ = b["tg"].stats()
    assert abs(j_avg - t_avg) <= 1.0, (j_avg, t_avg)
    ref = search_recall(jpt.Index, b["jps"], b["jg"], b["Q"], b["gt"], beam=24)
    got = search_recall(pt.Index, b["tps"], b["tg"], b["Q"], b["gt"], beam=24)
    assert abs(got - ref) <= 0.03, (got, ref)
    bp = BuildParams(num_clusters=T, cluster_size=S, MST_deg=MST)
    again, _ = hcnng.build_hcnng_graph(b["tps"], bp)
    assert torch.equal(again.neighbors, b["tg"].neighbors)
    other, _ = hcnng.build_hcnng_graph(b["tps"], BuildParams(
        num_clusters=T, cluster_size=S, MST_deg=MST, seed=1))
    assert not torch.equal(other.neighbors, b["tg"].neighbors)


def test_torch_hcnng_uint8_build_equals_float_copy():
    """uint8 points build on their values as float32: the graph equals the
    build on a float32 copy, and the PointSet stays uint8."""
    X, _ = data()
    U = np.round((X - X.min()) / (X.max() - X.min()) * 255).astype(np.uint8)
    kw = dict(num_clusters=T, cluster_size=S, mst_deg=MST, device="cpu")
    gu, psu, _ = pt.build_hcnng_index(U, **kw)
    gf, _, _ = pt.build_hcnng_index(U.astype(np.float32), **kw)
    assert psu.data.dtype == torch.uint8
    assert torch.equal(gu.neighbors, gf.neighbors) and torch.equal(gu.degrees, gf.degrees)


def test_torch_hcnng_api_validates_like_jax():
    X, _ = data()
    for kw in (dict(mst_deg=0), dict(num_clusters=0), dict(cluster_size=1)):
        with pytest.raises(ValueError):
            pt.build_hcnng_index(X, device="cpu", **kw)
        with pytest.raises(ValueError):
            jpt.build_hcnng_index(X, **kw)
    with pytest.raises(ValueError, match="too large"):
        pt.build_hcnng_index(X[:10], cluster_size=70_000, device="cpu")
    g, ps, secs = pt.build_hcnng_index(X[:300], num_clusters=2, cluster_size=40,
                                       device="cpu")
    assert g.max_degree == 6 and ps.n == 300 and secs > 0
