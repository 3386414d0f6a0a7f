"""pyNNDescent and random-start search, port vs JAX package.

The JAX builder draws from ``jax.random``; the port draws through
``utils/draws.py:Draws``. Here a replay of the JAX key schedule
(pynndescent.py:214-276: ``split`` a tree, ``split(key, 3)`` a round, one
``split`` for the polish and one for the final prune) is handed to the
port, so the modules take the same draws.

Bars (f32 sums run in another order in the two packages).
- ``_leaf_topk``, ``_descent_round``, ``_descent_round_exact``: distances
  within 1e-5 of the row's largest magnitude; ids equal except at slots
  whose two ids lie at distances within that tolerance of each other (a
  tie); the rounds report the same ``changed``.
- ``_reverse_capped``: equal.
- ``Index.batch_search(random_starts=)`` and ``beam_search_random``: the
  JAX draws (int64 and int32 ``integers``), so the same ids.
- Whole builds with the JAX draws: the ROADMAP's graph-build parity bar, average
  degree within 0.5 and recall@10 at a fixed beam within 0.01, each
  package's searcher also run over the other's graph. With the port's own
  draws: degree within 1.0 and recall within 0.03. A uint8 build equals
  the build on its float32 copy.

Sizes are the JAX tests': n = 1000, d = 16, R = 20, 6 trees of 80.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import parlayann_tpu as jpt
from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.data.graph import GraphIndexData as JGraph
from parlayann_tpu.build import cluster as jcluster
from parlayann_tpu.build import pynndescent as jpynn
from parlayann_tpu.search.beam import beam_search_random as jbeam_random

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.build import cluster, pynndescent
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.search.beam import beam_search_batch, beam_search_random
from parlayann_tpu_torch.search.exact import compute_groundtruth
from parlayann_tpu_torch.harness.recall import compute_recall

torch.set_num_threads(1)
N, D, KD, T, S = 1000, 16, 20, 6, 80
K, BEAM = 10, 10
METRICS = {"l2": (Metric.L2, JMetric.L2), "mips": (Metric.MIPS, JMetric.MIPS)}


def data():
    rng = np.random.default_rng(42)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((100, D)).astype(np.float32))


def bits(key, n):
    return torch.from_numpy(np.array(jax.random.bits(key, (n,), jnp.uint32).astype(jnp.int32)))


def hop_draws(key, n, s1, s2, J):
    """``_descent_round``'s two randint draws from its key (pynndescent.py:168-174)."""
    k1, k2 = jax.random.split(key)
    c1 = np.array(jax.random.randint(k1, (n, s1), 0, J))
    c2 = np.array(jax.random.randint(k2, (n, s1, s2), 0, J))
    return torch.from_numpy(c1).long(), torch.from_numpy(c2).long()


class JaxDraws:
    """The JAX pyNNDescent build's key schedule, for ``Draws``' calls in the
    order the build makes them."""

    def __init__(self, seed, num_clusters):
        key = jax.random.key(seed)
        self.trees = []
        for _ in range(max(num_clusters, 1)):
            key, sub = jax.random.split(key)
            self.trees.append(sub)
        self.key, self.hop_keys = key, {}

    def tree_bits(self, tree, level, n):
        key = self.trees[tree]
        for _ in range(level + 1):
            key, sub = jax.random.split(key)
        return bits(sub, n)

    def reverse_bits(self, stage, m):
        if isinstance(stage, int):
            assert stage == len(self.hop_keys)
            self.key, k1, self.hop_keys[stage] = jax.random.split(self.key, 3)
        else:
            self.key, k1 = jax.random.split(self.key)
        return bits(k1, m)

    def hops(self, rnd, n, s1, s2, J):
        return hop_draws(self.hop_keys[rnd], n, s1, s2, J)


def true_dists(X64, rows, ids, metric):
    """float64 distances of ``ids`` (R, K) to the points ``rows`` (R,);
    NaN where an id is negative."""
    v = X64[np.clip(ids, 0, None)]
    p = X64[rows][:, None, :]
    d = -(v * p).sum(-1) if metric is Metric.MIPS else ((v - p) ** 2).sum(-1)
    return np.where(ids >= 0, d, np.nan)


def assert_rows_match(X, got, want, metric, rows=None):
    """(ids, dists) lists of the port and the JAX package: the same empty
    slots, distances within 1e-5 of the row's largest magnitude, and where
    ids differ the two ids' float64 distances within it (a tie) -> the
    number of slots that differ."""
    ti, td = (np.asarray(x) for x in got)
    ji, jd = (np.asarray(x) for x in want)
    rows = np.arange(len(ti)) if rows is None else rows
    np.testing.assert_array_equal(ti >= 0, ji >= 0)
    ok = ji >= 0
    scale = np.abs(np.where(ok, jd, 0)).max(axis=1, keepdims=True) + 1e-30
    tol = 1e-5 * np.broadcast_to(scale, jd.shape)
    assert (np.abs(td - jd)[ok] <= tol[ok]).all()
    assert (td[~ok] >= INF).all() and (jd[~ok] >= INF).all()
    differ = ok & (ti != ji)
    X64 = X.astype(np.float64)
    dt, dj = true_dists(X64, rows, ti, metric), true_dists(X64, rows, ji, metric)
    assert (np.abs(dt - dj)[differ] <= tol[differ]).all()
    return int(differ.sum())


@pytest.fixture(scope="module", params=["l2", "mips"])
def init(request):
    """The points, two trees' leaves (JAX keys), and the K-lists after the
    JAX package's ``_leaf_topk`` over the first tree and then the second."""
    tm, jm = METRICS[request.param]
    X, _ = data()
    ps = PointSet.from_numpy(X, metric=tm, device="cpu")
    Xp = ps.data.numpy()
    n_pad = ps.n_pad
    ji = jnp.full((n_pad, KD), -1, jnp.int32)
    jd = jnp.full((n_pad, KD), np.float32(3.0e38), jnp.float32)
    trees, lists = [], []
    for key in JaxDraws(0, T).trees[:2]:
        ids, labels = jcluster.cluster_tree_labels(
            jnp.asarray(Xp), key, metric=jm, cluster_size=S, n_valid=N)
        members, sizes = cluster.leaf_members(np.asarray(ids), np.asarray(labels), S)
        ji, jd = jpynn._leaf_topk(jnp.asarray(Xp), jnp.asarray(members), jnp.asarray(sizes),
                                  ji, jd, S=S, K=KD, metric=jm, n_valid=N)
        trees.append((members, sizes))
        lists.append((np.array(ji), np.array(jd)))
    return dict(tm=tm, jm=jm, X=Xp, ps=ps, trees=trees, lists=lists,
                ids=lists[1][0], dists=lists[1][1])


def test_torch_pynn_leaf_topk_matches_jax(init):
    """The first tree's all-pairs K-lists from empty lists (each member
    holds min(K, leaf size - 1) ids), then the second tree's merged into
    them."""
    b = init
    n_pad = b["ps"].n_pad
    cur = (torch.full((n_pad, KD), -1, dtype=torch.int32),
           torch.full((n_pad, KD), INF, dtype=torch.float32))
    for (members, sizes), want in zip(b["trees"], b["lists"]):
        cur = pynndescent._leaf_topk(b["ps"].data, torch.from_numpy(members),
                                     torch.from_numpy(sizes), *cur, S=S, K=KD,
                                     metric=b["tm"], n_valid=N)
        assert_rows_match(b["X"], cur, want, b["tm"])
        if want is b["lists"][0]:
            want_n = np.zeros(n_pad, np.int64)
            for row, sz in zip(members, sizes):
                want_n[row[:sz]] = min(KD, sz - 1)
            np.testing.assert_array_equal((cur[0] >= 0).sum(1).numpy(), want_n)


@pytest.mark.parametrize("K_rev", [5, 20])
def test_torch_pynn_reverse_capped_matches_jax(K_rev):
    """Lists with -1, ids >= n_valid and pad rows, the JAX keys: equal."""
    rng = np.random.default_rng(3)
    n_pad, n_valid = 1008, 1000
    nbr = rng.integers(-1, n_pad, (n_pad, KD)).astype(np.int32)
    nbr[:50] = rng.integers(0, 20, (50, KD))  # hot targets past the cap
    key = jax.random.key(5)
    want = np.asarray(jpynn._reverse_capped(jnp.asarray(nbr), key, K=K_rev,
                                            metric=JMetric.L2, n_valid=n_valid))
    got = pynndescent._reverse_capped(torch.from_numpy(nbr), bits(key, n_pad * KD),
                                      K=K_rev, n_valid=n_valid)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:20] >= 0).all() and (want[n_valid:] == -1).all()


def test_torch_pynn_descent_rounds_match_jax(init):
    """One sampled round with the JAX key's draws, then the exact round, from
    the init's lists: ids equal up to ties and the same ``changed``."""
    b = init
    X, tm, jm = b["X"], b["tm"], b["jm"]
    n_pad = b["ps"].n_pad
    ji, jd = jnp.asarray(b["ids"]), jnp.asarray(b["dists"])
    key = jax.random.key(9)
    k1, k2 = jax.random.split(key)
    jrev = jpynn._reverse_capped(ji, k1, K=KD, metric=jm, n_valid=N)
    want = jpynn._descent_round(jnp.asarray(X), ji, jd, jrev, k2, s1=16, s2=16, K=KD,
                                metric=jm, n_valid=N)
    rev = pynndescent._reverse_capped(torch.from_numpy(b["ids"]), bits(k1, n_pad * KD),
                                      K=KD, n_valid=N)
    np.testing.assert_array_equal(rev.numpy(), np.asarray(jrev))
    c1, c2 = hop_draws(k2, n_pad, 16, 16, 2 * KD)
    got = pynndescent._descent_round(b["ps"].data, torch.from_numpy(b["ids"]),
                                     torch.from_numpy(b["dists"]), rev, c1, c2, K=KD,
                                     metric=tm, n_valid=N)
    assert_rows_match(X, got[:2], want[:2], tm)
    assert int(got[2]) == int(want[2]) > 0
    # the exact round from the JAX round's lists
    jrev2 = jpynn._reverse_capped(want[0], k2, K=KD, metric=jm, n_valid=N)
    want_x = jpynn._descent_round_exact(jnp.asarray(X), want[0], want[1], jrev2, K=KD,
                                        metric=jm, n_valid=N)
    got_x = pynndescent._descent_round_exact(
        b["ps"].data, torch.from_numpy(np.array(want[0])), torch.from_numpy(np.array(want[1])),
        torch.from_numpy(np.array(jrev2)), K=KD, metric=tm, n_valid=N)
    assert_rows_match(X, got_x[:2], want_x[:2], tm)
    assert int(got_x[2]) == int(want_x[2]) > 0


def test_torch_pynn_exact_round_chunks_change_nothing(init, monkeypatch):
    """Rows gathered in many small chunks give the same lists."""
    b = init
    rev = pynndescent._reverse_capped(torch.from_numpy(b["ids"]), bits(jax.random.key(1),
                                      b["ps"].n_pad * KD), K=KD, n_valid=N)
    args = (b["ps"].data, torch.from_numpy(b["ids"]), torch.from_numpy(b["dists"]), rev)
    whole = pynndescent._descent_round_exact(*args, K=KD, metric=b["tm"], n_valid=N)
    monkeypatch.setattr(pynndescent, "GATHER_BYTES", 37 * (2 * KD) ** 2 * D * 4)
    parts = pynndescent._descent_round_exact(*args, K=KD, metric=b["tm"], n_valid=N)
    for a, c in zip(whole, parts):
        assert torch.equal(a, c)


BP = dict(R=KD, cluster_size=S, num_clusters=T, alpha=1.2, delta=0.05)
_jax_builds = {}


def jax_build(metric, quantize_build=False):
    """The JAX build of the data (its own draws, seed 0), built once."""
    if (metric, quantize_build) not in _jax_builds:
        jps = JPointSet.from_numpy(data()[0], metric=METRICS[metric][1])
        jg, _ = jpynn.build_pynndescent_graph(jps, JBuildParams(**BP),
                                              quantize_build=quantize_build)
        _jax_builds[(metric, quantize_build)] = jps, jg
    return _jax_builds[(metric, quantize_build)]


@pytest.fixture(scope="module")
def graph():
    """A k-NN graph of the data (the JAX build with its own draws), in
    both packages."""
    X, Q = data()
    jps, jg = jax_build("l2")
    tps = PointSet.from_numpy(X, device="cpu")
    tg = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees), jg.n,
                                  jg.max_degree, device="cpu")
    return dict(X=X, Q=Q, jps=jps, jg=jg, tps=tps, tg=tg)


def test_torch_random_starts_match_jax(graph):
    """``Index.batch_search(random_starts=2, seed=5)`` starts from
    ``default_rng(5).integers(0, n, (B, 2))`` (int64): the same results as
    those starts given explicitly, and the same ids as the JAX package's
    search; ``beam_search_random`` draws int32 ``integers``, as the
    JAX one does, and equals it."""
    b = graph
    B = len(b["Q"])
    idx = pt.Index(points=b["tps"], graph=b["tg"])
    got = idx.batch_search(b["Q"], k=K, beam_size=BEAM, random_starts=2, seed=5)
    starts = np.random.default_rng(5).integers(0, N, (B, 2))
    explicit = idx.batch_search(b["Q"], k=K, beam_size=BEAM, starts=starts)
    assert torch.equal(got[0], explicit[0]) and torch.equal(got[1], explicit[1])
    other = idx.batch_search(b["Q"], k=K, beam_size=BEAM, random_starts=2, seed=6)
    assert not torch.equal(got[0], other[0])
    want = jpt.Index(points=b["jps"], graph=b["jg"]).batch_search(
        b["Q"], k=K, beam_size=BEAM, random_starts=2, seed=5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5)

    i32 = np.random.default_rng(5).integers(0, N, (B, 2), dtype=np.int32)
    kw = dict(metric=Metric.L2, n_valid=N, k=K, L=BEAM)
    q = torch.from_numpy(b["Q"])
    res = beam_search_random(q, b["tps"].data, b["tg"].neighbors, b["tg"].degrees,
                             n_starts=2, seed=5, **kw)
    res_x = beam_search_batch(q, b["tps"].data, b["tg"].neighbors, b["tg"].degrees,
                              torch.from_numpy(i32), **kw)
    assert torch.equal(res.beam_ids, res_x.beam_ids)
    jres = jbeam_random(jnp.asarray(b["Q"]), b["jps"].data, b["jg"].neighbors,
                        b["jg"].degrees, n_starts=2, seed=5, metric=JMetric.L2,
                        n_valid=N, k=K, L=BEAM)
    np.testing.assert_array_equal(res.beam_ids.numpy(), np.asarray(jres.beam_ids))


def test_torch_random_starts_on_q8_tier(graph):
    """The q8 search with random starts (kernel 3's plain version on the
    CPU) equals the same search with the drawn starts given explicitly and
    finds most neighbours of a k-NN graph."""
    b = graph
    idx = pt.Index(points=b["tps"], graph=b["tg"]).enable_quantized(8)
    ids, dists, _ = idx.batch_search(b["Q"], k=K, beam_size=32, random_starts=1, seed=3)
    starts = np.random.default_rng(3).integers(0, N, (len(b["Q"]), 1))
    ids2, _, _ = idx.batch_search(b["Q"], k=K, beam_size=32, starts=starts)
    assert torch.equal(ids, ids2)
    gt = compute_groundtruth(b["tps"], b["Q"], 2 * K)
    assert compute_recall(ids.numpy(), *gt, K) >= 0.9


def search_recall(index_cls, points, graph, Q, gt, beam):
    ids = index_cls(points=points, graph=graph).batch_search(
        Q, k=K, beam_size=beam, random_starts=1, seed=0)[0]
    return compute_recall(np.asarray(ids), *gt, K)


def builds(metric, draws, quantize_build=False):
    """The JAX build and the port's, with ``draws`` (None: the port's own)."""
    tm, _ = METRICS[metric]
    X, Q = data()
    jps, jg = jax_build(metric, quantize_build)
    tps = PointSet.from_numpy(X, metric=tm, device="cpu")
    stats = {}
    tg, _ = pynndescent.build_pynndescent_graph(tps, BuildParams(**BP), draws=draws,
                                                quantize_build=quantize_build, stats=stats)
    gt = compute_groundtruth(tps, Q, 2 * K)
    return dict(Q=Q, jps=jps, jg=jg, tps=tps, tg=tg, gt=gt, stats=stats)


def cross_recalls(b, beam):
    tg, jg = b["tg"], b["jg"]
    tg_in_jax = JGraph.from_numpy(tg.neighbors.numpy(), tg.degrees.numpy(), n=tg.n)
    jg_in_torch = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                           jg.n, jg.max_degree, device="cpu")
    ref = search_recall(jpt.Index, b["jps"], jg, b["Q"], b["gt"], beam)
    return ref, {
        "torch/torch": search_recall(pt.Index, b["tps"], tg, b["Q"], b["gt"], beam),
        "torch/jax-graph": search_recall(pt.Index, b["tps"], jg_in_torch, b["Q"], b["gt"], beam),
        "jax/torch-graph": search_recall(jpt.Index, b["jps"], tg_in_jax, b["Q"], b["gt"], beam)}


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_pynn_build_matches_jax(metric):
    """The JAX draws replayed, f32 build: average degree within 0.5, recall@10
    at beam 10 with one random start within 0.01, on each package's graph
    and across; the rounds' changed counts are printed."""
    b = builds(metric, JaxDraws(0, T))
    j_avg, _ = b["jg"].stats()
    t_avg, t_max = b["tg"].stats()
    assert t_max <= KD and b["tg"].max_degree == KD
    assert abs(j_avg - t_avg) <= 0.5, (j_avg, t_avg)
    ref, recalls = cross_recalls(b, BEAM)
    print(f"{metric}: degree avg jax {j_avg:.3f} torch {t_avg:.3f}; changed "
          f"{b['stats']['changed']} polish {b['stats']['polish_changed']}; "
          f"recall@{K} beam {BEAM}: jax/jax {ref:.4f}", recalls)
    for name, r in recalls.items():
        assert abs(r - ref) <= 0.01, (name, r, ref)


def test_torch_pynn_q8_build_matches_jax():
    """``quantize_build=True`` with the JAX draws: every distance an integer
    on the q8 tier, so the graphs are equal row for row."""
    b = builds("l2", JaxDraws(0, T), quantize_build=True)
    tn, td = b["tg"].neighbors.numpy(), b["tg"].degrees.numpy()
    jn, jd = np.asarray(b["jg"].neighbors), np.asarray(b["jg"].degrees)
    np.testing.assert_array_equal(td, jd)
    mask = np.arange(KD)[None, :] < td[:, None]
    np.testing.assert_array_equal(np.where(mask, tn, -1), np.where(mask, jn, -1))


def test_torch_pynn_build_own_draws():
    """The port's own draws: degree within 1.0 and recall@10 within 0.03 of
    the JAX build at beam 24; the same seed gives the same graph."""
    b = builds("l2", None)
    j_avg, _ = b["jg"].stats()
    t_avg, _ = b["tg"].stats()
    assert abs(j_avg - t_avg) <= 1.0, (j_avg, t_avg)
    ref = search_recall(jpt.Index, b["jps"], b["jg"], b["Q"], b["gt"], 24)
    got = search_recall(pt.Index, b["tps"], b["tg"], b["Q"], b["gt"], 24)
    assert abs(got - ref) <= 0.03, (got, ref)
    again, _ = pynndescent.build_pynndescent_graph(b["tps"], BuildParams(**BP))
    assert torch.equal(again.neighbors, b["tg"].neighbors)


def test_torch_pynn_uint8_build_equals_float_copy():
    """uint8 points build on an exact float32 copy (kernel 2's f32 mode),
    with or without ``quantize_build`` (pyNNDescent quantizes float32 only):
    the graph equals the build on the float32 values; the PointSet stays
    uint8."""
    X, _ = data()
    U = np.round((X - X.min()) / (X.max() - X.min()) * 255).astype(np.uint8)
    kw = dict(max_deg=KD, num_clusters=T, cluster_size=S, device="cpu")
    gf, _, _ = pt.build_pynndescent_index(U.astype(np.float32), **kw)
    for qb in (False, True):
        gu, psu, _ = pt.build_pynndescent_index(U, quantize_build=qb, **kw)
        assert psu.data.dtype == torch.uint8
        assert torch.equal(gu.neighbors, gf.neighbors) and torch.equal(gu.degrees, gf.degrees)


def test_torch_pynn_api_validates_like_jax():
    X, _ = data()
    for kw in (dict(max_deg=0), dict(delta=0.0), dict(delta=1.0)):
        with pytest.raises(ValueError):
            pt.build_pynndescent_index(X, device="cpu", **kw)
        with pytest.raises(ValueError):
            jpt.build_pynndescent_index(X, **kw)
