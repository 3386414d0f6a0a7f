"""The other Vamana build modes, port vs JAX package, on the CPU:
``single_batch``, ``cand_mode="exact"`` and the ``profile`` split.

Both packages build on the same q8 points with the same seed. On int8 data
every distance is an exact integer, and the builds replay the JAX
package's draws (the initial edges, the pass permutations, the sample
ladder). The single-batch build equals the JAX build row for row. The
exact build's top-k orders tied distances by id, where the JAX package's
``approx_min_k`` leaves ties in its own order, so its rows are held to a
share of equal rows. Both are held to the builder bar of ROADMAP (average
degree within 0.5, recall@10 at a fixed beam within 0.01) through the
port's own q8 search.
"""

import numpy as np
import pytest
import torch

import parlayann_tpu as jpt
from parlayann_tpu.build import vamana as jvamana
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.types import BuildParams as JBuildParams

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.build import vamana
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.types import BuildParams
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, BEAM = 10, 10


@pytest.fixture(scope="module")
def data():
    X, Q = synthetic.clustered(1500, 32, n_queries=64, n_clusters=24,
                               cluster_std=0.35, seed=3)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :2 * K]
    jq8 = jquantize.quantize_pointset(JPointSet.from_numpy(X), bits=8)
    ps = PointSet.from_numpy(X, device="cpu")
    return dict(X=X, Q=Q, gt=gt, gt_d=np.take_along_axis(d64, gt, 1), jq8=jq8, ps=ps,
                q8=quantize.quantize_pointset(ps, bits=8))


def _recall(graph, b):
    idx = pt.Index(points=b["ps"], graph=graph).enable_quantized(bits=8)
    ids, _, _ = idx.batch_search(b["Q"], k=K, beam_size=BEAM)
    return compute_recall(ids.numpy(), b["gt"], b["gt_d"], K)


def _hold_to_jax(b, jg, tg, min_equal_rows):
    """At least ``min_equal_rows`` of the rows equal to the JAX graph's;
    degrees and recall within the bar."""
    jn, jd = np.asarray(jg.neighbors), np.asarray(jg.degrees)
    tn, td = tg.neighbors.numpy(), tg.degrees.numpy()
    same = np.mean([jd[i] == td[i] and np.array_equal(jn[i, :jd[i]], tn[i, :td[i]])
                    for i in range(jg.n)])
    print(f"identical rows {same:.4f}")
    assert same >= min_equal_rows
    assert abs(jg.stats()[0] - tg.stats()[0]) <= 0.5
    jgraph = interop.graph_from_state(jn, jd, jg.n, jg.max_degree, device="cpu")
    assert abs(_recall(tg, b) - _recall(jgraph, b)) <= 0.01


@pytest.mark.parametrize("mode", ["single_batch", "exact"])
def test_torch_vamana_mode_matches_jax(data, mode):
    """A single-batch build (8 random initial edges a row, one batch of n a
    pass, each point's search from itself) equals the JAX build row for
    row; an exact-candidate build (the inserted prefix's exact top-k and
    the out-edges) keeps at least 99% of its rows; both count the JAX
    build's visits and distances."""
    kw = dict(R=16, L=32, alpha=1.2, num_passes=2)
    if mode == "single_batch":
        jbp, bp, cm = JBuildParams(single_batch=8, **kw), BuildParams(single_batch=8, **kw), "beam"
    else:
        jbp, bp, cm = JBuildParams(**kw), BuildParams(**kw), "exact"
    jg, js = jvamana.build_vamana_graph(data["jq8"], jbp, cand_mode=cm)
    tg, ts = vamana.build_vamana_graph(data["q8"], bp, cand_mode=cm)
    _hold_to_jax(data, jg, tg, 1.0 if mode == "single_batch" else 0.99)
    assert (ts.total_visited, ts.total_cmps) == (js.total_visited, js.total_cmps)
    assert _recall(tg, data) >= (0.85 if mode == "single_batch" else 0.8)


def test_torch_vamana_exact_samples_match_jax(data):
    """The waypoint sample ladder of an exact build at n = 40,000: the same
    sizes and ids as the JAX package's, from the same generator."""
    pts = torch.zeros((40_000, 2))
    ours = vamana._scale_samples(40_000, np.random.default_rng(7919), pts)
    theirs = jvamana._scale_samples(40_000, np.random.default_rng(7919),
                                    np.zeros((40_000, 2), np.float32))
    assert [len(s[0]) for s in ours] == [8192, 2048, 512]
    assert len(ours) == len(theirs)
    for (ti, td), (ji, _) in zip(ours, theirs):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        assert td.shape == (len(ti), 2)
    assert vamana._scale_samples(8191, np.random.default_rng(0), pts) == []


def test_torch_vamana_exact_with_samples(data):
    """An exact build past 8192 points runs the sample ladder (here samples
    of 2048 and 512 rows, on the plain scan): a navigable graph."""
    X, Q = synthetic.clustered(8200, 8, n_queries=32, n_clusters=40,
                               cluster_std=0.35, seed=5)
    g, ps, stats = pt.build_vamana_index(X, R=12, L=24, alpha=1.2, device="cpu",
                                         batch_cap_frac=0.25, cand_mode="exact")
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :2 * K]
    ids, _, _ = pt.Index(points=ps, graph=g).enable_quantized(bits=8).batch_search(
        Q, k=K, beam_size=32)
    assert compute_recall(ids.numpy(), gt, np.take_along_axis(d64, gt, 1), K) >= 0.9
    assert stats.total_cmps > 0 and g.stats()[1] <= 12


def test_torch_vamana_profile_split(data):
    """profile=True builds the same graph as the unprofiled build, and its
    beam, bidirect and prune seconds sum to at most the build's; the
    one-batch split leaves the graph as it was."""
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2)
    g0, s0 = vamana.build_vamana_graph(data["q8"], bp)
    g1, s1 = vamana.build_vamana_graph(data["q8"], bp, profile=True)
    assert torch.equal(g0.neighbors, g1.neighbors) and torch.equal(g0.degrees, g1.degrees)
    assert (s0.beam_time, s0.bidirect_time, s0.prune_time) == (0.0, 0.0, 0.0)
    parts = (s1.beam_time, s1.bidirect_time, s1.prune_time)
    assert all(t > 0 for t in parts) and sum(parts) <= s1.build_time
    before = g1.neighbors.clone()
    split = vamana.profile_one_batch(data["q8"], bp, g1, repeats=1)
    assert len(split) == 3 and all(t > 0 for t in split)
    assert torch.equal(g1.neighbors, before)


def test_torch_vamana_build_stats_fields_match_jax():
    assert vamana.BuildStats._fields == jvamana.BuildStats._fields


@pytest.mark.parametrize("kw", [dict(single_batch=8), dict(cand_mode="exact"),
                                dict(profile=True)], ids=["single_batch", "exact", "profile"])
def test_torch_vamana_api_passes_modes(data, kw):
    """api.build_vamana_index passes the build modes on, as the JAX
    package's keyword arguments do; each build is navigable (recall@10 at
    beam 10 of the exact build on this set: 0.87)."""
    g, ps, stats = pt.build_vamana_index(data["X"], R=16, L=32, alpha=1.2,
                                         device="cpu", **kw)
    assert _recall(g, data) >= 0.8
    assert (stats.beam_time > 0) == bool(kw.get("profile"))
