"""The Vamana q8 slice end to end, port vs JAX package: build_vamana_index
then q8 Index.batch_search, on the same data and seed.

The bar (ROADMAP, parity bar for builders): average degree within 0.5 of
the JAX graph's, recall@10 at a fixed beam within 0.01, and each package's
searcher run over the other's graph (through interop) held to the same
bar. On int8 data every distance is an exact integer, so the two builds are
expected to agree row for row; the fraction of identical rows is printed.
"""

import numpy as np
import pytest
import torch

import parlayann_tpu as jpt
from parlayann_tpu.data.graph import GraphIndexData as JGraph

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.build import vamana
from parlayann_tpu_torch.types import BuildParams
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, BEAM = 10, 10


@pytest.fixture(scope="module")
def built():
    X, Q = synthetic.clustered(1500, 32, n_queries=64, n_clusters=24,
                               cluster_std=0.35, seed=3)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :2 * K]
    gt_d = np.take_along_axis(d64, gt, 1)
    jg, jps, jstats = jpt.build_vamana_index(X, R=16, L=32, alpha=1.2)
    tg, tps, stats = pt.build_vamana_index(X, R=16, L=32, alpha=1.2,
                                           device="cpu")
    return dict(X=X, Q=Q, gt=gt, gt_d=gt_d, jg=jg, jps=jps, tg=tg, tps=tps,
                jstats=jstats, stats=stats)


def _recall(ids, b):
    return compute_recall(np.asarray(ids), b["gt"], b["gt_d"], K)


def test_torch_slice_graph_matches_jax(built):
    jg, tg = built["jg"], built["tg"]
    j_avg, j_max = jg.stats()
    t_avg, t_max = tg.stats()
    assert abs(j_avg - t_avg) <= 0.5, (j_avg, t_avg)
    assert t_max <= 16
    # same batches (pad rows included), same searches: same counts
    js, ts = built["jstats"], built["stats"]
    assert (ts.total_visited, ts.total_cmps) == (js.total_visited, js.total_cmps)
    jn, jd = np.asarray(jg.neighbors), np.asarray(jg.degrees)
    tn, td = tg.neighbors.numpy(), tg.degrees.numpy()
    same = np.mean([jd[i] == td[i] and np.array_equal(jn[i, :jd[i]], tn[i, :td[i]])
                    for i in range(jg.n)])
    print(f"degree avg jax {j_avg:.3f} torch {t_avg:.3f}; identical rows {same:.4f}")
    # each row is duplicate-free and in range (the fused kernel's contract)
    for i in range(tg.n):
        row = tn[i, :td[i]]
        assert len(set(row.tolist())) == len(row) and (row >= 0).all() and (row < tg.n).all()


@pytest.mark.parametrize("entry_min_n", [20_000, 0], ids=["start_point", "entry_tier"])
def test_torch_slice_search_matches_jax(built, entry_min_n):
    """Recall@10 at beam 10 within 0.01 of the JAX package's, on each
    package's own graph and on the other package's graph."""
    b = built
    Q = b["Q"]
    jg, tg = b["jg"], b["tg"]
    tg_in_jax = JGraph.from_numpy(tg.neighbors.numpy(), tg.degrees.numpy(),
                                  n=tg.n)
    jg_in_torch = interop.graph_from_state(
        np.asarray(jg.neighbors), np.asarray(jg.degrees), jg.n, jg.max_degree,
        device="cpu")

    def jax_search(graph):
        idx = jpt.Index(points=b["jps"], graph=graph, entry_min_n=entry_min_n)
        ids, _, _ = idx.enable_quantized(bits=8).batch_search(Q, k=K, beam_size=BEAM)
        return np.asarray(ids), idx

    def torch_search(graph):
        idx = pt.Index(points=b["tps"], graph=graph, entry_min_n=entry_min_n)
        ids, dists, res = idx.enable_quantized(bits=8).batch_search(
            Q, k=K, beam_size=BEAM)
        assert ids.shape == (len(Q), K) and torch.isfinite(dists).all()
        return ids.numpy()

    j_ids, j_idx = jax_search(jg)
    ref = _recall(j_ids, b)
    recalls = {
        "torch/torch": _recall(torch_search(tg), b),
        "torch/jax-graph": _recall(torch_search(jg_in_torch), b),
        "jax/torch-graph": _recall(jax_search(tg_in_jax)[0], b),
    }
    print(f"recall@{K} beam {BEAM}: jax/jax {ref:.4f}", recalls)
    for name, r in recalls.items():
        assert abs(r - ref) <= 0.01, (name, r, ref)
    if entry_min_n == 0:
        # the JAX Index's entry tier carried over through interop
        idx = interop.index_from_state(
            interop.pointset_from_state(
                np.asarray(b["jps"].data), b["jps"].n, b["jps"].d, b["jps"].metric,
                device="cpu"),
            jg_in_torch, entry_ids=np.asarray(j_idx.entry_ids))
        idx.entry_min_n = 0
        ids, _, _ = idx.enable_quantized(bits=8).batch_search(Q, k=K, beam_size=BEAM)
        assert abs(_recall(ids.numpy(), b) - ref) <= 0.01
        np.testing.assert_array_equal(idx.entry_ids.numpy(),
                                      np.asarray(j_idx.entry_ids))


@pytest.mark.parametrize("kw", [
    dict(two_phase=False, expand_group=4, seed=3),
    dict(two_phase=True, expand_group=2, seed=0),
], ids=["one_phase", "two_phase"])
def test_torch_slice_reference_keywords_match_jax(built, kw):
    """Index.batch_search takes the JAX package's two_phase, expand_group
    and seed keywords: on the same graph and q8 tier both packages return
    the same ids with them, and the port the same ids as without them."""
    b = built
    Q, jg = b["Q"], b["jg"]
    graph = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                     jg.n, jg.max_degree, device="cpu")
    jidx = jpt.Index(points=b["jps"], graph=jg).enable_quantized(bits=8)
    tidx = pt.Index(points=b["tps"], graph=graph).enable_quantized(bits=8)
    want = np.asarray(jidx.batch_search(Q, k=K, beam_size=BEAM, **kw)[0])
    ids = tidx.batch_search(Q, k=K, beam_size=BEAM, **kw)[0]
    np.testing.assert_array_equal(ids.numpy(), want)
    assert torch.equal(ids, tidx.batch_search(Q, k=K, beam_size=BEAM)[0])


def test_torch_slice_unported_configurations_raise(built):
    """The configurations this test once saw refused all run now. (The f32
    tier, expand > 1, degree_limit < R and ``quantize_build=False`` are
    served and held to the JAX package in tests/test_torch_f32.py;
    ``random_starts`` is served too: here the q8 search from random starts
    returns the JAX package's ids on the JAX graph, and
    tests/test_torch_pynndescent.py holds the draws. ``single_batch`` builds
    are held to the JAX builds in tests/test_torch_vamana_modes.py; here one
    builds on the f32 points and reaches the JAX test's floor, 0.85 at beam
    40, tests/test_vamana.py:127-146.)"""
    b = built
    jg = b["jg"]
    graph = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                     jg.n, jg.max_degree, device="cpu")
    idx = pt.Index(points=b["tps"], graph=graph).enable_quantized(bits=8)
    jidx = jpt.Index(points=b["jps"], graph=jg).enable_quantized(bits=8)
    kw = dict(k=K, beam_size=BEAM, random_starts=2, seed=4)
    np.testing.assert_array_equal(idx.batch_search(b["Q"][:16], **kw)[0].numpy(),
                                  np.asarray(jidx.batch_search(b["Q"][:16], **kw)[0]))
    sg, _ = vamana.build_vamana_graph(built["tps"], BuildParams(R=16, L=32, alpha=1.2,
                                                               num_passes=2, single_batch=8))
    assert sg.stats()[0] > 4
    sidx = pt.Index(points=b["tps"], graph=sg).enable_quantized(bits=8)
    assert _recall(sidx.batch_search(b["Q"], k=K, beam_size=40)[0].numpy(), b) >= 0.85


def test_torch_slice_entry_cache_is_not_clobbered(built):
    """index.py:323-331: a caller-built entry tier survives batch_search."""
    idx = pt.Index(points=built["tps"], graph=built["tg"], entry_min_n=0)
    idx.enable_quantized(bits=8).build_entry_cache(E=64, seed=5)
    ids_before = idx.entry_ids.clone()
    idx.batch_search(built["Q"][:8], k=K, beam_size=BEAM)
    assert torch.equal(idx.entry_ids, ids_before) and idx.entry_ids.shape[0] == 64


def test_torch_slice_q8_tier_state_carries_over(built):
    """The JAX q8 tier, through interop, is the port's own q8 tier."""
    jq = jpt.Index(points=built["jps"], graph=built["jg"]).enable_quantized(8).qpoints
    tq = pt.Index(points=built["tps"], graph=built["tg"]).enable_quantized(8).qpoints
    moved = interop.pointset_from_state(
        np.asarray(jq.data), jq.n, jq.d, jq.metric, bits=jq.bits,
        quant_slope=np.asarray(jq.quant_slope), quant_offset=np.asarray(jq.quant_offset),
        device="cpu")
    assert torch.equal(moved.data, tq.data) and moved.bits == tq.bits == 8
    assert (moved.n, moved.d, moved.metric) == (tq.n, tq.d, tq.metric)
    assert torch.equal(moved.quant_slope, tq.quant_slope)
    assert torch.equal(moved.quant_offset, tq.quant_offset)


def test_torch_slice_single_search_and_check_recall(built):
    idx = pt.Index(points=built["tps"], graph=built["tg"]).enable_quantized(8)
    Q = built["Q"]
    ids, dists, _ = idx.batch_search(Q, k=K, beam_size=BEAM)
    one_ids, one_d = idx.single_search(Q[3], k=K, beam_size=BEAM)
    np.testing.assert_array_equal(one_ids, ids[3].numpy())
    np.testing.assert_array_equal(one_d, dists[3].numpy())
    r = idx.check_recall(Q, built["gt"], built["gt_d"], k=K, beam_size=BEAM)
    assert r == _recall(ids.numpy(), built)
