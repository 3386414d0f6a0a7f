"""The benchmark's plain reference of the ClusterIndex
(``annbench/reference/cluster.py``) against the port, on the CPU.

The hierarchical build and the meta-routed seed are forced at 3,000 x 64
(``EXACT_LIMIT`` and ``ARGMIN_SEED_CUTOFF`` lowered, as
tests/test_torch_cluster_hier.py does); a small exact-path index takes the
argmin seed. Bars: the reference's ``faults`` read 0 on the port's
indexes; its search over the port's structure answers the ids the port's
``ClusterIndex.search`` answers, except where two of a row's distances tie
within 1e-5, and their distances agree to rtol 1e-5 (the port's rerank
sums 64 float32 squares, the reference in float64: float32's error is
at most 64 x 2^-24 = 3.8e-6 of the sum); the control, a 4-bit walk with a
TF32 rerank, departs from both.
"""

import numpy as np
import pytest
import torch

import parlayann_tpu_torch as pt
from parlayann_tpu_torch.build import clusterindex as tci
from parlayann_tpu_torch.ops.kernels import clusterbeam
from annbench.reference import cluster as ref

torch.set_num_threads(1)
K, RTOL = 10, 1e-5


def _state(ci):
    return dict(members=ci.members, adj=ci.adj, centroids=ci.centroids_q[:ci.C],
                seed=None if ci.seed_meta is None else tuple(ci.seed_meta), m=ci.m, Rc=ci.Rc)


@pytest.fixture(scope="module")
def indexes():
    from annbench import data

    X, Q = data.clustered(3000, 64, 200, 40, 0.35, 2**31 + 25, torch.device("cpu"))
    ps = pt.PointSet(data=X, n=3000, d=64, metric=pt.Metric.L2)
    mp = pytest.MonkeyPatch()
    mp.setattr(tci, "EXACT_LIMIT", 1.0)
    mp.setattr(clusterbeam, "ARGMIN_SEED_CUTOFF", 8)
    try:
        hier = pt.build_cluster_index(ps, m=32, Rc=16, slack=2.0, cand=8, ext_dtype="int8",
                                      seed=3)
    finally:
        mp.undo()
    exact = pt.build_cluster_index(ps, m=32, Rc=16, slack=2.0, cand=8, ext_dtype="int8",
                                   iters=3, seed=3)
    assert hier.seed_meta is not None and exact.seed_meta is None
    return dict(X=X, Q=Q, hier=hier, exact=exact)


def assert_ids_equal_but_ties(got_i, got_d, want_i, want_d):
    np.testing.assert_allclose(got_d, want_d, rtol=RTOL)
    for r in np.flatnonzero((got_i != want_i).any(axis=1)):
        s = np.sort(want_d[r])
        assert (np.diff(s) <= RTOL * np.abs(s[1:])).any(), (r, got_i[r], want_i[r])


@pytest.mark.parametrize("which", ["hier", "exact"])
def test_faults_zero_on_the_port_index(indexes, which):
    assert ref.faults(_state(indexes[which]), 3000) == 0


@pytest.mark.parametrize("which,n_probe,seed_probes", [
    ("hier", 8, 16), ("hier", 4, 4), ("hier", 2, 1), ("exact", 8, 16), ("exact", 3, 16)])
def test_reference_search_equals_the_port(indexes, monkeypatch, which, n_probe, seed_probes):
    monkeypatch.setattr(clusterbeam, "ARGMIN_SEED_CUTOFF", 8)
    ci, X, Q = indexes[which], indexes["X"], indexes["Q"]
    ids, dists, (nv, _) = ci.search(Q, k=K, n_probe=n_probe, min_probe=0, cut=0.0, starts=2,
                                    seed_probes=seed_probes, rerank_factor=2)
    assert (nv.numpy() <= n_probe).all()
    ri, rd = ref.search(X, 3000, Q, _state(ci), k=K, n_probe=n_probe, starts=2,
                        seed_probes=seed_probes, rerank_factor=2, block=64)
    ok = ri >= 0
    np.testing.assert_array_equal(ids.numpy() >= 0, ok)
    assert_ids_equal_but_ties(ids.numpy(), np.where(ok, dists.numpy(), 0),
                              ri, np.where(ok, rd, 0))


def test_the_control_departs(indexes):
    ci, X, Q = indexes["hier"], indexes["X"], indexes["Q"]
    kw = dict(k=K, n_probe=8, starts=2, seed_probes=16, rerank_factor=2)
    ri, rd = ref.search(X, 3000, Q, _state(ci), **kw)
    ci4, cd4 = ref.search(X, 3000, Q, _state(ci), bits=4, tf32=True, **kw)
    assert (ci4 != ri).any(axis=1).mean() > 0.2
    ok = (ri >= 0) & (ci4 >= 0)
    true = ((X[torch.from_numpy(ci4.clip(0))].double() - Q[:, None, :].double()) ** 2).sum(-1)
    err = np.abs(cd4 - true.numpy())[ok] / true.numpy()[ok].max()
    assert err.max() > 1e-4 and np.abs(rd - rd.astype(np.float32)).max() == 0


def test_faults_see_a_broken_structure(indexes):
    ci = indexes["hier"]
    st = _state(ci)
    mem = st["members"].copy()
    mem[0, 0] = mem[1, 0]  # one point twice, one in no cluster
    assert ref.faults(dict(st, members=mem), 3000) == 2
    adj = st["adj"].copy()
    adj[2, 0] = 2  # to itself
    assert ref.faults(dict(st, adj=adj), 3000) == 1
