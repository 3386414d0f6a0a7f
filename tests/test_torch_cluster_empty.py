"""Clusters with no member, which the JAX package keeps with zero
centroids: the port leaves them out (``clusterindex.drop_empty``), so no
seed or walk reaches one: the clusters a walk expands all hold members,
and a query gets k distinct ids wherever they hold k between them.

Two ways in: ``_finish`` given a state with empty member rows (zero
centroids, adjacency made over all of them as the JAX build makes it), and
the hierarchical build forced at a size where its partition leaves two
clusters empty. A query at the origin is the one the zero centroids
capture: seeded among them, its walk finds no member.
"""

import numpy as np
import pytest
import torch

import parlayann_tpu_torch as pt
from parlayann_tpu_torch.build import clusterindex as tci
from parlayann_tpu_torch.ops.kernels import clusterbeam
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, M_, RC = 10, 16, 8
EMPTY = 24  # more than a walk's n_probe + 4 beam lanes can hold


@pytest.fixture(scope="module")
def state():
    """A small exact-path index's structure with EMPTY clusters put in at
    spread positions: no member, a zero centroid, and the adjacency of
    every cluster made again over all the centroids."""
    X, Q = synthetic.clustered(2000, 32, n_queries=40, n_clusters=20, cluster_std=0.35,
                               seed=3)
    ps = pt.PointSet.from_numpy(X, device="cpu")
    ci = pt.build_cluster_index(ps, m=M_, Rc=RC, iters=2, ext_dtype="int8", device="cpu")
    C = ci.C + EMPTY
    where = np.sort(np.random.default_rng(0).choice(C, EMPTY, replace=False))
    real = np.setdiff1d(np.arange(C), where)
    members = np.full((C, M_), -1, np.int32)
    members[real] = ci.members
    cents = torch.zeros((C, 32))
    cents[torch.from_numpy(real)] = tci._recenter(ps.data, ci.members, ci.C)
    aid, _ = tci._assign_all(cents, C, cents, C, RC + 1, Metric.L2)
    adj = np.where(aid == np.arange(C)[:, None], -1, aid)
    adj = np.take_along_axis(adj, np.argsort(adj < 0, axis=1, kind="stable"), 1)[:, :RC]
    Q = np.concatenate([np.zeros((1, 32), np.float32), Q])  # the origin first
    return dict(ps=ps, Q=Q, members=members, adj=np.ascontiguousarray(adj, np.int32),
                cents=cents, C=C, real=real, where=where)


def _k_distinct(ids, n):
    ids = ids.numpy()
    assert ((ids >= 0) & (ids < n)).all()
    assert all(len(np.unique(r)) == len(r) for r in ids)


def _reachable_all_have_members(ci):
    assert ci.members.shape[0] == ci.C and (ci.members >= 0).any(axis=1).all()
    a = ci.adj[ci.adj >= 0]
    assert (a < ci.C).all()
    if ci.seed_meta is not None:
        ids = ci.seed_meta[2].numpy()
        assert np.array_equal(np.sort(ids[ids >= 0]), np.arange(ci.C))


def test_the_zero_centroids_capture_a_query(state):
    """As the JAX package keeps them, the empty clusters fill real
    clusters' adjacency and the origin's query gets no result."""
    s = state
    assert np.isin(s["adj"][s["real"]], s["where"]).any()
    ext = tci.build_cluster_ext_f32(s["ps"].data[:s["ps"].n], s["members"], s["adj"],
                                    s["cents"])
    cq = torch.nn.functional.pad(s["cents"], (0, 0, 0, tci._c_pad(s["C"]) - s["C"]))
    kept = tci.ClusterIndex(points=s["ps"], qpoints=None, centroids_q=cq,
                            members=s["members"], adj=s["adj"], ext=ext, C=s["C"], m=M_,
                            Rc=RC, ext_dtype="f32")
    ids, _, _ = kept.search(s["Q"], k=K, n_probe=8, cut=0.0)
    assert (ids[0] < 0).all()


@pytest.mark.parametrize("layout", ["int8", "f32"])
@pytest.mark.parametrize("seed_meta", [False, True])
def test_finish_drops_empty_clusters(state, monkeypatch, layout, seed_meta):
    s = state
    if seed_meta:  # the meta-routed seed, over the kept centroids
        monkeypatch.setattr(clusterbeam, "ARGMIN_SEED_CUTOFF", 8)
    ci = tci.ClusterIndex._finish(s["ps"], s["members"], s["adj"], s["cents"], s["C"], M_,
                                  RC, ext_dtype=layout)
    assert ci.C == s["C"] - EMPTY and (ci.seed_meta is not None) == seed_meta
    np.testing.assert_array_equal(ci.members, s["members"][s["real"]])
    _reachable_all_have_members(ci)
    # each row keeps its real neighbours, renumbered, in order
    new = {int(c): i for i, c in enumerate(s["real"])}
    for i, c in enumerate(s["real"]):
        want = [new[int(a)] for a in s["adj"][c] if a >= 0 and int(a) in new]
        got = ci.adj[i]
        assert list(got[got >= 0]) == want and (got[len(want):] == -1).all()
    for n_probe in (4, 8):  # clusters of ~11 members: k within four
        ids, dists, _ = ci.search(s["Q"], k=K, n_probe=n_probe, cut=0.0)
        _k_distinct(ids, s["ps"].n)
        assert torch.isfinite(dists).all()


def test_save_load_round_trip_after_the_drop(state, tmp_path):
    s = state
    ci = tci.ClusterIndex._finish(s["ps"], s["members"], s["adj"], s["cents"], s["C"], M_,
                                  RC, ext_dtype="int8")
    ci.save(str(tmp_path / "ci"))
    back = tci.ClusterIndex.load(str(tmp_path / "ci"), s["ps"])
    assert (back.C, back.m, back.Rc) == (ci.C, ci.m, ci.Rc)
    np.testing.assert_array_equal(back.members, ci.members)
    np.testing.assert_array_equal(back.adj, ci.adj)
    assert torch.equal(back.ext, ci.ext) and torch.equal(back.centroids_q, ci.centroids_q)
    for a, b in zip(ci.search(s["Q"], k=K, n_probe=8, cut=0.0)[:2],
                    back.search(s["Q"], k=K, n_probe=8, cut=0.0)[:2]):
        assert torch.equal(a, b)


def test_drop_empty_keeps_a_full_partition():
    members = np.arange(12, dtype=np.int32).reshape(3, 4)
    cents = torch.randn(3, 5)
    adj = np.array([[1, 2], [0, 2], [0, 1]], np.int32)
    got = tci.drop_empty(members, cents, adj)
    assert got[0] is members and got[1] is cents and got[2] is adj


def test_hierarchical_build_drops_its_empty_clusters(monkeypatch, tmp_path):
    """The forced hierarchical build at 4,000 x 64 (m = 32, C = 188) leaves
    two clusters empty: the index holds the 186 others."""
    X, Q = synthetic.clustered(4000, 64, n_queries=64, n_clusters=50, seed=7)
    ps = pt.PointSet.from_numpy(X, device="cpu")
    monkeypatch.setattr(tci, "EXACT_LIMIT", 1e3)
    monkeypatch.setattr(clusterbeam, "ARGMIN_SEED_CUTOFF", 8)
    emptied = []
    real = tci.drop_empty

    def spy(members, cents, adj=None):
        emptied.append(int((members < 0).all(axis=1).sum()))
        return real(members, cents, adj)

    monkeypatch.setattr(tci, "drop_empty", spy)
    ci = tci.ClusterIndex.build(ps, m=32, Rc=16, slack=1.5, ext_dtype="int8")
    assert emptied[0] == 2 and emptied[1:] == [0]  # before the adjacency; _finish's
    assert ci.C == 188 - 2
    got = ci.members[ci.members >= 0]
    assert len(got) == 4000 and len(np.unique(got)) == 4000
    _reachable_all_have_members(ci)
    ids, _, (nv, _) = ci.search(Q, k=K, n_probe=8, cut=0.0, seed_probes=8)
    _k_distinct(ids, 4000)
    assert (nv.numpy() == 8).all()
    ci.save(str(tmp_path / "hier"))
    back = tci.ClusterIndex.load(str(tmp_path / "hier"), ps)
    assert back.C == ci.C and torch.equal(back.ext, ci.ext)
    assert torch.equal(back.search(Q, k=K, n_probe=8, cut=0.0, seed_probes=8)[0], ids)
