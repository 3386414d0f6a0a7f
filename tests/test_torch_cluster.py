"""The ClusterIndex slice, port vs JAX package: the packed ext rows, the
capacity balancer, the cluster-beam search (kernel 5's plain version) over
a JAX-built index, and the port's own build against the JAX build.

Bars. Ext rows are byte-equal. ``balance_assign`` is equal. The search
over one index: probes and distance counts equal, the valid (distance, id)
results equal as sets, distances to rtol 1e-5 (both packages sum the same
f32 products in another order). The builds need not be identical (k-means
sums in another order on another device): the port's C equals the JAX
build's, its membership is a partition of the points with at most m per
cluster, and its recall@10 at 4 and 8 probes is within 0.01 of the JAX
build's, each searched by its own package.

The JAX searches call ``cluster_search_fused`` with DMA groups of 4 rows
(``G=4, n_buf=1``): the grouping is TPU scheduling and changes no result,
and it cuts the interpret-mode compile from ~10 s to ~3 s a search.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.build import clusterindex as jci
from parlayann_tpu.ops.pallas.clusterbeam import cluster_search_fused as jsearch

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.build import clusterindex as tci
from parlayann_tpu_torch.ops.kernels import clusterbeam
from parlayann_tpu_torch.search.exact import compute_groundtruth
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, M_, RC = 10, 32, 16


@pytest.fixture(scope="module")
def built():
    X, Q = synthetic.clustered(4000, 64, n_queries=64, n_clusters=50, seed=7)
    jps = JPointSet.from_numpy(X)
    j8 = jci.ClusterIndex.build(jps, m=M_, Rc=RC, iters=3, ext_dtype="int8")
    cents = jci._recenter(jps.data, j8.members, j8.C)
    jf = jci.ClusterIndex._finish(jps, j8.members, j8.adj, cents, j8.C, M_, RC,
                                  ext_dtype="f32")
    tps = interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d,
                                      jps.metric, device="cpu")
    q8 = j8.qpoints
    tq8 = interop.pointset_from_state(
        np.asarray(q8.data), q8.n, q8.d, q8.metric, bits=8,
        quant_slope=np.asarray(q8.quant_slope),
        quant_offset=np.asarray(q8.quant_offset), device="cpu")
    port_view = {
        "int8": interop.cluster_index_from_state(
            tps, j8.members, j8.adj, np.asarray(j8.centroids_q),
            np.asarray(j8.ext), j8.C, M_, RC, "int8", qpoints=tq8),
        "f32": interop.cluster_index_from_state(
            tps, jf.members, jf.adj, np.asarray(jf.centroids_q),
            np.asarray(jf.ext), jf.C, M_, RC, "f32"),
    }
    gt_i, gt_d = compute_groundtruth(tps, Q, 2 * K)
    return dict(X=X, Q=Q, jps=jps, tps=tps, jax={"int8": j8, "f32": jf},
                cents=np.array(cents), port_view=port_view, gt=(gt_i, gt_d))


def jax_search(ci, Q, *, n_probe, cut, min_probe=2, S=2):
    qp = ci.qpoints
    ids, dists, (nv, cmps) = jsearch(
        jnp.asarray(Q), ci.centroids_q, ci.ext, ci.points.data,
        None if qp is None else qp.quant_slope,
        None if qp is None else qp.quant_offset,
        metric=ci.points.metric, C=ci.C, m=ci.m, Rc=ci.Rc,
        n_points=ci.points.n, k=K, n_probe=n_probe, min_probe=min_probe,
        cut=cut, S=S, pool=2 * K, tier_bits=32 if qp is None else 8,
        rerank="tier" if ci.ext_dtype == "f32" else "full", G=4, n_buf=1)
    return [np.asarray(a) for a in (ids, dists, nv, cmps)]


@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cluster_ext_rows_byte_equal(built, layout):
    j = built["jax"][layout]
    tps = built["tps"]
    if layout == "int8":
        qd = torch.from_numpy(np.array(j.qpoints.data))
        cq = torch.from_numpy(np.array(j.centroids_q)[:j.C])
        ext = tci.build_cluster_ext(qd, j.members, j.adj, cq)
    else:
        ext = tci.build_cluster_ext_f32(tps.data[:tps.n], j.members, j.adj,
                                        torch.from_numpy(built["cents"]))
    want = np.asarray(j.ext)
    got = ext.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()


def test_torch_cluster_balance_assign_matches_jax(monkeypatch):
    """The JAX numpy balancer (its native twin is bit-identical), on random
    candidates with -1 holes and a capacity that forces the spill path."""
    from parlayann_tpu import native

    monkeypatch.setattr(native, "balance_assign", lambda *a, **kw: None)
    rng = np.random.default_rng(3)
    for n, C, m, k in ((5000, 100, 64, 8), (3000, 60, 50, 4)):
        ids = rng.integers(0, C, (n, k)).astype(np.int32)
        ids[rng.random((n, k)) < 0.05] = -1
        d = np.sort(rng.random((n, k)).astype(np.float32), axis=1)
        np.testing.assert_array_equal(tci.balance_assign(ids, d, C, m),
                                      jci.balance_assign(ids, d, C, m))


@pytest.mark.parametrize("cut", [0.0, 1.35], ids=["cut_off", "cut_on"])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cluster_search_over_jax_index(built, layout, cut):
    Q = built["Q"]
    ji, jd, jnv, jcm = jax_search(built["jax"][layout], Q, n_probe=8, cut=cut)
    ci = built["port_view"][layout]
    ti, td, (tnv, tcm) = ci.search(Q, k=K, n_probe=8, min_probe=2, cut=cut)
    ti, td = ti.numpy(), td.numpy()
    np.testing.assert_array_equal(tnv.numpy(), jnv)
    np.testing.assert_array_equal(tcm.numpy(), jcm)
    assert (tnv.numpy() <= 8).all() and (tnv.numpy() >= 1).all()
    for r in range(len(Q)):
        a = {int(i): float(x) for x, i in zip(td[r], ti[r]) if i >= 0}
        b = {int(i): float(x) for x, i in zip(jd[r], ji[r]) if i >= 0}
        assert a.keys() == b.keys(), r
        np.testing.assert_allclose([a[i] for i in sorted(a)],
                                   [b[i] for i in sorted(b)], rtol=1e-5)



@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cluster_search_over_jax_index_wide_beam(built, layout):
    """S = 8 seeds (the exact scan seed, not the argmin one) and n_probe =
    30, so the cluster beam is 64 lanes wide."""
    Q = built["Q"][:32]
    ji, jd, jnv, jcm = jax_search(built["jax"][layout], Q, n_probe=30, cut=0.0,
                                  min_probe=0, S=8)
    assert clusterbeam.walk_sizes(30, 8)[1] == 64
    ti, td, (tnv, tcm) = built["port_view"][layout].search(
        Q, k=K, n_probe=30, min_probe=0, cut=0.0, starts=8)
    np.testing.assert_array_equal(tnv.numpy(), jnv)
    np.testing.assert_array_equal(tcm.numpy(), jcm)
    assert (jnv > 8).any()
    for r in range(len(Q)):
        a = {int(i): float(x) for x, i in zip(td[r].numpy(), ti[r].numpy()) if i >= 0}
        b = {int(i): float(x) for x, i in zip(jd[r], ji[r]) if i >= 0}
        assert a.keys() == b.keys(), r
        np.testing.assert_allclose([a[i] for i in sorted(a)],
                                   [b[i] for i in sorted(b)], rtol=1e-5)


def test_torch_cluster_build_parity(built):
    """The port's own build on the same data, against the JAX build."""
    X, Q = built["X"], built["Q"]
    gt_i, gt_d = built["gt"]
    j8 = built["jax"]["int8"]
    ci = pt.build_cluster_index(X, m=M_, Rc=RC, iters=3, ext_dtype="int8",
                                device="cpu")
    assert ci.C == j8.C and ci.ext.shape == j8.ext.shape
    mem = ci.members[ci.members >= 0]
    assert len(mem) == len(X) and len(np.unique(mem)) == len(X)
    assert ((ci.members >= 0).sum(axis=1) <= M_).all()
    assert ci.adj.shape == (ci.C, RC) and (ci.adj < ci.C).all()
    assert not (ci.adj == np.arange(ci.C)[:, None]).any()
    for n_probe in (4, 8):
        ji, _, _, _ = jax_search(j8, Q, n_probe=n_probe, cut=0.0)
        ti, _, (nv, _) = ci.search(Q, k=K, n_probe=n_probe, cut=0.0)
        r_jax = compute_recall(ji, gt_i, gt_d, K)
        r_port = compute_recall(ti.numpy(), gt_i, gt_d, K)
        assert abs(r_port - r_jax) <= 0.01, (n_probe, r_port, r_jax)
        assert (nv.numpy() <= n_probe).all()
        for row in ti.numpy():
            v = row[row >= 0]
            assert len(np.unique(v)) == len(v)


def test_torch_cluster_f32_layout_scores_are_exact(built):
    """The auto layout at this size is f32, whose pool scores are the true
    squared distances (no rerank)."""
    X, Q = built["X"], built["Q"]
    gt_i, gt_d = built["gt"]
    ci = pt.build_cluster_index(X, m=M_, Rc=RC, iters=3, device="cpu")
    assert ci.ext_dtype == "f32" and ci.qpoints is None
    ids, dists, _ = ci.search_timed(Q, k=K, n_probe=8, cut=0.0)[:3]
    ids, dists = ids.numpy(), dists.numpy()
    assert compute_recall(ids, gt_i, gt_d, K) >= 0.93
    ok = ids >= 0
    true = ((X[ids.clip(0)] - Q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    np.testing.assert_allclose(dists[ok], true[ok], rtol=1e-5)


def test_torch_cluster_mips_smoke():
    X, Q = synthetic.clustered(4000, 64, n_queries=32, n_clusters=40,
                               cluster_std=0.35, seed=3)
    ps = PointSet.from_numpy(X, metric=Metric.MIPS, device="cpu")
    ci = tci.ClusterIndex.build(ps, m=64, Rc=16, iters=2)
    gt_i, gt_d = compute_groundtruth(ps, Q, K)
    ids, _, _ = ci.search(Q, k=K, n_probe=12, cut=0.0)
    assert compute_recall(ids.numpy(), gt_i, gt_d, K) >= 0.85


@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cluster_save_load_round_trip(built, layout, tmp_path):
    """The port loads the JAX package's saved index (the same npz keys):
    its ext rows equal the JAX index's and its search the JAX search; the
    port's own save and load give the same index back."""
    j = built["jax"][layout]
    j.save(str(tmp_path / "jax.npz"))
    ci = tci.ClusterIndex.load(str(tmp_path / "jax.npz"), built["tps"])
    assert (ci.C, ci.m, ci.Rc, ci.ext_dtype) == (j.C, j.m, j.Rc, layout)
    np.testing.assert_array_equal(ci.members, j.members)
    want_ext = np.asarray(j.ext)
    if layout == "int8":
        assert ci.ext.numpy().tobytes() == want_ext.tobytes()
    else:  # centroids summed in another order: their lanes agree to rtol 1e-6
        np.testing.assert_allclose(ci.ext.numpy(), want_ext, rtol=1e-6, atol=1e-6)
    Q = built["Q"]
    ji, jd, jnv, jcm = jax_search(j, Q, n_probe=8, cut=0.0)
    ti, td, (tnv, tcm) = ci.search(Q, k=K, n_probe=8, min_probe=2, cut=0.0)
    np.testing.assert_array_equal(tnv.numpy(), jnv)
    np.testing.assert_array_equal(tcm.numpy(), jcm)
    for r in range(len(Q)):
        a = {int(i): float(x) for x, i in zip(td[r].numpy(), ti[r].numpy()) if i >= 0}
        b = {int(i): float(x) for x, i in zip(jd[r], ji[r]) if i >= 0}
        assert a.keys() == b.keys(), r
        np.testing.assert_allclose([a[i] for i in sorted(a)], [b[i] for i in sorted(b)],
                                   rtol=1e-5)
    ci.save(str(tmp_path / "port"))  # np.savez appends .npz; load finds it
    back = tci.ClusterIndex.load(str(tmp_path / "port"), built["tps"])
    assert torch.equal(back.ext, ci.ext) and torch.equal(back.centroids_q, ci.centroids_q)
    ids, dists, _ = back.search(Q, k=K, n_probe=8, cut=0.0)
    assert torch.equal(ids, ti) and torch.equal(dists, td)
    with pytest.raises(ValueError, match="built on n="):
        tci.ClusterIndex.load(str(tmp_path / "port"), PointSet.from_numpy(
            built["X"][:100], device="cpu"))


def test_torch_cluster_stream_seed_and_hier_build_run(built, monkeypatch):
    """The two calls that raised until the hierarchical build and the meta
    seed were ported now run: the argmin seed past the cutoff, on an index
    with no seed quantizer, takes the streamed exact seed (as the JAX
    package does), and a build past ``EXACT_LIMIT`` builds hierarchically
    (tests/test_torch_cluster_hier.py holds both to the JAX package)."""
    ci = built["port_view"]["int8"]
    monkeypatch.setattr(clusterbeam, "ARGMIN_SEED_CUTOFF", 8)
    ids, dists, _ = ci.search(built["Q"][:4], k=K)
    sids, sdists, _ = ci.search(built["Q"][:4], k=K, seed_mode="stream")
    assert (ids.numpy() >= 0).all()
    assert torch.equal(ids, sids) and torch.equal(dists, sdists)
    monkeypatch.setattr(tci, "EXACT_LIMIT", 1e3)
    partitions = []
    real = tci.drop_empty

    def spy(members, cents, adj=None):
        partitions.append(members)
        return real(members, cents, adj)

    monkeypatch.setattr(tci, "drop_empty", spy)
    hier = tci.ClusterIndex.build(built["tps"], m=M_, Rc=RC)
    mem = hier.members[hier.members >= 0]
    # the JAX build's C counts the clusters the partition starts from; the
    # port leaves out those that end it empty (two here, PARITY.md)
    n_empty = int((partitions[0] < 0).all(axis=1).sum())
    assert partitions[0].shape[0] == built["jax"]["int8"].C and n_empty == 2
    assert hier.C == built["jax"]["int8"].C - n_empty
    assert (hier.members >= 0).any(axis=1).all()
    assert len(mem) == built["tps"].n and len(np.unique(mem)) == built["tps"].n
    assert ((hier.members >= 0).sum(1) <= M_).all()


def test_torch_cluster_api_validation():
    X = np.random.default_rng(0).normal(size=(500, 64)).astype(np.float32)
    with pytest.raises(ValueError):
        pt.build_cluster_index(X, m=63, device="cpu")  # not a multiple of 8
    with pytest.raises(ValueError):
        pt.build_cluster_index(X, m=128, device="cpu")  # d < m
    with pytest.raises(ValueError):
        pt.build_cluster_index(X, metric="cosine", device="cpu")
    ci = pt.build_cluster_index(X, m=32, Rc=8, iters=2, device="cpu")
    assert ci.C >= 8
