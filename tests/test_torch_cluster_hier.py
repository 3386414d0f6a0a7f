"""The hierarchical ClusterIndex, port vs JAX package: the meta quantizer,
``approx_assign``, the teleport, the polish, the routed respill, the whole
hierarchical build, the meta-routed query seed and the native balancer.

The same numpy inputs go through both packages. Bars: ``_meta_sizes`` and
the balancers equal; a quantizer's ``idtab`` equal and its centroids
within rtol 1e-5 (absolute 1e-6 for the means' near-zero components: the
two packages sum a mean in another order); ``approx_assign``'s
distances within rtol 1e-5 and its ids equal but where the k-th
distances tie within that tolerance. The builds need not be identical
(their k-means sums run in another order): C equal, the membership a
partition with at most m a cluster, and recall@10 at n_probe 4 and 8
within 0.01 of the JAX build's, each searched by its own package (the
builder bar of tests/test_torch_cluster.py). The hierarchical branch is
forced in JAX by ``PARLAYANN_KMEANS_EXACT_LIMIT`` and in the port by its
``EXACT_LIMIT``. The JAX build's partition is L2 whatever the index's
metric, and its layout is only ``_finish``'s, so the JAX package builds
once and packs the other layout and the MIPS index from that partition;
the port builds each of the four.

The JAX searches call ``cluster_search_fused`` with ``G=4, n_buf=1`` (TPU
scheduling, no change in results; a shorter interpret-mode compile).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu import native as jnative
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.types import Metric as JMetric
from parlayann_tpu.build import clusterindex as jci
from parlayann_tpu.ops.pallas import clusterbeam as jcb
from parlayann_tpu.ops.pallas.expand import expand_distances as jexpand
from parlayann_tpu.search.flat import _select_sort as jselect, flat_search_batch as jflat

from parlayann_tpu_torch import interop, native
from parlayann_tpu_torch import cli as tcli
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data import io
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.build import clusterindex as tci
from parlayann_tpu_torch.ops.kernels import clusterbeam as tcb
from parlayann_tpu_torch.search.exact import compute_groundtruth
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, M_, RC = 10, 32, 16
RTOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a))


def assert_ids_equal_but_ties(jids, jd, tids, td):
    """ids equal, except in rows where two of the row's distances tie
    within RTOL (the packages order equal distances differently)."""
    np.testing.assert_allclose(td, jd, rtol=RTOL)
    diff = (jids != tids).any(axis=1)
    for r in np.flatnonzero(diff):
        s = np.sort(jd[r])
        gaps = np.diff(s) <= RTOL * np.abs(s[1:])
        assert gaps.any(), (r, jids[r], tids[r], jd[r], td[r])


def assert_quantizers_match(tq, jq):
    """The port's (mcents, blocks, idtab) against JAX's: every cell holds
    the same centroids, in the same slot order in all cells but at most one
    or 1% of them (a cell's order is the balance's priority, the centroids' distances to
    their meta-centroid, and two of those can tie within the flat scan's
    float error: measured 3e-5 apart on 0.126); a block's rows equal
    JAX's where the ids do; the means within rtol 1e-5 (absolute 1e-6)."""
    (tm, tb, ti), (jm, jb, ji) = tq, [np.asarray(a) for a in jq]
    ti, tb = ti.numpy(), tb.numpy()
    assert ti.dtype == np.int32 and tb.shape == jb.shape and tb.dtype == jb.dtype
    np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))
    same = (ti == ji).all(axis=1)
    assert (~same).sum() <= max(1, 0.01 * len(same)), np.flatnonzero(~same)
    np.testing.assert_array_equal(tb[same], jb[same])
    np.testing.assert_allclose(tm.numpy(), jm, rtol=RTOL, atol=1e-6)


# ---- the meta quantizer and approx_assign (tests/test_cluster.py:256-283's data)

@pytest.fixture(scope="module")
def cents320():
    X, _ = synthetic.clustered(4000, 32, n_queries=0, n_clusters=40, cluster_std=0.35, seed=3)
    cents = np.asarray(jci.kmeans(jnp.asarray(X), 4000, 320, metric=JMetric.L2, iters=3, seed=0))
    return X, cents


def test_torch_cluster_hier_meta_sizes():
    for C in (8, 9, 100, 320, 1000, 4097, 32769, 125_000, 312_500, 2_000_000):
        for meta_m in (16, 48, 96, 128):
            assert tci._meta_sizes(C, meta_m) == jci._meta_sizes(C, meta_m), (C, meta_m)


def test_torch_cluster_hier_meta_quantizer(cents320):
    _, cents = cents320
    jq = jci._meta_quantizer(jnp.asarray(cents), 320, JMetric.L2, meta_m=48, seed=0)
    tq = tci._meta_quantizer(t(cents), 320, Metric.L2, meta_m=48, seed=0)
    assert_quantizers_match(tq, jq)
    # every centroid in exactly one cell, its block row its vector
    tm, tb, ti = tq
    ids = ti.numpy()[ti.numpy() >= 0]
    assert np.array_equal(np.sort(ids), np.arange(320))
    np.testing.assert_array_equal(tb.numpy()[ti.numpy() >= 0], cents[ids])


def test_torch_cluster_hier_approx_assign(cents320):
    X, cents = cents320
    jids, jd = jci.approx_assign(jnp.asarray(X), 4000, jnp.asarray(cents), 320, 4, JMetric.L2,
                                 P=2, meta_m=48)
    tids, td = tci.approx_assign(t(X), 4000, t(cents), 320, 4, Metric.L2, P=2, meta_m=48)
    assert_ids_equal_but_ties(np.asarray(jids), np.asarray(jd), tids, td)
    eids, _ = tci._assign_all(t(X), 4000, t(cents), 320, 4, Metric.L2)
    assert (eids[:, 0] == tids[:, 0]).mean() >= 0.97
    want = ((X - cents[tids[:, 0]]) ** 2).sum(1)
    np.testing.assert_allclose(td[:, 0], want, rtol=1e-3, atol=1e-2)


# ---- teleport, polish and the routed respill on one hierarchical state

@pytest.fixture(scope="module")
def state():
    """A first hierarchical round's inputs at 4,000 x 64, m = 32: random
    centroid seeds, 24 of them moved far from the data (clusters no point
    takes: the teleport's donors), and their routed candidates (JAX's),
    whose cap-m trial balance spills."""
    X, _ = synthetic.clustered(4000, 64, n_queries=0, n_clusters=40, cluster_std=0.35, seed=11)
    C = 188
    rng = np.random.default_rng(0)
    cents = X[rng.choice(4000, C, replace=False)].copy()
    cents[:24] = 30 * rng.standard_normal((24, 64))
    nbr_ids, nbr_d = jci.approx_assign(jnp.asarray(X), 4000, jnp.asarray(cents), C, 8, JMetric.L2,
                                       P=4, meta_m=16)
    return X, cents, np.asarray(nbr_ids), np.asarray(nbr_d), C


def test_torch_cluster_hier_teleport(state):
    X, cents, nbr_ids, nbr_d, C = state
    jc, jmoved = jci._teleport_centroids(jnp.asarray(X), jnp.asarray(cents), nbr_ids, nbr_d,
                                          C, M_)
    tc, tmoved = tci._teleport_centroids(t(X), t(cents), nbr_ids, nbr_d, C, M_)
    assert tmoved == jmoved > 0
    assert torch.equal(tc, t(jc))


def test_torch_cluster_hier_polish(state):
    X, cents, nbr_ids, nbr_d, C = state
    members = jci.balance_assign(nbr_ids, nbr_d, C, M_)
    members = jci._respill_local(jnp.asarray(X), 4000, members, nbr_ids, jnp.asarray(cents),
                                 C, M_, JMetric.L2)
    rc = np.asarray(jci._recenter(jnp.asarray(X), members, C))
    jm = jci._polish_misassigned(jnp.asarray(X), 4000, members.copy(), jnp.asarray(rc), C, M_,
                                 JMetric.L2)
    tm = tci._polish_misassigned(t(X), 4000, members.copy(), t(rc), C, M_, Metric.L2)

    def owner(mem):
        o = np.full(4000, -1)
        for c in range(C):
            o[mem[c][mem[c] >= 0]] = c
        return o

    before, jo, to = owner(members), owner(jm), owner(tm)
    assert (to >= 0).all() and ((tm >= 0).sum(1) <= M_).all()
    assert (jo != before).sum() == (to != before).sum() > 0
    differ = np.flatnonzero(jo != to)
    if len(differ):
        # only points whose exact nearest centroids tie
        d = ((X[differ][:, None, :] - rc[None]) ** 2).sum(-1)
        s = np.sort(d, axis=1)
        assert (np.diff(s[:, :9], axis=1) <= RTOL * s[:, 1:9]).any(axis=1).all()
    np.testing.assert_array_equal(np.sort(tm, axis=1), np.sort(jm, axis=1))


def test_torch_cluster_hier_respill_routed(cents320, monkeypatch):
    """The respill's routed branch (``RESPILL_LIMIT`` lowered, pending
    points in chunks of 64, one quantizer a pass) against its exact branch
    on the balance of 4,000 points over 320 k-means centroids at m = 16:
    a partition within capacity, and at least 97% of all placements equal
    (the routed search sees 2 of 8 cells a point)."""
    X, cents = cents320
    C, m = 320, 16
    ids, dd = tci._assign_all(t(X), 4000, t(cents), C, 8, Metric.L2)
    members = tci.balance_assign(ids, dd, C, m)
    assert (tci._mask_spilled(members, ids) >= 0).sum() < 4000  # it spills
    exact = tci._respill_local(t(X), 4000, members.copy(), ids, t(cents), C, m, Metric.L2)
    monkeypatch.setattr(tci, "RESPILL_LIMIT", 1.0)
    monkeypatch.setattr(tci, "RESPILL_CHUNK", 64)
    built, real = [], tci._meta_quantizer
    monkeypatch.setattr(tci, "_meta_quantizer", lambda *a, **kw: built.append(1) or real(*a, **kw))
    routed = tci._respill_local(t(X), 4000, members.copy(), ids, t(cents), C, m, Metric.L2,
                                verbose=True)
    assert built
    got = routed[routed >= 0]
    assert len(got) == 4000 and len(np.unique(got)) == 4000
    assert ((routed >= 0).sum(1) <= m).all()
    own = lambda mem: {int(p): c for c in range(C) for p in mem[c][mem[c] >= 0]}
    oe, orr = own(exact), own(routed)
    assert np.mean([oe[p] == orr[p] for p in range(4000)]) >= 0.97


# ---- the whole hierarchical build

@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    X, Q = synthetic.clustered(4000, 64, n_queries=48, n_clusters=40, cluster_std=0.35, seed=11)
    mp = pytest.MonkeyPatch()
    mp.setenv("PARLAYANN_KMEANS_EXACT_LIMIT", "1")
    try:
        j8 = jci.ClusterIndex.build(JPointSet.from_numpy(X), m=M_, Rc=RC, ext_dtype="int8")
    finally:
        mp.undo()
    jcents = jci._recenter(jnp.asarray(X), j8.members, j8.C)
    jax_idx = {}
    for metric in (Metric.L2, Metric.MIPS):
        jps = JPointSet.from_numpy(X, metric=JMetric(metric.value))
        for layout in ("int8", "f32"):
            jax_idx[(metric, layout)] = jci.ClusterIndex._finish(
                jps, j8.members, j8.adj, jcents, j8.C, M_, RC, ext_dtype=layout)
    mp = pytest.MonkeyPatch()
    mp.setattr(tci, "EXACT_LIMIT", 1.0)
    try:
        port_idx = {(metric, layout): tci.ClusterIndex.build(
            PointSet.from_numpy(X, metric=metric, device="cpu"), m=M_, Rc=RC, ext_dtype=layout)
            for metric in (Metric.L2, Metric.MIPS) for layout in ("int8", "f32")}
    finally:
        mp.undo()
    gt = {metric: compute_groundtruth(PointSet.from_numpy(X, metric=metric, device="cpu"), Q,
                                      2 * K) for metric in (Metric.L2, Metric.MIPS)}
    return dict(X=X, Q=Q, jax=jax_idx, port=port_idx, gt=gt)


def jax_search(ci, Q, *, n_probe, seed_probes=8, S=2):
    qp = ci.qpoints
    mc, mb, mi = ci.seed_meta or (None, None, None)
    ids, dists, (nv, cmps) = jcb.cluster_search_fused(
        jnp.asarray(Q), ci.centroids_q, ci.ext, ci.points.data,
        None if qp is None else qp.quant_slope, None if qp is None else qp.quant_offset,
        mc, mb, mi, metric=ci.points.metric, C=ci.C, m=ci.m, Rc=ci.Rc,
        n_points=ci.points.n, k=K, n_probe=n_probe, min_probe=2, cut=0.0, S=S, pool=2 * K,
        tier_bits=32 if qp is None else 8, rerank="tier" if ci.ext_dtype == "f32" else "full",
        G=4, n_buf=1, seed_probes=seed_probes)
    return [np.asarray(a) for a in (ids, dists, nv, cmps)]


@pytest.mark.parametrize("metric,layout", [(Metric.L2, "int8"), (Metric.L2, "f32"),
                                           (Metric.MIPS, "int8"), (Metric.MIPS, "f32")])
def test_torch_cluster_hier_build(hier, metric, layout):
    ci, ji = hier["port"][(metric, layout)], hier["jax"][(metric, layout)]
    assert ci.C == ji.C and ci.ext_dtype == layout
    got = ci.members[ci.members >= 0]
    assert len(got) == 4000 and len(np.unique(got)) == 4000
    assert ci.members.shape == (ci.C, M_) and ci.adj.shape == (ci.C, RC)
    gi, gd = hier["gt"][metric]
    for n_probe in (4, 8):
        rt = compute_recall(ci.search(hier["Q"], k=K, n_probe=n_probe, cut=0.0)[0].numpy(),
                            gi, gd, K)
        rj = compute_recall(jax_search(ji, hier["Q"], n_probe=n_probe)[0], gi, gd, K)
        assert abs(rt - rj) <= 0.01, (n_probe, rt, rj)


def test_torch_cluster_hier_save_load(hier, tmp_path):
    ci = hier["port"][(Metric.L2, "int8")]
    ci.save(str(tmp_path / "hier"))
    back = tci.ClusterIndex.load(str(tmp_path / "hier"), ci.points)
    assert torch.equal(back.ext, ci.ext)
    for a, b in zip(ci.search(hier["Q"], k=K, n_probe=8, cut=0.0),
                    back.search(hier["Q"], k=K, n_probe=8, cut=0.0)):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


def test_torch_cluster_hier_cli(tmp_path, monkeypatch):
    """``cli.py -algorithm cluster`` reaches the hierarchical build with no
    new flag once the limit is lowered."""
    X, Q = synthetic.clustered(2000, 32, n_queries=30, n_clusters=20, cluster_std=0.35, seed=5)
    f = {k: str(tmp_path / k) for k in ("b.fbin", "q.fbin", "gt.ibin", "res.csv")}
    io.write_bin(f["b.fbin"], X)
    io.write_bin(f["q.fbin"], Q)
    gi, gd = compute_groundtruth(PointSet.from_numpy(X, device="cpu"), Q, K)
    io.write_ibin(f["gt.ibin"], gi, gd)
    calls = []
    monkeypatch.setattr(tci, "EXACT_LIMIT", 1.0)
    real = tci._hier_partition
    monkeypatch.setattr(tci, "_hier_partition", lambda *a: calls.append(1) or real(*a))
    assert tcli.main(["-base_path", f["b.fbin"], "-query_path", f["q.fbin"], "-gt_path",
                      f["gt.ibin"], "-algorithm", "cluster", "-cluster_m", "16", "-Q", "8",
                      "-res_path", f["res.csv"], "-device", "cpu"]) == 0
    assert calls == [1]
    with open(f["res.csv"]) as fh:
        rows = [r.split(",") for r in fh.read().splitlines()]
    assert float(rows[4][2]) >= 0.9


# ---- the meta-routed query seed over one JAX-built index

@pytest.fixture(scope="module")
def seeded():
    """A JAX exact-path index at 4,000 x 64 (m = 32, C = 188) packed in both
    layouts with ``ARGMIN_SEED_CUTOFF`` = 8, so ``_finish`` builds the
    seed quantizer; the port's view of each, ``seed_meta`` carried across."""
    X, Q = synthetic.clustered(4000, 64, n_queries=64, n_clusters=50, cluster_std=0.35, seed=7)
    jps = JPointSet.from_numpy(X)
    j8 = jci.ClusterIndex.build(jps, m=M_, Rc=RC, iters=3, ext_dtype="int8")
    cents = jci._recenter(jps.data, j8.members, j8.C)
    mp = pytest.MonkeyPatch()
    mp.setattr(jcb, "ARGMIN_SEED_CUTOFF", 8)
    try:
        jax_idx = {lay: jci.ClusterIndex._finish(jps, j8.members, j8.adj, cents, j8.C, M_, RC,
                                                 ext_dtype=lay) for lay in ("int8", "f32")}
    finally:
        mp.undo()
    tps = interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, jps.metric,
                                      device="cpu")
    port = {}
    for lay, ji in jax_idx.items():
        assert ji.seed_meta is not None
        qp = None
        if lay == "int8":
            q8 = ji.qpoints
            qp = interop.pointset_from_state(
                np.asarray(q8.data), q8.n, q8.d, q8.metric, bits=8,
                quant_slope=np.asarray(q8.quant_slope), quant_offset=np.asarray(q8.quant_offset),
                device="cpu")
        port[lay] = interop.cluster_index_from_state(
            tps, ji.members, ji.adj, np.asarray(ji.centroids_q), np.asarray(ji.ext), ji.C, M_,
            RC, lay, qpoints=qp, seed_meta=[np.asarray(a) for a in ji.seed_meta])
    return dict(X=X, Q=Q, jps=jps, tps=tps, members=j8.members, adj=j8.adj,
                cents=np.asarray(cents), jax=jax_idx, port=port)


def jax_meta_seed(ji, q, S, seed_probes):
    """The JAX package's meta seed (ops/pallas/clusterbeam.py:522-556) as
    its own ops compute it."""
    mc, mb, mi = ji.seed_meta
    Cm = mb.shape[0]
    P = max(1, min(seed_probes, Cm))
    mt_i, _ = jflat(q, mc, k=P, metric=ji.points.metric, n_valid=Cm, chunk=min(Cm, 32768),
                    select="sort")
    ds, ids = [], []
    for p in range(P):
        c = jnp.clip(mt_i[:, p], 0, Cm - 1)
        dp = jexpand(mb, c, q, metric=ji.points.metric, block_b=256, group=4)
        ip = jnp.take(mi, c, axis=0)
        ds.append(jnp.where((ip >= 0) & (mt_i[:, p:p + 1] >= 0), dp, 3.0e38))
        ids.append(jnp.where(ip >= 0, ip, -1))
    sd, sid = jselect(jnp.concatenate(ds, axis=1), jnp.concatenate(ids, axis=1), S)
    return np.asarray(sd), np.asarray(sid)


@pytest.mark.parametrize("layout", ["int8", "f32"])
@pytest.mark.parametrize("seed_probes", [2, 8])
def test_torch_cluster_hier_meta_seed(seeded, monkeypatch, layout, seed_probes):
    ji, ci = seeded["jax"][layout], seeded["port"][layout]
    Q = seeded["Q"]
    q = torch.from_numpy(Q)
    if ci.qpoints is not None:
        from parlayann_tpu_torch.ops import quantize
        q = quantize.translate_query(q, ci.qpoints).float()
    monkeypatch.setattr(tcb, "ARGMIN_SEED_CUTOFF", 8)
    monkeypatch.setattr(jcb, "ARGMIN_SEED_CUTOFF", 8)
    sd, sid = tcb.seed_centroids(q, ci.centroids_q, C=ci.C, S=2, metric=ci.points.metric,
                                 meta=ci.seed_meta, seed_probes=seed_probes)
    jd, jid = jax_meta_seed(ji, jnp.asarray(q.numpy()), 2, seed_probes)
    assert_ids_equal_but_ties(jid, jd, sid.numpy(), sd.numpy())
    ids, dists, (nv, cm) = ci.search(Q, k=K, n_probe=8, cut=0.0, min_probe=2,
                                     seed_probes=seed_probes)
    jids, jdists, jnv, jcm = jax_search(ji, Q, n_probe=8, seed_probes=seed_probes)
    np.testing.assert_array_equal(nv.numpy(), jnv)
    np.testing.assert_array_equal(cm.numpy(), jcm)
    for r in range(len(Q)):
        a = sorted(zip(dists[r].tolist(), ids[r].tolist()))
        b = sorted(zip(jdists[r].tolist(), jids[r].tolist()))
        assert [i for _, i in a] == [i for _, i in b] or sorted(i for _, i in a) == sorted(
            i for _, i in b), r
        np.testing.assert_allclose([d for d, _ in a], [d for d, _ in b], rtol=RTOL)
    # the streamed seed ignores the router
    s_ids, _, _ = ci.search(Q, k=K, n_probe=8, cut=0.0, seed_mode="stream")
    plain = interop.cluster_index_from_state(ci.points, ci.members, ci.adj, ci.centroids_q.numpy(),
                                             ci.ext.numpy(), ci.C, M_, RC, layout,
                                             qpoints=ci.qpoints)
    assert torch.equal(s_ids, plain.search(Q, k=K, n_probe=8, cut=0.0, seed_mode="stream")[0])


@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cluster_hier_finish_seed_meta(seeded, monkeypatch, layout):
    """The port's ``_finish`` over JAX's members and centroids builds JAX's
    seed quantizer; without the lowered cutoff it builds none."""
    ji = seeded["jax"][layout]
    args = (seeded["tps"], seeded["members"], seeded["adj"], t(seeded["cents"]), ji.C, M_, RC)
    assert tci.ClusterIndex._finish(*args, ext_dtype=layout).seed_meta is None
    monkeypatch.setattr(tcb, "ARGMIN_SEED_CUTOFF", 8)
    ci = tci.ClusterIndex._finish(*args, ext_dtype=layout)
    assert ci.seed_meta[1].dtype == (torch.int8 if layout == "int8" else torch.float32)
    assert_quantizers_match(ci.seed_meta, ji.seed_meta)


# ---- the native balancer (tests/test_cluster.py:232-253's inputs)

def test_torch_cluster_hier_native_balance():
    rng = np.random.default_rng(3)
    n, C, m, k = 20000, 400, 64, 8
    ids = rng.integers(0, C, (n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.05] = -1
    d = rng.random((n, k)).astype(np.float32)
    order = np.argsort(d[:, 0], kind="stable").astype(np.int64)
    got = native.balance_assign(ids, order, C, m)
    np.testing.assert_array_equal(got, tci.balance_assign(ids, d, C, m))
    np.testing.assert_array_equal(got, jnative.balance_assign(ids, order, C, m))
    np.testing.assert_array_equal(tci._balance(ids, d, C, m), got)
    with pytest.raises(ValueError, match="capacity"):
        native.balance_assign(ids, order, 10, 8)
