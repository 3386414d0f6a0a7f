"""HNSW, port vs JAX package: level assignment, the q8 and f32 builds, the
layered search, the v2 and v3 model files and the reverse-edge exchange.

Bars.
- q8 build: every build distance is an integer (int8 points, integer
  sums below 2^24), exact in float32 in both packages, so each level's
  adjacency equals the JAX build's row for row. The tie rule, should a row
  differ: the two rows must hold the same multiset of distances to the
  row's point (a swap between equally distant neighbours); none differs
  on this data.
- uint8 build without ``quantize_build`` (the JAX package builds on the
  uint8 points, the port on an exact float32 copy through kernel 2's f32
  mode): the same integer distances, so the same bar and tie rule.
- f32 builds, under L2 and MIPS: the ROADMAP's builder bar. Each level's
  average degree within 0.5 of the JAX build's, recall@10 at ef = 24
  within 0.01, each package's searcher also run over the other's
  hierarchy.
- Search over one carried hierarchy: ids equal to the JAX package's except
  where two distances tie within rtol 1e-5.
- Model files: byte-equal, and each package loads the other's.
- ``exchange_reverse_edges``: equal rows (the sort-truncate).

The builds use ``batch_cap_frac=0.1`` (the JAX package's fixed compile
shapes make its CPU run of small batches slow); ``n <= 1500``, ``d <= 32``.
"""

import struct

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.build import hnsw as jh
from parlayann_tpu.build.reverse import exchange_reverse_edges as jexchange
from parlayann_tpu.ops import quantize as jquantize

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.build import hnsw as th
from parlayann_tpu_torch.build import reverse
from parlayann_tpu_torch.build.reverse import exchange_reverse_edges
from parlayann_tpu_torch.search.exact import compute_groundtruth
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, EF, M, EFC, FRAC = 10, 24, 8, 16, 0.1
METRICS = {"l2": (Metric.L2, JMetric.L2), "mips": (Metric.MIPS, JMetric.MIPS)}


def data():
    return synthetic.clustered(1500, 32, n_queries=64, n_clusters=20,
                               cluster_std=0.35, seed=7)


def u8_data():
    """data()'s points mapped onto 0..255 as uint8."""
    X, _ = data()
    return np.round((X - X.min()) / (X.max() - X.min()) * 255).astype(np.uint8)


def build_both(X, metric, quantize_build):
    """One build in each package on the same data and seed."""
    tm, jm = METRICS[metric]
    jidx, _ = jh.build_hnsw_graph(
        JPointSet.from_numpy(X, metric=jm),
        JBuildParams(R=M, L=EFC, alpha=0.9, m_l=0.34, batch_cap_frac=FRAC),
        quantize_build=quantize_build)
    tidx, _ = th.build_hnsw_graph(
        PointSet.from_numpy(X, metric=tm, device="cpu"),
        BuildParams(R=M, L=EFC, alpha=0.9, m_l=0.34, batch_cap_frac=FRAC),
        quantize_build=quantize_build)
    return jidx, tidx


def jax_state(jidx):
    """The JAX HNSWIndex as numpy state for interop.hnsw_index_from_state."""
    return [(lv.members, np.asarray(lv.nbrs)[:len(lv.members)],
             np.asarray(lv.degs)[:len(lv.members)], lv.cap) for lv in jidx.levels]


def port_from_jax(jidx, points):
    return interop.hnsw_index_from_state(
        points, jax_state(jidx), jidx.entrances, jidx.m, jidx.efc, jidx.alpha,
        jidx.m_l)


def rows(lv):
    """(nbrs, degs) of a level's members, either package, padded slots -1."""
    ml = len(lv.members)
    nb, dg = np.array(lv.nbrs)[:ml], np.array(lv.degs)[:ml]
    nb[np.arange(nb.shape[1])[None, :] >= dg[:, None]] = -1
    return nb, dg


@pytest.fixture(scope="module")
def q8():
    X, Q = data()
    jidx, tidx = build_both(X, "l2", quantize_build=True)
    return dict(X=X, Q=Q, jidx=jidx, tidx=tidx)


@pytest.fixture(scope="module", params=["l2", "mips"])
def f32(request):
    X, Q = data()
    jidx, tidx = build_both(X, request.param, quantize_build=False)
    gt = compute_groundtruth(tidx.points, Q, 2 * K)
    return dict(X=X, Q=Q, jidx=jidx, tidx=tidx, gt=gt, metric=request.param)


@pytest.mark.slow
def test_torch_hnsw_q8_beam_level_equals_jax_row_for_row():
    """Level 0 past FLAT_LEVEL_MAX members (n = 10,000) inserts through the
    efc-beam at expand = 4, the path of the 100K builds: the q8 builds
    equal row for row, and so do their recalls (about 50 s in the JAX
    package on the CPU, so left out of Tier-1)."""
    X, Q = synthetic.clustered(10_000, 16, n_queries=200, n_clusters=100,
                               cluster_std=0.35, seed=7)
    jidx, _ = jh.build_hnsw_graph(
        JPointSet.from_numpy(X), JBuildParams(R=M, L=EFC, alpha=0.9, m_l=0.34,
                                              batch_cap_frac=FRAC), quantize_build=True)
    tps = PointSet.from_numpy(X, device="cpu")
    tidx, _ = th.build_hnsw_graph(
        tps, BuildParams(R=M, L=EFC, alpha=0.9, m_l=0.34, batch_cap_frac=FRAC),
        quantize_build=True)
    assert len(jidx.levels[0].members) > th.FLAT_LEVEL_MAX
    np.testing.assert_array_equal(tidx.entrances, jidx.entrances)
    for jl, tl in zip(jidx.levels, tidx.levels):
        for a, b in zip(rows(tl), rows(jl)):
            np.testing.assert_array_equal(a, b)
    gt_i, gt_d = compute_groundtruth(tps, Q, 2 * K)
    for ef in (16, 32):
        assert (compute_recall(tidx.batch_search(Q, k=K, ef=ef)[0].numpy(), gt_i, gt_d, K)
                == compute_recall(np.asarray(jidx.batch_search(Q, k=K, ef=ef)[0]),
                                  gt_i, gt_d, K))


def test_torch_hnsw_assign_levels_matches_jax():
    for n, m_l, seed in ((100_000, 0.34, 0), (5000, 0.8, 3)):
        want = jh.assign_levels(n, m_l, np.random.default_rng(seed))
        got = th.assign_levels(n, m_l, np.random.default_rng(seed))
        np.testing.assert_array_equal(got, want)
        # insert_plan: the JAX build's two draws, levels then insert order
        rng = np.random.default_rng(seed)
        lv, order = th.insert_plan(n, m_l, seed)
        np.testing.assert_array_equal(lv, jh.assign_levels(n, m_l, rng))
        np.testing.assert_array_equal(order, rng.permutation(n))
    assert 0.03 < (got >= 1).mean() < 0.4 and got.min() == 0


def assert_levels_equal_up_to_ties(jidx, tidx, q):
    """Level members, entrances and every level's adjacency, the tie rule
    of the module docstring for a row that differs; ``q`` holds the
    integer points the build measured distances on."""
    np.testing.assert_array_equal(tidx.entrances, jidx.entrances)
    assert len(tidx.levels) == len(jidx.levels) >= 3
    for jl, tl in zip(jidx.levels, tidx.levels):
        np.testing.assert_array_equal(tl.members, jl.members)
        assert tl.cap == jl.cap
        tn, td = rows(tl)
        jn, jd = rows(jl)
        differ = np.flatnonzero((tn != jn).any(axis=1) | (td != jd))
        for r in differ:  # the tie rule
            p = q[jl.members[r]]

            def dists(row):
                ids = jl.members[row[row >= 0]]
                return np.sort(((q[ids] - p) ** 2).sum(1))
            np.testing.assert_array_equal(dists(tn[r]), dists(jn[r]))
        assert len(differ) == 0, f"{len(differ)} rows differ (all distance ties)"


def test_torch_hnsw_q8_build_equals_jax_row_for_row(q8):
    """Every level row for row, distances measured on the build's q8 tier."""
    jidx, tidx = q8["jidx"], q8["tidx"]
    q = np.asarray(jquantize.quantize_pointset(jidx.points, bits=8).data).astype(np.int64)
    assert_levels_equal_up_to_ties(jidx, tidx, q)


def test_torch_hnsw_uint8_build_equals_jax_row_for_row():
    """uint8 points with ``quantize_build=False`` (the default): the JAX
    package builds on them as they are, the port on an exact float32 copy
    (every distance an integer below 2^24, so exact in both); every level
    equals the JAX build's row for row, and the levels hold the uint8
    points as the JAX levels do."""
    U = u8_data()
    bp = dict(R=M, L=EFC, alpha=0.9, m_l=0.34, batch_cap_frac=FRAC)
    jidx, _ = jh.build_hnsw_graph(JPointSet.from_numpy(U), JBuildParams(**bp))
    tidx, _ = th.build_hnsw_graph(PointSet.from_numpy(U, device="cpu"), BuildParams(**bp))
    assert_levels_equal_up_to_ties(jidx, tidx, U.astype(np.int64))
    for jl, tl in zip(jidx.levels, tidx.levels):
        assert tl.points_l.dtype == torch.uint8 and np.asarray(jl.points_l).dtype == np.uint8


def test_torch_hnsw_f32_build_parity(f32):
    """Average degree per level within 0.5 and recall@10 at ef = 24 within
    0.01 of the JAX build; each searcher over the other's hierarchy."""
    jidx, tidx, Q = f32["jidx"], f32["tidx"], f32["Q"]
    gt_i, gt_d = f32["gt"]
    assert [len(lv.members) for lv in tidx.levels] == [len(lv.members) for lv in jidx.levels]
    for jl, tl in zip(jidx.levels, tidx.levels):
        assert abs(rows(tl)[1].mean() - rows(jl)[1].mean()) <= 0.5
    r_jax = compute_recall(np.asarray(jidx.batch_search(Q, k=K, ef=EF)[0]), gt_i, gt_d, K)
    r_port = compute_recall(tidx.batch_search(Q, k=K, ef=EF)[0].numpy(), gt_i, gt_d, K)
    assert abs(r_port - r_jax) <= 0.01, (r_port, r_jax)
    assert r_port >= 0.9
    # the port over the JAX hierarchy, the JAX package over the port's
    cross_t = port_from_jax(jidx, tidx.points)
    r_t_over_j = compute_recall(cross_t.batch_search(Q, k=K, ef=EF)[0].numpy(), gt_i, gt_d, K)
    jover = jh.HNSWIndex(
        points=jidx.points,
        levels=[jh._make_level(jidx.points, lv.members, lv.cap, nbrs=rows(lv)[0],
                               degs=rows(lv)[1]) for lv in tidx.levels],
        entrances=tidx.entrances, m=tidx.m, efc=tidx.efc, alpha=tidx.alpha,
        m_l=tidx.m_l)
    r_j_over_t = compute_recall(np.asarray(jover.batch_search(Q, k=K, ef=EF)[0]),
                                gt_i, gt_d, K)
    assert abs(r_t_over_j - r_jax) <= 0.01 and abs(r_j_over_t - r_port) <= 0.01


def assert_same_up_to_ties(ids, dists, want_ids, want_d, rtol=1e-5):
    ids, dists = np.asarray(ids), np.asarray(dists)
    want_ids, want_d = np.asarray(want_ids), np.asarray(want_d)
    ok = want_ids >= 0
    assert ((ids >= 0) == ok).all()
    tol = rtol * np.abs(want_d) + 1e-30
    assert (np.abs(dists - want_d)[ok] <= tol[ok]).all()
    for r in np.flatnonzero((ids != want_ids).any(axis=1)):
        last = ok[r].sum() - 1
        for a, ad, b, bd in ((ids, dists, want_ids, want_d), (want_ids, want_d, ids, dists)):
            only = ~np.isin(a[r], b[r])
            assert (np.abs(ad[r][only] - bd[r, last]) <= tol[r, last]).all(), r


@pytest.mark.parametrize("expand", [1, 2])
def test_torch_hnsw_search_matches_jax(q8, expand):
    """One carried hierarchy: the foldable entry (level-1 members as the q8
    Index's entry tier, kernel 3's plain walk, the rerank) at expand = 1,
    the lock-step search on level 0 at expand = 2."""
    jidx, Q = q8["jidx"], q8["Q"]
    tps = interop.pointset_from_state(np.asarray(jidx.points.data), jidx.points.n,
                                      jidx.points.d, jidx.points.metric, device="cpu")
    tidx = port_from_jax(jidx, tps)
    assert tidx._entry_foldable()
    want = jidx.batch_search(Q, k=K, ef=EF, expand=expand)
    got = tidx.batch_search(Q, k=K, ef=EF, expand=expand)
    assert_same_up_to_ties(got[0].numpy(), got[1].numpy(), *want)


def test_torch_hnsw_entry_paths_match_jax(q8, monkeypatch):
    """The non-foldable entries: ``_entry_top1`` over level 1 and
    ``_descent_all`` from the entrance list, against the JAX functions;
    then the port's whole search with level 1 not folded (ENTRY_FOLD_MAX =
    0) against its folded search."""
    jidx, Q = q8["jidx"], q8["Q"]
    jps = jidx.points
    tps = interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, jps.metric,
                                      device="cpu")
    tidx = port_from_jax(jidx, tps)
    q = torch.from_numpy(Q)
    lv1, jl1 = tidx.levels[1], jidx.levels[1]
    got = th._entry_top1(q, lv1.points_l, lv1.members_d, metric=Metric.L2,
                         nv=len(lv1.members), chunk=32)
    want = np.asarray(jh._entry_top1(jnp.asarray(Q), jl1.points_l, jl1.members_d,
                                     metric=JMetric.L2, nv=len(jl1.members), chunk=32))
    d2 = lambda ids: ((q8["X"][ids] - Q) ** 2).sum(1)  # noqa: E731
    np.testing.assert_allclose(d2(got.numpy()), d2(want), rtol=1e-5)
    assert (got.numpy() == want).mean() >= 0.95
    B, S = len(Q), len(jidx.entrances)
    ent = np.broadcast_to(jidx.entrances, (B, S)).astype(np.int32)
    upper = jidx.levels[:0:-1]
    want = np.asarray(jh._descent_all(
        jnp.asarray(Q), tuple((lv.points_l, lv.nbrs, lv.degs, lv.members_d, lv.glob2loc_d)
                              for lv in upper), jnp.asarray(ent), metric=JMetric.L2,
        nvs=tuple(len(lv.members) for lv in upper)))
    got = th._descent_all(q, tidx.levels[:0:-1], torch.from_numpy(ent), Metric.L2)
    np.testing.assert_array_equal(got.numpy(), want)
    folded = tidx.batch_search(Q, k=K, ef=EF)[0].numpy()
    monkeypatch.setattr(th, "ENTRY_FOLD_MAX", 0)
    tidx._bidx = None
    assert not tidx._entry_foldable()
    walked = tidx.batch_search(Q, k=K, ef=EF)[0].numpy()
    gt_i, gt_d = compute_groundtruth(tps, Q, 2 * K)
    assert abs(compute_recall(walked, gt_i, gt_d, K)
               - compute_recall(folded, gt_i, gt_d, K)) <= 0.05
    with pytest.raises(ValueError, match="foldable"):
        tidx.batch_search_timed(Q)


def test_torch_hnsw_model_files_byte_equal(q8, tmp_path):
    """v2 and v3 files of one carried hierarchy are byte-equal; each package
    loads the other's file to the same levels and entrances."""
    jidx = q8["jidx"]
    jps = jidx.points
    tps = interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, jps.metric,
                                      device="cpu")
    tidx = port_from_jax(jidx, tps)
    for kind, jsave, tsave in (("v2", jidx.save, tidx.save),
                               ("v3", jidx.save_v3, tidx.save_v3)):
        jp, tp = str(tmp_path / f"jax.{kind}"), str(tmp_path / f"port.{kind}")
        jsave(jp)
        tsave(tp)
        assert open(jp, "rb").read() == open(tp, "rb").read(), kind
        got = th.HNSWIndex.load(jp, tps)
        back = jh.HNSWIndex.load(tp, jps)
        for a, b in ((got, jidx), (tidx, back)):
            assert sorted(a.entrances.tolist()) == sorted(np.asarray(b.entrances).tolist())
            assert (a.m, a.efc, len(a.levels)) == (b.m, b.efc, len(b.levels))
            for la, lb in zip(a.levels, b.levels):
                np.testing.assert_array_equal(la.members, lb.members)
                na, da = rows(la)
                nb, db = rows(lb)
                np.testing.assert_array_equal(da, db)
                # v3 keeps each row's order; compare as sets all the same
                for i in range(len(da)):
                    assert set(na[i, :da[i]]) == set(nb[i, :db[i]])
        ids = got.batch_search(q8["Q"], k=5, ef=EF)[0]
        assert torch.equal(ids, tidx.batch_search(q8["Q"], k=5, ef=EF)[0])


def test_torch_hnsw_v3_reference_node_order(tmp_path):
    """tests/test_hnsw.py:103-142: a reference v3 file whose node order is
    the insertion permutation (the node table maps node to point; lists
    hold node ids)."""
    rng = np.random.default_rng(42)
    n, d, m, efc = 40, 8, 4, 8
    X = rng.standard_normal((n, d)).astype(np.float32)
    ps = PointSet.from_numpy(X, device="cpu")
    perm = rng.permutation(n).astype(np.uint32)  # node u -> point perm[u]
    lev = np.zeros(n, dtype=np.uint32)
    lev[:3] = 1
    buf = b"HNSW" + struct.pack("<I", 3) + struct.pack("<QQ", 123, 456)
    buf += struct.pack("<IfIIfI", d, 0.5, m, efc, 0.9, n)
    for u in range(n):
        buf += struct.pack("<II", lev[u], perm[u])
    for u in range(n):
        ring = [(u + 1) % n, (u - 1) % n]
        buf += struct.pack("<Q", len(ring)) + np.asarray(ring, "<u4").tobytes()
        if lev[u]:
            tri = [v for v in range(3) if v != u]
            buf += struct.pack("<Q", len(tri)) + np.asarray(tri, "<u4").tobytes()
    buf += struct.pack("<Q", 1) + np.asarray([0], "<u4").tobytes()
    p = tmp_path / "ref.v3"
    p.write_bytes(buf)
    idx = th.HNSWIndex.load(str(p), ps)
    assert idx.entrance == int(perm[0]) and len(idx.levels) == 2
    np.testing.assert_array_equal(idx.levels[1].members, np.sort(perm[:3].astype(np.int32)))
    for u in [0, 5, n - 1]:
        row = idx.levels[0].nbrs[int(perm[u])].numpy()
        assert set(row[:2].tolist()) == {int(perm[(u + 1) % n]), int(perm[(u - 1) % n])}
    with pytest.raises(ValueError, match="HNSW"):
        p.write_bytes(b"XXXX" + buf[4:])
        th.HNSWIndex.load(str(p), ps)


def test_torch_hnsw_multi_entrance_tie():
    """tests/test_hnsw.py:145-158: the entrance list appends on a level tie
    (HNSW.hpp:991-1007); every entrance is at the top level."""
    rng = np.random.default_rng(42)
    X = rng.standard_normal((800, 8)).astype(np.float32)
    # seed 7 draws a top level of 5 points, all reached in later batches
    idx, ps, _ = pt.build_hnsw_index(X, m=6, efc=12, m_l=0.8, seed=7, device="cpu")
    top = idx.levels[-1].members
    assert len(idx.entrances) == len(top) == 5 and np.isin(idx.entrances, top).all()
    assert idx.levels[0].cap == 12 and idx.levels[1].cap == 6
    assert (idx.level_of()[idx.entrances] == idx.max_level).all()


@pytest.mark.parametrize("shape", [(64, 6, 24, 16, 5), (96, 8, 40, 64, 11),
                                   (48, 4, 30, 24, 3)],
                         ids=["R6", "R8", "R4"])
@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_hnsw_exchange_reverse_edges_matches_jax(metric, shape, monkeypatch):
    """The one-call exchange (the JAX function at ``prune_budget=-1``, the
    sort-truncate) at small shapes with many overflowing targets, in chunks
    of 4 of them: equal rows (integer-valued points, so every distance is
    exact in both)."""
    monkeypatch.setattr(reverse, "EXCHANGE_CHUNK", 4)
    tm, jm = METRICS[metric]
    n, R, B, n_tgt, seed = shape
    rng = np.random.default_rng(seed)
    d = 8
    pts = rng.integers(-20, 20, (n, d)).astype(np.float32)
    nbrs = rng.integers(0, n, (n, R)).astype(np.int32)
    degs = rng.integers(0, R + 1, n).astype(np.int32)
    batch = rng.choice(n, B, replace=False).astype(np.int32)
    batch[-2:] = -1
    sel = rng.integers(0, n_tgt, (B, R)).astype(np.int32)  # crowd few targets
    sel[rng.random((B, R)) < 0.2] = -1
    d_sel = np.where(sel >= 0, ((pts[sel.clip(0)] - pts[batch.clip(0)][:, None]) ** 2).sum(-1)
                     if metric == "l2" else -(pts[sel.clip(0)] * pts[batch.clip(0)][:, None]).sum(-1),
                     3.0e38).astype(np.float32)
    jn, jd, js = jexchange(jnp.asarray(nbrs), jnp.asarray(degs), jnp.asarray(batch),
                           jnp.asarray(sel), jnp.asarray(d_sel), jnp.asarray(pts),
                           jnp.float32(1.2), R=R, metric=jm, n_valid=n,
                           prune_budget=-1, chunk=8)
    tn, td = exchange_reverse_edges(
        torch.from_numpy(nbrs.copy()), torch.from_numpy(degs.copy()), torch.from_numpy(batch),
        torch.from_numpy(sel), torch.from_numpy(d_sel), torch.from_numpy(pts),
        R=R, metric=tm, n_valid=n)
    assert int(js.n_overflow) > 4 and int(js.n_groups) > int(js.n_overflow)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    mask = np.arange(R)[None, :] < np.asarray(jd)[:, None]
    np.testing.assert_array_equal(np.where(mask, tn.numpy(), -1),
                                  np.where(mask, np.asarray(jn), -1))


def test_torch_hnsw_api_validation():
    X = np.random.default_rng(0).normal(size=(300, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        pt.build_hnsw_index(X, m=0, device="cpu")
    with pytest.raises(ValueError):
        pt.build_hnsw_index(X, metric="cosine", device="cpu")
    with pytest.raises(ValueError):
        pt.build_hnsw_index(X[:, :0], device="cpu")
    idx, ps, dt = pt.build_hnsw_index(X, m=6, efc=12, device="cpu")
    assert isinstance(idx, pt.HNSWIndex) and ps.device.type == "cpu" and dt > 0
    assert idx.base_graph().max_degree == 12
