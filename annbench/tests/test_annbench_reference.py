"""The plain reference against the port's plain path at a tiny n on the
CPU, and the arithmetic of recall, the roofline and the trace."""

import numpy as np
import pytest
import torch

from annbench import correct, data, peaks, trace
from annbench.reference import control, graph, knn, quant, recall

DEV = torch.device("cpu")


@pytest.fixture(scope="module")
def pts():
    return data.clustered(3000, 32, 300, 30, 0.35, 2**32 + 5, DEV)


def test_exact_knn_against_numpy_f64(pts):
    X, Q = pts
    ids, d = knn.exact_knn(X, 2992, Q, 20)
    Xd, Qd = X[:2992].double().numpy(), Q.double().numpy()
    full = ((Qd[:, None, :] - Xd[None, :, :]) ** 2).sum(-1)
    want = np.lexsort((np.broadcast_to(np.arange(2992), full.shape), full), axis=1)[:, :20]
    assert np.array_equal(ids, want)
    assert np.allclose(d, np.take_along_axis(full, want, 1), rtol=1e-12)
    assert np.allclose(knn.answer_dist64(X, 2992, Q, ids), d, rtol=1e-12)


def test_flat_reference_equals_port_plain_path(pts):
    import parlayann_tpu_torch as pt

    X, Q = pts
    ps = pt.PointSet(data=X, n=3000, d=32, metric=pt.Metric.L2)
    ids, dists = pt.FlatIndex(ps).batch_search(Q, k=50, select="pallas")
    gi, gd = knn.exact_knn(X, 3000, Q, 50)
    assert recall.compute_recall(ids.numpy(), gi, gd, 50) == 1.0
    f_ids, f_d = control.flat_scan(X, 3000, Q, k=50, tf32=False)
    assert recall.compute_recall(f_ids, gi, gd, 50) == 1.0


def test_recall_copy_equals_port_harness():
    from parlayann_tpu_torch.harness.recall import compute_recall

    rng = np.random.default_rng(3)
    res = rng.integers(-1, 40, (200, 10))
    gt = np.stack([rng.permutation(40)[:15] for _ in range(200)])
    gd = np.sort(rng.integers(0, 6, (200, 15)).astype(np.float64), axis=1)
    for k in (1, 5, 10):
        assert recall.compute_recall(res, gt, gd, k, block=37) == compute_recall(res, gt, gd, k)
        assert recall.compute_recall(res, gt, None, k) == compute_recall(res, gt, None, k)


def test_scalar_tier_equals_port(pts):
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops import quantize

    X, _ = pts
    ps = pt.PointSet(data=X, n=2990, d=32, metric=pt.Metric.L2)
    for bits in (4, 8):
        t = quantize.quantize_pointset(ps, bits=bits)
        levels, slope, lo = quant.scalar_tier(X, 2990, bits)
        assert torch.equal(t.data.int() + 128, levels.int())
        assert float(t.quant_slope) == float(slope) and float(t.quant_offset) == float(lo)


def test_graph_faults_on_port_graph_and_planted(pts):
    import parlayann_tpu_torch as pt

    X, Q = pts
    ps = pt.PointSet(data=X, n=3000, d=32, metric=pt.Metric.L2)
    g, _, _ = pt.build_vamana_index(ps, R=16, L=32, alpha=1.15, batch_cap_frac=0.1)
    assert graph.faults(g.neighbors, g.degrees, 3000, 16) == 0
    nb, dg = g.neighbors.clone(), g.degrees.clone()
    nb[5, 0] = 5  # itself
    nb[6, 1] = nb[6, 0]  # repeated
    nb[7, 0] = 3000  # out of range
    dg[8] = 0
    assert graph.faults(nb, dg, 3000, 16) == 4
    # the reference's walk at the stated precision over the port's graph
    # reaches what the port's search reaches
    idx = pt.Index(points=ps, graph=g).enable_quantized(8)
    ids, _, _ = idx.batch_search(Q, k=10, beam_size=32)
    gi, gd = knn.exact_knn(X, 3000, Q, 10)
    r_port = recall.compute_recall(ids.numpy(), gi, gd, 10)
    ri, _ = control.graph_search(X, 3000, Q, g.neighbors, g.degrees, k=10, L=32, bits=8,
                                 tf32=False)
    assert abs(recall.compute_recall(ri, gi, gd, 10) - r_port) < 0.05


def test_round_tf32():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.14159265, 0.0])
    y = control.round_tf32(x)
    assert y.tolist()[:4] == [1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9]  # ties to even
    r = torch.randn(10000)
    rel = ((control.round_tf32(r) - r).abs() / r.abs()).max()
    assert 2**-13 < rel <= 2**-11


def test_flat_bound_arithmetic():
    b = peaks.flat_scan_bound_s(10_000, 1_000_000, 128, 100)
    assert b == pytest.approx(2 * 10_000 * 1_000_000 * 128 / 495e12)  # operations bound it
    assert b * 1e3 == pytest.approx(5.1717, rel=1e-4)
    assert peaks.flat_scan_bound_s(1, 1_000_000, 128, 100) == pytest.approx(
        (1_000_000 * 128 * 4 + 128 * 4 + 800) / 3.35e12)


def test_trace_arithmetic():
    assert trace.merged([(3, 4), (0, 2), (1, 2.5)]) == [[0, 2.5], [3, 4]]
    assert trace.busy([(0, 1), (0.5, 2), (5, 6)]) == 3
    host = [(0.0, 10.0, "annbench.dispatch"), (2.0, 3.0, "aten::sort"),
            (6.0, 9.0, "annbench.wait"), (6.5, 8.0, "cudaEventSynchronize")]
    gaps = trace.name_gaps([(0, 2), (3, 4), (8.5, 9)], host)
    assert gaps == {"annbench.dispatch > aten::sort": 1.0,
                    "annbench.dispatch > annbench.wait": 4.5}
    names = trace.port_kernel_names()
    assert {"walk_regs", "walk_smem", "flat_topk_kernel", "merge_splits_kernel"} <= names
    m = trace.name_matcher(names)
    assert m.search("void walk_regs<4, 1>(Params)")
    assert not m.search("void at::native::sort_kernel<float>(...)")


def test_checks_on_planted_answers(pts):
    X, Q = pts
    gt = knn.exact_knn(X, 3000, Q, 10)
    ids, d = gt[0].copy(), gt[1].astype(np.float32)
    ctx = correct.context(X, 3000, Q, ids, d, gt)
    assert correct.numbers(ctx, ["malformed", "dist_err", "rank_gap", "miss"]) == pytest.approx(
        {"malformed": 0.0, "dist_err": 0.0, "rank_gap": 0.0, "miss": 0.0}, abs=1e-6)
    bad = ids.copy()
    bad[0, 0] = bad[0, 1]  # repeated id
    bad[1, 3] = (bad[1, 3] + 1) % 3000  # altered id, its distance kept
    ctx = correct.context(X, 3000, Q, bad, d, gt)
    v = correct.numbers(ctx, ["malformed", "dist_err", "miss"])
    assert v["malformed"] == 1 and v["dist_err"] > 1e-3 and v["miss"] > 0
    assert not correct.judge(v, {"malformed": 0, "dist_err": 1e-4, "miss": 1.0})
    assert not correct.judge({"x": float("nan")}, {"x": 1.0})
