"""Flat search, port vs JAX package: ``flat_search_batch`` (every select),
``flat_topk_plain`` (kernel 4's plain version), ``FlatIndex`` and
``exact_knn``, on the same numpy inputs.

The oracle is the JAX ``flat_search_batch(select="sort",
precision="exact")``, which orders its results by (distance, id), as the
port does. On int8 points with integer-valued queries every distance is an
exact integer, so ids and distances must be equal. On f32 points the two
packages sum the dot products in another order, and the L2 algebra
``||x||^2 - 2 q.x + ||q||^2`` cancels the norms down to the distance, so
the rounding is relative to the norms: distances agree to rtol 1e-5 plus
1e-6 x (||q||^2 + max ||x||^2), and ids agree except where two distances
lie within that tolerance of each other.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu.types import Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.search.flat import FlatIndex as JFlatIndex
from parlayann_tpu.search.flat import flat_search_batch as jflat
from parlayann_tpu.ops.pallas.flatscan import flat_topk_pallas

from parlayann_tpu_torch import interop
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk_plain
from parlayann_tpu_torch.search.flat import FlatIndex, flat_search_batch
from parlayann_tpu_torch.search.exact import exact_knn
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K = 10
METRICS = {"l2": (Metric.L2, JMetric.L2), "mips": (Metric.MIPS, JMetric.MIPS)}


@pytest.fixture(scope="module")
def data():
    X, Q = synthetic.clustered(3000, 32, n_queries=64, n_clusters=40, seed=3)
    return X, Q


def points_and_queries(data, dtype, metric):
    """(points, queries) as numpy: f32 as generated, or the q8 tier with
    queries translated into its domain (integer-valued f32)."""
    X, Q = data
    if dtype == "f32":
        return X, Q
    ps = quantize.quantize_pointset(PointSet.from_numpy(X, metric=metric,
                                                     device="cpu"))
    q = quantize.translate_query(torch.from_numpy(Q), ps).float()
    return ps.data[:len(X)].numpy(), q.numpy()


def oracle(Q, X, k, jmetric, mask=None, excl=None):
    args = [jnp.asarray(Q), jnp.asarray(X)]
    if mask is not None or excl is not None:
        args += [None if mask is None else jnp.asarray(mask),
                 None if excl is None else jnp.asarray(excl)]
    ids, dists = jflat(*args, k=k, metric=jmetric, n_valid=len(X), chunk=1024,
                       select="sort", precision="exact")
    return np.asarray(ids), np.asarray(dists)


def assert_same_topk(ids, dists, want_ids, want_d, Q, X, exact):
    """Equal (ids, dists) lists up to the tolerance in the module doc."""
    ids, dists = np.asarray(ids), np.asarray(dists)
    if exact:
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_array_equal(dists, want_d)
        return
    Xf = np.asarray(X, np.float64)
    scale = (np.asarray(Q, np.float64) ** 2).sum(1) + (Xf ** 2).sum(1).max()
    tol = 1e-5 * np.abs(want_d) + 1e-6 * scale[:, None]
    assert (np.abs(dists - want_d) <= tol).all()
    for r in np.flatnonzero((ids != want_ids).any(axis=1)):
        # an id in one list only must tie the other list's k-th distance
        only = ~np.isin(ids[r], want_ids[r])
        assert (np.abs(dists[r][only] - want_d[r, -1]) <= tol[r, -1]).all(), r
        only = ~np.isin(want_ids[r], ids[r])
        assert (np.abs(want_d[r][only] - dists[r, -1]) <= tol[r, -1]).all(), r


@pytest.mark.parametrize("select", ["sort", "groupmin", "approx", "pallas"])
@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_flat_search_matches_jax(data, select, metric, dtype):
    """Every select is the exact top-k here; "pallas" on CPU tensors is
    kernel 4's plain version."""
    tm, jm = METRICS[metric]
    X, Q = points_and_queries(data, dtype, tm)
    want_i, want_d = oracle(Q, X, K, jm)
    ids, dists = flat_search_batch(torch.from_numpy(Q), torch.from_numpy(X),
                                   k=K, metric=tm, n_valid=len(X), chunk=1024,
                                   select=select, precision="exact")
    assert ids.dtype == torch.int32 and ids.shape == (len(Q), K)
    assert_same_topk(ids, dists, want_i, want_d, Q, X, exact=dtype == "int8")


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_flat_topk_plain_mask_exclude(data, metric, dtype):
    """valid_mask keeps the first half of the points; exclude_ids drops each
    query's nearest valid point. A chunk of 100 puts many chunk seams
    inside each top-k."""
    tm, jm = METRICS[metric]
    X, Q = points_and_queries(data, dtype, tm)
    mask = np.zeros(len(X), bool)
    mask[: len(X) // 2] = True
    first, _ = oracle(Q, X, 1, jm, mask=mask)
    excl = first[:, 0].astype(np.int32)
    want_i, want_d = oracle(Q, X, K, jm, mask=mask, excl=excl)
    ids, dists = flat_topk_plain(
        torch.from_numpy(Q), torch.from_numpy(X), torch.from_numpy(mask),
        torch.from_numpy(excl), k=K, metric=tm, n_valid=len(X), chunk=100)
    ids = ids.numpy()
    assert ids.max() < len(X) // 2
    assert not (ids == excl[:, None]).any()
    assert_same_topk(ids, dists, want_i, want_d, Q, X, exact=dtype == "int8")


def test_torch_flat_topk_wide_k_and_few_points(rng):
    """k = 128 over 100 valid points of 104: 28 empty slots (-1, INF)."""
    X = rng.standard_normal((104, 16)).astype(np.float32)
    Q = rng.standard_normal((5, 16)).astype(np.float32)
    want_i, want_d = oracle(Q, X[:100], 128, JMetric.L2)
    ids, dists = flat_topk_plain(torch.from_numpy(Q), torch.from_numpy(X), k=128,
                                 metric=Metric.L2, n_valid=100, chunk=32)
    ids, dists = ids.numpy(), dists.numpy()
    assert (ids[:, 100:] == -1).all() and (dists[:, 100:] >= 3e38).all()
    assert_same_topk(ids[:, :100], dists[:, :100], want_i[:, :100],
                     want_d[:, :100], Q, X, exact=False)


def test_torch_flatscan_pallas_recall_at_most_port(data):
    """The Pallas kernel approximates the exact top-k (per-lane-class
    pool); the port's kernel function is the exact top-k, recall 1.0."""
    X, Q = data
    jps = JPointSet.from_numpy(X)
    gt_i, gt_d = oracle(Q, X, 2 * K, JMetric.L2)
    pi, _ = flat_topk_pallas(jnp.asarray(Q), jps.data, k=K, metric=jps.metric,
                             n_valid=jps.n, Bt=64, C=512, interpret=True,
                             precision="exact")
    ti, _ = flat_topk_plain(torch.from_numpy(Q), torch.from_numpy(X), k=K,
                            metric=Metric.L2, n_valid=len(X))
    r_pallas = compute_recall(np.asarray(pi), gt_i, gt_d, K)
    r_port = compute_recall(ti.numpy(), gt_i, gt_d, K)
    assert r_port == 1.0
    assert r_pallas <= r_port


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "q8"])
def test_torch_flat_index_matches_jax(data, quantized):
    X, Q = data
    jfi = JFlatIndex(JPointSet.from_numpy(X), quantize=quantized)
    want_i, want_d = jfi.batch_search(Q, k=K)
    fi = FlatIndex(PointSet.from_numpy(X, device="cpu"), quantize=quantized)
    ids, dists = fi.batch_search(Q, k=K, select="pallas")
    if quantized:  # the q8 tier is bit-equal and its distances exact
        np.testing.assert_array_equal(
            fi.qpoints.data.numpy(), np.asarray(jfi.qpoints.data))
    assert_same_topk(ids, dists, np.asarray(want_i), np.asarray(want_d), Q, X,
                     exact=quantized)
    ids_t, _, secs = fi.batch_search_timed(Q, k=K, select="pallas")
    np.testing.assert_array_equal(ids_t.numpy(), ids.numpy())
    assert secs > 0
    # the JAX index's own tier, carried over by interop, searches the same
    jq = jfi.qpoints
    tier = None if jq is None else interop.pointset_from_state(
        np.asarray(jq.data), jq.n, jq.d, jq.metric, bits=jq.bits,
        quant_slope=np.asarray(jq.quant_slope),
        quant_offset=np.asarray(jq.quant_offset), device="cpu")
    fi2 = interop.flat_index_from_state(fi.points, qpoints=tier)
    ids2, dists2 = fi2.batch_search(Q, k=K, select="pallas")
    assert torch.equal(ids2, ids) and torch.equal(dists2, dists)


def test_torch_exact_knn_ties_in_id_order(rng):
    """Every point appears three times, so each distance ties three ways
    and the k-th place falls inside a tie; a chunk of 7 puts ties across
    chunk seams. The ids must come back in (distance, id) order: the JAX
    package's order, which a plain torch.topk does not promise."""
    base = rng.integers(-4, 5, (40, 8)).astype(np.float32)
    X = np.concatenate([base, base, base])
    Q = rng.integers(-4, 5, (9, 8)).astype(np.float32)
    ids, dists = exact_knn(Q, PointSet.from_numpy(X, device="cpu"), 10, chunk=7)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    want = np.argsort(d64, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(ids.numpy(), want)
    np.testing.assert_array_equal(dists.numpy(), np.take_along_axis(d64, want, 1))
    j_ids, _ = oracle(Q, X, 10, JMetric.L2)
    np.testing.assert_array_equal(ids.numpy(), j_ids)


def test_torch_flat_rejects_bad_arguments(data):
    X, Q = data
    q, x = torch.from_numpy(Q), torch.from_numpy(X)
    with pytest.raises(ValueError, match="select"):
        flat_search_batch(q, x, k=K, metric=Metric.L2, n_valid=len(X), select="top")
    with pytest.raises(ValueError, match="precision"):
        flat_search_batch(q, x, k=K, metric=Metric.L2, n_valid=len(X),
                          precision="bf16")
