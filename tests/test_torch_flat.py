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
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels.flatscan import (
    MIN_SPLIT, POINT_TILE, _bias, _finish, flat_topk_plain, masked_plan, merge_split_topk,
    split_floor, split_plan, split_ranges)
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


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "q8"])
def test_torch_flat_index_ignores_index_keywords(data, quantized):
    """FlatIndex.batch_search ignores the keywords of Index.batch_search,
    as the JAX package's does: both packages return the same top-k with
    them, and the port the same lists as without them."""
    X, Q = data
    kw = dict(beam_size=64, cut=1.35, limit=100, rerank_factor=4, two_phase=False)
    want_i, want_d = JFlatIndex(JPointSet.from_numpy(X), quantize=quantized
                                ).batch_search(Q, k=K, **kw)
    fi = FlatIndex(PointSet.from_numpy(X, device="cpu"), quantize=quantized)
    ids, dists = fi.batch_search(Q, k=K, **kw)
    assert_same_topk(ids, dists, np.asarray(want_i), np.asarray(want_d), Q, X,
                     exact=quantized)
    plain_i, plain_d = fi.batch_search(Q, k=K)
    assert torch.equal(ids, plain_i) and torch.equal(dists, plain_d)


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


# ---- kernel 4's split point range and its 3xTF32 arithmetic, on the CPU ----


def split_lists(Q, X, k, metric, S, mask=None, excl=None, n_valid=None):
    """flat_topk_plain over S contiguous id ranges of X, ids made global:
    the (B, S, k) lists the kernel's splits write."""
    n = len(X) if n_valid is None else n_valid
    bounds = np.linspace(0, len(X), S + 1).astype(int)
    ds, ids = [], []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        i, d = flat_topk_plain(
            torch.from_numpy(Q), torch.from_numpy(X[lo:hi]),
            None if mask is None else torch.from_numpy(mask[lo:hi]),
            None if excl is None else torch.from_numpy(excl - lo),
            k=k, metric=metric, n_valid=int(np.clip(n - lo, 0, hi - lo)))
        ds.append(d)
        ids.append(torch.where(i >= 0, i + lo, -1))
    return torch.stack(ds, 1), torch.stack(ids, 1)


@pytest.mark.parametrize("S,k", [(2, 10), (3, 1), (7, 10), (5, 150), (4, 300)])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
def test_torch_flat_merge_split_topk_equals_one_scan(rng, metric, S, k):
    """Integer-valued points and queries force ties across and within the
    splits; k = 150 and 300 exceed the points of a split (600 / S); a mask,
    an exclusion and an invalid tail (n_valid < n) drop points."""
    X = rng.integers(-3, 4, (600, 6)).astype(np.float32)
    Q = rng.integers(-3, 4, (17, 6)).astype(np.float32)
    mask = rng.random(len(X)) < 0.7
    excl = rng.integers(0, len(X), len(Q)).astype(np.int32)
    for mk, ex in ((None, None), (mask, excl)):
        want = flat_topk_plain(torch.from_numpy(Q), torch.from_numpy(X),
                               None if mk is None else torch.from_numpy(mk),
                               None if ex is None else torch.from_numpy(ex),
                               k=k, metric=metric, n_valid=590)
        d, i = split_lists(Q, X, k, metric, S, mk, ex, n_valid=590)
        got_d, got_i = merge_split_topk(d, i, k)
        assert torch.equal(got_i, want[0]) and torch.equal(got_d, want[1])


def test_torch_flat_split_plan():
    """About four waves of CTAs, splits of whole tiles and never below the
    floor: MIN_SPLIT points without a mask, split_floor(k) (4 k, at least a
    tile) in the masked mode; one split where the points are few. Phase 2's
    plan (B = 10,000 over 100K points, k = 10) holds."""
    assert split_floor(10) == POINT_TILE and split_floor(50) == 200
    assert split_plan(10_000, 100_000, 264) == (7, 14336)
    assert split_plan(64, 70_000, 264)[0] > 1
    assert split_plan(1, 100, 264) == (1, POINT_TILE)
    assert split_plan(5, 0, 132) == (1, POINT_TILE)
    assert split_plan(2000, 5256, 132) == (1, 5376)
    # a few thousand points fill the card in the masked mode: HNSW's
    # level 1 at 2,000 rows
    S, per = split_plan(2000, 5256, 132, split_floor(50))
    assert S * -(-2000 // 64) >= 132 and per >= split_floor(50)
    for floor in (MIN_SPLIT, *(split_floor(k) for k in (1, 10, 64, 256))):
        for B in (1, 64, 300, 10_000, 200_000):
            for n in (1, 127, 4095, 4096, 70_000, 1_000_000):
                for slots in (132, 264):
                    S, per = split_plan(B, n, slots, floor)
                    assert per % POINT_TILE == 0 and (S - 1) * per < n <= S * per
                    assert S == 1 or per >= floor


@pytest.mark.parametrize("count,S,min_tiles", [
    (0, 5, 1), (1, 5, 4), (128, 13, 4), (2597, 13, 4), (2597, 5, 1), (48_000, 5, 4),
    (100_000, 5, 4), (129, 200, 1)])
def test_torch_flat_split_ranges_cover_the_count(count, S, min_tiles):
    """The masked mode's splits, as the card cuts them from the count:
    contiguous whole tiles in order (the last one ragged), at most S of
    them, none below min_tiles tiles unless it is the last, and together
    exactly [0, count)."""
    r = split_ranges(count, S, min_tiles)
    assert len(r) <= S and [lo for lo, _ in r] == [0, *(hi for _, hi in r)][:len(r)]
    assert (r[-1][1] if r else 0) == count
    for lo, hi in r[:-1]:
        assert lo % POINT_TILE == 0 and (hi - lo) >= min_tiles * POINT_TILE
    S_h, mt = masked_plan(2000, 5256, 132, 50)
    assert S_h > 1 and mt * POINT_TILE >= split_floor(50)


def compacted(X, mask, n_valid, metric):
    """The masked mode's compaction in PyTorch: the valid ids in ascending
    order (mask set, id below n_valid, finite bias)."""
    bias = _bias(torch.from_numpy(X), torch.from_numpy(mask), n_valid, metric)
    return torch.nonzero(bias < INF)[:, 0]


def masked_split_lists(Q, X, mask, excl, k, metric, n_valid, S, min_tiles):
    """flat_topk_plain over each split of the compacted in-mask order
    (split_ranges), ids made global, the exclusion given by global id:
    the (B, splits, k) lists the card's masked splits write."""
    ids = compacted(X, mask, n_valid, metric)
    q = torch.from_numpy(Q)
    ds, out = [], []
    for lo, hi in split_ranges(len(ids), S, min_tiles):
        sub = ids[lo:hi]
        at = torch.searchsorted(sub, torch.from_numpy(excl).long())
        hit = (at < len(sub)) & (sub[at.clamp(max=len(sub) - 1)] == torch.from_numpy(excl))
        ex_local = torch.where(hit, at, -1).to(torch.int32)
        i, d = flat_topk_plain(q, torch.from_numpy(X)[sub], None, ex_local, k=k,
                               metric=metric, n_valid=len(sub))
        ds.append(d)
        out.append(torch.where(i >= 0, sub[i.long().clamp(min=0)], -1).to(torch.int32))
    if not ds:
        return (torch.full((len(Q), 0, k), INF), torch.full((len(Q), 0, k), -1,
                                                             dtype=torch.int32))
    return torch.stack(ds, 1), torch.stack(out, 1)


@pytest.mark.parametrize("case,S,min_tiles,k", [
    ("random", 3, 1, 64),    # three splits of whole tiles, the last ragged
    ("random", 7, 1, 300),   # k larger than a split (one tile each)
    ("prefix", 4, 2, 50),    # the exact build's inserted prefix
    ("few", 5, 1, 50),       # fewer valid points than k: empty slots
    ("empty", 5, 1, 10),     # an all-false mask: no split holds a point
])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
def test_torch_flat_masked_splits_merge_to_one_scan(rng, metric, case, S, min_tiles, k):
    """Integer points and queries force ties within and across the splits
    of the compacted order; merge_split_topk of the splits' lists equals one
    scan with the mask, an exclusion (in or outside the mask) and an
    invalid tail (n_valid < n)."""
    n, n_valid = 1200, 1190
    X = rng.integers(-3, 4, (n, 6)).astype(np.float32)
    Q = rng.integers(-3, 4, (17, 6)).astype(np.float32)
    mask = {"random": rng.random(n) < 0.7, "prefix": np.arange(n) < 700,
            "few": rng.permutation(n) < 20, "empty": np.zeros(n, bool)}[case]
    excl = rng.integers(0, n, len(Q)).astype(np.int32)
    excl[:3] = np.flatnonzero(mask)[:3] if mask.sum() >= 3 else excl[:3]
    want = flat_topk_plain(torch.from_numpy(Q), torch.from_numpy(X),
                           torch.from_numpy(mask), torch.from_numpy(excl), k=k,
                           metric=metric, n_valid=n_valid)
    d, i = masked_split_lists(Q, X, mask, excl, k, metric, n_valid, S, min_tiles)
    got_d, got_i = merge_split_topk(d, i, k)
    if d.shape[1] == 0:  # no split: every slot empty
        got_d, got_i = torch.full((len(Q), k), INF), torch.full((len(Q), k), -1)
    assert torch.equal(got_i.to(torch.int32), want[0]) and torch.equal(got_d, want[1])
    if case == "few":
        assert (want[0][:, 20:] == -1).all()


@pytest.mark.parametrize("k", [50, 64, 128])
@pytest.mark.parametrize("mask_kind", ["random", "prefix"])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_flat_topk_plain_masked_wide_k(data, dtype, mask_kind, k):
    """The masked mode's k (HNSW's efc = 50, the exact build's 64, and 128)
    over a random and a prefix mask, each row excluding one id, on f32
    points and on the q8 tier: flat_topk_plain against the JAX oracle."""
    X, Q = points_and_queries(data, dtype, Metric.L2)
    g = np.random.default_rng(k)
    mask = (g.random(len(X)) < 0.5 if mask_kind == "random"
            else np.arange(len(X)) < len(X) // 3)
    excl = g.integers(0, len(X), len(Q)).astype(np.int32)
    want_i, want_d = oracle(Q, X, k, JMetric.L2, mask=mask, excl=excl)
    ids, dists = flat_topk_plain(
        torch.from_numpy(Q), torch.from_numpy(X), torch.from_numpy(mask),
        torch.from_numpy(excl), k=k, metric=Metric.L2, n_valid=len(X), chunk=700)
    ids = ids.numpy()
    assert mask[ids[ids >= 0]].all() and not (ids == excl[:, None]).any()
    assert_same_topk(ids, dists, want_i, want_d, Q, X, exact=dtype == "int8")


def tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on the f32 bit pattern: add half a TF32 ulp, clear
    the 13 low bits (ties away from zero)."""
    return ((a.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def dot_3xtf32(Q: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """The kernel's products: each operand split into hi = rna(a) and
    lo = rna(a - hi); lo_q.hi_x + hi_q.lo_x + hi_q.hi_x summed in f32 (the
    int8 points' lo is 0)."""
    qh = tf32_rna(Q)
    ql = tf32_rna(Q - qh)
    xh = tf32_rna(X)
    xl = tf32_rna(X - xh)
    return ql @ xh.T + qh @ xl.T + qh @ xh.T


def topk_3xtf32(Q, X, k, metric):
    """The kernel's function with its arithmetic emulated: select on
    bias + scale * (3xTF32 dot), stable by id, finish as the wrapper does."""
    q, x = torch.from_numpy(Q), torch.from_numpy(X)
    bias = _bias(x, None, len(X), metric)
    scale = -1.0 if metric is Metric.MIPS else -2.0
    sel = torch.where(bias[None] < INF, bias[None] + scale * dot_3xtf32(q, x.float()), INF)
    d, order = torch.sort(sel, dim=1, stable=True)
    return _finish(d[:, :k], order[:, :k], q, metric)


def test_torch_flat_tf32_split_error_bound(rng):
    """hi + lo carries 22 bits: each emulated product misses at most about
    3 * 2^-22 of |q_i x_i| (the dropped lo.lo term and the two roundings),
    plus the f32 sum's own rounding."""
    Q = (rng.standard_normal((40, 96)) * 10).astype(np.float32)
    X = rng.standard_normal((300, 96)).astype(np.float32)
    got = dot_3xtf32(torch.from_numpy(Q), torch.from_numpy(X)).double().numpy()
    want = Q.astype(np.float64) @ X.astype(np.float64).T
    absdot = np.abs(Q.astype(np.float64)) @ np.abs(X.astype(np.float64)).T
    assert (np.abs(got - want) <= (3 * 2.0 ** -22 + 96 * 2.0 ** -24) * absdot).all()
    # a single TF32 pass misses by up to 2^-10 relative: far outside
    one = (tf32_rna(torch.from_numpy(Q)) @ tf32_rna(torch.from_numpy(X)).T).double()
    assert (np.abs(one.numpy() - want) > 1e-4 * absdot).any()


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("source", ["gaussian", "clustered"])
def test_torch_flat_3xtf32_within_tolerance(data, rng, source, metric):
    """Selecting on the emulated 3xTF32 distances passes the f32 tolerance
    of the module doc against flat_topk_plain."""
    tm, _ = METRICS[metric]
    if source == "clustered":
        X, Q = data
    else:
        X = rng.standard_normal((3000, 32)).astype(np.float32)
        Q = rng.standard_normal((64, 32)).astype(np.float32)
    want_i, want_d = flat_topk_plain(torch.from_numpy(Q), torch.from_numpy(X), k=K,
                                     metric=tm, n_valid=len(X))
    ids, dists = topk_3xtf32(Q, X, K, tm)
    assert_same_topk(ids.numpy(), dists.numpy(), want_i.numpy(), want_d.numpy(), Q, X,
                     exact=False)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_flat_3xtf32_int8_integer_queries_equal(data, metric):
    """On the q8 tier (int8 points, integer-valued translated queries) lo is
    0 on both sides and every sum an exact integer: equal to the plain
    version."""
    tm, _ = METRICS[metric]
    X, Q = points_and_queries(data, "int8", tm)
    want = flat_topk_plain(torch.from_numpy(Q), torch.from_numpy(X), k=K, metric=tm,
                           n_valid=len(X))
    got = topk_3xtf32(Q, X, K, tm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("k", [2, 7, 64])
def test_torch_flat_smallest_by_key_equals_stable_sort(rng, k):
    """The keyed selection of ``flat_topk_plain`` equals the first k of a
    stable sort: ties (many equal values, -0.0 beside +0.0), negative
    distances (MIPS), INF sentinels."""
    from parlayann_tpu_torch.ops.kernels.flatscan import smallest_by_key

    d = torch.from_numpy(rng.integers(-5, 6, (50, 300)).astype(np.float32)) * 0.5
    d[:, ::7] = 3.0e38
    d[:5, :40] = -0.0
    d[5:10, :40] = 0.0
    got_d, got_p = smallest_by_key(d, k)
    want_d, want_p = torch.sort(d, dim=1, stable=True)
    assert torch.equal(got_p, want_p[:, :k]) and torch.equal(got_d, want_d[:, :k])
