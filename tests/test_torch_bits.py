"""The 1-bit and JL search tiers, port vs JAX package.

Inputs are made with numpy from a seed and fed to both packages; the JAX
side reaches its Pallas kernels in interpret mode, as its own tests run
them. Packed words compare through ``.view(np.uint32)`` (the port keeps
the same bits in int32). The bit ops, kernel 6's plain version and the
beams are exact integer arithmetic, so they must be equal. The JL
projections sum in another order: they agree to rtol 1e-5, and a bit or
an int8 level may differ only where the projected value lies within that
tolerance of its threshold or rounding boundary. The CUDA kernel itself is
held to the plain version on the card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu.types import BuildParams, Metric as JMetric
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.build.vamana import build_vamana_graph as jbuild_graph
from parlayann_tpu.index import Index as JIndex
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.ops.pallas.expand import (
    build_inline as jbuild_inline, build_inline_bits_flat as jbuild_flat,
    expand_bits_flat as jexpand_bits_flat, expand_distances as jexpand_distances)
from parlayann_tpu.search.beam import beam_search_batch as jbeam_batch

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.expand import (
    build_inline_bits, expand_bits_flat, expand_bits_flat_plain,
    expand_distances, expand_distances_plain)
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.harness.recall import compute_recall

torch.set_num_threads(1)
K = 10
RTOL = 1e-5


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def words(x):
    """Packed words of either package as uint32."""
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).view(np.uint32)


def both_points(X, metric="l2"):
    return (JPointSet.from_numpy(X, metric=metric),
            PointSet.from_numpy(X, metric=metric, device="cpu"))


@pytest.mark.parametrize("n,metric", [(203, "l2"), (200, "l2"), (200, "mips")],
                         ids=["l2-odd-n", "l2-even-n", "mips"])
def test_torch_bit_quantize_bit_equal(rng, n, metric):
    """Median thresholds (the mean of the two middle values at even n),
    packed words, translated queries, and the ops on them."""
    d = 100  # a partial last word
    X = rng.standard_normal((n, d)).astype(np.float32)
    X[:7, 3] = np.float32(0.25)  # values equal to a threshold stay 0 (strict >)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    jps, tps = both_points(X, metric)
    jb, tb = jquantize.bit_quantize(jps), quantize.bit_quantize(tps)
    assert tb.bits == 1 and tb.data.dtype == torch.int32
    assert tb.data.shape == jb.data.shape == (jps.n_pad, 4)
    np.testing.assert_array_equal(tb.quant_offset.numpy(), np.asarray(jb.quant_offset))
    np.testing.assert_array_equal(words(tb.data), words(jb.data))
    jq = jquantize.bit_translate_query(jnp.asarray(Q), jb)
    tq = quantize.bit_translate_query(t(Q), tb)
    np.testing.assert_array_equal(words(tq), words(jq))
    cand = rng.integers(0, n, (30, 17))
    np.testing.assert_array_equal(
        quantize.hamming_distance(tq, tb.data[t(cand)]).numpy(),
        np.asarray(jquantize.hamming_distance(jq, jb.data[jnp.asarray(cand)])))
    np.testing.assert_array_equal(
        quantize.hamming_all_pairs(tq, tb.data).numpy(),
        np.asarray(jquantize.hamming_all_pairs(jq, jb.data)))


def test_torch_pack_bits_sign_bit(rng):
    """Bit 31 set makes a word negative in int32; the bits are the JAX
    package's, and popcount counts it."""
    bits = rng.integers(0, 2, (40, 96)).astype(np.uint32)
    bits[:, 31] = 1
    got = quantize._pack_bits(t(bits.astype(bool)))
    np.testing.assert_array_equal(words(got), words(jquantize._pack_bits(jnp.asarray(bits))))
    assert (got[:, 0] < 0).all()
    np.testing.assert_array_equal(quantize.popcount(got).sum(1).numpy(), bits.sum(1))


@pytest.mark.parametrize("bits,sparse_nnz", [(1, 0), (8, 0), (8, 6)],
                         ids=["bits1", "bits8", "bits8-sparse6"])
def test_torch_jl_tier_matches_jax(rng, bits, sparse_nnz):
    """The port's JLTier over the JAX projection matrix."""
    n, d, jl_dims = 300, 96, 64
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    jps, tps = both_points(X)
    jt = jquantize.JLTier(jps, jl_dims=jl_dims, bits=bits, seed=3,
                          sparse_nnz=sparse_nnz)
    proj = np.array(jt.proj)
    tt = quantize.JLTier(tps, bits=bits, proj=proj)
    assert tt.jl_dims == jl_dims and tt.points.bits == bits
    want_p = np.asarray(jps.data) @ proj
    got_p = tt.project(tps.data).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=RTOL, atol=RTOL * np.abs(want_p).max())
    tol = RTOL * np.abs(want_p).max()
    if bits == 1:
        thr = np.asarray(jt.points.quant_offset)
        np.testing.assert_allclose(tt.points.quant_offset.numpy(), thr, rtol=RTOL, atol=tol)
        got_b = np.unpackbits(words(tt.points.data).view(np.uint8), axis=1,
                              bitorder="little")[:, :jl_dims]
        want_b = np.unpackbits(words(jt.points.data).view(np.uint8), axis=1,
                               bitorder="little")[:, :jl_dims]
        differ = got_b != want_b
        # a flipped bit only where the projection sits on its threshold
        assert (np.abs(want_p - thr[None, :])[differ] <= 2 * tol).all()
        assert differ.sum() <= 0.001 * differ.size, differ.sum()
    else:
        jq, tq = jt.points, tt.points
        got_l = tq.data.numpy().astype(np.int32)
        want_l = np.asarray(jq.data).astype(np.int32)
        differ = got_l != want_l
        assert (np.abs(got_l - want_l) <= 1).all()
        # a level differs only next to a rounding boundary
        pos = (want_p - float(jq.quant_offset)) * float(jq.quant_slope)
        assert (np.abs(np.abs(pos - np.floor(pos)) - 0.5)[differ] <= 1e-3).all()
        assert differ.sum() <= 0.001 * differ.size, differ.sum()
        np.testing.assert_allclose(float(tq.quant_slope), float(jq.quant_slope), rtol=RTOL)
    q_t = tt.translate_query(t(Q))
    q_j = np.asarray(jt.translate_query(jnp.asarray(Q)))
    if bits == 1:
        assert q_t.dtype == torch.int32 and q_t.shape == q_j.shape
    else:
        assert (np.abs(q_t.numpy() - q_j) <= 1).all()


@pytest.mark.parametrize("sparse_nnz", [0, 6])
def test_torch_jl_projection_matrix(sparse_nnz):
    """The port's own draw: the JAX construction from a torch.Generator."""
    d, jl_dims = 96, 64
    p = quantize.jl_projection_matrix(d, jl_dims, seed=4, sparse_nnz=sparse_nnz)
    assert p.shape == (d, jl_dims) and p.dtype == torch.float32
    assert torch.equal(p, quantize.jl_projection_matrix(d, jl_dims, seed=4,
                                                        sparse_nnz=sparse_nnz))
    scale = sparse_nnz or jl_dims
    nz = p[p != 0].abs()
    torch.testing.assert_close(nz, torch.full_like(nz, scale ** -0.5), rtol=0, atol=1e-7)
    if sparse_nnz:
        assert ((p != 0).sum(0) == sparse_nnz).all()
    else:
        assert (p != 0).all() and 0.3 < float((p > 0).float().mean()) < 0.7


@pytest.mark.parametrize("d", [64, 96, 100, 128, 1024])
def test_torch_expand_bits_plain_matches_jax(rng, d):
    """Kernel 6's plain version and the bits=1 route of expand_distances
    against the JAX kernels (interpret mode): equal hamming counts."""
    n, R, B = 256, 18, 48
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((B, d)).astype(np.float32)
    nbrs = rng.integers(0, n, (n, R)).astype(np.int32)
    ids = rng.integers(0, n, B).astype(np.int32)
    jps, tps = both_points(X)
    jb, tb = jquantize.bit_quantize(jps), quantize.bit_quantize(tps)
    jq = jquantize.bit_translate_query(jnp.asarray(Q), jb)
    tq = quantize.bit_translate_query(t(Q), tb)
    jinl = jbuild_inline(jb.data, jnp.asarray(nbrs))
    tinl = build_inline_bits(tb.data, t(nbrs))
    assert tinl.shape == (n, 24, (d + 31) // 32) and tinl.dtype == torch.int32
    np.testing.assert_array_equal(words(tinl), words(jinl))
    want = np.asarray(jexpand_bits_flat(jbuild_flat(jb.data, jnp.asarray(nbrs)),
                                        jnp.asarray(ids), jq))[:, :R]
    got = expand_bits_flat_plain(tinl, t(ids), tq)
    np.testing.assert_array_equal(got[:, :R].numpy(), want)
    before = expand_bits_flat.launches
    assert torch.equal(expand_bits_flat(tinl, t(ids), tq), got)  # CPU: the plain version
    assert expand_bits_flat.launches == before
    want_e = np.asarray(jexpand_distances(jinl, jnp.asarray(ids), jq,
                                          metric=JMetric.L2, bits=1))
    np.testing.assert_array_equal(
        expand_distances_plain(tinl, t(ids), tq, metric=Metric.L2, bits=1).numpy(), want_e)
    np.testing.assert_array_equal(
        expand_distances(tinl, t(ids), tq, metric=Metric.L2, bits=1).numpy(), want_e)


# ---------------------------------------------------------------------------
# The tiers end to end on one JAX-built graph, carried across through interop
# ---------------------------------------------------------------------------

TIERS = {
    # (enable_* arguments, recall floor of tests/test_quantized.py:88/201/208)
    "bit": (None, 0.5),
    "jl128-bits1": (dict(jl_dims=128, bits=1), 0.5),
    "jl64-bits8-sparse6": (dict(jl_dims=64, bits=8, sparse_nnz=6), 0.55),
}


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(42)
    n, d = 800, 96
    X = rng.standard_normal((n, d)).astype(np.float32)
    Q = rng.standard_normal((30, d)).astype(np.float32)
    jps = JPointSet.from_numpy(X)
    bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25)
    jg, _ = jbuild_graph(jps, bp)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :2 * K]
    tps = interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, jps.metric,
                                      device="cpu")
    tg = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                  jg.n, jg.max_degree, device="cpu")
    return dict(X=X, Q=Q, jps=jps, jg=jg, tps=tps, tg=tg, gt=gt,
                gt_d=np.take_along_axis(d64, gt, 1))


def carried(jtier_ps):
    """A JAX tier PointSet through interop."""
    off = None if jtier_ps.quant_offset is None else np.asarray(jtier_ps.quant_offset)
    slope = None if jtier_ps.quant_slope is None else np.asarray(jtier_ps.quant_slope)
    return interop.pointset_from_state(
        np.asarray(jtier_ps.data), jtier_ps.n, jtier_ps.d, jtier_ps.metric,
        bits=jtier_ps.bits, quant_slope=slope, quant_offset=off, device="cpu")


def both_indexes(b, tier):
    jidx = JIndex(points=b["jps"], graph=b["jg"])
    kw, _ = TIERS[tier]
    if kw is None:
        jidx.enable_bit_tier()
        tidx = interop.index_from_state(b["tps"], b["tg"],
                                        bit_points=carried(jidx.bit_points))
    else:
        jidx.enable_jl(**kw)
        jt = jidx.jl_tier
        tj = interop.jl_tier_from_state(b["tps"], np.asarray(jt.proj), jt.bits,
                                        carried(jt.points))
        tidx = interop.index_from_state(b["tps"], b["tg"], jl_tier=tj)
    return jidx, tidx


def test_torch_bit_tier_state_carries_over(built):
    """The JAX bit tier through interop is the port's own bit tier: the
    uint32 words keep their bits and the (d,) thresholds stay a vector."""
    jb = JIndex(points=built["jps"], graph=built["jg"]).enable_bit_tier().bit_points
    moved = carried(jb)
    own = pt.Index(points=built["tps"], graph=built["tg"]).enable_bit_tier().bit_points
    assert moved.quant_offset.shape == (96,) and moved.data.dtype == torch.int32
    assert torch.equal(moved.data, own.data)
    assert torch.equal(moved.quant_offset, own.quant_offset)
    assert (moved.n, moved.d, moved.bits, moved.metric) == (own.n, own.d, 1, own.metric)


@pytest.mark.parametrize("use_inline", [True, False], ids=["inline", "gather"])
def test_torch_beam_search_bits_matches_jax(built, use_inline):
    """beam_search_batch(bits=1) on the bit tier of the JAX graph: beams,
    distances, visits and distance counts equal the JAX package's, through
    kernel 6's inline path and through the gather path."""
    b = built
    jidx, tidx = both_indexes(b, "bit")
    jb, tb = jidx.bit_points, tidx.bit_points
    Q = b["Q"]
    jq = jquantize.bit_translate_query(jnp.asarray(Q), jb)
    tq = quantize.bit_translate_query(t(Q), tb)
    starts = np.zeros(1, np.int32)
    kw = dict(n_valid=jb.n, k=0, L=40, limit=jb.n, bits=1)
    jinl = jbuild_flat(jb.data, b["jg"].neighbors) if use_inline else None
    want = jbeam_batch(jq, jb.data, b["jg"].neighbors, b["jg"].degrees,
                       jnp.asarray(starts), None, jinl, metric=JMetric.L2,
                       use_inline=use_inline, **kw)
    tinl = tidx.build_inline_bits_cache(tb) if use_inline else None
    got = beam_search_batch(tq, tb.data, b["tg"].neighbors, b["tg"].degrees, t(starts),
                            None, tinl, metric=Metric.L2, **kw)
    for name in ("beam_ids", "beam_dists", "num_visited", "dist_cmps"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("tier", list(TIERS))
def test_torch_tier_search_matches_jax(built, tier):
    """Index.batch_search on each tier: the same ids as the JAX Index, the
    reranked f32 distances within rtol 1e-5, and each package's recall
    over the floor of tests/test_quantized.py."""
    b = built
    jidx, tidx = both_indexes(b, tier)
    kw = dict(k=K, beam_size=64, rerank_factor=10)
    j_ids, j_d, _ = jidx.batch_search(b["Q"], **kw)
    ids, dists, res = tidx.batch_search(b["Q"], **kw)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(dists.numpy(), np.asarray(j_d), rtol=RTOL)
    X, Q = b["X"], b["Q"]
    want = ((X[ids.numpy()] - Q[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dists.numpy(), want, rtol=1e-4, atol=1e-4)
    _, floor = TIERS[tier]
    for name, got in (("torch", ids.numpy()), ("jax", np.asarray(j_ids))):
        r = compute_recall(got, b["gt"], b["gt_d"], K)
        assert r >= floor, (name, tier, r)
    assert (res.num_visited > 0).all()


def test_torch_inline_bits_cache_follows_the_tier(built):
    """A search on the bit tier, then on a JL sign-bit tier: the inline
    words are rebuilt at the new W, so the second search is the one an
    index with only the JL tier gives."""
    b = built
    idx = pt.Index(points=b["tps"], graph=b["tg"]).enable_bit_tier()
    idx.batch_search(b["Q"], k=K, beam_size=32)
    assert idx.inline_bits.shape[2] == 3 and idx._inline_bits_src is idx.bit_points
    idx.bit_points = None
    idx.enable_jl(jl_dims=128, bits=1)
    ids, dists, _ = idx.batch_search(b["Q"], k=K, beam_size=32)
    assert idx.inline_bits.shape[2] == 4 and idx._inline_bits_src is idx.jl_tier.points
    fresh = pt.Index(points=b["tps"], graph=b["tg"])
    fresh.jl_tier = idx.jl_tier
    want_ids, want_d, _ = fresh.batch_search(b["Q"], k=K, beam_size=32)
    assert torch.equal(ids, want_ids) and torch.equal(dists, want_d)


def test_torch_lock_step_tiers_take_expand_and_degree_limit(built):
    """expand > 1 and degree_limit < R run on the lock-step 1-bit tier, and
    so do random starts: ``random_starts=2, seed=1`` searches from
    ``default_rng(1).integers(0, n, (B, 2))``."""
    b = built
    idx = pt.Index(points=b["tps"], graph=b["tg"]).enable_bit_tier()
    for kw in (dict(expand=2), dict(degree_limit=8)):
        ids, _, _ = idx.batch_search(b["Q"], k=K, beam_size=32, **kw)
        assert ids.shape == (len(b["Q"]), K) and (ids >= 0).all()
        assert compute_recall(ids.numpy(), b["gt"], b["gt_d"], K) >= 0.3
    got = idx.batch_search(b["Q"], k=K, beam_size=32, random_starts=2, seed=1)[0]
    starts = np.random.default_rng(1).integers(0, b["tps"].n, (len(b["Q"]), 2))
    assert torch.equal(got, idx.batch_search(b["Q"], k=K, beam_size=32, starts=starts)[0])
    assert compute_recall(got.numpy(), b["gt"], b["gt_d"], K) >= 0.3


def test_torch_jl_project_shapes(rng):
    """jl_project, the tier's points alone (tests/test_ops.py:117-123)."""
    X = rng.standard_normal((50, 40)).astype(np.float32)
    ps = PointSet.from_numpy(X, device="cpu")
    jl = quantize.jl_project(ps, jl_dims=32, bits=8, seed=1)
    assert jl.d == 32 and jl.data.shape == (ps.n_pad, 32) and jl.data.dtype == torch.int8
    jl1 = quantize.jl_project(ps, jl_dims=64, bits=1, seed=1)
    assert jl1.bits == 1 and jl1.data.shape == (ps.n_pad, 2) and jl1.data.dtype == torch.int32
    jl4 = quantize.jl_project(ps, jl_dims=32, bits=4, seed=1)
    assert jl4.bits == 4 and jl4.data.dtype == torch.int8 and jl4.data.shape == (ps.n_pad, 32)
    assert int(jl4.data[:ps.n].min()) == -128 and int(jl4.data[:ps.n].max()) == -113
