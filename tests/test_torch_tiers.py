"""The scalar tiers of 1 to 16 bits, the trimmed MIPS scale, the MIPS 2-bit
and 4-bit tiers, the JL tiers of other widths, kernel 1's 16-bit mode and
the two-tier filter: port vs JAX package, on the CPU.

The same numpy inputs go through both packages. The tiers are bit-equal
(the port stores L2 levels of 9 to 16 bits as ``level - 32768`` in int16
where the JAX package keeps uint16, so the JAX levels are shifted before
they are compared). Kernel 1's 16-bit mode sums exact integers in int64
where the JAX kernel sums in f32, so its distances are held to rtol 1e-5.
The searches run both packages' ``Index`` over one JAX graph.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import parlayann_tpu as jpt
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.ops.pallas.expand import expand_distances as jexpand
from parlayann_tpu.search.beam import beam_search_batch as jbeam
from parlayann_tpu.types import Metric as JMetric

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.expand import expand_distances, expand_distances_plain
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, BEAM = 10, 32


def _port_levels(a) -> np.ndarray:
    """A JAX tier's stored levels as the port stores them."""
    a = np.asarray(a)
    if a.dtype == np.uint16:
        return (a.astype(np.int32) - 32768).astype(np.int16)
    return a.view(np.int32) if a.dtype == np.uint32 else a


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("bits", [1, 4, 8, 12, 16])
def test_torch_tiers_quantize_pointset(rng, metric, bits):
    """Levels equal after the storage shift, slope and offset within rtol
    1e-6, translated queries equal."""
    X = rng.standard_normal((203, 33)).astype(np.float32) * 3.0
    Q = rng.standard_normal((17, 33)).astype(np.float32) * 4.0  # some clamp
    jps = jquantize.quantize_pointset(JPointSet.from_numpy(X, metric=metric), bits=bits)
    tps = quantize.quantize_pointset(PointSet.from_numpy(X, metric=metric, device="cpu"),
                                     bits=bits)
    assert tps.data.dtype == (torch.int8 if bits <= 8 else torch.int16)
    np.testing.assert_array_equal(tps.data.numpy(), _port_levels(jps.data))
    np.testing.assert_allclose(float(tps.quant_slope), float(jps.quant_slope), rtol=1e-6)
    np.testing.assert_allclose(float(tps.quant_offset), float(jps.quant_offset), rtol=1e-6)
    np.testing.assert_array_equal(
        quantize.translate_query(torch.from_numpy(Q), tps).numpy(),
        _port_levels(jquantize.translate_query(jnp.asarray(Q), jps)))


@pytest.mark.parametrize("what", ["trim", "cut"])
def test_torch_tiers_quantiles_past_2_24(rng, what):
    """The trimmed MIPS scale and the 2-bit cut equal the JAX quantiles on
    2^24 + 2^18 values, a broadcast of 300 rows (torch.quantile refuses
    more than 2^24)."""
    base = rng.standard_normal((300, 64)).astype(np.float32)
    reps = (2**24 + 2**18) // base.size + 1
    big = np.broadcast_to(base[None], (reps, 300, 64)).reshape(-1, 64)
    assert big.size > 2**24
    tbig = torch.from_numpy(base).expand(reps, 300, 64).reshape(-1, 64)
    if what == "trim":
        js, _ = jquantize.mips_params(jnp.asarray(big), bits=8, trim=0.001)
        ts, _ = quantize.mips_params(tbig, bits=8, trim=0.001)
    else:
        js, ts = jquantize.mips_2bit_params(jnp.asarray(big)), quantize.mips_2bit_params(tbig)
    assert np.float32(ts) == np.float32(js)


def test_torch_tiers_mips_low_bit_ops(rng):
    """The 2-bit and 4-bit tiers, their query translations, distances and
    unpack_int4, bit-equal (odd d pads the 4-bit queries)."""
    X = rng.standard_normal((101, 45)).astype(np.float32)
    Q = rng.standard_normal((9, 45)).astype(np.float32)
    jps = JPointSet.from_numpy(X, metric="mips")
    tps = PointSet.from_numpy(X, metric="mips", device="cpu")
    pick = rng.integers(0, 101, (9, 7))
    j2, t2 = jquantize.mips_2bit_quantize(jps), quantize.mips_2bit_quantize(tps)
    np.testing.assert_array_equal(t2.data.numpy(), _port_levels(j2.data))
    assert np.float32(t2.quant_offset) == np.float32(j2.quant_offset)
    jw = jquantize.mips_2bit_translate_query(jnp.asarray(Q), j2)
    tw = quantize.mips_2bit_translate_query(torch.from_numpy(Q), t2)
    np.testing.assert_array_equal(tw.numpy(), _port_levels(jw))
    np.testing.assert_array_equal(
        quantize.mips_2bit_distance(tw, t2.data[torch.from_numpy(pick)]).numpy(),
        np.asarray(jquantize.mips_2bit_distance(jw, jnp.asarray(np.asarray(j2.data)[pick]))))
    for trim in (0.0, 0.02):
        j4 = jquantize.mips_4bit_quantize(jps, trim=trim)
        t4 = quantize.mips_4bit_quantize(tps, trim=trim)
        np.testing.assert_array_equal(t4.data.numpy(), np.asarray(j4.data))
        assert np.float32(t4.quant_slope) == np.float32(j4.quant_slope)
        np.testing.assert_array_equal(quantize.unpack_int4(t4.data).numpy(),
                                      np.asarray(jquantize.unpack_int4(j4.data)))
        jl = jquantize.mips_4bit_translate_query(jnp.asarray(Q), j4)
        tl = quantize.mips_4bit_translate_query(torch.from_numpy(Q), t4)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tl.shape == (9, 46)
        np.testing.assert_array_equal(
            quantize.mips_4bit_distance(tl, t4.data[torch.from_numpy(pick)]).numpy(),
            np.asarray(jquantize.mips_4bit_distance(jl, jnp.asarray(np.asarray(j4.data)[pick]))))
    # every nibble value, both halves, through the arithmetic shifts
    allb = np.arange(-128, 128, dtype=np.int8)[None]
    np.testing.assert_array_equal(quantize.unpack_int4(torch.from_numpy(allb)).numpy(),
                                  np.asarray(jquantize.unpack_int4(jnp.asarray(allb))))


@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("bits", [4, 16])
def test_torch_tiers_jl_widths(rng, metric, bits):
    """JL tiers of 4 and 16 bits, given the JAX matrix. The two packages'
    float32 products sum in other orders, and 16-bit levels resolve their
    last bits: levels within one step of the JAX package's (equal at 4
    bits), and equal when the port quantizes the JAX projections."""
    X = rng.standard_normal((120, 40)).astype(np.float32)
    Q = rng.standard_normal((6, 40)).astype(np.float32)
    jt = jquantize.JLTier(JPointSet.from_numpy(X, metric=metric), jl_dims=32, bits=bits,
                          seed=2)
    tt = quantize.JLTier(PointSet.from_numpy(X, metric=metric, device="cpu"), jl_dims=32,
                         bits=bits, proj=np.array(jt.proj))
    assert tt.points.bits == bits and tt.points.d == 32
    want = _port_levels(jt.points.data).astype(np.int32)
    got = tt.points.data.numpy().astype(np.int32)
    assert np.abs(got - want).max() <= (0 if bits == 4 else 1)
    assert (got == want).mean() >= 0.99
    shift = 32768.0 if (bits > 8 and metric == "l2") else 0.0
    tq = tt.translate_query(torch.from_numpy(Q)).numpy()
    jq = np.asarray(jt.translate_query(jnp.asarray(Q))) - shift
    assert np.abs(tq - jq).max() <= (0 if bits == 4 else 1)
    # the JAX projections, quantized by the port: bit-equal
    jproj = np.asarray(jnp.asarray(X) @ jt.proj)
    own = quantize.quantize_pointset(PointSet.from_numpy(jproj, metric=metric, device="cpu"),
                                     bits=bits)
    np.testing.assert_array_equal(own.data.numpy(), want)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_tiers_expand_distances_int16(rng, metric):
    """Kernel 1's 16-bit function (its plain version on the CPU) against
    the JAX kernel in interpret mode on uint16 (L2) or int16 (MIPS) rows,
    with rows and queries at the extreme levels: rtol 1e-5 (the JAX kernel
    sums in f32, the port in int64)."""
    n, R8, d, B = 40, 16, 128, 24
    if metric == "l2":
        lv = rng.integers(0, 65536, (n, R8, d)).astype(np.uint16)
        lv[:5] = rng.choice([0, 65535], (5, R8, d))
        qlv = rng.integers(0, 65536, (B, d)).astype(np.float32)
        qlv[:4] = np.where(rng.random((4, d)) < 0.5, 0.0, 65535.0)
        t_in, t_q = lv.astype(np.int32) - 32768, qlv - 32768.0
    else:
        lv = rng.integers(-32767, 32768, (n, R8, d)).astype(np.int16)
        lv[:5] = rng.choice([-32767, 32767], (5, R8, d))
        qlv = rng.integers(-32767, 32768, (B, d)).astype(np.float32)
        qlv[:4] = 32767.0
        t_in, t_q = lv, qlv
    ids = rng.integers(-2, n + 2, B).astype(np.int32)
    ids[:4] = rng.integers(0, 5, 4)  # extreme rows against extreme queries
    jm = JMetric.L2 if metric == "l2" else JMetric.MIPS
    want = np.asarray(jexpand(jnp.asarray(lv), jnp.asarray(np.clip(ids, 0, n - 1)),
                              jnp.asarray(qlv), metric=jm))
    m = Metric.coerce(metric)
    inl = torch.from_numpy(t_in.astype(np.int16))
    got = expand_distances(inl, torch.from_numpy(ids), torch.from_numpy(t_q), metric=m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # the exact sums, rounded once: equal to a float64 sum rounded to f32
    rows = t_in[np.clip(ids, 0, n - 1)].astype(np.float64)
    qq = t_q.astype(np.float64)[:, None, :]
    exact = -(rows * qq).sum(-1) if metric == "mips" else ((rows - qq) ** 2).sum(-1)
    np.testing.assert_array_equal(got.numpy(), exact.astype(np.float32))
    assert np.abs(exact).max() > 2**31  # past int32: the reason for int64
    assert torch.equal(got, expand_distances_plain(inl, torch.from_numpy(ids),
                                                   torch.from_numpy(t_q), metric=m))


# ---- the tiers searched by both packages over one JAX graph ----------------

@pytest.fixture(scope="module")
def graphs():
    X, Q = synthetic.clustered(1200, 24, n_queries=48, n_clusters=20,
                               cluster_std=0.35, seed=9)
    out = {}
    for metric in ("l2", "mips"):
        jg, jps, _ = jpt.build_vamana_index(X, metric=metric, R=16, L=32, alpha=1.2)
        P = np.asarray(jps.data)[: jps.n].astype(np.float64)
        q = Q if metric == "l2" else Q / np.linalg.norm(Q, axis=1, keepdims=True)
        dd = (-(q @ P.T) if metric == "mips"
              else ((q[:, None, :].astype(np.float64) - P[None]) ** 2).sum(-1))
        gt = np.argsort(dd, axis=1, kind="stable")[:, :2 * K]
        out[metric] = dict(
            jg=jg, jps=jps, Q=q.astype(np.float32), gt=gt,
            gt_d=np.take_along_axis(dd, gt, 1),
            pts=interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, metric,
                                            device="cpu"),
            g=interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                       jg.n, jg.max_degree, device="cpu"))
    return out


TIERS = {  # name: (metric, enable on an Index of either package, tier field)
    "q16_l2": ("l2", lambda i: i.enable_quantized(bits=16), "qpoints"),
    "q12_l2": ("l2", lambda i: i.enable_quantized(bits=12), "qpoints"),
    "q16_mips": ("mips", lambda i: i.enable_quantized(bits=16), "qpoints"),
    "2bit": ("mips", lambda i: i.enable_mips_2bit(), "t2_points"),
    "4bit": ("mips", lambda i: i.enable_mips_4bit(), "t4_points"),
    "4bit_trim": ("mips", lambda i: i.enable_mips_4bit(trim=0.01), "t4_points"),
    "q8_trim": ("mips", lambda i: i.enable_quantized(bits=8, trim=0.001), "qpoints"),
}


def _tier_state(ps, metric):
    return interop.pointset_from_state(
        np.asarray(ps.data), ps.n, ps.d, metric, bits=ps.bits,
        quant_slope=None if ps.quant_slope is None else np.asarray(ps.quant_slope),
        quant_offset=None if ps.quant_offset is None else np.asarray(ps.quant_offset),
        device="cpu")


@pytest.mark.parametrize("name", list(TIERS))
def test_torch_tiers_search_matches_jax(graphs, name):
    """Each tier, built by both packages on one JAX graph: equal tier
    levels; the port's ids equal the JAX package's except at tied
    distances; recall@10 within 0.01. The JAX tier carried over through
    interop gives the port's own ids."""
    metric, enable, field = TIERS[name]
    b = graphs[metric]
    jidx = enable(jpt.Index(points=b["jps"], graph=b["jg"]))
    tidx = enable(pt.Index(points=b["pts"], graph=b["g"]))
    jtier, ttier = getattr(jidx, field), getattr(tidx, field)
    np.testing.assert_array_equal(ttier.data.numpy(), _port_levels(jtier.data))
    j_ids, j_d, _ = jidx.batch_search(b["Q"], k=K, beam_size=BEAM)
    t_ids, t_d, _ = tidx.batch_search(b["Q"], k=K, beam_size=BEAM)
    j_ids, j_d, t_ids, t_d = map(np.asarray, (j_ids, j_d, t_ids, t_d))
    diff = t_ids != j_ids
    np.testing.assert_allclose(t_d, j_d, rtol=1e-5, atol=1e-6)
    print(f"{name}: {diff.mean():.4f} of ids differ (at tied distances)")
    rj = compute_recall(j_ids, b["gt"], b["gt_d"], K)
    rt = compute_recall(t_ids, b["gt"], b["gt_d"], K)
    assert abs(rt - rj) <= 0.01, (rt, rj)
    carried = interop.index_from_state(b["pts"], b["g"], **{field: _tier_state(jtier, metric)})
    np.testing.assert_array_equal(carried.batch_search(b["Q"], k=K, beam_size=BEAM)[0].numpy(),
                                  t_ids)


def test_torch_tiers_priority(graphs):
    """JAX's tier priority, 1-bit > JL > 2-bit > 4-bit > scalar: with the
    2-bit and 4-bit tiers and a scalar tier all enabled, the search runs on
    the 2-bit tier (k = 0: every query expands its whole beam); without it,
    on the 4-bit tier; the 16-bit scalar tier takes the lock-step search."""
    b = graphs["mips"]
    idx = pt.Index(points=b["pts"], graph=b["g"]).enable_quantized(bits=16)
    only_2 = pt.Index(points=b["pts"], graph=b["g"]).enable_mips_2bit()
    only_4 = pt.Index(points=b["pts"], graph=b["g"]).enable_mips_4bit()
    ids16, _, res16 = idx.batch_search(b["Q"], k=K, beam_size=BEAM)
    assert idx.inline is not None and idx.inline.dtype == torch.int16
    idx.enable_mips_4bit().enable_mips_2bit()
    for want in (only_2, only_4):
        got, _, res = idx.batch_search(b["Q"], k=K, beam_size=BEAM)
        assert torch.equal(got, want.batch_search(b["Q"], k=K, beam_size=BEAM)[0])
        idx.t2_points = None
    idx.t4_points = None
    assert torch.equal(idx.batch_search(b["Q"], k=K, beam_size=BEAM)[0], ids16)


def test_torch_tiers_int8_tier_of_4_bits_takes_kernel_3(graphs, monkeypatch):
    """A 4-bit L2 scalar tier is stored in int8 and takes the fused walk
    (kernel 3's path); a 16-bit tier never does."""
    from parlayann_tpu_torch import index as index_mod

    b = graphs["l2"]
    calls = []
    real = index_mod.beam_search_fused
    monkeypatch.setattr(index_mod, "beam_search_fused",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pt.Index(points=b["pts"], graph=b["g"]).enable_quantized(bits=4).batch_search(
        b["Q"], k=K, beam_size=BEAM)
    assert calls == [1]
    pt.Index(points=b["pts"], graph=b["g"]).enable_quantized(bits=16).batch_search(
        b["Q"], k=K, beam_size=BEAM)
    assert calls == [1]


def test_torch_tiers_two_tier_filter(rng):
    """beam_search_batch with filter_data/filter_queries equals the JAX
    package's on integer-valued points (exact distances on both sides), and
    the filter drops candidates: a walk differs from the unfiltered one."""
    n, d, L = 600, 16, 32
    X = rng.integers(-8, 8, (n, d)).astype(np.float32)
    Q = rng.integers(-8, 8, (40, d)).astype(np.float32)
    dd = ((X[:, None] - X[None]) ** 2).sum(-1)
    np.fill_diagonal(dd, np.inf)
    nbrs = np.argsort(dd, axis=1, kind="stable")[:, :10].astype(np.int32)
    degs = np.full(n, 10, np.int32)
    fd, fq = X[:, :8], Q[:, :8]  # a coarse cheap tier: half the dims
    kw = dict(n_valid=n, k=10, L=L)
    j = jbeam(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(nbrs), jnp.asarray(degs),
              jnp.asarray([0], dtype=jnp.int32), metric=JMetric.L2,
              filter_data=jnp.asarray(fd), filter_queries=jnp.asarray(fq), **kw)
    T = torch.from_numpy
    t = beam_search_batch(T(Q), T(X), T(nbrs), T(degs), torch.tensor([0], dtype=torch.int32),
                          metric=Metric.L2, filter_data=T(fd), filter_queries=T(fq), **kw)
    np.testing.assert_array_equal(t.beam_ids.numpy(), np.asarray(j.beam_ids))
    np.testing.assert_array_equal(t.beam_dists.numpy(), np.asarray(j.beam_dists))
    np.testing.assert_array_equal(t.num_visited.numpy(), np.asarray(j.num_visited))
    np.testing.assert_array_equal(t.dist_cmps.numpy(), np.asarray(j.dist_cmps))
    plain = beam_search_batch(T(Q), T(X), T(nbrs), T(degs), torch.tensor([0], dtype=torch.int32),
                              metric=Metric.L2, **kw)
    assert not (torch.equal(plain.beam_ids, t.beam_ids)
                and torch.equal(plain.num_visited, t.num_visited))


@pytest.mark.parametrize("bits", [4, 16])
def test_torch_tiers_load_quantize_bits(tmp_path, rng, bits):
    """load_index(quantize_bits=) builds the scalar tier of that width from
    the data file, equal to the JAX package's after the storage shift."""
    from parlayann_tpu.data import io as jio

    n = 40
    g, x = str(tmp_path / "g.bin"), str(tmp_path / "x.fbin")
    ring = np.stack([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n], 1).astype(np.int32)
    jio.write_graph(g, ring, np.full(n, 2, np.int32))
    jio.write_bin(x, rng.standard_normal((n, 24)).astype(np.float32))
    tidx = pt.load_index(g, x, quantize_bits=bits, device="cpu")
    jidx = jpt.load_index(g, x, quantize_bits=bits)
    assert tidx.qpoints.bits == bits
    np.testing.assert_array_equal(tidx.qpoints.data.numpy(), _port_levels(jidx.qpoints.data))
    assert pt.load_index(g, x, quantize_bits=0, device="cpu").qpoints is None


def test_torch_tiers_sparse_clustered_u8_matches_bench_construction():
    """synthetic.sparse_clustered_u8 (numpy draws) against the construction
    of scripts/bench_mips_u8.py (jax.random draws), written out here: the
    two draw different rows, so their statistics are held within stated
    bounds at n = 20,000 x 128: the share of zeros and of 255s within
    0.005, the mean and standard deviation within 2%, and the mean and
    spread of the normalized rows' cosines within 0.01. One seed gives one
    dataset."""
    import jax

    n, d = 20_000, 128
    nc = max(64, n // 100)
    kc, km, kd, _ = jax.random.split(jax.random.key(23), 4)
    centers = jnp.where(jax.random.uniform(km, (nc, d)) < 0.35,
                        jax.random.gamma(kc, 1.2, (nc, d)) * 55.0, 0.0).astype(jnp.float32)
    ka, kg, kn = jax.random.split(kd, 3)
    x = jnp.take(centers, jax.random.randint(ka, (n,), 0, nc), axis=0)
    x = x * (jax.random.gamma(kg, 4.0, (n, d)) * 0.25)
    x = x + 4.0 * jax.random.normal(kn, (n, d), jnp.float32)
    ref = np.asarray(jnp.clip(jnp.round(x), 0, 255).astype(jnp.uint8))
    got, q = synthetic.sparse_clustered_u8(n, d, n_queries=50, seed=7)
    assert got.dtype == np.uint8 and got.shape == (n, d) and q.shape == (50, d)
    again, _ = synthetic.sparse_clustered_u8(n, d, seed=7)
    np.testing.assert_array_equal(again, got)

    def stats(a):
        f = a.astype(np.float64)
        u = f / np.linalg.norm(f, axis=1, keepdims=True)
        cos = u[:2000] @ u[2000:4000].T
        return (a == 0).mean(), (a == 255).mean(), f.mean(), f.std(), cos.mean(), cos.std()

    s, r = stats(got), stats(ref)
    assert abs(s[0] - r[0]) <= 0.005 and abs(s[1] - r[1]) <= 0.005, (s, r)
    np.testing.assert_allclose(s[2:4], r[2:4], rtol=0.02)
    np.testing.assert_allclose(s[4:], r[4:], atol=0.01)
