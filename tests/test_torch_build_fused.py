"""The Vamana build's fused read phase, port vs JAX package, on the CPU.

The port's ``build_beam_fused`` (its plain walk on the CPU; kernel 3's
build mode on the card) against the JAX package's ``build_beam_fused``
(``fused_step`` in interpret mode), then one batch of both packages'
``_fused_read_phase``, then whole builds with ``fused_read=True`` against
the JAX package's ``PARLAYANN_BUILD_FUSED=1`` builds, and the flag's
guards. Inputs are int8 tiers with integer-valued queries, so every
distance is an exact integer in both packages. The JAX kernel orders tied
distances arbitrarily and the port by (distance, packed id), so walks are
compared as per-row (distance, id) sets, as tests/test_fusedbeam.py
compares the JAX kernel with its lock-step search; builds are held to the
bar ROADMAP sets for builds (average degree within 0.5, recall@10 at a fixed
beam within 0.01) through the port's own q8 search.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parlayann_tpu.build import vamana as jvamana
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.ops.pallas import fusedbeam as jfused
from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import api, interop
from parlayann_tpu_torch.build import vamana
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels.fusedbeam import build_beam_fused
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K = 10


def _row_set(ids, dists, b):
    """Row b's valid (distance, id) pairs, sorted."""
    return sorted((float(dists[b, i]), int(ids[b, i]))
                  for i in range(ids.shape[1]) if dists[b, i] < 1e37 and ids[b, i] >= 0)


def _walk_case(seed, R, B, lo):
    """n = 400 random 128-d points on the q8 tier, random rows of R
    neighbours without self loops and degrees from lo to R, B translated
    (integer-valued) queries."""
    rng = np.random.default_rng(seed)
    n, d = 400, 128
    X = rng.standard_normal((n, d)).astype(np.float32)
    jq8 = jquantize.quantize_pointset(JPointSet.from_numpy(X), bits=8)
    nbrs = np.stack([rng.choice(np.delete(np.arange(n), i), R, replace=False)
                     for i in range(n)]).astype(np.int32)
    degs = rng.integers(lo, R + 1, (n,)).astype(np.int32)
    Qf = rng.standard_normal((B, d)).astype(np.float32)
    q_t = np.asarray(jquantize.translate_query(jnp.asarray(Qf), jq8), np.float32)
    return dict(n=n, R=R, tier=np.asarray(jq8.data), nbrs=nbrs, degs=degs, q=q_t)


@pytest.fixture(scope="module")
def walk_case():
    """The JAX test's case (tests/test_fusedbeam.py:170): R = 16, degrees
    from 4 to 16, 32 queries."""
    return _walk_case(5, 16, 32, 4)


@pytest.fixture(scope="module")
def wide_case():
    """bench.py's second configuration's widths: R = 64 (rows of 16 to 64
    neighbours), 16 queries; walked at L = 128, vmax = 128, the card's
    widest register walk."""
    return _walk_case(6, 64, 16, 16)


@pytest.mark.parametrize("case,metric", [
    pytest.param("walk_case", "L2", id="L2"), pytest.param("walk_case", "MIPS", id="MIPS"),
    pytest.param("wide_case", "L2", id="R64-L128-L2"),
    pytest.param("wide_case", "MIPS", id="R64-L128-MIPS")])
def test_torch_build_beam_fused_matches_jax(request, case, metric):
    """Per-row (distance, id) sets of the visited lists and num_visited
    equal the JAX kernel's (L = 16, vmax = 24 over rows of 16; L = 128,
    vmax = 128 over rows of 64); dist_cmps equal the port's lock-step
    recorder at expand = 1; rows are -1 / INF past num_visited."""
    c = request.getfixturevalue(case)
    n = c["n"]
    L, vmax, block_b = (16, 24, 32) if case == "walk_case" else (128, 128, 16)
    jm, tm = JMetric[metric], Metric[metric]
    jn, jd = jnp.asarray(c["nbrs"]), jnp.asarray(c["degs"])
    iext = jfused.build_inline_ext(jnp.asarray(c["tier"]), jn, jd)
    j_ids, j_d, j_nv, _ = jfused.build_beam_fused(
        jnp.asarray(c["q"]), jnp.asarray(c["tier"]), iext, jnp.zeros((1,), jnp.int32),
        metric=jm, n_valid=n, L=L, vmax=vmax, G=8, block_b=block_b)
    j_ids, j_d = np.asarray(j_ids), np.asarray(j_d)

    args = (torch.tensor(c["q"]), torch.tensor(c["tier"]),
            torch.tensor(c["nbrs"]), torch.tensor(c["degs"]),
            torch.zeros((1,), dtype=torch.int32))
    ids, dists, nv, cmps = build_beam_fused(*args, metric=tm, n_valid=n, L=L, vmax=vmax)
    assert ids.shape == dists.shape == (len(c["q"]), vmax)
    np.testing.assert_array_equal(nv.numpy(), np.asarray(j_nv))
    for b in range(len(c["q"])):
        assert _row_set(ids.numpy(), dists.numpy(), b) == _row_set(j_ids, j_d, b), b
        k = int(nv[b])
        assert bool((ids[b, k:] == -1).all()) and bool((dists[b, k:] == INF).all())
        assert bool((ids[b, :k] >= 0).all())
    ref = beam_search_batch(*args, metric=tm, n_valid=n, k=0, L=L, limit=vmax,
                            expand=1, record_visited=True)
    assert torch.equal(cmps, ref.dist_cmps)
    assert torch.equal(nv, ref.num_visited)
    assert int(nv.max()) == vmax  # the budget binds on some rows


def test_torch_fused_read_phase_matches_jax(walk_case):
    """One batch of the read phase: 24 of the graph's own points and 8
    padded rows. Each active row's candidates (visited ∪ out-edges) equal
    the JAX read phase's as (distance, id) sets; where self was expanded
    within the budget (on several rows), its recorded distance is INF; the
    visit and distance counts are the active rows' and equal JAX's."""
    c = walk_case
    n, R, L, vmax = c["n"], c["R"], 16, 24
    batch = np.full(32, -1, np.int32)
    batch[:24] = np.random.default_rng(9).choice(n, 24, replace=False)
    jn, jd, jt = (jnp.asarray(c[k]) for k in ("nbrs", "degs", "tier"))
    iext = jfused.build_inline_ext(jt, jn, jd)
    jc_ids, jc_d, j_v, j_c = jvamana._fused_read_phase(
        jn, jd, jt, jnp.asarray(batch), jnp.zeros((1,), jnp.int32), iext,
        R=R, L=L, vmax=vmax, metric=JMetric.L2, n_valid=n)
    jc_ids, jc_d = np.asarray(jc_ids), np.asarray(jc_d)
    c_ids, c_d, v, cm = vamana._fused_read_phase(
        torch.tensor(c["nbrs"]), torch.tensor(c["degs"]),
        torch.tensor(c["tier"]), torch.tensor(batch),
        R=R, L=L, vmax=vmax, metric=Metric.L2, n_valid=n)
    assert c_ids.shape == (32, vmax + R)
    c_ids, c_d = c_ids.numpy(), c_d.numpy()
    found = 0
    for b in range(24):
        assert _row_set(c_ids, c_d, b) == _row_set(jc_ids, jc_d, b), b
        self_at = np.flatnonzero(c_ids[b, :vmax] == batch[b])
        assert len(self_at) <= 1 and all(c_d[b, self_at] == INF)
        found += len(self_at)
    print(f"self expanded within the budget on {found} of 24 rows")
    assert found >= 4
    assert (int(v), int(cm)) == (int(j_v), int(j_c))
    assert bool((c_ids[24:, :vmax] == -1).all())  # padded rows do no work


@pytest.fixture(scope="module")
def build_case():
    """n = 8,192 x 32, R = 16, L = 32, two passes at batch_cap_frac 0.5: one
    steady batch of 4,096 a pass takes the fused read."""
    X, Q = synthetic.clustered(8192, 32, n_queries=200, n_clusters=64,
                               cluster_std=0.35, seed=11)
    d64 = ((Q[:, None, :].astype(np.float64) - X[None]) ** 2).sum(-1)
    gt = np.argsort(d64, axis=1, kind="stable")[:, :2 * K]
    ps = PointSet.from_numpy(X, device="cpu")
    return dict(X=X, Q=Q, gt=gt, gt_d=np.take_along_axis(d64, gt, 1), ps=ps,
                jq8=jquantize.quantize_pointset(JPointSet.from_numpy(X), bits=8),
                q8=quantize.quantize_pointset(ps, bits=8),
                kw=dict(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.5))


def _recall(graph, b, beam):
    idx = pt.Index(points=b["ps"], graph=graph).enable_quantized(bits=8)
    ids, _, _ = idx.batch_search(b["Q"], k=K, beam_size=beam)
    return compute_recall(ids.numpy(), b["gt"], b["gt_d"], K)


def _bar(b, g1, g2, what, beam):
    """The build bar between two port graphs at ``beam`` -> (identical
    rows, recall@10 of g1 at ``beam``); prints both recalls at beams 10
    and 32."""
    n1, d1 = g1.neighbors.numpy(), g1.degrees.numpy()
    n2, d2 = g2.neighbors.numpy(), g2.degrees.numpy()
    same = np.mean([d1[i] == d2[i] and np.array_equal(n1[i, :d1[i]], n2[i, :d2[i]])
                    for i in range(g1.n)])
    rec = {bm: (_recall(g1, b, bm), _recall(g2, b, bm)) for bm in (10, 32)}
    print(f"{what}: identical rows {same:.4f}; degree {g1.stats()[0]:.3f} / "
          f"{g2.stats()[0]:.3f}; recall@{K} at beam 10 {rec[10][0]:.4f} / "
          f"{rec[10][1]:.4f}, at beam 32 {rec[32][0]:.4f} / {rec[32][1]:.4f}")
    assert abs(g1.stats()[0] - g2.stats()[0]) <= 0.5
    assert abs(rec[beam][0] - rec[beam][1]) <= 0.01
    return same, rec[beam][0]


def test_torch_fused_build_matches_jax(build_case, monkeypatch):
    """The port's fused_read=True build against the JAX package's
    PARLAYANN_BUILD_FUSED=1 build: the build bar at beam 10, at least 99%
    of rows identical, total visits within 0.5%. Against the port's own
    lock-step build: the build bar at beam 32. At beam 10 the two read
    modes' graphs differ by up to 0.02 on this data from one build seed to
    another, either way (0.8646 fused against 0.8834 lock-step at seed 0,
    0.9030 against 0.8924 at seed 1, on 2,000 queries), so beam 10 does
    not separate the modes here; beam 32 does not wash out a broken read
    (both above 0.99)."""
    b = build_case
    monkeypatch.setenv("PARLAYANN_BUILD_FUSED", "1")
    jg, js = jvamana.build_vamana_graph(b["jq8"], JBuildParams(**b["kw"]))
    monkeypatch.delenv("PARLAYANN_BUILD_FUSED")
    tg, ts = vamana.build_vamana_graph(b["q8"], BuildParams(**b["kw"]), fused_read=True)
    lg, ls = vamana.build_vamana_graph(b["q8"], BuildParams(**b["kw"]))
    jgraph = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                      jg.n, jg.max_degree, device="cpu")
    print(f"visits: port fused {ts.total_visited}, JAX fused {js.total_visited}, "
          f"port lock-step {ls.total_visited}")
    assert abs(ts.total_visited - js.total_visited) <= 0.005 * js.total_visited
    # the fused read runs vmax single steps where the lock-step read runs
    # ceil(vmax / 2) double ones: the builds must differ in their visits
    assert ts.total_visited != ls.total_visited
    same, r = _bar(b, tg, jgraph, "port fused vs JAX fused", 10)
    assert same >= 0.99 and r >= 0.8
    _, r = _bar(b, tg, lg, "port fused vs port lock-step", 32)
    assert r >= 0.98


@pytest.mark.parametrize("case", ["f32_tier", "narrow_d", "exact", "single_batch"])
def test_torch_fused_read_refuses_what_jax_never_fuses(case):
    """fused_read=True raises ValueError wherever the JAX package would not
    take the fused read (vamana.py:541-545), instead of building lock-step."""
    X = synthetic.clustered(300, 32, n_queries=1, n_clusters=4, seed=1)[0]
    kw = dict(R=16, L=32, device="cpu", fused_read=True)
    if case == "f32_tier":
        kw["quantize_build"] = False
    elif case == "narrow_d":
        X = X[:, :12]
    elif case == "exact":
        kw["cand_mode"] = "exact"
    else:
        kw["single_batch"] = 8
    with pytest.raises(ValueError, match="fused_read"):
        vamana.build_vamana_index(X, **kw)
    with pytest.raises(ValueError, match="fused_read"):
        api.build_vamana_index(X, **kw)


def test_torch_fused_read_api_passes_the_flag(monkeypatch):
    """api.build_vamana_index hands fused_read to build_vamana_graph, and
    leaves it off by default."""
    seen = []

    def spy(points, bp, **kw):
        seen.append(kw["fused_read"])
        raise RuntimeError("stop")

    monkeypatch.setattr(vamana, "build_vamana_graph", spy)
    X = synthetic.clustered(300, 32, n_queries=1, n_clusters=4, seed=1)[0]
    for flag in (True, None):
        extra = {} if flag is None else dict(fused_read=flag)
        with pytest.raises(RuntimeError, match="stop"):
            api.build_vamana_index(X, R=16, L=32, device="cpu", **extra)
    assert seen == [True, False]
