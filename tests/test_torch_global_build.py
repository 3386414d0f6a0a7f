"""The port's global cross-shard build against the JAX package's (the twins
of tests/test_global_build.py's four tests).

The JAX package runs in this process on conftest's virtual CPU devices
(``make_mesh_1d(4)``); the port runs D = 4 on four gloo ranks, spawned once
for the module by tests/torch_ranks.py, on the same numpy inputs. The bar
(ROADMAP's parity bar at equal D): on integer-valued int8 data the global
graph equals JAX's row for row; on float32 data the builder bar (average
degree within 0.5, recall@10 at a fixed beam within 0.01); a search over
one graph gives distances equal within rtol 1e-5, so ids differ only at
ties, with the port's searcher over JAX's graph and JAX's over the port's.
"""

import contextlib
import io

import numpy as np
import pytest
import jax
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from parlayann_tpu.parallel import global_build as jglobal
from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric

from parlayann_tpu_torch.build.vamana import build_vamana_graph
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.index import Index
from parlayann_tpu_torch.parallel import global_build as tglobal
from parlayann_tpu_torch.types import BuildParams

import torch_ranks
from torch_ranks import assert_same_search, builder_bar, exact_knn, rows_equal

K = 10
# the parity builds: f32 over two passes as the JAX test builds; int8 over
# one (each pass is 13 batches of up to 48 hops of collectives)
G_BP = {"f32": dict(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25),
        "int8": dict(R=16, L=32, alpha=1.2, num_passes=1, batch_cap_frac=0.25)}
BIG_BP = dict(R=16, L=32, alpha=1.2, num_passes=1, batch_cap_frac=0.25)


def jax_index(mesh, X, nbrs, degs, R):
    """A JAX GlobalIndex over (D, nl, ...) shard arrays."""
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(*(("d",) + (None,) * (a.ndim - 1)))))
    return jglobal.GlobalIndex(
        mesh=mesh, points=put(torch_ranks._pad_shards(X, nbrs.shape[0])), nbrs=put(nbrs),
        degs=put(degs), n=len(X), rows_per_shard=nbrs.shape[1], max_degree=R,
        metric=JMetric.L2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(42)
    st = {"g_bp": G_BP, "big_bp": BIG_BP}
    st["g_X_f32"] = rng.standard_normal((1500, 24)).astype(np.float32)
    st["g_X_int8"] = rng.integers(-40, 41, (1500, 24)).astype(np.int8)
    st["g_Q"] = rng.standard_normal((80, 24)).astype(np.float32)
    n = 32  # a complete graph over 32 points: the search is exact
    st["full_X"] = rng.standard_normal((n, 8)).astype(np.float32)
    st["full_Q"] = rng.standard_normal((16, 8)).astype(np.float32)
    st["full_nbrs"] = np.arange(n, dtype=np.int32)[None, :].repeat(n, 0)
    st["full_degs"] = np.full(n, n, np.int32)
    st["big_X"] = rng.standard_normal((8192, 32)).astype(np.float32)
    st["big_Q"] = rng.standard_normal((100, 32)).astype(np.float32)
    jax_out = {}

    def jax_side():
        """While the ranks build: the JAX package's global builds and
        searches, and the port's single-device build of the 8K set."""
        mesh = jglobal.make_mesh_1d(4)
        for dt in ("f32", "int8"):
            g = jglobal.build_global_vamana(st[f"g_X_{dt}"], mesh, JBuildParams(**G_BP[dt]))
            jax_out[f"g_{dt}_graph"] = (np.asarray(g.nbrs), np.asarray(g.degs))
            jax_out[f"g_{dt}"] = jglobal.global_search(g, st["g_Q"], k=K, beam_size=32)
        torch.set_num_threads(1)
        ps = PointSet.from_numpy(st["big_X"], device="cpu")
        g, _ = build_vamana_graph(ps, BuildParams(**BIG_BP))
        ids, _, _ = Index(points=ps, graph=g).batch_search(st["big_Q"], k=K, beam_size=48)
        jax_out["big_single_ids"] = ids.numpy()
        return {k: v for k, v in jax_out.items() if k.endswith("_graph")}

    port = torch_ranks.spawn(tmp_path_factory.mktemp("global"), 4, "global_job", st,
                             late=jax_side)
    return st, jax_out, port


def test_torch_global_build_matches_jax(runs):
    """One graph over all n (global ids, edges across shards): int8 row for
    row with JAX's global build, f32 at the builder bar, and each package's
    search over the other's graph equal to its own."""
    st, jax_out, port = runs
    mesh = jglobal.make_mesh_1d(4)
    n, R = 1500, G_BP["f32"]["R"]
    jn, jd = jax_out["g_int8_graph"]
    assert rows_equal(jn, jd, port["g_int8_nbrs"], port["g_int8_degs"]).all()
    Q = st["g_Q"]
    gt, gtd = exact_knn(st["g_X_f32"], Q, K)
    r_jax = compute_recall(jax_out["g_f32"][0], gt, gtd, K)
    r_port = compute_recall(port["g_f32_ids"], gt, gtd, K)
    jn, jd = jax_out["g_f32_graph"]
    builder_bar(jn, jd, port["g_f32_nbrs"], port["g_f32_degs"], n, r_jax, r_port, "global f32")
    for dt in ("f32", "int8"):
        nb = port[f"g_{dt}_nbrs"].reshape(-1, R)
        dg = port[f"g_{dt}_degs"].reshape(-1)
        assert dg[:n].mean() > 8  # healthy connectivity
        edges = nb[:n][np.arange(R)[None, :] < dg[:n, None]]
        assert (edges >= 0).all() and (edges < n).all()
        # edges cross shard boundaries (a per-shard-island build would not)
        owner = np.repeat(np.arange(4), port[f"g_{dt}_nbrs"].shape[1])[:n]
        assert sum(owner[nb[v, j]] != owner[v] for v in range(0, n, 97)
                   for j in range(dg[v])) > 0
        assert_same_search(port[f"g_{dt}_onjax_ids"], port[f"g_{dt}_onjax_dists"],
                           *jax_out[f"g_{dt}"], f"port search on the jax {dt} graph")
        jidx = jax_index(mesh, st[f"g_X_{dt}"], port[f"g_{dt}_nbrs"], port[f"g_{dt}_degs"], R)
        assert_same_search(*jglobal.global_search(jidx, Q, k=K, beam_size=32),
                           port[f"g_{dt}_ids"], port[f"g_{dt}_dists"],
                           f"jax search on the port {dt} graph")


def test_torch_global_search_exact_on_full_graph(runs):
    """A complete graph -> the global search returns the exact top-k."""
    st, _, port = runs
    X, Q = st["full_X"], st["full_Q"]
    d = ((Q[:, None, :] - X[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(port["full_ids"], np.argsort(d, axis=1)[:, :5])
    np.testing.assert_allclose(port["full_dists"], np.sort(d, axis=1)[:, :5], rtol=1e-5)


def test_torch_global_build_8k_parity(runs):
    """n = 8192 over D = 4: recall within 0.02 of the port's single-device
    build on the same data."""
    st, jax_out, port = runs
    gt, gtd = exact_knn(st["big_X"], st["big_Q"], K)
    r1 = compute_recall(jax_out["big_single_ids"], gt, gtd, K)
    r2 = compute_recall(port["big_ids"], gt, gtd, K)
    print(f"8K recall@{K} at beam 48: single-device {r1:.4f}, global {r2:.4f}")
    assert r2 > r1 - 0.02, (r1, r2)


@pytest.mark.parametrize("kw", [
    dict(n=100_000, D=8, R=32, L=64, dim=128, batch=4096),
    dict(n=1_000_000, D=8, R=64, L=128, dim=128, batch=4096, itemsize_vec=1, hops=136,
         overflow_targets=512),
    dict(n=1_000_000, D=8, R=64, L=128, dim=128, batch=4096, itemsize_vec=1),
    dict(n=256, D=4, R=8, L=16, dim=16, batch=256),
    dict(n=5000, D=3, R=16, L=32, dim=24, batch=1000, itemsize=8),
], ids=["100k", "1m_q8_typical", "1m_q8_worst", "dryrun", "odd_d"])
def test_torch_collective_volume_report_equals_jax(kw):
    """The volume table equals JAX's for the same arguments; the port's
    heading names per-device collective volume."""
    n, D = kw.pop("n"), kw.pop("D")
    j_sites, j_total = jglobal.collective_volume_report(n, D, print_table=False, **kw)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        t_sites, t_total = tglobal.collective_volume_report(n, D, **kw)
    assert t_sites == j_sites and t_total == j_total
    assert len(t_sites) == 10 and t_total > 0
    text = buf.getvalue()
    assert text.startswith("per-device collective volume") and "ICI" not in text
    if kw.get("hops") == 136:  # the JAX test's bounds at the q8 shapes
        assert t_total < 1e9
        assert max(t_sites.values()) == t_sites["beam: psum cand ids+deg   (B,E,R+1)"]
    if kw.get("itemsize_vec") == 1 and "hops" not in kw:
        assert t_total < 5e9
