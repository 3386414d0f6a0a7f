"""The port's per-shard replica and cluster-sharded modes against the JAX
package's (the twins of tests/test_sharded.py's four tests).

The JAX package runs in this process on conftest's virtual CPU devices;
the port runs the same shard count D on four gloo ranks, spawned once for
the module by tests/torch_ranks.py. Both get the same numpy inputs. The
bar (ROADMAP's parity bar at equal D):

- integer-valued int8 data: the replica shards' graphs equal JAX's row
  for row (every distance is an exact integer);
- float32 data: the builder bar, average degree within 0.5 and recall@10
  at a fixed beam within 0.01;
- a search over one set of shards: distances equal within rtol 1e-5, so
  ids differ only where two points lie at one distance (a tie); the
  port's searcher runs over JAX's shards and JAX's over the port's;
- the cluster build: C equal and recall@10 at n_probe 8 within 0.03.
"""

import numpy as np
import pytest
import jax
from jax.sharding import NamedSharding, PartitionSpec as P

from parlayann_tpu.build.clusterindex import ClusterIndex as JClusterIndex
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.parallel import sharded as jsharded
from parlayann_tpu.parallel.cluster_sharded import (
    ShardedClusterIndex as JShardedClusterIndex, build_sharded_cluster as jbuild_cluster,
)
from parlayann_tpu.parallel.mesh import make_mesh as jmake_mesh
from parlayann_tpu.types import BuildParams as JBuildParams, Metric as JMetric
from parlayann_tpu.utils import synthetic

from parlayann_tpu_torch.harness.recall import compute_recall

import torch_ranks
from torch_ranks import assert_same_search, builder_bar, exact_knn, rows_equal

K = 10
# the replica builds: (tag, rows, dim, queries, build params, data axis, k, beam)
REPLICA = {
    "a": (800, 16, 200, dict(R=12, L=24, alpha=1.2, num_passes=1, batch_cap_frac=0.5),
          4, K, 32),
    # 497 rows over d = 2: the last shard ends in a pad row; (d, q) = (2, 2)
    "u": (497, 8, 8, dict(R=8, L=16, alpha=1.2, num_passes=1, batch_cap_frac=0.5),
          2, 5, 16),
}


def jax_index(mesh, X, nbrs, degs, R):
    """A JAX ShardedIndex over (D, nl, ...) shard arrays."""
    D = nbrs.shape[0]
    pts = torch_ranks._pad_shards(X, D)
    put = lambda a: jax.device_put(a, NamedSharding(mesh, P(*(("d",) + (None,) * (a.ndim - 1)))))
    return jsharded.ShardedIndex(mesh=mesh, points=put(pts), nbrs=put(nbrs), degs=put(degs),
                                 n=len(X), rows_per_shard=nbrs.shape[1], max_degree=R,
                                 metric=JMetric.L2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    rng = np.random.default_rng(42)
    st = {}
    for tag, (n, d, nq, bp, D, k, beam) in REPLICA.items():
        st[f"{tag}_bp"], st[f"{tag}_k"], st[f"{tag}_beam"] = bp, k, beam
        st[f"{tag}_X_f32"] = rng.standard_normal((n, d)).astype(np.float32)
        st[f"{tag}_Q_f32"] = rng.standard_normal((nq, d)).astype(np.float32)
        st[f"{tag}_X_int8"] = rng.integers(-40, 41, (n, d)).astype(np.int8)
        st[f"{tag}_Q_int8"] = rng.integers(-40, 41, (nq, d)).astype(np.float32)
    st["c_X"], st["c_Q"] = synthetic.clustered(4000, 64, n_queries=64, n_clusters=40,
                                               cluster_std=0.1, seed=5)
    st["b_X"], st["b_Q"] = synthetic.clustered(4000, 64, n_queries=64, n_clusters=40,
                                               cluster_std=0.1, seed=6)
    jax_out = {}

    def jax_side():
        """The JAX package's builds and searches, while the ranks build."""
        late = {}
        for tag, (n, d, nq, bp, D, k, beam) in REPLICA.items():
            mesh = jmake_mesh(4, data_axis=D)
            for dt in ("f32", "int8"):
                idx = jsharded.build_sharded_vamana(st[f"{tag}_X_{dt}"], mesh,
                                                    JBuildParams(**bp))
                late[f"{tag}_{dt}_graph"] = (np.asarray(idx.nbrs), np.asarray(idx.degs))
                jax_out[f"{tag}_{dt}"] = jsharded.sharded_search(
                    idx, st[f"{tag}_Q_{dt}"], k=k, beam_size=beam)
                jax_out[f"{tag}_{dt}_rows"] = idx.rows_per_shard
        ci = JClusterIndex.build(JPointSet.from_numpy(st["c_X"]), m=32, Rc=16, iters=3,
                                 ext_dtype="int8")
        q8 = ci.qpoints
        late["c_state"] = dict(
            points=np.asarray(ci.points.data), n=ci.points.n, d=ci.points.d,
            q8=np.asarray(q8.data), slope=np.asarray(q8.quant_slope),
            offset=np.asarray(q8.quant_offset), members=ci.members, adj=ci.adj,
            centroids_q=np.asarray(ci.centroids_q), ext=np.asarray(ci.ext), C=ci.C, m=32,
            Rc=16)
        jsci = JShardedClusterIndex.from_cluster_index(ci, jmake_mesh(4, data_axis=4))
        jax_out["c"] = tuple(np.asarray(a) for a in
                             jsci.search(st["c_Q"], k=K, n_probe=8, cut=0.0))
        jsci = jbuild_cluster(st["b_X"], jmake_mesh(4, data_axis=4), m=32, Rc=16, iters=3)
        jax_out["b"] = (jsci.C, np.asarray(jsci.search(st["b_Q"], k=K, n_probe=8,
                                                       cut=0.0)[0]))
        jax_out.update(late)
        return late

    port = torch_ranks.spawn(tmp_path_factory.mktemp("parallel"), 4, "parallel_job", st,
                             late=jax_side)
    return st, jax_out, port


@pytest.mark.parametrize("tag", ["a", "u"], ids=["d4", "d2_q2_uneven"])
def test_torch_sharded_build_and_search(runs, tag):
    """Replica builds at D = 4 on a (4, 1) mesh and at D = 2 on the (2, 2)
    mesh (497 rows: the last shard pads): int8 shards row for row, f32
    shards at the builder bar, and each package's search over the other's
    shards equal to its own over them."""
    st, jax_out, port = runs
    n, d, nq, bp, D, k, beam = REPLICA[tag]
    nl = -(-n // D)
    # int8: row for row
    jn, jd = jax_out[f"{tag}_int8_graph"]
    assert port[f"{tag}_int8_nbrs"].shape == (D, nl, bp["R"])
    assert rows_equal(jn, jd, port[f"{tag}_int8_nbrs"], port[f"{tag}_int8_degs"]).all()
    # f32: the builder bar at a fixed beam
    X, Q = st[f"{tag}_X_f32"], st[f"{tag}_Q_f32"]
    gt, gtd = exact_knn(X, Q, k)
    r_jax = compute_recall(jax_out[f"{tag}_f32"][0], gt, gtd, k)
    r_port = compute_recall(port[f"{tag}_f32_ids"], gt, gtd, k)
    jn, jd = jax_out[f"{tag}_f32_graph"]
    builder_bar(jn, jd, port[f"{tag}_f32_nbrs"], port[f"{tag}_f32_degs"], n, r_jax, r_port,
                f"replica {tag} f32")
    mesh = jmake_mesh(4, data_axis=D)
    for dt in ("f32", "int8"):
        ids, dists = port[f"{tag}_{dt}_ids"], port[f"{tag}_{dt}_dists"]
        assert ids.shape == (nq, k) and (ids < n).all()
        for row in ids:  # global ids valid and unique per row
            v = row[row >= 0]
            assert len(set(v.tolist())) == len(v)
        # the port's search over JAX's shards, JAX's over the port's
        assert_same_search(port[f"{tag}_{dt}_onjax_ids"], port[f"{tag}_{dt}_onjax_dists"],
                           *jax_out[f"{tag}_{dt}"], f"port search on jax {tag} {dt} shards")
        jidx = jax_index(mesh, st[f"{tag}_X_{dt}"], port[f"{tag}_{dt}_nbrs"],
                         port[f"{tag}_{dt}_degs"], bp["R"])
        j_on_port = jsharded.sharded_search(jidx, st[f"{tag}_Q_{dt}"], k=k, beam_size=beam)
        assert_same_search(*j_on_port, ids, dists, f"jax search on port {tag} {dt} shards")
    if tag == "a":
        assert jax_out["a_f32_rows"] == 200
        assert r_port >= 0.85, r_port


def test_torch_dryrun_multichip_twin(runs):
    """dryrun_multichip_torch's three modes at the JAX dryrun's sizes on
    four ranks: well-formed results with unique valid ids."""
    _, _, port = runs
    for mode, (nq, n) in {"global": (8, 256), "sharded": (8, 128), "cluster": (8, 256)}.items():
        ids, dists = port[f"dry_{mode}_ids"], port[f"dry_{mode}_dists"]
        assert ids.shape == (nq, 5) and dists.shape == (nq, 5), mode
        assert (ids >= 0).all() and (ids < n).all(), mode
        assert all(len(set(r.tolist())) == 5 for r in ids), mode
        assert (np.diff(dists, axis=1) >= 0).all(), mode


def test_torch_cluster_sharded_search(runs):
    """The port's cluster-sharded search over a JAX-built ClusterIndex
    equals JAX's cluster-sharded search; recall within 0.02 of the
    single-device index; returned distances are the float32 distances."""
    st, jax_out, port = runs
    X, Q = st["c_X"], st["c_Q"]
    j_ids, j_d, j_nv = jax_out["c"]
    assert_same_search(port["c_ids"], port["c_dists"], j_ids, j_d, "cluster-sharded search")
    np.testing.assert_array_equal(port["c_nv"], j_nv)
    assert port["c_nv"].max() <= 8
    gt, gtd = exact_knn(X, Q, K)
    rec_s = compute_recall(port["c_ids"], gt, gtd, K)
    rec_1 = compute_recall(port["c_single_ids"], gt, gtd, K)
    assert rec_s >= rec_1 - 0.02, (rec_s, rec_1)
    ids, d = port["c_ids"], port["c_dists"]
    for qi in range(0, len(Q), 7):
        ok = ids[qi] >= 0
        true = ((X[ids[qi][ok]] - Q[qi]) ** 2).sum(-1)
        np.testing.assert_allclose(d[qi][ok], true, rtol=1e-2, atol=1e-2)


def test_torch_cluster_sharded_build(runs):
    """The distributed cluster build (all-reduced Lloyd) at D = 4: C equal
    to JAX's, recall@10 at n_probe 8 within 0.03 of JAX's build."""
    st, jax_out, port = runs
    X, Q = st["b_X"], st["b_Q"]
    j_C, j_ids = jax_out["b"]
    assert int(port["b_C"]) == j_C
    gt, gtd = exact_knn(X, Q, K)
    rec_j = compute_recall(j_ids, gt, gtd, K)
    rec_p = compute_recall(port["b_ids"], gt, gtd, K)
    print(f"cluster build recall@{K} at n_probe 8: jax {rec_j:.4f} port {rec_p:.4f}")
    assert abs(rec_p - rec_j) <= 0.03, (rec_p, rec_j)
