"""Rank-side code of the multi-device port tests (tests/test_torch_parallel.py,
tests/test_torch_global_build.py). Imports no jax, and pytest does not
collect it.

:func:`spawn` starts a world of gloo ranks on the CPU (or of NCCL ranks,
one card each, for the card tests) under the spawn start method (never fork: the pytest process runs JAX's threads), meeting
through a file store in the test's temporary directory, so concurrent
test workers cannot clash on a port. Every collective times out after
``TIMEOUT`` seconds and the world is joined with a deadline, so a
mismatched collective fails its test instead of hanging the run. Each rank
runs one job of this module on the same inputs; rank 0 writes the job's
results to an ``.npz`` that the test reads back. Inputs that only the JAX
package can make (its graphs, its cluster index) come late: the test
computes them while the ranks build, and the ranks wait for them
(:func:`late`) only where they need them.
"""

from __future__ import annotations

import os
import pickle
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT = 60  # seconds a collective may wait
DEADLINE = 300  # seconds a whole world may run


def _entry(rank, world, store, out, job, state):
    kw = {}
    if state.get("device") == "cuda":  # rank r on card r, over NCCL
        torch.cuda.set_device(rank)
        backend, kw = "nccl", dict(device_id=torch.device("cuda", rank))
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=TIMEOUT), **kw)
    try:
        res = globals()[job](state)
        if rank == 0:
            np.savez(out + ".tmp.npz", **res)
            os.replace(out + ".tmp.npz", out)
    finally:
        dist.destroy_process_group()


def spawn(tmp_path, world: int, job: str, state: dict, late=None) -> dict:
    """Run ``job(state)`` on ``world`` gloo ranks (NCCL ranks, one card
    each, where ``state["device"]`` is ``"cuda"``) -> rank 0's results.
    ``late()``, called here while the ranks run, returns the inputs that
    the job reads through :func:`late`."""
    out = str(tmp_path / f"{job}.npz")
    state = dict(state, late_path=str(tmp_path / f"{job}.late.pkl"))
    ctx = torch.multiprocessing.start_processes(
        _entry, args=(world, str(tmp_path / f"{job}.store"), out, job, state),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + DEADLINE
    try:
        if late is not None:
            with open(state["late_path"] + ".tmp", "wb") as f:
                pickle.dump(late(), f)
            os.replace(state["late_path"] + ".tmp", state["late_path"])
        while not ctx.join(timeout=max(0.1, end - time.monotonic())):
            if time.monotonic() > end:
                raise TimeoutError(f"{job}: the ranks did not finish in {DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    with np.load(out) as f:
        return dict(f)


def late(state) -> dict:
    """The late inputs of :func:`spawn`, once the test has written them."""
    end = time.monotonic() + DEADLINE
    while not os.path.exists(state["late_path"]):
        if time.monotonic() > end:
            raise TimeoutError("the late inputs never came")
        time.sleep(0.05)
    with open(state["late_path"], "rb") as f:
        return pickle.load(f)


# --- checks shared by the test files (numpy only) ---


def exact_knn(X, Q, k):
    d = ((Q[:, None, :].astype(np.float64) - X[None].astype(np.float64)) ** 2).sum(-1)
    gt = np.argsort(d, axis=1, kind="stable")[:, :k]
    return gt, np.take_along_axis(d, gt, 1)


def assert_same_search(ids_a, d_a, ids_b, d_b, what):
    """Distances equal within rtol 1e-5; where the ids differ, the two
    points lie at one distance (a tie), which the distance check holds."""
    np.testing.assert_allclose(d_a, d_b, rtol=1e-5, atol=0, err_msg=what)
    print(f"{what}: {int((ids_a != ids_b).sum())} of {ids_a.size} ids differ (ties)")


def builder_bar(jnb, jdg, tnb, tdg, n, r_jax, r_port, what, names=("jax", "port")):
    dj, dt = jdg.reshape(-1)[:n].mean(), tdg.reshape(-1)[:n].mean()
    a, b = names
    print(f"{what}: degree avg {a} {dj:.3f} {b} {dt:.3f}; recall {a} {r_jax:.4f} "
          f"{b} {r_port:.4f}; identical rows {np.mean(rows_equal(jnb, jdg, tnb, tdg)):.4f}")
    assert abs(dj - dt) <= 0.5, (dj, dt)
    assert abs(r_jax - r_port) <= 0.01, (r_jax, r_port)


def rows_equal(jnb, jdg, tnb, tdg):
    jnb, tnb = jnb.reshape(-1, jnb.shape[-1]), tnb.reshape(-1, tnb.shape[-1])
    jdg, tdg = jdg.reshape(-1), tdg.reshape(-1)
    return np.array([jdg[i] == tdg[i] and np.array_equal(jnb[i, :jdg[i]], tnb[i, :tdg[i]])
                     for i in range(len(jdg))])


def _bp(kw):
    from parlayann_tpu_torch.types import BuildParams
    return BuildParams(**kw)


def parallel_job(st):
    """The replica and cluster modes: builds on a (4, 1) mesh and on the
    (2, 2) mesh, the dryrun's three modes and the distributed cluster
    build; then, with the late inputs, searches over the JAX package's
    shards and the cluster-sharded search over a JAX-built ClusterIndex."""
    from dryrun_multichip_torch import dryrun_multichip
    from parlayann_tpu_torch import interop
    from parlayann_tpu_torch.parallel.mesh import gather_shards, make_mesh
    from parlayann_tpu_torch.parallel.sharded import build_sharded_vamana, sharded_search
    from parlayann_tpu_torch.parallel.cluster_sharded import (
        ShardedClusterIndex, build_sharded_cluster,
    )

    out = {}
    meshes = {"a": make_mesh(4, data_axis=4, device="cpu"),
              "u": make_mesh(4, data_axis=2, device="cpu")}
    for tag, mesh in meshes.items():
        for dt in ("f32", "int8"):
            idx = build_sharded_vamana(st[f"{tag}_X_{dt}"], mesh, _bp(st[f"{tag}_bp"]))
            out[f"{tag}_{dt}_nbrs"] = gather_shards(mesh, idx.nbrs)
            out[f"{tag}_{dt}_degs"] = gather_shards(mesh, idx.degs)
            out[f"{tag}_{dt}_ids"], out[f"{tag}_{dt}_dists"] = sharded_search(
                idx, st[f"{tag}_Q_{dt}"], k=st[f"{tag}_k"], beam_size=st[f"{tag}_beam"])

    for mode, (ids, dists) in dryrun_multichip("cpu").items():
        out[f"dry_{mode}_ids"], out[f"dry_{mode}_dists"] = ids, dists

    mesh = meshes["a"]
    sci = build_sharded_cluster(st["b_X"], mesh, m=32, Rc=16, iters=3)
    ids, _, _ = sci.search(st["b_Q"], k=10, n_probe=8, cut=0.0)
    out.update(b_C=np.int64(sci.C), b_ids=ids.numpy())

    jax = late(st)
    for tag, mesh in meshes.items():
        for dt in ("f32", "int8"):
            X = st[f"{tag}_X_{dt}"]
            jn, jd = jax[f"{tag}_{dt}_graph"]
            jidx = interop.sharded_index_from_state(
                _pad_shards(X, mesh.shape["d"]), jn, jd, len(X), jn.shape[-1], "l2", mesh)
            (out[f"{tag}_{dt}_onjax_ids"],
             out[f"{tag}_{dt}_onjax_dists"]) = sharded_search(
                jidx, st[f"{tag}_Q_{dt}"], k=st[f"{tag}_k"], beam_size=st[f"{tag}_beam"])
    ci = _cluster_index(jax["c_state"])
    sci = ShardedClusterIndex.from_cluster_index(ci, mesh)
    ids, dists, nv = sci.search(st["c_Q"], k=10, n_probe=8, cut=0.0)
    out.update(c_ids=ids.numpy(), c_dists=dists.numpy(), c_nv=nv.numpy())
    ids1, _, _ = ci.search(torch.from_numpy(st["c_Q"]), k=10, n_probe=8, cut=0.0)
    out["c_single_ids"] = ids1.numpy()
    return out


def _pad_shards(X, D):
    nl = -(-len(X) // D)
    pad = np.zeros((D * nl,) + X.shape[1:], X.dtype)
    pad[:len(X)] = X
    return pad.reshape((D, nl) + X.shape[1:])


def _cluster_index(s):
    """A port ClusterIndex (int8 layout) from a JAX ClusterIndex's state."""
    from parlayann_tpu_torch import interop

    ps = interop.pointset_from_state(s["points"], s["n"], s["d"], "l2", device="cpu")
    q8 = interop.pointset_from_state(
        s["q8"], s["n"], s["d"], "l2", bits=8, quant_slope=s["slope"],
        quant_offset=s["offset"], device="cpu")
    return interop.cluster_index_from_state(
        ps, s["members"], s["adj"], s["centroids_q"], s["ext"], s["C"], s["m"],
        s["Rc"], "int8", qpoints=q8)


def global_job(st):
    """The global build: f32 and int8 builds at one size, the exact search
    over a complete graph and the larger build; then, with the late
    inputs, searches over the JAX package's graphs."""
    from parlayann_tpu_torch import interop
    from parlayann_tpu_torch.parallel.mesh import gather_shards, make_mesh_1d
    from parlayann_tpu_torch.parallel.global_build import (
        build_global_vamana, global_search,
    )

    mesh = make_mesh_1d(4, device="cpu")
    out = {}
    for dt in ("f32", "int8"):
        g = build_global_vamana(st[f"g_X_{dt}"], mesh, _bp(st["g_bp"][dt]))
        out[f"g_{dt}_nbrs"] = gather_shards(mesh, g.nbrs)
        out[f"g_{dt}_degs"] = gather_shards(mesh, g.degs)
        out[f"g_{dt}_ids"], out[f"g_{dt}_dists"] = global_search(
            g, st["g_Q"], k=10, beam_size=32)

    X, nb, dg = st["full_X"], st["full_nbrs"], st["full_degs"]
    full = interop.global_index_from_state(
        _pad_shards(X, 4), _pad_shards(nb, 4), _pad_shards(dg, 4), len(X), nb.shape[1],
        "l2", mesh)
    out["full_ids"], out["full_dists"] = global_search(full, st["full_Q"], k=5,
                                                       beam_size=16)

    g = build_global_vamana(st["big_X"], mesh, _bp(st["big_bp"]))
    out["big_ids"], _ = global_search(g, st["big_Q"], k=10, beam_size=48)

    jax = late(st)
    for dt in ("f32", "int8"):
        X = st[f"g_X_{dt}"]
        jn, jd = jax[f"g_{dt}_graph"]
        jg = interop.global_index_from_state(_pad_shards(X, 4), jn, jd, len(X), jn.shape[-1],
                                             "l2", mesh)
        out[f"g_{dt}_onjax_ids"], out[f"g_{dt}_onjax_dists"] = global_search(
            jg, st["g_Q"], k=10, beam_size=32)
    return out


def four_rank_job(st):
    """Every multi-device mode on ``st["device"]``'s mesh: the replica build
    on int8 and f32 data over a (4, 1) mesh and on int8 over the (2, 2)
    mesh, the global build on int8 and f32, the cluster-sharded build and
    the dryrun's three modes, each searched; kernel 2's f32 launches in
    this rank's f32 graph builds."""
    from dryrun_multichip_torch import dryrun_multichip
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.parallel.mesh import gather_shards, make_mesh, make_mesh_1d
    from parlayann_tpu_torch.parallel.sharded import build_sharded_vamana, sharded_search
    from parlayann_tpu_torch.parallel.global_build import build_global_vamana, global_search
    from parlayann_tpu_torch.parallel.cluster_sharded import build_sharded_cluster

    dev, out = st["device"], {}
    bp = _bp(st["bp"])
    meshes = {"a": make_mesh(4, data_axis=4, device=dev),
              "u": make_mesh(4, data_axis=2, device=dev), "g": make_mesh_1d(4, device=dev)}
    for tag, dt in (("a", "int8"), ("a", "f32"), ("u", "int8"), ("g", "int8"), ("g", "f32")):
        mesh, X = meshes[tag], st[f"X_{dt}"]
        build, search = ((build_global_vamana, global_search) if tag == "g"
                         else (build_sharded_vamana, sharded_search))
        occlusion_rounds.launches_f32 = 0
        idx = build(X[:st["n_u"]] if tag == "u" else X, mesh, bp)
        out[f"{tag}_{dt}_f32_launches"] = np.int64(occlusion_rounds.launches_f32)
        out[f"{tag}_{dt}_nbrs"] = gather_shards(mesh, idx.nbrs)
        out[f"{tag}_{dt}_degs"] = gather_shards(mesh, idx.degs)
        out[f"{tag}_{dt}_ids"], out[f"{tag}_{dt}_dists"] = search(
            idx, st[f"Q_{dt}"], k=10, beam_size=32)
    sci = build_sharded_cluster(st["c_X"], meshes["g"], m=32, Rc=16, iters=3)
    ids, dists, _ = sci.search(st["c_Q"], k=10, n_probe=8, cut=0.0)
    out.update(c_C=np.int64(sci.C), c_ids=ids.cpu().numpy(), c_dists=dists.cpu().numpy())
    for mode, (ids, dists) in dryrun_multichip(dev).items():
        out[f"dry_{mode}_ids"], out[f"dry_{mode}_dists"] = ids, dists
    return out
