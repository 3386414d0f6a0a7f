"""The three multi-device modes of the PyTorch port at the sizes of the JAX
package's ``dryrun_multichip`` (``__graft_entry__.py``), on the process
group it runs in: the global cross-shard build and search, the per-shard
replica build and search on a (d, q) mesh, and the cluster-sharded build
and search. Imports no jax.

Usage, from the repository root:

    python3 dryrun_multichip_torch.py                        # one rank, the card, NCCL
    python3 dryrun_multichip_torch.py --device cpu --ranks 4  # four gloo ranks

``--ranks N`` spawns N processes that meet through a file in a temporary
directory; on CUDA, rank r runs on card r. Inside a group that is already
initialised (``torchrun``, a test's spawner), call :func:`dryrun_multichip`.
"""

from __future__ import annotations

import argparse
import os
import tempfile
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def dryrun_multichip(device=None) -> dict:
    """Run the three modes over every rank of the initialised world ->
    {mode: (ids, dists)}, the same on every rank. Rank 0 prints the
    collective volume tables."""
    from parlayann_tpu_torch.types import BuildParams
    from parlayann_tpu_torch.parallel.mesh import make_mesh, make_mesh_1d
    from parlayann_tpu_torch.parallel.sharded import build_sharded_vamana, sharded_search
    from parlayann_tpu_torch.parallel.global_build import (
        build_global_vamana, collective_volume_report, global_search,
    )
    from parlayann_tpu_torch.parallel.cluster_sharded import build_sharded_cluster

    n_devices = dist.get_world_size()
    rng = np.random.default_rng(0)
    bp = BuildParams(R=8, L=16, alpha=1.2, num_passes=1, batch_cap_frac=1.0)
    out = {}

    # 1. the global build: one graph over all n, rows sharded over d
    mesh1 = make_mesh_1d(n_devices, device=device)
    n, dim = 64 * n_devices, 16
    X = rng.standard_normal((n, dim)).astype(np.float32)
    Q = rng.standard_normal((2 * n_devices, dim)).astype(np.float32)
    gidx = build_global_vamana(X, mesh1, bp)
    out["global"] = global_search(gidx, Q, k=5, beam_size=16)
    assert out["global"][0].shape == (len(Q), 5)
    assert (out["global"][0] < n).all()
    if dist.get_rank() == 0:
        collective_volume_report(n, n_devices, R=bp.R, L=bp.L, dim=dim, batch=n)
        collective_volume_report(1_000_000, n_devices, R=64, L=128, dim=128, batch=4096)
        collective_volume_report(1_000_000, n_devices, R=64, L=128, dim=128,
                                 batch=4096, itemsize_vec=1)

    # 2. per-shard replicas on a (d, q) mesh, queries split over q
    d_axis, q_axis = n_devices, 1
    if n_devices % 2 == 0 and n_devices > 2:
        d_axis, q_axis = n_devices // 2, 2
    mesh2 = make_mesh(n_devices, data_axis=d_axis, device=device)
    Xs, Qs = X[:64 * d_axis], Q[:4 * q_axis]
    idx = build_sharded_vamana(Xs, mesh2, bp)
    out["sharded"] = sharded_search(idx, Qs, k=5, beam_size=16)
    assert out["sharded"][0].shape == (len(Qs), 5)
    assert (out["sharded"][0] < len(Xs)).all()

    # 3. the cluster-sharded capacity mode: Lloyd over row-sharded points,
    # the member payload sharded by cluster block
    sci = build_sharded_cluster(X, mesh1, m=8, Rc=8, iters=2)
    cids, cdists, _ = sci.search(Q, k=5, n_probe=4, cut=0.0)
    out["cluster"] = (cids.cpu().numpy(), cdists.cpu().numpy())
    assert out["cluster"][0].shape == (len(Q), 5)
    assert (out["cluster"][0] < n).all()
    return out


def _rank(rank: int, world: int, store: str, device: str) -> None:
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        # ranks on one host share its cores: idle OpenMP threads spinning in
        # one rank slow the others' collectives down
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    backend = "nccl" if device == "cuda" else "gloo"
    kw = dict(device_id=torch.device("cuda", rank)) if device == "cuda" else {}
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=timedelta(seconds=300), **kw)
    try:
        dryrun_multichip(device)
        if rank == 0:
            print(f"dryrun_multichip_torch: {world} rank(s) on {device} ok", flush=True)
    finally:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=1)
    args = ap.parse_args()
    if args.device == "cuda" and torch.cuda.device_count() < args.ranks:
        raise SystemExit(f"{args.ranks} rank(s) need as many CUDA cards, "
                         f"found {torch.cuda.device_count()}")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if args.ranks == 1:
            _rank(0, 1, store, args.device)
        else:
            torch.multiprocessing.start_processes(
                _rank, args=(args.ranks, store, args.device), nprocs=args.ranks,
                start_method="spawn")


if __name__ == "__main__":
    main()
