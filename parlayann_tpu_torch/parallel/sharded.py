"""Dataset-sharded build and search: the per-shard replica mode.

Counterpart of parlayann_tpu/parallel/sharded.py. The dataset splits into
contiguous row blocks, one per ``d`` coordinate of the mesh; each shard
builds and owns an independent Vamana graph over its rows. The build needs
no collective: every rank walks the same batch schedule and draws every
shard's insert order from one generator, so shard s is built in the order
JAX builds it, and inserts only its own rows with the single-card batch
phases (``build/vamana.py``: the read phase at ``expand=1``, then the
forward robustPrune, the reverse append and the overflow α-prune, both
prunes on kernel 2). Queries replicate over ``d`` and split over ``q``;
each rank beam-searches its shard and the per-shard top-k merge through
one all-gather over ``d``, then the query blocks through one over ``q``.

Local ids become global ids by adding ``shard * rows_per_shard``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.build.vamana import (
    _pad_pow2, _read_phase, _sort_rows_by_distance, _write_batch,
    batch_schedule,
)
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.topk import smallest_k
from parlayann_tpu_torch.parallel.mesh import Mesh, all_gather, to_mesh
from parlayann_tpu_torch.search.beam import beam_search_batch, top_k_from_beam


@dataclasses.dataclass
class ShardedIndex:
    """This rank's shard of a dataset-sharded index: rows
    ``[d * rows_per_shard, (d + 1) * rows_per_shard)`` of the zero-padded
    dataset, with their local graph."""

    mesh: Mesh
    points: torch.Tensor  # (nl, dim)
    nbrs: torch.Tensor  # (nl, R) local ids
    degs: torch.Tensor  # (nl,)
    n: int  # total valid rows
    rows_per_shard: int
    max_degree: int
    metric: Metric
    start_point: int = 0

    def to(self, mesh: Mesh) -> "ShardedIndex":
        """The same shard on another mesh of the same shape (its device)."""
        return to_mesh(self, mesh)


def _storage(data: np.ndarray) -> np.ndarray:
    """uint8 rows build on an exact float32 copy (kernel 2 takes int8 or
    float32 vectors), as the single-card builds do."""
    return data.astype(np.float32) if data.dtype == np.uint8 else data


def shard_dataset(data: np.ndarray, mesh: Mesh, axis: str = "d"):
    """Zero-pad the rows to a multiple of the axis size and keep this
    rank's block -> ((nl, dim) tensor on the mesh's device, nl)."""
    D = mesh.shape[axis]
    n = data.shape[0]
    nl = -(-n // D)
    lo = mesh.index(axis) * nl
    block = np.zeros((nl,) + data.shape[1:], dtype=data.dtype)
    rows = data[lo:min(lo + nl, n)]
    block[:len(rows)] = rows
    return torch.from_numpy(block).to(mesh.device), nl


def build_sharded_vamana(
    data: np.ndarray,
    mesh: Mesh,
    bp: BuildParams,
    metric: Metric = Metric.L2,
    verbose: bool = False,
) -> ShardedIndex:
    """Build one Vamana graph per dataset shard, every rank its own. Each
    rank passes the full host ``data``."""
    metric = Metric.coerce(metric)
    D, s = mesh.shape["d"], mesh.index("d")
    n = data.shape[0]
    points, nl = shard_dataset(_storage(data), mesh)
    dev = mesh.device
    R, L = bp.R, bp.L
    vmax = max((3 * L) // 2, R + 16)
    nbrs = torch.zeros((nl, R), dtype=torch.int32, device=dev)
    degs = torch.zeros((nl,), dtype=torch.int32, device=dev)
    start = torch.zeros((1,), dtype=torch.int32, device=dev)

    counts = [min(nl, max(0, n - i * nl)) for i in range(D)]
    rng = np.random.default_rng(bp.seed)
    sched, max_batch = batch_schedule(nl, nl, bp.batch_cap_frac)
    for p in range(bp.num_passes):
        alpha = bp.alpha if p == bp.num_passes - 1 else 1.0
        # every shard's order, in shard order: one stream for all ranks
        orders = [rng.permutation(c).astype(np.int32) for c in counts]
        for lo, hi in sched:
            batches = [_pad_pow2(o[lo:hi], max_batch) if lo < c else None
                       for o, c in zip(orders, counts)]
            width = max((len(b) for b in batches if b is not None), default=0)
            if width == 0:
                continue
            mine = np.full(width, -1, dtype=np.int32)
            if batches[s] is not None:
                mine[:len(batches[s])] = batches[s]
            batch = torch.from_numpy(mine).to(dev)
            cand_ids, cand_d, _, _ = _read_phase(
                nbrs, degs, points, batch, start, None, R=R, L=L, vmax=vmax,
                metric=metric, n_valid=nl, expand=1)
            nbrs, degs = _write_batch(nbrs, degs, points, batch, cand_ids, cand_d,
                                      alpha, R=R, metric=metric, n_valid=nl)
        if verbose:
            print(f"sharded build: pass {p} done", flush=True)
    nbrs = _sort_rows_by_distance(nbrs, degs, points, R=R, metric=metric)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ShardedIndex(mesh=mesh, points=points, nbrs=nbrs, degs=degs, n=n,
                        rows_per_shard=nl, max_degree=R, metric=metric)


def sharded_search(
    idx: ShardedIndex,
    queries: np.ndarray,
    k: int = 10,
    beam_size: int = 64,
    cut: float = 1.35,
    expand: int = 1,
):
    """Search every shard and merge the per-shard top-k -> (ids (B, k),
    dists (B, k)) numpy, global ids, on every rank. Each rank passes all
    B queries and searches its block of them."""
    mesh = idx.mesh
    Qax, qi, s = mesh.shape["q"], mesh.index("q"), mesh.index("d")
    D, nl = mesh.shape["d"], idx.rows_per_shard
    queries = np.asarray(queries)
    B = len(queries)
    b = -(-B // Qax)
    qpad = np.zeros((b * Qax, queries.shape[1]), dtype=queries.dtype)
    qpad[:B] = queries
    qloc = torch.from_numpy(qpad[qi * b:(qi + 1) * b]).to(mesh.device)

    res = beam_search_batch(
        qloc, idx.points, idx.nbrs, idx.degs,
        torch.tensor([idx.start_point], dtype=torch.int32, device=mesh.device),
        metric=idx.metric, n_valid=nl, k=k, L=max(beam_size, k), cut=cut,
        expand=expand)
    ids, dists = top_k_from_beam(res, k)
    # the last shard's zero-pad rows are not points: mask them out BEFORE
    # the cross-shard merge so they cannot take top-k slots
    local_n = min(max(idx.n - s * nl, 0), nl)
    ok = (ids >= 0) & (ids < local_n)
    dists = torch.where(ok, dists, INF)
    gids = torch.where(ok, ids + s * nl, -1).to(torch.int32)
    all_d = all_gather(mesh, dists.contiguous(), "d").reshape(D, b, k)
    all_i = all_gather(mesh, gids, "d").reshape(D, b, k)
    md = all_d.permute(1, 0, 2).reshape(b, D * k)
    mi = all_i.permute(1, 0, 2).reshape(b, D * k)
    md = torch.where(mi >= 0, md, INF)
    dists, ids = smallest_k(md, mi, k)
    ids = all_gather(mesh, ids.contiguous(), "q")
    dists = all_gather(mesh, dists.contiguous(), "q")
    ids = torch.where(ids >= idx.n, -1, ids)
    return ids[:B].cpu().numpy(), dists[:B].cpu().numpy()
