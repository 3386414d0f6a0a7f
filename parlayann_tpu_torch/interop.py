"""Carry state between the JAX package and the port, as numpy arrays.

The JAX package's ``PointSet`` (every tier), ``GraphIndexData``,
``Index.entry_ids``, ``JLTier``, ``ClusterIndex``, ``FlatIndex``,
``HNSWIndex``, ``ShardedIndex`` and ``GlobalIndex`` are plain arrays plus
metadata; these
functions build the port's objects from those arrays (given as numpy), so
both packages can search one graph or one cluster index.
The other direction needs nothing here: the port's tensors convert with
``.cpu().numpy()``. Only numpy and torch are imported here.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.index import Index
from parlayann_tpu_torch.ops.quantize import JLTier
from parlayann_tpu_torch.build.clusterindex import ClusterIndex
from parlayann_tpu_torch.build.hnsw import HNSWIndex, _make_level
from parlayann_tpu_torch.search.flat import FlatIndex
from parlayann_tpu_torch.parallel.global_build import GlobalIndex
from parlayann_tpu_torch.parallel.mesh import Mesh
from parlayann_tpu_torch.parallel.sharded import ShardedIndex
from parlayann_tpu_torch.utils.device import resolve


def _metric(metric) -> Metric:
    # the JAX package's Metric enum has the same values ("Euclidian", "mips")
    return Metric.coerce(getattr(metric, "value", metric))


def pointset_from_state(data: np.ndarray, n: int, d: int, metric, bits: int = 32,
                        quant_slope=None, quant_offset=None,
                        device=None) -> PointSet:
    """A PointSet from ``PointSet.data`` (already padded) and its fields,
    on ``device`` (None: the card). The uint32 words of the 1-bit and MIPS
    2-bit tiers become int32 words with the same bits; the 1-bit tier's
    ``(d,)`` threshold vector stays a vector. The uint16 levels of an L2
    tier of 9 to 16 bits become the port's ``level - 32768`` in int16
    (ops/quantize.py); every other dtype (int8 tiers, the packed 4-bit
    tier, MIPS int16 levels, the points) is taken as it is."""
    device = resolve(device)

    def f32(v):
        return None if v is None else torch.tensor(
            np.asarray(v, dtype=np.float32), device=device)

    arr = np.asarray(data)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    elif arr.dtype == np.uint16:
        arr = (arr.astype(np.int32) - 32768).astype(np.int16)
    return PointSet(
        data=torch.tensor(arr).to(device), n=int(n),
        d=int(d), metric=_metric(metric), bits=int(bits),
        quant_slope=f32(quant_slope), quant_offset=f32(quant_offset))


def graph_from_state(neighbors: np.ndarray, degrees: np.ndarray, n: int,
                     max_degree: int, device=None) -> GraphIndexData:
    """A GraphIndexData from the padded ``neighbors``/``degrees`` arrays,
    on ``device`` (None: the card)."""
    device = resolve(device)
    return GraphIndexData(
        neighbors=torch.tensor(np.asarray(neighbors, dtype=np.int32)).to(device),
        degrees=torch.tensor(np.asarray(degrees, dtype=np.int32)).to(device),
        n=int(n), max_degree=int(max_degree))


def jl_tier_from_state(points: PointSet, proj: np.ndarray, bits: int,
                       tier_state: PointSet) -> JLTier:
    """A JLTier from the JAX ``JLTier.proj`` and its quantized ``points``
    (already converted by :func:`pointset_from_state`), installed as they
    are over the full-precision ``points``."""
    return JLTier(points, bits=bits, proj=np.array(proj, dtype=np.float32),
                  points=tier_state)


def index_from_state(points: PointSet, graph: GraphIndexData,
                     entry_ids: Optional[np.ndarray] = None,
                     qpoints: Optional[PointSet] = None,
                     bit_points: Optional[PointSet] = None,
                     jl_tier: Optional[JLTier] = None, use_inline: bool = True,
                     use_fused: bool = True,
                     t2_points: Optional[PointSet] = None,
                     t4_points: Optional[PointSet] = None) -> Index:
    """An Index over converted points, graph and tiers (with no
    ``qpoints`` it searches the full-precision tier; ``t2_points`` and
    ``t4_points`` are the JAX Index's MIPS 2-bit and 4-bit tiers);
    ``entry_ids`` (the JAX Index's sampled entry tier) are installed as
    they are, and the JAX Index's ``use_inline`` and ``use_fused``
    switches carried over."""
    idx = Index(points=points, graph=graph, qpoints=qpoints,
                bit_points=bit_points, jl_tier=jl_tier, use_inline=use_inline,
                use_fused=use_fused, t2_points=t2_points, t4_points=t4_points)
    if entry_ids is not None:
        idx.entry_ids = torch.tensor(np.asarray(entry_ids, dtype=np.int32)).to(points.device)
        idx.entry_vecs = points.data[idx.entry_ids.long()]
    return idx


def cluster_index_from_state(points: PointSet, members: np.ndarray,
                             adj: np.ndarray, centroids_q: np.ndarray,
                             ext: np.ndarray, C: int, m: int, Rc: int,
                             ext_dtype: str, qpoints: Optional[PointSet] = None,
                             seed_meta=None) -> ClusterIndex:
    """A ClusterIndex over the JAX ``ClusterIndex`` state: ``members``,
    ``adj``, ``centroids_q`` and the packed ``ext`` rows (byte-compatible
    layouts), with ``points`` and, for the int8 layout, the q8 tier
    ``qpoints`` already converted; ``seed_meta`` the JAX index's seed
    quantizer (mcents, blocks, idtab) as numpy arrays, or None."""
    dev = points.device
    if seed_meta is not None:
        seed_meta = tuple(torch.tensor(np.asarray(a)).to(dev) for a in seed_meta)
    return ClusterIndex(
        points=points, qpoints=qpoints,
        centroids_q=torch.tensor(np.asarray(centroids_q)).to(dev),
        members=np.asarray(members, dtype=np.int32),
        adj=np.asarray(adj, dtype=np.int32),
        ext=torch.tensor(np.asarray(ext)).to(dev), C=int(C), m=int(m),
        Rc=int(Rc), ext_dtype=str(ext_dtype), seed_meta=seed_meta)


def flat_index_from_state(points: PointSet,
                          qpoints: Optional[PointSet] = None) -> FlatIndex:
    """A FlatIndex over converted points and, if the JAX index had one,
    its q8 tier (installed as it is, not recomputed)."""
    fi = FlatIndex(points)
    fi.qpoints = qpoints
    return fi


def hnsw_index_from_state(points: PointSet, levels, entrances: np.ndarray,
                          m: int, efc: int, alpha: float, m_l: float) -> HNSWIndex:
    """An HNSWIndex over converted full-precision ``points`` from the JAX
    ``HNSWIndex`` state: ``levels`` lists, level 0 first, each level's
    (members, the first len(members) rows of its neighbours, of its
    degrees, cap); then the entrance list and the build's parameters."""
    return HNSWIndex(
        points=points,
        levels=[_make_level(points, np.asarray(mem, dtype=np.int32), int(cap),
                            nbrs=np.asarray(nb), degs=np.asarray(dg))
                for mem, nb, dg, cap in levels],
        entrances=np.asarray(entrances, dtype=np.int32), m=int(m), efc=int(efc),
        alpha=float(alpha), m_l=float(m_l))


def _shard_fields(points, nbrs, degs, mesh: Mesh):
    """This rank's slices of (D, nl, ...) arrays, on the mesh's device."""
    s = mesh.index("d")

    def part(a, dtype=None):
        a = np.asarray(a)
        if a.shape[0] != mesh.shape["d"]:
            raise ValueError(f"state has {a.shape[0]} shards, the mesh's d axis "
                             f"{mesh.shape['d']}")
        return torch.from_numpy(np.ascontiguousarray(a[s], dtype=dtype)).to(mesh.device)

    pts = part(points)
    return dict(points=pts, nbrs=part(nbrs, np.int32), degs=part(degs, np.int32),
                rows_per_shard=int(pts.shape[0]))


def sharded_index_from_state(points: np.ndarray, nbrs: np.ndarray, degs: np.ndarray,
                             n: int, max_degree: int, metric, mesh: Mesh,
                             start_point: int = 0) -> ShardedIndex:
    """This rank's ShardedIndex from the JAX ``ShardedIndex``'s (D, nl, ...)
    ``points``, ``nbrs`` and ``degs`` (local ids), as numpy."""
    return ShardedIndex(mesh=mesh, n=int(n), max_degree=int(max_degree),
                        metric=_metric(metric), start_point=int(start_point),
                        **_shard_fields(points, nbrs, degs, mesh))


def global_index_from_state(points: np.ndarray, nbrs: np.ndarray, degs: np.ndarray,
                            n: int, max_degree: int, metric, mesh: Mesh,
                            start_point: int = 0) -> GlobalIndex:
    """This rank's GlobalIndex from the JAX ``GlobalIndex``'s (D, nl, ...)
    ``points``, ``nbrs`` (global ids) and ``degs``, as numpy."""
    return GlobalIndex(mesh=mesh, n=int(n), max_degree=int(max_degree),
                       metric=_metric(metric), start_point=int(start_point),
                       **_shard_fields(points, nbrs, degs, mesh))
