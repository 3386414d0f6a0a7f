"""High-level API with boundary validation (ParlayANNpy parity).

Counterpart of parlayann_tpu/api.py for the Vamana, HCNNG, pyNNDescent,
HNSW and ClusterIndex builds and ``load_index``: a bad dtype, metric,
shape or path raises ValueError before any device work starts.
"""

from __future__ import annotations

import os

import numpy as np

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet

VALID_DTYPES = (np.float32, np.int8, np.uint8)
VALID_METRICS = ("euclidian", "l2", "mips")


def valid_dtype(dtype) -> np.dtype:
    """Canonicalize a user dtype -> float32/int8/uint8, or raise."""
    dt = np.dtype(dtype)
    for ok in VALID_DTYPES:
        if dt == np.dtype(ok):
            return np.dtype(ok)
    raise ValueError(f"vector dtype must be one of float32/int8/uint8, got {dt}")


def valid_metric(metric) -> Metric:
    """Canonicalize 'Euclidian'/'l2'/'mips' (any case) or a Metric, or raise."""
    if isinstance(metric, Metric):
        return metric
    if isinstance(metric, str) and metric.lower() in VALID_METRICS:
        return Metric.MIPS if metric.lower() == "mips" else Metric.L2
    raise ValueError(
        f"distance_metric must be one of 'Euclidian'/'l2'/'mips', got {metric!r}")


def _valid_data(data, name="data"):
    if isinstance(data, PointSet):
        return data
    arr = np.asarray(data)
    if arr.ndim != 2 or arr.shape[0] == 0 or arr.shape[1] == 0:
        raise ValueError(
            f"{name} must be a nonempty 2-D array (n, d), got shape {arr.shape}")
    return arr.astype(valid_dtype(arr.dtype), copy=False)


def _valid_pos(name, value, lo=1):
    if not isinstance(value, (int, np.integer)) or value < lo:
        raise ValueError(f"{name} must be an integer >= {lo}, got {value!r}")
    return int(value)


def build_vamana_index(data, metric="Euclidian", R: int = 64, L: int = 128,
                       alpha: float = 1.2, two_pass: bool = True,
                       quantize_build: bool = True, **kwargs):
    """Validated Vamana build (python/wrapper.py:4-24) -> (graph, points,
    stats): on the q8 tier, or on the float32 points with
    ``quantize_build=False``. Other keyword arguments go to
    :func:`build.vamana.build_vamana_index` (``device``,
    ``batch_cap_frac``, ``seed``, the build modes ``single_batch``,
    ``cand_mode``, ``profile`` and ``fused_read``, ...)."""
    from parlayann_tpu_torch.build import vamana

    data = _valid_data(data)
    _valid_pos("R", R), _valid_pos("L", L)
    if L < R:
        raise ValueError(f"L (beam {L}) must be >= R (degree {R})")
    if not (0.8 <= float(alpha) <= 4.0):
        raise ValueError(f"alpha must be in [0.8, 4], got {alpha}")
    return vamana.build_vamana_index(
        data, metric=valid_metric(metric), R=R, L=L, alpha=alpha,
        two_pass=two_pass, quantize_build=quantize_build, **kwargs)


def build_hcnng_index(data, metric="Euclidian", mst_deg: int = 3,
                      num_clusters: int = 30, cluster_size: int = 1000,
                      device=None, **kwargs):
    """Validated HCNNG build (api.py:85-98) -> (graph, PointSet, build
    seconds). ``data`` becomes a PointSet on ``device`` (None: the card)
    unless it is one; other keyword arguments go to
    :func:`build.hcnng.build_hcnng_index` (``seed``, ``verbose``)."""
    from parlayann_tpu_torch.build import hcnng

    data = _valid_data(data)
    _valid_pos("mst_deg", mst_deg)
    _valid_pos("num_clusters", num_clusters)
    _valid_pos("cluster_size", cluster_size, lo=2)
    return hcnng.build_hcnng_index(
        data, metric=valid_metric(metric), mst_deg=mst_deg,
        num_clusters=num_clusters, cluster_size=cluster_size, device=device,
        **kwargs)


def build_pynndescent_index(data, metric="Euclidian", max_deg: int = 40,
                            num_clusters: int = 10, cluster_size: int = 100,
                            alpha: float = 1.2, delta: float = 0.05,
                            device=None, **kwargs):
    """Validated pyNNDescent build (api.py:101-116) -> (graph, PointSet,
    build seconds). ``data`` becomes a PointSet on ``device`` (None: the
    card) unless it is one; other keyword arguments go to
    :func:`build.pynndescent.build_pynndescent_index` (``quantize_build``,
    ``seed``, ``verbose``). Search with ``random_starts``."""
    from parlayann_tpu_torch.build import pynndescent

    data = _valid_data(data)
    _valid_pos("max_deg", max_deg)
    if not (0.0 < float(delta) < 1.0):
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    return pynndescent.build_pynndescent_index(
        data, metric=valid_metric(metric), K=max_deg,
        num_clusters=num_clusters, cluster_size=cluster_size,
        alpha=alpha, delta=delta, device=device, **kwargs)


def build_hnsw_index(data, metric="Euclidian", m: int = 20, efc: int = 50,
                     alpha: float = 0.9, m_l: float = 0.34, device=None,
                     **kwargs):
    """Validated HNSW build (api.py:119-129) -> (HNSWIndex, full-precision
    PointSet, build seconds). ``data`` becomes a PointSet on ``device``
    (None: the card) unless it is one; other keyword arguments go to
    :func:`build.hnsw.build_hnsw_index` (``quantize_build``,
    ``batch_cap_frac``, ``seed``, ``verbose``)."""
    from parlayann_tpu_torch.build import hnsw

    data = _valid_data(data)
    _valid_pos("m", m), _valid_pos("efc", efc)
    return hnsw.build_hnsw_index(data, metric=valid_metric(metric), m=m, efc=efc,
                                 alpha=alpha, m_l=m_l, device=device, **kwargs)


def load_index(graph_path: str, data_path: str, metric="Euclidian", **kwargs):
    """Validated :meth:`Index.load` (graph_index.cpp ctor): both files must
    exist before any device work starts. Keyword arguments go to
    ``Index.load`` (``dtype``, ``quantize_bits``, ``auto_tier``,
    ``device``)."""
    from parlayann_tpu_torch.index import Index

    for p, name in ((graph_path, "graph_path"), (data_path, "data_path")):
        if not isinstance(p, (str, os.PathLike)) or not os.path.exists(p):
            raise ValueError(f"{name} does not exist: {p!r}")
    return Index.load(graph_path, data_path, metric=valid_metric(metric), **kwargs)


def build_cluster_index(data, metric="Euclidian", m: int = 64, Rc: int = 16,
                        device=None, **kwargs):
    """Validated ClusterIndex build (api.py:132-151) -> ClusterIndex.
    ``data`` becomes a PointSet on ``device`` (None: the card) unless it
    is one; keyword arguments go to :meth:`ClusterIndex.build` (``slack``,
    ``iters``, ``ext_dtype``, ``seed``, ...)."""
    from parlayann_tpu_torch.build.clusterindex import ClusterIndex

    data = _valid_data(data)
    _valid_pos("m", m, lo=8), _valid_pos("Rc", Rc, lo=8)
    if m % 8 or Rc % 8:
        raise ValueError(f"m and Rc must be multiples of 8, got {m}, {Rc}")
    if not isinstance(data, PointSet):
        data = PointSet.from_numpy(data, metric=valid_metric(metric),
                                   device=device)
    if data.d < m or data.d < Rc:
        raise ValueError(
            f"packed id planes need d >= m and d >= Rc "
            f"(d={data.d}, m={m}, Rc={Rc})")
    return ClusterIndex.build(data, m=m, Rc=Rc, **kwargs)
