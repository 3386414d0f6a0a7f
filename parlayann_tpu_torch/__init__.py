"""parlayann_tpu_torch — the PyTorch + CUDA port of parlayann_tpu.

The JAX package ``parlayann_tpu`` is the reference; this package keeps its
module names so each module's counterpart is easy to find. Plain tensor code
is PyTorch; every Pallas kernel on the ported path is a hand-written CUDA
kernel for Hopper (``csrc/``), built with nvcc at first use and bound through
ctypes. Nothing here imports jax.

Ported so far: the Vamana build on the q8 tier or on the f32 points
(:func:`build_vamana_index`, ``quantize_build=False``), with its
``single_batch``, ``cand_mode="exact"`` and ``profile`` modes; the search
of :class:`Index` on the f32 points, on the scalar tiers of 1 to 16 bits
(the fused beam on int8 levels, or the lock-step search: int16 levels,
``expand > 1`` or ``degree_limit < R``), on the packed 1-bit tier
(``enable_bit_tier``), the MIPS 2-bit and 4-bit tiers
(``enable_mips_2bit``, ``enable_mips_4bit``) and the JL tiers
(``enable_jl``, any width, dense and sparse), the quantized ones with a
full-precision rerank; the two-tier filter of ``beam_search_batch``; the
ClusterIndex build and search (:func:`build_cluster_index`,
:class:`ClusterIndex`); the flat brute-force search (:class:`FlatIndex`);
the HNSW build and its layered search (:func:`build_hnsw_index`,
:class:`HNSWIndex`, with the v2 and the reference's v3 model files); the
HCNNG and pyNNDescent builds (:func:`build_hcnng_index`,
:func:`build_pynndescent_index`) and ``random_starts`` search; the
reference's file formats (``data/io.py``, ``PointSet.from_file``,
``GraphIndexData.load``/``save``, :func:`load_index`, ``Index.save``,
``ClusterIndex.save``/``load``); range search (``search/range.py``:
``range_search_batch``, ``range_query``, ``self_join``) with its exact
ground truth; the sweep harnesses (``harness/sweep.py``,
``harness/range_sweep.py``, ``harness/csv.py``), the data tools
(``python -m parlayann_tpu_torch.tools.<name>``) and the reference's
command line (``python -m parlayann_tpu_torch.cli``).
Entry points that place data take ``device``; ``None`` means the CUDA
card, and without one they raise rather than run on the CPU.
"""

from parlayann_tpu_torch.types import BuildParams, QueryParams, RangeParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.api import (
    build_vamana_index,
    build_hcnng_index,
    build_pynndescent_index,
    build_hnsw_index,
    build_cluster_index,
    load_index,
)
from parlayann_tpu_torch.index import Index
from parlayann_tpu_torch.build.clusterindex import ClusterIndex
from parlayann_tpu_torch.build.hnsw import HNSWIndex
from parlayann_tpu_torch.search.flat import FlatIndex

__version__ = "0.1.0"

__all__ = [
    "BuildParams",
    "QueryParams",
    "RangeParams",
    "Metric",
    "PointSet",
    "GraphIndexData",
    "build_vamana_index",
    "build_hcnng_index",
    "build_pynndescent_index",
    "build_hnsw_index",
    "build_cluster_index",
    "load_index",
    "Index",
    "ClusterIndex",
    "HNSWIndex",
    "FlatIndex",
]
