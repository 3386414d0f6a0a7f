"""Flat (brute-force) k-NN: exact top-k by a distance scan.

Counterpart of parlayann_tpu/search/flat.py. The (B, N) distance matrix is
never materialised: points are scanned in chunks and every chunk is
reduced to k candidates at once.

The JAX package has four selects. On the TPU, "sort" (two-level lane
sorts), "groupmin" (a per-64-group min, exact only at k = 1) and "approx"
(``lax.approx_min_k``, the TPU's PartialReduce unit) are XLA glue, and
"pallas" is the flatscan kernel. Here "sort", "groupmin" and "approx" are
one exact path, a ``torch.matmul`` per chunk plus a stable sort
(:func:`flat_topk_plain` on any device), and "pallas" is kernel 4
(:func:`flat_topk`), which returns the same exact answer. Results are
ordered by (distance, id). The distance algebra is the JAX package's:
``||x||^2 - 2 q.x`` to select, ``||q||^2`` added back to the survivors and
clamped at 0.
"""

from __future__ import annotations

import torch

from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize as qz
from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk, flat_topk_plain
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.utils import trace
from parlayann_tpu_torch.utils.timing import timed_rounds

SELECTS = ("sort", "groupmin", "approx", "pallas")


def flat_search_batch(queries, points_data, valid_mask=None, exclude_ids=None,
                      *, k: int, metric: Metric, n_valid: int,
                      chunk: int = 32768, select: str = "sort",
                      precision: str = "fast"):
    """-> (ids (B, k) int32, -1 where empty; dists (B, k) f32 in the data's
    domain: true squared L2, or -dot for MIPS).

    ``points_data`` (n_pad, d) f32 or int8; ``valid_mask`` (n_pad,) bool
    and ``exclude_ids`` (B,) int32 (a per-query id never returned) are the
    builder's exact-candidate options. ``precision`` "fast" and "exact"
    both compute float32-accurate distances: the plain path in float32,
    kernel 4 in 3xTF32 on the tensor cores (a single-pass "fast" is
    ROADMAP queue 2, "B2. flat_topk")."""
    if select not in SELECTS:
        raise ValueError(f"select must be one of {SELECTS}, got {select!r}")
    if select == "pallas":
        return flat_topk(queries, points_data, valid_mask, exclude_ids, k=k,
                         metric=metric, n_valid=n_valid, precision=precision)
    return flat_topk_plain(queries, points_data, valid_mask, exclude_ids, k=k,
                           metric=metric, n_valid=n_valid, precision=precision,
                           chunk=chunk)


class FlatIndex:
    """Query-side handle for brute-force search (the recall-1.0 tier).

    ``quantize=True`` searches the q8 tier (4x fewer bytes per point; the
    same top-k up to quantization ties) with queries translated into the
    tier's domain."""

    def __init__(self, points: PointSet, quantize: bool = False):
        self.points = points
        self.qpoints = None
        if quantize:
            self.qpoints = qz.quantize_pointset(points, bits=8)

    @property
    def device(self) -> torch.device:
        return self.points.device

    def batch_search(self, queries, k: int = 10, select: str = "sort",
                     chunk: int = 32768, **_ignored):
        """-> (ids (B, k), dists (B, k)); q8-tier distances are in the
        tier's domain. Other keywords (``Index.batch_search``'s
        ``beam_size``, ``cut``, ...) are ignored, as the JAX package's
        FlatIndex ignores them, so a harness can search either index.
        Under the recorder (``utils/trace.py``) the call is a ``search``
        span (host time; counting its ``queries``) over
        ``search.translate`` (the q8 tier) and ``flat.scan`` (the top-k
        selection with its finish), which time the stream where they are
        timed."""
        with trace.span("search"):
            q = torch.as_tensor(queries).to(self.device, torch.float32)
            trace.count("queries", q.shape[0])
            ps = self.qpoints or self.points
            if self.qpoints is not None:
                with trace.span("search.translate", self.device):
                    q = qz.translate_query(q, self.qpoints).float()
            with trace.span("flat.scan", self.device):
                return flat_search_batch(q, ps.data, k=k, metric=self.points.metric,
                                         n_valid=ps.n, chunk=chunk, select=select)

    def batch_search_timed(self, queries, warmup: bool = True, rounds: int = 1,
                           **kw):
        """Timed steady-state search -> (ids, dists, seconds per round):
        queries uploaded first, one warm-up search, then ``rounds``
        back-to-back searches fenced by ``torch.cuda.synchronize``."""
        queries = torch.as_tensor(queries).to(self.device, torch.float32)
        out, secs = timed_rounds(lambda: self.batch_search(queries, **kw),
                                 self.device, rounds, warmup)
        return (*out, secs)
