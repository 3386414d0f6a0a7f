"""Index — the query-side handle (graph + points + the q8 tier).

Counterpart of parlayann_tpu/index.py (GraphIndex, python/graph_index.cpp:
82-305). ``batch_search`` on the q8 tier is the JAX package's fused path
(``_fused_search_1d``, index.py:63-93): entry top-1 over a sampled tier (or
the given starts) -> query translation to q8 -> kernel 3's beam search ->
full-precision rerank. The configurations this slice does not serve raise
NotImplementedError naming the ROADMAP item; none falls back to another
path.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric, QueryParams
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.fusedbeam import beam_search_fused
from parlayann_tpu_torch.search.rerank import rerank_topk
from parlayann_tpu_torch.utils.timing import timed_rounds


class FusedResult(NamedTuple):
    ids: torch.Tensor  # (B, k)
    dists: torch.Tensor  # (B, k) full precision
    num_visited: torch.Tensor  # (B,)
    dist_cmps: torch.Tensor  # (B,)


def _entry_top1(q: torch.Tensor, evecs: torch.Tensor, eids: torch.Tensor, *,
                metric: Metric) -> torch.Tensor:
    """Exact nearest sampled point per query -> (B, 1) start ids: one
    (B, E) float32 matmul and a row argmin (first index on ties)."""
    ev = evecs.float()
    dot = q.float() @ ev.T
    if metric is Metric.MIPS:
        dist = -dot
    else:
        dist = (ev * ev).sum(dim=1)[None, :] - 2.0 * dot
    return eids[dist.argmin(dim=1)][:, None]


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet; see ROADMAP {item}")


@dataclasses.dataclass
class Index:
    points: PointSet
    graph: GraphIndexData
    start_point: int = 0
    qpoints: Optional[PointSet] = None  # q8 tier (graph_index.cpp:86-101)
    # sampled entry tier: each query starts from its exact nearest point in
    # a fixed ~4K uniform sample instead of ``start_point``
    entry_ids: Optional[torch.Tensor] = None
    entry_vecs: Optional[torch.Tensor] = None
    use_entry: bool = True
    entry_min_n: int = 20_000  # below this the start point is fine

    @property
    def device(self) -> torch.device:
        return self.points.device

    def enable_quantized(self, bits: int = 8, trim: float = 0.0) -> "Index":
        """Build the scalar-quantized search tier (graph_index.cpp:86-101)."""
        self.qpoints = quantize.quantize_pointset(self.points, bits=bits, trim=trim)
        return self

    def build_entry_cache(self, E: int = 4096, seed: int = 0):
        """Fixed uniform sample for the entry tier, drawn as the JAX package
        draws it (same seed, same ids). A tier of the same size is kept."""
        E = min(E, self.points.n)
        if self.entry_ids is not None and self.entry_ids.shape[0] == E:
            return
        ids = np.random.default_rng(seed).choice(
            self.points.n, E, replace=False).astype(np.int32)
        self.entry_ids = torch.from_numpy(ids).to(self.device)
        self.entry_vecs = self.points.data[self.entry_ids.long()]

    def batch_search(self, queries, k: int = 10, beam_size: int = 128,
                     cut: float = 1.35, limit: Optional[int] = None,
                     degree_limit: Optional[int] = None, expand: int = 1,
                     rerank_factor: int = 10, random_starts: int = 0,
                     starts=None):
        """Search all query rows -> (ids (B, k), dists (B, k), FusedResult).

        ``starts``: optional per-query start ids, (B,) or (B, S); they take
        precedence over the entry tier and ``start_point``. The rerank pool
        is min(k * rerank_factor, beam)."""
        if self.qpoints is None:
            _not_ported("search without the q8 tier (the f32 tier)",
                        "queue 1, item 17")
        if expand != 1:
            _not_ported("multi-expansion search (expand > 1)", "queue 2")
        if random_starts > 0:
            _not_ported("random_starts", "queue 1, item 11")
        qp = QueryParams(k=k, beamSize=beam_size, cut=cut, limit=limit,
                         degree_limit=degree_limit).resolved(
            self.graph.max_degree, self.points.n)
        if qp.degree_limit < self.graph.max_degree:
            _not_ported("degree_limit < R on the fused path", "queue 2")
        qf = torch.as_tensor(queries).to(self.device, torch.float32)
        if starts is not None:
            start_arr = torch.as_tensor(starts).to(self.device, torch.int32)
            if start_arr.dim() == 1:
                start_arr = start_arr[:, None]
        elif self.use_entry and self.points.n >= self.entry_min_n:
            # never clobber a caller-built tier (index.py:323-331)
            if self.entry_ids is None:
                self.build_entry_cache()
            start_arr = _entry_top1(qf, self.entry_vecs, self.entry_ids,
                                    metric=self.points.metric)
        else:
            start_arr = torch.tensor([self.start_point], dtype=torch.int32,
                                     device=self.device)
        tier = self.qpoints
        L = max(qp.beamSize, k)
        q_t = quantize.translate_query(qf, tier).float()
        fid, _, nv, cmps = beam_search_fused(
            q_t, tier.data, self.graph.neighbors, self.graph.degrees, start_arr,
            metric=tier.metric, n_valid=tier.n, k=k, L=L, cut=qp.cut,
            limit=qp.limit)
        pool = min(max(k * rerank_factor, k), L)
        ids, dists = rerank_topk(qf, self.points.data, fid, k=k, pool=pool,
                                 metric=self.points.metric)
        return ids, dists, FusedResult(ids, dists, nv, cmps)

    def batch_search_timed(self, queries, warmup: bool = True, rounds: int = 1,
                           **kw):
        """Timed steady-state search -> (ids, dists, res, seconds per round):
        queries uploaded first, one warm-up search, then ``rounds``
        back-to-back searches fenced by ``torch.cuda.synchronize``."""
        queries = torch.as_tensor(queries).to(self.device, torch.float32)
        out, secs = timed_rounds(lambda: self.batch_search(queries, **kw),
                                 self.device, rounds, warmup)
        return (*out, secs)

    def single_search(self, query, k: int = 10, beam_size: int = 128, **kw):
        ids, dists, _ = self.batch_search(
            np.asarray(query)[None, :], k=k, beam_size=beam_size, **kw)
        return ids[0].cpu().numpy(), dists[0].cpu().numpy()

    def check_recall(self, queries, gt_ids, gt_dists=None, k: int = 10,
                     beam_size: int = 64, **kw):
        """Search + tie-aware recall (graph_index.cpp:259-305)."""
        from parlayann_tpu_torch.harness.recall import compute_recall

        ids, _, _ = self.batch_search(queries, k=k, beam_size=beam_size, **kw)
        return compute_recall(ids.cpu().numpy(), np.asarray(gt_ids),
                              None if gt_dists is None else np.asarray(gt_dists), k)
