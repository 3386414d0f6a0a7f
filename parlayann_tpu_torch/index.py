"""Index — the query-side handle (graph + points + the search tiers).

Counterpart of parlayann_tpu/index.py (GraphIndex, python/graph_index.cpp:
82-305). ``batch_search`` picks the tier by the JAX package's priority,
1-bit > JL > MIPS 2-bit > MIPS 4-bit > scalar > full (index.py:343-367):

- the packed 1-bit tier (``enable_bit_tier``) and the JL sign-bit tier
  (``enable_jl(bits=1)``) run the lock-step ``beam_search_batch(bits=1)``
  with ``k=0`` over an inline word array through kernel 6
  (``expand_bits_flat``);
- the JL scalar tiers (``enable_jl(bits=8)``, or any width) run the
  lock-step search with ``k`` over their projections, gathering rows;
- the MIPS 2-bit tier (``enable_mips_2bit``) runs the lock-step search
  with ``k=0`` and the MIPS 4-bit tier (``enable_mips_4bit``) with ``k``,
  both gathering rows (ternary words, packed nibbles), as in JAX;
- a scalar tier stored in int8 (``enable_quantized(bits)`` with bits <= 8)
  is the JAX package's fused path (``_fused_search_1d``, index.py:63-93)
  on kernel 3 when ``use_fused`` holds, ``expand == 1`` and ``degree_limit
  >= R``;
- everything else on a scalar tier (``expand > 1``, ``degree_limit < R``,
  ``use_fused=False``, and the int16 tiers of 9 to 16 bits, whose rows
  kernel 3 does not read) and the full-precision (f32) tier run the
  lock-step ``search/fused.py:fused_search`` (index.py:416-446) over the
  tier's inline rows (``build_inline_cache``, kernel 1 on int8, int16 or
  f32 rows) or, past the cache's byte budget, by gathering rows.

Every tier starts from the entry top-1 over a sampled tier (or the given
starts, or ``start_point``); the quantized tiers end in the
full-precision rerank, the f32 tier in the beam's first k entries. On the
card the entry top-1 is one launch of ``ops/kernels/entry.py:entry_top1``
(``csrc/entry.cu``): the (B, E) distances in 3xTF32 ``wgmma`` tiles on the
tensor cores, folded into each row's argmin in registers, so no (B, E)
array reaches device memory (the JAX package's fused dot and argmin,
index.py:39-55); on the CPU one float32 matmul and a row argmin. What it
reads of the tier (``entry_tier``: the float32 rows, their bias,
``||e||^2`` for L2 or 0 for MIPS, the int32 ids and, on the card, the rows
split into TF32 hi and lo parts) is made once a tier (``_entry_tier``),
also for a tier that ``interop`` or the HNSW index installs as
``entry_vecs``. The
JAX package's TPU-only eligibility tests of the fused kernel (its VMEM
beam-state budget, ``d >= R8``) are not carried over: kernel 3 takes any
L up to 4096 and any d. ``random_starts`` draws each query's starts as
the JAX package does (index.py:318-322); nothing falls back to another
path.

``Index.load``/``save`` read and write the reference's graph and data
files (data/io.py), and ``batch_search_from_string`` searches a big-ann
``.bin`` byte string.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import Metric, QueryParams
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.entry import EntryTier, entry_tier, entry_top1
from parlayann_tpu_torch.ops.kernels.expand import build_inline, build_inline_bits
from parlayann_tpu_torch.ops.kernels.fusedbeam import beam_search_fused
from parlayann_tpu_torch.search.beam import beam_search_batch
from parlayann_tpu_torch.search.fused import FusedResult, fused_search
from parlayann_tpu_torch.search.rerank import rerank_topk
from parlayann_tpu_torch.utils import trace
from parlayann_tpu_torch.utils.timing import timed_rounds


@dataclasses.dataclass
class Index:
    points: PointSet
    graph: GraphIndexData
    start_point: int = 0
    qpoints: Optional[PointSet] = None  # scalar tier (graph_index.cpp:86-101)
    # (n_pad, R8, d) inline neighbour rows of the lock-step search's tier
    # (the scalar tier if any, else the points), in its dtype; None past the
    # byte budget of build_inline_cache, which then clears use_inline
    inline: Optional[torch.Tensor] = None
    use_inline: bool = True
    _inline_src: Optional[PointSet] = None
    use_fused: bool = True  # the q8 tier's kernel-3 walk where it applies
    bit_points: Optional[PointSet] = None  # packed 1-bit tier
    jl_tier: Optional[quantize.JLTier] = None
    t2_points: Optional[PointSet] = None  # ternary 2-bit MIPS tier
    t4_points: Optional[PointSet] = None  # packed 4-bit MIPS tier
    # (n_pad, R8, W) int32 inline words of a 1-bit tier, and that tier
    inline_bits: Optional[torch.Tensor] = None
    _inline_bits_src: Optional[PointSet] = None
    # sampled entry tier: each query starts from its exact nearest point in
    # a fixed ~4K uniform sample instead of ``start_point``
    entry_ids: Optional[torch.Tensor] = None
    entry_vecs: Optional[torch.Tensor] = None
    use_entry: bool = True
    entry_min_n: int = 20_000  # below this the start point is fine
    # what the entry top-1 reads of the tier (_entry_tier), and the
    # (entry_vecs, entry_ids) it was made from
    _entry: Optional[EntryTier] = None
    _entry_src: Optional[tuple] = None

    @property
    def device(self) -> torch.device:
        return self.points.device

    @staticmethod
    def load(graph_path: str, data_path: str, metric: Metric = Metric.L2,
             dtype=None, quantize_bits: int = 8, auto_tier: bool = True,
             device=None) -> "Index":
        """An Index over a reference graph file and a data file (JAX
        index.py:131-155), on ``device`` (None: the card). float32 and
        uint8 points get the scalar tier of ``quantize_bits`` (0: none;
        uint8 through its exact affine remap). ``auto_tier`` adds what the
        reference builds at load (graph_index.cpp:86-101): the JL 1024
        sign-bit tier for L2 at d > 800, the MIPS 2-bit tier at d > 200."""
        ps = PointSet.from_file(data_path, dtype=dtype, metric=Metric.coerce(metric),
                                device=device)
        idx = Index(points=ps, graph=GraphIndexData.load(graph_path, device=ps.device))
        if quantize_bits and ps.data.dtype in (torch.float32, torch.uint8):
            idx.qpoints = quantize.quantize_pointset(ps, bits=quantize_bits)
        if auto_tier:
            if ps.metric is Metric.L2 and ps.d > 800:
                idx.enable_jl(jl_dims=1024, bits=1)
            elif ps.metric is Metric.MIPS and ps.d > 200:
                idx.enable_mips_2bit()
        return idx

    def save(self, graph_path: str) -> None:
        self.graph.save(graph_path)

    def enable_quantized(self, bits: int = 8, trim: float = 0.0) -> "Index":
        """Build the scalar-quantized search tier of 1 to 16 bits
        (graph_index.cpp:86-101); ``trim`` trims the MIPS scale."""
        self.qpoints = quantize.quantize_pointset(self.points, bits=bits, trim=trim)
        return self

    def enable_mips_2bit(self) -> "Index":
        """The ternary 2-bit MIPS tier (Mips_2Bit_Point, mips_point.h:495-621)."""
        self.t2_points = quantize.mips_2bit_quantize(self.points)
        return self

    def enable_mips_4bit(self, trim: float = 0.0) -> "Index":
        """The packed 4-bit MIPS tier (Mips_4Bit_Point, mips_point.h:706-849)."""
        self.t4_points = quantize.mips_4bit_quantize(self.points, trim=trim)
        return self

    def enable_bit_tier(self) -> "Index":
        """Build the packed 1-bit tier (Euclidean_Bit_Point /
        Mips_Bit_Point, euclidian_point.h:332-420, mips_point.h:625-700):
        beam search runs on hamming distances, the rerank restores
        precision."""
        self.bit_points = quantize.bit_quantize(self.points)
        return self

    def enable_jl(self, jl_dims: int = 64, bits: int = 8, seed: int = 0,
                  sparse_nnz: int = 0) -> "Index":
        """Build a JL search tier (jl_point.h; graph_index.cpp:86-101) over
        quantized random projections; ``bits=1`` is the sign-bit hamming
        variant."""
        self.jl_tier = quantize.JLTier(self.points, jl_dims=jl_dims, bits=bits,
                                       seed=seed, sparse_nnz=sparse_nnz)
        return self

    def build_inline_bits_cache(self, src: PointSet) -> torch.Tensor:
        """Inline words of the 1-bit tier ``src`` (n_pad, R8, W) for kernel
        6, kept for the next search. Keyed on the source tier itself: the
        1-bit and the JL sign-bit tiers have different W, and a cache of
        the other tier would give wrong distances."""
        if self.inline_bits is None or self._inline_bits_src is not src:
            self.inline_bits = None  # free the stale array before the new one
            self.inline_bits = build_inline_bits(src.data, self.graph.neighbors)
            self._inline_bits_src = src
        return self.inline_bits

    def build_inline_cache(self, hbm_budget_bytes: int = 6 << 30) -> Optional[torch.Tensor]:
        """Inline rows (n_pad, R8, d) of the lock-step search's tier (the
        scalar tier if any, else the full-precision points) for kernel 1,
        kept for the next search and keyed on that tier, so enabling a
        scalar tier after an f32 search rebuilds it in the tier's dtype. An
        array of more than ``hbm_budget_bytes`` is not built: ``use_inline``
        turns off and the search gathers rows (JAX index.py:194-213, which
        budgets R rows a vertex; here the R8 rows the array really holds)."""
        if not self.use_inline:
            return None
        src = self.qpoints if self.qpoints is not None else self.points
        if self.inline is None or self._inline_src is not src:
            self.inline = None  # free the stale array before the new one
            R8 = (self.graph.max_degree + 7) // 8 * 8
            if src.n_pad * R8 * src.d * src.data.element_size() > hbm_budget_bytes:
                self.use_inline = False
                return None
            self.inline = build_inline(src.data, self.graph.neighbors)
            self._inline_src = src
        return self.inline

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
        self._entry_tier()

    def _entry_tier(self) -> EntryTier:
        """-> the entry tier as ``entry_top1`` reads it, made once a tier:
        again only when ``entry_vecs`` or ``entry_ids`` is another tensor than
        the one it was made from (``build_entry_cache`` makes it at once; a
        tier that ``interop`` or the HNSW index installs gets its own at the
        next search), never once a batch."""
        src = (self.entry_vecs, self.entry_ids)
        if self._entry_src is None or any(a is not b for a, b in zip(src, self._entry_src)):
            self._entry = entry_tier(self.entry_vecs, self.entry_ids, self.points.metric)
            self._entry_src = src
        return self._entry

    def batch_search(self, queries, k: int = 10, beam_size: int = 128,
                     cut: float = 1.35, limit: Optional[int] = None,
                     degree_limit: Optional[int] = None, expand: int = 1,
                     rerank_factor: int = 10, two_phase: bool = True,
                     expand_group: int = 1, random_starts: int = 0,
                     seed: int = 0, starts=None):
        """Search all query rows -> (ids (B, k), dists (B, k), result): a
        FusedResult on the scalar and f32 tiers, the BeamResult of the
        lock-step search on the 1-bit, JL, 2-bit and 4-bit tiers.

        ``starts``: optional per-query start ids, (B,) or (B, S); they take
        precedence over ``random_starts``, which take precedence over the
        entry tier and ``start_point``. ``random_starts > 0``: every query
        starts from that many uniformly random vertices,
        ``np.random.default_rng(seed).integers(0, n, (B, random_starts))``
        as in the JAX package (beamSearchRandom, beamSearch.h:309-351); a
        graph without a navigable entry, such as pyNNDescent's k-NN graph,
        needs them. The rerank pool is min(k * rerank_factor, beam).

        The JAX package's ``two_phase`` (resume at most B // 4 unconverged
        queries in a second phase) and ``expand_group`` (group expansions
        into one TPU step) schedule work on the TPU: both are accepted and
        every query runs its untruncated search.

        Under the recorder (``utils/trace.py``) the call is a ``search``
        span (host time; counting its ``queries``) over ``search.entry``,
        ``search.translate``, ``search.walk`` (counting the walk's
        ``visits`` and ``cmps``) and ``search.rerank``, which time the
        stream where they are timed."""
        with trace.span("search"):
            qp = QueryParams(k=k, beamSize=beam_size, cut=cut, limit=limit,
                             degree_limit=degree_limit).resolved(
                self.graph.max_degree, self.points.n)
            qf = torch.as_tensor(queries).to(self.device, torch.float32)
            trace.count("queries", qf.shape[0])
            if starts is not None:
                start_arr = torch.as_tensor(starts).to(self.device, torch.int32)
                if start_arr.dim() == 1:
                    start_arr = start_arr[:, None]
            elif random_starts > 0:
                rs = np.random.default_rng(seed).integers(
                    0, self.points.n, (qf.shape[0], random_starts))
                start_arr = torch.from_numpy(rs.astype(np.int32)).to(self.device)
            elif self.use_entry and self.points.n >= self.entry_min_n:
                # never clobber a caller-built tier (index.py:323-331)
                if self.entry_ids is None:
                    self.build_entry_cache()
                tier = self._entry_tier()
                with trace.span("search.entry", self.device):
                    before = entry_top1.launches
                    start_arr = entry_top1(qf.contiguous(), tier)
                    trace.count("launches", entry_top1.launches - before)
            else:
                start_arr = torch.tensor([self.start_point], dtype=torch.int32,
                                         device=self.device)
            L = max(qp.beamSize, k)
            pool = min(max(k * rerank_factor, k), L)
            # the coarse 1-bit and 2-bit tiers have huge tie classes, so the
            # metric cut rule is unusable: they search with k=0 (pure beam) and
            # the rerank restores precision (beamSearch.h:394-454)
            if self.bit_points is not None:
                tier = self.bit_points
                with trace.span("search.translate", self.device):
                    q = quantize.bit_translate_query(qf, tier)
                bits, search_k = 1, 0
            elif self.jl_tier is not None:
                tier = self.jl_tier.points
                with trace.span("search.translate", self.device):
                    q = self.jl_tier.translate_query(qf)
                bits = 1 if self.jl_tier.bits == 1 else 32
                search_k = 0 if bits == 1 else k
            elif self.t2_points is not None:
                tier = self.t2_points
                with trace.span("search.translate", self.device):
                    q = quantize.mips_2bit_translate_query(qf, tier)
                bits, search_k = 2, 0
            elif self.t4_points is not None:
                tier = self.t4_points
                with trace.span("search.translate", self.device):
                    q = quantize.mips_4bit_translate_query(qf, tier)
                bits, search_k = 4, k
            elif (self.qpoints is not None and self.qpoints.data.dtype == torch.int8
                  and self.use_fused and expand == 1
                  and qp.degree_limit >= self.graph.max_degree):
                return self._search_q8(qf, start_arr, qp, k, L, pool)
            else:
                tier = self.qpoints if self.qpoints is not None else self.points
                res = fused_search(
                    qf, tier, self.points.data, self.graph.neighbors,
                    self.graph.degrees, start_arr, self.build_inline_cache(), k=k,
                    L=L, cut=qp.cut, limit=qp.limit, degree_limit=qp.degree_limit,
                    expand=expand, rerank_pool=pool,
                    do_rerank=tier is not self.points)
                return res.ids, res.dists, res
            inline = self.build_inline_bits_cache(tier) if bits == 1 else None
            with trace.span("search.walk", self.device):
                res = beam_search_batch(
                    q, tier.data, self.graph.neighbors, self.graph.degrees, start_arr,
                    None, inline, metric=tier.metric, n_valid=tier.n, k=search_k, L=L,
                    cut=qp.cut, limit=qp.limit, degree_limit=qp.degree_limit,
                    expand=expand, bits=bits)
                trace.count("visits", res.num_visited)
                trace.count("cmps", res.dist_cmps)
            with trace.span("search.rerank", self.device):
                ids, dists = rerank_topk(qf, self.points.data, res.beam_ids, k=k,
                                         pool=pool, metric=self.points.metric)
            return ids, dists, res

    def _search_q8(self, qf, start_arr, qp, k, L, pool):
        """The fused path of a scalar tier stored in int8: kernel 3 walks
        each query, then the rerank."""
        tier = self.qpoints
        with trace.span("search.translate", self.device):
            q_t = quantize.translate_query(qf, tier).float()
        with trace.span("search.walk", self.device):
            fid, _, nv, cmps = beam_search_fused(
                q_t, tier.data, self.graph.neighbors, self.graph.degrees, start_arr,
                metric=tier.metric, n_valid=tier.n, k=k, L=L, cut=qp.cut,
                limit=qp.limit)
            trace.count("visits", nv)
            trace.count("cmps", cmps)
        with trace.span("search.rerank", self.device):
            ids, dists = rerank_topk(qf, self.points.data, fid, k=k, pool=pool,
                                     metric=self.points.metric)
        return ids, dists, FusedResult(
            ids, dists, nv, cmps, torch.zeros((), dtype=torch.int32, device=ids.device))

    def batch_search_timed(self, queries, warmup: bool = True, rounds: int = 1,
                           **kw):
        """Timed steady-state search -> (ids, dists, res, seconds per round):
        queries uploaded first, one warm-up search, then ``rounds``
        back-to-back searches fenced by ``torch.cuda.synchronize``."""
        queries = torch.as_tensor(queries).to(self.device, torch.float32)
        out, secs = timed_rounds(lambda: self.batch_search(queries, **kw),
                                 self.device, rounds, warmup)
        return (*out, secs)

    def batch_search_from_string(self, queries: bytes, k: int = 10,
                                 beam_size: int = 128,
                                 visit_limit: Optional[int] = None, **kw):
        """Search queries given as a big-ann ``.bin`` byte string ([u32 n]
        [u32 d] + rows; graph_index.cpp:236-257) -> numpy (ids (n, k),
        dists (n, k)). A 1-byte payload decodes as int8 when the index
        holds int8 points, else as uint8: an i8bin query read as uint8
        would corrupt every negative component."""
        hdr = np.frombuffer(queries, dtype=np.uint32, count=2)
        n, d = int(hdr[0]), int(hdr[1])
        if d != self.points.d:
            raise ValueError(f"query dim {d} != index dim {self.points.d}")
        itemsize = (len(queries) - 8) // max(n * d, 1)
        if itemsize == 1:
            dt = np.int8 if self.points.data.dtype == torch.int8 else np.uint8
        else:
            dt = np.float32
        q = np.frombuffer(queries, dtype=dt, offset=8, count=n * d).reshape(n, d)
        ids, dists, _ = self.batch_search(q.astype(np.float32), k=k,
                                          beam_size=beam_size, limit=visit_limit,
                                          **kw)
        return ids.cpu().numpy(), dists.cpu().numpy()

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
