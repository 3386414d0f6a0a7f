"""HNSW builder and layered search.

Counterpart of parlayann_tpu/build/hnsw.py (HNSW/HNSW.hpp). Node levels are
drawn up front, ``floor(-ln(U) * m_l)`` (HNSW.hpp:505-518); level 0 holds
every point with degree cap 2m, upper levels cap m. Points insert in
prefix-doubling batches (HNSW.hpp:777-800). A batch descends from the
entrance list through the levels above each row's own level (greedy,
ef = 1) and inserts into each level it belongs to: candidates from an exact
scan of the level's already-inserted members (levels of at most
``FLAT_LEVEL_MAX`` members, kernel 4 with ``valid_mask`` and
``exclude_ids``) or from an efc-beam search (larger levels, with kernel 1
over inline rows for wide batches on the card), forward edges from the
α-occlusion prune (kernel 2; the reference tests ``d(c, r) < alpha *
d(c, q)`` with alpha <= 1, robustPrune ``a * d <= d'``, so a = 1 / alpha),
reverse edges by sort-truncate (HNSW.hpp:940-988). The entrance list holds
the points at the top level (HNSW.hpp:991-1007).

Each level is a compact (members, adjacency, gathered vectors) triple over
LOCAL ids; level 0's local ids are the point ids. The JAX package pads
batch widths and the entrance list to powers of two and masks rows to fix
its compile shapes; here each level runs on the rows that insert into or
descend through it, which gives the same results.

Search folds the hierarchy into the q8 ``Index`` over level 0 when level 1
has at most ``ENTRY_FOLD_MAX`` members: they become the Index's entry tier
(the exact top-1 member is the start), then kernel 3 walks level 0 and the
f32 rerank follows. Otherwise the start comes from ``_descent_all`` (or
``_entry_top1``), and ``expand > 1`` runs the lock-step search on level 0.

Model files: "HTPU" v2 (fixed-width levels) and the reference's "HNSW" v3
(HNSW.hpp:1615-1691 save, :631-744 load), auto-detected on load; both are
byte-equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import struct
import time
from typing import Optional

import numpy as np
import torch

from parlayann_tpu_torch.types import BuildParams, Metric
from parlayann_tpu_torch.data.pointset import PointSet, pad_to
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.index import Index
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels.expand import build_inline
from parlayann_tpu_torch.search.beam import beam_search_batch, top_k_from_beam
from parlayann_tpu_torch.search.flat import flat_search_batch
from parlayann_tpu_torch.build.prune import robust_prune_chunked
from parlayann_tpu_torch.build.reverse import exchange_reverse_edges, scatter_rows
from parlayann_tpu_torch.utils.timing import fence

# levels of at most this many members insert from an exact scan of their
# inserted members instead of an efc-beam (JAX hnsw.py:506)
FLAT_LEVEL_MAX = 8192
# level 1 up to this size becomes the level-0 Index's entry tier
ENTRY_FOLD_MAX = 512 * 1024
# level-0 beam expansions a step in the build (the JAX default of
# PARLAYANN_HNSW_EXPAND)
BUILD_EXPAND = 4
# level-0 batches of at least this many rows read candidates through
# kernel 1 over inline rows on the card (JAX hnsw.py:762-763)
INLINE_MIN_ROWS = 4096


@dataclasses.dataclass
class Level:
    members: np.ndarray  # (ml,) global ids, ascending
    points_l: torch.Tensor  # (ml_pad, d) gathered vectors
    nbrs: torch.Tensor  # (ml_pad, cap) LOCAL ids
    degs: torch.Tensor  # (ml_pad,)
    cap: int
    members_d: torch.Tensor  # (ml_pad,) global ids (pad rows: member 0)
    glob2loc_d: torch.Tensor  # (n,) int32 local ids, -1 if absent


def _make_level(points: PointSet, members: np.ndarray, cap: int,
                nbrs=None, degs=None) -> Level:
    n, ml = points.n, len(members)
    ml_pad = pad_to(max(ml, 1), 8)
    dev = points.device
    glob2loc = np.full(n, -1, dtype=np.int32)
    glob2loc[members] = np.arange(ml, dtype=np.int32)
    members_d = torch.from_numpy(np.pad(members, (0, ml_pad - ml)).astype(np.int32)).to(dev)
    if nbrs is None:
        nbrs_t = torch.zeros((ml_pad, cap), dtype=torch.int32, device=dev)
        degs_t = torch.zeros((ml_pad,), dtype=torch.int32, device=dev)
    else:
        nbrs_t = torch.from_numpy(
            np.pad(nbrs, ((0, ml_pad - ml), (0, 0))).astype(np.int32)).to(dev)
        degs_t = torch.from_numpy(np.pad(degs, (0, ml_pad - ml)).astype(np.int32)).to(dev)
    return Level(members=members, points_l=points.data[members_d.long()], nbrs=nbrs_t,
                 degs=degs_t, cap=cap, members_d=members_d,
                 glob2loc_d=torch.from_numpy(glob2loc).to(dev))


def assign_levels(n: int, m_l: float, rng: np.random.Generator) -> np.ndarray:
    """Geometric level per point (get_level_random, HNSW.hpp:505-518)."""
    u = rng.random(n)
    lev = np.floor(-np.log(np.maximum(u, 1e-12)) * m_l).astype(np.int32)
    return np.minimum(lev, 24)


def insert_plan(n: int, m_l: float, seed: int):
    """The build's two draws from ``default_rng(seed)``: every point's
    level, then the insert order -> ((n,) levels, (n,) int32 order)."""
    rng = np.random.default_rng(seed)
    levels_of = assign_levels(n, m_l, rng)
    return levels_of, rng.permutation(n).astype(np.int32)


def _entry_top1(q: torch.Tensor, pts_l: torch.Tensor, members_d: torch.Tensor, *,
                metric: Metric, nv: int, chunk: int = 8192) -> torch.Tensor:
    """The exact nearest of a level's first ``nv`` members per query ->
    (B,) global ids: one f32 matmul and an argmin a chunk of members, the
    first chunk winning a tie (JAX hnsw.py:415-456)."""
    qf = q.float()
    best_d = torch.full((qf.shape[0],), INF, device=qf.device)
    best_i = torch.zeros((qf.shape[0],), dtype=torch.int64, device=qf.device)
    for off in range(0, pts_l.shape[0], chunk):
        blk = pts_l[off:off + chunk].float()
        dot = qf @ blk.T
        dist = -dot if metric is Metric.MIPS else (blk * blk).sum(1)[None, :] - 2.0 * dot
        lid = off + torch.arange(blk.shape[0], device=qf.device)
        dist = torch.where((lid < nv)[None, :], dist, INF)
        ci = dist.argmin(dim=1)
        cd = dist.gather(1, ci[:, None])[:, 0]
        upd = cd < best_d
        best_d = torch.where(upd, cd, best_d)
        best_i = torch.where(upd, off + ci, best_i)
    return members_d[best_i.clamp(max=members_d.shape[0] - 1)]


def _descend(lv: Level, q: torch.Tensor, entry: torch.Tensor,
             metric: Metric) -> torch.Tensor:
    """One greedy ef = 1 step through a level (HNSW.hpp:1532-1567) from
    the (B, S) global entry ids (-1 = none) -> (B,) global exits, the
    first entry where the level gives none."""
    starts = torch.where(entry >= 0, lv.glob2loc_d[entry.clamp(min=0).long()], -1)
    res = beam_search_batch(q, lv.points_l, lv.nbrs, lv.degs, starts,
                            metric=metric, n_valid=len(lv.members), k=0, L=1)
    loc = res.beam_ids[:, 0]
    return torch.where(loc >= 0, lv.members_d[loc.clamp(min=0).long()], entry[:, 0])


def _descent_all(q: torch.Tensor, levels, entry: torch.Tensor,
                 metric: Metric) -> torch.Tensor:
    """Greedy descent through ``levels`` (top first, down to level 1) from
    the (B, S) entry ids -> (B,) global level-1 exits (JAX
    hnsw.py:459-476)."""
    for lv in levels:
        entry = _descend(lv, q, entry, metric)[:, None]
    return entry[:, 0]


def _insert_at_level(lv: Level, points_data, batch_glob, entry_glob, alpha,
                     inline, vmask, *, efc: int, m_fwd: int, metric: Metric,
                     expand: int = 1) -> torch.Tensor:
    """Insert the rows ``batch_glob`` (all members of this level) into it:
    candidates, forward prune, row write, reverse edges (HNSW.hpp:869-1014).
    Updates ``lv.nbrs``/``lv.degs`` in place -> (B,) global ids of each
    row's closest candidate (its entry to the next level down; the first
    entry if it found none)."""
    n_valid, cap = len(lv.members), lv.cap
    loc = lv.glob2loc_d[batch_glob.long()]
    q = points_data[batch_glob.long()]
    if n_valid <= FLAT_LEVEL_MAX:
        # the exact top-efc over the level's inserted members (``vmask``):
        # an exact hit on a member not wired yet would pass a dead vertex
        # down as the next level's entry (the JAX package measured recall
        # .88 -> .16 at 12K without the mask, hnsw.py:515-519)
        kf = min(efc, n_valid)
        beam_ids, beam_dists = flat_search_batch(
            q.float(), lv.points_l, vmask, exclude_ids=loc, k=kf, metric=metric,
            n_valid=n_valid, select="pallas")
        if kf < efc:  # the efc candidate width the prune expects
            beam_ids = torch.nn.functional.pad(beam_ids, (0, efc - kf), value=-1)
            beam_dists = torch.nn.functional.pad(beam_dists, (0, efc - kf), value=INF)
    else:
        # kernel 1 takes f32 queries; the JAX package measured recall .27
        # from uncast int8 queries on its inline path (hnsw.py:538-541)
        starts = torch.where(entry_glob >= 0,
                             lv.glob2loc_d[entry_glob.clamp(min=0).long()], -1)
        res = beam_search_batch(
            q.float() if inline is not None else q, lv.points_l, lv.nbrs,
            lv.degs, starts, loc, inline, metric=metric, n_valid=n_valid, k=0,
            L=efc, exclude_self=True, expand=expand)
        beam_ids, beam_dists = res.beam_ids, res.beam_dists
    # forward edges: the α-prune of the efc candidates (select_neighbors)
    pr = robust_prune_chunked(loc, beam_ids,
                              torch.where(beam_ids >= 0, beam_dists, INF),
                              lv.points_l, alpha, R=m_fwd, metric=metric,
                              n_valid=n_valid)
    sel = torch.nn.functional.pad(pr.ids, (0, cap - m_fwd), value=-1)
    seld = torch.nn.functional.pad(pr.dists, (0, cap - m_fwd), value=INF)
    scatter_rows(lv.nbrs, lv.degs, loc, sel, pr.degree)
    # reverse edges: an overflowing row keeps its cap closest (sort-truncate)
    exchange_reverse_edges(lv.nbrs, lv.degs, loc, sel, seld, lv.points_l,
                           R=cap, metric=metric, n_valid=n_valid)
    closest = beam_ids[:, 0]
    return torch.where(closest >= 0, lv.members_d[closest.clamp(min=0).long()],
                       entry_glob[:, 0])


@dataclasses.dataclass
class HNSWIndex:
    points: PointSet
    levels: list  # Level, index = level number (0 = base)
    entrances: np.ndarray  # (S,) int32 global ids, all at max_level
    m: int
    efc: int
    alpha: float
    m_l: float
    _bidx: Optional[Index] = None  # the q8 Index over level 0, built lazily

    @property
    def max_level(self) -> int:
        return len(self.levels) - 1

    @property
    def entrance(self) -> int:
        return int(self.entrances[0])

    @property
    def device(self) -> torch.device:
        return self.points.device

    # ---------------- search (HNSW.hpp:1570-1613) ----------------
    def _entry_foldable(self) -> bool:
        return self.max_level > 0 and len(self.levels[1].members) <= ENTRY_FOLD_MAX

    def _base_index(self) -> Index:
        """The q8 Index over level 0; when level 1 is foldable its members
        are the Index's entry tier, so the search's start is the exact
        nearest level-1 member, a better start than the greedy upper-level
        walk (HNSW.hpp:1532-1567)."""
        if self._bidx is None:
            idx = Index(points=self.points, graph=self.base_graph())
            idx.enable_quantized(bits=8)
            if self._entry_foldable():
                idx.entry_ids = self.levels[1].members_d[:len(self.levels[1].members)]
                idx.entry_vecs = self.points.data[idx.entry_ids.long()]
                idx.entry_min_n = 0
            self._bidx = idx
        return self._bidx

    def batch_search(self, queries, k: int = 10, ef: int = 64,
                     cut: float = 1.35, expand: int = 1):
        """-> (ids (B, k), dists (B, k)). ``expand == 1``: the q8 Index
        over level 0 (kernel 3, then the f32 rerank); ``expand > 1``: the
        lock-step search on the full-precision level 0."""
        q = torch.as_tensor(queries).to(self.device, torch.float32)
        L = max(ef, k)
        if expand == 1 and self._entry_foldable():
            ids, dists, _ = self._base_index().batch_search(q, k=k, beam_size=L, cut=cut)
            return ids, dists
        B = q.shape[0]
        ent = torch.from_numpy(self.entrances.astype(np.int32)).to(self.device)
        if self.max_level == 0:
            entry = ent[:1].expand(B)
        elif self._entry_foldable():
            lv1 = self.levels[1]
            entry = _entry_top1(q, lv1.points_l, lv1.members_d,
                                metric=self.points.metric, nv=len(lv1.members))
        else:
            entry = _descent_all(q, self.levels[:0:-1], ent[None, :].expand(B, -1),
                                 self.points.metric)
        if expand == 1:
            ids, dists, _ = self._base_index().batch_search(
                q, k=k, beam_size=L, cut=cut, starts=entry)
            return ids, dists
        lv0 = self.levels[0]
        res = beam_search_batch(q, lv0.points_l, lv0.nbrs, lv0.degs, entry[:, None],
                                metric=self.points.metric, n_valid=self.points.n,
                                k=k, L=L, cut=cut, expand=expand)
        return top_k_from_beam(res, k)

    def batch_search_timed(self, queries, k: int = 10, ef: int = 64,
                           cut: float = 1.35, warmup: bool = True,
                           rounds: int = 1):
        """Timed steady-state search through the q8 Index over level 0 ->
        (ids, dists, result, seconds per round) (Index.batch_search_timed).
        Needs a foldable level 1, where the whole search is that Index's."""
        if not self._entry_foldable():
            raise ValueError("timed path requires a foldable level-1 entry")
        return self._base_index().batch_search_timed(
            queries, warmup=warmup, rounds=rounds, k=k, beam_size=max(ef, k), cut=cut)

    def base_graph(self) -> GraphIndexData:
        """Level 0 as a GraphIndexData (its local ids are point ids)."""
        lv0 = self.levels[0]
        return GraphIndexData(neighbors=lv0.nbrs, degrees=lv0.degs,
                              n=self.points.n, max_degree=lv0.cap)

    # ---------------- persistence ----------------
    def level_of(self) -> np.ndarray:
        """(n,) top level of every point."""
        out = np.zeros(self.points.n, dtype=np.int32)
        for lv_no in range(1, len(self.levels)):
            out[self.levels[lv_no].members] = lv_no
        return out

    def _rows(self, lv: Level):
        ml = len(lv.members)
        return lv.nbrs[:ml].cpu().numpy(), lv.degs[:ml].cpu().numpy()

    def save(self, path: str) -> None:
        """The fixed-width "HTPU" v2 file (entrance list)."""
        with open(path, "wb") as f:
            f.write(b"HTPU")
            f.write(struct.pack("<iiiff", 2, self.points.n, self.m, self.alpha,
                                self.m_l))
            f.write(struct.pack("<iii", self.efc, len(self.levels),
                                len(self.entrances)))
            self.entrances.astype(np.int32).tofile(f)
            for lv in self.levels:
                nb, dg = self._rows(lv)
                f.write(struct.pack("<iii", len(lv.members), lv.cap, 0))
                lv.members.astype(np.int32).tofile(f)
                dg.astype(np.int32).tofile(f)
                nb.astype(np.int32).tofile(f)

    @staticmethod
    def load(path: str, points: PointSet) -> "HNSWIndex":
        """Read an "HTPU" (v1 or v2) or a reference "HNSW" v3 file (told
        apart by the magic) over ``points``, on their device."""
        with open(path, "rb") as f:
            magic = f.read(4)
            if magic == b"HNSW":
                return HNSWIndex.load_v3(path, points)
            if magic != b"HTPU":
                raise ValueError(f"{path}: not an HNSW model file")
            ver = struct.unpack("<i", f.read(4))[0]
            if ver == 1:
                n, m, alpha, m_l, ent0 = struct.unpack("<iiffi", f.read(20))
                efc, n_levels = struct.unpack("<ii", f.read(8))
                entrances = np.asarray([ent0], dtype=np.int32)
            else:
                n, m, alpha, m_l = struct.unpack("<iiff", f.read(16))
                efc, n_levels, n_ent = struct.unpack("<iii", f.read(12))
                entrances = np.fromfile(f, np.int32, n_ent)
            levels = []
            for _ in range(n_levels):
                ml, cap, _ = struct.unpack("<iii", f.read(12))
                members = np.fromfile(f, np.int32, ml)
                dg = np.fromfile(f, np.int32, ml)
                nb = np.fromfile(f, np.int32, ml * cap).reshape(ml, cap)
                levels.append(_make_level(points, members, cap, nbrs=nb, degs=dg))
        return HNSWIndex(points=points, levels=levels, entrances=entrances,
                         m=m, efc=efc, alpha=alpha, m_l=m_l)

    def save_v3(self, path: str) -> None:
        """The reference's "HNSW" v3 file (HNSW.hpp:1615-1691): node ids
        are point ids (the (level, id) table carries the mapping), each
        node's records hold its neighbours' point ids level by level."""
        n = self.points.n
        lev = self.level_of()
        degs_l, glob_l = [], []
        for lv in self.levels:
            nb, dg = self._rows(lv)
            degs_l.append(dg.astype(np.int64))
            glob_l.append(lv.members[np.clip(nb, 0, len(lv.members) - 1)].astype(np.uint32))
        # per-node record block: for each level 0..lev[u], u64 count + u32 ids
        node_len = np.zeros(n, dtype=np.int64)
        for lv_no, lv in enumerate(self.levels):
            node_len[lv.members] += 8 + 4 * degs_l[lv_no]
        node_off = np.concatenate([[0], np.cumsum(node_len)])
        buf = np.zeros(int(node_off[-1]), dtype=np.uint8)
        within = np.zeros(n, dtype=np.int64)  # offset of the level's record
        for lv_no, lv in enumerate(self.levels):
            mem, d = lv.members, degs_l[lv_no]
            start = node_off[mem] + within[mem]
            szb = d.astype("<u8").view(np.uint8).reshape(-1, 8)
            buf[(start[:, None] + np.arange(8)).ravel()] = szb.ravel()
            rows = np.repeat(np.arange(len(mem)), d)
            cols = (np.concatenate([np.arange(x) for x in d]) if len(d)
                    else np.zeros(0, np.int64))
            ids = glob_l[lv_no][rows, cols].astype("<u4")
            tgt = np.repeat(start + 8, d) + 4 * cols
            buf[(tgt[:, None] + np.arange(4)).ravel()] = (
                ids.view(np.uint8).reshape(-1, 4).ravel())
            within[mem] += 8 + 4 * d
        with open(path, "wb") as f:
            f.write(b"HNSW")
            f.write(struct.pack("<I", 3))
            # code_U and sizeof(node): the reference's loader reads and
            # ignores both (HNSW.hpp:684-688)
            f.write(struct.pack("<QQ", 0, 0))
            f.write(struct.pack("<IfIIfI", self.points.d, self.m_l, self.m,
                                self.efc, self.alpha, n))
            table = np.empty((n, 2), dtype="<u4")
            table[:, 0] = lev.astype(np.uint32)
            table[:, 1] = np.arange(n, dtype=np.uint32)
            table.tofile(f)
            buf.tofile(f)
            f.write(struct.pack("<Q", len(self.entrances)))
            self.entrances.astype("<u4").tofile(f)

    @staticmethod
    def load_v3(path: str, points: PointSet) -> "HNSWIndex":
        """Read a reference "HNSW" v3 file (HNSW.hpp:631-744), also one the
        reference wrote: any node order, neighbour lists in node ids."""
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:4] != b"HNSW":
            raise ValueError(f"{path}: not an HNSW v3 model file")
        (version,) = struct.unpack_from("<I", raw, 4)
        if version != 3:
            raise ValueError(f"unsupported HNSW model version {version}")
        off = 8 + 16  # past code_U and sizeof(node)
        dim, m_l, m, efc, alpha, n = struct.unpack_from("<IfIIfI", raw, off)
        off += 24
        table = np.frombuffer(raw, dtype="<u4", count=2 * n, offset=off)
        off += 8 * n
        node_lev = table[0::2].astype(np.int32)
        node_pid = table[1::2].astype(np.int32)  # node id -> point id
        max_level = int(node_lev.max()) if n else 0
        recs = [[] for _ in range(max_level + 1)]  # per level: (node, ids)
        for u in range(n):
            for lv_no in range(int(node_lev[u]) + 1):
                (cnt,) = struct.unpack_from("<Q", raw, off)
                off += 8
                recs[lv_no].append((u, np.frombuffer(raw, dtype="<u4", count=cnt,
                                                     offset=off)))
                off += 4 * int(cnt)
        (n_ent,) = struct.unpack_from("<Q", raw, off)
        ent_nodes = np.frombuffer(raw, dtype="<u4", count=n_ent, offset=off + 8)
        entrances = node_pid[ent_nodes.astype(np.int64)].astype(np.int32)
        levels = []
        for lv_no in range(max_level + 1):
            members = np.sort(node_pid[node_lev >= lv_no]).astype(np.int32)
            g2l = np.full(points.n, -1, dtype=np.int32)
            g2l[members] = np.arange(len(members), dtype=np.int32)
            cap = max(2 * m if lv_no == 0 else m,
                      max((len(i) for _, i in recs[lv_no]), default=0))
            nb = np.full((len(members), cap), -1, dtype=np.int32)
            dg = np.zeros(len(members), dtype=np.int32)
            for u, ids in recs[lv_no]:
                loc = g2l[node_pid[u]]
                nb[loc, :len(ids)] = g2l[node_pid[ids.astype(np.int64)]]
                dg[loc] = len(ids)
            levels.append(_make_level(points, members, cap, nbrs=nb, degs=dg))
        return HNSWIndex(points=points, levels=levels, entrances=entrances,
                         m=int(m), efc=int(efc), alpha=float(alpha), m_l=float(m_l))


def build_hnsw_graph(points: PointSet, bp: BuildParams, verbose: bool = False,
                     quantize_build: bool = False):
    """Build an HNSW index over ``points``, on their device (ctor + insert,
    HNSW.hpp:748-1014) -> (HNSWIndex, seconds, fenced). ``bp.R`` is m,
    ``bp.L`` efc. ``quantize_build`` runs every build distance on the q8
    tier (float32 and uint8 points); the index's levels then hold the
    full-precision vectors again, so search changes only through the
    graph. Without it, uint8 points build on an exact float32 copy (kernel
    2's f32 mode) and the levels hold them as uint8."""
    n = points.n
    m = bp.R if bp.R > 0 else 20
    efc = bp.L if bp.L > 0 else 50
    alpha = bp.alpha if bp.alpha > 0 else 0.9
    m_l = bp.m_l if bp.m_l > 0 else 0.34
    a_prune = float(np.float32(1.0 / alpha))
    dev = points.device
    t0 = time.perf_counter()

    build_ps = quantize.build_tier(points, quantize_build)

    levels_of, order = insert_plan(n, m_l, bp.seed)
    levels = [_make_level(build_ps, np.flatnonzero(levels_of >= lv_no).astype(np.int32),
                          2 * m if lv_no == 0 else m)
              for lv_no in range(int(levels_of.max()) + 1)]
    entrances = [int(order[0])]  # the entrance list (HNSW.hpp:130)
    ent_level = int(levels_of[entrances[0]])
    # the exact scans see only members inserted by earlier batches
    ins_flag = np.zeros(n, dtype=bool)

    max_batch = min(max(int(bp.batch_cap_frac * n), 1), 1_000_000)
    bounds, lo, size = [], 0, 1  # prefix doubling (HNSW.hpp:777-800)
    while lo < n:
        bounds.append((lo, min(lo + size, n)))
        lo, size = min(lo + size, n), min(size * 2, max_batch)

    for bi, (lo, hi) in enumerate(bounds):
        batch, blev = order[lo:hi], levels_of[order[lo:hi]]
        bg = torch.from_numpy(batch).to(dev)
        # every row starts from the whole entrance list (HNSW.hpp:869-881);
        # a level it touches leaves it one entry, repeated across the columns
        entry = torch.tensor(entrances, dtype=torch.int32, device=dev)[None, :].repeat(
            len(batch), 1)
        # from the batch's own top level: a row above the entrances inserts
        # on all its levels (HNSW.hpp:991-1007)
        for lv_no in range(max(ent_level, int(blev.max())), -1, -1):
            lv = levels[lv_no]
            ins = np.flatnonzero(blev >= lv_no)
            desc = np.flatnonzero(blev < lv_no) if 0 < lv_no <= ent_level else ins[:0]
            if len(desc):
                r = torch.from_numpy(desc).to(dev)
                entry[r] = _descend(lv, build_ps.data[bg[r].long()], entry[r],
                                    points.metric)[:, None]
            if not len(ins):
                continue
            r = torch.from_numpy(ins).to(dev)
            vmask = inline = None
            expand = 1
            if len(lv.members) <= FLAT_LEVEL_MAX:
                vm = np.zeros(lv.points_l.shape[0], dtype=bool)
                vm[:len(lv.members)] = ins_flag[lv.members]
                vmask = torch.from_numpy(vm).to(dev)
            elif lv_no == 0:
                expand = BUILD_EXPAND
                if dev.type == "cuda" and len(ins) >= INLINE_MIN_ROWS:
                    inline = build_inline(lv.points_l, lv.nbrs)
            entry[r] = _insert_at_level(
                lv, build_ps.data, bg[r], entry[r], a_prune, inline, vmask,
                efc=efc, m_fwd=m, metric=points.metric, expand=expand)[:, None]
            del inline
        # entrance update (HNSW.hpp:991-1007): replace on a strictly higher
        # level, append the batch's highest node on a tie
        top, highest = int(blev.max()), int(batch[int(np.argmax(blev))])
        if top > ent_level:
            entrances, ent_level = [highest], top
        elif top == ent_level and highest not in entrances:
            entrances.append(highest)
        ins_flag[batch] = True
        if verbose and bi % 8 == 0:
            print(f"hnsw: batch {bi + 1}/{len(bounds)}", flush=True)

    if build_ps is not points:
        # search levels hold the full-precision vectors
        for lv in levels:
            lv.points_l = points.data[lv.members_d.long()]
    fence(dev)
    idx = HNSWIndex(points=points, levels=levels,
                    entrances=np.asarray(entrances, dtype=np.int32),
                    m=m, efc=efc, alpha=alpha, m_l=m_l)
    return idx, time.perf_counter() - t0


def build_hnsw_index(data, metric: Metric = Metric.L2, m: int = 20, efc: int = 50,
                     alpha: float = 0.9, m_l: Optional[float] = None,
                     verbose: bool = False, seed: int = 0,
                     quantize_build: bool = False, batch_cap_frac: float = 0.02,
                     device=None):
    """Convenience wrapper (python/builder.cpp:202-237; defaults from
    docs/algorithms.md:77-81) -> (HNSWIndex, full-precision PointSet,
    build seconds). ``data`` is an array, placed on ``device`` (None: the
    card), or a PointSet (which keeps its own device); ``batch_cap_frac``
    caps the insert batches at that fraction of n."""
    metric = Metric.coerce(metric)
    ps = data if isinstance(data, PointSet) else PointSet.from_numpy(
        np.asarray(data), metric=metric, device=device)
    bp = BuildParams(R=m, L=efc, alpha=alpha, m_l=m_l if m_l is not None else 0.34,
                     seed=seed, batch_cap_frac=batch_cap_frac)
    idx, dt = build_hnsw_graph(ps, bp, verbose=verbose, quantize_build=quantize_build)
    return idx, ps, dt
