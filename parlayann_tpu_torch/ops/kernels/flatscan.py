"""Kernel 4: exact brute-force top-k (flat search).

Counterpart of parlayann_tpu/ops/pallas/flatscan.py (``flat_topk_pallas``
:121). The Pallas kernel approximates the exact top-k through a per-lane-
class pool (recall ~0.999); its own docstring names ``select="sort"`` as
the oracle. The port's kernel (``csrc/flatscan.cu``) returns that oracle's
answer: the exact k smallest, ordered by (distance, id). The distance
algebra is the JAX package's: selection runs on ``||x||^2 - 2 q.x`` (L2)
or ``-q.x`` (MIPS), and ``||q||^2`` is added back to the k survivors and
clamped at 0, so L2 distances are true squared distances.

The kernel computes its distance tiles on the tensor cores in 3xTF32
(each f32 operand split into two TF32 parts, three products summed), which
is float32-accurate: each product misses at most about 3 * 2^-22 of
|q_i x_i|. ``precision`` is accepted for the JAX signature: "exact" and
"fast" both compute that f32-accurate product (the TPU's "fast" is bf16
MXU passes; a single-pass TF32 or bf16 "fast" is ROADMAP queue 2,
"B2. flat_topk").

The grid also splits the points: S CTAs scan S contiguous ranges of one
block of queries, each keeping its own sorted lists. The splits of a row
share the best k-th entry any of them has reached through a (B,) scratch,
so each filters its candidates against it. Without a mask the ranges cut
the ids (:func:`split_plan` picks S) and :func:`merge_split_topk` merges
the lists. With ``valid_mask`` the kernel first compacts the valid ids on
the card (ascending, with their bias and their count, which the host never
reads), the ranges cut that compacted order (:func:`masked_plan` picks S
and the fewest tiles a split, the card sizes the splits from the count as
:func:`split_ranges` does), and a merge kernel merges the lists of the
splits that hold points.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels import _lib

# the kernel keeps 64 sorted (distance, id) lists of k entries in shared
# memory: 8 bytes * 64 * k, 128 KB at k = 256
MAX_K = 256
PRECISIONS = ("fast", "exact")
QUERY_TILE = 64   # queries per CTA (csrc/flatscan.cu kBT)
POINT_TILE = 128  # points per tile (kCT); a split is a multiple of it
WAVES = 4         # CTAs the splits aim for, in waves over the card
MIN_SPLIT = 4096  # points; no split of the unmasked mode is cut smaller
SPLIT_PER_ENTRY = 4  # a masked split scans at least this many points per list entry


def _bias(points: torch.Tensor, valid_mask: Optional[torch.Tensor],
          n_valid: int, metric: Metric) -> torch.Tensor:
    """(n_pad,) f32: ||x||^2 (L2) or 0 (MIPS), INF where x is not a valid
    point (id >= n_valid, or masked out)."""
    n_pad = points.shape[0]
    if metric is Metric.MIPS:
        bias = torch.zeros(n_pad, dtype=torch.float32, device=points.device)
    else:
        xf = points.float()
        bias = (xf * xf).sum(dim=1)
    ok = torch.arange(n_pad, device=points.device) < n_valid
    if valid_mask is not None:
        ok &= valid_mask.to(torch.bool)
    return torch.where(ok, bias, INF)


def _finish(sel_d: torch.Tensor, sel_i: torch.Tensor, qf: torch.Tensor,
            metric: Metric):
    """Selection-domain (B, k) results -> (ids with -1 where empty, true
    distances: ||q||^2 added back and clamped at 0 for L2)."""
    ok = sel_d < INF
    ids = torch.where(ok, sel_i, -1).to(torch.int32)
    if metric is Metric.MIPS:
        return ids, sel_d
    qn = (qf * qf).sum(dim=1, keepdim=True)
    return ids, torch.where(ok, torch.clamp(sel_d + qn, min=0.0), INF)


def _check_args(k: int, precision: str):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def split_floor(k: int) -> int:
    """The fewest points a masked split scans: ``SPLIT_PER_ENTRY`` per entry of
    the k-entry lists it writes (so the lists the merge reads stay a
    quarter of the points scanned), at least one tile."""
    return max(POINT_TILE, SPLIT_PER_ENTRY * k)


def split_plan(B: int, n_pad: int, slots: int, floor: int = MIN_SPLIT):
    """-> (S, points per split): enough splits of the point range for about
    ``WAVES`` waves of CTAs over ``slots`` (CTAs resident on the card at
    once), none smaller than ``floor`` points; splits are whole tiles, and
    S = 1 when one split covers every point."""
    rows = -(-B // QUERY_TILE)
    want = -(-WAVES * slots // max(rows, 1))
    S = max(1, min(want, n_pad // floor))
    per = max(POINT_TILE, -(-n_pad // (S * POINT_TILE)) * POINT_TILE)
    return max(1, -(-n_pad // per)), per


def masked_plan(B: int, n_valid: int, slots: int, k: int):
    """Masked mode -> (S, fewest tiles a split): the host does not know how
    many points the mask keeps, so S aims at ``WAVES`` waves as
    :func:`split_plan` does over ``n_valid`` (the most the mask can keep),
    with :func:`split_floor` in place of ``MIN_SPLIT`` so that a few
    thousand points fill the card, and the card sizes the splits from the
    count (:func:`split_ranges`); splits past the count exit at once."""
    S, _ = split_plan(B, n_valid, slots, split_floor(k))
    return S, -(-split_floor(k) // POINT_TILE)


def split_ranges(count: int, S: int, min_tiles: int):
    """The masked mode's splits of ``count`` compacted points, as the card
    cuts them (csrc/flatscan.cu ``masked_split_tiles``): each split takes
    max(min_tiles, ceil(tiles / S)) tiles in order -> [(lo, hi)] positions
    of the splits that hold points."""
    tiles = -(-count // POINT_TILE)
    span = max(min_tiles, -(-tiles // S)) * POINT_TILE
    return [(lo, min(lo + span, count)) for lo in range(0, count, span)]


def merge_split_topk(dists: torch.Tensor, ids: torch.Tensor, k: int):
    """(B, S, k) sorted (distance, id) lists of S contiguous id ranges, the
    range of list s below that of s + 1 -> the (B, k) lists of their union.
    One stable sort by distance over the concatenation keeps equal
    distances in list order and, within a list, in id order: (distance, id)
    order. Empty slots (INF) sort last."""
    B = dists.shape[0]
    d, order = torch.sort(dists.reshape(B, -1), dim=1, stable=True)
    return d[:, :k], torch.gather(ids.reshape(B, -1), 1, order[:, :k])


def smallest_by_key(d: torch.Tensor, k: int):
    """The k smallest of each row of ``d`` in (distance, position) order ->
    (dists (B, k), positions (B, k) int64): the first k of a stable sort,
    through one ``torch.topk`` over int64 keys that hold the distance's
    order-preserving bits above the position (a selection, where the sort
    orders every entry). -0.0 counts as +0.0, as in the float order."""
    b = (d + 0.0).view(torch.int32).long()
    key = ((b ^ ((b >> 31) & 0x7FFFFFFF)) << 32) | torch.arange(
        d.shape[1], device=d.device)
    pos = torch.topk(key, k, dim=1, largest=False, sorted=True).values & 0xFFFFFFFF
    return d.gather(1, pos), pos


def flat_topk_plain(queries: torch.Tensor, points: torch.Tensor,
                    valid_mask: Optional[torch.Tensor] = None,
                    exclude_ids: Optional[torch.Tensor] = None, *, k: int,
                    metric: Metric, n_valid: int, precision: str = "fast",
                    chunk: int = 32768):
    """The kernel's function in PyTorch: one float32 matmul per chunk of
    points, then an exact selection (:func:`smallest_by_key`) and a stable
    merge with the earlier chunks' survivors. Ties go by id: ids grow along each chunk, and every
    earlier chunk's survivors precede the current one's."""
    _check_args(k, precision)
    qf = queries.float()
    B = qf.shape[0]
    n_pad = points.shape[0]
    bias = _bias(points, valid_mask, n_valid, metric)
    scale = -1.0 if metric is Metric.MIPS else -2.0
    excl = None if exclude_ids is None else exclude_ids.long()[:, None]
    run_d = torch.full((B, 0), INF, dtype=torch.float32, device=qf.device)
    run_i = torch.full((B, 0), -1, dtype=torch.int64, device=qf.device)
    for lo in range(0, n_pad, chunk):
        hi = min(lo + chunk, n_pad)
        dot = qf @ points[lo:hi].float().T
        d = bias[None, lo:hi] + scale * dot
        ids = torch.arange(lo, hi, device=qf.device)[None, :].expand(B, -1)
        ok = bias[None, lo:hi] < INF
        if excl is not None:
            ok = ok & (ids != excl)
        d = torch.where(ok, d, INF)
        if k == 1:  # argmin keeps the first (lowest-id) minimum
            cd, pos = d.min(dim=1, keepdim=True)
        else:
            cd, pos = smallest_by_key(d, min(k, d.shape[1]))
        md = torch.cat([run_d, cd], dim=1)
        mi = torch.cat([run_i, pos + lo], dim=1)
        md, order = torch.sort(md, dim=1, stable=True)
        run_d, run_i = md[:, :k], torch.gather(mi, 1, order[:, :k])
    if run_d.shape[1] < k:  # fewer points than k
        pad = k - run_d.shape[1]
        run_d = torch.cat([run_d, run_d.new_full((B, pad), INF)], dim=1)
        run_i = torch.cat([run_i, run_i.new_full((B, pad), -1)], dim=1)
    return _finish(run_d, run_i, qf, metric)


def flat_topk(queries: torch.Tensor, points: torch.Tensor,
              valid_mask: Optional[torch.Tensor] = None,
              exclude_ids: Optional[torch.Tensor] = None, *, k: int,
              metric: Metric, n_valid: int, precision: str = "fast"):
    """Exact top-k of each query row over ``points`` -> (ids (B, k) int32,
    -1 where fewer than k valid points; dists (B, k) f32, true squared L2
    or -dot, INF where empty), ordered by (distance, id).

    ``queries`` (B, d) f32; ``points`` (n_pad, d) f32 or int8 (rows >=
    ``n_valid`` never match); ``valid_mask`` (n_pad,) bool; ``exclude_ids``
    (B,) int32, one id per query that must not match. CPU tensors run
    :func:`flat_topk_plain`; CUDA tensors launch the kernel, for k up to
    ``MAX_K``."""
    extra = [t for t in (valid_mask, exclude_ids) if t is not None]
    if not _lib.route(queries, points, *extra):
        return flat_topk_plain(queries, points, valid_mask, exclude_ids, k=k,
                               metric=metric, n_valid=n_valid,
                               precision=precision)
    _check_args(k, precision)
    if k > MAX_K:
        raise ValueError(f"k={k} exceeds the kernel's {MAX_K}")
    _lib.require(queries, "queries", torch.float32, 2)
    if points.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"points must be float32 or int8 (got {points.dtype})")
    _lib.require(points, "points", points.dtype, 2)
    B, d = queries.shape
    n_pad = points.shape[0]
    if points.shape[1] != d:
        raise ValueError(f"queries {tuple(queries.shape)} vs points "
                         f"{tuple(points.shape)}")
    if not 0 <= n_valid <= n_pad < 2**31 - 1:
        raise ValueError(f"n_valid={n_valid}, n_pad={n_pad} out of range")
    if valid_mask is not None and valid_mask.shape != (n_pad,):
        raise ValueError(f"valid_mask {tuple(valid_mask.shape)} for {n_pad} points")
    if exclude_ids is not None:
        if exclude_ids.shape != (B,):
            raise ValueError(f"exclude_ids {tuple(exclude_ids.shape)} for {B} queries")
        exclude_ids = exclude_ids.to(torch.int32).contiguous()
    if B == 0:
        return (torch.empty((0, k), dtype=torch.int32, device=queries.device),
                torch.empty((0, k), dtype=torch.float32, device=queries.device))
    if valid_mask is not None:
        sel_d, sel_i = _launch_masked(queries, points, valid_mask, exclude_ids, k,
                                      metric, n_valid)
        return _finish(sel_d, sel_i, queries, metric)
    bias = _bias(points, None, n_valid, metric).contiguous()
    x_int8 = points.dtype == torch.int8
    S, per = splits(B, n_pad, k, x_int8, queries.device)
    out_d = torch.empty((B, S, k), dtype=torch.float32, device=queries.device)
    out_i = torch.empty((B, S, k), dtype=torch.int32, device=queries.device)
    # the splits' shared per-row threshold (the kernel's launch resets it)
    thr = torch.empty((B,), dtype=torch.int64, device=queries.device) if S > 1 else None
    fn = _lib.function("pa_flat_topk", [_lib.VP] * 5 + [_lib.INT] * 4
                       + [_lib.FLOAT] + [_lib.INT] * 5 + [_lib.VP] * 3)
    rc = fn(queries.data_ptr(), points.data_ptr(), bias.data_ptr(),
            _ptr(exclude_ids), _ptr(thr), B, n_pad, d, k,
            -1.0 if metric is Metric.MIPS else -2.0, int(x_int8), S, per,
            _copy_width(queries), _copy_width(points),
            out_d.data_ptr(), out_i.data_ptr(), _lib.stream())
    flat_topk.launches += 1
    _lib.check(rc, "flat_topk")
    if S == 1:
        sel_d, sel_i = out_d[:, 0], out_i[:, 0]
    else:
        sel_d, sel_i = merge_split_topk(out_d, out_i, k)
    return _finish(sel_d, sel_i, queries, metric)


def _launch_masked(queries, points, valid_mask, exclude_ids, k, metric, n_valid):
    """The masked mode on the card: one C call compacts the valid ids,
    scans them and merges the splits -> selection-domain (B, k) (distances,
    ids), with no host synchronisation."""
    dev = queries.device
    B, d = queries.shape
    x_int8 = points.dtype == torch.int8
    mask = valid_mask.to(torch.bool).contiguous()
    S, min_tiles = masked_splits(B, n_valid, k, x_int8, dev)
    # the compaction's int32 workspace, laid out by the C side
    size = _lib.library().pa_flat_topk_masked_scratch
    size.argtypes = [_lib.INT]
    size.restype = ctypes.c_longlong
    n_ws = size(n_valid)
    ws = torch.empty(n_ws, dtype=torch.int32, device=dev)
    out_d = torch.empty((B, S, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, S, k), dtype=torch.int32, device=dev)
    if S > 1:
        thr = torch.empty((B,), dtype=torch.int64, device=dev)
        fin_d = torch.empty((B, k), dtype=torch.float32, device=dev)
        fin_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    else:
        thr = fin_d = fin_i = None
    fn = _lib.function("pa_flat_topk_masked", [_lib.VP] * 5 + [ctypes.c_longlong, _lib.VP]
                       + [_lib.INT] * 4 + [_lib.FLOAT] + [_lib.INT] * 6 + [_lib.VP] * 5)
    rc = fn(queries.data_ptr(), points.data_ptr(), mask.data_ptr(), _ptr(exclude_ids),
            ws.data_ptr(), n_ws, _ptr(thr), B, n_valid, d, k,
            -1.0 if metric is Metric.MIPS else -2.0, int(x_int8),
            int(metric is not Metric.MIPS), S, min_tiles, _copy_width(queries),
            _copy_width(points), out_d.data_ptr(), out_i.data_ptr(), _ptr(fin_d),
            _ptr(fin_i), _lib.stream())
    flat_topk.launches += 1
    _lib.check(rc, "flat_topk")
    if S == 1:
        return out_d[:, 0], out_i[:, 0]
    return fin_d, fin_i


flat_topk.launches = 0


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _copy_width(t: torch.Tensor) -> int:
    """The widest copy (16, 8 or 4 bytes) that every row slot of ``t`` keeps
    aligned; 1 means the kernel loads that array with plain loads."""
    row = t.shape[1] * t.element_size()
    for w in (16, 8, 4):
        if row % w == 0 and t.data_ptr() % w == 0:
            return w
    return 1


_resident: dict = {}


def _slots(k: int, x_int8: bool, masked: bool, device: torch.device) -> int:
    """CTAs the card holds at once at this k: the kernel's occupancy times
    the SM count, asked once per device and kernel."""
    key = (k, bool(x_int8), bool(masked), device.index)
    if key not in _resident:
        fn = _lib.function("pa_flat_topk_resident",
                           [_lib.INT, _lib.INT, _lib.INT, ctypes.POINTER(ctypes.c_int)])
        blocks = ctypes.c_int(0)
        _lib.check(fn(k, int(x_int8), int(masked), ctypes.byref(blocks)),
                   "flat_topk occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _resident[key] = max(1, blocks.value) * sms
    return _resident[key]


def splits(B: int, n_pad: int, k: int, x_int8: bool, device: torch.device):
    """-> (S, points per split) that :func:`flat_topk` launches with on
    ``device`` without a mask: :func:`split_plan` over the CTAs the card
    holds at once."""
    return split_plan(B, n_pad, _slots(k, x_int8, False, device))


def masked_splits(B: int, n_valid: int, k: int, x_int8: bool, device: torch.device):
    """-> (S, fewest tiles a split) of the masked mode on ``device``:
    :func:`masked_plan` over the CTAs the card holds at once."""
    return masked_plan(B, n_valid, _slots(k, x_int8, True, device), k)
