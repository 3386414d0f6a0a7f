"""Kernels 1 and 6: frontier-expansion distances over inline neighbours.

Counterpart of parlayann_tpu/ops/pallas/expand.py (``build_inline`` :30,
``expand_distances`` :129, ``expand_bits_flat`` :301). ``inline[v, j]`` is
the vector of the j-th neighbour of vertex v; for B queries a kernel
returns the distances to the R8 inline neighbours of ``expand_ids[b]``.
Slots at or beyond a vertex's degree hold garbage distances that the
caller masks.

Kernel 1 (``expand_distances``, ``csrc/expand.cu``) reads int8 vectors
(the q8 tier and the scalar tiers of fewer bits), int16 vectors (the
scalar tiers of 9 to 16 bits) or f32 vectors (the full-precision tier),
one kernel each. On int16 rows the distances are summed exactly in int64
and rounded once to f32: the squares and products of 16-bit levels pass
2^31.
``expand_distances_multi`` is kernel 1's multi-probe mode (JAX
``expand_distances_multi`` :381): (B, E) ids, each query against E blocks,
for the meta-routed top-k (``clusterbeam.meta_topk``), where many queries
probe few blocks. Its kernel groups the pairs by block on the card and
reads each touched block into shared memory once a work item, for f32 and
int8 rows.
Kernel 6 (``expand_bits_flat``, ``csrc/expandbits.cu``) reads the 1-bit
tier's packed int32 words and returns XOR + popcount hamming distances; it
also serves ``expand_distances(bits=1)``. Its inline array is
``build_inline`` of the word array, ``(n_pad, R8, W)``: the JAX package's
flat ``(n_pad, rws, 128)`` layout and its lane-group sums exist only for
Mosaic's 128-lane DMA rule and are not carried over. Each ``*_plain``
function is the same function in PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops import distance, quantize
from parlayann_tpu_torch.ops.kernels import _lib


def build_inline(points_data: torch.Tensor, nbrs: torch.Tensor,
                 chunk_rows: int = 65536) -> torch.Tensor:
    """(n_pad, d), (n_pad, R) -> (n_pad, R8, d) inline neighbour vectors,
    R8 = R rounded up to a multiple of 8 (the JAX layout, kept so both
    packages compare like with like). Pad slots hold row 0's vector."""
    n_pad, R = nbrs.shape
    R8 = (R + 7) // 8 * 8
    out = torch.empty((n_pad, R8, points_data.shape[1]),
                      dtype=points_data.dtype, device=points_data.device)
    for lo in range(0, n_pad, chunk_rows):
        rows = nbrs[lo:lo + chunk_rows].clamp(0, n_pad - 1)
        if R8 != R:
            rows = torch.nn.functional.pad(rows, (0, R8 - R))
        out[lo:lo + chunk_rows] = points_data[rows]
    return out


def build_inline_bits(words: torch.Tensor, nbrs: torch.Tensor,
                      chunk_rows: int = 65536) -> torch.Tensor:
    """(n_pad, W) int32 words, (n_pad, R) -> (n_pad, R8, W) int32 inline
    words: :func:`build_inline` of the word array, the layout the JAX
    ``expand_distances(bits=1)`` reads."""
    return build_inline(words, nbrs, chunk_rows)


def expand_bits_flat_plain(inline: torch.Tensor, expand_ids: torch.Tensor,
                           q_words: torch.Tensor) -> torch.Tensor:
    """Kernel 6's function in PyTorch: (B, R8) f32 hamming distances."""
    rows = inline[expand_ids.long().clamp(0, inline.shape[0] - 1)]
    return quantize.hamming_distance(q_words, rows)


def expand_bits_flat(inline: torch.Tensor, expand_ids: torch.Tensor,
                     q_words: torch.Tensor) -> torch.Tensor:
    """-> (B, R8) f32 hamming distances from the packed query b to the
    inline neighbours of ``expand_ids[b]`` (ids are clamped into range).
    CPU tensors run :func:`expand_bits_flat_plain`; CUDA tensors launch
    kernel 6, which takes an int32 ``(n_pad, R8, W)`` inline array, int32
    ids and ``(B, W)`` int32 query words."""
    if not _lib.route(inline, expand_ids, q_words):
        return expand_bits_flat_plain(inline, expand_ids, q_words)
    _lib.require(inline, "inline", torch.int32, 3)
    _lib.require(expand_ids, "expand_ids", torch.int32, 1)
    _lib.require(q_words, "q_words", torch.int32, 2)
    n_pad, R8, W = inline.shape
    B = q_words.shape[0]
    if expand_ids.shape[0] != B or q_words.shape[1] != W:
        raise ValueError(
            f"shape mismatch: inline {tuple(inline.shape)}, expand_ids "
            f"{tuple(expand_ids.shape)}, q_words {tuple(q_words.shape)}")
    out = torch.empty((B, R8), dtype=torch.float32, device=q_words.device)
    if B == 0:
        return out
    fn = _lib.function("pa_expand_bits", [_lib.VP] * 4 + [_lib.INT] * 4 + [_lib.VP])
    rc = fn(inline.data_ptr(), expand_ids.data_ptr(), q_words.data_ptr(),
            out.data_ptr(), B, n_pad, R8, W, _lib.stream())
    expand_bits_flat.launches += 1
    _lib.check(rc, "expand_bits_flat")
    return out


expand_bits_flat.launches = 0


def expand_distances_plain(inline: torch.Tensor, expand_ids: torch.Tensor,
                           queries: torch.Tensor, *, metric: Metric,
                           bits: int = 32) -> torch.Tensor:
    """The kernels' function in PyTorch: (B, R8) f32 distances. f32 rows
    sum in the f32 kernel's order (``distance.gathered_lane_order``, 4
    values a 16-byte chunk), so the two agree bit for bit; int8 rows sum
    exact integers on the build path, in any order; int16 rows sum in
    int64, rounded once to f32 (``distance.gathered``), as the int16
    kernel does."""
    if bits == 1:
        return expand_bits_flat_plain(inline, expand_ids, queries)
    rows = inline[expand_ids.long().clamp(0, inline.shape[0] - 1)]
    if inline.dtype == torch.float32:
        return distance.gathered_lane_order(queries, rows, metric, chunk=4)
    return distance.gathered(queries, rows, metric)


def expand_distances(inline: torch.Tensor, expand_ids: torch.Tensor,
                     queries: torch.Tensor, *, metric: Metric,
                     bits: int = 32) -> torch.Tensor:
    """-> (B, R8) f32 distances from query b to the inline neighbours of
    ``expand_ids[b]`` (ids are clamped into range). CPU tensors run
    :func:`expand_distances_plain`; CUDA tensors launch kernel 1, which
    takes an int8, an int16 or a float32 inline array (one kernel each; the
    f32 and int16 launches are also counted in ``launches_f32`` and
    ``launches_i16``), int32 ids and f32 queries (integer levels for int16
    rows). ``bits=1``: the inline array and the queries are packed int32
    words and the call is :func:`expand_bits_flat` (kernel 6)."""
    if bits == 1:
        return expand_bits_flat(inline, expand_ids, queries)
    if not _lib.route(inline, expand_ids, queries):
        return expand_distances_plain(inline, expand_ids, queries, metric=metric)
    f32 = inline.dtype == torch.float32
    i16 = inline.dtype == torch.int16
    _lib.require(inline, "inline",
                 torch.float32 if f32 else torch.int16 if i16 else torch.int8, 3)
    _lib.require(expand_ids, "expand_ids", torch.int32, 1)
    _lib.require(queries, "queries", torch.float32, 2)
    n_pad, R8, d = inline.shape
    B = queries.shape[0]
    if expand_ids.shape[0] != B or queries.shape[1] != d:
        raise ValueError(
            f"shape mismatch: inline {tuple(inline.shape)}, expand_ids "
            f"{tuple(expand_ids.shape)}, queries {tuple(queries.shape)}")
    out = torch.empty((B, R8), dtype=torch.float32, device=queries.device)
    if B == 0:
        return out
    name = ("pa_expand_distances_f32" if f32 else
            "pa_expand_distances_i16" if i16 else "pa_expand_distances")
    fn = _lib.function(name, [_lib.VP] * 4 + [_lib.INT] * 5 + [_lib.VP])
    rc = fn(inline.data_ptr(), expand_ids.data_ptr(), queries.data_ptr(),
            out.data_ptr(), B, n_pad, R8, d, int(metric is Metric.MIPS),
            _lib.stream())
    expand_distances.launches += 1
    expand_distances.launches_f32 += f32
    expand_distances.launches_i16 += i16
    _lib.check(rc, "expand_distances")
    return out


expand_distances.launches = 0
expand_distances.launches_f32 = 0
expand_distances.launches_i16 = 0


def expand_distances_multi_plain(inline: torch.Tensor, expand_ids: torch.Tensor,
                                 queries: torch.Tensor, *, metric: Metric) -> torch.Tensor:
    """The multi-probe mode's function in PyTorch: (B, E, R8) f32, probe e
    of query b as :func:`expand_distances_plain` of ``expand_ids[b, e]``
    (the gather, then ``distance.gathered_lane_order`` for f32 rows and
    ``distance.gathered`` for int8 rows), one probe at a time so the
    gathered rows stay (B, R8, d)."""
    B, E = expand_ids.shape
    out = torch.empty((B, E, inline.shape[1]), dtype=torch.float32, device=queries.device)
    for e in range(E):
        out[:, e] = expand_distances_plain(inline, expand_ids[:, e], queries, metric=metric)
    return out


def expand_distances_multi(inline: torch.Tensor, expand_ids: torch.Tensor,
                           queries: torch.Tensor, *, metric: Metric) -> torch.Tensor:
    """-> (B, E, R8) f32 distances from query b to the R8 rows of block
    ``expand_ids[b, e]`` (ids are clamped into range); queries are not
    repeated. CPU tensors run :func:`expand_distances_multi_plain`; CUDA
    tensors launch kernel 1's multi-probe mode, which takes a float32 or an
    int8 ``(n_pad, R8, d)`` array, ``(B, E)`` int32 ids and ``(B, d)`` f32
    queries, and equals the single mode pair for pair (f32 rows in its
    summation order; int8 rows exact on integer-valued queries). Launches
    are counted in ``launches``, the f32 rows' also in ``launches_f32``."""
    if not _lib.route(inline, expand_ids, queries):
        return expand_distances_multi_plain(inline, expand_ids, queries, metric=metric)
    f32 = inline.dtype == torch.float32
    _lib.require(inline, "inline", torch.float32 if f32 else torch.int8, 3)
    _lib.require(expand_ids, "expand_ids", torch.int32, 2)
    _lib.require(queries, "queries", torch.float32, 2)
    n_pad, R8, d = inline.shape
    B, E = expand_ids.shape
    if queries.shape != (B, d):
        raise ValueError(
            f"shape mismatch: inline {tuple(inline.shape)}, expand_ids "
            f"{tuple(expand_ids.shape)}, queries {tuple(queries.shape)}")
    if B * E >= 2**31:
        raise ValueError(f"{B} x {E} pairs exceed the kernel's int32 pair index")
    out = torch.empty((B, E, R8), dtype=torch.float32, device=queries.device)
    if B * E == 0:
        return out
    size = _lib.library().pa_expand_multi_scratch
    size.argtypes = [_lib.INT, _lib.INT]
    size.restype = ctypes.c_longlong
    n_scratch = size(n_pad, B * E)
    scratch = torch.empty(n_scratch, dtype=torch.int32, device=queries.device)
    fn = _lib.function("pa_expand_distances_multi",
                       [_lib.VP] * 5 + [ctypes.c_longlong] + [_lib.INT] * 7 + [_lib.VP])
    rc = fn(inline.data_ptr(), expand_ids.data_ptr(), queries.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n_scratch, B, E, n_pad, R8, d,
            int(f32), int(metric is Metric.MIPS), _lib.stream())
    expand_distances_multi.launches += 1
    expand_distances_multi.launches_f32 += f32
    _lib.check(rc, "expand_distances_multi")
    return out


expand_distances_multi.launches = 0
expand_distances_multi.launches_f32 = 0
