"""Scalar quantization (q8), the 1-bit tier and the JL tiers.

Counterpart of parlayann_tpu/ops/quantize.py:29-191 and :305-365.
Euclidean q8: global min/max -> ``slope = 255 / (max - min)``,
``q = round((x - min) * slope)`` clamped to [0, 255] and stored as
``q - 128`` in int8. MIPS q8: symmetric ``slope = 127 / max|x|``.
``torch.round`` rounds half to even, as ``jnp.round`` does, and every step
is the same float32 operation, so the tier is bit-equal to the JAX
package's.

The 1-bit tier (euclidian_point.h:332-420, mips_point.h:625-700) keeps one
bit per coordinate: ``x > median`` of that coordinate (L2) or ``x > 0``
(MIPS), packed little-endian into 32-bit words and compared by XOR +
popcount. The words are int32 holding the JAX package's uint32 bits: CPU
torch has no shifts on uint32. The JL tiers (jl_point.h) project onto
``jl_dims`` random sign directions, dense or with ``sparse_nnz`` nonzeros
per direction, then take the 1-bit or the q8 tier of the projection. The
MIPS 2-bit and 4-bit tiers and the trimmed MIPS scale are not ported yet
(ROADMAP queue 1, "The remaining tiers").
"""

from __future__ import annotations

import dataclasses
import math

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet


def _check_bits(bits: int):
    if bits != 8:
        raise NotImplementedError(
            f"only the 8-bit tier is ported (bits={bits}); "
            'see ROADMAP queue 1, "The remaining tiers"')


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def euclidean_params(data: torch.Tensor, bits: int = 8):
    """Global min/max scan (euclidian_point.h:212-235) -> (slope, offset)."""
    _check_bits(bits)
    lo = data.min().float()
    hi = data.max().float()
    slope = _f32(2.0 ** bits - 1.0).to(lo.device) / torch.clamp(hi - lo, min=1e-30)
    return slope, lo


def euclidean_translate(x: torch.Tensor, slope, offset, bits: int = 8):
    """Scalar-quantize with clamping (euclidian_point.h:183-209); stores
    ``level - 128`` as int8 (L2 differences cancel the shift)."""
    _check_bits(bits)
    q = torch.round((x.float() - offset) * slope)
    q = torch.clamp(q, 0.0, 2.0 ** bits - 1.0)
    return (q - 128.0).to(torch.int8)


def mips_params(data: torch.Tensor, bits: int = 8, trim: float = 0.0):
    """Symmetric scale from max-abs (mips_point.h:433-489) ->
    (slope, offset=0)."""
    _check_bits(bits)
    if trim > 0.0:
        raise NotImplementedError(
            "trimmed MIPS quantization is not ported; see ROADMAP queue 1, "
            '"The remaining tiers"')
    max_abs = data.float().abs().max()
    levels = 2.0 ** (bits - 1) - 1.0
    slope = _f32(levels).to(max_abs.device) / torch.clamp(max_abs, min=1e-30)
    return slope, _f32(0.0).to(max_abs.device)


def mips_translate(x: torch.Tensor, slope, offset, bits: int = 8):
    _check_bits(bits)
    levels = 2.0 ** (bits - 1) - 1.0
    q = torch.clamp(torch.round(x.float() * slope), -levels, levels)
    return q.to(torch.int8)


def quantize_pointset(ps: PointSet, bits: int = 8, trim: float = 0.0) -> PointSet:
    """The q8 tier of a PointSet (point_range.h:55-66). Parameters come
    from the valid rows only: zero pad rows would widen the range."""
    valid = ps.data[: ps.n]
    if ps.metric is Metric.L2:
        slope, offset = euclidean_params(valid, bits)
        qdata = euclidean_translate(ps.data, slope, offset, bits)
    else:
        slope, offset = mips_params(valid, bits, trim)
        qdata = mips_translate(ps.data, slope, offset, bits)
    return PointSet(data=qdata, n=ps.n, d=ps.d, metric=ps.metric, bits=bits,
                    quant_slope=slope, quant_offset=offset)


def build_tier(ps: PointSet, quantize_build: bool) -> PointSet:
    """The points a graph build computes its distances on: the q8 tier of
    float32 or uint8 points when ``quantize_build``; else int8 and float32
    points as they are, and uint8 points as an exact float32 copy (the
    kernels read int8 or float32 rows; the JAX package builds on uint8 as
    it is, with the same integer distances)."""
    if quantize_build and ps.data.dtype in (torch.float32, torch.uint8):
        return quantize_pointset(ps, bits=8)
    if ps.data.dtype == torch.uint8:
        return dataclasses.replace(ps, data=ps.data.float())
    if ps.data.dtype not in (torch.int8, torch.float32):
        raise ValueError(f"builds run on int8, uint8 or float32 points, not {ps.data.dtype}")
    return ps


def translate_query(q: torch.Tensor, ps: PointSet) -> torch.Tensor:
    """Quantize queries into ``ps``'s domain (graph_index.cpp:144-177)."""
    if ps.bits >= 32 or ps.quant_slope is None:
        return q
    if ps.metric is Metric.L2:
        return euclidean_translate(q, ps.quant_slope, ps.quant_offset, ps.bits)
    return mips_translate(q, ps.quant_slope, ps.quant_offset, ps.bits)


# ---------------------------------------------------------------------------
# The 1-bit tier: packed int32 words, hamming distances (XOR + popcount).
# ---------------------------------------------------------------------------


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(n, d) bool or {0, 1} -> (n, ceil(d / 32)) int32 words; bit j of
    word w is coordinate 32 w + j (the JAX package's uint32 bits)."""
    n, d = bits.shape
    words = (d + 31) // 32
    b = torch.nn.functional.pad(bits.to(torch.bool), (0, words * 32 - d))
    b = b.reshape(n, words, 32)
    out = torch.zeros((n, words), dtype=torch.int32, device=bits.device)
    for j in range(31):
        out |= b[:, :, j].to(torch.int32) << j
    # bit 31 is the sign bit of an int32 word
    out |= torch.where(b[:, :, 31], -2**31, 0).to(torch.int32)
    return out


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor -> int64 counts
    (a SWAR count on the word widened to int64 and masked to 32 bits)."""
    v = x.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (v * 0x01010101 & 0xFFFFFFFF) >> 24


def _median_rows(x: torch.Tensor) -> torch.Tensor:
    """Median of each column, as ``jnp.median(x, axis=0)``: the mean of the
    two middle values, ``(a + b) * 0.5``, when the row count is even."""
    s = torch.sort(x, dim=0).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def bit_quantize(ps: PointSet) -> PointSet:
    """The 1-bit tier of a PointSet; the (d,) thresholds go into
    ``quant_offset``. L2: per-coordinate median of the valid rows; MIPS: 0
    (the sign bit). A coordinate's bit is ``x > threshold``."""
    data = ps.data.float()
    if ps.metric is Metric.L2:
        thr = _median_rows(data[: ps.n])
    else:
        thr = torch.zeros((ps.d,), dtype=torch.float32, device=data.device)
    return PointSet(data=_pack_bits(data > thr[None, :]), n=ps.n, d=ps.d,
                    metric=ps.metric, bits=1, quant_slope=None,
                    quant_offset=thr)


def bit_translate_query(q: torch.Tensor, bps: PointSet) -> torch.Tensor:
    """(B, d) queries -> (B, W) int32 words in ``bps``'s domain."""
    return _pack_bits(q.float() > bps.quant_offset[None, :])


def hamming_distance(q_bits: torch.Tensor, c_bits: torch.Tensor) -> torch.Tensor:
    """(B, W) vs (B, K, W) words -> (B, K) f32 popcount distances."""
    return popcount(q_bits[:, None, :] ^ c_bits).sum(-1).float()


def hamming_all_pairs(q_bits: torch.Tensor, p_bits: torch.Tensor) -> torch.Tensor:
    """(B, W) vs (N, W) words -> (B, N) f32 popcount distances."""
    return popcount(q_bits[:, None, :] ^ p_bits[None, :, :]).sum(-1).float()


# ---------------------------------------------------------------------------
# Johnson-Lindenstrauss tiers (jl_point.h): a random sign projection to
# jl_dims, then the 1-bit or the 8-bit tier of the projected points.
# ---------------------------------------------------------------------------


def jl_projection_matrix(d: int, jl_dims: int, seed: int = 0,
                         sparse_nnz: int = 0) -> torch.Tensor:
    """(d, jl_dims) float32 random sign projection on the CPU, drawn from
    a ``torch.Generator`` seeded with ``seed``: Rademacher signs over
    sqrt(jl_dims); with ``0 < sparse_nnz < d`` only the ``sparse_nnz``
    input coordinates of largest uniform score are kept per column
    (jl_point.h:193-285), over sqrt(sparse_nnz). The construction is the
    JAX package's; its random numbers are not."""
    gen = torch.Generator().manual_seed(seed)
    signs = torch.randint(0, 2, (d, jl_dims), generator=gen).float() * 2.0 - 1.0
    if sparse_nnz and sparse_nnz < d:
        scores = torch.rand((d, jl_dims), generator=gen)
        keep = torch.zeros((d, jl_dims), dtype=torch.bool)
        keep.scatter_(0, scores.topk(sparse_nnz, dim=0).indices, True)
        return torch.where(keep, signs, 0.0) / math.sqrt(sparse_nnz)
    return signs / math.sqrt(jl_dims)


class JLTier:
    """A JL search tier: the projection matrix and the quantized projected
    points (``bits`` 1: sign bits against the per-dimension median, searched
    by hamming distance; ``bits`` 8: the q8 tier of the projections, with
    the source metric). ``proj`` replaces the drawn matrix, and ``points``
    installs an already quantized tier as it is (interop)."""

    def __init__(self, ps: PointSet, jl_dims: int = 64, bits: int = 8,
                 seed: int = 0, sparse_nnz: int = 0, proj=None,
                 points: PointSet | None = None):
        if bits not in (1, 8):
            raise NotImplementedError(
                f"JL tiers of {bits} bits are not ported; see ROADMAP queue 1, "
                '"The remaining tiers"')
        if proj is None:
            proj = jl_projection_matrix(ps.d, jl_dims, seed, sparse_nnz)
        self.proj = torch.as_tensor(proj, dtype=torch.float32).to(ps.device)
        self.bits = bits
        self.jl_dims = int(self.proj.shape[1])
        if points is None:
            projected = PointSet(data=self.project(ps.data), n=ps.n,
                                 d=self.jl_dims, metric=ps.metric, bits=32)
            points = (bit_quantize(projected) if bits == 1
                      else quantize_pointset(projected, bits=bits))
        self.points = points

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """(m, d) rows -> (m, jl_dims) float32 projections."""
        return x.float() @ self.proj

    def translate_query(self, q: torch.Tensor) -> torch.Tensor:
        """(B, d) queries -> int32 words (bits 1) or f32 levels (bits 8)."""
        proj = self.project(q)
        if self.bits == 1:
            return bit_translate_query(proj, self.points)
        return translate_query(proj, self.points).float()


def jl_project(ps: PointSet, jl_dims: int = 64, bits: int = 8,
               seed: int = 0) -> PointSet:
    """The quantized projected PointSet of a JLTier."""
    return JLTier(ps, jl_dims=jl_dims, bits=bits, seed=seed).points
