"""Scalar quantization (1-16 bits), the 1-bit, MIPS 2-bit and 4-bit tiers
and the JL tiers.

Counterpart of parlayann_tpu/ops/quantize.py. Euclidean scalar tiers: global
min/max -> ``slope = (2^bits - 1) / (max - min)``, ``q = round((x - min) *
slope)`` clamped to [0, 2^bits - 1]. MIPS: symmetric ``slope = (2^(bits-1)
- 1) / max|x|``, where ``max|x|`` may be trimmed to the ``1 - trim``
quantile of the valid rows' absolute values. ``torch.round`` rounds half to
even, as ``jnp.round`` does, and every step is the same float32 operation,
so the tiers are bit-equal to the JAX package's.

Storage. Tiers of up to 8 bits are int8: Euclidean levels as ``level -
128``, MIPS levels as they are. Wider tiers are int16: MIPS levels as they
are (the JAX package's int16), Euclidean levels as ``level - 32768``, where
the JAX package keeps uint16 levels (``torch.uint16`` is a bare dtype with
few operations). Euclidean distances are differences, so the shift cancels
exactly, as the 8-bit tier's does; ``interop.pointset_from_state`` shifts
a JAX uint16 tier the same way.

Quantiles (the trimmed MIPS scale and the 2-bit cut) are ``jnp.quantile``'s
"linear" interpolation in its float32 arithmetic, from two order statistics
(``kthvalue``): ``torch.quantile`` refuses inputs of more than 2^24 values,
and 1M x 128 points hold 2^27.

The 1-bit tier (euclidian_point.h:332-420, mips_point.h:625-700) keeps one
bit per coordinate: ``x > median`` of that coordinate (L2) or ``x > 0``
(MIPS), packed little-endian into 32-bit words and compared by XOR +
popcount. The words are int32 holding the JAX package's uint32 bits: CPU
torch has no shifts on uint32. The MIPS 2-bit tier (mips_point.h:495-621)
packs a sign plane and a nonzero plane of ternary values {-1, 0, +1} into
the same words, ``[sign words | nonzero words]``; the MIPS 4-bit tier
(mips_point.h:706-849) packs levels in [-7, 7] two to an int8 byte,
coordinate i in the low nibble of byte i and coordinate i + d/2 in its high
nibble. The JL tiers (jl_point.h) project onto ``jl_dims`` random sign
directions, dense or with ``sparse_nnz`` nonzeros per direction, then take
the 1-bit tier or a scalar tier of any width of the projection.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet


def _check_bits(bits: int):
    if not 1 <= bits <= 16:
        raise ValueError(f"scalar tiers have 1 to 16 bits, not {bits}")


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32)


def quantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """The ``q`` quantile of all values of ``x`` as ``jnp.quantile(x, q)``
    computes it (method "linear", with float32 positions and weights): the
    order statistics at floor and ceil of ``q (n - 1)``, weighted. Any
    number of values; a 0-d float32 tensor on ``x``'s device."""
    flat = x.reshape(-1).float()
    f = torch.float32
    n = torch.tensor(flat.numel(), dtype=f)
    pos = torch.tensor(q, dtype=f) * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1 - hw
    # XLA's gather clamps an index past the end (float32 n - 1 can round up)
    last = flat.numel() - 1
    lo_i = min(int(torch.clamp(low, 0, n - 1)), last)
    hi_i = min(int(torch.clamp(high, 0, n - 1)), last)
    lo_v = torch.kthvalue(flat, lo_i + 1).values
    hi_v = lo_v if hi_i == lo_i else torch.kthvalue(flat, hi_i + 1).values
    return lo_v * lw.to(flat.device) + hi_v * hw.to(flat.device)


def euclidean_params(data: torch.Tensor, bits: int = 8):
    """Global min/max scan (euclidian_point.h:212-235) -> (slope, offset)."""
    _check_bits(bits)
    lo = data.min().float()
    hi = data.max().float()
    slope = _f32(2.0 ** bits - 1.0).to(lo.device) / torch.clamp(hi - lo, min=1e-30)
    return slope, lo


def euclidean_translate(x: torch.Tensor, slope, offset, bits: int = 8):
    """Scalar-quantize with clamping (euclidian_point.h:183-209); stores
    ``level - 128`` as int8 (up to 8 bits) or ``level - 32768`` as int16
    (L2 differences cancel the shift)."""
    _check_bits(bits)
    q = torch.round((x.float() - offset) * slope)
    q = torch.clamp(q, 0.0, 2.0 ** bits - 1.0)
    if bits <= 8:
        return (q - 128.0).to(torch.int8)
    return (q - 32768.0).to(torch.int16)


def mips_params(data: torch.Tensor, bits: int = 8, trim: float = 0.0):
    """Symmetric scale from the (trimmed) max-abs (mips_point.h:433-489)
    -> (slope, offset=0). ``trim > 0`` takes the ``1 - trim`` quantile of
    the absolute values instead of their maximum."""
    _check_bits(bits)
    absd = data.float().abs()
    max_abs = quantile_linear(absd, 1.0 - trim) if trim > 0.0 else absd.max()
    levels = 2.0 ** (bits - 1) - 1.0
    slope = _f32(levels).to(max_abs.device) / torch.clamp(max_abs, min=1e-30)
    return slope, _f32(0.0).to(max_abs.device)


def mips_translate(x: torch.Tensor, slope, offset, bits: int = 8):
    _check_bits(bits)
    levels = 2.0 ** (bits - 1) - 1.0
    q = torch.clamp(torch.round(x.float() * slope), -levels, levels)
    return q.to(torch.int8 if bits <= 8 else torch.int16)


def quantize_pointset(ps: PointSet, bits: int = 8, trim: float = 0.0) -> PointSet:
    """A scalar tier of a PointSet (point_range.h:55-66). Parameters come
    from the valid rows only: zero pad rows would widen the range. ``trim``
    applies to MIPS only, as in the JAX package."""
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
# The MIPS 2-bit tier (Mips_2Bit_Point, mips_point.h:495-621): ternary values
# {-1, 0, +1} as two packed planes, sign (x > cut) and nonzero (|x| > cut),
# ``[sign words | nonzero words]``; the cut is max(|q30|, q70) of the valid
# rows' values (mips_point.h:601-618). Negated ternary dot:
#   2 popcount((sign_p ^ sign_q) & nz) - popcount(nz_p & nz_q)
# ---------------------------------------------------------------------------


def mips_2bit_params(data: torch.Tensor) -> torch.Tensor:
    """The ternary cut max(|q30|, q70) over all values of ``data``."""
    flat = data.float()
    return torch.maximum(quantile_linear(flat, 0.7), -quantile_linear(flat, 0.3))


def _pack_ternary(x: torch.Tensor, cut) -> torch.Tensor:
    """(n, d) floats -> (n, 2W) int32 words [sign planes | nonzero planes]."""
    return torch.cat([_pack_bits(x > cut), _pack_bits(x.abs() > cut)], dim=1)


def mips_2bit_quantize(ps: PointSet) -> PointSet:
    """The 2-bit ternary MIPS tier; the cut lives in ``quant_offset``."""
    cut = mips_2bit_params(ps.data[: ps.n])
    return PointSet(data=_pack_ternary(ps.data.float(), cut), n=ps.n, d=ps.d,
                    metric=Metric.MIPS, bits=2, quant_slope=None, quant_offset=cut)


def mips_2bit_translate_query(q: torch.Tensor, tps: PointSet) -> torch.Tensor:
    return _pack_ternary(q.float(), tps.quant_offset)


def mips_2bit_distance(q_words: torch.Tensor, c_words: torch.Tensor) -> torch.Tensor:
    """(B, 2W) vs (B, K, 2W) words -> (B, K) f32 ternary negated dots
    (mips_point.h:529-547), formed as integers before the subtraction."""
    W = q_words.shape[-1] // 2
    qs, qn = q_words[:, None, :W], q_words[:, None, W:]
    cs, cn = c_words[..., :W], c_words[..., W:]
    nz = qn & cn
    n_neg = popcount((qs ^ cs) & nz).sum(-1)
    n_nz = popcount(nz).sum(-1)
    return (2 * n_neg - n_nz).float()


# ---------------------------------------------------------------------------
# The MIPS 4-bit tier (Mips_4Bit_Point, mips_point.h:706-849; distance_4 at
# :344-354): symmetric levels in [-7, 7], two to an int8 byte. Unpacking is
# (x << 4) >> 4 (low nibble) and x >> 4 (high), arithmetic shifts of int8.
# ---------------------------------------------------------------------------


def mips_4bit_quantize(ps: PointSet, trim: float = 0.0) -> PointSet:
    """The packed 4-bit MIPS tier; the scale lives in ``quant_slope``."""
    slope, _ = mips_params(ps.data[: ps.n], bits=4, trim=trim)
    q = torch.clamp(torch.round(ps.data.float() * slope), -7, 7).to(torch.int32)
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 1))
    half = q.shape[1] // 2
    packed = ((q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4)).to(torch.int8)
    return PointSet(data=packed, n=ps.n, d=ps.d, metric=Metric.MIPS, bits=4,
                    quant_slope=slope, quant_offset=_f32(0.0).to(slope.device))


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., d/2) int8 -> (..., d) int8 in [-8, 7] ([low half | high half])."""
    x = packed.to(torch.int8)
    return torch.cat([(x << 4) >> 4, x >> 4], dim=-1)


def mips_4bit_translate_query(q: torch.Tensor, tps: PointSet) -> torch.Tensor:
    """(B, d) queries -> (B, d') f32 levels in [-7, 7], unpacked, d' even."""
    lev = torch.clamp(torch.round(q.float() * tps.quant_slope), -7, 7)
    if lev.shape[-1] % 2:
        lev = torch.nn.functional.pad(lev, (0, 1))
    return lev


def mips_4bit_distance(q_levels: torch.Tensor, c_packed: torch.Tensor) -> torch.Tensor:
    """(B, d') f32 levels vs (B, K, d'/2) packed int8 -> (B, K) negated
    dots; small integers, exact in any summation order."""
    return -(unpack_int4(c_packed).float() * q_levels[:, None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Johnson-Lindenstrauss tiers (jl_point.h): a random sign projection to
# jl_dims, then the 1-bit tier or a scalar tier of the projected points.
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
    by hamming distance; ``bits`` 2-16: the scalar tier of that width of the
    projections, with the source metric). ``proj`` replaces the drawn
    matrix, and ``points`` installs an already quantized tier as it is
    (interop)."""

    def __init__(self, ps: PointSet, jl_dims: int = 64, bits: int = 8,
                 seed: int = 0, sparse_nnz: int = 0, proj=None,
                 points: PointSet | None = None):
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
        """(B, d) queries -> int32 words (bits 1) or f32 levels."""
        proj = self.project(q)
        if self.bits == 1:
            return bit_translate_query(proj, self.points)
        return translate_query(proj, self.points).float()


def jl_project(ps: PointSet, jl_dims: int = 64, bits: int = 8,
               seed: int = 0) -> PointSet:
    """The quantized projected PointSet of a JLTier."""
    return JLTier(ps, jl_dims=jl_dims, bits=bits, seed=seed).points
