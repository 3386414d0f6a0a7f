"""The entry top-1: each query's nearest point of the sampled entry tier.

Replaces no Pallas kernel. The JAX package computes the entry top-1 as one
(B, E) MXU dot with a fused row argmin (parlayann_tpu/index.py:39-55), and
XLA keeps the (B, E) tile out of HBM. The port's kernel (``csrc/entry.cu``)
keeps that fusion on the H100: 3xTF32 ``wgmma`` tiles of the (B, E)
products, 128 queries a CTA, folded into a running (key, position) minimum
per row in registers, so no (B, E) array exists in device memory. It is
bound by its operations (three TF32 passes of 2 B E d); the source's note
says what its design does about that.

The key of entry j for query q is ``bias[j] - 2 q.e_j`` (L2, ``bias`` the
squared norms) or ``-q.e_j`` (MIPS); the smallest key wins, the lowest
position among equal keys, as ``argmin`` does. :func:`entry_tier` makes
what the search reads of a tier once a tier: the float32 rows, the bias,
the int32 ids and, on the card, the rows split for the kernel
(:func:`entry_pack`). :func:`entry_top1_plain` is the same arithmetic in
PyTorch (one float32 matmul and an argmin), for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops.kernels import _lib

ROWS = 128        # queries a CTA (csrc/entry.cu kRows)
ENTRY_TILE = 128  # entries a work item (kET)
PACK = 32         # the packed tier's width unit (kKB)


def entry_bias(evecs: torch.Tensor, metric: Metric) -> torch.Tensor:
    """(E, d) f32 entry rows -> (E,) f32: ``||e||^2`` (L2) or 0 (MIPS)."""
    if metric is Metric.MIPS:
        return torch.zeros(evecs.shape[0], dtype=torch.float32, device=evecs.device)
    return (evecs * evecs).sum(dim=1)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (ties away from zero), as csrc/tf32.cuh's
    ``tf32_rna``: half a TF32 ulp added to the bits, the 13 low bits
    cleared."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def entry_pack(evecs: torch.Tensor) -> torch.Tensor:
    """(E, d) float32 entry rows -> (E, 2 dp) float32, the form the kernel
    reads: each row's TF32 hi parts over d rounded up to ``PACK`` (zeros
    past d), then its lo parts, split as csrc/tf32.cuh's ``split_tf32``
    (hi = rna(x), lo = rna(x - hi))."""
    E, d = evecs.shape
    x = torch.zeros((E, -(-d // PACK) * PACK), dtype=torch.float32, device=evecs.device)
    x[:, :d] = evecs
    hi = _tf32_rna(x)
    return torch.cat([hi, _tf32_rna(x - hi)], dim=1)


@dataclasses.dataclass(frozen=True)
class EntryTier:
    """What the entry top-1 reads of a tier, made once by
    :func:`entry_tier`."""
    rows: torch.Tensor            # (E, d) float32
    bias: torch.Tensor            # (E,) float32, entry_bias
    ids: torch.Tensor             # (E,) int32, the points' ids
    metric: Metric
    pack: Optional[torch.Tensor]  # (E, 2 dp) float32, entry_pack; on the card only


def entry_tier(evecs: torch.Tensor, ids: torch.Tensor, metric: Metric) -> EntryTier:
    """(E, d) entry vectors of any dtype and their (E,) point ids -> the
    tier's :class:`EntryTier`, on their device."""
    rows = evecs.float().contiguous()
    return EntryTier(rows, entry_bias(rows, metric), ids.to(torch.int32).contiguous(), metric,
                     entry_pack(rows) if rows.is_cuda else None)


def entry_top1_plain(q: torch.Tensor, evecs: torch.Tensor, ebias: torch.Tensor,
                     eids: torch.Tensor, *, metric: Metric) -> torch.Tensor:
    """The kernel's function in PyTorch -> (B, 1) start ids: one (B, E)
    float32 matmul and a row argmin (first index on ties)."""
    dot = q.float() @ evecs.float().T
    dist = -dot if metric is Metric.MIPS else ebias[None, :] - 2.0 * dot
    return eids[dist.argmin(dim=1)][:, None]


def grid(B: int, E: int, slots: int):
    """-> (R, T, G): row blocks of ``ROWS`` queries, tiles of ``ENTRY_TILE``
    entries a row block, and CTAs, one wave of at most ``slots`` (the CTAs
    the card holds at once) over the R T work items. With G != R some row
    block may be shared by several CTAs, which merge through the
    workspace."""
    R = -(-B // ROWS)
    T = -(-E // ENTRY_TILE)
    return R, T, max(1, min(R * T, slots))


def entry_top1(q: torch.Tensor, tier: EntryTier) -> torch.Tensor:
    """Nearest entry per query -> (B, 1) int32 ids ``tier.ids[argmin_j key]``.

    ``q`` (B, d) float32. CPU tensors run :func:`entry_top1_plain`; CUDA
    tensors launch the kernel over ``tier.pack`` (one launch, after a fill
    of its (B + R) workspace where row blocks are shared)."""
    if not _lib.route(q, tier.rows, tier.bias, tier.ids):
        return entry_top1_plain(q, tier.rows, tier.bias, tier.ids, metric=tier.metric)
    if tier.pack is None:
        raise ValueError("entry_top1: a tier on the card without its pack (entry_tier)")
    _lib.route(q, tier.pack)
    _lib.require(q, "q", torch.float32, 2)
    _lib.require(tier.pack, "pack", torch.float32, 2)
    _lib.require(tier.bias, "bias", torch.float32, 1)
    _lib.require(tier.ids, "ids", torch.int32, 1)
    B, d = q.shape
    E = tier.ids.shape[0]
    if (E == 0 or tier.rows.shape != (E, d) or tier.bias.shape != (E,)
            or tier.pack.shape != (E, 2 * (-(-d // PACK) * PACK)) or tier.pack.data_ptr() % 16):
        raise ValueError(f"q {tuple(q.shape)}, rows {tuple(tier.rows.shape)}, pack "
                         f"{tuple(tier.pack.shape)} at {tier.pack.data_ptr():#x}, bias "
                         f"{tuple(tier.bias.shape)}, ids {tuple(tier.ids.shape)}")
    if B == 0:
        return torch.empty((0, 1), dtype=torch.int32, device=q.device)
    R, _, G = grid(B, E, _slots(d, q.device))
    # one allocation: the (B,) int32 ids, then, 8-byte aligned, the (B + R)
    # 64-bit workspace where row blocks are shared
    off = B + (B & 1)
    buf = torch.empty((off + 2 * (B + R) if G != R else B,), dtype=torch.int32,
                      device=q.device)
    rc = _call()(q.data_ptr(), tier.pack.data_ptr(), tier.bias.data_ptr(), tier.ids.data_ptr(),
                 buf.data_ptr() + 4 * off if G != R else None, buf.data_ptr(), B, E, d, G,
                 -1.0 if tier.metric is Metric.MIPS else -2.0, _lib.stream())
    entry_top1.launches += 1
    _lib.check(rc, "entry_top1")
    return buf[:B, None]


entry_top1.launches = 0

_cache: dict = {}


def _call():
    """The C entry point, its argument types declared once."""
    if "fn" not in _cache:
        _cache["fn"] = _lib.function("pa_entry_top1", [_lib.VP] * 6 + [_lib.INT] * 4
                                        + [_lib.FLOAT, _lib.VP])
    return _cache["fn"]


def _slots(d: int, device: torch.device) -> int:
    """CTAs the card holds at once at dimension d (shared memory grows with
    d up to 128): the kernel's occupancy times the SM count, asked once per
    device and d."""
    key = (d, device.index)
    if key not in _cache:
        fn = _lib.function("pa_entry_top1_slots", [_lib.INT, ctypes.POINTER(ctypes.c_int)])
        blocks = ctypes.c_int(0)
        _lib.check(fn(d, ctypes.byref(blocks)), "entry_top1 occupancy")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _cache[key] = max(1, blocks.value) * sms
    return _cache[key]
