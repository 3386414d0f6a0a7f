"""The program's scalar tier against the reference's, recomputed from the
points: levels that differ (over the n valid rows), plus one for a slope
and one for an offset that differ. Exact: limit 0."""

import torch

from annbench.reference import quant


def compute(ctx) -> float:
    st = ctx.state
    bits = st["bits"]
    levels, slope, lo = quant.scalar_tier(ctx.points, ctx.n, bits)
    shift = 128 if bits <= 8 else 32768  # the port stores level - shift
    got = st["tier"][:ctx.n].to(torch.int32) + shift
    off = int((got != levels[:ctx.n].to(torch.int32)).sum())
    off += int(float(st["slope"]) != float(slope)) + int(float(st["offset"]) != float(lo))
    return float(off)
