"""For an exact top-k: the widest gap between the j-th smallest float64
distance of the answered ids and the exact j-th distance, over the
well-formed answers, as a share of the query's exact k-th distance. An
exact scan reads 0 up to float32 near-ties; a scan below float32 swaps
neighbours whose distances differ by its rounding."""

import numpy as np


def compute(ctx) -> float:
    wf = ctx.well_formed
    if not wf.any():
        return float("inf")
    got = np.sort(ctx.d64[wf], axis=1)
    return float(((got - ctx.gt_d[wf]) / ctx.scale[wf, None]).max())
