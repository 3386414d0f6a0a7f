"""The widest gap between an answered distance and the reference's
float64 distance of the same id, over the well-formed answers, as a share
of the query's exact k-th distance. It catches an id or a distance
altered where it is produced, and a rerank computed below float32."""

import numpy as np


def compute(ctx) -> float:
    wf = ctx.well_formed
    if not wf.any():
        return float("inf")
    err = np.abs(ctx.dists[wf].astype(np.float64) - ctx.d64[wf]) / ctx.scale[wf, None]
    return float(err.max())
