"""The 95th percentile (linear interpolation) of every batch's latency in
the window, from the call that dispatches it to its results on the host."""

import numpy as np

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "host_clock", False
LAYER, MOVES = None, None


def read(run):
    lat = run.window.latencies
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
