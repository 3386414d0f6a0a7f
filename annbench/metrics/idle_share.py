"""The share of the first traced stretch's fenced wall time in which no
activity ran on the device."""

UNIT, BETTER, SOURCE, TRACE = "%", "lower", "device_trace", True
LAYER = "device (H100)"
MOVES = "qps"


def read(run):
    t = run.trace
    if t is None or t.wall_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
