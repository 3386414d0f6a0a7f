"""The exact scan's share of its roofline: the least time the card could
take for a batch (``peaks.flat_scan_bound_s``: 2 B N d operations at the
TF32 rate or the bytes over the memory rate, the larger) over the device's
busy time a batch in the traced stretch. It takes the busy time, not a
kernel's name, so it reads the same work whatever implements the scan."""

from annbench import peaks

UNIT, BETTER, SOURCE, TRACE = "%", "higher", "device_trace", True
LAYER = "kernel 4 scan"
MOVES = "qps"


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    data, trf = run.cell.config["data"], run.cell.traffic
    b = peaks.flat_scan_bound_s(trf["batch"], data["n"], data["d"], trf["k"])
    return 100.0 * b / (t.busy_s / t.batches)
