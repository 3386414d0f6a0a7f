"""Queries answered in the window over the window's seconds (first
dispatch to the last results on the host)."""

UNIT, BETTER, SOURCE, TRACE = "queries/s", "higher", "host_clock", False
LAYER, MOVES = None, None


def read(run):
    w = run.window
    return w.queries / w.seconds if w.seconds > 0 and w.queries else None
