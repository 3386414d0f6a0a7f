"""Host milliseconds a batch inside the search call until it returns
(the benchmark's span around the call), summed over the window's batches
outside the traced stretches and divided by their count. It shows the
cost of enqueueing a batch and any host synchronisation inside the call."""

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "host_clock", True
LAYER = "Index API, host side"
MOVES = "qps"


def read(run):
    d = run.window.dispatch
    t = run.trace
    if t is not None:
        d = d[:t.first] + d[t.last:]
    return sum(d) / len(d) * 1e3 if d else None
