"""Stream milliseconds a batch of the port's ``search.entry`` span over
the first traced stretch's timed batches: the entry top-1 (the (B, E)
product against the sampled entry tier and its argmin), launch bubbles
included."""

from annbench.port_spans import stream_ms_a_batch

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "program_span", True
LAYER = "search glue: entry top-1"
MOVES = "qps"


def read(run):
    return stream_ms_a_batch(run, "search.entry")
