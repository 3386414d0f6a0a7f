"""Stream milliseconds a batch of the port's ``search.pool`` span over the
first traced stretch's timed batches: the sort of the cluster walk's
point pool by (distance, id), launch bubbles included."""

from annbench.port_spans import stream_ms_a_batch

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "program_span", True
LAYER = "pool sort"
MOVES = "qps"


def read(run):
    return stream_ms_a_batch(run, "search.pool")
