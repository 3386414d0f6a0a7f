"""Stream milliseconds a batch of the port's ``search.rerank`` span over
the first traced stretch's timed batches: the float32 rerank of the
walk's pool (the gather, the distances and the top-k), launch bubbles
included."""

from annbench.port_spans import stream_ms_a_batch

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "program_span", True
LAYER = "search glue: rerank"
MOVES = "qps"


def read(run):
    return stream_ms_a_batch(run, "search.rerank")
