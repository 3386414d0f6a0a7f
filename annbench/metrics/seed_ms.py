"""Stream milliseconds a batch of the port's ``search.seed`` span over the
first traced stretch's timed batches: the cluster search's seed (the scan
of the seed quantizer's meta-centroids, kernel 1's multi-probe mode over
the nearest cells' blocks and the top-S select), launch bubbles
included."""

from annbench.port_spans import stream_ms_a_batch

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "program_span", True
LAYER = "meta seed"
MOVES = "qps"


def read(run):
    return stream_ms_a_batch(run, "search.seed")
