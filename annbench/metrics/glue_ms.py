"""Device milliseconds a batch of every activity in the traced stretch
that is not one of the port's own CUDA kernels: PyTorch's kernels (the
entry top-1's product and argmin, the query translation, the rerank's
gather and top-k, sorts), copies and memsets."""

from annbench.trace import name_matcher

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "device_trace", True
LAYER = "search glue"
MOVES = "qps"


def read(run):
    t = run.trace
    if t is None:
        return None
    port = name_matcher(t.port)
    s = sum(v for k, v in t.ops.items() if not port.search(k))
    return s / t.batches * 1e3 if s > 0 else None
