"""Device milliseconds a batch of kernel 5's cluster walk (its activities
by name in the traced stretch)."""

from annbench.trace import name_matcher

UNIT, BETTER, SOURCE, TRACE = "ms", "lower", "device_trace", True
LAYER = "kernel 5 walk"
MOVES = "qps"
KERNELS = ("cluster_walk_regs", "cluster_walk_smem")


def read(run):
    t = run.trace
    if t is None:
        return None
    hit = name_matcher(KERNELS)
    s = sum(v for k, v in t.ops.items() if hit.search(k))
    return s / t.batches * 1e3 if s > 0 else None
