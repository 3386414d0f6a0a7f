"""Faults of the program's adjacency (``reference/graph.py``): a degree
outside [1, R], and out-edges out of range, to the vertex itself or
repeated. Exact: limit 0."""

from annbench.reference import graph


def compute(ctx) -> float:
    st = ctx.state
    return float(graph.faults(st["nbrs"], st["degs"], ctx.n, st["R"]))
