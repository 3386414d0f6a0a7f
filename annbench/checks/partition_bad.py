"""Faults of the program's ClusterIndex structure (``reference/cluster.py``
``faults``): the membership not a partition of the points, -1 padding
inside a row, an empty cluster that the seed or the adjacency reaches,
adjacency ids out of range, to the row itself or repeated, and a seed
quantizer whose cells are not a partition of the centroids or hold other
rows than the centroids they name. Exact: limit 0."""

from annbench.reference import cluster


def compute(ctx) -> float:
    return float(cluster.faults(ctx.state, ctx.n))
