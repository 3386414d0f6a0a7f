"""Answers that are not k distinct ids of the points with finite
distances in nondecreasing order, counted by query. Exact: limit 0."""


def compute(ctx) -> float:
    return float((~ctx.well_formed).sum())
