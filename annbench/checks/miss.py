"""1 - tie-aware recall@k of the pool's answers against the exact ground
truth. It catches a walk that stops short, answers left out, and a graph
that does not lead to the neighbours."""


def compute(ctx) -> float:
    return 1.0 - ctx.recall
