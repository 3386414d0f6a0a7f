"""Tie-aware recall@k, the cell's k, of the answers to every query of the
pool against the reference's exact ground truth. The benchmark computes
it itself after the window."""

UNIT, BETTER, SOURCE, TRACE = "ratio", "higher", "host_clock", False
LAYER, MOVES = None, None


def read(run):
    return run.recall
