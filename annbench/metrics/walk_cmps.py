"""Kernel 3's distance computations a query over the first traced
stretch's timed batches: the ``cmps`` counter of the port's
``search.walk`` spans over the ``queries`` counter of their ``search``
roots."""

from annbench.port_spans import first_stretch

UNIT, BETTER, SOURCE, TRACE = "cmps/query", "lower", "program_counter", True
LAYER = "kernel 3 walk"
MOVES = "qps"


def read(run):
    got = first_stretch(run)
    if got is None:
        return None
    roots, kids = got
    cmps = sum(s.counters.get("cmps", 0) for s in kids if s.name == "search.walk")
    queries = sum(s.counters.get("queries", 0) for s in roots)
    return cmps / queries if cmps and queries else None
