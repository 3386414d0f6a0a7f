"""Seconds from the start of the run's module to the end of the warm-up:
imports, loading (and in a checkout's first run, building) the kernel
library, drawing the data, building the index and warming up."""

UNIT, BETTER, SOURCE, TRACE = "s", "lower", "host_clock", False
LAYER, MOVES = None, None


def read(run):
    return run.spans["setup_s"]
