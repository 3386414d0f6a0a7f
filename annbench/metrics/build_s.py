"""The fenced seconds of the index build in set-up: the benchmark's span
around ``api.build_vamana_index``."""

UNIT, BETTER, SOURCE, TRACE = "s", "lower", "host_clock", True
LAYER = "Vamana build"
MOVES = "setup_s"


def read(run):
    return run.spans.get("build_s")
