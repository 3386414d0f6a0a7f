"""Stream seconds of the ClusterIndex build's polish in set-up: the port's
``build.polish`` span (the exact rescan of the worst-placed points and
their moves), which the adapter records around the build."""

UNIT, BETTER, SOURCE, TRACE = "s", "lower", "program_span", True
LAYER = "build: polish"
MOVES = "setup_s"


def read(run):
    return run.spans.get("polish_s")
