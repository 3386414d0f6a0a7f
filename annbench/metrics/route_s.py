"""Stream seconds of the ClusterIndex build's routed assigns in set-up:
the port's ``build.assign`` spans (each round's and the final assignment
of the points to their nearest centroids), which the adapter records
around the build."""

UNIT, BETTER, SOURCE, TRACE = "s", "lower", "program_span", True
LAYER = "build: routed assigns"
MOVES = "setup_s"


def read(run):
    return run.spans.get("route_s")
