"""One reader a metric: ``UNIT``, ``BETTER``, ``LAYER`` (per-layer
metrics), ``MOVES``, ``SOURCE``, ``TRACE`` (read in the ``--trace 1``
run) and ``read(run) -> float | None``; None leaves the metric out of the
line."""
