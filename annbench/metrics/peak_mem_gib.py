"""``torch.cuda.max_memory_allocated()`` from the start of the process to
the end of the window (build and search), read before the reference runs."""

UNIT, BETTER, SOURCE, TRACE = "GiB", "lower", "host_clock", False
LAYER, MOVES = None, None


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
