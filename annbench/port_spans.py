"""The port's own spans in a ``--trace 1`` run, for the readers of the
per-layer metrics that the program records (``parlayann_tpu_torch/utils/
trace.py``, on while the profiler records, one root span in its
``SAMPLE`` timed: stream times and counters).

Each traced attempt dispatches ``run.trace.batches`` batches, each a root
``search`` span: one to three attempts of the first stretch (the profiler
is asked again when it saw no device activity), the device traced alone,
then one to three of the second. A checkout of the port without the
recorder, or a run that recorded no span, gives None.
"""

from __future__ import annotations


def _first_stretch_roots(roots, batches: int, wall_s: float) -> list:
    """The first stretch's roots: of the groups of ``batches`` roots that
    can be its last attempt (one to three groups follow it), the one whose
    host extent, first start to last end, is nearest the stretch's wall
    seconds; the earliest of equals, since a discarded attempt of the
    first stretch ran as the kept one did, the device traced alone."""
    g = len(roots) // batches
    groups = [roots[len(roots) - (g - i) * batches:][:batches] for i in range(g)]
    if g < 2:
        return groups[0] if groups else []
    return min(groups[max(0, g - 4):g - 1],
               key=lambda r: abs((r[-1].end_ns - r[0].start_ns) * 1e-9 - wall_s))


def first_stretch(run):
    """-> (the timed root ``search`` spans of the first traced stretch, the
    spans directly under them), None if there are none."""
    t = run.trace
    if t is None:
        return None
    try:
        from parlayann_tpu_torch.utils import trace
    except ImportError:
        return None
    spans = trace.spans()
    roots = [s for s in spans if s.name == "search" and s.parent is None]
    roots = [s for s in _first_stretch_roots(roots, t.batches, t.wall_s) if s.timed]
    if not roots:
        return None
    ids = {s.id for s in roots}
    return roots, [s for s in spans if s.parent in ids]


def stream_ms_a_batch(run, name: str):
    """Stream milliseconds a batch of the child spans ``name`` (0 where a
    batch ran none), None where no child has a stream time (no card)."""
    got = first_stretch(run)
    if got is None:
        return None
    roots, kids = got
    timed = [s for s in kids if s.stream_ms is not None]
    if not timed:
        return None
    return sum(s.stream_ms for s in timed if s.name == name) / len(roots)
