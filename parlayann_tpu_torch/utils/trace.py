"""Spans and counters of the port: where a search's or a build's time goes.

``span(name)`` marks a layer's work and ``count(name, value)`` attaches a
count to the innermost open span. Both do nothing unless the recorder is
on, which it is inside ``recording()`` or while a ``torch.profiler``
session records; off, a span costs one flag test and the profiler's own
test, and records and allocates nothing.

A recorded span holds its name, its id, its parent's id, the id of its
root (the outermost span of the call, shared by every span under it) and
its host start and end in ``time.time_ns()``, which is the profiler's
clock. While the profiler records, each span also opens a profiler range
of its name (``torch.profiler.record_function``'s, through the profiler's
low-cost binding where there is one), so the spans sit on the trace's
host timeline and the stamps fall inside their ranges.

A *timed* span holds its counters too, and, for work on a CUDA device
(``device=``, or its parent's), its stream time: CUDA events on the
device's current stream at its two ends, from the stream reaching the
span's first work to finishing its last, launch bubbles included. Inside
``recording()`` every span is timed. Under the profiler alone one root in
``SAMPLE`` is timed, with every span under it: an event costs the host
tens of microseconds on an H100's host, a host stamp a fraction of one. A counter keeps a
reference to its value (a device tensor stays on the device) and is
reduced only when read, so the hot path gains no launch and no host
synchronisation.

Spans stay in memory in a ring of ``CAPACITY`` spans: the oldest give way
and are counted as dropped. ``spans()``, read after the caller has
synchronised the device, resolves the events and counters.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Optional

import torch

CAPACITY = 1 << 14
SAMPLE = 16

_profiling = torch._C._autograd._profiler_enabled
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or \
    torch.profiler.record_function


class Span:
    """One recorded span; its own context manager. ``stream_ms`` is None
    where the span is not timed or has no CUDA device; ``self_ns`` and
    ``self_stream_ms`` (the span less what its children cover) and
    ``counters`` are filled by :func:`spans`."""

    end_ns = self_ns = 0
    stream_ms = self_stream_ms = _ev0 = _ev1 = None
    counters = _counts = ()

    def __init__(self, rec: "Recorder", name: str, device: Optional[torch.device],
                 ranged: bool):
        self.name, self._rec, self.device = name, rec, device
        self._range = _range(name) if ranged else None

    def __enter__(self) -> "Span":
        rec = self._rec
        stack = self._stack = rec._thread_stack()
        top = stack[-1] if stack else None
        self.id = next(rec._ids)
        if top is None:
            self.parent, self.root = None, self.id
            self.timed = rec.forced > 0 or next(rec._roots) % SAMPLE == 0
        else:
            self.parent, self.root, self.timed = top.id, top.root, top.timed
            if self.device is None:
                self.device = top.device
        if self._range is not None:
            self._range.__enter__()
        self.start_ns = time.time_ns()
        if self.timed and self.device is not None and self.device.type == "cuda":
            self._ev0 = _event(self.device)
        stack.append(self)
        rec._store(self)
        return self

    def __exit__(self, *exc) -> None:
        self._stack.pop()
        if self._ev0 is not None:
            self._ev1 = _event(self.device)
        self.end_ns = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    def _resolve(self) -> None:
        if self._ev1 is not None:
            self._ev1.synchronize()
            self.stream_ms = self._ev0.elapsed_time(self._ev1)
            self._ev0 = self._ev1 = None
        counters = dict(self.counters)
        for name, v in self._counts:
            v = v.sum().item() if isinstance(v, torch.Tensor) else v
            counters[name] = counters.get(name, 0) + v
        self.counters, self._counts = counters, ()


class Recorder:
    """The ring of recorded spans and the per-thread stack of open ones."""

    def __init__(self, capacity: int = CAPACITY):
        self.forced = 0  # open ``recording()`` blocks
        self.dropped = 0
        self._buf = collections.deque(maxlen=capacity)
        self._ids = itertools.count(1)
        self._roots = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()  # for ``forced``

    def _thread_stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _store(self, sp: Span) -> None:
        buf = self._buf
        if len(buf) == buf.maxlen:
            self.dropped += 1
        buf.append(sp)

    def on(self) -> bool:
        return self.forced > 0 or _profiling()

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def forget(self, after: int) -> None:
        """Take the spans with ids above ``after`` out of the ring."""
        kept = [sp for sp in self._buf if sp.id <= after]
        self._buf.clear()
        self._buf.extend(kept)

    def spans(self) -> list:
        """The closed spans in the order they opened, resolved (see the
        module's docstring); read while no other thread records."""
        done = [sp for sp in self._buf if sp.end_ns]
        kids = {}
        for sp in done:
            sp._resolve()
            kids.setdefault(sp.parent, []).append(sp)
        for sp in done:
            ch = kids.get(sp.id, ())
            covered, hi = 0, sp.start_ns
            for c in sorted(ch, key=lambda c: c.start_ns):
                lo, e = max(c.start_ns, hi), min(c.end_ns, sp.end_ns)
                if e > lo:
                    covered += e - lo
                    hi = e
            sp.self_ns = sp.host_ns - covered
            if sp.stream_ms is not None:
                sp.self_stream_ms = sp.stream_ms - sum(
                    c.stream_ms for c in ch if c.stream_ms is not None)
        return done


RECORDER = Recorder()
_OFF = contextlib.nullcontext()


def _event(device: torch.device):
    """A timing CUDA event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def span(name: str, device: Optional[torch.device] = None):
    """A context manager over a layer's work: a :class:`Span` when the
    recorder is on, else a no-op that gives None."""
    profiling = _profiling()
    if not (RECORDER.forced or profiling):
        return _OFF
    return Span(RECORDER, name, device, profiling)


def count(name: str, value) -> None:
    """Add ``value`` (a number, or a tensor summed when read) to the
    counter ``name`` of the innermost open span, if it is timed."""
    if not (RECORDER.forced or _profiling()):
        return
    stack = RECORDER._thread_stack()
    if stack and stack[-1].timed:
        top = stack[-1]
        top._counts = (*top._counts, (name, value))


@contextlib.contextmanager
def recording(keep: bool = True):
    """Record and time every span inside the block, profiler or not.
    ``keep=False``: the block's spans leave the ring when it ends, unless
    the recorder was on before it (for a caller that reads only the spans
    it holds)."""
    drop = not (keep or RECORDER.on())
    mark = next(RECORDER._ids)
    with RECORDER._lock:
        RECORDER.forced += 1
    try:
        yield
    finally:
        with RECORDER._lock:
            RECORDER.forced -= 1
        if drop:
            RECORDER.forget(mark)


def on() -> bool:
    return RECORDER.on()


def spans() -> list:
    return RECORDER.spans()


def clear() -> None:
    RECORDER.clear()


def dropped() -> int:
    return RECORDER.dropped
