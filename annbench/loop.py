"""The closed loop that feeds the index during the measured window.

A client cycles through the query pool in fixed batches and keeps
``in_flight`` batches dispatched: it calls the search of batch i + 1, and
enqueues its copy to pinned host memory, before it waits for batch i's
results. A batch's latency runs from the call that dispatches it to the
moment its results are on the host. Each pool slot has its own host
buffers, so the last answers of every slot that was answered stay there
for the check after the window.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch


def slots(pool, batch: int) -> list:
    """The pool cut into batches (views), in order."""
    return [pool[i:i + batch] for i in range(0, pool.shape[0], batch)]


@dataclasses.dataclass
class Window:
    seconds: float  # first dispatch to the last results on the host
    batches: int
    queries: int
    latencies: list  # seconds a batch, dispatch to results on the host
    dispatch: list  # host seconds inside the search call, a batch
    answered: set  # pool slots whose last answers are in the host buffers


class ClosedLoop:
    """``search(queries) -> (ids, dists)`` over ``batches`` (the pool in
    slots), ``in_flight`` batches deep, on ``device``."""

    def __init__(self, search, batches, device: torch.device, in_flight: int):
        if in_flight < 1:
            raise ValueError("in_flight must be at least 1")
        self.search, self.batches, self.depth = search, batches, in_flight
        self.cuda = device.type == "cuda"
        self.host = None
        self.labels = False  # profiler labels around the client's steps
        self.reset()

    def reset(self):
        self.i = 0
        self.pending = collections.deque()
        self.latencies, self.dispatch, self.answered = [], [], set()
        self.queries = 0
        self.last = None
        for hi, hd in self.host or ():
            hi.fill_(-1)
            hd.fill_(float("nan"))

    def _label(self, name):
        if self.labels:
            return torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def _buffers(self, ids, dists):
        pin = self.cuda
        # a slot never answered reads as ids -1 and NaN distances
        self.host = [(torch.full(ids.shape, -1, dtype=ids.dtype, pin_memory=pin),
                      torch.full(dists.shape, float("nan"), dtype=dists.dtype,
                                 pin_memory=pin))
                     for _ in self.batches]

    def _dispatch(self):
        slot = self.i % len(self.batches)
        with self._label("annbench.dispatch"):
            t0 = time.perf_counter()
            ids, dists = self.search(self.batches[slot])
            t1 = time.perf_counter()
            if self.host is None:
                self._buffers(ids, dists)
            hi, hd = self.host[slot]
            hi.copy_(ids, non_blocking=self.cuda)
            hd.copy_(dists, non_blocking=self.cuda)
            ev = None
            if self.cuda:
                ev = torch.cuda.Event()
                ev.record()
        self.pending.append((slot, t0, ev))
        self.dispatch.append(t1 - t0)
        self.i += 1

    def _complete(self):
        slot, t0, ev = self.pending.popleft()
        with self._label("annbench.wait"):
            if ev is not None:
                ev.synchronize()
        self.last = time.perf_counter()
        self.latencies.append(self.last - t0)
        self.queries += self.batches[slot].shape[0]
        self.answered.add(slot)

    def pump(self, *, until: float | None = None, count: int | None = None):
        """Dispatch until the host clock passes ``until`` or ``count``
        batches went out, keeping the loop full; then drain it."""
        sent = 0
        while True:
            go = (time.perf_counter() < until) if count is None else sent < count
            if go:
                self._dispatch()
                sent += 1
                if len(self.pending) < self.depth:
                    continue
            if not self.pending:
                return
            self._complete()

    def window(self, seconds: float, during=None) -> Window:
        """Run the loop for ``seconds``; ``during(self)``, if given, is
        called once at 40% of the window with the loop drained (the traced
        stretch)."""
        self.reset()
        t0 = time.perf_counter()
        if during is None:
            self.pump(until=t0 + seconds)
        else:
            self.pump(until=t0 + 0.4 * seconds)
            during(self)
            self.pump(until=t0 + seconds)
        end = self.last if self.last is not None else time.perf_counter()
        return Window(seconds=end - t0, batches=len(self.latencies),
                      queries=self.queries, latencies=self.latencies,
                      dispatch=self.dispatch, answered=set(self.answered))

    def answers(self):
        """(ids, dists) of the whole pool as numpy arrays, from the host
        buffers."""
        ids = np.concatenate([h[0].numpy() for h in self.host])
        dists = np.concatenate([h[1].numpy() for h in self.host])
        return ids, dists
