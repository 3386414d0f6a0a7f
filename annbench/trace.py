"""The traced stretch of a ``--trace 1`` run, read from ``torch.profiler``.

Two stretches of whole batches run back to back inside the window, each
with the loop drained before and after. The first traces device activity
only: its busy time (the union of the device's activities), its wall time
and the device seconds of each activity by name give the per-layer device
metrics, with no host tracing to slow the host down. The second traces
the host too, with the client's steps labelled, and names each idle gap
of the device by what the host was doing then. The port's own kernels are
the ``__global__`` functions of its CUDA sources.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import re
import time
from pathlib import Path

import numpy as np
import torch

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")


def port_kernel_names(package: str = "parlayann_tpu_torch") -> frozenset:
    """Names of the ``__global__`` functions in the port's CUDA sources."""
    spec = importlib.util.find_spec(package)
    if spec is None or spec.origin is None:
        return frozenset()
    names = set()
    for src in sorted((Path(spec.origin).parent / "csrc").glob("*.cu*")):
        names.update(_GLOBAL.findall(src.read_text()))
    return frozenset(names)


def name_matcher(names) -> re.Pattern:
    """A pattern that finds any of ``names`` as a whole word in an
    activity's (demangled) name."""
    if not names:
        return re.compile(r"(?!)")
    return re.compile(r"\b(?:" + "|".join(sorted(map(re.escape, names))) + r")\b")


@dataclasses.dataclass
class Trace:
    wall_s: float  # the fenced stretch on the host clock
    busy_s: float  # seconds in which some activity ran on the device
    batches: int
    ops: dict  # device seconds by activity name
    gaps: dict  # idle seconds of the device by what the host was doing
    port: frozenset  # the port's kernel names
    first: int = 0  # the stretch's batches in the window's dispatch list
    last: int = 0


def merged(spans):
    """Sorted (start, end) spans -> the union as a list of disjoint spans."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def busy(spans) -> float:
    return float(sum(hi - lo for lo, hi in merged(spans)))


def name_gaps(device_spans, host_events) -> dict:
    """Idle gaps between the device's activities, summed by what the host
    was doing at each gap's middle: the innermost host event there, under
    the client's label (``annbench.dispatch`` / ``annbench.wait``) that
    holds it. ``host_events``: (start, end, name)."""
    union = merged(device_spans)
    if len(union) < 2 or not host_events:
        return {}
    hs = np.array([e[0] for e in host_events], dtype=np.float64)
    he = np.array([e[1] for e in host_events], dtype=np.float64)
    names = [e[2] for e in host_events]
    labels = [i for i, n in enumerate(names) if n.startswith("annbench.")]
    out = {}
    for (_, g0), (g1, _) in zip(union[:-1], union[1:]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        inside = np.nonzero((hs <= mid) & (he >= mid))[0]
        if inside.size == 0:
            key = "(no host event)"
        else:
            inner = inside[np.argmin(he[inside] - hs[inside])]
            outer = [i for i in labels if hs[i] <= mid <= he[i]]
            key = names[inner]
            if outer and outer[0] != inner:
                key = f"{names[outer[0]]} > {key}"
        out[key] = out.get(key, 0.0) + (g1 - g0)
    return out


def _profile(fn, device, activities, attempts=3):
    """Run ``fn`` under the profiler -> (events, wall seconds), None if the
    profiler saw no device activity ``attempts`` times in a row (it now and
    then returns a window with no device events although kernels ran)."""
    from torch.profiler import profile

    for _ in range(attempts):
        torch.cuda.synchronize(device)
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            wall = time.perf_counter() - t0
        events = list(prof.events())
        if any(e.device_type == torch.autograd.DeviceType.CUDA for e in events):
            return events, wall
    return None


def _spans(events, device: bool):
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    return [(e.time_range.start * 1e-6, e.time_range.end * 1e-6, e.name)
            for e in events if e.device_type == kind]


def trace_stretch(loop, batches: int, device) -> Trace | None:
    """Trace ``batches`` batches of ``loop`` twice (see the module's
    docstring) -> a Trace, None if the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity

    first = len(loop.dispatch)
    got = _profile(lambda: loop.pump(count=batches), device, [ProfilerActivity.CUDA])
    if got is None:
        return None
    events, wall = got
    dev = _spans(events, device=True)
    ops = {}
    for lo, hi, name in dev:
        ops[name] = ops.get(name, 0.0) + (hi - lo)
    loop.labels = True
    try:
        got2 = _profile(lambda: loop.pump(count=batches), device,
                        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    finally:
        loop.labels = False
    last = len(loop.dispatch)
    gaps = {}
    if got2 is not None:
        ev2 = got2[0]
        gaps = name_gaps([(lo, hi) for lo, hi, _ in _spans(ev2, device=True)],
                         _spans(ev2, device=False))
    return Trace(wall_s=wall, busy_s=busy([(lo, hi) for lo, hi, _ in dev]),
                 batches=batches, ops=ops, gaps=gaps, port=port_kernel_names(),
                 first=first, last=last)


def top(d: dict, n: int = 10, width: int = 160) -> list:
    """The ``n`` largest entries of a {name: seconds} dict as [[name, s]]."""
    return [[k[:width], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
