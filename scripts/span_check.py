"""Hold the port's spans to the profiler on the card, in one benchmark cell.

    python3 scripts/span_check.py --workload <cell> --seed <n>

Sets the cell up as ``annbench.run`` does (points, queries and index from
the seed, the warm-up), then traces ``trace_batches`` batches of the
closed loop twice, as the benchmark's two stretches do:

- the device traced alone: wall and busy ms a batch; the readers of the
  spans (``entry_ms``, ``rerank_ms``, ``walk_cmps``) and ``walk_ms``; per
  span name, the stream ms a timed batch and the host self ms a batch;
  the search root's children's stream ms over the wall ms a batch;
- host and device traced: the share of spans whose ``time_ns`` stamps lie
  within 20 us of their profiler ranges, and the share of idle-gap
  seconds keyed by a span.

In both, each span's device extent in the trace (the first start to the
last end of the device activities whose launches fall inside it) is set
beside the stream ms of the timed spans. Last, the host us a batch of a
q8 search's spans: off, inside ``recording()`` and under a profiler that
traces the device alone. Prints one JSON object.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from annbench import data, loop, run, spec  # noqa: E402
from annbench import trace as atrace  # noqa: E402
from parlayann_tpu_torch.utils import trace  # noqa: E402

TOL_NS = 20_000
CUDA = torch.autograd.DeviceType.CUDA


def _stretch(lp, batches, dev, activities):
    """Trace ``batches`` batches -> (this stretch's spans, kineto events,
    wall seconds)."""
    trace.clear()
    torch.cuda.synchronize(dev)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        lp.pump(count=batches)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    return trace.spans(), list(prof.profiler.kineto_results.events()), wall


def _extents(spans, events):
    """{span id: device ms from the first start to the last end of the
    device activities launched inside the span}, from the correlation of
    each launch (a runtime call on the host) to its activity."""
    dev = {}
    for e in events:
        if e.device_type() == CUDA:
            dev.setdefault(e.correlation_id(), []).append((e.start_ns(), e.end_ns()))
    calls = sorted((e.start_ns(), e.correlation_id()) for e in events
                   if e.device_type() != CUDA and e.correlation_id() in dev)
    starts = [c[0] for c in calls]
    out = {}
    for s in spans:
        lo, hi = bisect.bisect_left(starts, s.start_ns), bisect.bisect_right(starts, s.end_ns)
        acts = [a for _, corr in calls[lo:hi] for a in dev[corr]]
        if acts:
            out[s.id] = (max(a[1] for a in acts) - min(a[0] for a in acts)) * 1e-6
    return out


def _per_name(spans, roots, ext):
    """Per span name under the roots: host self ms a batch, stream ms a
    timed batch, and the trace's extent ms a batch and a timed batch."""
    ids = {r.id for r in roots}
    timed = {r.id for r in roots if r.timed}
    out = {}
    for s in spans:
        if s.root not in ids:
            continue
        o = out.setdefault(s.name, dict(host_self_ms=0.0, stream_ms=0.0, extent_ms=0.0,
                                        extent_timed_ms=0.0, counters={}))
        o["host_self_ms"] += s.self_ns * 1e-6 / len(roots)
        o["extent_ms"] += ext.get(s.id, 0.0) / len(roots)
        if s.root in timed:
            o["stream_ms"] += (s.stream_ms or 0.0) / len(timed)
            o["extent_timed_ms"] += ext.get(s.id, 0.0) / len(timed)
            for k, v in s.counters.items():
                o["counters"][k] = o["counters"].get(k, 0) + v / len(timed)
    return out


def _clock(spans, events):
    """Share of ``spans`` within TOL_NS of their profiler ranges (matched
    by name in order), and the worst miss in ns."""
    names = {s.name for s in spans}
    ranges = {}
    for e in events:
        if e.name() in names and e.device_type() != CUDA:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    for v in ranges.values():
        v.sort()
    seen, ok, worst = {}, 0, 0
    for s in sorted(spans, key=lambda s: s.start_ns):
        i = seen.get(s.name, 0)
        seen[s.name] = i + 1
        if i < len(ranges.get(s.name, ())):
            lo, hi = ranges[s.name][i]
            miss = max(abs(s.start_ns - lo), abs(hi - s.end_ns))
            worst = max(worst, miss)
            ok += miss <= TOL_NS
    return {"spans": len(spans), "within_20us": ok / max(len(spans), 1), "worst_ns": worst}


def _batch_of_spans(device, x):
    """The spans and counters of one q8 search, with no work inside."""
    with trace.span("search"):
        trace.count("queries", 1)
        for name in ("search.entry", "search.translate", "search.walk", "search.rerank"):
            with trace.span(name, device):
                if name == "search.walk":
                    trace.count("visits", x)
                    trace.count("cmps", x)


def _host_cost(device):
    """Host us a batch of a q8 search's spans: off, recording, and under a
    profiler tracing the device alone (one root in SAMPLE timed)."""
    x = torch.zeros(4, device=device)
    out = {}
    modes = (("off_us", contextlib.nullcontext, 20_000),
             ("recording_us", trace.recording, 2_000),
             ("cuda_profiler_us", lambda: profile(activities=[ProfilerActivity.CUDA]), 4_000))
    for label, ctx, n in modes:
        with ctx():
            for _ in range(64):
                _batch_of_spans(device, x)
            torch.cuda.synchronize(device)
            t = time.perf_counter_ns()
            for _ in range(n):
                _batch_of_spans(device, x)
            out[label] = (time.perf_counter_ns() - t) / n * 1e-3
            torch.cuda.synchronize(device)
        trace.clear()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    dev = torch.device("cuda", 0)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    cfg, trf = cell.config, cell.traffic
    points, pool = data.make(cfg, trf["pool"], args.seed, dev)
    system = spec.system(cfg["index"]).System(cfg, points, args.seed, {})
    lp = loop.ClosedLoop(system.searcher(trf), loop.slots(pool, trf["batch"]), dev,
                         trf["in_flight"])
    lp.pump(count=trf["warmup_batches"])
    b = trf["trace_batches"]
    out = {"cell": args.workload, "seed": args.seed, "batches": b,
           "card": torch.cuda.get_device_name(dev), "power_limit_w": run.power_limit_w()}

    spans, events, wall = _stretch(lp, b, dev, [ProfilerActivity.CUDA])
    acts = [(e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name()) for e in events
            if e.device_type() == CUDA]
    ops = {}
    for lo, hi, name in acts:
        ops[name] = ops.get(name, 0.0) + (hi - lo)
    t = atrace.Trace(wall_s=wall, busy_s=atrace.busy([a[:2] for a in acts]), batches=b,
                     ops=ops, gaps={}, port=atrace.port_kernel_names())
    r = run.Run(cell=cell, spans={}, window=None, trace=t, recall=None, peak_bytes=0)
    out["metrics"] = {m: spec.metric(m).read(r) for m in
                      ("entry_ms", "rerank_ms", "walk_cmps", "walk_ms", "glue_ms",
                       "idle_share")}
    roots = [s for s in spans if s.name == "search" and s.parent is None]
    out["roots"], out["timed_roots"] = len(roots), sum(s.timed for s in roots)
    out["wall_ms_a_batch"], out["busy_ms_a_batch"] = wall * 1e3 / b, t.busy_s * 1e3 / b
    per = _per_name(spans, roots, _extents(spans, events))
    out["device_alone"] = per
    kids = ("search.entry", "search.translate", "search.walk", "search.rerank")
    out["children_stream_cover"] = (sum(per.get(n, {}).get("stream_ms", 0.0) for n in kids)
                                    / out["wall_ms_a_batch"])
    out["children_extent_cover"] = (sum(per.get(n, {}).get("extent_ms", 0.0) for n in kids)
                                    / out["wall_ms_a_batch"])

    lp.labels = True
    spans2, events2, wall2 = _stretch(lp, b, dev, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    lp.labels = False
    roots2 = [s for s in spans2 if s.name == "search" and s.parent is None]
    out["host_traced"] = _per_name(spans2, roots2, _extents(spans2, events2))
    out["host_traced_wall_ms_a_batch"] = wall2 * 1e3 / b
    out["clock"] = _clock(spans2, events2)
    gaps = atrace.name_gaps(
        [(e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in events2 if e.device_type() == CUDA],
        [(e.start_ns() * 1e-9, e.end_ns() * 1e-9, e.name()) for e in events2
         if e.device_type() != CUDA])
    names = {s.name for s in spans2}
    total = sum(gaps.values())
    named = sum(v for k, v in gaps.items() if any(p.strip() in names for p in k.split(">")))
    out["gap_s"], out["gap_share_named_by_span"] = total, (named / total if total else None)
    out["gaps"] = atrace.top(gaps, 12)
    out["host_cost"] = _host_cost(dev)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
