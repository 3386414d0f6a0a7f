"""The port's span recorder (``utils/trace.py``) on the CPU: off by
default and free when off, on inside ``recording()`` or a profiler
session, the span tree and its self times, the capacity bound, the shared
clock with the profiler, and searches and builds that give the same
results recorded or not."""

import itertools
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import parlayann_tpu_torch as pt
from parlayann_tpu_torch.build import vamana
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.types import BuildParams
from parlayann_tpu_torch.utils import synthetic, trace

torch.set_num_threads(1)
SEARCH = ("search.entry", "search.translate", "search.walk", "search.rerank")


@pytest.fixture()
def rec():
    """An empty recorder, off."""
    assert not trace.on()
    trace.clear()
    yield trace.RECORDER
    trace.clear()


@pytest.fixture(scope="module")
def built():
    X, Q = synthetic.clustered(1200, 16, n_queries=40, n_clusters=16,
                               cluster_std=0.35, seed=7)
    graph, ps, _ = pt.build_vamana_index(X, R=16, L=32, alpha=1.2, device="cpu")
    return X, Q, graph, ps


def _tree(sp_list):
    """{root id: [(name, parent's name), ...]} in the order the spans opened."""
    by_id = {s.id: s for s in sp_list}
    out = {}
    for s in sp_list:
        parent = by_id[s.parent].name if s.parent is not None else None
        out.setdefault(s.root, []).append((s.name, parent))
    return out


def test_off_records_and_allocates_nothing(rec, built):
    X, Q, graph, ps = built
    idx = pt.Index(points=ps, graph=graph).enable_quantized(bits=8)
    idx.batch_search(Q, k=5, beam_size=16)
    assert trace.spans() == [] and trace.dropped() == 0
    assert trace.span("a") is trace.span("b")  # one shared no-op
    with trace.span("a") as sp:
        trace.count("n", torch.ones(3))
    assert sp is None and trace.spans() == []
    blocks = [0, 0, 0]
    for i in range(3):
        before = sys.getallocatedblocks()
        for _ in itertools.repeat(None, 2000):
            with trace.span("x"):
                trace.count("n", 1)
        blocks[i] = sys.getallocatedblocks() - before
    assert min(blocks) <= 0, blocks


def test_nesting_ids_counters_and_self_time(rec):
    with trace.recording():
        with trace.span("outer") as a:
            time.sleep(0.002)
            with trace.span("inner") as b:
                trace.count("n", torch.tensor([2, 3]))
                trace.count("n", 4)
                time.sleep(0.003)
            with trace.span("inner2") as c:
                time.sleep(0.001)
        with trace.span("next") as d:
            pass
        trace.count("orphan", 1)  # no span open: dropped silently
    assert not trace.on()
    got = trace.spans()
    assert [s.name for s in got] == ["outer", "inner", "inner2", "next"]
    assert (b.parent, c.parent, a.parent, d.parent) == (a.id, a.id, None, None)
    assert {s.root for s in (a, b, c)} == {a.id} and d.root == d.id
    assert b.counters == {"n": 9} and a.counters == {} and d.counters == {}
    assert a.start_ns <= b.start_ns < b.end_ns <= c.start_ns < c.end_ns <= a.end_ns
    assert a.self_ns == a.host_ns - b.host_ns - c.host_ns
    assert b.self_ns == b.host_ns and b.host_ns >= 3_000_000
    assert a.stream_ms is None  # no CUDA device


def test_on_under_the_profiler_only(rec):
    assert not trace.on()
    with profile(activities=[ProfilerActivity.CPU]):
        assert trace.on()
        with trace.span("profiled") as sp:
            pass
    assert not trace.on()
    with trace.span("after") as off:
        pass
    assert off is None and [s.name for s in trace.spans()] == ["profiled"]
    assert sp.end_ns > 0


def test_capacity_bound_and_drop_count(rec, monkeypatch):
    monkeypatch.setattr(trace, "RECORDER", trace.Recorder(capacity=3))
    with trace.recording():
        held = []
        for i in range(5):
            with trace.span(f"s{i}") as sp:
                held.append(sp)
    assert [s.name for s in trace.spans()] == ["s2", "s3", "s4"]  # the oldest give way
    assert trace.dropped() == 2
    assert held[0].end_ns >= held[0].start_ns > 0  # a dropped span still times itself
    trace.clear()
    assert trace.spans() == [] and trace.dropped() == 0


def test_exception_closes_the_span(rec):
    with trace.recording():
        with pytest.raises(ValueError):
            with trace.span("fails"):
                raise ValueError("boom")
        with trace.span("later") as sp:
            pass
    assert sp.parent is None and [s.name for s in trace.spans()] == ["fails", "later"]


def test_shared_clock_with_the_profiler(rec):
    """Each span's ``time_ns`` stamps lie within 20 us of the absolute
    times of its ``record_function`` range in the profiler's results."""
    x = torch.ones(256)
    worst = None
    for _attempt in range(3):  # a descheduled worker can stall one stamp
        trace.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for i in range(5):  # the profiler's first ranges cost more
                with trace.span(f"warm.{i}"):
                    x.sum()
            for i in range(20):
                with trace.span(f"clock.{i}"):
                    x.sum()
        ranges = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("clock.")}
        got = [s for s in trace.spans() if s.name.startswith("clock.")]
        assert len(got) == len(ranges) == 20
        worst = max(max(abs(s.start_ns - ranges[s.name][0]),
                        abs(s.end_ns - ranges[s.name][1])) for s in got)
        if worst <= 20_000:
            break
    assert worst <= 20_000, worst


@pytest.mark.parametrize("tier", ["q8", "f32", "flat"])
def test_search_same_results_recorded_or_not(rec, built, tier):
    X, Q, graph, ps = built
    if tier == "flat":
        index = pt.FlatIndex(ps)
        search = lambda: index.batch_search(Q, k=5)  # noqa: E731
        want = {"search": None, "flat.scan": "search"}
    else:
        index = pt.Index(points=ps, graph=graph)
        index.entry_min_n = 0  # the entry tier at this size too
        if tier == "q8":
            index.enable_quantized(bits=8)
        search = lambda: index.batch_search(Q, k=5, beam_size=16)[:2]  # noqa: E731
        want = {"search": None, **{n: "search" for n in SEARCH}}
    off = search()
    with trace.recording():
        on = search()
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    got = trace.spans()
    (root, names), = _tree(got).items()
    assert dict(names) == want and names[0] == ("search", None)
    top = got[0]
    assert top.id == root and top.counters == {"queries": Q.shape[0]}
    if tier != "flat":
        walk = next(s for s in got if s.name == "search.walk")
        assert walk.counters["cmps"] > walk.counters["visits"] > 0


def test_recorded_build_same_graph_and_phase_spans(rec):
    X, _ = synthetic.clustered(900, 16, n_queries=4, n_clusters=12, cluster_std=0.35,
                               seed=11)
    ps = quantize.quantize_pointset(pt.PointSet.from_numpy(X, device="cpu"), bits=8)
    bp = BuildParams(R=12, L=24, alpha=1.2, num_passes=2, batch_cap_frac=0.1)
    g0, s0 = vamana.build_vamana_graph(ps, bp)
    with trace.recording():
        g1, s1 = vamana.build_vamana_graph(ps, bp)
    assert torch.equal(g0.neighbors, g1.neighbors) and torch.equal(g0.degrees, g1.degrees)
    assert s0[4:] == s1[4:] and s1.beam_time == 0.0
    got = trace.spans()
    (root, names), = _tree(got).items()
    assert names[0] == ("build", None)
    phases = ["build.read", "build.prune", "build.reverse", "build.overflow"]
    batches = len(vamana.batch_schedule(900, 900, 0.1)[0]) * bp.num_passes
    assert [n for n, _ in names[1:]] == phases * batches
    assert {p for _, p in names[1:]} == {"build"}
    reads = [s for s in got if s.name == "build.read"]
    assert sum(s.counters["visits"] for s in reads) == s1.total_visited
    assert sum(s.counters["cmps"] for s in reads) == s1.total_cmps


def test_profile_fills_build_stats_from_the_spans(rec):
    """``profile=True`` sums its phase spans into BuildStats; they stay in
    the recorder only where it was on before the build."""
    X, _ = synthetic.clustered(900, 16, n_queries=4, n_clusters=12, cluster_std=0.35,
                               seed=11)
    ps = quantize.quantize_pointset(pt.PointSet.from_numpy(X, device="cpu"), bits=8)
    bp = BuildParams(R=12, L=24, alpha=1.2, num_passes=1, batch_cap_frac=0.1)
    with trace.recording():
        g, st = vamana.build_vamana_graph(ps, bp, profile=True)
    assert not trace.on()
    got = trace.spans()
    secs = {}
    for s in got:
        secs[s.name] = secs.get(s.name, 0.0) + s.host_ns * 1e-9
    assert st.beam_time == pytest.approx(secs["build.read"])
    assert st.bidirect_time == pytest.approx(secs["build.reverse"])
    assert st.prune_time == pytest.approx(secs["build.prune"] + secs["build.overflow"])
    assert all(t > 0 for t in st[1:4]) and sum(st[1:4]) <= st.build_time
    assert np.isfinite(st.build_time)
    trace.clear()
    g2, st2 = vamana.build_vamana_graph(ps, bp, profile=True)
    assert trace.spans() == [] and not trace.on()
    assert torch.equal(g.neighbors, g2.neighbors) and all(t > 0 for t in st2[1:4])


class _FakeEvent:
    """A CUDA event's stand-in: its record order is its time in ms."""

    n = 0

    def __init__(self, device):
        _FakeEvent.n += 1
        self.t = float(_FakeEvent.n)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.t - self.t


def _q8_like_batch(device, value):
    with trace.span("search") as root:
        trace.count("queries", 10)
        with trace.span("search.entry", device):
            pass
        with trace.span("search.walk", device):
            trace.count("cmps", value)
    return root


def test_profiler_times_one_root_in_sample(rec, monkeypatch):
    """Under the profiler alone, one root span in SAMPLE is timed, with
    its children: they record events and counters, the others host stamps
    alone. Inside ``recording()`` every span is timed."""
    monkeypatch.setattr(trace, "_event", _FakeEvent)
    dev = torch.device("cuda", 0)
    with profile(activities=[ProfilerActivity.CPU]):
        roots = [_q8_like_batch(dev, torch.tensor([3, 4])) for _ in range(3 * trace.SAMPLE)]
    with trace.recording():
        forced = [_q8_like_batch(dev, 5) for _ in range(3)]
    got = trace.spans()
    assert len(got) == 3 * len(roots + forced)
    timed = [r for r in roots if r.timed]
    assert len(timed) == 3 and all(r.timed for r in forced)
    for s in got:
        top = next(r for r in roots + forced if r.id == s.root)
        assert s.timed is top.timed
        if s.name == "search":
            assert s.stream_ms is None  # the root gives no device
            assert s.counters == ({"queries": 10} if s.timed else {})
        else:
            assert (s.stream_ms == 1.0) is s.timed and (s.stream_ms is None) is not s.timed
    walks = [s.counters.get("cmps") for s in got if s.name == "search.walk"]
    assert walks == [7 if r.timed else None for r in roots] + [5, 5, 5]


def test_recording_keep_false_forgets_its_spans(rec):
    with trace.recording():
        with trace.span("before"):
            pass
    with trace.recording(keep=False):
        with trace.span("gone") as gone:
            pass
    assert gone.host_ns >= 0 and [s.name for s in trace.spans()] == ["before"]
    with trace.recording():
        with trace.recording(keep=False):  # on before: kept
            with trace.span("kept"):
                pass
    assert [s.name for s in trace.spans()] == ["before", "kept"]
