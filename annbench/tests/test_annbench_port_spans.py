"""The readers of the port's own spans (``entry_ms``, ``rerank_ms``,
``walk_cmps``): None where there is nothing to read, the averages of a
span list made by hand, and a tiny run on the CPU, whose spans have no
stream time."""

import sys
from types import SimpleNamespace

import pytest
import torch

from annbench import run, spec
from annbench.trace import Trace
from parlayann_tpu_torch.utils import trace as ptrace

READERS = ("entry_ms", "rerank_ms", "walk_cmps")
VAMANA = "vamana-sift1m.q8-k10-r95"


def _run(batches):
    t = None if batches is None else Trace(
        wall_s=1.0, busy_s=0.5, batches=batches, ops={}, gaps={}, port=frozenset())
    return run.Run(cell=None, spans={}, window=None, trace=t, recall=None, peak_bytes=0)


@pytest.fixture()
def empty():
    ptrace.clear()
    yield
    ptrace.clear()


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(empty, monkeypatch, name):
    read = spec.metric(name).read
    assert read(_run(None)) is None  # an untraced run
    assert read(_run(4)) is None  # traced, nothing recorded
    monkeypatch.setitem(sys.modules, "parlayann_tpu_torch.utils.trace", None)
    assert read(_run(4)) is None  # a port without the recorder


def _sp(id_, name, parent=None, stream_ms=None, t=0, timed=True, **counters):
    """A span made by hand, open over [t, t + 1) ms of the host clock."""
    return SimpleNamespace(id=id_, name=name, parent=parent, stream_ms=stream_ms,
                           start_ns=t * 10**6, end_ns=(t + 1) * 10**6, timed=timed,
                           counters=counters)


def _stretch(first_id, t, entry, walk, cmps, timed=True):
    """Two batches' root ``search`` spans and their children, from host
    ms ``t``: one batch with an entry top-1, a walk and a rerank, one
    without the translate."""
    i = first_id
    return [
        _sp(i, "search", t=t, timed=timed, queries=100),
        _sp(i + 1, "search.entry", i, entry, t=t),
        _sp(i + 2, "search.translate", i, 0.1, t=t),
        _sp(i + 3, "search.walk", i, walk, t=t, cmps=cmps),
        _sp(i + 4, "search.rerank", i, 1.0, t=t),
        _sp(i + 5, "search", t=t + 1, timed=timed, queries=100),
        _sp(i + 6, "search.entry", i + 5, entry + 0.2, t=t + 1),
        _sp(i + 7, "search.walk", i + 5, walk + 0.2, t=t + 1, cmps=cmps + 2000),
        _sp(i + 8, "search.rerank", i + 5, 1.4, t=t + 1),
    ]


def test_averages_of_a_hand_made_span_list(monkeypatch):
    spans = (_stretch(1, 0, 0.5, 2.0, 3000)
             + [_sp(10, "build"), _sp(11, "search.entry", 10, 9.0)]  # no search root
             + _stretch(20, 10, 50.0, 9.0, 99999))  # the second stretch
    monkeypatch.setattr(ptrace, "spans", lambda: spans)
    r = _run(2)
    assert spec.metric("entry_ms").read(r) == pytest.approx((0.5 + 0.7) / 2)
    assert spec.metric("rerank_ms").read(r) == pytest.approx((1.0 + 1.4) / 2)
    assert spec.metric("walk_cmps").read(r) == pytest.approx(8000 / 200)
    spans[1].name = spans[6].name = "other"  # batches without an entry top-1
    assert spec.metric("entry_ms").read(r) == 0.0


def test_untimed_batches_are_left_out(monkeypatch):
    spans = (_stretch(1, 0, 0.5, 2.0, 3000)
             + _stretch(10, 2, 7.0, 7.0, 7000, timed=False)  # two untimed batches
             + _stretch(20, 10, 50.0, 9.0, 99999) + _stretch(30, 12, 50.0, 9.0, 99999))
    monkeypatch.setattr(ptrace, "spans", lambda: spans)
    r = _run(4)
    assert spec.metric("entry_ms").read(r) == pytest.approx((0.5 + 0.7) / 2)
    assert spec.metric("walk_cmps").read(r) == pytest.approx(8000 / 200)


@pytest.mark.parametrize("retried", ["first", "second"])
def test_a_discarded_attempt_is_not_read(monkeypatch, retried):
    """The profiler saw no device activity in one attempt of a stretch
    and was asked again: the reader takes an attempt of the first
    stretch, whose host extent (2 ms) matches the stretch's wall time,
    and not one of the second stretch (host traced: 20 ms). A discarded
    attempt of the first stretch ran as the kept one did and reads the
    same."""
    first = _stretch(1, 0, 0.5, 2.0, 3000)
    second = _stretch(20, 10, 50.0, 9.0, 99999)
    for s in second:
        s.end_ns += 18 * 10**6 if s.name == "search" and s.id == 25 else 0
    if retried == "first":
        spans = _stretch(40, -10, 0.5, 2.0, 3000) + first + second
    else:
        later = _stretch(40, 40, 50.0, 9.0, 99999)
        later[5].end_ns += 18 * 10**6
        spans = first + second + later
    monkeypatch.setattr(ptrace, "spans", lambda: spans)
    r = run.Run(cell=None, spans={}, window=None, recall=None, peak_bytes=0,
                trace=Trace(wall_s=0.0021, busy_s=0.002, batches=2, ops={}, gaps={},
                            port=frozenset()))
    assert spec.metric("entry_ms").read(r) == pytest.approx((0.5 + 0.7) / 2)
    assert spec.metric("walk_cmps").read(r) == pytest.approx(8000 / 200)


def test_tiny_cpu_run_reads_the_counters(tiny, empty):
    """A tiny run of cell 1 on the CPU, then two batches searched under
    the recorder as a traced stretch would: the walk's counter is read,
    and the spans, with no CUDA stream, give no stream time."""
    c = spec.cell(spec.load_benchmark(), VAMANA)
    cfg, trf = c.config, c.traffic
    from annbench import data, loop

    points, pool = data.make(cfg, trf["pool"], 2**31 + 99, torch.device("cpu"))
    system = spec.system(cfg["index"]).System(cfg, points, 2**31 + 99, {})
    search = system.searcher(trf)
    batches = loop.slots(pool, trf["batch"])
    with ptrace.recording():
        for b in batches[:2]:
            search(b)
    _, _, res = system.index.batch_search(torch.cat(batches[:2]), k=trf["k"],
                                          beam_size=trf["beam"])
    r = _run(2)
    want = res.dist_cmps.double().mean().item()
    assert spec.metric("walk_cmps").read(r) == pytest.approx(want)
    assert spec.metric("entry_ms").read(r) is None
    assert spec.metric("rerank_ms").read(r) is None
