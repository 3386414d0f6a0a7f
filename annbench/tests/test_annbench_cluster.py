"""The ClusterIndex cell's comparison at a tiny size on the CPU: its
reference's ``faults`` on structures broken by hand, ``walk_off`` on
planted answers, whole runs that have to fail (a packing fault, a walk
that stops short, a structure left broken), the control, which fails, and
the readers of the cell's per-layer metrics."""

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from annbench import correct, data, run, spec
from annbench.checks import walk_off
from annbench.reference import cluster, knn
from annbench.systems import cluster as system

CELL = "cluster-10m.np8"
READERS = ("seed_ms", "cwalk_ms", "pool_ms", "route_s", "polish_s")


def _run(name=CELL, seed=99):
    c = spec.cell(spec.load_benchmark(), name)
    return run.measure(c, seed, 1.0, False, torch.device("cpu"), start=time.perf_counter())


@pytest.fixture()
def meta(monkeypatch):
    """The hierarchical build and the meta-routed seed at the tiny size."""
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops.kernels import clusterbeam

    monkeypatch.setattr(tci, "EXACT_LIMIT", 1.0)
    monkeypatch.setattr(clusterbeam, "ARGMIN_SEED_CUTOFF", 8)


@pytest.fixture(scope="module")
def tiny_system():
    from annbench.tests.conftest import tiny_cell

    c = tiny_cell(spec.load_benchmark(), CELL)
    points, pool = data.make(c.config, c.traffic["pool"], 2**32 + 3, torch.device("cpu"))
    sys_ = spec.system("cluster").System(c.config, points, 2**32 + 3, {})
    search = sys_.searcher(c.traffic)
    ids, dists = zip(*(search(b) for b in (pool[:250], pool[250:])))
    return c, points, pool, sys_, torch.cat(ids).numpy(), torch.cat(dists).numpy()


def test_state_holds_the_pool_in_order(tiny_system):
    c, points, pool, sys_, _, _ = tiny_system
    st = sys_.state()
    assert torch.equal(st["queries"], pool)
    assert st["search"] == dict(k=10, n_probe=8, min_probe=0, cut=0.0, starts=2,
                                seed_probes=16, rerank_factor=2)
    assert cluster.faults(st, c.config["data"]["n"]) == 0


@pytest.mark.parametrize("fault,want", [
    ("twice", 2), ("hole", 1), ("out", 2), ("self", 1), ("repeat", 1), ("adj_range", 1),
    ("adj_hole", 1), ("empty", 1)])
def test_faults_count_what_is_broken(tiny_system, fault, want):
    c, _, _, sys_, _, _ = tiny_system
    st = dict(sys_.state())
    n = c.config["data"]["n"]
    mem, adj = st["members"].copy(), st["adj"].copy()
    C = mem.shape[0]
    if fault == "twice":  # a point in two clusters, one in none
        mem[0, 0] = mem[1, 0]
    elif fault == "hole":  # -1 inside a row, its id moved to the end
        r = int(np.flatnonzero((mem >= 0).sum(1) < mem.shape[1] - 1)[0])
        f = int((mem[r] >= 0).sum())
        mem[r, f] = mem[r, 0]
        mem[r, 0] = -1
    elif fault == "out":  # an id past n, the point it replaced in none
        mem[0, 0] = n
    elif fault == "self":
        adj[3, 0] = 3
    elif fault == "repeat":
        adj[3, 1] = adj[3, 0]
    elif fault == "adj_range":
        adj[3, 0] = C
    elif fault == "adj_hole":
        adj[3, 0] = -1
    else:  # an empty cluster that the adjacency names
        mem = np.concatenate([mem, np.full((1, mem.shape[1]), -1, mem.dtype)])
        adj = np.concatenate([adj, adj[:1]])
        adj[0, -1] = C
        st["centroids"] = torch.cat([st["centroids"], st["centroids"][:1] * 0])
    st.update(members=mem, adj=adj)
    assert cluster.faults(st, n) == want


def test_faults_see_a_broken_seed_quantizer(meta):
    from annbench.tests.conftest import tiny_cell

    c = tiny_cell(spec.load_benchmark(), CELL)
    points, _ = data.make(c.config, 8, 2**32 + 4, torch.device("cpu"))
    st = spec.system("cluster").System(c.config, points, 2**32 + 4, {}).state()
    n = c.config["data"]["n"]
    assert st["seed"] is not None and cluster.faults(st, n) == 0
    mc, blocks, idtab = st["seed"]
    b2 = blocks.clone()
    b2[0, 0, 0] += 1  # a block row other than its centroid
    assert cluster.faults(dict(st, seed=(mc, b2, idtab)), n) == 1
    i2 = idtab.clone()
    i2[0, 1] = i2[0, 0]  # a centroid in two cells, one in none
    assert cluster.faults(dict(st, seed=(mc, blocks, i2)), n) >= 2


def test_walk_off_on_planted_answers(tiny_system):
    c, points, pool, sys_, ids, dists = tiny_system
    st = dict(sys_.state())
    n = c.config["data"]["n"]
    gt = knn.exact_knn(points, n, pool, 10)
    ctx = correct.context(points, n, pool, ids, dists, gt, st)
    assert walk_off.compute(ctx) == 0.0
    ref_ids, ref_d = st["reference_answers"]
    assert np.array_equal(ref_ids, ids)
    bad = ids.copy()
    bad[5, 9] = gt[0][5, 0] if gt[0][5, 0] not in ids[5] else (ids[5, 9] + 1) % n
    ctx = correct.context(points, n, pool, bad, dists, gt, st)
    assert walk_off.compute(ctx) == pytest.approx(1 / len(ids))
    # a swap between ids at distances float32 cannot tell apart is set aside
    scale = np.ones(2)
    got = np.array([[1, 2], [1, 2]])
    want = np.array([[2, 1], [1, 3]])
    d_got = np.array([[1.0, 1.0 + 1e-7], [1.0, 2.0]])
    d_want = np.array([[1.0, 1.0 + 1e-7], [1.0, 2.5]])
    assert walk_off.off(got, d_got, want, d_want, scale).tolist() == [False, True]


def test_sound_run_with_the_meta_seed_passes(tiny, meta):
    r = _run()
    assert r["correct"] is True and r["checks"]["walk_off"]["value"] == 0.0


def _scrambled_finish(real):
    """The ext rows of clusters 0 and 1 packed in each other's place."""
    def finish(*a, **kw):
        ci = real(*a, **kw)
        ci.ext[[0, 1]] = ci.ext[[1, 0]]
        return ci
    return staticmethod(finish)


@pytest.mark.parametrize("fault", ["packing", "short_walk", "self_loop"])
def test_faults_fail_a_run(tiny, monkeypatch, fault):
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops.kernels import clusterbeam

    if fault == "packing":
        monkeypatch.setattr(tci.ClusterIndex, "_finish",
                            _scrambled_finish(tci.ClusterIndex._finish))
    elif fault == "short_walk":
        real = clusterbeam.cluster_walk
        monkeypatch.setattr(clusterbeam, "cluster_walk",
                            lambda *a, **kw: real(*a, **dict(kw, n_probe=1)))
    else:
        real = tci.ClusterIndex._finish

        def finish(points, members, adj, *a, **kw):
            adj = adj.copy()
            adj[:, -1] = np.arange(adj.shape[0])
            return real(points, members, adj, *a, **kw)

        monkeypatch.setattr(tci.ClusterIndex, "_finish", staticmethod(finish))
    r = _run()
    assert r["correct"] is False
    failed = {k for k, v in r["checks"].items() if v["value"] > v["limit"]}
    assert failed & ({"partition_bad"} if fault == "self_loop" else {"walk_off", "miss"})


def test_control_fails_and_reference_passes(tiny, meta, tmp_path):
    import importlib.util

    spec_ = importlib.util.spec_from_file_location(
        "cluster_readings", spec.ROOT / "scripts" / "cluster_readings.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    out = tmp_path / "readings.jsonl"
    mod.main(["--seeds", "7", "--seconds", "0.5", "--control", "1", "--device", "cpu",
              "--out", str(out)])
    import json

    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["side"] for x in lines] == ["program", "control", "reference"]
    for rec in lines:
        assert rec["correct"] is (rec["side"] != "control"), rec
    assert lines[1]["walk_off"] > 0.1 and lines[2]["walk_off"] == 0.0


def _traced(batches):
    from annbench.trace import Trace

    t = None if batches is None else Trace(
        wall_s=1.0, busy_s=0.5, batches=batches, ops={}, gaps={}, port=frozenset())
    return run.Run(cell=None, spans={}, window=None, trace=t, recall=None, peak_bytes=0)


@pytest.mark.parametrize("name", READERS)
def test_readers_none_where_nothing_was_recorded(name):
    from parlayann_tpu_torch.utils import trace as ptrace

    ptrace.clear()
    read = spec.metric(name).read
    assert read(_traced(None)) is None and read(_traced(4)) is None


def test_readers_of_a_hand_made_trace_and_spans(monkeypatch):
    from parlayann_tpu_torch.utils import trace as ptrace

    r = _traced(2)
    r.trace.ops = {"void (anonymous namespace)::cluster_walk_regs<signed char>(Params)": 4e-4,
                   "void walk_regs<4, 1>(Params)": 9.0}
    assert spec.metric("cwalk_ms").read(r) == pytest.approx(0.2)
    sp = lambda i, name, parent=None, ms=None, t=0: SimpleNamespace(  # noqa: E731
        id=i, name=name, parent=parent, stream_ms=ms, start_ns=t * 10**6,
        end_ns=(t + 1) * 10**6, timed=True, counters={"queries": 10})
    spans = [sp(1, "search"), sp(2, "search.seed", 1, 3.0), sp(3, "search.pool", 1, 0.5),
             sp(4, "search", t=1), sp(5, "search.seed", 4, 5.0, 1),
             sp(6, "search.pool", 4, 0.7, 1)]
    monkeypatch.setattr(ptrace, "spans", lambda: spans)
    assert spec.metric("seed_ms").read(r) == pytest.approx(4.0)
    assert spec.metric("pool_ms").read(r) == pytest.approx(0.6)
    r.spans.update(route_s=61.5, polish_s=9.25)
    assert spec.metric("route_s").read(r) == 61.5 and spec.metric("polish_s").read(r) == 9.25


def test_build_seconds_from_the_build_spans():
    root = SimpleNamespace(id=1)
    sp = lambda name, ms, root_id=1: SimpleNamespace(  # noqa: E731
        name=name, stream_ms=ms, root=root_id)
    spans = [sp("build.assign", 1000.0), sp("build.assign", 500.0), sp("build.polish", None),
             sp("build.assign", 7.0, root_id=2)]
    assert system.stream_s(spans, root, "build.assign") == pytest.approx(1.5)
    assert system.stream_s(spans, root, "build.polish") is None  # no card
    assert system.stream_s(spans, root, "build.adjacency") is None


@pytest.mark.cuda
def test_card_tiny_traced_run(tiny, meta):
    """On the card: a tiny traced run of the cell, the hierarchical build
    and the meta seed forced, reports every per-layer metric it lists, and
    is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    c = spec.cell(spec.load_benchmark(), CELL)
    c.traffic["trace_batches"] = 2
    r = run.measure(c, 5, 1.0, True, torch.device("cuda", 0), start=time.perf_counter())
    assert r["correct"] is True
    assert set(r["metrics"]) == {m["name"] for m in c.per_layer}
    assert r["device"]["busy_s"] > 0
