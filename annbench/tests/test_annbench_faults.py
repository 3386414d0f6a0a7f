"""The comparison has to fail: the timed path broken underneath a whole
run (the look for a card skipped, a tiny size on the CPU), and the
control read by the calibration tool. A cell on one card has no exchange
between cards to leave out."""

import json
import time

import pytest
import torch

from annbench import calibrate, run, spec

VAMANA = ["vamana-sift1m.q8-k10-r95", "vamana-sift1m.q8-k100-b128"]
FLAT = ["flat-sift1m.k100"]


def _run(name):
    c = spec.cell(spec.load_benchmark(), name)
    return run.measure(c, 99, 1.0, False, torch.device("cpu"), start=time.perf_counter())


def _unchanged_walk(queries, tier_data, nbrs, degs, starts, *, L, **kw):
    """Kernel 3 returning the state it starts from: the start in lane 0."""
    B = queries.shape[0]
    ids = torch.full((B, L), -1, dtype=torch.int32)
    ids[:, 0] = starts.reshape(B, -1)[:, 0] if starts.numel() == B else starts.reshape(-1)[0]
    dists = torch.full((B, L), float("inf"))
    z = torch.zeros(B, dtype=torch.int32)
    return ids, dists, z, z


def _half(fn, method=False):
    """Answer the first half of a batch; the second half repeats it."""
    def search(*a, **kw):
        a = list(a)
        q = a[int(method)]
        h = q.shape[0] // 2
        a[int(method)] = q[:h]
        out = fn(*a, **kw)
        return tuple(torch.cat([x, x[:q.shape[0] - h]]) if torch.is_tensor(x) and x.dim() == 2
                     else x for x in out)
    return search


def _altered(fn):
    """One answer of each batch changed to another id where it is produced."""
    def search(*a, **kw):
        ids, dists, *rest = fn(*a, **kw)
        ids = ids.clone()
        ids[0, 0] = (ids[0, 0] + 1) % 4000
        return (ids, dists, *rest)
    return search


@pytest.mark.parametrize("name", VAMANA)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_vamana_faults_fail(tiny, monkeypatch, name, fault):
    import parlayann_tpu_torch.index as pindex

    if fault == "unchanged":
        monkeypatch.setattr(pindex, "beam_search_fused", _unchanged_walk)
    elif fault == "half":
        monkeypatch.setattr(pindex.Index, "batch_search", _half(pindex.Index.batch_search, method=True))
    else:
        monkeypatch.setattr(pindex, "rerank_topk", _altered(pindex.rerank_topk))
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", FLAT)
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_flat_faults_fail(tiny, monkeypatch, name, fault):
    import parlayann_tpu_torch.search.flat as pflat

    real = pflat.flat_topk

    def unchanged(queries, points, *a, k, **kw):
        B = queries.shape[0]
        return (torch.full((B, k), -1, dtype=torch.int32), torch.full((B, k), float("inf")))

    broken = {"unchanged": unchanged, "half": _half(real), "altered": _altered(real)}[fault]
    monkeypatch.setattr(pflat, "flat_topk", broken)
    assert _run(name)["correct"] is False


def test_sound_runs_pass(tiny):
    for name in VAMANA + FLAT:
        assert _run(name)["correct"] is True


def test_control_fails_and_reference_passes(tiny, tmp_path):
    out = tmp_path / "readings.jsonl"
    calibrate.main(["readings", "--cells", ",".join(VAMANA + FLAT), "--seeds", "7",
                    "--control", "1", "--device", "cpu", "--out", str(out)])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert len(lines) == 3 * len(VAMANA + FLAT)
    for rec in lines:
        assert rec["correct"] is (rec["side"] != "control"), rec


@pytest.mark.cuda
def test_card_tiny_traced_run(tiny):
    """On the card: a tiny traced run of each cell reports every per-layer
    metric it lists, and is correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for name in VAMANA + FLAT:
        c = spec.cell(spec.load_benchmark(), name)
        c.traffic["trace_batches"] = 2
        r = run.measure(c, 5, 1.0, True, torch.device("cuda", 0), start=time.perf_counter())
        assert r["correct"] is True
        assert set(r["metrics"]) == {m["name"] for m in c.per_layer}
        assert r["device"]["busy_s"] > 0
