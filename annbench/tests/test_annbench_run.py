"""A whole run on the CPU at a tiny size: the last line's schema, the
exit without a card, and the check that no JAX module is loaded."""

import json
import subprocess
import sys
import time

import pytest
import torch

from annbench import guard, run, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_schema_and_correct(tiny, name):
    c = spec.cell(spec.load_benchmark(), name)
    r = run.measure(c, 2**31 + 12345, 1.0, False, torch.device("cpu"),
                    start=time.perf_counter())
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["checks"]) == set(c.limits)
    for v in r["checks"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    want = {m["name"] for m in c.end_to_end} - {"peak_mem_gib"}  # no card: no peak
    assert set(r["metrics"]) == want
    for m in c.end_to_end:
        if m["name"] in r["metrics"]:
            assert r["metrics"][m["name"]]["unit"] == m["unit"]
            assert r["metrics"][m["name"]]["value"] > 0
    json.dumps(r)


def test_same_seed_same_inputs():
    from annbench import data

    cfg = {"data": {"generator": "clustered", "n": 64, "d": 8, "dtype": "float32",
                    "clusters": 4, "cluster_std": 0.35}}
    a = data.make(cfg, 16, 2**33 + 7, torch.device("cpu"))
    b = data.make(cfg, 16, 2**33 + 7, torch.device("cpu"))
    c = data.make(cfg, 16, 2**33 + 8, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])


def _cli(args, cwd):
    return subprocess.run([sys.executable, "-m", "annbench.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _cli(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
               spec.ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["parlayann_tpu_torch", "parlayann_tpu_torch.index",
                                   "jaxtyping", "annbench"]) == []
    assert guard.forbidden_loaded(["parlayann_tpu.index", "jax.numpy", "flax", "jaxlib.x"]) \
        == ["flax", "jax", "jaxlib", "parlayann_tpu"]


def test_nothing_loads_jax():
    """Every module of the benchmark and a whole tiny run, in a fresh
    process: no top-level name jax, jaxlib, flax or parlayann_tpu."""
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'annbench/tests')\n"
        "import conftest\n"
        "from annbench import spec, run, calibrate, guard, correct, trace, peaks\n"
        "for name in ('qps', 'recall', 'walk_ms', 'glue_ms', 'scan_roofline'):\n"
        "    spec.metric(name)\n"
        "c = conftest.tiny_cell(spec.load_benchmark(), %r)\n"
        "run.measure(c, 3, 0.2, False, torch.device('cpu'), start=time.perf_counter())\n"
        "print(guard.forbidden_loaded())\n" % CELLS[0])
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
