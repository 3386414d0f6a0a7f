"""BENCHMARK.json and the files it names, found by name."""

import json
import math
import re

import pytest

from annbench import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["annbench"]
    assert BENCH["command"][:3] == ["python3", "-m", "annbench.run"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_check_time_fits_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    c = spec.cell(BENCH, name)
    assert c.chips == 1
    assert c.config["name"] in {x["name"] for x in BENCH["configs"]}
    assert c.traffic["k"] <= c.traffic.get("beam", c.traffic["k"])
    assert c.traffic["pool"] % c.traffic["batch"] == 0
    for number in c.limits:
        assert hasattr(spec.check(number), "compute")
    assert hasattr(spec.system(c.config["index"]), "System")
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert entry["file"].startswith("annbench/configs/")
    with open(spec.ROOT / entry["file"]) as f:
        cfg = json.load(f)
    assert cfg["name"] == entry["name"] and cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == []
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_readers_declare_their_entry(m):
    r = spec.metric(m["name"])
    assert (r.UNIT, r.BETTER, r.SOURCE) == (m["unit"], m["better"], m["source"])
    per_layer = m in BENCH["per_layer"]
    assert r.TRACE == per_layer
    if per_layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert (r.LAYER, r.MOVES) == (m["layer"], m["moves"])
    else:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in m.get("workloads", ()):
        assert w in CELLS


def test_names_and_units():
    names = [m["name"] for m in METRICS] + CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n)
    for m in METRICS:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    bounds = {m["name"]: m["bound"] for m in BENCH["end_to_end"]}
    assert bounds["setup_s"] <= 0.25 and not math.isnan(sum(bounds.values()))


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.cell(BENCH, "no-such-cell")
    with pytest.raises(ValueError):
        spec.metric("../run")
    with pytest.raises(KeyError):
        spec.check("no_such_number")
