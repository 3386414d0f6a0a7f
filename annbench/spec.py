"""The benchmark's files, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells and the
metrics. A cell names a configuration (``configs/<config>.json``) and a
traffic mix (``traffic/<mix>.json``); the limits of its correctness check
are ``limits/<cell>.json``. A metric is a reader ``metrics/<metric>.py``,
a number compared is ``checks/<number>.py``, and an index kind named by a
configuration is ``systems/<kind>.py``. Adding any of these adds files and
entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list


def load_benchmark(path: Path | None = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(bench: dict, name: str) -> Cell:
    """The cell ``name`` of ``bench`` with its files read."""
    for w in bench["workloads"]:
        if w["name"] == name:
            break
    else:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=_json("configs", w["config"]),
        traffic=_json("traffic", w["traffic"]),
        limits=_json("limits", name),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def _module(kind: str, name: str) -> ModuleType:
    if not NAME.match(name):
        raise ValueError(f"bad {kind} name {name!r}")
    path = HERE / kind / f"{name}.py"
    if not path.exists():
        raise KeyError(f"no {kind} file {path.name}")
    spec = importlib.util.spec_from_file_location(
        f"annbench.{kind}.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric(name: str) -> ModuleType:
    """The reader of metric ``name``: ``UNIT``, ``BETTER``, ``LAYER``,
    ``MOVES``, ``TRACE`` (read in the run with ``--trace 1``) and
    ``read(run) -> float | None``."""
    return _module("metrics", name)


def check(name: str) -> ModuleType:
    """The number compared ``name``: ``compute(ctx) -> float``."""
    return _module("checks", name)


def system(kind: str) -> ModuleType:
    """The adapter of an index kind: ``setup(config, data, seed, spans)``."""
    return _module("systems", kind)
