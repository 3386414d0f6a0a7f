"""Shared helpers of the benchmark's CPU tests: the cells of
BENCHMARK.json cut to a size the CPU runs in seconds (the mix's k, beam
and limits kept; n, the clusters, the pool, the batch, R and L made
small)."""

import copy

import pytest

from annbench import spec

_cell = spec.cell


def tiny_cell(bench, name):
    c = _cell(bench, name)
    c.config, c.traffic = copy.deepcopy(c.config), copy.deepcopy(c.traffic)
    c.config["data"].update(n=4000, clusters=40)
    if "build" in c.config:
        c.config["build"].update(R=32, L=64, batch_cap_frac=0.1)
    c.traffic.update(pool=500, batch=250)
    return c


@pytest.fixture()
def tiny(monkeypatch):
    """Every cell found by name is the tiny version of itself."""
    monkeypatch.setattr(spec, "cell", tiny_cell)
    return tiny_cell


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
