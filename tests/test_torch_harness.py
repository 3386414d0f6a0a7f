"""The sweep harness, port vs JAX package: bucket selection and best-QPS
picks on the same NNResult lists, the CSV on the same rows, and
search_and_parse on the two packages' q8 Index over one graph."""

import dataclasses

import numpy as np
import pytest
import torch

from parlayann_tpu.types import BuildParams as JBuildParams
from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.build.vamana import build_vamana_graph as jbuild
from parlayann_tpu.index import Index as JIndex
from parlayann_tpu.harness import csv as jcsv, sweep as jsweep
from parlayann_tpu.harness.recall import NNResult as JNNResult
from parlayann_tpu.search import exact as jexact

import parlayann_tpu_torch as pt
from parlayann_tpu_torch.harness import csv as tcsv, sweep as tsweep
from parlayann_tpu_torch.harness.recall import NNResult

torch.set_num_threads(1)


def _results(seed, n=40):
    """NNResult fields: recalls on and between the buckets, ties in QPS."""
    rng = np.random.default_rng(seed)
    rec = np.concatenate([rng.choice(tsweep.BUCKETS, n // 2), rng.uniform(0, 1, n - n // 2)])
    qps = rng.choice([100.0, 250.0, 1e3, 5e4], n) * rng.integers(1, 4, n)
    return [dict(recall=float(r), QPS=float(q), avg_cmps=float(i), tail_cmps=float(2 * i),
                 avg_visited=1.5 * i, tail_visited=3.0 * i, k=10, beamQ=10 + i, cut=1.35,
                 limit=1000, degree_limit=32, num_queries=100)
            for i, (r, q) in enumerate(zip(rec, qps))]


def test_torch_sweep_constants_match_jax():
    assert (tsweep.BEAMS, tsweep.LIMITS, tsweep.BUCKETS) == (jsweep.BEAMS, jsweep.LIMITS,
                                                             jsweep.BUCKETS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_torch_parse_result_matches_jax(seed, tmp_path):
    rows = _results(seed)
    jres = [JNNResult(**r) for r in rows]
    tres = [NNResult(**r) for r in rows]
    jb = jsweep.parse_result(jres, jsweep.BUCKETS)
    tb = tsweep.parse_result(tres, tsweep.BUCKETS)
    assert tb and [(b, dataclasses.asdict(r)) for b, r in tb] == [
        (b, dataclasses.asdict(r)) for b, r in jb]
    for target in (0.0, 0.5, 0.95, 0.99999, 1.01):
        j, t = jsweep.best_qps_at_recall(jres, target), tsweep.best_qps_at_recall(tres, target)
        assert (None if t is None else dataclasses.asdict(t)) == (
            None if j is None else dataclasses.asdict(j))
    # the CSV block, byte for byte, appended twice
    rec = dict(name="vamana", params="R=32 L=64 alpha=1.2", size=100000, time=2.34567,
               avg_deg=28.123, max_deg=32)
    paths = [str(tmp_path / f"{w}.csv") for w in "jt"]
    for _ in range(2):
        jcsv.write_to_csv(paths[0], jb, jcsv.GraphRecord(**rec))
        tcsv.write_to_csv(paths[1], tb, tcsv.GraphRecord(**rec))
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()


def test_torch_search_and_parse_matches_jax():
    """Short beam and limit lists on the two packages' q8 Index over one
    graph: equal recall, comparisons and visits a row. Limits 2 and 3 give
    degree_limit 10 and 15 < R = 16 (the lock-step search); the others
    run on the fused walk."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((600, 16)).astype(np.float32)
    Q = rng.standard_normal((32, 16)).astype(np.float32)
    jps = JPointSet.from_numpy(X)
    g, _ = jbuild(jps, JBuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.25))
    gt_ids, gt_d = jexact.compute_groundtruth(jps, Q, 20)
    jidx = JIndex(points=jps, graph=g).enable_quantized(bits=8)
    tidx = pt.Index(points=pt.PointSet.from_numpy(X, device="cpu"),
                    graph=pt.GraphIndexData.from_numpy(np.asarray(g.neighbors)[:600],
                                                       np.asarray(g.degrees)[:600], n=600,
                                                       device="cpu")).enable_quantized(bits=8)
    kw = dict(k=10, beams=[10, 16, 32], limits=[2, 3, 10], best_accuracy_probe=False)
    jres, jbest = jsweep.search_and_parse(jidx, Q, gt_ids, gt_d, **kw)
    tres, tbest = tsweep.search_and_parse(tidx, Q, gt_ids, gt_d, **kw)
    assert len(tres) == len(jres) == 6
    for t, j in zip(tres, jres):
        assert (t.recall, t.avg_cmps, t.tail_cmps, t.avg_visited, t.beamQ, t.limit,
                t.degree_limit) == (j.recall, j.avg_cmps, j.tail_cmps, j.avg_visited, j.beamQ,
                                    j.limit, j.degree_limit)
        assert t.QPS > 0
    assert [b for b, _ in tbest] == [b for b, _ in jbest]
    assert tres[2].recall >= tres[0].recall and tres[3].avg_visited <= 2
