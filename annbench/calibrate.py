"""Readings that set a cell's limits and its beam; not run by the benchmark.

    python3 -m annbench.calibrate readings --cells A,B --seeds 1,2,3 [--control 1]
    python3 -m annbench.calibrate sweep --cell A --seed 0 --beams 10,12,16 --seconds 2

``readings``: for each seed, cells of one configuration share one set-up
(the same data and index), each runs one pass over its pool through the
closed loop, and the numbers compared are read on the program's answers.
With ``--control 1`` the same numbers are read on the control's answers
(the reference's search one precision below the configuration's: a 4-bit
walk with TF32 products, or a TF32 scan) and on the reference's own
search at the stated precision (an 8-bit walk with a float32 rerank, or a
float32 scan), a second witness beside the exact ground truth. One JSON
line a seed, cell and side.

``sweep``: one set-up, then a window of ``--seconds`` at each beam and
the recall@k of the pool at each, after all windows. One JSON line a beam.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
import time

import torch

from annbench import correct, data, guard, loop, spec
from annbench.reference import control, knn

SIDES = {"control": dict(bits=4, tf32=True), "reference": dict(bits=8, tf32=False)}


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def _pass(system, traffic, pool, device):
    """Warm up, then one pass over the pool -> (ids, dists, seconds)."""
    lp = loop.ClosedLoop(system.searcher(traffic), loop.slots(pool, traffic["batch"]),
                         device, traffic["in_flight"])
    lp.pump(count=traffic["warmup_batches"])
    lp.reset()
    t0 = time.perf_counter()
    lp.pump(count=len(lp.batches))
    secs = time.perf_counter() - t0
    return (*lp.answers(), secs)


def _side_answers(side, cfg, trf, points, n, pool, state):
    p = SIDES[side]
    if cfg["index"] == "flat":
        return control.flat_scan(points, n, pool, k=trf["k"], tf32=p["tf32"])
    return control.graph_search(points, n, pool, state["nbrs"], state["degs"], k=trf["k"],
                                L=max(trf["beam"], trf["k"]), bits=p["bits"], tf32=p["tf32"])


def readings(cells, seeds, with_control, device, out):
    bench = spec.load_benchmark()
    cells = [spec.cell(bench, c) for c in cells]
    groups = {}
    for c in cells:
        groups.setdefault(c.config["name"], []).append(c)
    for seed in seeds:
        for group in groups.values():
            cfg = group[0].config
            pool_n = max(c.traffic["pool"] for c in group)
            n = cfg["data"]["n"]
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            spans = {}
            t0 = time.perf_counter()
            points, pool = data.make(cfg, pool_n, seed, device)
            system = spec.system(cfg["index"]).System(cfg, points, seed, spans)
            setup = time.perf_counter() - t0
            got = {c.name: _pass(system, c.traffic, pool[:c.traffic["pool"]], device)
                   for c in group}
            peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
            state = system.state()
            del system
            gc.collect()
            t1 = time.perf_counter()
            kmax = max(c.traffic["k"] for c in group)
            gt = knn.exact_knn(points, n, pool, kmax)
            gt_s = time.perf_counter() - t1
            for c in group:
                q = pool[:c.traffic["pool"]]
                g = (gt[0][:q.shape[0]], gt[1][:q.shape[0]])
                ids, dists, secs = got[c.name]
                ctx = correct.context(points, n, q, ids, dists, g, state)
                vals = correct.numbers(ctx, c.limits)
                _emit(out, dict(seed=seed, cell=c.name, side="program", **vals,
                                recall=ctx.recall, pass_qps=q.shape[0] / secs,
                                setup_s=setup, build_s=spans.get("build_s"), gt_s=gt_s,
                                peak_gib=peak / 2**30, correct=correct.judge(vals, c.limits)))
                if not with_control:
                    continue
                for side in SIDES:
                    t2 = time.perf_counter()
                    ids, dists = _side_answers(side, cfg, c.traffic, points, n, q, state)
                    ctx = correct.context(points, n, q, ids, dists, g)
                    names = [k for k in c.limits if k not in ("q8_off", "graph_bad")]
                    vals = correct.numbers(ctx, names)
                    _emit(out, dict(seed=seed, cell=c.name, side=side, **vals,
                                    recall=ctx.recall, secs=time.perf_counter() - t2,
                                    correct=correct.judge(vals, {k: c.limits[k] for k in names})))
            del points, pool, state, got
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    guard.require_clean("after the readings")


def sweep(cell, seed, beams, seconds, device, out):
    c = spec.cell(spec.load_benchmark(), cell)
    cfg, n = c.config, c.config["data"]["n"]
    spans = {}
    points, pool = data.make(cfg, c.traffic["pool"], seed, device)
    system = spec.system(cfg["index"]).System(cfg, points, seed, spans)
    _emit(out, dict(cell=cell, seed=seed, build_s=spans.get("build_s")))
    rows = []
    for beam in beams:
        trf = dict(copy.deepcopy(c.traffic), beam=beam)
        lp = loop.ClosedLoop(system.searcher(trf), loop.slots(pool, trf["batch"]), device,
                             trf["in_flight"])
        lp.pump(count=trf["warmup_batches"])
        win = lp.window(seconds)
        rows.append((beam, win, *lp.answers()))
    del system
    gc.collect()
    gt = knn.exact_knn(points, n, pool, c.traffic["k"])
    for beam, win, ids, dists in rows:
        ctx = correct.context(points, n, pool, ids, dists, gt)
        _emit(out, dict(cell=cell, seed=seed, beam=beam, recall=ctx.recall,
                        qps=win.queries / win.seconds, batches=win.batches,
                        answered=len(win.answered), malformed=float((~ctx.well_formed).sum())))
    guard.require_clean("after the sweep")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="what", required=True)
    r = sub.add_parser("readings")
    r.add_argument("--cells", required=True)
    r.add_argument("--seeds", required=True)
    r.add_argument("--control", type=int, default=0)
    s = sub.add_parser("sweep")
    s.add_argument("--cell", required=True)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--beams", required=True)
    s.add_argument("--seconds", type=float, default=2.0)
    for p in (r, s):
        p.add_argument("--out", default=None, help="also append the lines to this file")
        p.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    guard.require_clean("at start")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("annbench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    if args.what == "readings":
        readings(args.cells.split(","), [int(x) for x in args.seeds.split(",")],
                 bool(args.control), device, args.out)
    else:
        sweep(args.cell, args.seed, [int(x) for x in args.beams.split(",")], args.seconds,
              device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
