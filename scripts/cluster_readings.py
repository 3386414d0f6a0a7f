"""Readings that set the limits of the ClusterIndex cell, with its control.

    python3 scripts/cluster_readings.py --seeds 1,2,3 [--cell cluster-10m.np8]
        [--seconds 20] [--control 1] [--out file.jsonl]

For each seed, one whole run of the cell as ``annbench.run`` makes it
(``run.measure``: set-up from the seed, the closed loop for ``--seconds``,
the answers judged against the reference), and its numbers compared, its
end-to-end metrics, the index's cluster count and smallest cluster, and
the run's seconds by part (set-up, window, the judgement after it). With
``--control 1`` the same set-up then answers the pool through the
reference's cluster search twice (``reference/cluster.py``): one step
below the stated precision (a 4-bit walk, TF32 products in the rerank:
the control, which has to fail) and at it (an 8-bit walk, a float64
rerank: a second witness beside the exact ground truth), each judged by
the same numbers but those of the program's structure. One JSON line a
seed and side, also appended to ``--out``. ``setup_s`` is taken from the
start of each seed's run, so past the first seed it leaves out the
imports and the kernel library's build.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from annbench import correct, guard, run, spec  # noqa: E402
from annbench.reference import cluster  # noqa: E402

SIDES = {"control": dict(bits=4, tf32=True), "reference": dict(bits=8, tf32=False)}
STRUCTURE = ("q8_off", "partition_bad")  # numbers of the program's set-up alone


def _emit(out, rec):
    line = json.dumps(rec)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def readings(cell_name, seeds, seconds, with_control, device, out):
    cell = spec.cell(spec.load_benchmark(), cell_name)
    held = {}
    context = correct.context

    def keep(*a, **kw):
        held["ctx"] = context(*a, **kw)
        return held["ctx"]

    correct.context = keep
    try:
        for seed in seeds:
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            res = run.measure(cell, seed, seconds, False, device, start=t0)
            wall = time.perf_counter() - t0
            ctx = held.pop("ctx")
            st = ctx.state
            fill = (np.asarray(st["members"]) >= 0).sum(axis=1)
            m = {k: v["value"] for k, v in res["metrics"].items()}
            _emit(out, dict(
                seed=seed, cell=cell_name, side="program", correct=res["correct"],
                **{k: v["value"] for k, v in res["checks"].items()}, **m,
                C=int(fill.shape[0]), min_fill=int(fill.min()), wall_s=wall,
                window_s=seconds, judge_s=wall - m["setup_s"] - seconds,
                peak_bytes=res["device"]["memory_peak_bytes"],
                power_limit_w=res["device"].get("power_limit_w")))
            if with_control:
                p = st["search"]
                names = [k for k in cell.limits if k not in STRUCTURE]
                for side, kw in SIDES.items():
                    t1 = time.perf_counter()
                    ids, dists = cluster.search(
                        ctx.points, ctx.n, st["queries"], st, k=ctx.k, n_probe=p["n_probe"],
                        starts=p["starts"], seed_probes=p["seed_probes"],
                        rerank_factor=p["rerank_factor"], **kw)
                    c2 = context(ctx.points, ctx.n, st["queries"], ids, dists,
                                 (ctx.gt_ids, ctx.gt_d), st)
                    vals = correct.numbers(c2, names)
                    _emit(out, dict(seed=seed, cell=cell_name, side=side, **vals,
                                    recall=c2.recall, secs=time.perf_counter() - t1,
                                    correct=correct.judge(vals, {k: cell.limits[k]
                                                                 for k in names})))
                    del c2
            del ctx, st
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        correct.context = context
    guard.require_clean("after the readings")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default="cluster-10m.np8")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--out", default=None, help="also append the lines to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    guard.require_clean("at start")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("cluster_readings: no CUDA card", file=sys.stderr)
        return 2
    readings(args.cell, [int(x) for x in args.seeds.split(",")], args.seconds,
             bool(args.control), device, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
