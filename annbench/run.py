"""Run one cell of the benchmark once and print one JSON line.

    python3 -m annbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up draws the points and the query pool from the seed on the card,
builds the index through the port's public API and warms up the cell's
batch shape; ``setup_s`` runs from the start of this module to the end of
the warm-up. The window then feeds the closed loop for ``--seconds``.
With ``--trace 1`` two traced stretches of whole batches run inside the
window (``trace.py``) and the line carries the per-layer metrics, else
the end-to-end ones. After the window the device's peak memory is read,
the index is freed, and the plain reference judges every pool query's
answers (``correct.py``). Exit codes: 0 with a result line, 2 without a
card (or fewer than the cell asks for), 3 with a JAX module loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from annbench import guard, spec  # noqa: E402


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    cell: spec.Cell
    spans: dict  # host seconds: setup_s, build_s
    window: object  # loop.Window
    trace: object  # trace.Trace or None
    recall: float | None
    peak_bytes: int


def power_limit_w():
    """The card's power limit in watts from nvidia-smi, None if unread."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
             "-i", "0"], capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
            start: float = T0) -> dict:
    """Set up, run the window, judge the answers -> the result object."""
    import torch

    from annbench import correct, data, loop
    from annbench import trace as tr
    from annbench.reference import knn

    cfg, trf = cell.config, cell.traffic
    cuda = device.type == "cuda"
    spans = {}
    points, pool = data.make(cfg, trf["pool"], seed, device)
    system = spec.system(cfg["index"]).System(cfg, points, seed, spans)
    lp = loop.ClosedLoop(system.searcher(trf), loop.slots(pool, trf["batch"]), device,
                         trf["in_flight"])
    lp.pump(count=trf["warmup_batches"])
    spans["setup_s"] = time.perf_counter() - start

    traced = {}
    during = None
    if trace:
        if not cuda:
            raise RuntimeError("a traced run needs the card")
        during = lambda lo: traced.update(t=tr.trace_stretch(lo, trf["trace_batches"], device))  # noqa: E731
    win = lp.window(seconds, during)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    guard.require_clean("after the window")
    if trace and traced.get("t") is None:
        raise RuntimeError("the profiler saw no device activity in the traced stretch")

    ids, dists = lp.answers()
    state = system.state()
    del system, lp
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    n = cfg["data"]["n"]
    gt = knn.exact_knn(points, n, pool, trf["k"])
    ctx = correct.context(points, n, pool, ids, dists, gt, state)
    values = correct.numbers(ctx, cell.limits)
    ok = correct.judge(values, cell.limits)

    run = Run(cell=cell, spans=spans, window=win, trace=traced.get("t"),
              recall=ctx.recall, peak_bytes=peak)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": int(peak)}
    if cuda:
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": bool(ok), "attempted": int(win.queries),
              "failed": int((~ctx.well_formed).sum()), "metrics": metrics, "device": dev}
    if trace:
        t = run.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.wall_s
        result["breakdown"] = {"device_ops": tr.top(t.ops), "idle_gaps": tr.top(t.gaps)}
    result["checks"] = {k: {"value": v, "limit": cell.limits[k]} for k, v in values.items()}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    guard.require_clean("at start")
    cell = spec.cell(spec.load_benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"annbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    guard.require_clean("before the result")
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
