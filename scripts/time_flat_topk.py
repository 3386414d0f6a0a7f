"""Time kernel 4 (``flat_topk``) of a checkout of the PyTorch port on one card.

Usage, on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/time_flat_topk.py [--root DIR] [--reps N] [--tag NAME]

Imports ``parlayann_tpu_torch`` from DIR (default: this repository), builds
its kernels, and times ``flat_topk`` at chip_smoke.py's phase-2 shape: the
synthetic clustered 100K x 128 set (seed 7) and its 10K queries, k=10, L2,
on f32 points and on the q8 tier (int8 points, translated queries). Times
are device times from CUDA events over back-to-back launches after a
warm-up. Prints one JSON line with the card's name and power limit. To
compare versions on one card, run it on each checkout in turns (A, B, B, A)
in one call on one machine.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose parlayann_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="", help="a name for the checkout in the output")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path[:0] = [root, str(REPO)]  # the timed package first; chip_smoke's timer

    import torch
    from chip_smoke import card_line, time_ms

    if not torch.cuda.is_available():
        sys.exit("time_flat_topk: no CUDA device")
    import parlayann_tpu_torch
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels import _lib
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
    from parlayann_tpu_torch.utils import synthetic

    if not parlayann_tpu_torch.__file__.startswith(root):
        sys.exit(f"time_flat_topk: imported {parlayann_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0
    X, Q = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=7)
    ps = PointSet.from_numpy(X, device=dev)
    q = torch.from_numpy(Q).to(dev)
    tier = quantize.quantize_pointset(ps, bits=8)
    q8 = quantize.translate_query(q, tier).float()
    kw = dict(k=10, metric=Metric.L2, n_valid=len(X))
    out = {"tag": args.tag, "root": root, "build_s": build_s}
    for name, qq, xx in (("f32", q, ps.data), ("int8", q8, tier.data)):
        out[f"{name}_ms"] = time_ms(lambda: flat_topk(qq, xx, **kw), args.reps)
    out["card"] = card_line()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
