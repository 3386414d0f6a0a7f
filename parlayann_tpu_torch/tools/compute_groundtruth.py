"""Exact k-NN ground truth tool (data_tools/compute_groundtruth.cpp:104):
the exact flat scan (search/exact.py) over query batches; writes the
big-ann ibin format."""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.data import io
    from parlayann_tpu_torch.search import exact

    p = argparse.ArgumentParser(prefix_chars="-")
    p.add_argument("-base_path", required=True)
    p.add_argument("-query_path", required=True)
    p.add_argument("-gt_path", required=True)
    p.add_argument("-k", type=int, default=100)
    p.add_argument("-data_type", default="float",
                   choices=["float", "uint8", "int8"])
    p.add_argument("-dist_func", default="Euclidian",
                   choices=["Euclidian", "mips"])
    p.add_argument("-normalize", action="store_true")
    p.add_argument("-device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dtype = {"float": np.float32, "uint8": np.uint8, "int8": np.int8}[args.data_type]
    metric = Metric.L2 if args.dist_func == "Euclidian" else Metric.MIPS
    base = PointSet.from_file(args.base_path, dtype=dtype, metric=metric,
                              normalize=args.normalize, device=args.device)
    q = PointSet.from_file(args.query_path, dtype=dtype, metric=metric,
                           normalize=args.normalize, device="cpu").to_numpy()
    ids, dists = exact.compute_groundtruth(base, q, args.k)
    io.write_ibin(args.gt_path, ids, dists)
    print(f"Wrote {len(q)} x {args.k} ground truth to {args.gt_path}")


if __name__ == "__main__":
    main()
