"""Exact range ground truth tool (data_tools/compute_range_groundtruth.cpp)."""

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
    p.add_argument("-radius", type=float, required=True)
    p.add_argument("-data_type", default="float",
                   choices=["float", "uint8", "int8"])
    p.add_argument("-dist_func", default="Euclidian",
                   choices=["Euclidian", "mips"])
    p.add_argument("-nonzero_path", default=None,
                   help="also write the .bin subset of query VECTORS with"
                        " >=1 in-range result (the SSNPP workflow's"
                        " nonzero-query file, write_nonzero_elts in"
                        " compute_range_groundtruth.cpp:32-58)")
    p.add_argument("-device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    dtype = {"float": np.float32, "uint8": np.uint8, "int8": np.int8}[args.data_type]
    metric = Metric.L2 if args.dist_func == "Euclidian" else Metric.MIPS
    base = PointSet.from_file(args.base_path, dtype=dtype, metric=metric,
                              device=args.device)
    q = PointSet.from_file(args.query_path, dtype=dtype, metric=metric,
                           device="cpu").to_numpy()
    gt = exact.compute_range_groundtruth(base, q, args.radius)
    io.write_range_ibin(args.gt_path, gt)
    nz = sum(1 for g in gt if len(g))
    print(f"Wrote range GT for {len(q)} queries ({nz} non-empty) to {args.gt_path}")
    if args.nonzero_path:
        keep = np.asarray([len(g) > 0 for g in gt], dtype=bool)
        io.write_bin(args.nonzero_path, np.ascontiguousarray(q[keep]))
        print(f"Wrote {int(keep.sum())} nonzero-result query vectors to "
              f"{args.nonzero_path}")


if __name__ == "__main__":
    main()
