"""Random subset of a bin file (data_tools/random_sample.cpp)."""

import argparse

import numpy as np


def main(argv=None):
    from parlayann_tpu_torch.data import io

    p = argparse.ArgumentParser(prefix_chars="-")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("-n", type=int, required=True)
    p.add_argument("-seed", type=int, default=0)
    args = p.parse_args(argv)
    data = io.read_bin(args.in_path, io.infer_bin_dtype(args.in_path))
    rng = np.random.default_rng(args.seed)
    sel = rng.choice(len(data), size=min(args.n, len(data)), replace=False)
    io.write_bin(args.out_path, data[np.sort(sel)])
    print(f"Sampled {min(args.n, len(data))} rows from {args.in_path}")


if __name__ == "__main__":
    main()
