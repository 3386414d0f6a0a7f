"""First-n slice of a bin file (data_tools/crop.cpp)."""

import argparse


def main(argv=None):
    from parlayann_tpu_torch.data import io

    p = argparse.ArgumentParser(prefix_chars="-")
    p.add_argument("in_path")
    p.add_argument("out_path")
    p.add_argument("-n", type=int, required=True)
    args = p.parse_args(argv)
    data = io.read_bin(args.in_path, io.infer_bin_dtype(args.in_path))
    io.write_bin(args.out_path, data[: args.n])
    print(f"Cropped {args.in_path} to {min(args.n, len(data))} rows")


if __name__ == "__main__":
    main()
