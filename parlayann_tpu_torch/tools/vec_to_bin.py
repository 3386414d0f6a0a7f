""".fvecs/.bvecs/.ivecs -> .bin converter (data_tools/vec_to_bin.cpp)."""

import argparse


def main(argv=None):
    from parlayann_tpu_torch.data import io

    p = argparse.ArgumentParser(prefix_chars="-")
    p.add_argument("in_path")
    p.add_argument("out_path")
    args = p.parse_args(argv)
    io.vecs_to_bin(args.in_path, args.out_path)
    print(f"Converted {args.in_path} -> {args.out_path}")


if __name__ == "__main__":
    main()
