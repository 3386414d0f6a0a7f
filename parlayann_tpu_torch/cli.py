"""Command line — flag-compatible with the reference benchmark CLI.

Counterpart of parlayann_tpu/cli.py (algorithms/bench/neighborsTime.C:
73-253 + parse_command_line.h): the same single-dash flags and flow. Load
the points, build or load a graph, run the recall/QPS sweep
(search_and_parse), optionally save the graph and append CSV results; or
run the range modes. One flag more, ``-device``: everything runs on the
CUDA card unless it names another device (``-device cpu``).

Usage:
  python -m parlayann_tpu_torch.cli -base_path base.fbin -query_path q.fbin \
      -gt_path gt.ibin -R 64 -L 128 -alpha 1.2 -two_pass 1 \
      -data_type float -dist_func Euclidian -graph_outfile out.graph
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="parlayann_tpu_torch", description=__doc__, prefix_chars="-",
        fromfile_prefix_chars="@",
    )
    a = p.add_argument
    a("-base_path", type=str, required=True)
    a("-query_path", type=str, default=None)
    a("-gt_path", type=str, default=None)
    a("-graph_path", type=str, default=None, help="load a prebuilt graph")
    a("-graph_outfile", type=str, default=None, help="save the built graph")
    a("-res_path", type=str, default=None, help="append CSV results")
    a("-algorithm", type=str, default="auto",
      choices=["auto", "cluster"],
      help="auto = infer the graph family from the reference's flags "
           "(alg_type, types.h:154-245); cluster = the two-level cluster "
           "index (build/clusterindex.py)")
    a("-cluster_m", type=int, default=64,
      help="cluster index: members per cluster")
    a("-data_type", type=str, default="float", choices=["float", "uint8", "int8"])
    a("-dist_func", type=str, default="Euclidian", choices=["Euclidian", "mips"])
    a("-normalize", action="store_true")
    a("-k", type=int, default=10)
    a("-R", type=int, default=0)
    a("-L", type=int, default=0)
    a("-alpha", type=float, default=1.0)
    a("-num_passes", type=int, default=1)
    a("-two_pass", type=int, default=0)
    a("-single_batch", type=int, default=0)
    a("-quantize_bits", type=int, default=0)
    a("-quantize", type=int, default=0, choices=range(6),
      help="two-level quantize mode (vamana/neighbors.h:117-186): 1=q8; "
           "Euclidian: 2=+1-bit tier, 3=+JL-sparse-1024; mips: 2=+1-bit, "
           "3=+2-bit ternary, 4=+JL-bit-512, 5=+JL-sparse-1500")
    a("-m_l", type=float, default=0.0)
    a("-num_clusters", type=int, default=0)
    a("-cluster_size", type=int, default=0)
    a("-mst_deg", type=int, default=0)
    a("-delta", type=float, default=0.0)
    a("-radius", type=float, default=0.0)
    a("-radius_2", type=float, default=0.0)
    a("-range", dest="range_", action="store_true")
    a("-self", dest="self_", action="store_true")
    a("-Q", type=int, default=0, help="fixed beam width (skips the sweep)")
    a("-cut", type=float, default=1.35)
    a("-limit", type=int, default=0)
    a("-rerank_factor", type=int, default=10)
    a("-trim", type=float, default=0.0)
    a("-verbose", action="store_true")
    a("-device", type=str, default=None,
      help="torch device (default: the CUDA card; 'cpu' for the CPU)")
    return p


def main(argv=None):
    from parlayann_tpu_torch.types import BuildParams, Metric
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.data.graph import GraphIndexData
    from parlayann_tpu_torch.data import io
    from parlayann_tpu_torch.index import Index
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.harness import sweep as sweep_mod
    from parlayann_tpu_torch.harness.csv import GraphRecord, write_to_csv
    from parlayann_tpu_torch.utils.device import resolve

    args = make_parser().parse_args(argv)
    dev = resolve(args.device)
    dtype = {"float": np.float32, "uint8": np.uint8, "int8": np.int8}[args.data_type]
    metric = Metric.L2 if args.dist_func == "Euclidian" else Metric.MIPS

    ps = PointSet.from_file(args.base_path, dtype=dtype, metric=metric,
                            normalize=args.normalize, device=dev)
    print(f"Data: detected {ps.n} points with dimension {ps.d}")

    bp = BuildParams(
        R=args.R, L=args.L, alpha=args.alpha,
        num_passes=2 if args.two_pass else args.num_passes,
        single_batch=args.single_batch, quantize=args.quantize_bits,
        m_l=args.m_l, num_clusters=args.num_clusters,
        cluster_size=args.cluster_size, MST_deg=args.mst_deg,
        delta=args.delta, radius=args.radius, radius_2=args.radius_2,
        self_=args.self_, range_=args.range_, trim=args.trim,
        verbose=args.verbose,
    )

    if args.algorithm == "cluster":
        return _cluster_main(args, ps, metric)

    t0 = time.perf_counter()
    alg = bp.alg_type
    if args.graph_path:
        graph = GraphIndexData.load(args.graph_path, device=dev)
        build_time = 0.0
    else:
        if alg == "vamana":
            from parlayann_tpu_torch.build.vamana import build_vamana_graph

            # -quantize != 0 also quantizes the BUILD of float points to one
            # byte (vamana/neighbors.h:118-119), with -trim's MIPS scale;
            # uint8 points build on an exact float32 copy (the kernels read
            # int8 or float32 rows)
            build_ps = (quantize.quantize_pointset(ps, bits=8, trim=args.trim)
                        if args.quantize and ps.data.dtype.is_floating_point
                        else quantize.build_tier(ps, False))
            graph, _ = build_vamana_graph(build_ps, bp, verbose=args.verbose)
        elif alg == "HCNNG":
            from parlayann_tpu_torch.build.hcnng import build_hcnng_graph

            graph, _ = build_hcnng_graph(ps, bp, verbose=args.verbose)
        elif alg == "pyNNDescent":
            from parlayann_tpu_torch.build.pynndescent import build_pynndescent_graph

            graph, _ = build_pynndescent_graph(ps, bp, verbose=args.verbose)
        else:  # HNSW
            from parlayann_tpu_torch.build.hnsw import build_hnsw_graph

            hnsw, _ = build_hnsw_graph(ps, bp, verbose=args.verbose)
            graph = hnsw.base_graph()
        build_time = time.perf_counter() - t0
        avg, mx = graph.stats()
        print(f"Built {alg} graph in {build_time:.3f}s, "
              f"avg degree {avg:.2f}, max degree {mx}")

    if args.graph_outfile:
        graph.save(args.graph_outfile)

    if args.self_ and args.range_:
        # range self-join (vamanaRange/neighbors.h:93-117)
        from parlayann_tpu_torch.search.range import self_join

        res, cmps = self_join(
            ps.data, graph.neighbors, graph.degrees, args.radius,
            args.radius_2 or args.radius, metric=metric, n_valid=ps.n,
        )
        total = sum(len(r) for r in res)
        print(f"Self-join: {total} edges, {cmps} distance comparisons")
        return 0

    if not args.query_path:
        return 0
    Q = PointSet.from_file(args.query_path, dtype=dtype, metric=metric,
                           normalize=args.normalize, device="cpu").to_numpy()

    if args.range_:
        # query-driven range track: sweep initial beams and print the
        # per-beam pointwise/cumulative recall + QPS table
        # (check_range_recall.h:67-84, vamanaRange/range.h:40-69)
        from parlayann_tpu_torch.harness.range_sweep import range_search_wrapper

        rgt = io.read_range_ibin(args.gt_path) if args.gt_path else [
            np.zeros(0, np.int32) for _ in range(len(Q))
        ]
        range_search_wrapper(
            Q, ps.data, graph.neighbors, graph.degrees, rgt, args.radius,
            metric=metric, n_valid=ps.n, verbose=True,
        )
        return 0

    gt_ids = gt_dists = None
    if args.gt_path:
        gt_ids, gt_dists = io.read_ibin(args.gt_path)

    idx = Index(points=ps, graph=graph)
    if args.quantize:
        # two-level tier dispatch (vamana/neighbors.h:117-186): level 1 is
        # always the 1-byte scalar tier; modes >= 2 add the aggressive
        # search tier (search on it, rerank at full precision)
        idx.enable_quantized(bits=8, trim=args.trim)
        if metric is Metric.L2:
            if args.quantize == 2:  # Euclidean_Bit_Point
                idx.enable_bit_tier()
            elif args.quantize == 3:  # Euclidean_JL_Sparse_Point<1024>
                idx.enable_jl(jl_dims=1024, bits=8, sparse_nnz=6)
        else:
            if args.quantize == 2:  # Mips_Bit_Point
                idx.enable_bit_tier()
            elif args.quantize == 3:  # Mips_2Bit_Point
                idx.enable_mips_2bit()
            elif args.quantize == 4:  # Mips_JL_Bit_Point<512>
                idx.enable_jl(jl_dims=512, bits=1)
            elif args.quantize == 5:  # Mips_JL_Sparse_Point<1500>
                idx.enable_jl(jl_dims=1500, bits=8, sparse_nnz=6)
    elif args.quantize_bits:
        idx.enable_quantized(bits=args.quantize_bits, trim=args.trim)

    if args.Q:
        r = sweep_mod.check_recall(
            idx, Q, gt_ids, gt_dists, args.k, args.Q, cut=args.cut,
            limit=args.limit or None, verbose=True,
        )
        best = [(r.recall, r)]
    else:
        _, best = sweep_mod.search_and_parse(
            idx, Q, gt_ids, gt_dists, k=args.k, verbose=args.verbose,
        )
        for bucket, r in best:
            r.print()

    if args.res_path:
        avg, mx = graph.stats()
        rec = GraphRecord(
            name=alg, params=f"R={args.R} L={args.L} alpha={args.alpha}",
            size=ps.n, time=build_time, avg_deg=avg, max_deg=mx,
        )
        write_to_csv(args.res_path, best, rec)
    return 0


def _cluster_main(args, ps, metric):
    """-algorithm cluster: build or load the two-level cluster index and run
    an n_probe sweep with the same printed protocol as the graph sweep
    (check_nn_recall.h output format; beamQ column = n_probe)."""
    from parlayann_tpu_torch.build.clusterindex import ClusterIndex
    from parlayann_tpu_torch.data import io
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.harness.recall import NNResult, compute_recall, mean_p99
    from parlayann_tpu_torch.harness import sweep as sweep_mod
    from parlayann_tpu_torch.harness.csv import GraphRecord, write_to_csv

    t0 = time.perf_counter()
    if args.graph_path:
        ci = ClusterIndex.load(args.graph_path, ps)
        build_time = 0.0
    else:
        ci = ClusterIndex.build(ps, m=args.cluster_m)
        build_time = time.perf_counter() - t0
        print(f"Built cluster index in {build_time:.3f}s, "
              f"C={ci.C} m={ci.m} Rc={ci.Rc}")
    if args.graph_outfile:
        ci.save(args.graph_outfile)
    if not args.query_path:
        return 0
    Q = PointSet.from_file(args.query_path, metric=metric, normalize=args.normalize,
                           device="cpu").to_numpy()
    gt_ids = gt_dists = None
    if args.gt_path:
        gt_ids, gt_dists = io.read_ibin(args.gt_path)

    probes = [args.Q] if args.Q else [4, 6, 8, 12, 16, 24, 32, 48]
    results = []
    for npr in probes:
        if npr > ci.C:
            break
        ids, _, (nvo, cmps), dt = ci.search_timed(
            Q, k=args.k, n_probe=npr, cut=0.0, rerank_factor=args.rerank_factor)
        rec = (compute_recall(ids.cpu().numpy(), gt_ids, gt_dists, args.k)
               if gt_ids is not None else 0.0)
        ac, tc = mean_p99(cmps.cpu().numpy())
        av, tv = mean_p99(nvo.cpu().numpy())
        r = NNResult(recall=rec, QPS=len(Q) / dt, avg_cmps=ac, tail_cmps=tc,
                     avg_visited=av, tail_visited=tv, k=args.k, beamQ=npr,
                     cut=0.0, limit=npr, degree_limit=ci.Rc, num_queries=len(Q))
        r.print()
        results.append(r)
        if rec > 0.999:
            break
    best = sweep_mod.parse_result(results, sweep_mod.BUCKETS)
    if args.res_path:
        rec_row = GraphRecord(
            name="cluster", params=f"m={ci.m} Rc={ci.Rc} C={ci.C}",
            size=ps.n, time=build_time, avg_deg=float(ci.m), max_deg=ci.m,
        )
        write_to_csv(args.res_path, best, rec_row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
