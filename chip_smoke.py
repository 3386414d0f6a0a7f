"""Smoke run of the PyTorch port on one NVIDIA GPU.

Usage, from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:
  1. environment: torch, CUDA, nvcc, the card's name and power limit; build
     the CUDA kernels from ``parlayann_tpu_torch/csrc``.
  2. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with both times (CUDA events, after a warm-up); kernel
     2 at the builds' seven prune shapes, (C, R) = (96, 32), (64, 32),
     (40, 32), (128, 32), (192, 64), (50, 20) and (80, 40) over B=2048 rows of d=128,
     under L2 and MIPS, each on rows of its own metric's distances; then
     the f32 modes of kernels 1 (B=10,000 over a (100000, 32, 128) f32
     inline array) and 2 (the same seven prune shapes on f32 vectors, L2
     and MIPS, with each shape's share of rechecked tests, and integer-valued rows at
     alpha 1), each equal to its plain version, which sums in the serial
     order (kernel 1's own; kernel 2 rechecks in it); then kernel 1's int16
     mode (B=10,000 over a (100000, 32, 128) int16 inline array, L2 and
     MIPS, rows and queries at the extreme levels so that an int32 sum
     would overflow), equal to its plain version (both sum in int64); then
     the entry top-1 (``entry_top1``: B=10,000 queries against a 4,096-point
     entry tier of the 100K set, L2 and MIPS) against its plain version,
     ids equal or within rounding of the best entry in float64, timed beside
     its bound, the plain chain and ``torch.addmm`` + ``argmin``.
  3. the slice through the user entry points: a q8 Vamana build of the
     synthetic clustered 100K x 128 set (R=32, L=64, alpha=1.2, two passes,
     batch_cap_frac=0.16), then q8 ``Index.batch_search`` of 10K queries at
     beams 10/16/32/64 against exact ground truth. Every kernel's launch
     count is zeroed before and read after these searches; one more
     search at beams 10 and 64 runs under torch.profiler (device split and
     idle share). The same build then runs once more under
     torch.profiler, which prints kernel 2's summed device time and
     launches and the build's idle share. Kernel 3 is then checked
     against its plain version on the built graph, all four outputs
     equal, at B = 1024 and 10,000 queries x L = 10 and 64, and timed at
     each; then kernel 3's build mode (``build_beam_fused``) at a steady
     batch of the build, B = 16,000 of the q8 tier's rows walking from
     point 0 for vmax = 64 expansions, all four outputs equal to its plain
     version, timed with its bound and a step's time, with the walk the
     launcher takes and the share of step distances whose tier row the
     walk did not read again; before it, each of kernel 3's walks
     (``walk_regs<P,CP>``, ``walk_smem``) with its registers, spilled
     bytes and resident warps an SM.
  3b. the fused read phase at 100K, on phase 3's set and ground truth: at
     bench.py's two configurations (R=32 L=64 alpha 1.2 and R=64 L=128
     alpha 1.15, two passes at 0.16), a lock-step build (phase 3's at
     R=32) and a ``fused_read=True`` build, each timed (fenced), built
     again with ``profile=True`` for its beam / bidirect / prune split, and
     searched on the q8 tier at beams 10/16/32/64; kernel 3's build mode
     is held to its plain version and timed at R=64 L=128 (vmax 128, the
     widest register walk) as phase 2 does at R=32. Each fused build reaches
     recall@10 ``RECALL_BAR`` at beam 64 and lies within ``FUSED_GAP`` of
     the lock-step build's at beams 10 and 64; it launches
     ``build_beam_fused`` once a steady batch a pass (10), and kernel 1
     exactly the lock-step read's steady steps fewer (320 at R=32).
  4. the ClusterIndex slice on the same set: ``build_cluster_index`` (m=64,
     Rc=16, slack 1.5) with the f32 and the int8 ext layout, each searched
     by 10K queries at n_probe 3/4/6/8/12/16 with cut=0 and at the adaptive
     (12, 2, 1.35) setting; one more f32 search at n_probe 8 and at the
     adaptive row each runs under torch.profiler (device split, idle share,
     kernel 5's share). Kernel 5 is then checked against its plain version
     on each built index at B = 1024 and 10,000 queries (n_probe 16 and the
     adaptive row) and timed at both.
  5. the FlatIndex slice on the same set: f32 and q8 tiers through kernel 4.
  7. the f32 tier at 100K, on the same set and ground truth: a Vamana build
     on the f32 points (phase 3's parameters, ``quantize_build=False``;
     kernel 1 on f32 rows in its steady batches, kernel 2 on f32 vectors),
     the f32 ``Index.batch_search`` (no quantized tier: the lock-step
     search over f32 inline rows, no rerank) at beams 10/16/32/64, and
     phase 3's q8 index searched at beam 64 with ``expand=2`` and with
     ``degree_limit=16`` (the lock-step search over int8 inline rows, then
     the rerank). One more f32 search at beam 64 runs under torch.profiler.
     Kernel 1's f32 and int8 modes and kernel 2's f32 mode must have
     launched. Phase 7 runs before phase 6.
  6. the capacity tiers at the size of scripts/bench_1m_tiers.py: synthetic
     clustered 1M x 128 (10K clusters, 10K queries), a q8 Vamana build (R=32,
     L=64, alpha=1.2, two passes, batch_cap_frac=0.04), exact ground truth
     on the card, then ``Index.batch_search_timed`` on the packed 1-bit tier
     and on the JL sign-bit tier of 512 dims at beams 100/220/400
     (rerank_factor 20), and on the sparse JL 8-bit tier of 1024 dims at
     beam 100. One more search of each tier at its first beam runs under
     torch.profiler, which prints the device's busy time, idle share and
     top kernels. Then the same q8 build with ``fused_read=True`` (46
     ``build_beam_fused`` launches), timed, with recall@10 at beams 10 and
     64 within ``FUSED_GAP`` of phase 6's graph on the q8 tier, and kernel
     3's build mode at that build's steady batch (B = 40,000 of the tier's
     rows over phase 6's graph, vmax 64), held to its plain version and
     timed with its bound as phase 2 does at 100K. Kernel 6 is
     then checked against its plain version on the tiers' inline words (W
     = 4 and W = 16).
  8. HNSW at 100K, on phase 3's set and ground truth: build A, the JAX
     package's default and ParlayANN's SIFT-100K configuration
     (``build_hnsw_index(X, m=20, efc=50, alpha=0.9, m_l=0.34)``, f32,
     ``batch_cap_frac=0.02``), and build B, the q8 build
     (``quantize_build=True``, ``batch_cap_frac=0.08``: kernel 1 on int8
     inline rows in its level-0 batches, kernel 2 in int8, kernel 4 on int8
     level points); each prints its fenced seconds, level sizes, degrees
     and entrance list. ``batch_search_timed`` of 10K queries at ef 12, 16,
     22, 30 and 50 on build A and ef 12 and 50 on build B (recall@10 at ef
     50 at least 0.95 on both). Kernels 1 (int8 rows), 2 (f32 and int8), 3
     and 4 must launch. Build A runs once more under torch.profiler (idle
     share, kernels 2 and 4's device ms and launches), and one search at ef
     12 too. Kernel 4's masked mode is then checked against its plain
     version on build A's f32 level 1 and build B's int8 level 1, with the
     build's own mask of inserted members (from ``hnsw.insert_plan``) and
     each row's exclusion, at B = 2000, k = 50; kernel 3 on build A's
     degree-40 level 0 with its level-1 entry tier, at B = 10,000 and
     L = 12 and 50 (the search's ef), equal to its plain version. Phase 2 also holds
     kernel 1 at R8 = 40 (HNSW's level 0) and kernel 2 at (C, R) = (50, 20)
     (its forward prune) to their plain versions.
  9. HCNNG and pyNNDescent at 100K, after phase 8. HCNNG on phase 3's set
     and ground truth: ``build_hcnng_index(X, mst_deg=3, num_clusters=30,
     cluster_size=1000)``, f32, the JAX package's default and ParlayANN's
     SIFT-100K configuration; its fenced seconds split into label trees,
     candidate passes (the host's queueing and waits), Kruskal and
     assembly; the q8 search at beams 10/16/32/64 (recall@10 at beam 64
     at least 0.95). pyNNDescent
     on ``synthetic.uniform(100_000, 128, n_queries=10_000)`` (the
     clustered set splits a k-NN graph into its 1000 islands) with exact
     ground truth on the card: build A, ``build_pynndescent_index(X,
     max_deg=40, cluster_size=100, num_clusters=10, alpha=1.2,
     delta=0.05)`` in f32, and build B, the same with
     ``quantize_build=True``; each prints its seconds, rounds and changed
     counts, degrees and the share of the true 10 nearest neighbours its
     rows hold (1,000 sampled points), and is searched on the q8 tier with
     one random start a query at beams 30/55/80 (recall@10 at beam 80 at
     least ``PYNN_BAR``). One descent round's draws are timed on the host
     and on the card's generator. Kernels 2 (f32 and int8) and 3 must
     launch. Kernel 3 is then checked against its plain version on the
     HCNNG graph (degree up to 90: the shared-memory walk) at B = 1024 and
     10,000 x L = 10 and 64, and on build A's graph with its random starts
     at B = 10,000, L = 80, and timed at each.
  10. the reference's command line, tools and range search, after phase 9.
     10a, the tutorial's k-NN flow (scripts/tutorial.sh) on phase 3's set
     written as .fbin files: ``tools.compute_groundtruth -k 10``, a CLI
     build (``-R 32 -L 64 -alpha 1.2 -two_pass 1 -quantize 1
     -graph_outfile``, the CLI's batch_cap_frac 0.02), a CLI search at
     ``-Q 64`` (recall@10 at least ``RECALL_BAR``) and the CLI's full
     sweep with ``-res_path`` (a CSV bucket at 0.95 or above); kernels 2
     and 3 must launch. 10b, an SSNPP-shaped range run (scripts/ssnpp_range,
     scripts/bench_range.py): ``synthetic.clustered(1_000_000, 256,
     n_queries=10_000, n_clusters=10_000)`` mapped onto uint8 by one affine
     map of the base's range, the radius the 20th percentile of the
     queries' exact 1-NN squared distances, a Vamana build (R=64, L=128,
     alpha=1.0, two passes, uint8 on its exact f32 copy,
     batch_cap_frac=0.04) saved as a graph file,
     ``tools.compute_range_groundtruth -nonzero_path``, the CLI's ``-range
     -self`` self-join and the same self-join once more for its lists
     (every pair within the radius by exact integer distance; cumulative
     recall over 2,000 sampled points against brute force at least
     ``SELFJOIN_BAR``), ``range_search_wrapper`` over the 10K queries at
     bench_range's beams 10-100 (cumulative recall at beam 100 at least
     ``RANGE_BAR``; every id at its exact distance within the radius),
     ``range_search_batch`` on 256 queries on the card equal to the CPU's,
     one profiled BFS of 4,096 self-join rows, and the CLI's ``-range``
     track over all nine beams up to 3000 on a 1,000-query crop made by
     ``tools.crop``; kernel 2's f32 mode must launch.
  11. the last tiers and build modes, after phase 6. 11a, on phase 3's set,
     q8 graph and ground truth: ``enable_quantized(bits=16)`` searched at
     beams 10-64 (the lock-step search on kernel 1's int16 mode; recall@10
     at beam 64 at least ``RECALL_BAR``), its walk of 256 queries equal on
     the card and the CPU, and ``enable_quantized(bits=4)`` (int8 levels,
     kernel 3) with its recall printed. 11b, on phase 3's set: one steady
     batch's phase split (``profile_one_batch``), a ``cand_mode="exact"``
     build with ``profile=True`` (its split printed; recall@10 at beam 10
     within ``EXACT_GAP`` of phase 3's build; kernels 2 and 4's masked mode
     must launch) and a ``single_batch=8`` build (recall@10 at beam 64 at
     least ``SB_BAR``; kernel 1 in its read phase). 11c, MIPS at 1M on
     scripts/bench_mips_u8.py's construction
     (``synthetic.sparse_clustered_u8``, normalized): the q8 build (R=32,
     L=64, alpha 0.98, two passes, batch_cap_frac 0.16), exact ground truth,
     the q8 sweep on kernel 3 (beams 10-240), the 4-bit (22-160) and 2-bit
     (33-240) tiers, the trimmed q8 tier (``trim=0.001``) and the f32 walk
     without and with the q8 tier's running-mean filter at beams 10 and 22;
     q8 and 4-bit must reach ``MIPS_BAR`` within their beams, the 2-bit tier
     ``MIPS_2BIT_BAR`` at beam 240.
  12. the hierarchical ClusterIndex at 10M, after phase 11c, on
     scripts/bench_10m_cluster.py's construction drawn on the card (100,000
     centres from N(0, 1), each of 10M points and 10K queries a uniformly
     chosen centre plus 0.35 N(0, 1)), the exact top-20 on kernel 4 as
     ground truth: ``build_cluster_index(X, m=64, Rc=16, slack=2.0,
     cand=8, ext_dtype="int8", verbose=True)`` (C = 312,500: the
     meta-routed rounds on kernel 1's multi-probe mode over f32 blocks, one
     launch a chunk of 16,384 points, the teleports, the respill, the
     polish, the routed adjacency and the seed quantizer; the build prints
     its split, summed beside ``HIER_SINGLE_MODE``'s), its (Cm, cap) cells,
     ext size and peak device memory, kernel 1's launches by mode (at least
     one multi launch a router chunk, no single-mode launch); then 10K
     queries at ``seed_probes=16``, n_probe 8, 16 and 32 at cut 0 and the
     adaptive row (32, 4, 1.35), each through the meta seed (kernel 1's
     multi mode on int8 blocks), and n_probe 8 with
     ``seed_mode="stream"``; recall@10 at n_probe 8 through the meta seed
     at least ``HIER_BAR``, no cluster empty, and every query K results
     on the cut-0 rows (the adaptive row's queries short of K are counted:
     its expanded clusters can hold fewer than K points). Phase 2 then
     holds kernel 1 to its plain version on the router's f32 blocks (R8 =
     112, B = 8192, each query at its nearest cell) and the seed's int8
     blocks (R8 = 24, B = 10,000); the multi mode at the router's real
     shape (the first 16,384 points at their top-16 cells) and the seed's
     (the 10K q8 queries at their top 16), each equal to its plain version and to 16 single launches, timed
     beside them with its bound and its grouping / scoring split; one
     router chunk fenced and split into the meta-centroid scan and
     select (kernel 4), kernel 1, the mask and gather, and
     ``smallest_k``; kernel 4 as that scan at the router's and the seed's
     shapes (top-16) against the plain path; and kernel 5 over the 10M
     ext at n_probe 8 from the meta seeds.
  13. the multi-device modes (``parlayann_tpu_torch.parallel``), after
     phase 12, on phase 6's set (synthetic clustered 1M x 128, 10K
     queries) with exact ground truth from kernel 4, in a process group of
     one rank on NCCL (``init_process_group("nccl", init_method="file://...",
     rank=0, world_size=1, device_id=cuda:0)``; the NCCL version printed):
     ``build_sharded_vamana`` and ``build_global_vamana`` on the f32 points
     (R=32, L=64, alpha=1.2, two passes, batch_cap_frac=0.04; kernel 2's
     f32 mode must launch in each), each searched at beams 10-128 from
     point 0 as the JAX package searches (recall@10 at beam 128 at least
     ``RECALL_BAR``), beside a single-card f32 ``build_vamana_index`` of the
     same data and parameters searched at beam 64 from its entry tier and
     from point 0; ``build_sharded_cluster`` (m=64, Rc=16, slack 1.5,
     iters 6, cand 8) searched at n_probe 4/8/16, its recall@10 at n_probe
     8 within ``PAR_GAP`` of a single-card int8 ``build_cluster_index`` on
     the same data; each mode's search of ``PAR_CHECK`` queries on the card
     equal to the same search on the CPU through a gloo sub-group of the
     same world; each build's fenced seconds, each search's QPS and the
     peak device memory; the group is destroyed at the end.
  Launch counts are zeroed just before phases 3, 4, 5, 7, 8, 9, 10a, 10b,
  6, 11a, 11b, 11c and 12, and before each build of phases 3b, 6 (the
  fused build) and 13, and read just after each; every kernel of the
  phase's path must have launched.

Kernel times are device times from CUDA events over back-to-back launches
(the stream sleeps while the host queues them). Each kernel's entry in the
JSON summary carries its bound: the larger of
the bytes it must move over 3.35 TB/s and its operations over 67 T/s (the
H100's published device-memory rate and f32 rate outside the tensor cores;
the XOR and popcount of kernel 6 are counted at that rate too), from this
run's inputs, with data-dependent walks counted from their returned visit
and distance counts, each input row counted once (kernel 3: the distinct
tier rows scored and adjacency rows visited, from the plain walk's
expanded ids; kernel 5: the distinct expanded ext rows, their id planes
and valid vectors, and f32 rows' operations at the f32 rate, int8 rows'
at the int8 rate). Kernel 4 runs on
the tensor cores in 3xTF32, so its operations are 3 TF32 passes (2 for
int8 points) of 2 B N d over 495 T/s, the H100 SXM dense TF32 rate; its
masked mode counts N as the points in the valid mask, and on int8 points
with integer-valued queries its 2 B N d operations at the int8 rate (the
TF32 passes' bound printed beside it);
kernel 2's are its stars' 2 C d int8 products and kernel 3's its 2 d int8
products and sums a distance (integer-valued queries on the int8 tier),
both over 1,979 T/s, the dense int8 rate (kernel 2's f32 mode runs 3xTF32
on the tensor cores: its stars' 3 x 2 C d operations over 495 T/s, as
kernel 4's; the f32-core bound of its earlier design, 2 C d over 67 T/s,
is printed beside it); kernel 2's bytes are each row's
distances and rounds (8 B C) and its live candidates' vectors.
``library_ms`` is one PyTorch call
computing the same function where there is one (kernel 4: the cuBLAS product of the
same distance matrix, which is not the top-k; the entry top-1: ``torch.addmm``
of the biased product, then ``argmin``), else null. The entry top-1's bound
counts 3 TF32 passes of 2 B E d over 495 T/s, as kernel 4's; its
``max_abs_err`` (L2; ``mips_max_abs_err``) is the worst float64 distance
gap between its entry and the best one over the queries whose ids differ
from the plain chain's (``differ`` of them; ``rel_gap`` the worst gap
relative to the best distance), 0 where none differ.

The second-to-last line is a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``. Any failed check raises, so the script
exits non-zero and prints no result; so does a machine without a CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
K = 10
BEAMS = (10, 16, 32, 64)
RECALL_BAR = 0.95  # recall@10 at beam 64
PROBES = (3, 4, 6, 8, 12, 16)
ADAPTIVE = (12, 2, 1.35)  # n_probe, min_probe, cut
CLUSTER_BAR = 0.95  # recall@10 of the f32 layout at n_probe 16, cut 0
FLAT_BAR = 0.999  # recall@10 of the f32 FlatIndex
TIER_N = 1_000_000
TIER_BEAMS = (100, 220, 400)
# recall@10 floors of phase 6: (tier, beam) -> floor, below the JAX
# package's 1M anchors (BENCHES.md:627-640)
TIER_BARS = {("bit", 400): 0.88, ("jl512", 400): 0.95, ("jl1024-8bit", 100): 0.85}
HBM_BPS = 3.35e12  # H100 SXM device memory, bytes/s
F32_OPS = 67e12  # H100 SXM f32 outside the tensor cores, operations/s
TF32_OPS = 495e12  # H100 SXM dense TF32 tensor cores, operations/s
INT8_OPS = 1979e12  # H100 SXM dense int8 tensor cores, operations/s


def log(*a):
    print(*a, flush=True)


_START = time.perf_counter()


def phase(title):
    """A phase header with the seconds since the script started."""
    log(f"== {title} (at {time.perf_counter() - _START:.1f} s)")


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout


def card_line():
    return run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).strip().splitlines()[0]


def time_ms(fn, reps):
    """Mean device milliseconds per call over ``reps`` calls, after one
    warm-up. The stream first sleeps long enough for the host to queue all
    ``reps`` calls, so a kernel shorter than its launch's host cost is
    timed back to back, not at the host's launch rate."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e6 * min(reps, 200)))  # ~1 ms of cycles a call
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_window(fn, what, attempts=3):
    """Run ``fn`` once under torch.profiler and print the device's busy
    time, its idle share of the fenced wall time, and the kernels that
    took the most device time -> dict(idle=share, by_name={kernel: device
    us}, busy_ms, wall_ms), None if the profiler saw no device activity. Only device
    activity is traced: host operators would add their own cost to the
    wall time, and their events make a build's trace slow to parse.
    The profiler now and then returns a window of a few milliseconds with
    no device events at all although its kernels ran, so a window that
    comes back empty is run again, up to ``attempts`` times in all."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, attempts + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA)
        if spans:
            break
        log(f"profile {what}: the profiler saw no device activity "
            f"(attempt {attempt} of {attempts})")
    else:
        return None
    busy, end_at, by_name = 0.0, float("-inf"), {}
    for lo, hi in spans:
        busy += max(0.0, hi - max(lo, end_at))
        end_at = max(end_at, hi)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    total = sum(by_name.values())
    log(f"profile {what}: wall {wall_us / 1e3:.3f} ms fenced, device busy "
        f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.3f}, "
        f"{len(spans)} device activities")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"    {us / 1e3:9.3f} ms {us / total:6.1%}  {name[:90]}")
    return dict(idle=1 - busy / wall_us, by_name=by_name, busy_ms=busy / 1e3,
                wall_ms=wall_us / 1e3)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def bound(nbytes, ops, rate=F32_OPS):
    """-> dict(bound_ms, bound_by): the least time the card could take, the
    larger of the bytes over the memory rate and the operations over
    ``rate``, the card's peak for the operations' type (f32 unless given)."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / rate * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def expand_ops(rows, q, n_dist):
    """Kernel 1's operations for ``n_dist`` distances from queries ``q`` to
    rows of ``rows``' dtype -> (ops, rate) for ``bound``. On int8 rows with
    integer-valued queries in [-128, 127] (the q8 tier's) the kernel sums
    exact dp4a integers, sum v q and sum v v: two int8 products and two
    additions a term at the int8 rate. Otherwise a subtraction, a
    multiplication and an addition a term at the f32 rate."""
    d = q.shape[-1]
    if rows.dtype == torch.int8 and int8_valued(q):
        return 4 * n_dist * d, INT8_OPS
    return 3 * n_dist * d, F32_OPS


def int8_valued(q):
    """True where every query value is an integer in [-128, 127], as the q8
    tier's are: a product of such queries with int8 rows is an int8 x int8
    product, and its bound counts the int8 rate."""
    return bool(((q == q.round()) & (q >= -128) & (q <= 127)).all())


def unique_rows(ids, n_pad):
    return int(torch.unique(ids.long().clamp(0, n_pad - 1)).numel())


def phase_environment():
    from parlayann_tpu_torch.ops.kernels import _lib

    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
        f"python {sys.version.split()[0]}")
    log("nvcc:", run([_lib._nvcc(), "--version"]).strip().splitlines()[-1])
    log("card:", card_line())
    seconds, report = _lib.build_report()
    log(f"kernels built and loaded in {seconds:.2f} s")
    for line in report.splitlines():
        if "Used" in line or "Compiling entry" in line or line.startswith("nvcc "):
            log("  ptxas:", line.strip())


def kernel_expand(gen, dev):
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_distances, expand_distances_plain)

    n_pad, R8, d, B = 100_000, 32, 128, 32_000
    inline = torch.randint(-128, 128, (n_pad, R8, d), generator=gen,
                           dtype=torch.int8).to(dev)
    ids = torch.randint(0, n_pad, (B,), generator=gen, dtype=torch.int32).to(dev)
    # the build path's queries: int8 points as f32 -> exact integer distances
    q_int = torch.randint(-128, 128, (B, d), generator=gen).float().to(dev)
    q_f32 = torch.randn((B, d), generator=gen).to(dev) * 50.0
    err = 0.0
    for metric in (Metric.L2, Metric.MIPS):
        out = expand_distances(inline, ids, q_int, metric=metric)
        ref = expand_distances_plain(inline, ids, q_int, metric=metric)
        check(torch.equal(out, ref), f"expand_distances {metric} not bit-equal")
        # f32 queries: the sums run in another order. L2 sums have no
        # cancellation (rtol 1e-5); a negated dot can cancel to near zero,
        # so its error is bounded by 1e-5 of the largest magnitude instead
        outf = expand_distances(inline, ids, q_f32, metric=metric)
        reff = expand_distances_plain(inline, ids, q_f32, metric=metric)
        atol = 0.0 if metric is Metric.L2 else 1e-5 * float(reff.abs().max())
        torch.testing.assert_close(outf, reff, rtol=1e-5, atol=atol)
        err = max(err, float((out - ref).abs().max()))
    ms = time_ms(lambda: expand_distances(inline, ids, q_int, metric=Metric.L2), 20)
    plain_ms = time_ms(
        lambda: expand_distances_plain(inline, ids, q_int, metric=Metric.L2), 5)
    b = bound(unique_rows(ids, n_pad) * R8 * d + B * d * 4 + B * 4 + B * R8 * 4,
              *expand_ops(inline, q_int, B * R8))
    log(f"kernel 1 expand_distances B={B} inline={tuple(inline.shape)}: "
        f"bit-equal (L2, MIPS); f32 queries within 1e-5; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def _prune_rows(gen, dev, B, C, d, mips=False, f32=False, u8=False):
    """Candidate rows as robustPrune sees them: the metric's distances to a
    point p (squared L2, or -p.c under MIPS), ascending, with a tail of INF
    (invalid) slots; int8 vectors (the q8 build), normal f32 vectors with
    their f32 distances (the f32 build), or (``u8``) f32 vectors of integer
    values in [0, 256) with their exact distances (a uint8 build's float32
    copy)."""
    from parlayann_tpu_torch.ops.distance import INF

    if u8:
        p = torch.randint(0, 256, (B, 1, d), generator=gen)
        vecs = torch.randint(0, 256, (B, C, d), generator=gen)
        f32 = True
    elif f32:
        p = torch.randn((B, 1, d), generator=gen)
        vecs = torch.randn((B, C, d), generator=gen)
    else:
        p = torch.randint(-128, 128, (B, 1, d), generator=gen)
        vecs = torch.randint(-128, 128, (B, C, d), generator=gen)
    dist = (-(vecs * p).sum(-1) if mips else ((vecs - p) ** 2).sum(-1)).float()
    n_bad = torch.randint(0, C // 4, (B, 1), generator=gen)
    dist = torch.where(torch.arange(C)[None, :] >= C - n_bad, INF, dist)
    dist, order = torch.sort(dist, dim=1, stable=True)
    vecs = torch.gather(vecs, 1, order[:, :, None].expand(B, C, d))
    return dist.to(dev), vecs.to(torch.float32 if f32 else torch.int8).to(dev)


# (C, R) of the Vamana build's prunes, the sharded builds' forward prunes
# (vmax 96 visited + 32 old edges), HNSW's forward prune and pyNNDescent's
# undirect prune
OCCLUDE_SHAPES = ((96, 32), (64, 32), (40, 32), (128, 32), (192, 64), (50, 20), (80, 40))


def kernel_occlude(gen, dev, f32=False):
    """Kernel 2 at the builds' seven prune shapes under L2 and MIPS, on int8
    or (``f32``) f32 vectors: rounds equal to the plain version (on f32
    vectors it forms the pair distances in the serial order that the
    kernel rechecks in) -> the kernels entry at (96, 32), L2, with every
    shape's times. On f32 vectors each shape also prints the share of the
    tests the rounds can read that fell inside the margin and were
    rechecked, on the normal rows and on integer-valued rows at alpha 1
    (where exact ties d(star, c) = d(p, c) occur), whose rounds are checked
    too; the bound counts the 3xTF32 operations at the TF32 rate, and the
    f32-core bound of the design before it is printed beside it."""
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.distance import INF
    from parlayann_tpu_torch.ops.kernels.occlude import (
        occlusion_rounds, occlusion_rounds_plain)

    B, d, alpha = 2048, 128, 1.2
    mode, size = (" f32", 4) if f32 else ("", 1)
    times = {}
    for C, R in OCCLUDE_SHAPES:
        for metric in (Metric.L2, Metric.MIPS):
            dist, vecs = _prune_rows(gen, dev, B, C, d, mips=metric is Metric.MIPS, f32=f32)
            what = f"kernel 2 occlusion_rounds{mode} B={B} C={C} R={R} d={d} {metric.name}"
            counts = torch.zeros(2, dtype=torch.int64, device=dev)
            out = occlusion_rounds(dist, vecs, alpha, R=R, metric=metric, counts=counts)
            ref = occlusion_rounds_plain(dist, vecs, alpha, R=R, metric=metric)
            check(torch.equal(out, ref), f"{what}: rounds differ")
            extra, note = {}, ""
            if f32:
                tests, rechecks = counts.tolist()
                check(tests > 0, f"{what}: the kernel counted no tests")
                idist, ivecs = _prune_rows(gen, dev, B, C, d, mips=metric is Metric.MIPS,
                                           u8=True)
                icounts = torch.zeros(2, dtype=torch.int64, device=dev)
                check(torch.equal(
                    occlusion_rounds(idist, ivecs, 1.0, R=R, metric=metric, counts=icounts),
                    occlusion_rounds_plain(idist, ivecs, 1.0, R=R, metric=metric)),
                    f"{what}: rounds differ on integer-valued rows at alpha 1")
                itests, irechecks = icounts.tolist()
                extra = dict(recheck_share=rechecks / tests,
                             int_recheck_share=irechecks / max(itests, 1))
                note = (f"; rechecked {rechecks} of {tests} tests "
                        f"({extra['recheck_share']:.4%}), integer rows at alpha 1 "
                        f"{irechecks} of {itests} ({extra['int_recheck_share']:.4%})")
            ms = time_ms(lambda: occlusion_rounds(dist, vecs, alpha, R=R, metric=metric), 20)
            plain_ms = time_ms(lambda: occlusion_rounds_plain(
                dist, vecs, alpha, R=R, metric=metric), 2 if f32 else 3)
            # the rows are ascending, so a row's live candidates are its first
            # n_live: its distances and rounds move once, and the vectors of
            # its live candidates; each star's distances to the row's C
            # candidates are 2 C d operations (int8 tensor cores or f32)
            is_star = (out < R).int()
            stars, n_live = int(is_star.sum()), int((dist < INF).sum())
            strips = float(torch.nn.functional.pad(is_star, (0, -C % 16))
                           .view(B, -1, 16).amax(2).sum(1).float().mean())
            # a star in a later strip runs that strip's epilogue
            check(strips > 1.0, f"{what}: the stars stay in one strip a row")
            nbytes = B * C * 8 + n_live * d * size
            if f32:  # 3xTF32: three TF32 products a term
                b = bound(nbytes, 3 * 2 * stars * C * d, TF32_OPS)
                extra["f32_core_bound_ms"] = bound(nbytes, 2 * stars * C * d)["bound_ms"]
                note += f"; the f32-core bound {extra['f32_core_bound_ms']:.4f} ms"
            else:
                b = bound(nbytes, 2 * stars * C * d, INT8_OPS)
            times[(C, R, metric)] = dict(ms=ms, plain_ms=plain_ms, **b, **extra)
            log(f"{what}: rounds equal; {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
                f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {stars} stars, "
                f"{stars / B:.2f} and {strips:.2f} strips a row; {n_live} live candidates)"
                f"{note}")
    head = {k: v for k, v in times[(96, 32, Metric.L2)].items()
            if k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    return dict(max_abs_err=0.0, library_ms=None, **head,
                shapes={f"C{C}_R{R}_{m.name}": {k: v[k] for k in v if k != "plain_ms"}
                        for (C, R, m), v in times.items()})


def kernel_expand_f32(dev):
    """Kernel 1 on f32 rows at the f32 search's shape: B=10,000 queries over
    a (100000, 32, 128) f32 inline array (1.64 GB, made on the card), equal
    to its plain version (the same summation order) under L2 and MIPS."""
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_distances, expand_distances_plain)

    n_pad, R8, d, B = 100_000, 32, 128, 10_000
    cg = torch.Generator(device=dev).manual_seed(SEED)
    inline = torch.randn((n_pad, R8, d), generator=cg, device=dev)
    ids = torch.randint(0, n_pad, (B,), generator=cg, device=dev, dtype=torch.int32)
    q = torch.randn((B, d), generator=cg, device=dev)
    for metric in (Metric.L2, Metric.MIPS):
        out = expand_distances(inline, ids, q, metric=metric)
        ref = expand_distances_plain(inline, ids, q, metric=metric)
        check(torch.equal(out, ref), f"expand_distances f32 rows {metric} not bit-equal")
    ms = time_ms(lambda: expand_distances(inline, ids, q, metric=Metric.L2), 20)
    plain_ms = time_ms(lambda: expand_distances_plain(inline, ids, q, metric=Metric.L2), 5)
    b = bound(unique_rows(ids, n_pad) * R8 * d * 4 + B * d * 4 + B * 4 + B * R8 * 4,
              3 * B * R8 * d)
    log(f"kernel 1 expand_distances f32 rows B={B} inline={tuple(inline.shape)}: "
        f"bit-equal (L2, MIPS); {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def kernel_expand_i16(dev):
    """Kernel 1's 16-bit mode at the 16-bit tier's search shape: B=10,000
    queries over a (100000, 32, 128) int16 inline array (made on the card),
    under L2 and MIPS, torch.equal to its plain version (both sum exactly in
    int64 and round once). The first 64 rows and the first 1,000 queries,
    which expand them, hold only the extreme levels (-32768 and 32767: 16-bit
    L2 levels 0 and 65535 after the port's shift), so an int32 sum would
    overflow and show."""
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_distances, expand_distances_plain)

    n_pad, R8, d, B = 100_000, 32, 128, 10_000
    cg = torch.Generator(device=dev).manual_seed(SEED)

    def levels(shape):
        return torch.randint(-32768, 32768, shape, generator=cg, device=dev, dtype=torch.int32)

    def extreme(shape):
        return torch.where(torch.rand(shape, generator=cg, device=dev) < 0.5, -32768, 32767)

    inline = levels((n_pad, R8, d))
    inline[:64] = extreme((64, R8, d))
    inline = inline.to(torch.int16)
    ids = torch.randint(0, n_pad, (B,), generator=cg, device=dev, dtype=torch.int32)
    ids[:1000] = torch.randint(0, 64, (1000,), generator=cg, device=dev, dtype=torch.int32)
    q = levels((B, d)).float()
    q[:1000] = extreme((1000, d)).float()
    for metric in (Metric.L2, Metric.MIPS):
        out = expand_distances(inline, ids, q, metric=metric)
        ref = expand_distances_plain(inline, ids, q, metric=metric)
        check(torch.equal(out, ref), f"expand_distances int16 rows {metric} not equal")
        check(float(out.abs().max()) > 2**31,
              f"expand_distances int16 rows {metric}: no distance passed 2^31")
    ms = time_ms(lambda: expand_distances(inline, ids, q, metric=Metric.L2), 20)
    plain_ms = time_ms(lambda: expand_distances_plain(inline, ids, q, metric=Metric.L2), 5)
    b = bound(unique_rows(ids, n_pad) * R8 * d * 2 + B * d * 4 + B * 4 + B * R8 * 4,
              3 * B * R8 * d)
    log(f"kernel 1 expand_distances int16 rows B={B} inline={tuple(inline.shape)}: "
        f"equal (L2, MIPS; extreme levels past 2^31); {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b)


def kernel_expand_hnsw(gen, dev):
    """Kernel 1 at HNSW's level 0 (R8 = 40 = 2m): int8 rows at build B's
    read shape (8,000 rows x 4 expansions = B 32,000, integer queries) and
    f32 rows (B 8,000), each equal to its plain version under L2 and MIPS
    -> {"int8": times, "f32": times}."""
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_distances, expand_distances_plain)

    n_pad, R8, d = 100_000, 40, 128
    cg = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    for name, B, size in (("int8", 32_000, 1), ("f32", 8_000, 4)):
        if name == "int8":
            inline = torch.randint(-128, 128, (n_pad, R8, d), generator=cg, device=dev,
                                   dtype=torch.int8)
            q = torch.randint(-128, 128, (B, d), generator=cg, device=dev).float()
        else:
            inline = torch.randn((n_pad, R8, d), generator=cg, device=dev)
            q = torch.randn((B, d), generator=cg, device=dev)
        ids = torch.randint(0, n_pad, (B,), generator=cg, device=dev, dtype=torch.int32)
        for metric in (Metric.L2, Metric.MIPS):
            check(torch.equal(expand_distances(inline, ids, q, metric=metric),
                              expand_distances_plain(inline, ids, q, metric=metric)),
                  f"expand_distances R8=40 {name} rows {metric} not equal")
        ms = time_ms(lambda: expand_distances(inline, ids, q, metric=Metric.L2), 20)
        plain_ms = time_ms(lambda: expand_distances_plain(inline, ids, q, metric=Metric.L2), 5)
        b = bound(unique_rows(ids, n_pad) * R8 * d * size + B * d * 4 + B * 4 + B * R8 * 4,
                  *expand_ops(inline, q, B * R8))
        out[name] = dict(ms=ms, plain_ms=plain_ms, **b)
        log(f"kernel 1 expand_distances {name} rows R8=40 B={B} inline={tuple(inline.shape)}: "
            f"equal (L2, MIPS); {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']})")
        del inline
    return out


def bitonic_check(gen, dev):
    from parlayann_tpu_torch.ops.kernels.fusedbeam import bitonic_sort_rows
    from parlayann_tpu_torch.ops.topk import lexsort

    for W in (64, 128, 1024):
        # integer-valued keys force ties, broken by the payload
        keys = torch.randint(0, W // 4, (64, W), generator=gen).float().to(dev)
        vals = torch.stack([torch.randperm(W, generator=gen) for _ in range(64)])
        vals = vals.to(torch.int32).to(dev)
        sk, sv = bitonic_sort_rows(keys, vals)
        check(torch.equal(sk, torch.sort(keys, dim=1).values),
              f"bitonic keys differ from torch.sort (W={W})")
        # payloads are unique per row, so the (key, payload) order is unique
        rk, rv = lexsort((keys, vals))
        check(torch.equal(sk, rk) and torch.equal(sv, rv),
              f"bitonic (key, payload) pairs differ from a stable lexsort (W={W})")
    log("bitonic device code (test launch, W=64/128/1024): keys equal torch.sort, "
        "(key, payload) pairs equal a stable lexsort")
    # the cluster search's pool sort is 10K rows of 256 lanes
    rows, W = 10_000, 256
    keys = torch.randint(0, W, (rows, W), generator=gen).float().to(dev)
    vals = torch.randint(0, 2**30, (rows, W), generator=gen, dtype=torch.int32).to(dev)
    ms = time_ms(lambda: bitonic_sort_rows(keys, vals), 20)
    plain_ms = time_ms(lambda: lexsort((keys, vals)), 20)
    lib_ms = time_ms(lambda: torch.sort(keys, dim=1, stable=True), 20)
    b = bound(rows * W * 16, 0)
    log(f"bitonic_sort_rows {rows} x {W} (with its two input copies): {ms:.4f} ms; "
        f"plain lexsort {plain_ms:.4f} ms; torch.sort of the keys {lib_ms:.4f} ms; "
        f"bound {b['bound_ms']:.4f} ms (bytes)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, **b)


def make_data():
    from parlayann_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    X, Q = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=SEED)
    log(f"data: synthetic clustered {X.shape}, {len(Q)} queries "
        f"({time.perf_counter() - t0:.2f} s)")
    return X, Q


def check_topk(got, want, scale, what):
    """Kernel 4 against its plain version on f32 points -> max relative
    distance error. The two sum the dot products in another order and the
    L2 algebra cancels ||q||^2 + ||x||^2 down to the distance, so distances
    must agree to rtol 1e-5 plus 1e-6 x (||q||^2 + max ||x||^2) (``scale``),
    and ids must be equal except where two distances lie within that
    tolerance."""
    ids, d = got
    rids, rd = want
    check(torch.equal(ids < 0, rids < 0), f"{what}: empty slots differ")
    ok = rids >= 0
    tol = 1e-5 * rd.abs() + 1e-6 * scale[:, None]
    diff = (d - rd).abs()
    check(bool((diff <= tol)[ok].all()), f"{what}: distances differ")
    bad = (ids != rids).any(dim=1).nonzero()[:, 0].tolist()
    for r in bad:
        last = int(ok[r].sum()) - 1
        only = ~torch.isin(ids[r], rids[r])
        check(bool(((d[r][only] - rd[r, last]).abs() <= tol[r, last]).all()),
              f"{what}: row {r} ids differ beyond a tie")
        only = ~torch.isin(rids[r], ids[r])
        check(bool(((rd[r][only] - d[r, last]).abs() <= tol[r, last]).all()),
              f"{what}: row {r} ids differ beyond a tie")
    return float((diff / rd.abs().clamp(min=1e-30))[ok].max()), len(bad)


def kernel_flat(X, Q, gen, dev):
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.flatscan import (
        flat_topk, flat_topk_plain, splits)

    n, B = len(X), len(Q)
    q = torch.from_numpy(Q).to(dev)
    err, abs_err, out = 0.0, 0.0, {}
    for metric in (Metric.L2, Metric.MIPS):
        ps = PointSet.from_numpy(X, metric=metric, device=dev)
        tier = quantize.quantize_pointset(ps, bits=8)
        q8 = quantize.translate_query(q, tier).float()
        scale = (q * q).sum(1) + (ps.data * ps.data).sum(1).max()
        cases = [("f32", q, ps.data, None, None), ("int8", q8, tier.data, None, None)]
        if metric is Metric.L2:
            mask = (torch.rand(n, generator=gen) < 0.5).to(dev)
            excl = torch.randint(0, n, (B,), generator=gen, dtype=torch.int32).to(dev)
            cases.append(("f32 masked", q, ps.data, mask, excl))
        for name, qq, xx, mk, ex in cases:
            kw = dict(k=K, metric=metric, n_valid=n)
            got = flat_topk(qq, xx, mk, ex, **kw)
            want = flat_topk_plain(qq, xx, mk, ex, **kw)
            what = f"flat_topk {name} {metric.name}"
            if name == "int8":
                check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                      f"{what}: not equal")
                note = "equal"
            else:
                rel, n_tie = check_topk(got, want, scale, what)
                err = max(err, rel)
                ok = want[0] >= 0
                abs_err = max(abs_err, float((got[1] - want[1]).abs()[ok].max()))
                note = f"max rel err {rel:.3g}, {n_tie} rows with tie swaps"
            if ex is not None:
                check(not bool((got[0] == ex[:, None]).any()), f"{what}: excluded id")
            if metric is Metric.L2 and mk is None:
                ms = time_ms(lambda: flat_topk(qq, xx, **kw), 10)
                plain_ms = time_ms(lambda: flat_topk_plain(qq, xx, **kw), 2)
                out[name] = (ms, plain_ms)
                note += f"; {ms:.4f} ms vs plain {plain_ms:.4f} ms"
            log(f"kernel 4 flat_topk {name} {metric.name} B={B} N={n} d=128 k={K}: {note}")
    # no PyTorch call computes the top-k; the cuBLAS product of the same
    # (B, N) L2 distance matrix (||x||^2 - 2 q.x, TF32 off) is the yardstick
    x = PointSet.from_numpy(X, device=dev).data[:n]
    xn = (x * x).sum(1)[None, :]
    lib_ms = time_ms(lambda: torch.addmm(xn, q, x.T, beta=1.0, alpha=-2.0), 3)
    bounds = {}
    for name, passes, size in (("f32", 3, 4), ("int8", 2, 1)):
        # inputs read once (points, queries, bias), the (B, k) lists written
        b = bound(n * 128 * size + B * 128 * 4 + n * 4 + B * K * 8,
                  passes * 2 * B * n * 128, TF32_OPS)
        S, per = splits(B, n, K, name == "int8", dev)
        ms, plain_ms = out[name]
        log(f"kernel 4 flat_topk {name} L2: {ms:.4f} ms vs plain {plain_ms:.4f} ms; "
            f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {passes} TF32 passes); "
            f"S={S} splits of {per} points")
        bounds[name] = b
    log(f"kernel 4 flat_topk: torch.addmm of the f32 distance matrix alone {lib_ms:.4f} ms")
    ms, plain_ms = out["f32"]
    return dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                **bounds["f32"])


ENTRY_E = 4096  # the search's entry tier (Index.build_entry_cache)
ENTRY_WIDE_D = 200  # a width past the 128 dimensions the kernel keeps at once


def kernel_entry(X, Q, dev):
    """The entry top-1 (``ops/kernels/entry.py``, over the tier that
    ``entry_tier`` makes once) at the search's shape: B = 10,000 queries
    against the E = 4,096-point entry tier of the 100K set, d = 128, L2 and
    MIPS, against its plain version (ids equal, or the kernel's entry within
    1e-5 of the best in float64, relative: the worst such gap and the count
    of ids that differ are reported), timed beside its bound (3 TF32 passes
    of 2 B E d at 495 TFLOP/s; the bytes are 7 MB), the plain chain and one
    library call (``torch.addmm`` of the biased (B, E) product, then
    ``argmin``); then once past d = 128 (``ENTRY_WIDE_D``, the queries in
    128-dimension chunks) on Gaussian data, beside its plain chain."""
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.entry import (
        _slots, entry_tier, entry_top1, entry_top1_plain, grid)

    def gap(q, tier, got, want):
        """-> (ids that differ, the worst (mine - best) / |best| and the
        worst mine - best over them, distances in float64; 0 when none
        differ)."""
        differ = (got != want)[:, 0]
        if not bool(differ.any()):
            return 0, 0.0, 0.0
        q64, e64 = q[differ].double(), tier.rows.double()
        dist = (-(q64 @ e64.T) if tier.metric is Metric.MIPS else
                (q64 * q64).sum(1)[:, None] + (e64 * e64).sum(1)[None] - 2 * q64 @ e64.T)
        pos_of = torch.zeros(int(tier.ids.max()) + 1, dtype=torch.int64, device=dev)
        pos_of[tier.ids.long()] = torch.arange(tier.ids.shape[0], device=dev)
        mine = dist.gather(1, pos_of[got[differ].long()])[:, 0]
        best = dist.min(dim=1).values
        return (int(differ.sum()), float(((mine - best) / best.abs()).max()),
                float((mine - best).max()))

    def run(q, tier, label, reps):
        got = entry_top1(q, tier)
        want = entry_top1_plain(q, tier.rows, tier.bias, tier.ids, metric=tier.metric)
        differ, worst, worst_abs = gap(q, tier, got, want)
        check(worst <= 1e-5, f"entry_top1 {label}: an entry beyond rounding of the best "
                             f"({worst:.3e} relative)")
        ms = time_ms(lambda: entry_top1(q, tier), reps)
        plain_ms = time_ms(lambda: entry_top1_plain(q, tier.rows, tier.bias, tier.ids,
                                                    metric=tier.metric), 10)
        log(f"entry_top1 {label}: {differ} ids differ from the plain chain, the worst "
            f"{worst:.3e} relative of the best; {ms:.4f} ms vs plain {plain_ms:.4f} ms")
        return dict(ms=ms, plain_ms=plain_ms, differ=differ, rel_gap=worst, abs_gap=worst_abs)

    B, d = len(Q), X.shape[1]
    ids = torch.from_numpy(np.random.default_rng(0).choice(
        len(X), ENTRY_E, replace=False).astype(np.int32)).to(dev)
    ev = torch.from_numpy(X).to(dev)[ids.long()]
    q = torch.from_numpy(Q).to(dev)
    out = {m.name: run(q, entry_tier(ev, ids, m), f"{m.name} B={B} E={ENTRY_E} d={d}", 50)
           for m in (Metric.L2, Metric.MIPS)}
    gen = torch.Generator(device=dev).manual_seed(0)
    wide = run(torch.randn((B, ENTRY_WIDE_D), generator=gen, device=dev),
               entry_tier(torch.randn((ENTRY_E, ENTRY_WIDE_D), generator=gen, device=dev),
                          ids, Metric.L2), f"L2 B={B} E={ENTRY_E} d={ENTRY_WIDE_D}", 20)
    tier = entry_tier(ev, ids, Metric.L2)
    lib_ms = time_ms(lambda: torch.addmm(tier.bias[None], q, tier.rows.T, beta=1.0,
                                         alpha=-2.0).argmin(1), 10)
    b = bound(B * d * 4 + ENTRY_E * (d + 2) * 4 + B * 4, 3 * 2 * B * ENTRY_E * d, TF32_OPS)
    R, T, G = grid(B, ENTRY_E, _slots(d, dev))
    log(f"entry_top1 L2: {out['L2']['ms']:.4f} ms vs plain {out['L2']['plain_ms']:.4f} ms; "
        f"torch.addmm + argmin {lib_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}, 3 TF32 passes); {G} CTAs over {R} row blocks x {T} tiles")
    return dict(max_abs_err=out["L2"]["abs_gap"], rel_gap=out["L2"]["rel_gap"],
                differ=out["L2"]["differ"], mips_max_abs_err=out["MIPS"]["abs_gap"],
                mips_rel_gap=out["MIPS"]["rel_gap"], mips_differ=out["MIPS"]["differ"],
                ms=out["L2"]["ms"], plain_ms=out["L2"]["plain_ms"], library_ms=lib_ms,
                mips_ms=out["MIPS"]["ms"], wide_d=ENTRY_WIDE_D, wide_ms=wide["ms"],
                wide_plain_ms=wide["plain_ms"], wide_differ=wide["differ"], **b)


def slice_run(X, Q, dev):
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.expand import expand_distances
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.ops.kernels.fusedbeam import beam_search_fused
    from parlayann_tpu_torch.ops.kernels.entry import entry_top1
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.harness.recall import compute_recall

    wrappers = (expand_distances, occlusion_rounds, beam_search_fused, entry_top1)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph, points, stats = pt.build_vamana_index(
        X, R=32, L=64, alpha=1.2, batch_cap_frac=0.16, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    avg_deg, max_deg = graph.stats()
    log(f"build: {build_s:.3f} s (q8, R=32 L=64 alpha=1.2, 2 passes, "
        f"batch_cap_frac=0.16); degree avg {avg_deg:.3f} max {max_deg}; "
        f"visited {stats.total_visited} cmps {stats.total_cmps}")
    idx = pt.Index(points=points, graph=graph).enable_quantized(bits=8)
    rows = []
    for beam in BEAMS:
        ids, _, res, dt = idx.batch_search_timed(Q, k=K, beam_size=beam,
                                                 rounds=3)
        rows.append((beam, ids.cpu().numpy(), dt,
                     float(res.num_visited.float().mean()),
                     float(res.dist_cmps.float().mean())))
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}

    gt_ids, gt_d = exact.compute_groundtruth(points, Q, 2 * K)
    recall = {}
    for beam, ids, dt, nv, cm in rows:
        recall[beam] = compute_recall(ids, gt_ids, gt_d, K)
        check(ids.shape == (len(Q), K) and (ids >= 0).all(),
              f"beam {beam}: malformed ids")
        log(f"search beam={beam}: recall@{K} {recall[beam]:.4f}  "
            f"QPS {len(Q) / dt:.1f}  ({dt * 1e3:.3f} ms / {len(Q)} queries; "
            f"visited {nv:.2f} cmps {cm:.1f})")
    log("launches during the slice:", launches)
    qd = torch.as_tensor(Q).to(dev)
    for beam in (BEAMS[0], BEAMS[-1]):
        profile_window(lambda: idx.batch_search(qd, k=K, beam_size=beam),
                       f"q8 search of {len(Q)} queries at beam {beam}")
    check(recall[64] >= RECALL_BAR,
          f"recall@{K} at beam 64 is {recall[64]:.4f} < {RECALL_BAR}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the slice")
    return idx, launches, (gt_ids, gt_d), build_s


def profiled_build(X, dev):
    """The 100K q8 build of phase 3 once more, under torch.profiler (the
    timed build stays unprofiled): kernel 2's summed device time and
    launches, and the build's idle share."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds

    before = occlusion_rounds.launches
    prof = profile_window(lambda: pt.build_vamana_index(
        X, R=32, L=64, alpha=1.2, batch_cap_frac=0.16, device=dev), "100K q8 build")
    check(prof is not None, "the profiled build saw no device activity")
    n = occlusion_rounds.launches - before
    occl_ms = sum(us for name, us in prof["by_name"].items() if "occlusion" in name) / 1e3
    check(n > 0 and occl_ms > 0, "the profiled build ran no occlusion_rounds")
    log(f"profiled build: occlusion_rounds {occl_ms:.4f} ms of device time over {n} "
        f"launches ({occl_ms / n:.4f} ms each); idle share {prof['idle']:.3f}")


FUSED_SHAPES = ((1024, 10), (1024, 64), (10_000, 10), (10_000, 64))  # (B, L) of kernel 3


def fused_args(idx, Q, L, dev):
    """Kernel 3's inputs as the q8 search makes them for queries Q at beam
    L -> (args, kwargs): the translated (integer-valued) queries, the int8
    tier, the graph and the entry tier's top-1 starts."""
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.entry import entry_tier, entry_top1

    q = torch.as_tensor(Q).to(dev)
    tier, g = idx.qpoints, idx.graph
    if idx.entry_ids is None:
        idx.build_entry_cache()  # the search's own entry tier (kept if built)
    starts = entry_top1(q, entry_tier(idx.entry_vecs, idx.entry_ids, tier.metric))
    q_t = quantize.translate_query(q, tier).float()
    return ((q_t, tier.data, g.neighbors, g.degrees, starts),
            dict(metric=tier.metric, n_valid=tier.n, k=K, L=L, limit=tier.n))


def fused_rows(args, n_valid, expanded):
    """-> (distinct tier rows a walk scored, distinct vertices it visited),
    from the expanded ids that the plain walk reports step by step: the
    valid starts and the valid neighbours below each visited vertex's
    degree."""
    _, _, nbrs, degs, starts = args
    e = torch.cat(expanded) if expanded else starts.new_empty(0)
    vis = torch.unique(e[e >= 0]).long()
    slot = torch.arange(nbrs.shape[1], device=nbrs.device)[None, :]
    nb = torch.where(slot < degs[vis][:, None], nbrs[vis], -1)
    ids = torch.cat([nb.reshape(-1), starts.reshape(-1)])
    ids = torch.unique(ids[(ids >= 0) & (ids < n_valid)])
    return int(ids.numel()), int(vis.numel())


def kernel_fusedbeam(idx, Q, dev, shapes=FUSED_SHAPES, plain_at=(1024, 64),
                     what="the built graph"):
    """Kernel 3 against its plain version on ``idx``'s q8 search inputs at
    each (B, L) of ``shapes`` (ids, dists, nv and cmps equal) -> {(B, L):
    times and bound}; the plain version is timed at ``plain_at``."""
    from parlayann_tpu_torch.ops.kernels.fusedbeam import (
        beam_search_fused, beam_search_fused_plain)

    out = {}
    for B, L in shapes:
        args, kw = fused_args(idx, Q[:B], L, dev)
        expanded = []
        got = beam_search_fused(*args, **kw)
        want = beam_search_fused_plain(*args, **kw, expanded=expanded)
        for name, g, w in zip(("ids", "dists", "num_visited", "dist_cmps"), got, want):
            check(torch.equal(g, w), f"beam_search_fused B={B} L={L}: {name} differ")
        nv, cm = got[2], got[3]
        ms = time_ms(lambda: beam_search_fused(*args, **kw), 10)
        plain_ms = (time_ms(lambda: beam_search_fused_plain(*args, **kw), 2)
                    if (B, L) == plain_at else None)
        n_cmp, n_vis = int(cm.sum()), int(nv.sum())
        n_rows, n_adj = fused_rows(args, kw["n_valid"], expanded)
        # each input byte once: the distinct tier rows scored, the distinct
        # visited vertices' adjacency rows and degrees, the queries and
        # starts; the outputs. The queries are integer-valued and the tier
        # int8, so each distance is d int8 products and d additions.
        d, R = args[0].shape[1], args[2].shape[1]
        b = bound(n_rows * d + n_adj * (R + 1) * 4 + B * d * 4 + args[4].numel() * 4
                  + B * L * 8 + B * 8, 2 * n_cmp * d, INT8_OPS)
        out[(B, L)] = dict(ms=ms, plain_ms=plain_ms, **b)
        step = f"; {ms / int(nv.max()) * 1e3:.3f} us a step of the longest walk" if B == 1024 else ""
        log(f"kernel 3 beam_search_fused B={B} L={L} R={R} on {what}: ids, dists, nv, "
            f"cmps equal; {ms:.4f} ms" + (f" vs plain {plain_ms:.4f} ms" if plain_ms else "")
            + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {n_vis} visits of {n_adj} "
            f"vertices, {n_cmp} distances to {n_rows} rows); visits mean "
            f"{float(nv.float().mean()):.2f} max {int(nv.max())}{step}")
    return out


BUILD_FUSED_B = 16_000  # a steady batch of phase 3's build: 0.16 x 100K inserts


# kernel 3's walks by (L, R) of a launch that takes each (d = 128):
# walk_regs<P, CP> (P = pow2(L) / 32 beam and CP = pow2(R) / 32 candidate
# registers a lane) and walk_smem past 128 lanes or 64 neighbours
WALK_SHAPES = ((10, 32), (10, 64), (64, 32), (64, 64), (128, 32), (128, 64), (64, 90))


def walk_table():
    """Print each of kernel 3's walks: registers and spilled bytes a thread
    (the runtime's), resident warps an SM at the launch's shared memory."""
    from parlayann_tpu_torch.ops.kernels.fusedbeam import walk_info

    for L, R in WALK_SHAPES:
        w = walk_info(128, L, R)
        log(f"kernel 3 {w['walk']} (L={L}, R={R}): {w['regs']} registers, "
            f"{w['local_bytes']} bytes spilled a thread; {w['threads'] // 32} warps a CTA, "
            f"{w['resident_warps']} resident warps an SM")
        check(w["regs"] > 0 and w["resident_warps"] > 0, f"kernel 3 {w['walk']}: no residency")


def kernel_build_fused(idx, dev, B=BUILD_FUSED_B, R=32, L=64, what="phase 3's graph"):
    """Kernel 3's build mode against its plain version at a steady batch
    of phase 3's build: B of the q8 tier's rows (a draw of SEED) as
    queries, each walking ``idx``'s graph (phase 3's by default) from
    point 0 at k = 0 for vmax = max(L, R + 16) expansions (64 at R = 32,
    L = 64); all four outputs equal -> times, bound, the walk the launcher
    took and the share of its step distances whose tier row it did not
    read again (scored earlier in the same walk)."""
    from parlayann_tpu_torch.ops.kernels.fusedbeam import (
        build_beam_fused, build_beam_fused_plain, walk_info)

    tier, g = idx.qpoints, idx.graph
    vmax = max(L, R + 16)
    ids = torch.from_numpy(np.random.default_rng(SEED).permutation(tier.n)[:B]
                           .astype(np.int64)).to(dev)
    args = (tier.data[ids].float(), tier.data, g.neighbors, g.degrees,
            torch.zeros((B, 1), dtype=torch.int32, device=dev))
    kw = dict(metric=tier.metric, n_valid=tier.n, L=L, vmax=vmax)
    got = build_beam_fused(*args, **kw)
    want = build_beam_fused_plain(*args, **kw)
    for name, a, b in zip(("visited ids", "visited dists", "num_visited", "dist_cmps"),
                          got, want):
        check(torch.equal(a, b), f"build_beam_fused B={B} vmax={vmax}: {name} differ")
    ms = time_ms(lambda: build_beam_fused(*args, **kw), 10)
    plain_ms = time_ms(lambda: build_beam_fused_plain(*args, **kw), 2)
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    build_beam_fused(*args, **kw, counts=counts)
    valid, skipped = counts.tolist()
    walk = walk_info(tier.d, L, R)["walk"]
    nv, cm = got[2], got[3]
    n_rows, n_adj = fused_rows(args, tier.n, [got[0].reshape(-1)])
    # each input byte once: the distinct tier rows scored, the visited
    # vertices' adjacency rows and degrees, the queries and starts; the
    # visited rows, nv and cmps written. Each distance is d int8 products
    # and d additions.
    d = tier.d
    b = bound(n_rows * d + n_adj * (R + 1) * 4 + B * d * 4 + B * 4 + B * vmax * 8 + B * 8,
              2 * int(cm.sum()) * d, INT8_OPS)
    n_vis = int(nv.sum())
    share = skipped / valid if valid else 0.0
    log(f"kernel 3 build mode build_beam_fused B={B} L={L} vmax={vmax} R={R} on {what}: "
        f"{walk}; visited ids, dists, nv, cmps equal; {ms:.4f} ms vs plain {plain_ms:.4f} ms; "
        f"{ms * 1e6 / n_vis:.3f} ns a step; bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
        f"{n_vis} visits of {n_adj} vertices, {int(cm.sum())} distances to {n_rows} rows); "
        f"visits mean {float(nv.float().mean()):.2f} max {int(nv.max())}; tier rows not read "
        f"again: {skipped} of {valid} step distances ({share:.4f})")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, walk=walk,
                ns_per_step=ms * 1e6 / n_vis, rows_skipped_share=share, **b)


# phase 3b: the fused read phase (kernel 3's build mode) beside the lock-step
# read, at bench.py:434-436's two configurations, two passes at 0.16
FUSED_CONFIGS = (dict(R=32, L=64, alpha=1.2), dict(R=64, L=128, alpha=1.15))
FUSED_GAP = 0.01  # |fused - lock-step| recall@10 at beams 10 and 64


def steady_batches(n, frac):
    """Batches a pass of at least max(max_batch, 4096) inserts: the ones
    that read fused under fused_read=True."""
    from parlayann_tpu_torch.build.vamana import batch_schedule

    sched, max_batch = batch_schedule(n, n, frac)
    return sum(hi - lo >= max(max_batch, 4096) for lo, hi in sched)


def counted_build(X, dev, **kw):
    """pt.build_vamana_index with every launch count zeroed just before and
    read just after -> (graph, points, stats, fenced seconds, launches)."""
    import parlayann_tpu_torch as pt

    _zero_launches()
    t0 = time.perf_counter()
    g, ps, st = pt.build_vamana_index(X, device=dev, **kw)
    torch.cuda.synchronize()
    return g, ps, st, time.perf_counter() - t0, _launch_counts()


def fused_read_run(X, Q, gt, idx3, secs3, dev):
    """Phase 3b: at each of FUSED_CONFIGS, a lock-step build (phase 3's for
    R = 32) and a fused_read=True build, each timed, run again with
    profile=True for its split, and searched on the q8 tier at BEAMS; past
    R = 32, kernel 3's build mode is held to its plain version and timed
    on the lock-step graph at the configuration's (R, L), as phase 2 does
    at R = 32 -> ({config: {"lock-step" / "fused": launches of the counted
    build}}, {shape: the build mode's times and bound})."""
    import parlayann_tpu_torch as pt

    q = torch.from_numpy(Q).to(dev)
    steady = 2 * steady_batches(len(X), 0.16)
    out, shapes = {}, {}
    for cfg in FUSED_CONFIGS:
        R, L = cfg["R"], cfg["L"]
        vmax = max(L, R + 16)
        rows = {}
        for mode in ("lock-step", "fused"):
            kw = dict(cfg, batch_cap_frac=0.16, fused_read=mode == "fused")
            what = f"R={R} L={L} alpha={cfg['alpha']} {mode} build"
            reuse = mode == "lock-step" and R == 32
            # the split: the same build with profile=True (fenced phases)
            pg, _, ps_, secs_p, launches = counted_build(X, dev, profile=True, **kw)
            if reuse:
                g, ps, secs = idx3.graph, idx3.points, secs3
            else:
                g, ps, st, secs, launches = counted_build(X, dev, **kw)
            same = (torch.equal(pg.neighbors, g.neighbors)
                    and torch.equal(pg.degrees, g.degrees))
            avg, mx = g.stats()
            log(f"{what}: {secs:.3f} s fenced{' (phase 3)' if reuse else ''}; profiled "
                f"{secs_p:.3f} s: beam {ps_.beam_time:.3f} s, bidirect "
                f"{ps_.bidirect_time:.3f} s, prune {ps_.prune_time:.3f} s; degree avg "
                f"{avg:.3f} max {mx}; visited {ps_.total_visited} cmps {ps_.total_cmps}; "
                f"the profiled graph {'equals' if same else 'differs from'} the timed one; "
                f"launches {dict((k, v) for k, v in launches.items() if v)}")
            qidx = pt.Index(points=ps, graph=g).enable_quantized(bits=8)
            recall = _search_rows(_index_search(qidx, q), ps.n, gt, BEAMS, f"{what}, q8")
            rows[mode] = dict(recall=recall, launches=launches)
            if mode == "lock-step" and R != 32:
                shapes[f"R{R}_L{L}_vmax{vmax}_B{BUILD_FUSED_B}"] = kernel_build_fused(
                    qidx, dev, R=R, L=L, what=f"the R={R} L={L} lock-step graph")
            del qidx
        lock, fused = rows["lock-step"], rows["fused"]
        check(fused["recall"][64] >= RECALL_BAR, f"3b R={R}: the fused build's recall@{K} at "
              f"beam 64 is {fused['recall'][64]:.4f} < {RECALL_BAR}")
        for beam in (10, 64):
            gap = fused["recall"][beam] - lock["recall"][beam]
            check(abs(gap) <= FUSED_GAP, f"3b R={R}: the fused build's recall@{K} at beam "
                  f"{beam} is {gap:+.4f} off the lock-step build's")
        n_fused = fused["launches"]["build_beam_fused"]
        check(n_fused == steady, f"3b R={R}: build_beam_fused launched {n_fused} times, not "
              f"{steady} (2 passes x {steady // 2} steady batches)")
        drop = lock["launches"]["expand_distances"] - fused["launches"]["expand_distances"]
        steps = steady * -(-vmax // 2)
        check(drop == steps, f"3b R={R}: kernel 1's launches fell by {drop}, not by the "
              f"lock-step read's {steps} steady steps")
        log(f"phase 3b R={R}: recall@{K} fused {fused['recall'][10]:.4f} / "
            f"{fused['recall'][64]:.4f}, lock-step {lock['recall'][10]:.4f} / "
            f"{lock['recall'][64]:.4f} at beams 10 / 64; build_beam_fused {n_fused} launches; "
            f"kernel 1 {drop} fewer")
        out[f"R{R}_L{L}"] = {m: r["launches"] for m, r in rows.items()}
    return out, shapes


def _no_duplicates(ids):
    s, _ = torch.sort(ids, dim=1)
    return not bool(((s[:, 1:] == s[:, :-1]) & (s[:, 1:] >= 0)).any())


def cluster_run(X, Q, gt, dev):
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.clusterbeam import cluster_walk
    from parlayann_tpu_torch.harness.recall import compute_recall

    gt_ids, gt_d = gt
    settings = [(p, 0, 0.0) for p in PROBES] + [ADAPTIVE]
    indexes, recall = {}, {}
    cluster_walk.launches = 0
    torch.cuda.synchronize()
    for layout in ("auto", "int8"):
        t0 = time.perf_counter()
        ci = pt.build_cluster_index(X, m=64, Rc=16, slack=1.5, ext_dtype=layout,
                                    device=dev)
        torch.cuda.synchronize()
        log(f"cluster build (ext_dtype={layout!r} -> {ci.ext_dtype}): "
            f"{time.perf_counter() - t0:.3f} s; C={ci.C}, ext {tuple(ci.ext.shape)}")
        for n_probe, min_probe, cut in settings:
            ids, _, (nv, cm), dt = ci.search_timed(
                Q, k=K, n_probe=n_probe, min_probe=min_probe, cut=cut, rounds=3)
            r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
            recall[(ci.ext_dtype, n_probe, cut)] = r
            check(ids.shape == (len(Q), K) and bool((ids >= 0).all()),
                  f"cluster {ci.ext_dtype} n_probe={n_probe}: malformed ids")
            check(_no_duplicates(ids), f"cluster {ci.ext_dtype}: duplicate ids")
            check(bool((nv <= n_probe).all()), f"cluster {ci.ext_dtype}: nv > n_probe")
            log(f"cluster search {ci.ext_dtype} n_probe={n_probe} min_probe={min_probe} "
                f"cut={cut}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  "
                f"({dt * 1e3:.3f} ms; nv {float(nv.float().mean()):.3f} "
                f"cmps {float(cm.float().mean()):.1f})")
        indexes[ci.ext_dtype] = ci
    torch.cuda.synchronize()
    launches = cluster_walk.launches
    log("launches during the ClusterIndex slice:", {"cluster_walk": launches})
    check(launches > 0, "cluster_walk was not launched by the ClusterIndex slice")
    check(set(indexes) == {"f32", "int8"}, f"layouts built: {sorted(indexes)}")
    r16 = recall[("f32", 16, 0.0)]
    check(r16 >= CLUSTER_BAR, f"f32 ClusterIndex recall@{K} at n_probe 16 is "
          f"{r16:.4f} < {CLUSTER_BAR}")
    cluster_profile(indexes["f32"], Q, dev)
    return indexes, launches


CLUSTER_B = (1024, 10_000)  # queries of kernel 5's checks and times


def cluster_args(ci, Q, dev):
    """Kernel 5's inputs as the cluster search makes them for queries Q ->
    (args, kwargs without the walk's settings): the queries in the ext's
    domain (q8-translated on the int8 layout) and their exact top-2
    centroid seeds."""
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.clusterbeam import seed_centroids

    q = torch.as_tensor(Q).to(dev)
    if ci.qpoints is not None:
        q = quantize.translate_query(q, ci.qpoints).float()
    sd, sid = seed_centroids(q, ci.centroids_q, C=ci.C, S=2, metric=ci.points.metric)
    return ((q.contiguous(), ci.ext, sd.contiguous(), sid.contiguous()),
            dict(metric=ci.points.metric, C=ci.C, m=ci.m, Rc=ci.Rc, n_points=ci.points.n))


def check_walk(got, want, what):
    """Kernel 5 against its plain version, which sums f32 distances in the
    kernel's order: every output equal, on both layouts -> the largest
    distance error (0)."""
    for a, b, name in zip(got, want, ("pool dists", "pool ids", "expansions (and so cmps)")):
        check(torch.equal(a, b), f"{what}: {name} differ")
    return float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0


def walk_bound(ci, args, expanded):
    """Kernel 5's bound for one walk from the plain walk's expanded ids ->
    (bound dict, distances, distinct rows, expansions). Bytes: each
    distinct expanded row once (the 4-byte ids of its m members and Rc
    adjacent centroids, and its valid member and adjacent vectors), the
    queries and seeds, the pool and counts written.
    Operations: per distance, d subtractions, multiplications and additions
    at the f32 rate on f32 rows, or d int8 products and d additions at the
    int8 rate on int8 rows (the integer-valued q8 queries)."""
    from parlayann_tpu_torch.ops.kernels.clusterbeam import (
        POOL_DEPTH, decode_ids, ext_layout)

    ext = ci.ext
    mid_row, _, aid_row = ext_layout(ext, ci.m, ci.Rc)
    mid, aid = decode_ids(ext, mid_row, ci.m), decode_ids(ext, aid_row, ci.Rc)
    n_row = (((mid >= 0) & (mid < ci.points.n)).sum(1)
             + ((aid >= 0) & (aid < ci.C)).sum(1))
    e = torch.cat(expanded)
    e = e[e >= 0].long()
    rows = torch.unique(e)
    n_dist = int(n_row[e].sum())
    q, _, sd, _ = args
    B, d = q.shape
    es = ext.element_size()
    nbytes = (int(n_row[rows].sum()) * d * es + int(rows.numel()) * 4 * (ci.m + ci.Rc)
              + B * d * 4 + sd.numel() * 8 + B * POOL_DEPTH * ci.m * 8 + B * 4)
    ops, rate = (3 * n_dist * d, F32_OPS) if es == 4 else (2 * n_dist * d, INT8_OPS)
    return bound(nbytes, ops, rate), n_dist, int(rows.numel()), int(e.numel())


def kernel_cluster(indexes, Q, dev):
    """Kernel 5 on the built indexes at B = 1024 and 10,000 queries, both
    layouts: checked against its plain version at n_probe 16 and at the
    adaptive row, timed at n_probe 16 -> the kernels entry at the main
    path's shape (f32 rows, B = 10,000), with every shape's times."""
    from parlayann_tpu_torch.ops.kernels.clusterbeam import cluster_walk, cluster_walk_plain

    shapes, err, main = {}, 0.0, None
    for layout, ci in indexes.items():
        for B in CLUSTER_B:
            args, base = cluster_args(ci, Q[:B], dev)
            for n_probe, min_probe, cut in ((16, 0, 0.0), ADAPTIVE):
                kw = dict(base, n_probe=n_probe, min_probe=min_probe, cut=cut)
                expanded = []
                got = cluster_walk(*args, **kw)
                want = cluster_walk_plain(*args, **kw, expanded=expanded)
                err = max(err, check_walk(got, want, f"cluster_walk {layout} B={B} "
                                                     f"n_probe={n_probe} cut={cut}"))
                if n_probe == 16:
                    b, n_dist, n_rows, n_vis = walk_bound(ci, args, expanded)
            kw = dict(base, n_probe=16)
            ms = time_ms(lambda: cluster_walk(*args, **kw), 10)
            plain_ms = time_ms(lambda: cluster_walk_plain(*args, **kw), 2)
            shapes[f"{layout}_B{B}"] = dict(ms=ms, plain_ms=plain_ms, **b)
            log(f"kernel 5 cluster_walk {layout} ext B={B} m={ci.m} Rc={ci.Rc} on the built "
                f"index: pool dists, pool ids and nv equal at n_probe 16 and adaptive; "
                f"n_probe=16 "
                f"{ms:.4f} ms vs plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
                f"({b['bound_by']}; {n_vis} probes of {n_rows} rows, {n_dist} distances)")
            if (layout, B) == ("f32", CLUSTER_B[-1]):
                main = dict(ms=ms, plain_ms=plain_ms, **b)
    return dict(max_abs_err=err, library_ms=None, **main,
                shapes={k: dict(ms=v["ms"], bound_ms=v["bound_ms"]) for k, v in shapes.items()})


def cluster_profile(ci, Q, dev):
    """The cluster search of Q at n_probe 8 and at the adaptive row, once
    each under torch.profiler -> {setting: dict(wall_ms, busy_ms, idle,
    walk_ms, walk_share)}: kernel 5's device time and its share of the
    busy time."""
    qd = torch.as_tensor(Q).to(dev)
    out = {}
    for n_probe, min_probe, cut in ((8, 0, 0.0), ADAPTIVE):
        what = f"{ci.ext_dtype} cluster search of {len(Q)} queries, n_probe={n_probe} cut={cut}"
        prof = profile_window(lambda: ci.search(qd, k=K, n_probe=n_probe,
                                                min_probe=min_probe, cut=cut), what)
        check(prof is not None, f"{what}: the profiler saw no device activity")
        walk_ms = sum(us for name, us in prof["by_name"].items() if "cluster_walk" in name) / 1e3
        out[f"p{n_probe}" + ("_adaptive" if cut else "")] = dict(
            wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"], idle=prof["idle"],
            walk_ms=walk_ms, walk_share=walk_ms / prof["busy_ms"])
        log(f"    cluster_walk {walk_ms:.4f} ms, {walk_ms / prof['busy_ms']:.1%} of busy")
    return out


def flat_run(X, Q, gt, dev):
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
    from parlayann_tpu_torch.harness.recall import compute_recall

    gt_ids, gt_d = gt
    recall = {}
    flat_topk.launches = 0
    torch.cuda.synchronize()
    for name, quantized in (("f32", False), ("q8", True)):
        fi = pt.FlatIndex(pt.PointSet.from_numpy(X, device=dev), quantize=quantized)
        ids, _, dt = fi.batch_search_timed(Q, k=K, select="pallas", rounds=3)
        recall[name] = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
        check(ids.shape == (len(Q), K) and bool((ids >= 0).all()),
              f"FlatIndex {name}: malformed ids")
        log(f"FlatIndex {name} select=pallas: recall@{K} {recall[name]:.4f}  "
            f"QPS {len(Q) / dt:.1f}  ({dt * 1e3:.3f} ms / {len(Q)} queries)")
    torch.cuda.synchronize()
    launches = flat_topk.launches
    log("launches during the FlatIndex slice:", {"flat_topk": launches})
    check(launches > 0, "flat_topk was not launched by the FlatIndex slice")
    check(recall["f32"] >= FLAT_BAR,
          f"f32 FlatIndex recall@{K} is {recall['f32']:.4f} < {FLAT_BAR}")
    return launches


def f32_run(X, Q, gt, q8_idx, dev):
    """Phase 7: the f32 tier at 100K and the q8 tier's lock-step search ->
    {kernel entry: launches in this phase}."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.expand import expand_distances
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.harness.recall import compute_recall

    gt_ids, gt_d = gt
    for w in (expand_distances, occlusion_rounds):
        w.launches = w.launches_f32 = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph, points, stats = pt.build_vamana_index(
        X, R=32, L=64, alpha=1.2, batch_cap_frac=0.16, quantize_build=False, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    avg_deg, max_deg = graph.stats()
    check(points.data.dtype == torch.float32, "the f32 build did not keep f32 points")
    log(f"f32 build: {build_s:.3f} s (R=32 L=64 alpha=1.2, 2 passes, batch_cap_frac=0.16, "
        f"quantize_build=False); degree avg {avg_deg:.3f} max {max_deg}; "
        f"visited {stats.total_visited} cmps {stats.total_cmps}")
    idx = pt.Index(points=points, graph=graph)
    recall = {}
    for beam in BEAMS:
        ids, dists, res, dt = idx.batch_search_timed(Q, k=K, beam_size=beam, rounds=3)
        r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
        recall[("f32", beam)] = r
        check(ids.shape == (len(Q), K) and bool((ids >= 0).all()),
              f"f32 beam {beam}: malformed ids")
        check(_no_duplicates(ids), f"f32 beam {beam}: duplicate ids")
        check(bool(torch.isfinite(dists).all()), f"f32 beam {beam}: distances not finite")
        log(f"f32 search beam={beam}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  "
            f"({dt * 1e3:.3f} ms / {len(Q)} queries; visited "
            f"{float(res.num_visited.float().mean()):.2f} cmps "
            f"{float(res.dist_cmps.float().mean()):.1f})")
    check(idx.inline is not None and idx.inline.dtype == torch.float32,
          "the f32 search did not use f32 inline rows")
    log(f"f32 inline rows {tuple(idx.inline.shape)} {idx.inline.numel() * 4 / 1e9:.3f} GB")
    for name, kw in (("expand=2", dict(expand=2)), ("degree_limit=16", dict(degree_limit=16))):
        ids, _, res, dt = q8_idx.batch_search_timed(Q, k=K, beam_size=64, rounds=3, **kw)
        r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
        recall[(name, 64)] = r
        check(ids.shape == (len(Q), K) and bool((ids >= 0).all()), f"q8 {name}: malformed ids")
        check(_no_duplicates(ids), f"q8 {name}: duplicate ids")
        log(f"q8 lock-step search beam=64 {name}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  "
            f"({dt * 1e3:.3f} ms; visited {float(res.num_visited.float().mean()):.2f} "
            f"cmps {float(res.dist_cmps.float().mean()):.1f})")
    check(q8_idx.inline is not None and q8_idx.inline.dtype == torch.int8,
          "the q8 lock-step search did not use int8 inline rows")
    torch.cuda.synchronize()
    launches = {
        "expand_distances (f32 rows)": expand_distances.launches_f32,
        "expand_distances (int8 rows)": expand_distances.launches - expand_distances.launches_f32,
        "occlusion_rounds (f32 rows)": occlusion_rounds.launches_f32,
    }
    log("launches during the f32 tier slice:", launches)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the f32 tier slice")
    qd = torch.as_tensor(Q).to(dev)
    prof = profile_window(lambda: idx.batch_search(qd, k=K, beam_size=64),
                          f"f32 search of {len(Q)} queries at beam 64")
    check(prof is not None, "the f32 search's profile saw no device activity")
    for (name, beam), r in recall.items():
        if beam == 64:
            check(r >= RECALL_BAR, f"{name} recall@{K} at beam 64 is {r:.4f} < {RECALL_BAR}")
    return launches


HNSW_EFS = {"A": (12, 16, 22, 30, 50), "B": (12, 50)}
HNSW_BUILDS = {"A": dict(batch_cap_frac=0.02),  # f32, the JAX package's default
               "B": dict(quantize_build=True, batch_cap_frac=0.08)}
HNSW_BAR = 0.95  # recall@10 at ef 50 (the JAX package: .9859-.9887)
HNSW_SEED = 0  # the builds' level and insert-order draws
HNSW_FUSED = ((10_000, 12), (10_000, 50))  # kernel 3's (B, L) in the HNSW search


def hnsw_build(X, name, dev):
    """One phase-8 build -> (HNSWIndex, seconds): m=20, efc=50, alpha=0.9,
    m_l=0.34 and build ``name``'s settings; prints its shape."""
    import parlayann_tpu_torch as pt

    torch.cuda.synchronize()
    idx, _, secs = pt.build_hnsw_index(X, m=20, efc=50, alpha=0.9, m_l=0.34, device=dev,
                                       seed=HNSW_SEED, **HNSW_BUILDS[name])
    sizes = [len(lv.members) for lv in idx.levels]
    degs = [lv.degs[:len(lv.members)].float() for lv in idx.levels]
    check(sizes[0] == len(X) and all(a > b for a, b in zip(sizes, sizes[1:])),
          f"HNSW build {name}: level sizes {sizes}")
    check(all(int(d.max()) <= lv.cap for d, lv in zip(degs, idx.levels)),
          f"HNSW build {name}: a degree above its cap")
    check(bool(np.isin(idx.entrances, idx.levels[-1].members).all()),
          f"HNSW build {name}: an entrance below the top level")
    log(f"HNSW build {name} ({HNSW_BUILDS[name]}): {secs:.3f} s fenced; level sizes {sizes}; "
        f"degree avg/max " + ", ".join(f"{float(d.mean()):.3f}/{int(d.max())}" for d in degs)
        + f"; entrances {idx.entrances.tolist()}")
    return idx, secs


def hnsw_run(X, Q, gt, dev):
    """Phase 8: HNSW at 100K -> ({build name: HNSWIndex}, {kernel entry:
    launches in this phase}, {"build_s", "recall", "qps"})."""
    from parlayann_tpu_torch.ops.kernels.expand import expand_distances
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.ops.kernels.fusedbeam import beam_search_fused
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
    from parlayann_tpu_torch.harness.recall import compute_recall

    gt_ids, gt_d = gt
    for w in (expand_distances, occlusion_rounds, beam_search_fused, flat_topk):
        w.launches = 0
    expand_distances.launches_f32 = occlusion_rounds.launches_f32 = 0
    torch.cuda.synchronize()
    builds, out = {}, dict(build_s={}, recall={}, qps={})
    for name in HNSW_BUILDS:
        builds[name], out["build_s"][name] = hnsw_build(X, name, dev)
    for name, efs in HNSW_EFS.items():
        for ef in efs:
            ids, dists, res, dt = builds[name].batch_search_timed(Q, k=K, ef=ef, rounds=3)
            r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
            what = f"HNSW {name} ef={ef}"
            check(ids.shape == (len(Q), K) and bool((ids >= 0).all()), f"{what}: malformed ids")
            check(_no_duplicates(ids), f"{what}: duplicate ids")
            check(bool(torch.isfinite(dists).all()), f"{what}: distances not finite")
            out["recall"][(name, ef)], out["qps"][(name, ef)] = r, len(Q) / dt
            log(f"{what}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  ({dt * 1e3:.3f} ms / "
                f"{len(Q)} queries; visited {float(res.num_visited.float().mean()):.2f} "
                f"cmps {float(res.dist_cmps.float().mean()):.1f})")
    torch.cuda.synchronize()
    launches = {
        "expand_distances": expand_distances.launches - expand_distances.launches_f32,
        "expand_distances (f32 rows)": expand_distances.launches_f32,
        "occlusion_rounds": occlusion_rounds.launches - occlusion_rounds.launches_f32,
        "occlusion_rounds (f32 rows)": occlusion_rounds.launches_f32,
        "beam_search_fused": beam_search_fused.launches,
        "flat_topk": flat_topk.launches,
    }
    log("launches during the HNSW slice:", launches)
    for name, n in launches.items():
        if name != "expand_distances (f32 rows)":  # no f32 inline rows on this path
            check(n > 0, f"{name} was not launched by the HNSW slice")
    for name in HNSW_BUILDS:
        r = out["recall"][(name, 50)]
        check(r >= HNSW_BAR, f"HNSW {name} recall@{K} at ef 50 is {r:.4f} < {HNSW_BAR}")
    return builds, launches, out


def hnsw_profile(X, Q, dev):
    """Build A once more under torch.profiler (the timed build stays
    unprofiled): idle share, kernels 2 and 4's device ms and launches; then
    one search at ef 12 of build A's index, profiled too."""
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk

    before = (occlusion_rounds.launches, flat_topk.launches)
    kept = {}
    prof = profile_window(lambda: kept.setdefault("idx", hnsw_build(X, "A", dev)[0]),
                          "100K HNSW build A")
    check(prof is not None, "the profiled HNSW build saw no device activity")
    n2, n4 = occlusion_rounds.launches - before[0], flat_topk.launches - before[1]
    ms2 = sum(us for k, us in prof["by_name"].items() if "occlusion" in k) / 1e3
    ms4 = sum(us for k, us in prof["by_name"].items()
              if any(f in k for f in FLAT_KERNELS)) / 1e3
    check(n2 > 0 and n4 > 0 and ms2 > 0 and ms4 > 0,
          "the profiled HNSW build ran no occlusion_rounds or flat_topk")
    log(f"    occlusion_rounds {ms2:.4f} ms over {n2} launches; flat_topk {ms4:.4f} ms "
        f"over {n4} launches; busy {prof['busy_ms']:.3f} ms of {prof['wall_ms']:.3f} ms")
    qd = torch.as_tensor(Q).to(dev)
    sprof = profile_window(lambda: kept["idx"].batch_search(qd, k=K, ef=12),
                           f"HNSW A search of {len(Q)} queries at ef 12")
    check(sprof is not None, "the profiled HNSW search saw no device activity")
    return dict(idle=prof["idle"], busy_ms=prof["busy_ms"], occlusion_ms=ms2,
                occlusion_launches=n2, flat_ms=ms4, flat_launches=n4,
                search_idle=sprof["idle"])


def hnsw_level1_cases(builds, X, dev, B=2000, k=50):
    """Kernel 4's masked mode on level 1 as the builds call it: build A's
    f32 level points and build B's int8 ones (the q8 tier's rows), the
    queries of the steady batch that starts halfway through the insert
    order (the build's point vectors as f32), the mask of the level's
    members inserted before it, each row excluding its own level-1 id (-1
    for rows not on level 1), k = efc -> {name: case} for ``masked_case``;
    the yardstick multiplies every member of the level."""
    from parlayann_tpu_torch.build import hnsw
    from parlayann_tpu_torch.ops import quantize

    n = len(X)
    _, order = hnsw.insert_plan(n, builds["A"].m_l, HNSW_SEED)
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    lo = n // 2
    rows = torch.from_numpy(order[lo:lo + B].astype(np.int64)).to(dev)
    cases = {}
    for name, kind in (("A", "f32"), ("B", "int8")):
        idx = builds[name]
        lv = idx.levels[1]
        ml = len(lv.members)
        vm = np.zeros(lv.points_l.shape[0], dtype=bool)
        vm[:ml] = pos[lv.members] < lo
        data = idx.points.data
        if kind == "int8":
            data = quantize.quantize_pointset(idx.points, bits=8).data
        pts = data[lv.members_d.long()].contiguous()
        cases[f"hnsw_{name}_level1_masked_{kind}_B{B}_k{k}"] = dict(
            q=data[rows].float().contiguous(), pts=pts, mask=torch.from_numpy(vm).to(dev),
            excl=lv.glob2loc_d[rows].contiguous(), k=k, metric=idx.points.metric,
            n_valid=ml, lib_rows=ml, what=f"HNSW {name} level 1")
    return cases


EXACT_FRAC = 0.16  # phase 11b's exact build: batch_cap_frac
EXACT_K = 64  # its kc = min(vmax, max(L, R + 8)) at R = 32, L = 64


def exact_build_cases(X, dev):
    """Kernel 4's masked mode at the exact-candidate build's shapes (phase
    11b: q8 tier, R = 32, L = 64, seed 0), from its own schedule
    (``batch_schedule(n, n, 0.16)``) and pass orders
    (``default_rng(0).permutation`` twice): (a) pass 1's doubling batch of
    rows [127, 255), padded to 256; (b) pass 1's steady batch [48383,
    64383) of 16,000 rows; (c) the same batch of pass 2, all points
    inserted. Each row queries its own q8 row as f32 and excludes its own id
    (pad rows: row 0, no exclusion), k = 64, the mask the points inserted
    before the batch (point 0, the start, from the outset) -> {name: case}
    for ``masked_case``; the yardstick multiplies the points in the mask."""
    from parlayann_tpu_torch.build.vamana import _pad_pow2, batch_schedule
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.ops import quantize

    n = len(X)
    tier = quantize.quantize_pointset(PointSet.from_numpy(X, device=dev), bits=8)
    sched, max_batch = batch_schedule(n, n, EXACT_FRAC)
    rng = np.random.default_rng(0)
    orders = [rng.permutation(n).astype(np.int32) for _ in range(2)]
    steady = [b for b in sched if b[1] - b[0] >= max(max_batch, 4096)]
    picks = (("a_pass1_doubling", 0, (127, 255)), ("b_pass1_steady", 0, steady[2]),
             ("c_pass2_steady", 1, steady[2]))
    cases = {}
    for name, p, (lo, hi) in picks:
        order = orders[p]
        batch = torch.from_numpy(_pad_pow2(order[lo:hi], max_batch)).to(dev)
        ins = np.zeros(tier.data.shape[0], dtype=bool)
        ins[0] = True
        ins[order[:lo] if p == 0 else order] = True
        B = len(batch)
        cases[f"exact_{name}_int8_B{B}_k{EXACT_K}"] = dict(
            q=tier.data[batch.long().clamp(min=0)].float().contiguous(), pts=tier.data,
            mask=torch.from_numpy(ins).to(dev), excl=batch, k=EXACT_K, metric=tier.metric,
            n_valid=n, lib_rows=None,
            what=f"the exact build's {'pass 1' if p == 0 else 'pass 2'} rows [{lo}, {hi})")
    return cases


def masked_case(case, reps=20, plain_reps=5):
    """Check kernel 4's masked mode on one case against its plain version
    (int8 bit-equal, f32 under phase 2's rule; no excluded id, no id outside
    the mask) and time it -> dict(ms, plain_ms, library_ms, max_abs_err,
    bound_ms, bound_by, n_in). The yardstick is ``torch.addmm`` of the
    distance matrix over the case's ``lib_rows`` first rows (None: the
    points in the mask); the bound counts the points in the mask, the bytes
    of the in-mask rows, the mask, the queries, the exclusions and the
    (B, k) lists against the operations of 2 B N_in d: on int8 points with
    integer-valued queries (every case here) an int8 x int8 product at the
    int8 rate (``int8_valued``), else 3 TF32 passes. The kernel's own
    passes, 2 TF32 passes on int8 points, give ``bound_tf32_ms``."""
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk, flat_topk_plain

    q, pts, mask, excl, k = case["q"], case["pts"], case["mask"], case["excl"], case["k"]
    kw = dict(k=k, metric=case["metric"], n_valid=case["n_valid"])
    kind = "int8" if pts.dtype == torch.int8 else "f32"
    what = f"flat_topk masked {kind} ({case['what']})"
    got = flat_topk(q, pts, mask, excl, **kw)
    want = flat_topk_plain(q, pts, mask, excl, **kw)
    if kind == "int8":
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"{what}: not equal")
        err, note = 0.0, "equal"
    else:
        x = pts.float()
        scale = (q * q).sum(1) + (x * x).sum(1).max()
        rel, n_tie = check_topk(got, want, scale, what)
        ok = want[0] >= 0
        err = float((got[1] - want[1]).abs()[ok].max())
        note = f"max rel err {rel:.3g}, {n_tie} rows with tie swaps"
    check(not bool((got[0] == excl[:, None]).any()), f"{what}: an excluded id")
    check(bool(mask[got[0][got[0] >= 0].long()].all()), f"{what}: an id outside the mask")
    ms = time_ms(lambda: flat_topk(q, pts, mask, excl, **kw), reps)
    plain_ms = time_ms(lambda: flat_topk_plain(q, pts, mask, excl, **kw), plain_reps)
    valid = mask.clone()
    valid[case["n_valid"]:] = False
    n_in = int(valid.sum())
    x = (pts[:case["lib_rows"]] if case["lib_rows"] else pts[valid]).float()
    xn = (x * x).sum(1)[None, :]
    lib_ms = time_ms(lambda: torch.addmm(xn, q, x.T, beta=1.0, alpha=-2.0), reps)
    B, d = q.shape
    passes = 3 if kind == "f32" else 2
    nbytes = n_in * d * pts.element_size() + pts.shape[0] + B * d * 4 + B * 4 + B * k * 8
    tf32 = bound(nbytes, passes * 2 * B * n_in * d, TF32_OPS)
    if kind == "int8" and int8_valued(q):
        b, rate = bound(nbytes, 2 * B * n_in * d, INT8_OPS), "the int8 rate"
    else:
        b, rate = tf32, f"{passes} TF32 passes"
    log(f"kernel 4 {what} ({pts.shape[0]} points, {n_in} in the mask) B={B} k={k}: {note}; "
        f"{ms:.4f} ms vs plain {plain_ms:.4f} ms (torch.addmm of the "
        f"{'level' if case['lib_rows'] else 'in-mask'} distance matrix {lib_ms:.4f} ms); "
        f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {rate} over the {n_in} points in "
        f"the mask; {passes} TF32 passes {tf32['bound_ms']:.4f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, max_abs_err=err, n_in=n_in,
                bound_tf32_ms=tf32["bound_ms"], **b)


HCNNG_BEAMS = (10, 16, 32, 64)
PYNN_BEAMS = (30, 55, 80)
PYNN_BUILDS = {"A": dict(), "B": dict(quantize_build=True)}  # f32, then q8
# recall@10 floor at beam 80 of both pyNNDescent builds, with one random
# start, on the standard-normal 100K set: the first card run of this phase
# showed 0.5509 (A) and 0.5501 (B) on an NVIDIA H100 80GB HBM3; 0.50
# leaves 0.05 for other draws and run-to-run change
PYNN_BAR = 0.50
PYNN_SEED = 0  # the pyNNDescent and HCNNG builds' draws
HCNNG_FUSED = FUSED_SHAPES  # kernel 3's (B, L) on the HCNNG graph
PYNN_FUSED = (10_000, 80)  # kernel 3's (B, L) on pyNNDescent build A


def knn_share(graph, points, dev, sample=1000):
    """The share of each sampled point's exact 10 nearest neighbours (itself
    excluded) that its graph row holds, over ``sample`` points drawn from
    seed 7."""
    from parlayann_tpu_torch.ops import distance

    rows = torch.from_numpy(np.random.default_rng(SEED).choice(
        points.n, sample, replace=False)).to(dev)
    d = distance.all_pairs(points.data[rows], points.data[:points.n], points.metric)
    d[torch.arange(sample, device=dev), rows] = float("inf")
    true = torch.topk(d, K, dim=1, largest=False).indices
    nb = graph.neighbors[rows].long()
    nb = torch.where(torch.arange(nb.shape[1], device=dev)[None, :]
                     < graph.degrees[rows][:, None], nb, -1)
    return float((true[:, :, None] == nb[:, None, :]).any(-1).float().mean())


def draw_cost(dev, n_pad=100_000, K_deg=40):
    """The seconds of one descent round's draws at n_pad (the (n_pad, 16)
    and (n_pad, 16, 16) join slots and the (n_pad K,) reverse keys), on the
    host generator (moved to the card) and on the card's, which a card
    build uses -> (host, card)."""
    from parlayann_tpu_torch.utils.draws import Draws

    out = []
    for host in (True, False):
        dr = Draws(PYNN_SEED, dev, host=host)
        dr.hops(0, n_pad, 16, 16, 2 * K_deg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dr.reverse_bits(0, n_pad * K_deg)
        dr.hops(0, n_pad, 16, 16, 2 * K_deg)
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return tuple(out)


def hcnng_run(X, Q, gt, dev):
    """Phase 9, HCNNG: the SIFT-100K configuration on phase 3's set, its
    q8 search -> the q8 Index over the graph."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.harness.recall import compute_recall

    gt_ids, gt_d = gt
    split = {}
    torch.cuda.synchronize()
    graph, points, secs = pt.build_hcnng_index(X, mst_deg=3, num_clusters=30,
                                               cluster_size=1000, device=dev,
                                               seed=PYNN_SEED, stats=split)
    avg_deg, max_deg = graph.stats()
    check(graph.max_degree == 90 and max_deg <= 90 and avg_deg > 3,
          f"HCNNG: degrees avg {avg_deg} max {max_deg}")
    log(f"HCNNG build (mst_deg=3, num_clusters=30, cluster_size=1000, f32): {secs:.3f} s "
        f"fenced: label trees {split['labels_s']:.3f} s, candidate passes (queueing and "
        f"waits) {split['candidates_s']:.3f} s, Kruskal {split['kruskal_s']:.3f} s, assembly "
        f"{split['assembly_s']:.3f} s; degree avg {avg_deg:.3f} max {max_deg}")
    idx = pt.Index(points=points, graph=graph).enable_quantized(bits=8)
    recall = {}
    for beam in HCNNG_BEAMS:
        ids, dists, res, dt = idx.batch_search_timed(Q, k=K, beam_size=beam, rounds=3)
        r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
        recall[beam] = r
        what = f"HCNNG q8 search beam={beam}"
        check(ids.shape == (len(Q), K) and bool((ids >= 0).all()), f"{what}: malformed ids")
        check(_no_duplicates(ids), f"{what}: duplicate ids")
        check(bool(torch.isfinite(dists).all()), f"{what}: distances not finite")
        log(f"{what}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  ({dt * 1e3:.3f} ms; "
            f"visited {float(res.num_visited.float().mean()):.2f} "
            f"cmps {float(res.dist_cmps.float().mean()):.1f})")
    check(recall[64] >= RECALL_BAR,
          f"HCNNG recall@{K} at beam 64 is {recall[64]:.4f} < {RECALL_BAR}")
    return idx, dict(build_s=secs, recall=recall, **split)


def pynn_run(dev):
    """Phase 9, pyNNDescent: builds A (f32) and B (q8) of the SIFT-100K
    configuration on the standard-normal 100K set, each searched on the q8
    tier with one random start -> ({build: Index}, the queries)."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.utils import synthetic

    X, Q = synthetic.uniform(100_000, 128, n_queries=10_000, seed=SEED)
    t0 = time.perf_counter()
    points = pt.PointSet.from_numpy(X, device=dev)
    gt_ids, gt_d = exact.compute_groundtruth(points, Q, 2 * K)
    log(f"data: synthetic uniform {X.shape}, {len(Q)} queries; exact top-{2 * K} on the "
        f"card {time.perf_counter() - t0:.3f} s")
    host_s, card_s = draw_cost(dev)
    log(f"one descent round's draws at n_pad=100000: host generator {host_s:.4f} s, "
        f"card generator {card_s:.4f} s")
    out, recall = {}, {}
    for name, kw in PYNN_BUILDS.items():
        stats = {}
        torch.cuda.synchronize()
        graph, _, secs = pt.build_pynndescent_index(
            points, max_deg=40, cluster_size=100, num_clusters=10, alpha=1.2, delta=0.05,
            seed=PYNN_SEED, stats=stats, **kw)
        avg_deg, max_deg = graph.stats()
        check(max_deg <= 40 and avg_deg > 5, f"pyNNDescent {name}: degrees {avg_deg}/{max_deg}")
        share = knn_share(graph, points, dev)
        log(f"pyNNDescent build {name} ({kw or 'f32'}): {secs:.3f} s fenced: init "
            f"{stats['init_s']:.3f} s, {len(stats['changed'])} rounds and the polish "
            f"{stats['rounds_s']:.3f} s, prune {stats['prune_s']:.3f} s; changed "
            f"{stats['changed']}, polish {stats['polish_changed']}; degree avg "
            f"{avg_deg:.3f} max {max_deg}; true 10-NN held in the row {share:.4f}")
        idx = pt.Index(points=points, graph=graph).enable_quantized(bits=8)
        for beam in PYNN_BEAMS:
            ids, dists, res, dt = idx.batch_search_timed(
                Q, k=K, beam_size=beam, random_starts=1, seed=SEED, rounds=3)
            r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
            recall[(name, beam)] = r
            what = f"pyNNDescent {name} q8 search beam={beam} random_starts=1"
            check(ids.shape == (len(Q), K) and bool((ids >= 0).all()), f"{what}: malformed ids")
            check(_no_duplicates(ids), f"{what}: duplicate ids")
            check(bool(torch.isfinite(dists).all()), f"{what}: distances not finite")
            log(f"{what}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  ({dt * 1e3:.3f} ms; "
                f"visited {float(res.num_visited.float().mean()):.2f} "
                f"cmps {float(res.dist_cmps.float().mean()):.1f})")
        out[name] = idx
    for name in PYNN_BUILDS:
        r = recall[(name, PYNN_BEAMS[-1])]
        check(r >= PYNN_BAR, f"pyNNDescent {name} recall@{K} at beam {PYNN_BEAMS[-1]} is "
              f"{r:.4f} < {PYNN_BAR}")
    return out, Q


def kernel_fusedbeam_random(idx, Q, dev, B, L):
    """Kernel 3 on a pyNNDescent graph with the search's random starts (one
    a query, drawn as ``Index.batch_search`` draws them), against its plain
    version -> times and bound."""
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.fusedbeam import (
        beam_search_fused, beam_search_fused_plain)

    q = torch.as_tensor(Q[:B]).to(dev)
    tier, g = idx.qpoints, idx.graph
    starts = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, tier.n, (B, 1)).astype(np.int32)).to(dev)
    args = (quantize.translate_query(q, tier).float(), tier.data, g.neighbors, g.degrees,
            starts)
    kw = dict(metric=tier.metric, n_valid=tier.n, k=K, L=L, limit=tier.n)
    expanded = []
    got = beam_search_fused(*args, **kw)
    want = beam_search_fused_plain(*args, **kw, expanded=expanded)
    for name, a, b in zip(("ids", "dists", "num_visited", "dist_cmps"), got, want):
        check(torch.equal(a, b), f"beam_search_fused random starts B={B} L={L}: {name} differ")
    ms = time_ms(lambda: beam_search_fused(*args, **kw), 10)
    n_cmp = int(got[3].sum())
    n_rows, n_adj = fused_rows(args, kw["n_valid"], expanded)
    d, R = args[0].shape[1], args[2].shape[1]
    b = bound(n_rows * d + n_adj * (R + 1) * 4 + B * d * 4 + B * 4 + B * L * 8 + B * 8,
              2 * n_cmp * d, INT8_OPS)
    log(f"kernel 3 beam_search_fused B={B} L={L} R={R} on pyNNDescent A's graph, one random "
        f"start a query: ids, dists, nv, cmps equal; {ms:.4f} ms; bound {b['bound_ms']:.4f} "
        f"ms ({b['bound_by']}; {n_adj} vertices, {n_cmp} distances to {n_rows} rows); "
        f"visits mean {float(got[2].float().mean()):.2f} max {int(got[2].max())}")
    return dict(ms=ms, **b)


def tier_run(dev):
    """Phase 6: the capacity tiers at bench_1m_tiers' size -> (launches,
    the tiers' inline words and query words for kernel 6's check)."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.entry import entry_top1
    from parlayann_tpu_torch.ops.kernels.expand import expand_bits_flat, expand_distances
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    X, Q = synthetic.clustered(TIER_N, 128, n_queries=10_000, n_clusters=10_000,
                               cluster_std=0.35, seed=SEED)
    log(f"data: synthetic clustered {X.shape}, {len(Q)} queries, 10000 clusters "
        f"({time.perf_counter() - t0:.2f} s)")
    wrappers = (expand_distances, occlusion_rounds, expand_bits_flat, entry_top1)
    for w in wrappers:
        w.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph, points, stats = pt.build_vamana_index(
        X, R=32, L=64, alpha=1.2, batch_cap_frac=0.04, device=dev)
    torch.cuda.synchronize()
    avg_deg, max_deg = graph.stats()
    log(f"build: {time.perf_counter() - t0:.3f} s (q8, R=32 L=64 alpha=1.2, 2 passes, "
        f"batch_cap_frac=0.04); degree avg {avg_deg:.3f} max {max_deg}; "
        f"visited {stats.total_visited} cmps {stats.total_cmps}")
    t0 = time.perf_counter()
    gt_ids, gt_d = exact.compute_groundtruth(points, Q, 2 * K)
    log(f"ground truth: exact top-{2 * K} on the card, {time.perf_counter() - t0:.3f} s")

    q = torch.from_numpy(Q).to(dev)
    idx = pt.Index(points=points, graph=graph)
    sample = torch.arange(0, len(Q), 37, device=dev)
    kept, recall = {}, {}
    tiers = (("bit", TIER_BEAMS, lambda: idx.enable_bit_tier()),
             ("jl512", TIER_BEAMS, lambda: idx.enable_jl(jl_dims=512, bits=1)),
             ("jl1024-8bit", (100,),
              lambda: idx.enable_jl(jl_dims=1024, bits=8, sparse_nnz=6)))
    for name, beams, enable in tiers:
        idx.bit_points = idx.jl_tier = None
        t0 = time.perf_counter()
        enable()
        torch.cuda.synchronize()
        log(f"tier {name}: built in {time.perf_counter() - t0:.3f} s")
        for beam in beams:
            ids, dists, res, dt = idx.batch_search_timed(
                q, k=K, beam_size=beam, rerank_factor=20, rounds=1)
            what = f"tier {name} beam {beam}"
            check(ids.shape == (len(Q), K) and bool((ids >= 0).all())
                  and bool((ids < TIER_N).all()), f"{what}: malformed ids")
            check(_no_duplicates(ids), f"{what}: duplicate ids")
            # the reranked distances are the f32 distances of the ids
            s_ids = ids[sample].long()
            want = ((points.data[s_ids] - q[sample][:, None, :]) ** 2).sum(-1)
            torch.testing.assert_close(dists[sample], want, rtol=1e-5, atol=0)
            r = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
            recall[(name, beam)] = r
            log(f"{what}: recall@{K} {r:.4f}  QPS {len(Q) / dt:.1f}  "
                f"({dt * 1e3:.3f} ms; visited {float(res.num_visited.float().mean()):.2f} "
                f"cmps {float(res.dist_cmps.float().mean()):.1f})")
        profile_window(lambda: idx.batch_search(q, k=K, beam_size=beams[0],
                                                rerank_factor=20),
                       f"tier {name} beam {beams[0]}")
        if idx.jl_tier is None or idx.jl_tier.bits == 1:
            tier = idx.bit_points if idx.jl_tier is None else idx.jl_tier.points
            inline = idx.inline_bits
            check(idx._inline_bits_src is tier, f"tier {name}: stale inline words")
            qw = (quantize.bit_translate_query(q, tier) if idx.jl_tier is None
                  else idx.jl_tier.translate_query(q))
            kept[name] = (inline, qw)
            log(f"tier {name}: inline words {tuple(inline.shape)} "
                f"{inline.numel() * 4 / 1e9:.3f} GB; tier words "
                f"{tier.data.numel() * 4 / 1e6:.1f} MB")
        else:
            log(f"tier {name}: int8 projections {tuple(idx.jl_tier.points.data.shape)} "
                f"{idx.jl_tier.points.data.numel() / 1e9:.3f} GB (no inline array)")
    torch.cuda.synchronize()
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"peak device memory in phase 6: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("launches during the tier slice:", launches)
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the tier slice")
    for (name, beam), floor in TIER_BARS.items():
        check(recall[(name, beam)] >= floor, f"tier {name} recall@{K} at beam {beam} "
              f"is {recall[(name, beam)]:.4f} < {floor}")
    del idx
    fused_launches, k3b = fused_1m(X, q, points, graph, (gt_ids, gt_d), dev)
    return launches, kept, fused_launches, k3b


FUSED_1M_B = 40_000  # a steady batch of phase 6's build: 0.04 x 1M inserts


def fused_1m(X, q, points, graph, gt, dev):
    """Phase 6's q8 build once more with fused_read=True, beside phase 6's
    graph: recall@10 at beams 10 and 64 within FUSED_GAP of it on the q8
    tier; then kernel 3's build mode held to its plain version and timed
    at the build's steady batch over phase 6's graph -> (the fused build's
    launches, the build mode's times and bound at 1M)."""
    import parlayann_tpu_torch as pt

    steady = 2 * steady_batches(TIER_N, 0.04)
    g, ps, st, secs, launches = counted_build(X, dev, R=32, L=64, alpha=1.2,
                                              batch_cap_frac=0.04, fused_read=True)
    avg, mx = g.stats()
    log(f"fused_read=True build: {secs:.3f} s (q8, R=32 L=64 alpha=1.2, 2 passes, "
        f"batch_cap_frac=0.04); degree avg {avg:.3f} max {mx}; visited {st.total_visited} "
        f"cmps {st.total_cmps}; launches {dict((k, v) for k, v in launches.items() if v)}")
    rec = {}
    for name, (p, gr) in (("phase 6's graph", (points, graph)), ("fused build", (ps, g))):
        rec[name] = _search_rows(_index_search(
            pt.Index(points=p, graph=gr).enable_quantized(bits=8), q), TIER_N, gt, (10, 64),
            f"1M {name}, q8")
    check(launches["build_beam_fused"] == steady, f"6: build_beam_fused launched "
          f"{launches['build_beam_fused']} times, not {steady}")
    for beam in (10, 64):
        gap = rec["fused build"][beam] - rec["phase 6's graph"][beam]
        check(abs(gap) <= FUSED_GAP, f"6: the fused build's recall@{K} at beam {beam} is "
              f"{gap:+.4f} off phase 6's graph's")
    del g, ps
    k3b = kernel_build_fused(pt.Index(points=points, graph=graph).enable_quantized(bits=8),
                             dev, B=FUSED_1M_B, what="phase 6's 1M graph")
    return launches, k3b


def kernel_bits(kept, gen, dev):
    """Kernel 6 against its plain version on the tiers' inline words, B=32000
    random vertices with the tier's own query words. The timed launches
    cycle through 8 id sets, more rows than the 50 MB L2 cache holds, so
    each launch reads its rows from device memory as a search step does."""
    import itertools

    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_bits_flat, expand_bits_flat_plain, expand_distances)

    B, out = 32_000, {}
    for name, (inline, qw) in kept.items():
        n_pad, R8, W = inline.shape
        id_sets = [torch.randint(0, n_pad, (B,), generator=gen, dtype=torch.int32).to(dev)
                   for _ in range(8)]
        ids = id_sets[0]
        q = qw[torch.arange(B, device=dev) % qw.shape[0]].contiguous()
        got = expand_bits_flat(inline, ids, q)
        ref = expand_bits_flat_plain(inline, ids, q)
        check(torch.equal(got, ref), f"expand_bits_flat W={W} not bit-equal")
        check(torch.equal(expand_distances(inline, ids, q, metric=Metric.L2, bits=1), ref),
              f"expand_distances(bits=1) W={W} not bit-equal")
        cycle = itertools.cycle(id_sets)
        ms = time_ms(lambda: expand_bits_flat(inline, next(cycle), q), 48)
        plain_ms = time_ms(lambda: expand_bits_flat_plain(inline, ids, q), 5)
        b = bound(unique_rows(ids, n_pad) * R8 * W * 4 + B * W * 4 + B * 4 + B * R8 * 4,
                  3 * B * R8 * W)
        out[W] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b)
        log(f"kernel 6 expand_bits_flat {name} B={B} inline={tuple(inline.shape)}: "
            f"bit-equal, and through expand_distances(bits=1); {ms:.4f} ms vs plain "
            f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']})")
    return out

# phase 10: the reference's command line, tools and range search
RANGE_N, RANGE_D = 1_000_000, 256  # SSNPP's row shape: 256-d uint8
RANGE_PCTL = 20  # scripts/bench_range.py: percentile of the exact 1-NN distances
RANGE_BEAMS_Q = (10, 20, 30, 40, 50, 100)  # scripts/bench_range.py's beams
RANGE_BAR = 0.95  # cumulative range recall of the 10K queries at beam 100
SELFJOIN_BAR = 0.90  # the self-join's cumulative recall over sampled points
SELFJOIN_SAMPLE = 2000  # vamanaRange/neighbors.h:120-138's brute-force check
RANGE_CROP = 1000  # queries of the full-beam CLI run (RANGE_BEAMS, up to 3000)


class _Tee:
    """stdout that is also kept."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.out.write(s)
        self.parts.append(s)
        return len(s)

    def flush(self):
        self.out.flush()


def run_cli(args, what):
    """``cli.main(args)`` on the card -> (its printed text, fenced seconds)."""
    import contextlib

    from parlayann_tpu_torch import cli

    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(rc == 0, f"{what}: the CLI returned {rc}")
    log(f"{what}: {secs:.3f} s")
    return "".join(tee.parts), secs


def _wrappers():
    """Every kernel wrapper, each counting its launches."""
    from parlayann_tpu_torch.ops.kernels.clusterbeam import cluster_walk
    from parlayann_tpu_torch.ops.kernels.entry import entry_top1
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_bits_flat, expand_distances, expand_distances_multi)
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
    from parlayann_tpu_torch.ops.kernels.fusedbeam import beam_search_fused, build_beam_fused
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds

    return (expand_distances, expand_distances_multi, occlusion_rounds, beam_search_fused,
            build_beam_fused, flat_topk, cluster_walk, expand_bits_flat, entry_top1)


def _zero_launches():
    torch.cuda.synchronize()
    for w in _wrappers():
        w.launches = 0
        for mode in ("launches_f32", "launches_i16"):
            if hasattr(w, mode):
                setattr(w, mode, 0)


def _launch_counts():
    """{kernel entry of the JSON line: launches since _zero_launches}; the
    f32 modes of kernels 1 (single and multi-probe) and 2 and kernel 1's
    int16 mode have entries of their own."""
    torch.cuda.synchronize()
    out = {}
    for w in _wrappers():
        f32 = getattr(w, "launches_f32", None)
        i16 = getattr(w, "launches_i16", None)
        out[w.__name__] = w.launches - (f32 or 0) - (i16 or 0)
        if f32 is not None:
            out[f"{w.__name__} (f32 rows)"] = f32
        if i16 is not None:
            out[f"{w.__name__} (int16 rows)"] = i16
    return out


def tutorial_run(X, Q, dev):
    """Phase 10a: the tutorial's k-NN flow (scripts/tutorial.sh) through
    the tools and the CLI on phase 3's set -> {kernel: launches}."""
    import csv
    import re
    import tempfile

    from parlayann_tpu_torch.data import io
    from parlayann_tpu_torch.tools import compute_groundtruth

    with tempfile.TemporaryDirectory() as tmp:
        f = {k: f"{tmp}/{k}" for k in ("base.fbin", "query.fbin", "gt.ibin", "g.graph",
                                       "res.csv")}
        io.write_bin(f["base.fbin"], X)
        io.write_bin(f["query.fbin"], Q)
        _zero_launches()
        t0 = time.perf_counter()
        compute_groundtruth.main(["-base_path", f["base.fbin"], "-query_path", f["query.fbin"],
                                  "-gt_path", f["gt.ibin"], "-k", "10"])
        log(f"tools.compute_groundtruth -k 10: {time.perf_counter() - t0:.3f} s")
        common = ["-base_path", f["base.fbin"], "-quantize", "1"]
        out, _ = run_cli(common + ["-R", "32", "-L", "64", "-alpha", "1.2", "-two_pass", "1",
                                   "-graph_outfile", f["g.graph"]], "CLI build")
        build_s = float(re.search(r"Built vamana graph in ([0-9.]+)s", out).group(1))
        log(f"CLI build: {build_s:.3f} s as the CLI prints it, at the CLI's "
            f"batch_cap_frac 0.02 (phase 3's build above ran at 0.16)")
        search = common + ["-graph_path", f["g.graph"], "-query_path", f["query.fbin"],
                           "-gt_path", f["gt.ibin"]]
        out, _ = run_cli(search + ["-Q", "64"], "CLI search at -Q 64")
        recall = float(re.search(r"recall = ([0-9.e+-]+), QPS", out).group(1))
        _, sweep_s = run_cli(search + ["-res_path", f["res.csv"]],
                             "CLI sweep (43 beams, 20 limits, the best-accuracy probe)")
        with open(f["res.csv"], newline="") as fh:
            rows = [r for r in csv.reader(fh)][4:]
        buckets = [(float(r[1]), float(r[2]), float(r[3]), int(r[9]), float(r[10]))
                   for r in rows if len(r) == 11]
        for b, rec, qps, beam, cut in buckets:
            log(f"  bucket {b}: recall {rec:.4f}, QPS {qps:.1f} (Q = {beam}, cut = {cut})")
    launches = _launch_counts()
    log("launches during phase 10a:", {k: v for k, v in launches.items() if v})
    log(f"  expand_distances: {launches['expand_distances']} launches. The CLI build's "
        f"batches stay under kernel 1's 4096 rows (0.02 x {len(X)} = {int(0.02 * len(X))}), "
        f"and every sweep row has degree_limit = min(32, 5 l) = 32, so the fused walk runs")
    check(recall >= RECALL_BAR, f"10a: recall@{K} at -Q 64 is {recall:.4f} < {RECALL_BAR}")
    check(any(b >= 0.95 for b, *_ in buckets), "10a: the CSV has no bucket at 0.95 or above")
    for name in ("occlusion_rounds", "beam_search_fused", "entry_top1"):
        check(launches[name] > 0, f"{name} was not launched by phase 10a")
    log(f"phase 10a: recall@{K} at -Q 64 {recall:.4f}; build {build_s:.3f} s; "
        f"sweep {sweep_s:.3f} s")
    return launches


def _exact_l2(xu, a, b, rows_per=1 << 20):
    """Exact squared L2 (int64) between uint8 rows a[i] and b[i] on the card."""
    out = []
    for lo in range(0, a.shape[0], rows_per):
        da = xu[a[lo:lo + rows_per]].int() - xu[b[lo:lo + rows_per]].int()
        out.append((da * da).sum(1, dtype=torch.int64))
    return torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=xu.device)


def _u8_affine(x, lo, hi):
    return ((x - lo) * (255.0 / (hi - lo))).round().clamp(0, 255).to(torch.uint8)


def range_run(dev):
    """Phase 10b: an SSNPP-shaped range run at 1M x 256 uint8 -> {kernel:
    launches}."""
    import re
    import tempfile

    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.build.vamana import INLINE_BUDGET
    from parlayann_tpu_torch.data import io
    from parlayann_tpu_torch.harness.recall import range_recall
    from parlayann_tpu_torch.harness.range_sweep import RANGE_BEAMS, range_search_wrapper
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.search.beam import beam_search_batch
    from parlayann_tpu_torch.search.range import (
        RangeResult, range_query, range_search_batch, self_join, self_join_rows)
    from parlayann_tpu_torch.tools import compute_range_groundtruth, crop
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    X, Q = synthetic.clustered(RANGE_N, RANGE_D, n_queries=10_000, n_clusters=10_000,
                               cluster_std=0.35, seed=SEED)
    x, q = torch.from_numpy(X).to(dev), torch.from_numpy(Q).to(dev)
    del X, Q
    lo, hi = x.min(), x.max()  # one affine map of the base's range onto [0, 255]
    xu, qu = _u8_affine(x, lo, hi), _u8_affine(q, lo, hi)
    del x, q
    xq = torch.cat([xu, qu])  # queries as rows RANGE_N.. for _exact_l2
    xu_np, qu_np = xu.cpu().numpy(), qu.cpu().numpy()
    log(f"data: synthetic clustered {tuple(xu.shape)} uint8, {qu.shape[0]} queries, 10000 "
        f"clusters, mapped onto [0, 255] ({time.perf_counter() - t0:.2f} s)")
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    points = pt.PointSet.from_numpy(xu_np, device=dev)
    nn_ids, _ = exact.exact_knn(qu_np, points, 1)
    nn_d = _exact_l2(xq, torch.arange(qu.shape[0], device=dev) + RANGE_N,
                     nn_ids[:, 0].long()).cpu().numpy()
    rad = float(np.percentile(nn_d, RANGE_PCTL))
    log(f"radius {rad} (the {RANGE_PCTL}th percentile of the queries' exact 1-NN squared "
        f"distances; median {float(np.median(nn_d))})")

    t0 = time.perf_counter()
    graph, points, stats = pt.build_vamana_index(
        xu_np, R=64, L=128, alpha=1.0, two_pass=True, quantize_build=False,
        batch_cap_frac=0.04, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    avg_deg, max_deg = graph.stats()
    inline_gb = points.n_pad * 64 * RANGE_D * 4 / 1e9
    log(f"build: {build_s:.3f} s (uint8 on its exact f32 copy, R=64 L=128 alpha=1.0, "
        f"2 passes, batch_cap_frac=0.04); degree avg {avg_deg:.3f} max {max_deg}; "
        f"visited {stats.total_visited} cmps {stats.total_cmps}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; read phase "
        f"{'inline rows (kernel 1)' if inline_gb * 1e9 <= INLINE_BUDGET else 'gathers rows'}"
        f" ({inline_gb:.1f} GB of f32 inline rows against a {INLINE_BUDGET / 2**30:.0f} GiB "
        f"budget)")
    nbrs, degs = graph.neighbors, graph.degrees
    r = repr(rad)
    with tempfile.TemporaryDirectory() as tmp:
        f = {k: f"{tmp}/{k}" for k in ("base.u8bin", "query.u8bin", "g.graph", "gt.rbin",
                                       "nz.u8bin", "crop.u8bin", "crop.rbin")}
        io.write_bin(f["base.u8bin"], xu_np)
        io.write_bin(f["query.u8bin"], qu_np)
        graph.save(f["g.graph"])  # -graph_outfile

        t0 = time.perf_counter()
        compute_range_groundtruth.main([
            "-base_path", f["base.u8bin"], "-query_path", f["query.u8bin"],
            "-gt_path", f["gt.rbin"], "-radius", r, "-data_type", "uint8",
            "-nonzero_path", f["nz.u8bin"]])
        gt = io.read_range_ibin(f["gt.rbin"])
        sizes = np.array([len(g) for g in gt])
        nz = io.read_bin(f["nz.u8bin"], np.uint8)
        check(nz.shape[0] == int((sizes > 0).sum()) and np.array_equal(nz, qu_np[sizes > 0]),
              "the -nonzero_path file is not the non-empty queries")
        log(f"range ground truth: {time.perf_counter() - t0:.3f} s; {int((sizes > 0).sum())} "
            f"of {len(gt)} queries non-empty, {int(sizes.sum())} matches, largest set "
            f"{int(sizes.max())}")

        out, cli_s = run_cli(["-base_path", f["base.u8bin"], "-graph_path", f["g.graph"],
                              "-data_type", "uint8", "-range", "-self", "-radius", r,
                              "-radius_2", r], "CLI self-join (files read included)")
        m = re.search(r"Self-join: (\d+) edges, (\d+) distance comparisons", out)
        edges, cmps = int(m.group(1)), int(m.group(2))

        # the self-join once more, for its lists
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows, cmps2 = self_join(points.data, nbrs, degs, rad, rad, metric=Metric.L2,
                                n_valid=RANGE_N)
        sj_s = time.perf_counter() - t0
        lens = np.array([len(a) for a in rows])
        check(int(lens.sum()) == edges and cmps2 == cmps,
              "the self-join's lists differ from the CLI's run")
        log(f"self-join: {edges} edges, {cmps} distance comparisons, {sj_s:.3f} s "
            f"({(RANGE_N + 4095) // 4096} batches of 4096; {int((lens > 0).sum())} points "
            f"with a match, largest list {int(lens.max())})")
        src = torch.from_numpy(np.repeat(np.arange(RANGE_N), lens)).to(dev)
        dst = torch.from_numpy(np.concatenate(rows).astype(np.int64)).to(dev)
        dd = _exact_l2(xu, src, dst)
        check(bool((dd <= rad).all()) and not bool((src == dst).any()),
              "the self-join reported a pair outside the radius, or a point itself")

        sample = np.sort(np.random.default_rng(SEED).choice(RANGE_N, SELFJOIN_SAMPLE,
                                                            replace=False))
        sgt = exact.compute_range_groundtruth(points, xu_np[sample], rad)
        sgt = [g[g != i] for g, i in zip(sgt, sample)]
        pw, cum = range_recall([rows[i] for i in sample], sgt)
        log(f"self-join sampled check ({SELFJOIN_SAMPLE} points, brute force over the base): "
            f"{sum(len(g) for g in sgt)} true pairs, pointwise recall {pw:.4f}, cumulative "
            f"{cum:.4f}")
        del src, dst, dd, rows

        qf = qu.float()
        cap = 256
        while cap < int(sizes.max()):
            cap *= 2
        torch.cuda.reset_peak_memory_stats()
        table = range_search_wrapper(qf, points.data, nbrs, degs, gt, rad, beams=RANGE_BEAMS_Q,
                                     metric=Metric.L2, n_valid=RANGE_N, repeats=2)
        log(f"query track: cap {cap} (largest set {int(sizes.max())}); peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        # exactness: every reported id lies within the radius, at its exact distance
        rr = range_query(qf, points.data, nbrs, degs, 0, rad, initial_beam=100, cap=cap,
                         metric=Metric.L2, n_valid=RANGE_N)
        hit = (rr.ids >= 0) & (rr.dists <= rad)
        qi, slot = hit.nonzero(as_tuple=True)
        ed = _exact_l2(xq, qi + RANGE_N, rr.ids[qi, slot].long())
        check(bool((ed <= rad).all()) and bool((ed.float() == rr.dists[qi, slot]).all()),
              "the query track reported an id outside the radius or at a wrong distance")
        # the ground truth's norm expansion against exact distances
        got = [set() for _ in gt]
        for a, b in zip(qi.tolist(), rr.ids[qi, slot].tolist()):
            got[a].add(b)
        gq = torch.from_numpy(np.repeat(np.arange(len(gt)), sizes)).to(dev)
        gi = torch.from_numpy(np.concatenate(gt).astype(np.int64)).to(dev)
        gd = _exact_l2(xq, gq + RANGE_N, gi)
        missed = sum(len(s - set(gt[a].tolist())) for a, s in enumerate(got))
        log(f"ground truth against exact distances: {int((gd > rad).sum())} of "
            f"{int(sizes.sum())} pairs beyond the radius, {missed} pairs within it missing "
            f"(the f32 norm expansion at {int(sizes.sum())} pairs)")

        # card against CPU on 256 non-empty queries, seeded by a beam search
        sel = torch.from_numpy(np.flatnonzero(sizes > 0)[:256]).to(dev)
        bres = beam_search_batch(
            qf[sel], points.data, nbrs, degs, torch.zeros(1, dtype=torch.int32, device=dev),
            metric=Metric.L2, n_valid=RANGE_N, k=0, L=100)
        seeds = torch.where(bres.beam_dists <= rad, bres.beam_ids, -1)
        args = (qf[sel], points.data, nbrs, degs, seeds)
        card = range_search_batch(*args, rad, metric=Metric.L2, n_valid=RANGE_N, cap=cap)
        host = range_search_batch(*(a.cpu() for a in args), rad, metric=Metric.L2,
                                  n_valid=RANGE_N, cap=cap)
        for a, b, name in zip(card, host, RangeResult._fields):
            check(torch.equal(a.cpu(), b), f"range_search_batch on the card: {name} differs "
                  f"from the CPU's")
        log(f"range_search_batch on 256 queries: card equals CPU (ids, dists, counts, "
            f"dist_cmps; {int(host.counts.sum())} matches)")

        prof = profile_window(
            lambda: self_join_rows(points.data, nbrs, degs,
                                   torch.arange(4096, dtype=torch.int32, device=dev), rad,
                                   metric=Metric.L2, n_valid=RANGE_N),
            "range BFS of 4096 self-join rows")
        check(prof is not None, "the profiled range BFS saw no device activity")

        crop.main([f["query.u8bin"], f["crop.u8bin"], "-n", str(RANGE_CROP)])
        compute_range_groundtruth.main([
            "-base_path", f["base.u8bin"], "-query_path", f["crop.u8bin"],
            "-gt_path", f["crop.rbin"], "-radius", r, "-data_type", "uint8"])
        out, full_s = run_cli(["-base_path", f["base.u8bin"], "-graph_path", f["g.graph"],
                               "-query_path", f["crop.u8bin"], "-gt_path", f["crop.rbin"],
                               "-data_type", "uint8", "-range", "-radius", r],
                              f"CLI range track, {RANGE_CROP} queries, beams 10-3000")
        check(out.count("For initial beam = ") == sum(b <= RANGE_N for b in RANGE_BEAMS),
              "the CLI range track missed a beam")
    launches = _launch_counts()
    log("launches during phase 10b:", {k: v for k, v in launches.items() if v})
    log(f"phase 10b: build {build_s:.3f} s, self-join {sj_s:.3f} s ({cli_s:.3f} s through "
        f"the CLI), full-beam CLI run {full_s:.3f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB since the query track")
    check(cum >= SELFJOIN_BAR, f"10b: the self-join's sampled cumulative recall {cum:.4f} "
          f"< {SELFJOIN_BAR}")
    row = {t.initial_beam: t for t in table}[100]
    check(row.cumulative_recall >= RANGE_BAR, f"10b: cumulative range recall at beam 100 "
          f"{row.cumulative_recall:.4f} < {RANGE_BAR}")
    check(launches["occlusion_rounds (f32 rows)"] > 0,
          "occlusion_rounds (f32 rows) was not launched by phase 10b")
    return launches



# phase 11: the last tiers and build modes
Q16_CPU = 256  # queries of 11a's card-against-CPU check of the 16-bit tier
SB_BAR = 0.85  # single-batch build, recall@10 at beam 64 (tests/test_vamana.py:127-146)
EXACT_GAP = 0.01  # |exact build - phase 3's build| recall@10 at beam 10
MIPS_N = 1_000_000
MIPS_BEAMS = {  # scripts/bench_mips_u8.py's sweeps
    "q8": (10, 15, 22, 33, 50, 75, 110, 160, 240),
    "4bit": (22, 33, 50, 75, 110, 160),
    "2bit": (33, 50, 75, 110, 160, 240),
    "q8_trim": (10, 22, 50),
}
MIPS_BAR = 0.95  # q8 and 4-bit: recall@10 reached within their beam lists
MIPS_2BIT_BAR = 0.80  # the 2-bit tier at beam 240 (the JAX package: 0.865)
FILTER_BEAMS = (10, 22)  # scripts/bench_tier_filter.py's C


def _index_search(idx, q, **kw):
    """Index.batch_search_timed of ``q`` as a function of the beam, for
    :func:`_search_rows`."""
    return lambda beam: idx.batch_search_timed(q, k=K, beam_size=beam, rounds=1, **kw)


def _search_rows(search, n, gt, beams, what):
    """``search(beam) -> (ids, dists, result, seconds)`` at each beam ->
    {beam: recall@10}, each row checked (shape, ids in [0, n), no
    duplicates, finite distances) and printed."""
    from parlayann_tpu_torch.harness.recall import compute_recall

    out = {}
    for beam in beams:
        ids, dists, res, dt = search(beam)
        check(ids.shape == (gt[0].shape[0], K) and bool((ids >= 0).all())
              and bool((ids < n).all()), f"{what} beam {beam}: malformed ids")
        check(_no_duplicates(ids), f"{what} beam {beam}: duplicate ids")
        check(bool(torch.isfinite(dists).all()), f"{what} beam {beam}: distances not finite")
        out[beam] = compute_recall(ids.cpu().numpy(), gt[0], gt[1], K)
        log(f"{what} beam={beam}: recall@{K} {out[beam]:.4f}  QPS {ids.shape[0] / dt:.1f}  "
            f"({dt * 1e3:.3f} ms; visited {float(res.num_visited.float().mean()):.2f} "
            f"cmps {float(res.dist_cmps.float().mean()):.1f})")
    return out


def _on_cpu(points, graph):
    import dataclasses

    return (dataclasses.replace(points, data=points.data.cpu()),
            dataclasses.replace(graph, neighbors=graph.neighbors.cpu(),
                                degrees=graph.degrees.cpu()))


def tiers11_run(points, graph, Q, gt, dev):
    """Phase 11a: the 16-bit scalar tier (the lock-step search on kernel
    1's int16 mode) and the 4-bit scalar tier (int8 levels, kernel 3) on
    phase 3's graph -> {kernel: launches}."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.entry import entry_tier, entry_top1
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.search.beam import beam_search_batch

    q = torch.from_numpy(Q).to(dev)
    _zero_launches()
    idx = pt.Index(points=points, graph=graph).enable_quantized(bits=16)
    recall = _search_rows(_index_search(idx, q), points.n, gt, BEAMS, "16-bit tier")
    check(idx.inline is not None and idx.inline.dtype == torch.int16,
          "the 16-bit tier did not search int16 inline rows")
    log(f"16-bit tier: inline rows {tuple(idx.inline.shape)} "
        f"{idx.inline.numel() * 2 / 1e9:.3f} GB; levels {tuple(idx.qpoints.data.shape)} int16")
    idx4 = pt.Index(points=points, graph=graph).enable_quantized(bits=4)
    recall4 = _search_rows(_index_search(idx4, q), points.n, gt, BEAMS,
                           "4-bit scalar tier (kernel 3)")
    launches = _launch_counts()
    log("launches during phase 11a:", {k: v for k, v in launches.items() if v})

    # the card against the CPU on Q16_CPU queries from the same starts
    qs = q[:Q16_CPU]
    idx.build_entry_cache()
    starts = entry_top1(qs, entry_tier(idx.entry_vecs, idx.entry_ids, points.metric))
    cpu_pts, cpu_graph = _on_cpu(points, graph)
    cidx = pt.Index(points=cpu_pts, graph=cpu_graph).enable_quantized(bits=16)
    check(torch.equal(cidx.qpoints.data, idx.qpoints.data.cpu()),
          "11a: the 16-bit levels differ between the card and the CPU")
    tq, cq = (quantize.translate_query(x, t.qpoints).float()
              for x, t in ((qs, idx), (qs.cpu(), cidx)))
    kw = dict(metric=points.metric, n_valid=points.n, k=K, L=64)
    got = beam_search_batch(tq, idx.qpoints.data, graph.neighbors, graph.degrees, starts,
                            None, idx.inline, **kw)
    want = beam_search_batch(cq, cidx.qpoints.data, cpu_graph.neighbors, cpu_graph.degrees,
                             starts.cpu(), None, cidx.build_inline_cache(), **kw)
    for name in ("beam_ids", "beam_dists", "num_visited", "dist_cmps"):
        check(torch.equal(getattr(got, name).cpu(), getattr(want, name)),
              f"11a: the 16-bit walk's {name} differ between the card and the CPU")
    gi, gd, _ = idx.batch_search(qs, k=K, beam_size=64, starts=starts)
    wi, wd, _ = cidx.batch_search(qs.cpu(), k=K, beam_size=64, starts=starts.cpu())
    torch.testing.assert_close(gd.cpu(), wd, rtol=1e-5, atol=0)
    check(bool(((gi.cpu() == wi) | torch.isclose(gd.cpu(), wd, rtol=1e-5)).all()),
          "11a: the 16-bit tier's reranked ids differ off ties between the card and the CPU")
    log(f"11a: the 16-bit walk of {Q16_CPU} queries at beam 64 equal on the card and the "
        f"CPU (beams, distances, visits, comparisons); reranked ids equal but at ties "
        f"({int((gi.cpu() != wi).sum())} differ)")
    for name in ("expand_distances (int16 rows)", "beam_search_fused", "entry_top1"):
        check(launches[name] > 0, f"{name} was not launched by phase 11a")
    check(recall[64] >= RECALL_BAR,
          f"16-bit tier recall@{K} at beam 64 is {recall[64]:.4f} < {RECALL_BAR}")
    log(f"phase 11a: 16-bit tier recall@{K} {recall[10]:.4f} / {recall[64]:.4f} at beams "
        f"10 / 64; 4-bit scalar tier {recall4[10]:.4f} / {recall4[64]:.4f}")
    return launches


def modes11_run(X, Q, gt, points, graph, dev):
    """Phase 11b: an exact-candidate build with profile=True and a
    single-batch build at 100K, on phase 3's set -> {kernel: launches}."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.build import vamana
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.types import BuildParams

    q = torch.from_numpy(Q).to(dev)
    ref = _search_rows(_index_search(pt.Index(points=points, graph=graph).enable_quantized(
        bits=8), q), points.n, gt, (10,), "phase 3's graph, q8")[10]
    split = vamana.profile_one_batch(
        quantize.quantize_pointset(points, bits=8),
        BuildParams(R=32, L=64, alpha=1.2, num_passes=2, batch_cap_frac=0.16), graph)
    log(f"one steady batch of phase 3's build (profile_one_batch, best of 2): beam "
        f"{split[0]:.4f} s, bidirect {split[1]:.4f} s, prune {split[2]:.4f} s")
    _zero_launches()
    out = {}
    for name, kw in (("exact", dict(cand_mode="exact", profile=True,
                                    batch_cap_frac=EXACT_FRAC)),
                     ("single_batch", dict(single_batch=8))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g, ps, stats = pt.build_vamana_index(X, R=32, L=64, alpha=1.2, device=dev, **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        avg, mx = g.stats()
        log(f"{name} build: {secs:.3f} s ({kw}); degree avg {avg:.3f} max {mx}; visited "
            f"{stats.total_visited} cmps {stats.total_cmps}; split beam "
            f"{stats.beam_time:.3f} s, bidirect {stats.bidirect_time:.3f} s, prune "
            f"{stats.prune_time:.3f} s")
        if name == "exact":
            check(stats.beam_time + stats.bidirect_time + stats.prune_time <= stats.build_time,
                  "11b: the profiled split exceeds the build time")
        out[name] = _search_rows(_index_search(pt.Index(points=ps, graph=g).enable_quantized(
            bits=8), q), ps.n, gt, (10, 64), f"{name} build, q8")
    launches = _launch_counts()
    log("launches during phase 11b:", {k: v for k, v in launches.items() if v})
    exact_kernel4_profile(X, dev)
    for name in ("occlusion_rounds", "flat_topk", "expand_distances"):
        check(launches[name] > 0, f"{name} was not launched by phase 11b")
    check(abs(out["exact"][10] - ref) <= EXACT_GAP,
          f"11b: the exact build's recall@{K} at beam 10 {out['exact'][10]:.4f} is not within "
          f"{EXACT_GAP} of phase 3's build's {ref:.4f}")
    check(out["single_batch"][64] >= SB_BAR,
          f"11b: the single-batch build's recall@{K} at beam 64 is "
          f"{out['single_batch'][64]:.4f} < {SB_BAR}")
    log(f"phase 11b: exact build recall@{K} at beam 10 {out['exact'][10]:.4f} (phase 3's "
        f"build {ref:.4f}); single-batch build at beam 64 {out['single_batch'][64]:.4f}")
    return launches


# the kernels of kernel 4's masked mode: the scan, the compaction passes and
# the merge of the splits
FLAT_KERNELS = ("flat_topk", "compact_count", "compact_scatter", "merge_splits")


def exact_kernel4_profile(X, dev):
    """Phase 11b's exact build once more under torch.profiler: kernel 4's
    launches and summed device time (the scan and, in the masked mode, its
    compaction and merge) beside the build's fenced beam split."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk

    before, kept = flat_topk.launches, {}
    prof = profile_window(lambda: kept.setdefault("stats", pt.build_vamana_index(
        X, R=32, L=64, alpha=1.2, device=dev, cand_mode="exact", profile=True,
        batch_cap_frac=EXACT_FRAC)[2]), "100K exact build")
    check(prof is not None, "the profiled exact build saw no device activity")
    n4 = flat_topk.launches - before
    ms4 = sum(us for k, us in prof["by_name"].items()
              if any(f in k for f in FLAT_KERNELS)) / 1e3
    st = kept["stats"]
    check(n4 > 0 and ms4 > 0, "the profiled exact build ran no flat_topk")
    log(f"    flat_topk (kernel 4 masked) {ms4:.4f} ms device time over {n4} launches; "
        f"the profiled build's fenced split: beam {st.beam_time:.3f} s, bidirect "
        f"{st.bidirect_time:.3f} s, prune {st.prune_time:.3f} s of {st.build_time:.3f} s")
    return dict(flat_ms=ms4, flat_launches=n4, busy_ms=prof["busy_ms"], idle=prof["idle"],
                beam_s=st.beam_time, build_s=st.build_time)


def mips11_run(dev):
    """Phase 11c: MIPS at 1M on scripts/bench_mips_u8.py's construction:
    the q8 build, the q8 sweep on kernel 3, the 4-bit and 2-bit tiers, the
    trimmed q8 tier and the f32 walk with the q8 filter -> {kernel:
    launches}."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.entry import entry_tier, entry_top1
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.search.beam import beam_search_batch
    from parlayann_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    X, Q = synthetic.sparse_clustered_u8(MIPS_N, 128, n_queries=10_000, seed=SEED)
    Qm = Q.astype(np.float32)
    Qm /= np.maximum(np.linalg.norm(Qm, axis=1, keepdims=True), 1e-30)
    log(f"data: sparse clustered uint8 {X.shape} ({(X == 0).mean():.2f} zeros), "
        f"{len(Q)} queries, normalized for MIPS ({time.perf_counter() - t0:.2f} s)")
    _zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    graph, points, stats = pt.build_vamana_index(X, metric="mips", R=32, L=64,
                                                 batch_cap_frac=0.16, device=dev)
    torch.cuda.synchronize()
    avg, mx = graph.stats()
    log(f"MIPS q8 build: {time.perf_counter() - t0:.3f} s (R=32 L=64, alpha 0.98 for d=128, "
        f"2 passes, batch_cap_frac=0.16); degree avg {avg:.3f} max {mx}; visited "
        f"{stats.total_visited} cmps {stats.total_cmps}")
    q = torch.from_numpy(Qm).to(dev)
    t0 = time.perf_counter()
    gt = exact.compute_groundtruth(points, Qm, 2 * K)
    log(f"ground truth: exact top-{2 * K} on the card, {time.perf_counter() - t0:.3f} s")
    recall = {}
    tiers = (("q8", lambda i: i.enable_quantized(bits=8)),
             ("4bit", lambda i: i.enable_mips_4bit()),
             ("2bit", lambda i: i.enable_mips_2bit()),
             ("q8_trim", lambda i: i.enable_quantized(bits=8, trim=0.001)))
    for name, enable in tiers:
        t0 = time.perf_counter()
        idx = enable(pt.Index(points=points, graph=graph))
        torch.cuda.synchronize()
        log(f"tier {name}: built in {time.perf_counter() - t0:.3f} s")
        recall[name] = _search_rows(_index_search(idx, q), points.n, gt, MIPS_BEAMS[name],
                                    f"MIPS {name}")
        if name == "q8":
            q8_idx = idx
    # the f32 walk, without and with the q8 tier's running-mean filter
    # (bench_tier_filter.py's B and C), from the entry tier's starts
    tier = q8_idx.qpoints
    q8_idx.build_entry_cache()
    starts = entry_top1(q, entry_tier(q8_idx.entry_vecs, q8_idx.entry_ids, points.metric))
    fq = quantize.translate_query(q, tier).float()

    def walk(filt):
        def search(beam):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = beam_search_batch(
                q, points.data, graph.neighbors, graph.degrees, starts, metric=points.metric,
                n_valid=points.n, k=K, L=beam, filter_data=tier.data if filt else None,
                filter_queries=fq if filt else None)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return res.beam_ids[:, :K], res.beam_dists[:, :K], res, dt
        return search

    # each walk twice, in the order B, C, C, B: one timing of a host-bound
    # loop is not enough to call a QPS difference
    for filt in (False, True, True, False):
        _search_rows(walk(filt), points.n, gt, FILTER_BEAMS,
                     f"f32 walk {'with the q8 filter' if filt else 'unfiltered'}")
    log(f"peak device memory in phase 11c: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    launches = _launch_counts()
    log("launches during phase 11c:", {k: v for k, v in launches.items() if v})
    for name in ("expand_distances", "occlusion_rounds", "beam_search_fused", "entry_top1"):
        check(launches[name] > 0, f"{name} was not launched by phase 11c")
    for name in ("q8", "4bit"):
        best = max(recall[name].values())
        check(best >= MIPS_BAR, f"11c: MIPS {name} reaches recall@{K} {best:.4f} < {MIPS_BAR} "
              f"within beams {MIPS_BEAMS[name]}")
    check(recall["2bit"][240] >= MIPS_2BIT_BAR,
          f"11c: MIPS 2bit recall@{K} at beam 240 is {recall['2bit'][240]:.4f} < {MIPS_2BIT_BAR}")
    log(f"phase 11c: best recall@{K} q8 {max(recall['q8'].values()):.4f}, 4-bit "
        f"{max(recall['4bit'].values()):.4f}; 2-bit at beam 240 {recall['2bit'][240]:.4f}")
    return launches

HIER_N = 10_000_000  # scripts/bench_10m_cluster.py's BENCH_N
HIER_NQ = 10_000
HIER_STD = 0.35  # each point a centre plus 0.35 N(0, 1)
HIER_BUILD = dict(m=64, Rc=16, slack=2.0, cand=8, ext_dtype="int8")  # BENCHES.md:425-450
HIER_PROBES = (8, 16, 32)  # cut 0
HIER_ADAPTIVE = (32, 4, 1.35)  # n_probe, min_probe, cut
HIER_SEED_PROBES = 16  # the JAX run's SEED_PROBES
HIER_BAR = 0.90  # recall@10 at n_probe 8, meta seed (the JAX package: 0.9617)
# the same build with kernel 1's single mode in the router (16 launches a
# chunk), on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 5): seconds
# of the whole build, of its three router rounds, of the final assign
# (polish included), of the routed adjacency and of the finish
HIER_SINGLE_MODE = dict(build=128.44, rounds=56.5, final=55.4, adjacency=3.65, finish=12.28)


def _build_split(text, rounds):
    """The hierarchical build's verbose lines -> {part: seconds}: its
    ``rounds`` router rounds (summed), final assign, respill, polish, the
    whole final phase, adjacency and finish. Fails if a part's line is
    missing."""
    import re

    def first(name, pattern):
        m = re.search(pattern, text)
        check(m is not None, f"phase 12: the build printed no {name} line ({pattern!r})")
        return float(m.group(1))

    got = re.findall(r"hier round \d+/\d+: ([\d.]+)s", text)
    check(len(got) == rounds, f"phase 12: the build printed {len(got)} of {rounds} round lines")
    return dict(rounds=sum(map(float, got)),
                assign=first("final assign", r"final assign: ([\d.]+)s"),
                respill=first("respill", r"respill: ([\d.]+)s"),
                polish=first("polish", r"polish: ([\d.]+)s"),
                final=first("hier final", r"hier final: ([\d.]+)s"),
                adjacency=first("adjacency", r"adjacency ([\d.]+) s"),
                finish=first("finish", r"finish ([\d.]+) s"))


def hier_data(dev):
    """scripts/bench_10m_cluster.py:66-91's construction, drawn on the card
    from the script's seed: HIER_N // 100 centres from N(0, 1), each point
    and query a uniformly chosen centre plus ``HIER_STD`` N(0, 1) ->
    (points (HIER_N, 128), queries (HIER_NQ, 128)) f32 on the card."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    centres = torch.randn((HIER_N // 100, 128), generator=g, device=dev)

    def draw(rows):
        out = torch.empty((rows, 128), device=dev)
        for lo in range(0, rows, 1 << 20):
            r = min(1 << 20, rows - lo)
            a = torch.randint(0, centres.shape[0], (r,), generator=g, device=dev)
            out[lo:lo + r] = centres[a] + HIER_STD * torch.randn((r, 128), generator=g,
                                                                 device=dev)
        return out

    return draw(HIER_N), draw(HIER_NQ)


def hier_run(dev):
    """Phase 12: the hierarchical ClusterIndex at 10M x 128 -> (index,
    points, queries, {kernel: launches}): the build (its split printed by
    ``verbose``), the meta-seeded search at ``HIER_PROBES`` and the adaptive
    row, and the streamed exact seed at n_probe 8."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.ops.distance import INF
    from parlayann_tpu_torch.search.flat import flat_search_batch
    from parlayann_tpu_torch.types import Metric

    _zero_launches()
    t0 = time.perf_counter()
    X, Q = hier_data(dev)
    torch.cuda.synchronize()
    log(f"data: {HIER_N} x 128 clustered ({HIER_N // 100} centres, std {HIER_STD}) and "
        f"{HIER_NQ} queries drawn on the card in {time.perf_counter() - t0:.2f} s")
    points = PointSet(data=X, n=HIER_N, d=128, metric=Metric.L2)
    t0 = time.perf_counter()
    gi, gd = flat_search_batch(Q, X, k=2 * K, metric=Metric.L2, n_valid=HIER_N,
                               select="pallas")
    gt = (gi.cpu().numpy(), gd.cpu().numpy())
    log(f"ground truth: exact top-{2 * K} on kernel 4, {time.perf_counter() - t0:.3f} s")
    import contextlib

    torch.cuda.reset_peak_memory_stats()
    tee = _Tee(sys.stdout)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        ci = pt.build_cluster_index(points, verbose=True, **HIER_BUILD)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    build = _launch_counts()
    split = _build_split("".join(tee.parts), tci.HIER_ROUNDS)
    Cm, cap = tci._meta_sizes(ci.C, tci.META_M)
    check(ci.seed_meta is not None and ci.seed_meta[1].dtype == torch.int8,
          "phase 12: the index has no int8 seed quantizer")
    log(f"hierarchical build: {secs:.3f} s fenced; C={ci.C} (n x C = {HIER_N * ci.C:.3g}, "
        f"C^2 = {ci.C ** 2:.3g}); router cells (Cm, cap) = ({Cm}, {cap}); seed cells "
        f"{tuple(ci.seed_meta[1].shape[:2])}; ext {tuple(ci.ext.shape)} "
        f"{ci.ext.numel() / 2**30:.3f} GiB; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"hierarchical build split: rounds {split['rounds']:.1f} s, final {split['final']:.1f} s "
        f"(assign {split['assign']:.1f}, respill {split['respill']:.1f}, polish "
        f"{split['polish']:.1f}), adjacency {split['adjacency']:.2f} s, finish "
        f"{split['finish']:.2f} s; with kernel 1's single mode (16 launches a router "
        f"chunk): {HIER_SINGLE_MODE['build']} s = rounds {HIER_SINGLE_MODE['rounds']} + "
        f"final {HIER_SINGLE_MODE['final']} + adjacency {HIER_SINGLE_MODE['adjacency']} + "
        f"finish {HIER_SINGLE_MODE['finish']}")
    modes = {"single int8": build["expand_distances"],
             "single f32": build["expand_distances (f32 rows)"],
             "multi int8": build["expand_distances_multi"],
             "multi f32": build["expand_distances_multi (f32 rows)"]}
    log("kernel 1 launches in the build by mode:", modes)
    # the three router rounds and the final assign: one multi launch a chunk
    chunks = -(-HIER_N // tci._kmeans_chunk_for(Cm))
    check(modes["multi f32"] >= (tci.HIER_ROUNDS + 1) * chunks,
          f"the router launched kernel 1's multi mode {modes['multi f32']} times, fewer "
          f"than one a chunk ({tci.HIER_ROUNDS + 1} x {chunks})")
    check(modes["single f32"] == 0 and modes["single int8"] == 0,
          "the hierarchical build launched kernel 1's single mode")
    # kernel 4 scans the meta-centroids of every router chunk (and once
    # the ground truth, above)
    check(build["flat_topk"] >= (tci.HIER_ROUNDS + 1) * chunks + 1,
          f"the router launched kernel 4 {build['flat_topk'] - 1} times, fewer than one "
          f"a chunk ({tci.HIER_ROUNDS + 1} x {chunks})")
    got = ci.members[ci.members >= 0]
    check(len(got) == HIER_N and len(np.unique(got)) == HIER_N,
          "phase 12: the membership is not a partition of the points")
    check(bool((ci.members >= 0).any(axis=1).all()), "phase 12: the index holds an empty cluster")
    log(f"{ci.C} clusters, none empty; the smallest holds "
        f"{int((ci.members >= 0).sum(axis=1).min())} points")
    rows = [(p, 0, 0.0, "argmin") for p in HIER_PROBES] + [(*HIER_ADAPTIVE, "argmin"),
                                                          (8, 0, 0.0, "stream")]
    recall = {}
    for n_probe, min_probe, cut, mode in rows:
        ids, dists, (nv, cm), dt = ci.search_timed(
            Q, k=K, n_probe=n_probe, min_probe=min_probe, cut=cut, seed_mode=mode,
            seed_probes=HIER_SEED_PROBES, rounds=3)
        r = compute_recall(ids.cpu().numpy(), *gt, K)
        recall[(n_probe, cut, mode)] = r
        seed = "meta seed" if mode == "argmin" else "streamed exact seed"
        # a query short of K ids ends in -1 (INF). The build drops empty
        # clusters (no zero centroid can capture a seed), so at cut 0 a
        # query expands n_probe clusters with members, about 32 points
        # each here, and a short one is a fault; the adaptive row may stop
        # after min_probe clusters that hold fewer than K points
        short = ids < 0
        check(ids.shape == (HIER_NQ, K) and bool((ids < HIER_N).all())
              and bool((dists[short] >= INF).all())
              and bool((short[:, :-1] <= short[:, 1:]).all()),
              f"phase 12 n_probe={n_probe} {seed}: malformed ids")
        n_short = int(short.any(1).sum())
        check(cut > 0 or n_short == 0, f"phase 12 n_probe={n_probe} {seed}: {n_short} "
              f"queries with fewer than {K} results at cut 0")
        check(_no_duplicates(ids), f"phase 12 n_probe={n_probe}: duplicate ids")
        check(bool(torch.isfinite(dists).all()), f"phase 12 n_probe={n_probe}: distances")
        check(bool((nv <= n_probe).all()), f"phase 12 n_probe={n_probe}: nv > n_probe")
        log(f"10M cluster search n_probe={n_probe} min_probe={min_probe} cut={cut} {seed} "
            f"(seed_probes {HIER_SEED_PROBES}): recall@{K} {r:.4f}  QPS {HIER_NQ / dt:.1f}  "
            f"({dt * 1e3:.3f} ms; nv {float(nv.float().mean()):.3f} "
            f"cmps {float(cm.float().mean()):.1f}; {n_short} queries with fewer than {K} "
            f"results)")
    launches = _launch_counts()
    log("launches during phase 12:", {k: v for k, v in launches.items() if v})
    check(launches["cluster_walk"] > 0, "cluster_walk was not launched by phase 12")
    check(launches["expand_distances_multi"] > build["expand_distances_multi"],
          "expand_distances_multi (int8 rows) was not launched by the meta-seeded search")
    check(launches["flat_topk"] > build["flat_topk"],
          "flat_topk was not launched by the meta-seeded search")
    check(launches["expand_distances"] == 0 and launches["expand_distances (f32 rows)"] == 0,
          "phase 12 launched kernel 1's single mode")
    r8 = recall[(8, 0.0, "argmin")]
    check(r8 >= HIER_BAR, f"phase 12: recall@{K} at n_probe 8 with the meta seed is "
          f"{r8:.4f} < {HIER_BAR}")
    return ci, X, Q, launches, dict(seconds=secs, **split)


# the group of kernels a multi-mode call launches besides its scoring kernel
MULTI_GROUPING = ("multi_count", "multi_partials", "multi_scan", "multi_scatter", "Memset")


def kernel_multi(name, blocks, mcents, q, E):
    """Kernel 1's multi-probe mode at a meta-routed top-k's shape: the B
    queries ``q`` against the blocks of their top-E meta-cells (the flat
    scan of ``mcents``, as ``meta_topk`` selects them) -> the JSON entry.
    The launch must equal its plain version and the E single-mode launches
    stacked (the earlier design, timed beside it). Bound: the distinct
    blocks read once, the queries, the ids and the output, against the B E
    R8 distances' operations (``expand_ops``: the f32 rate on f32 blocks,
    the int8 rate on the seed's int8 blocks and q8 queries). One more launch under torch.profiler
    splits the grouping kernels from the scoring kernel."""
    from parlayann_tpu_torch.ops.kernels.expand import (
        expand_distances, expand_distances_multi, expand_distances_multi_plain)
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
    from parlayann_tpu_torch.types import Metric

    Cm, cap, d = blocks.shape
    B = q.shape[0]
    mt_i, _ = flat_topk(q, mcents, k=E, metric=Metric.L2, n_valid=Cm)
    ids = mt_i.clamp(0, Cm - 1).to(torch.int32).contiguous()
    cols = [ids[:, e].contiguous() for e in range(E)]
    got = expand_distances_multi(blocks, ids, q, metric=Metric.L2)
    check(torch.equal(got, expand_distances_multi_plain(blocks, ids, q, metric=Metric.L2)),
          f"expand_distances_multi on the {name} blocks: not equal to its plain version")
    check(torch.equal(got, torch.stack([expand_distances(blocks, c, q, metric=Metric.L2)
                                        for c in cols], dim=1)),
          f"expand_distances_multi on the {name} blocks: not equal to {E} single launches")
    ms = time_ms(lambda: expand_distances_multi(blocks, ids, q, metric=Metric.L2), 20)
    single_ms = time_ms(lambda: [expand_distances(blocks, c, q, metric=Metric.L2)
                                 for c in cols], 10)
    plain_ms = time_ms(lambda: expand_distances_multi_plain(blocks, ids, q, metric=Metric.L2), 2)
    n_blk = unique_rows(ids, Cm)
    b = bound(n_blk * cap * d * blocks.element_size() + B * d * 4 + B * E * 4 + B * E * cap * 4,
              *expand_ops(blocks, q, B * E * cap))
    prof = profile_window(lambda: expand_distances_multi(blocks, ids, q, metric=Metric.L2),
                          f"kernel 1 multi on the {name} blocks")
    group_ms = score_ms = None
    if prof is not None:
        by = prof["by_name"]
        group_ms = sum(us for k, us in by.items() if any(g in k for g in MULTI_GROUPING)) / 1e3
        score_ms = sum(us for k, us in by.items() if "expand_multi_kernel" in k) / 1e3
    log(f"kernel 1 expand_distances_multi {blocks.dtype} {name} blocks {tuple(blocks.shape)} "
        f"B={B} x E={E} (top-{E} meta cells): equal to its plain version and to {E} "
        f"single launches (L2); {ms:.4f} ms vs {E} single launches {single_ms:.4f} ms "
        f"[the earlier design] vs plain {plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}; {n_blk} distinct blocks); profiled: grouping {group_ms} ms, "
        f"scoring {score_ms} ms")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
                single_launches_ms=single_ms, grouping_ms=group_ms, scoring_ms=score_ms,
                distinct_blocks=n_blk, **b)


def kernel_meta_scan(name, mcents, q, P):
    """Kernel 4 as ``meta_topk``'s scan: the B queries ``q`` against the
    (Cm, d) meta-centroids ``mcents``, top-``P`` under L2 -> the JSON entry,
    checked against the plain path (``flat_topk_plain``, the scan
    ``meta_topk`` ran before kernel 4) by ``check_topk`` and timed beside
    it. Bound: the centroids, their bias and the queries read once and the
    (B, P) lists written, against 3 TF32 passes of 2 B Cm d."""
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk, flat_topk_plain, splits
    from parlayann_tpu_torch.types import Metric

    Cm, d = mcents.shape
    q = q.contiguous()
    B = q.shape[0]
    kw = dict(k=P, metric=Metric.L2, n_valid=Cm)
    got = flat_topk(q, mcents, **kw)
    want = flat_topk_plain(q, mcents, **kw)
    scale = (q * q).sum(1) + (mcents * mcents).sum(1).max()
    rel, n_tie = check_topk(got, want, scale, f"flat_topk over the {name} meta-centroids")
    ms = time_ms(lambda: flat_topk(q, mcents, **kw), 20)
    plain_ms = time_ms(lambda: flat_topk_plain(q, mcents, **kw), 3)
    b = bound(Cm * d * 4 + Cm * 4 + B * d * 4 + B * P * 8, 3 * 2 * B * Cm * d, TF32_OPS)
    S, per = splits(B, Cm, P, False, q.device)
    log(f"kernel 4 flat_topk over the {name} meta-centroids ({Cm}, {d}) B={B} k={P}: max "
        f"rel err {rel:.3g}, {n_tie} rows with tie swaps; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}); S={S} splits "
        f"of {per} points")
    return dict(max_rel_err=rel, tie_rows=n_tie, ms=ms, plain_ms=plain_ms, splits=S,
                **b)


def router_chunk(router, X, k):
    """One chunk of the build's router (``approx_assign``: the first 16,384
    points, top-``HIER_P`` cells, k candidates), fenced, split into the
    meta-centroid scan and select (kernel 4), kernel 1's multi launch, the
    mask and the ``idtab`` gather, and ``smallest_k`` (CUDA events;
    ``meta_topk``'s steps, checked equal to it) -> {part: ms}."""
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops.distance import INF
    from parlayann_tpu_torch.ops.kernels.clusterbeam import meta_topk
    from parlayann_tpu_torch.ops.kernels.expand import expand_distances_multi
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk
    from parlayann_tpu_torch.ops.topk import smallest_k
    from parlayann_tpu_torch.types import Metric

    mcents, blocks, idtab = router
    Cm, cap = blocks.shape[:2]
    P = tci.HIER_P
    q = X[:tci._kmeans_chunk_for(Cm)].float().contiguous()
    B = q.shape[0]
    for _ in range(2):  # a warm-up, then the measured chunk
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        mt_i, _ = flat_topk(q, mcents, k=P, metric=Metric.L2, n_valid=Cm)
        ev[1].record()
        mi = mt_i.clamp(0, Cm - 1).to(torch.int32)
        dp = expand_distances_multi(blocks, mi, q, metric=Metric.L2)
        ev[2].record()
        ip = idtab[mi.long()]
        dp = torch.where((ip >= 0) & (mt_i >= 0)[:, :, None], dp, INF)
        ev[3].record()
        d, i = smallest_k(dp.reshape(B, P * cap), ip.reshape(B, P * cap), k)
        ev[4].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    want_i, want_d = meta_topk(q, mcents, blocks, idtab, k=k, P=P, metric=Metric.L2)
    check(torch.equal(i, want_i) and torch.equal(d, want_d),
          "the split router chunk differs from meta_topk")
    parts = dict(zip(("scan_select", "kernel1", "mask_gather", "smallest_k"),
                     (ev[j].elapsed_time(ev[j + 1]) for j in range(4))))
    log(f"router chunk (B={B}, P={P}, k={k}, {Cm} cells of {cap}): {wall:.3f} ms fenced = "
        + ", ".join(f"{n} {v:.3f} ms" for n, v in parts.items()))
    return dict(wall_ms=wall, **parts)


def kernel_hier(ci, X, Q, dev):
    """Kernel 1 on the hierarchical build's blocks and kernel 5 over the 10M
    ext, each against its plain version -> {"router": f32 entry, "seed":
    int8 entry, "router_multi", "seed_multi": the multi-probe mode's
    entries, "chunk": the router chunk's split, "router_scan",
    "seed_scan": kernel 4 over the meta-centroids, "walk": kernel 5 entry}.
    The router's blocks are the build's adjacency quantizer rebuilt over the
    final centroids, queried by the first 8,192 points (half a chunk of
    ``approx_assign``), each at its nearest cell, then in the multi mode by
    the first 16,384 (one chunk) at their top-``HIER_P`` cells; the seed's
    blocks are the index's, queried by the q8 queries at their nearest
    cell, then at their top-``HIER_SEED_PROBES``. Bound: the distinct
    blocks read once, the queries and the output, against ``expand_ops``."""
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.clusterbeam import (
        cluster_walk, cluster_walk_plain, seed_centroids)
    from parlayann_tpu_torch.ops.kernels.expand import expand_distances, expand_distances_plain
    from parlayann_tpu_torch.search.flat import flat_search_batch
    from parlayann_tpu_torch.types import Metric

    t0 = time.perf_counter()
    cents = tci._recenter(X, ci.members, ci.C)
    router = tci._meta_quantizer(cents, ci.C, Metric.L2, meta_m=tci.META_M, seed=101)
    torch.cuda.synchronize()
    log(f"the router's quantizer over the final centroids: {time.perf_counter() - t0:.2f} s")
    q8 = quantize.translate_query(Q, ci.qpoints).float()
    out = {}
    for name, (mc, blocks, _), q in (("router", router, X[:8192].contiguous()),
                                     ("seed", ci.seed_meta, q8)):
        ids, _ = flat_search_batch(q, mc, k=1, metric=Metric.L2, n_valid=mc.shape[0],
                                   chunk=min(mc.shape[0], 32768))
        ids = ids[:, 0].contiguous()
        got = expand_distances(blocks, ids, q, metric=Metric.L2)
        want = expand_distances_plain(blocks, ids, q, metric=Metric.L2)
        check(torch.equal(got, want), f"expand_distances on the {name} blocks: not equal")
        check(torch.equal(got[:256], expand_distances_plain(blocks, ids[:256], q[:256],
                                                            metric=Metric.L2)),
              f"expand_distances on the {name} blocks: the first 256 queries not equal")
        ms = time_ms(lambda: expand_distances(blocks, ids, q, metric=Metric.L2), 20)
        plain_ms = time_ms(lambda: expand_distances_plain(blocks, ids, q, metric=Metric.L2), 3)
        Cm, cap, d = blocks.shape
        B = q.shape[0]
        b = bound(unique_rows(ids, Cm) * cap * d * blocks.element_size() + B * d * 4 + B * 4
                  + B * cap * 4, *expand_ops(blocks, q, B * cap))
        log(f"kernel 1 expand_distances {blocks.dtype} {name} blocks {tuple(blocks.shape)} "
            f"B={B}: equal (L2); {ms:.4f} ms vs plain {plain_ms:.4f} ms; bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {unique_rows(ids, Cm)} distinct blocks)")
        out[name] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None, **b)
    out["router_multi"] = kernel_multi("router", router[1], router[0],
                                       X[:tci._kmeans_chunk_for(router[1].shape[0])].contiguous(),
                                       tci.HIER_P)
    out["seed_multi"] = kernel_multi("seed", ci.seed_meta[1], ci.seed_meta[0], q8.contiguous(),
                                     HIER_SEED_PROBES)
    out["chunk"] = router_chunk(router, X, HIER_BUILD["cand"])
    out["router_scan"] = kernel_meta_scan(
        "router", router[0], X[:tci._kmeans_chunk_for(router[1].shape[0])], tci.HIER_P)
    out["seed_scan"] = kernel_meta_scan("seed", ci.seed_meta[0], q8, HIER_SEED_PROBES)
    sd, sid = seed_centroids(q8, ci.centroids_q, C=ci.C, S=2, metric=Metric.L2,
                             meta=ci.seed_meta, seed_probes=HIER_SEED_PROBES)
    args = (q8.contiguous(), ci.ext, sd.contiguous(), sid.contiguous())
    kw = dict(metric=Metric.L2, C=ci.C, m=ci.m, Rc=ci.Rc, n_points=ci.points.n, n_probe=8)
    expanded = []
    got = cluster_walk(*args, **kw)
    want = cluster_walk_plain(*args, **kw, expanded=expanded)
    err = check_walk(got, want, "cluster_walk int8 over the 10M ext at n_probe 8")
    b, n_dist, n_rows, n_vis = walk_bound(ci, args, expanded)
    ms = time_ms(lambda: cluster_walk(*args, **kw), 10)
    plain_ms = time_ms(lambda: cluster_walk_plain(*args, **kw), 2)
    log(f"kernel 5 cluster_walk int8 over the 10M ext (C={ci.C}) B={HIER_NQ} n_probe 8, "
        f"meta seeds: pool dists, pool ids and nv equal; {ms:.4f} ms vs plain "
        f"{plain_ms:.4f} ms; bound {b['bound_ms']:.4f} ms ({b['bound_by']}; {n_vis} probes "
        f"of {n_rows} rows, {n_dist} distances)")
    out["walk"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None, **b)
    return out


# phase 13: the multi-device modes at world size 1 on NCCL
PAR_N = 1_000_000  # phase 6's set
PAR_PASSES = 2
PAR_BUILD = dict(R=32, L=64, alpha=1.2, num_passes=PAR_PASSES, batch_cap_frac=0.04)
PAR_CLUSTER = dict(m=64, Rc=16, slack=1.5, iters=6, cand=8)
# beams of the replica and global searches; both start every query at
# point 0, as the JAX package's do, and on this set reach recall@10 0.8940
# at beam 64 and 0.9704 at 128 (the phase prints the single-card f32
# build's recall at 64 beside them), so RECALL_BAR is held at beam 128
PAR_BEAMS = (10, 16, 32, 64, 128)
PAR_BAR_BEAM = 128
PAR_PROBES = (4, 8, 16)  # cut 0
PAR_GAP = 0.03  # cluster-sharded against single-card recall@10 at n_probe 8
PAR_CHECK = 256  # queries searched on the card and on the CPU


def _same_search(card, host, what):
    """One search's results on the card and on the CPU (numpy ids and
    distances of the same queries): distances within rtol 1e-5, so ids
    differ only where two points lie at one distance (a tie)."""
    (ids, d), (hids, hd) = card, host
    check(np.array_equal(ids < 0, hids < 0), f"{what}: empty slots differ")
    ok = hids >= 0
    check(bool(np.allclose(d[ok], hd[ok], rtol=1e-5, atol=0)),
          f"{what}: distances differ between the card and the CPU")
    log(f"{what}: the card's {len(ids)} rows equal the CPU's ({int((ids != hids).sum())} "
        f"ids differ, all at tied distances)")


def _check_ids(ids, n, what):
    ids = torch.as_tensor(ids)
    check(ids.shape[1] == K and bool((ids >= 0).all()) and bool((ids < n).all()),
          f"{what}: malformed ids")
    check(_no_duplicates(ids), f"{what}: duplicate ids")


def parallel_run(dev):
    """Phase 13: the multi-device modes at world size 1 on NCCL over phase
    6's 1M set -> {mode: {kernel: launches}}: the replica and global
    builds (kernel 2's f32 mode) and their searches, the cluster-sharded
    build and search against a single-card ClusterIndex, and each mode's
    search of ``PAR_CHECK`` queries on the card held to the same search on
    the CPU through a gloo sub-group."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.parallel.cluster_sharded import build_sharded_cluster
    from parlayann_tpu_torch.parallel.global_build import build_global_vamana, global_search
    from parlayann_tpu_torch.parallel.mesh import make_mesh, make_mesh_1d
    from parlayann_tpu_torch.parallel.sharded import build_sharded_vamana, sharded_search
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.types import BuildParams
    from parlayann_tpu_torch.utils import synthetic

    t0 = time.perf_counter()
    X, Q = synthetic.clustered(PAR_N, 128, n_queries=10_000, n_clusters=10_000,
                               cluster_std=0.35, seed=SEED)
    points = pt.PointSet.from_numpy(X, device=dev)
    gt_ids, gt_d = exact.compute_groundtruth(points, Q, 2 * K)
    log(f"data: synthetic clustered {X.shape}, {len(Q)} queries, 10000 clusters; exact "
        f"top-{2 * K} on the card ({time.perf_counter() - t0:.2f} s)")
    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{os.path.join(store, 'store')}",
                            rank=0, world_size=1, device_id=dev)
    out = {}
    try:
        v = torch.cuda.nccl.version()
        log(f"process group: NCCL {'.'.join(map(str, v)) if isinstance(v, tuple) else v}, "
            f"world size {dist.get_world_size()}: one process on one card, every collective a "
            f"real NCCL call over a group of one; no cross-card traffic is measured")
        log("card:", card_line())
        meshes = {"replica": (make_mesh(device=dev), make_mesh(device="cpu")),
                  "global": (make_mesh_1d(device=dev), make_mesh_1d(device="cpu"))}
        log("meshes:", {k: (m.backend, str(m.device), c.backend)
                        for k, (m, c) in meshes.items()})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bp = BuildParams(**PAR_BUILD)
        qc = Q[:PAR_CHECK]
        modes = (("replica", build_sharded_vamana, sharded_search),
                 ("global", build_global_vamana, global_search))
        for name, build, search in modes:
            mesh, cpu = meshes[name]
            _zero_launches()
            t0 = time.perf_counter()
            idx = build(X, mesh, bp)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            out[name] = _launch_counts()
            degs = idx.degs[:PAR_N].float()
            log(f"{name} build: {secs:.3f} s fenced (f32 points, R=32 L=64 alpha=1.2, "
                f"{PAR_PASSES} passes, batch_cap_frac=0.04); degree avg {float(degs.mean()):.3f} "
                f"max {int(degs.max())}; launches {out[name]}")
            check(out[name]["occlusion_rounds (f32 rows)"] > 0,
                  f"kernel 2's f32 mode was not launched by the {name} build")
            rec = {}
            for beam in PAR_BEAMS:
                t0 = time.perf_counter()
                ids, dists = search(idx, Q, k=K, beam_size=beam)
                dt = time.perf_counter() - t0
                _check_ids(ids, PAR_N, f"{name} beam {beam}")
                check(bool(np.isfinite(dists).all()), f"{name} beam {beam}: distances not finite")
                rec[beam] = compute_recall(ids, gt_ids, gt_d, K)
                log(f"{name} search beam={beam}: recall@{K} {rec[beam]:.4f}  QPS {len(Q) / dt:.1f}"
                    f"  ({dt * 1e3:.3f} ms for {len(Q)} queries, host copies included)")
            check(rec[PAR_BAR_BEAM] >= RECALL_BAR, f"{name}: recall@{K} at beam "
                  f"{PAR_BAR_BEAM} is {rec[PAR_BAR_BEAM]:.4f} < {RECALL_BAR}")
            if name == "replica":  # one shard: the whole graph, seeded by an entry tier
                graph = pt.GraphIndexData(neighbors=idx.nbrs, degrees=idx.degs, n=PAR_N,
                                          max_degree=bp.R)
                ids, _, _ = pt.Index(points=points, graph=graph).batch_search(
                    Q, k=K, beam_size=64)
                log(f"the replica graph through the single-card Index (entry top-1 of a "
                    f"sample, f32 search) at beam 64: recall@{K} "
                    f"{compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K):.4f}")
                # the single-card f32 build on the same data and parameters:
                # what the set allows at beam 64 without the modes' start
                t0 = time.perf_counter()
                g1, p1, _ = pt.build_vamana_index(
                    X, R=bp.R, L=bp.L, alpha=bp.alpha, quantize_build=False, device=dev,
                    batch_cap_frac=bp.batch_cap_frac)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                one = pt.Index(points=p1, graph=g1)
                r1 = [compute_recall(one.batch_search(Q, k=K, beam_size=64, starts=s)[0]
                                     .cpu().numpy(), gt_ids, gt_d, K)
                      for s in (None, np.zeros(len(Q), np.int32))]
                log(f"single-card f32 build on the same data: {secs:.3f} s fenced; recall@{K} "
                    f"at beam 64 {r1[0]:.4f} from its entry tier, {r1[1]:.4f} from point 0")
                del g1, p1, one
            _same_search(search(idx, qc, k=K, beam_size=64),
                         search(idx.to(cpu), qc, k=K, beam_size=64),
                         f"{name} search at beam 64")
            del idx

        mesh, cpu = meshes["replica"]
        _zero_launches()
        t0 = time.perf_counter()
        sci = build_sharded_cluster(X, mesh, **PAR_CLUSTER)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        log(f"cluster-sharded build: {secs:.3f} s fenced (m=64 Rc=16 slack 1.5, iters 6, "
            f"cand 8; C={sci.C}, int8 payload {sci.mvecs.numel() / 1e6:.1f} MB)")
        rec = {}
        for n_probe in PAR_PROBES:
            t0 = time.perf_counter()
            ids, dists, nv = sci.search(Q, k=K, n_probe=n_probe, cut=0.0)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            _check_ids(ids, PAR_N, f"cluster-sharded n_probe {n_probe}")
            rec[n_probe] = compute_recall(ids.cpu().numpy(), gt_ids, gt_d, K)
            log(f"cluster-sharded search n_probe={n_probe}: recall@{K} {rec[n_probe]:.4f}  "
                f"QPS {len(Q) / dt:.1f}  ({dt * 1e3:.3f} ms; probes {float(nv.float().mean()):.2f})")
        out["cluster"] = _launch_counts()
        t0 = time.perf_counter()
        ci = pt.build_cluster_index(X, ext_dtype="int8", device=dev, **PAR_CLUSTER)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        ids1, _, _ = ci.search(torch.from_numpy(Q).to(dev), k=K, n_probe=8, cut=0.0)
        rec1 = compute_recall(ids1.cpu().numpy(), gt_ids, gt_d, K)
        log(f"single-card ClusterIndex on the same data (int8 ext): build {secs:.3f} s, "
            f"recall@{K} at n_probe 8 {rec1:.4f}; cluster-sharded {rec[8]:.4f}")
        check(abs(rec[8] - rec1) <= PAR_GAP, f"cluster-sharded recall@{K} at n_probe 8 "
              f"{rec[8]:.4f} is not within {PAR_GAP} of the single card's {rec1:.4f}")
        card = sci.search(qc, k=K, n_probe=8, cut=0.0)
        host = sci.to(cpu).search(qc, k=K, n_probe=8, cut=0.0)
        _same_search((card[0].cpu().numpy(), card[1].cpu().numpy()),
                     (host[0].numpy(), host[1].numpy()), "cluster-sharded search at n_probe 8")
        del sci, ci
        log(f"peak device memory in phase 13: "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(SEED)

    phase("phase 1: environment and build")
    phase_environment()
    X, Q = make_data()
    phase("phase 2: kernels against their plain versions")
    k1 = kernel_expand(gen, dev)
    k2 = kernel_occlude(gen, dev)
    k1f = kernel_expand_f32(dev)
    k2f = kernel_occlude(gen, dev, f32=True)
    k1h = kernel_expand_hnsw(gen, dev)
    k1i = kernel_expand_i16(dev)
    kb = bitonic_check(gen, dev)
    k4 = kernel_flat(X, Q, gen, dev)
    ke = kernel_entry(X, Q, dev)
    phase("phase 3: the slice (q8 Vamana build + q8 fused search)")
    idx, launches, gt, build_s = slice_run(X, Q, dev)
    phase("phase 3 (continued): the 100K build once more under torch.profiler")
    profiled_build(X, dev)
    phase("phase 2 (continued): kernel 3 on the built graph, and its build mode")
    walk_table()
    k3s = kernel_fusedbeam(idx, Q, dev)
    k3 = dict(max_abs_err=0.0, library_ms=None, **k3s[(1024, 64)],
              shapes={f"B{B}_L{L}": dict(ms=v["ms"], bound_ms=v["bound_ms"])
                      for (B, L), v in k3s.items()})
    k3b = kernel_build_fused(idx, dev)
    phase("phase 3b: the fused read phase (fused_read=True) beside the lock-step read at 100K")
    p3b, k3b["shapes"] = fused_read_run(X, Q, gt, idx, build_s, dev)
    phase("phase 4: the ClusterIndex slice (build + cluster-beam search)")
    indexes, launches["cluster_walk"] = cluster_run(X, Q, gt, dev)
    phase("phase 2 (continued): kernel 5 on the built indexes")
    k5 = kernel_cluster(indexes, Q, dev)
    phase("phase 5: the FlatIndex slice")
    launches["flat_topk"] = flat_run(X, Q, gt, dev)
    del indexes
    phase("phase 7: the f32 tier at 100K (f32 build, f32 and q8 lock-step search)")
    launches.update(f32_run(X, Q, gt, idx, dev))
    p3 = (idx.points, idx.graph)  # phase 11's 100K graph
    del idx
    phase("phase 8: HNSW at 100K (f32 and q8 builds, layered search)")
    hnsw_builds, hnsw_launches, _ = hnsw_run(X, Q, gt, dev)
    phase("phase 8 (continued): build A and a search under torch.profiler")
    hnsw_profile(X, Q, dev)
    phase("phase 2 (continued): kernel 4's masked mode on HNSW's level 1, kernel 3 on level 0")
    k4m = {name: masked_case(c) for name, c in hnsw_level1_cases(hnsw_builds, X, dev).items()}
    k3h = kernel_fusedbeam(hnsw_builds["A"]._base_index(), Q, dev, shapes=HNSW_FUSED,
                           plain_at=HNSW_FUSED[0], what="HNSW A's level 0")
    del hnsw_builds
    phase("phase 9: HCNNG and pyNNDescent at 100K (cluster trees, Kruskal, random starts)")
    t9 = time.perf_counter()
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.ops.kernels.fusedbeam import beam_search_fused
    for w in (occlusion_rounds, beam_search_fused):
        w.launches = 0
    occlusion_rounds.launches_f32 = 0
    torch.cuda.synchronize()
    hcnng_idx, _ = hcnng_run(X, Q, gt, dev)
    pynn_idx, pynn_q = pynn_run(dev)
    torch.cuda.synchronize()
    p9 = {"occlusion_rounds": occlusion_rounds.launches - occlusion_rounds.launches_f32,
          "occlusion_rounds (f32 rows)": occlusion_rounds.launches_f32,
          "beam_search_fused": beam_search_fused.launches}
    log("launches during phase 9:", p9)
    for name, n in p9.items():
        check(n > 0, f"{name} was not launched by phase 9")
    phase("phase 2 (continued): kernel 3 on the HCNNG graph and with random starts")
    k3c = kernel_fusedbeam(hcnng_idx, Q, dev, shapes=HCNNG_FUSED, plain_at=(1024, 64),
                           what="the HCNNG graph")
    k3r = kernel_fusedbeam_random(pynn_idx["A"], pynn_q, dev, *PYNN_FUSED)
    del hcnng_idx, pynn_idx
    log(f"phase 9 took {time.perf_counter() - t9:.1f} s")
    phase("phase 10a: the tutorial's k-NN flow through the tools and the CLI")
    p10 = tutorial_run(X, Q, dev)
    phase("phase 10b: an SSNPP-shaped range run at 1M x 256 uint8")
    for name, n in range_run(dev).items():
        p10[name] += n
    phase("phase 6: the capacity tiers at 1M (q8 build, 1-bit and JL search)")
    tier_launches, kept, p6_fused, k3b["shapes"]["1M_R32_L64_vmax64_B40000"] = tier_run(dev)
    launches["expand_bits_flat"] = tier_launches["expand_bits_flat"]
    phase("phase 2 (continued): kernel 6 on the tiers' inline words")
    k6 = kernel_bits(kept, gen, dev)
    del kept
    phase("phase 11a: the 16-bit and 4-bit scalar tiers at 100K (kernel 1's int16 mode)")
    p11 = {"11a": tiers11_run(*p3, Q, gt, dev)}
    phase("phase 11b: exact-candidate (profiled) and single-batch Vamana builds at 100K")
    p11["11b"] = modes11_run(X, Q, gt, *p3, dev)
    phase("phase 2 (continued): kernel 4's masked mode at the exact build's shapes")
    k4m.update({name: masked_case(c, reps=10, plain_reps=2)
                for name, c in exact_build_cases(X, dev).items()})
    phase("phase 11c: MIPS at 1M (q8 build and sweep, 4-bit, 2-bit and trimmed tiers, filter)")
    p11["11c"] = mips11_run(dev)
    phase("phase 12: the hierarchical ClusterIndex at 10M x 128 (router, teleport, polish, meta seed)")
    ci12, X12, Q12, p12, b12 = hier_run(dev)
    phase("phase 2 (continued): kernel 1 on the 10M build's blocks, kernel 5 over its ext")
    k12 = kernel_hier(ci12, X12, Q12, dev)
    del ci12, X12, Q12
    phase("phase 13: the multi-device modes at world size 1 on NCCL (replica, global, cluster-sharded)")
    p13 = parallel_run(dev)

    # phase8_launches: each kernel's launches in phase 8 (HNSW); shapes:
    # its times at HNSW's shapes beside the main path's
    k1["shapes"] = {"hnsw_R8_40_int8_B32000": k1h["int8"],
                    "hier_seed_blocks_R8_24_int8_B10000": k12["seed"]}
    k1f["shapes"] = {"hnsw_R8_40_f32_B8000": k1h["f32"],
                     "hier_router_blocks_R8_112_f32_B8192": k12["router"]}
    k4["shapes"] = k4m
    k4["shapes"].update(hier_router_meta_scan=k12["router_scan"],
                        hier_seed_meta_scan=k12["seed_scan"])
    k3["shapes"].update({f"hnsw_R40_B{B}_L{L}": v for (B, L), v in k3h.items()})
    # kernel 5's times over phase 12's 10M ext
    k5["shapes"]["int8_10M_B10000_p8_meta_seed"] = k12["walk"]
    # phase9_launches: launches in phase 9 (HCNNG, pyNNDescent); kernel 3's
    # times on the HCNNG graph (R = 90) and with random starts
    k3["shapes"].update({f"hcnng_R90_B{B}_L{L}": dict(ms=v["ms"], bound_ms=v["bound_ms"])
                         for (B, L), v in k3c.items()})
    k3["shapes"][f"pynn_R40_random_starts_B{PYNN_FUSED[0]}_L{PYNN_FUSED[1]}"] = k3r
    h = hnsw_launches
    kernels = [
        dict(name="expand_distances", route="cuda",
             source="parlayann_tpu_torch/csrc/expand.cu",
             replaces="parlayann_tpu/ops/pallas/expand.py:129",
             launches=launches["expand_distances"],
             phase8_launches=h["expand_distances"], **k1),
        dict(name="occlusion_rounds", route="cuda",
             source="parlayann_tpu_torch/csrc/occlude.cu",
             replaces="parlayann_tpu/ops/pallas/occlude.py:91",
             launches=launches["occlusion_rounds"],
             phase8_launches=h["occlusion_rounds"],
             phase9_launches=p9["occlusion_rounds"], **k2),
        # the f32 modes, launched by phase 7
        dict(name="expand_distances (f32 rows)", route="cuda",
             source="parlayann_tpu_torch/csrc/expand.cu",
             replaces="parlayann_tpu/ops/pallas/expand.py:129",
             launches=launches["expand_distances (f32 rows)"],
             phase8_launches=h["expand_distances (f32 rows)"], **k1f),
        # the multi-probe mode, launched by phase 12 only: f32 rows by the
        # hierarchical build's router (one launch a chunk), int8 rows by
        # the meta-routed query seed; timed at those shapes (phase 2), with
        # the router chunk's split and the build's beside the f32 entry
        dict(name="expand_distances_multi (f32 rows)", route="cuda",
             source="parlayann_tpu_torch/csrc/expand.cu",
             replaces="parlayann_tpu/ops/pallas/expand.py:381",
             launches=p12["expand_distances_multi (f32 rows)"],
             router_chunk=k12["chunk"], hier_build=b12, **k12["router_multi"]),
        dict(name="expand_distances_multi", route="cuda",
             source="parlayann_tpu_torch/csrc/expand.cu",
             replaces="parlayann_tpu/ops/pallas/expand.py:381",
             launches=p12["expand_distances_multi"], **k12["seed_multi"]),
        # the int16 mode, launched by phase 11a's 16-bit tier search
        dict(name="expand_distances (int16 rows)", route="cuda",
             source="parlayann_tpu_torch/csrc/expand.cu",
             replaces="parlayann_tpu/ops/pallas/expand.py:129",
             launches=p11["11a"]["expand_distances (int16 rows)"], **k1i),
        dict(name="occlusion_rounds (f32 rows)", route="cuda",
             source="parlayann_tpu_torch/csrc/occlude.cu",
             replaces="parlayann_tpu/ops/pallas/occlude.py:91",
             launches=launches["occlusion_rounds (f32 rows)"],
             phase8_launches=h["occlusion_rounds (f32 rows)"],
             phase9_launches=p9["occlusion_rounds (f32 rows)"], **k2f),
        dict(name="beam_search_fused", route="cuda",
             source="parlayann_tpu_torch/csrc/fusedbeam.cu",
             replaces="parlayann_tpu/ops/pallas/fusedbeam.py:627",
             launches=launches["beam_search_fused"],
             phase8_launches=h["beam_search_fused"],
             phase9_launches=p9["beam_search_fused"], **k3),
        # kernel 3's build mode: launched by phase 3b's fused_read=True build
        # at R = 32 (the main path; phase3b_launches: both configurations)
        # and by phase 6's 1M fused build; shapes: its times at phase 3b's
        # R = 64, L = 128 and at phase 6's 1M steady batch
        dict(name="build_beam_fused", route="cuda",
             source="parlayann_tpu_torch/csrc/fusedbeam.cu",
             replaces="parlayann_tpu/ops/pallas/fusedbeam.py:952",
             launches=p3b["R32_L64"]["fused"]["build_beam_fused"],
             phase3b_launches={c: r["fused"]["build_beam_fused"] for c, r in p3b.items()},
             phase6_launches=p6_fused["build_beam_fused"], **k3b),
        dict(name="flat_topk", route="cuda",
             source="parlayann_tpu_torch/csrc/flatscan.cu",
             replaces="parlayann_tpu/ops/pallas/flatscan.py:121",
             launches=launches["flat_topk"], phase8_launches=h["flat_topk"], **k4),
        dict(name="cluster_walk", route="cuda",
             source="parlayann_tpu_torch/csrc/clusterbeam.cu",
             replaces="parlayann_tpu/ops/pallas/clusterbeam.py:351",
             launches=launches["cluster_walk"], **k5),
        # no Pallas kernel: the XLA-fused dot and argmin of the JAX search
        dict(name="entry_top1", route="cuda", source="parlayann_tpu_torch/csrc/entry.cu",
             replaces="none (parlayann_tpu/index.py:39-55, XLA-fused)",
             launches=launches["entry_top1"], phase6_launches=tier_launches["entry_top1"],
             **ke),
        # also the bits=1 mode of expand_distances (expand.py:129)
        dict(name="expand_bits_flat", route="cuda",
             source="parlayann_tpu_torch/csrc/expandbits.cu",
             replaces="parlayann_tpu/ops/pallas/expand.py:301",
             launches=launches["expand_bits_flat"], **k6[4]),
        # device code that no walk runs any more (kernels 3 and 5 run the
        # warp networks of warp.cuh): timed on its test launch, off the path
        dict(name="bitonic_sort (test launch bitonic_sort_rows; on no path)",
             route="cuda", source="parlayann_tpu_torch/csrc/bitonic.cuh",
             replaces="parlayann_tpu/ops/pallas/bitonic.py:51", launches=0, **kb),
    ]
    # phase10_launches: launches in phase 10 (the CLI's tutorial flow and the
    # SSNPP-shaped range run), on each kernel it launched
    for k in kernels:
        if p10.get(k["name"]):
            k["phase10_launches"] = p10[k["name"]]
    # phase11_launches: launches in phases 11a, 11b and 11c, on each kernel
    # one of them launched
    for k in kernels:
        counts = {sub: c[k["name"]] for sub, c in p11.items() if c.get(k["name"])}
        if counts:
            k["phase11_launches"] = counts
    # phase12_launches: launches in phase 12 (the 10M hierarchical
    # ClusterIndex), on each kernel it launched; kernel 5's times over the
    # 10M ext
    for k in kernels:
        if p12.get(k["name"]):
            k["phase12_launches"] = p12[k["name"]]
    # phase13_launches: launches in phase 13 (the multi-device modes), by
    # mode, on each kernel one of them launched
    for k in kernels:
        counts = {mode: c[k["name"]] for mode, c in p13.items() if c.get(k["name"])}
        if counts:
            k["phase13_launches"] = counts
    phase("done")
    log(card_line())
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
