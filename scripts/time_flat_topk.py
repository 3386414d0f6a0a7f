"""Time a kernel of a checkout of the PyTorch port on one card.

Usage, on a machine with an NVIDIA GPU and nvcc:

    python3 scripts/time_flat_topk.py [--kernel flat_topk|masked|occlusion|fusedbeam|
                                                fusedbuild|cluster|router|multi|meta]
                                      [--root DIR]
                                      [--reps N] [--tag NAME]
                                      [--f32] [--build N ...] [--build-reps K]
                                      [--f32-build]

Imports ``parlayann_tpu_torch`` from DIR (default: this repository), builds
its kernels, and times one of them with chip_smoke.py's timer (this
repository's, whatever DIR holds): device times from CUDA events over
back-to-back launches after a warm-up. Prints one JSON line with the card's
name and power limit. To compare versions on one card, run it on each
checkout in turns (A, B, B, A) in one call on one machine.

- ``--kernel flat_topk`` (kernel 4, the default): chip_smoke.py's phase-2
  shape, the synthetic clustered 100K x 128 set (seed 7) and its 10K
  queries, k=10, L2, on f32 points and on the q8 tier (int8 points,
  translated queries); then the same at k=100, the ground truth's usual k
  (keys ``*_k100_ms``), each first checked against the checkout's plain
  version (int8 bit-equal, f32 under phase 2's rule).
- ``--kernel masked`` (kernel 4's masked mode, ``valid_mask`` given):
  chip_smoke.py's masked cases, each checked against the checkout's plain
  version (int8 bit-equal, f32 under phase 2's rule) and timed beside its
  plain version and ``torch.addmm`` of its distance matrix: HNSW's level 1
  of phase 8's builds A (f32) and B (int8), B = 2,000 rows at k = 50 (the
  builds are the checkout's own); the exact-candidate build's (a) doubling
  batch of pass 1 (128 rows padded to 256), (b) steady batch of pass 1 and
  (c) steady batch of pass 2 (16,000 rows), int8 at k = 64, each against
  the prefix inserted before it. Then phase 2's unmasked shapes as
  ``flat_topk`` times them. Pass ``--index-cache FILE`` to every run of one
  call: the first saves the cases there and the others time the same ones.
  ``--profile-builds`` first builds phase 8's HNSW A and phase 11b's
  exact-candidate graph under torch.profiler (kernel 4's device ms and
  launches, busy time, idle share, the exact build's fenced beam split).
- ``--kernel occlusion`` (kernel 2): chip_smoke.py's six prune shapes,
  B=2048 rows of d=128 at (C, R) = (96, 32), (64, 32), (40, 32),
  (192, 64), (50, 20) and (80, 40), alpha 1.2, under L2 and under MIPS, each on rows
  of its own metric that chip_smoke.py makes from seed 7, so every
  checkout is timed on the same inputs; int8 vectors, or normal f32
  vectors with ``--f32``. Each shape's rounds are also checked against the
  checkout's plain version.
- ``--kernel fusedbeam`` (kernel 3): builds chip_smoke.py's q8 Vamana index
  of its synthetic clustered 100K x 128 set once (with the checkout's own
  build; the graph's digest is printed, so two checkouts can be seen to
  search the same graph), then times the q8 walk at chip_smoke.py's four
  shapes, B = 1024 and 10,000 queries x L = 10 and 64, and at B = 10,000,
  L = 128 (128 beam lanes), on the search's own
  inputs (translated queries, entry-tier starts). Each shape's four
  outputs are also checked equal to the checkout's plain version, and the
  mean and largest visits are printed. Then the checkout's q8
  ``Index.batch_search_timed`` of the 10K queries at chip_smoke.py's beams
  (10/16/32/64, three fenced rounds after a warm-up): recall@10 against
  exact ground truth, QPS, mean visits and distance counts.
- ``--kernel fusedbuild`` (kernel 3's build mode, ``build_beam_fused``):
  the graphs of chip_smoke.py's phases 3 and 3b (the 100K q8 Vamana builds
  at R=32 L=64 alpha 1.2 and R=64 L=128 alpha 1.15, batch_cap_frac 0.16),
  phase 9's HCNNG graph and phase 6's 1M q8 graph (1M x 128, 10K
  clusters, R=32 L=64, 0.04); then the build mode at a steady batch of
  each build, as chip_smoke.py's ``kernel_build_fused``: B = 16,000 of the
  100K q8 tier's rows at (R, L, vmax) = (32, 64, 64) and (64, 128, 128),
  and B = 40,000 of the 1M tier's rows at (32, 64, 64), each launch's four
  outputs checked equal to the checkout's plain version, with its time, a
  step's time (the total visits over it), the walk the launcher takes
  (with its registers and resident warps an SM: from the runtime where the
  checkout's wrapper has ``walk_info``, else from nvcc's -Xptxas -v
  report) and, where the checkout counts them, the share of step
  distances whose tier row the walk did not read again. Then kernel 3's
  search at chip_smoke.py's shapes (and B = 10,000, L = 128) on the R = 32
  graph, at B = 10,000 and L = 10, 64 and 128 on the R = 64 graph, and on
  the HCNNG graph (R = 90), outputs checked and timed. Pass
  ``--index-cache FILE`` to every run of one call: the first saves its
  graphs there and the others walk the same ones.
- ``--kernel cluster`` (kernel 5): builds chip_smoke.py's 100K ClusterIndex
  (m=64, Rc=16, slack 1.5) with the checkout's own build on the f32 and the
  int8 ext layout (a digest of each ext is printed, so two checkouts can be
  seen to walk the same index), then times the walk at B = 1024 and 10,000
  queries x n_probe 8, n_probe 16 and the adaptive (12, 2, 1.35) row on the
  search's own inputs (translated queries, top-2 centroid seeds); each
  shape's three outputs are checked equal to the checkout's plain version
  (a checkout whose f32 walk sums in another order than its plain version
  reports the first output that differs).
  Then the checkout's ``ClusterIndex.search_timed`` of the 10K queries at
  chip_smoke.py's settings (n_probe 3/4/6/8/12/16 at cut 0 and the adaptive
  row; three fenced rounds): recall@10 against exact ground truth, QPS,
  mean probes and distance counts; and one
  profiled f32 search at n_probe 8 and at the adaptive row (device busy
  time, idle share, kernel 5's device time and share). The card's k-means
  is not deterministic, so two checkouts are compared on one pair of
  indexes: ``--index-cache FILE`` saves the first run's indexes there and
  loads them in every later run.

- ``--kernel router`` (kernel 1 in the 10M build's router): draws
  chip_smoke.py's phase-12 set (10M x 128 on the card, ``hier_data``), takes
  312,500 of its points as centroids (phase 12's C), builds their meta
  quantizer (``_meta_quantizer``, 4,070 cells of 112) and times one router
  pass, ``approx_assign`` of all 10M points at P = 16, k = 8 (611 chunks of
  16,384), fenced, twice; kernel 1's launches by mode are printed (a
  checkout without the multi-probe mode launches the single mode 16 times
  a chunk).
- ``--kernel multi`` (kernel 1's multi-probe mode alone): the same set and
  centroids, and two shapes of phase 12: the router's (its meta quantizer,
  the first 16,384 points at their top-16 cells) and the query seed's
  (``_seed_quantizer`` over the centroids' q8 translation, (24,415, 24,
  128) int8 blocks, chip_smoke.py's 10,000 queries translated the same way
  at their top-16 cells). Each launch is checked equal to the checkout's
  plain version and timed; the checkout's CTA shape (consumer warps,
  stages) is whatever its ``launch_multi`` picks.
- ``--kernel meta`` (kernel 4 as the meta-centroid scan): the same two
  shapes, the router's 16,384 points over its (4,070, 128) meta-centroids
  and the seed's 10,000 q8 queries over its (24,415, 128), top-16: kernel 4
  checked against the plain path and timed beside it (chip_smoke.py's
  ``kernel_meta_scan``), then the checkout's ``meta_topk`` (the scan,
  kernel 1's multi mode and the select) at k = 8 and 2.

``--build N`` (100000 or 1000000, repeatable) also builds chip_smoke.py's
q8 Vamana index over its synthetic clustered N x 128 set (R=32, L=64,
alpha=1.2, two passes; batch_cap_frac 0.16 at 100K, 0.04 at 1M),
``--build-reps`` times on the host clock (fenced), then once more under
torch.profiler. It reports each timed build's seconds, the average
degree, the digests of the graphs (equal digests: equal graphs), and
kernel 2's and kernel 1's summed device ms and launches, the idle share
of the profiled build, and the caching allocator's device allocations
and frees during it (``cudaMalloc`` / ``cudaFree`` calls, which block the
host). ``--f32-build`` builds each size a second
time on the f32 points (``quantize_build=False``), timed and profiled the
same way (keys ``build{N}_f32_*``).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import inspect
import json
import re
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SEED = 7
OCCLUDE_B, OCCLUDE_D, ALPHA = 2048, 128, 1.2
BUILDS = {100_000: (1000, 0.16), 1_000_000: (10_000, 0.04)}  # n -> clusters, batch_cap_frac


def time_flat(chip, reps, dev):
    import torch
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.data.pointset import PointSet
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.ops.kernels.flatscan import flat_topk, flat_topk_plain
    from parlayann_tpu_torch.utils import synthetic

    X, Q = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=SEED)
    ps = PointSet.from_numpy(X, device=dev)
    q = torch.from_numpy(Q).to(dev)
    tier = quantize.quantize_pointset(ps, bits=8)
    q8 = quantize.translate_query(q, tier).float()
    out = {}
    for k, tag in ((10, ""), (100, "_k100")):
        kw = dict(k=k, metric=Metric.L2, n_valid=len(X))
        for name, qq, xx in (("f32", q, ps.data), ("int8", q8, tier.data)):
            if k != 10:  # phase 2 checks k = 10; the other k is checked here
                got, want = flat_topk(qq, xx, **kw), flat_topk_plain(qq, xx, **kw)
                what = f"flat_topk {name} k={k}"
                if name == "int8":
                    chip.check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                               f"{what}: not equal")
                else:
                    xf = xx.float()
                    chip.check_topk(got, want, (qq * qq).sum(1) + (xf * xf).sum(1).max(), what)
            out[f"{name}{tag}_ms"] = chip.time_ms(lambda: flat_topk(qq, xx, **kw), reps)
    return out


def masked_cases(chip, dev, cache=None):
    """The masked mode's cases (chip_smoke.py's ``hnsw_level1_cases`` over
    phase 8's builds A and B, with the checkout's own HNSW build, and
    ``exact_build_cases``), saved to ``cache`` or loaded from it."""
    import torch
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.utils import synthetic

    if cache and Path(cache).exists():
        cases = torch.load(cache, map_location=dev)
        for c in cases.values():
            c["metric"] = Metric[c["metric"]]
        return cases
    X, _ = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=SEED)
    builds = {name: chip.hnsw_build(X, name, dev)[0] for name in chip.HNSW_BUILDS}
    cases = chip.hnsw_level1_cases(builds, X, dev)
    del builds
    cases.update(chip.exact_build_cases(X, dev))
    if cache:
        Path(cache).parent.mkdir(parents=True, exist_ok=True)
        torch.save({name: dict(c, metric=c["metric"].name) for name, c in cases.items()},
                   cache)
    return cases


def profile_builds(chip, dev):
    """The checkout's HNSW build A and exact-candidate build under
    torch.profiler (chip_smoke.py's ``hnsw_profile`` and
    ``exact_kernel4_profile``): kernel 4's device ms and launches beside
    the build's busy time, idle share and (exact build) fenced beam split."""
    from parlayann_tpu_torch.utils import synthetic

    X, Q = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=SEED)
    out = {}
    for name, r in (("hnsw_A", chip.hnsw_profile(X, Q, dev)),
                    ("exact", chip.exact_kernel4_profile(X, dev))):
        out.update({f"{name}_{key}": v for key, v in r.items()})
    return out


def time_masked(chip, reps, dev, cache=None, profile=False):
    """Kernel 4's masked mode at HNSW's level-1 shapes and the exact
    build's three, each checked against the checkout's plain version
    (chip_smoke.py's ``masked_case``), then phase 2's unmasked shapes;
    with ``profile``, the builds around it (``profile_builds``)."""
    out = profile_builds(chip, dev) if profile else {}
    for name, case in masked_cases(chip, dev, cache).items():
        r = chip.masked_case(case, reps=reps, plain_reps=2)
        out.update({f"{name}_{key}": v for key, v in r.items()
                    if key in ("ms", "plain_ms", "library_ms", "bound_ms", "n_in")})
    out.update({f"unmasked_{key}": v for key, v in time_flat(chip, reps, dev).items()})
    return out


def time_occlusion(chip, reps, dev, f32=False):
    import torch
    from parlayann_tpu_torch.types import Metric
    from parlayann_tpu_torch.ops.kernels.occlude import (
        occlusion_rounds, occlusion_rounds_plain)

    gen = torch.Generator().manual_seed(SEED)
    out = {}
    for C, R in chip.OCCLUDE_SHAPES:
        for metric in (Metric.L2, Metric.MIPS):
            dist, vecs = chip._prune_rows(gen, dev, OCCLUDE_B, C, OCCLUDE_D,
                                          mips=metric is Metric.MIPS, f32=f32)
            kw = dict(R=R, metric=metric)
            key = f"C{C}_R{R}_{metric.name}" + ("_f32" if f32 else "")
            out[f"{key}_equal"] = bool(torch.equal(
                occlusion_rounds(dist, vecs, ALPHA, **kw),
                occlusion_rounds_plain(dist, vecs, ALPHA, **kw)))
            out[f"{key}_ms"] = chip.time_ms(
                lambda: occlusion_rounds(dist, vecs, ALPHA, **kw), reps)
    return out


def time_fused(chip, reps, dev):
    import torch
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.fusedbeam import (
        beam_search_fused, beam_search_fused_plain)
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.utils import synthetic

    X, Q = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=SEED)
    graph, points, _ = pt.build_vamana_index(X, R=32, L=64, alpha=1.2,
                                             batch_cap_frac=0.16, device=dev)
    idx = pt.Index(points=points, graph=graph).enable_quantized(bits=8)
    out = {"graph": hashlib.sha256(graph.neighbors.cpu().numpy().tobytes()
                                   + graph.degrees.cpu().numpy().tobytes()).hexdigest()[:16]}
    for B, L in chip.FUSED_SHAPES + ((10_000, 128),):
        args, kw = chip.fused_args(idx, Q[:B], L, dev)
        got = beam_search_fused(*args, **kw)
        want = beam_search_fused_plain(*args, **kw)
        key = f"B{B}_L{L}"
        out[f"{key}_equal"] = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
        out[f"{key}_visits_mean"] = float(got[2].float().mean())
        out[f"{key}_visits_max"] = int(got[2].max())
        out[f"{key}_ms"] = chip.time_ms(lambda: beam_search_fused(*args, **kw), reps)
    gt_ids, gt_d = exact.compute_groundtruth(points, Q, 2 * chip.K)
    for beam in chip.BEAMS:
        ids, _, res, dt = idx.batch_search_timed(Q, k=chip.K, beam_size=beam, rounds=3)
        out[f"search{beam}"] = dict(
            recall=compute_recall(ids.cpu().numpy(), gt_ids, gt_d, chip.K), qps=len(Q) / dt,
            visits=float(res.num_visited.float().mean()),
            cmps=float(res.dist_cmps.float().mean()))
    return out


def time_cluster(chip, reps, dev, cache=None):
    import torch
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels import clusterbeam
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.utils import synthetic

    X, Q = synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                               cluster_std=0.35, seed=SEED)
    # the card's k-means is not deterministic: checkouts compared in one call
    # share the first one's indexes through the cache
    if cache and Path(cache).exists():
        indexes = torch.load(cache, map_location=dev, weights_only=False)
    else:
        indexes = {}
        for ext_dtype in ("auto", "int8"):
            ci = pt.build_cluster_index(X, m=64, Rc=16, slack=1.5, ext_dtype=ext_dtype,
                                        device=dev)
            indexes[ci.ext_dtype] = ci
        if cache:
            torch.save(indexes, cache)
    settings = [(p, 0, 0.0) for p in chip.PROBES] + [chip.ADAPTIVE]
    out, gt = {}, None
    for lay, ci in indexes.items():
        out[f"{lay}_ext"] = hashlib.sha256(ci.ext.cpu().numpy().tobytes()).hexdigest()[:16]
        for B in chip.CLUSTER_B:
            args, base = chip.cluster_args(ci, Q[:B], dev)
            for n_probe, min_probe, cut in ((8, 0, 0.0), (16, 0, 0.0), chip.ADAPTIVE):
                kw = dict(base, n_probe=n_probe, min_probe=min_probe, cut=cut)
                key = f"{lay}_B{B}_p{n_probe}" + ("_adaptive" if cut else "")
                got = clusterbeam.cluster_walk(*args, **kw)
                want = clusterbeam.cluster_walk_plain(*args, **kw)
                try:
                    chip.check_walk(got, want, key)
                    out[f"{key}_equal"] = True
                except AssertionError as err:
                    out[f"{key}_equal"] = str(err)[:200]
                out[f"{key}_ms"] = chip.time_ms(
                    lambda: clusterbeam.cluster_walk(*args, **kw), reps)
        if gt is None:
            gt = exact.compute_groundtruth(ci.points, Q, 2 * chip.K)
        for n_probe, min_probe, cut in settings:
            ids, _, (nv, cm), dt = ci.search_timed(
                Q, k=chip.K, n_probe=n_probe, min_probe=min_probe, cut=cut, rounds=3)
            out[f"{lay}_search_p{n_probe}" + ("_adaptive" if cut else "")] = dict(
                recall=compute_recall(ids.cpu().numpy(), *gt, chip.K), qps=len(Q) / dt,
                nv=float(nv.float().mean()), cmps=float(cm.float().mean()))
        if lay == "f32":
            out["f32_profile"] = chip.cluster_profile(ci, Q, dev)
    return out


def build_run(chip, n, reps, dev, quantize_build=True):
    """Time the q8 (or f32) build of n points ``reps`` times, then profile
    it once."""
    import torch
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch.ops.kernels.expand import expand_distances
    from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
    from parlayann_tpu_torch.utils import synthetic

    n_clusters, frac = BUILDS[n]
    X, _ = synthetic.clustered(n, 128, n_clusters=n_clusters, cluster_std=0.35, seed=SEED)
    kw = dict(R=32, L=64, alpha=1.2, batch_cap_frac=frac, device=dev)
    if not quantize_build:
        kw["quantize_build"] = False
    seconds, digests = [], set()
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph, _, _ = pt.build_vamana_index(X, **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        digests.add(hashlib.sha256(graph.neighbors.cpu().numpy().tobytes()
                                   + graph.degrees.cpu().numpy().tobytes()).hexdigest()[:16])
    tag = f"build{n}" + ("" if quantize_build else "_f32")
    before = occlusion_rounds.launches, expand_distances.launches
    mem = torch.cuda.memory_stats()
    prof = chip.profile_window(lambda: pt.build_vamana_index(X, **kw), f"{tag}")
    mem_after = torch.cuda.memory_stats()
    if prof is None:
        sys.exit("time_flat_topk: the profiled build saw no device activity")

    def device_ms(part):
        return sum(us for name, us in prof["by_name"].items() if part in name) / 1e3

    return {f"{tag}_s": seconds, f"{tag}_avg_degree": graph.stats()[0],
            f"{tag}_graph": sorted(digests), f"{tag}_occlusion_ms": device_ms("occlusion"),
            f"{tag}_occlusion_launches": occlusion_rounds.launches - before[0],
            f"{tag}_expand_ms": device_ms("expand_"),
            f"{tag}_expand_launches": expand_distances.launches - before[1],
            f"{tag}_busy_ms": prof["busy_ms"], f"{tag}_idle_share": prof["idle"],
            **{f"{tag}_{k}": mem_after.get(k, 0) - mem.get(k, 0)
               for k in ("num_device_alloc", "num_device_free")}}


def router_inputs(chip, dev):
    """chip_smoke.py's phase-12 set and 312,500 of its points as centroids
    -> (points, queries, centroids) on the card."""
    import torch

    X, Q = chip.hier_data(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    return X, Q, X[torch.randperm(X.shape[0], generator=g, device=dev)[:312_500]].contiguous()


def time_router(chip, reps, dev):
    import torch
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops.kernels import expand
    from parlayann_tpu_torch.types import Metric

    X, _, cents = router_inputs(chip, dev)
    n, C = X.shape[0], cents.shape[0]
    quant = tci._meta_quantizer(cents, C, Metric.L2, meta_m=tci.META_M, seed=0)
    # the checkout's kernel 1 wrappers: the multi-probe mode where it has one
    wrappers = [w for w in (expand.expand_distances,
                            getattr(expand, "expand_distances_multi", None)) if w]
    secs = []
    for _ in range(reps):
        for w in wrappers:
            w.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tci.approx_assign(X, n, cents, C, 8, Metric.L2, P=tci.HIER_P, quantizer=quant)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return {"router_cells": list(quant[1].shape), "router_s": secs,
            **{f"{w.__name__}_launches": w.launches for w in wrappers}}


def meta_shapes(chip, dev):
    """The router's and the query seed's meta-routed top-k inputs of phase
    12 -> {"router" | "seed": ((mcents, blocks, idtab), queries, top-E)}."""
    import torch
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops import quantize
    from parlayann_tpu_torch.types import Metric

    X, Q, cents = router_inputs(chip, dev)
    C = cents.shape[0]
    slope, offset = quantize.euclidean_params(X, 8)
    router = tci._meta_quantizer(cents, C, Metric.L2, meta_m=tci.META_M, seed=0)
    seed = tci._seed_quantizer(quantize.euclidean_translate(cents, slope, offset).float(), C,
                               torch.int8)
    return {"router": (router, X[:tci._kmeans_chunk_for(router[1].shape[0])], tci.HIER_P),
            "seed": (seed, quantize.euclidean_translate(Q, slope, offset).float(),
                     chip.HIER_SEED_PROBES)}


def time_meta(chip, reps, dev):
    """Kernel 4 as the meta-centroid scan at both shapes (chip_smoke.py's
    ``kernel_meta_scan``: checked against the plain path, timed beside it),
    then the checkout's whole ``meta_topk`` at k = 8 (the router's
    candidates) and k = 2 (the seed's starts)."""
    from parlayann_tpu_torch.ops.kernels.clusterbeam import meta_topk
    from parlayann_tpu_torch.types import Metric

    out = {}
    for (name, ((mc, blocks, idtab), q, E)), k in zip(meta_shapes(chip, dev).items(), (8, 2)):
        out[f"{name}_scan"] = chip.kernel_meta_scan(name, mc, q, E)
        out[f"{name}_meta_topk_ms"] = chip.time_ms(
            lambda: meta_topk(q, mc, blocks, idtab, k=k, P=E, metric=Metric.L2), reps)
    return out


def time_multi(chip, reps, dev):
    import torch
    from parlayann_tpu_torch.ops.kernels import expand
    from parlayann_tpu_torch.search.flat import flat_search_batch
    from parlayann_tpu_torch.types import Metric

    out = {}
    for name, ((mc, blocks, _), q, E) in meta_shapes(chip, dev).items():
        Cm = blocks.shape[0]
        ids, _ = flat_search_batch(q, mc, k=E, metric=Metric.L2, n_valid=Cm,
                                   chunk=min(Cm, 32768), select="sort")
        ids = ids.clamp(0, Cm - 1).to(torch.int32).contiguous()
        q = q.contiguous()
        got = expand.expand_distances_multi(blocks, ids, q, metric=Metric.L2)
        want = expand.expand_distances_multi_plain(blocks, ids, q, metric=Metric.L2)
        out[f"{name}_shape"] = [*blocks.shape, q.shape[0], E]
        out[f"{name}_equal"] = bool(torch.equal(got, want))
        out[f"{name}_ms"] = chip.time_ms(
            lambda: expand.expand_distances_multi(blocks, ids, q, metric=Metric.L2), reps)
    return out


# kernel 3's build mode: (name, data, graph, B, R, L), vmax = max(L, R + 16) as
# chip_smoke.py's kernel_build_fused; phase 3's and phase 3b's R = 64 graphs
# at a steady batch of 16,000 (0.16 x 100K), phase 6's 1M graph at its
# steady batch of 40,000 (0.04 x 1M)
FUSEDBUILD_SHAPES = (("R32_L64_vmax64_B16000", "100K", "R32", 16_000, 32, 64),
                     ("R64_L128_vmax128_B16000", "100K", "R64", 16_000, 64, 128),
                     ("1M_R32_L64_vmax64_B40000", "1M", "1M", 40_000, 32, 64))


def _ptxas_walks(log):
    """Registers and spills of kernel 3's walks from nvcc's -Xptxas -v log
    -> {"walk_regs<P,CP>" or "walk_smem": dict(regs, spill_stores,
    spill_loads)}; empty when the library was already built."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            w = re.search(r"walk_regsILi(\d+)ELi(\d+)E", m.group(1))
            name = (f"walk_regs<{w.group(1)},{w.group(2)}>" if w
                    else "walk_smem" if "walk_smem" in m.group(1) else None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["regs"] = int(m.group(1))
            name = None
    return out


def _resident_warps(regs, warps_per_cta):
    """Warps of a kernel an H100 SM holds by its registers alone (256-register
    allocation units a warp, 32 CTAs and 64 warps an SM at most): for a
    checkout whose wrapper cannot ask the runtime."""
    per_warp = -(-regs * 32 // 256) * 256
    ctas = min(65536 // per_warp // warps_per_cta, 32, 64 // warps_per_cta)
    return ctas * warps_per_cta


def time_fusedbuild(chip, reps, dev, cache=None):
    import numpy as np
    import torch
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch import interop
    from parlayann_tpu_torch.ops.kernels import _lib
    from parlayann_tpu_torch.ops.kernels import fusedbeam as fb
    from parlayann_tpu_torch.utils import synthetic
    from parlayann_tpu_torch.utils.arrays import pow2

    log = _lib.build_report()[1]
    data = {"100K": synthetic.clustered(100_000, 128, n_queries=10_000, n_clusters=1000,
                                        cluster_std=0.35, seed=SEED),
            "1M": synthetic.clustered(chip.TIER_N, 128, n_queries=10, n_clusters=10_000,
                                      cluster_std=0.35, seed=SEED)}
    # the card's builds are deterministic, but checkouts compared in one call
    # share the first run's graphs through the cache and build nothing
    builds = {"R32": ("100K", dict(R=32, L=64, alpha=1.2, batch_cap_frac=0.16)),
              "R64": ("100K", dict(R=64, L=128, alpha=1.15, batch_cap_frac=0.16)),
              "1M": ("1M", dict(R=32, L=64, alpha=1.2, batch_cap_frac=0.04))}
    if cache and Path(cache).exists():
        saved = dict(np.load(cache))
    else:
        saved = {}
        for name, (src, kw) in builds.items():
            g, _, _ = pt.build_vamana_index(data[src][0], device=dev, **kw)
            saved[f"{name}_nbrs"], saved[f"{name}_degs"] = (g.neighbors.cpu().numpy(),
                                                            g.degrees.cpu().numpy())
        g, _, _ = pt.build_hcnng_index(data["100K"][0], mst_deg=3, num_clusters=30,
                                       cluster_size=1000, device=dev, seed=chip.PYNN_SEED)
        saved["hcnng_nbrs"], saved["hcnng_degs"] = (g.neighbors.cpu().numpy(),
                                                    g.degrees.cpu().numpy())
        if cache:
            np.savez(cache, **saved)

    def index(name, src):
        nb, dg = saved[f"{name}_nbrs"], saved[f"{name}_degs"]
        graph = interop.graph_from_state(nb, dg, len(dg), nb.shape[1], device=dev)
        points = pt.PointSet.from_numpy(data[src][0], device=dev)
        return pt.Index(points=points, graph=graph).enable_quantized(bits=8)

    out = {"graphs": {name: hashlib.sha256(saved[f"{name}_nbrs"].tobytes()
                                           + saved[f"{name}_degs"].tobytes()).hexdigest()[:16]
                      for name in ("R32", "R64", "1M", "hcnng")},
           "ptxas": _ptxas_walks(log)}
    counted = "counts" in inspect.signature(fb.build_beam_fused).parameters
    for key, src, name, B, R, L in FUSEDBUILD_SHAPES:
        idx = index(name, src)
        tier, g = idx.qpoints, idx.graph
        vmax = max(L, R + 16)
        ids = torch.from_numpy(np.random.default_rng(SEED).permutation(tier.n)[:B]
                               .astype(np.int64)).to(dev)
        args = (tier.data[ids].float(), tier.data, g.neighbors, g.degrees,
                torch.zeros((B, 1), dtype=torch.int32, device=dev))
        kw = dict(metric=tier.metric, n_valid=tier.n, L=L, vmax=vmax)
        got = fb.build_beam_fused(*args, **kw)
        want = fb.build_beam_fused_plain(*args, **kw)
        ms = chip.time_ms(lambda: fb.build_beam_fused(*args, **kw), reps)
        steps = int(got[2].sum())
        row = dict(equal=all(bool(torch.equal(a, b)) for a, b in zip(got, want)), ms=ms,
                   steps=steps, ns_per_step=ms * 1e6 / steps)
        if hasattr(fb, "walk_info"):
            row.update(fb.walk_info(tier.d, L, R))
        else:  # the launcher's rule before register walks of 128 lanes
            walk = (f"walk_regs<{max(pow2(L), 32) // 32},{max(pow2(R), 32) // 32}>"
                    if pow2(L) <= 64 and pow2(R) <= 64 else "walk_smem")
            row["walk"] = walk
            if walk in out["ptxas"]:
                row["resident_warps_from_regs"] = _resident_warps(
                    out["ptxas"][walk]["regs"], 4 if walk != "walk_smem" else 1)
        if counted:
            counts = torch.zeros(2, dtype=torch.int64, device=dev)
            fb.build_beam_fused(*args, **kw, counts=counts)
            row["step_distances"], row["rows_skipped"] = map(int, counts.tolist())
            row["rows_skipped_share"] = row["rows_skipped"] / max(row["step_distances"], 1)
        out[key] = row
    # kernel 3's search rows: chip_smoke.py's shapes on phase 3's graph, on
    # the R = 64 graph and on the HCNNG graph (R = 90, the shared-memory
    # walk), and L = 128
    for name, shapes in (("R32", chip.FUSED_SHAPES + ((10_000, 128),)),
                         ("R64", ((10_000, 10), (10_000, 64), (10_000, 128))),
                         ("hcnng", chip.HCNNG_FUSED)):
        idx = index(name, "100K")
        for B, L in shapes:
            args, kw = chip.fused_args(idx, data["100K"][1][:B], L, dev)
            got = fb.beam_search_fused(*args, **kw)
            want = fb.beam_search_fused_plain(*args, **kw)
            out[f"search_{name}_B{B}_L{L}"] = dict(
                equal=all(bool(torch.equal(a, b)) for a, b in zip(got, want)),
                ms=chip.time_ms(lambda: fb.beam_search_fused(*args, **kw), reps))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("flat_topk", "masked", "occlusion", "fusedbeam",
                                         "fusedbuild", "cluster", "router", "multi", "meta"),
                    default="flat_topk")
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose parlayann_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=None,
                    help="timed launches (default 20 for flat_topk, masked, fusedbeam, "
                         "cluster, multi and meta, 50 for occlusion; router: timed passes, "
                         "default 2)")
    ap.add_argument("--tag", default="", help="a name for the checkout in the output")
    ap.add_argument("--build", type=int, action="append", default=[], choices=sorted(BUILDS),
                    help="also time and profile the q8 build of this many points")
    ap.add_argument("--build-reps", type=int, default=1, help="timed builds of each size")
    ap.add_argument("--f32", action="store_true",
                    help="occlusion: time kernel 2's f32 mode (normal f32 vectors)")
    ap.add_argument("--f32-build", action="store_true",
                    help="also time and profile each --build size on the f32 points")
    ap.add_argument("--profile-builds", action="store_true",
                    help="masked: first profile the checkout's HNSW build A and exact build "
                         "(kernel 4's device ms and launches, busy time, idle share)")
    ap.add_argument("--index-cache", default=None,
                    help="cluster / fusedbuild / masked: load the indexes, graphs or "
                         "cases from this file, or build and save them there")
    args = ap.parse_args()
    root = str(Path(args.root).resolve())
    sys.path[:0] = [root]  # the timed package
    # this repository's timer and profiler, whatever the checkout holds
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    chip = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip)

    import torch

    if not torch.cuda.is_available():
        sys.exit("time_flat_topk: no CUDA device")
    import parlayann_tpu_torch
    from parlayann_tpu_torch.ops.kernels import _lib

    if not parlayann_tpu_torch.__file__.startswith(root):
        sys.exit(f"time_flat_topk: imported {parlayann_tpu_torch.__file__}, not {root}")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _lib.library()
    out = {"tag": args.tag, "root": root, "kernel": args.kernel,
           "lib_build_s": time.perf_counter() - t0}
    if args.kernel == "flat_topk":
        out.update(time_flat(chip, args.reps or 20, dev))
    elif args.kernel == "masked":
        out.update(time_masked(chip, args.reps or 20, dev, args.index_cache,
                               args.profile_builds))
    elif args.kernel == "fusedbeam":
        out.update(time_fused(chip, args.reps or 20, dev))
    elif args.kernel == "fusedbuild":
        out.update(time_fusedbuild(chip, args.reps or 20, dev, args.index_cache))
    elif args.kernel == "cluster":
        out.update(time_cluster(chip, args.reps or 20, dev, args.index_cache))
    elif args.kernel == "router":
        out.update(time_router(chip, args.reps or 2, dev))
    elif args.kernel == "multi":
        out.update(time_multi(chip, args.reps or 20, dev))
    elif args.kernel == "meta":
        out.update(time_meta(chip, args.reps or 20, dev))
    else:
        out.update(time_occlusion(chip, args.reps or 50, dev, args.f32))
    for n in args.build:
        out.update(build_run(chip, n, args.build_reps, dev))
        if args.f32_build:
            out.update(build_run(chip, n, args.build_reps, dev, quantize_build=False))
    out["card"] = chip.card_line()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
