"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked ``cuda`` and skips where no NVIDIA GPU is present: a
CUDA kernel has no CPU mode. This file imports no jax, so it also runs on a
GPU machine without the JAX package; run it there from the repository root
with ``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``
(the shared conftest imports jax). Shapes are small versions of the main
path's. On int8 data with integer-valued queries every distance is an
exact integer, so those comparisons are exact. Kernel 1 on f32 rows and
kernel 5 sum in one fixed f32 order that their plain versions replay, and
kernel 2 on f32 rows decides every test its tensor-core sum leaves in
doubt from the plain version's serial sum, so those comparisons are exact
too. Elsewhere on f32 data the
kernel and its plain version sum in another order. Flat top-k distances agree to rtol
1e-5 plus 1e-6 x (||q||^2 + max ||x||^2) (the L2 algebra cancels the
norms), and ids agree except where two distances lie within that
tolerance; cluster-walk distances agree to rtol 1e-5 (L2) or to 1e-5 of
the largest magnitude (MIPS, whose dot products can cancel). Hamming
distances over packed words are exact integers: equal.
"""

import numpy as np
import pytest
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.ops import quantize
from parlayann_tpu_torch.ops.kernels.expand import (
    expand_bits_flat, expand_bits_flat_plain, expand_distances,
    expand_distances_multi, expand_distances_multi_plain, expand_distances_plain)
from parlayann_tpu_torch.ops.kernels.occlude import (
    occlusion_rounds, occlusion_rounds_plain, pairwise_ordered)
from parlayann_tpu_torch.ops.kernels.fusedbeam import (
    beam_search_fused, beam_search_fused_plain, bitonic_sort_rows, build_beam_fused,
    build_beam_fused_plain, walk_info)
from parlayann_tpu_torch.ops.kernels.flatscan import (
    MAX_K, flat_topk, flat_topk_plain, splits)
from parlayann_tpu_torch.ops.kernels.clusterbeam import (
    cluster_walk, cluster_walk_plain, seed_centroids)
from parlayann_tpu_torch.ops.topk import lexsort
from parlayann_tpu_torch.utils.arrays import pow2
from parlayann_tpu_torch.api import build_cluster_index, build_hnsw_index, build_vamana_index
from parlayann_tpu_torch.build import hcnng, hnsw, pynndescent
from parlayann_tpu_torch.harness.recall import compute_recall
from parlayann_tpu_torch.search.exact import compute_groundtruth
from parlayann_tpu_torch.types import BuildParams
from parlayann_tpu_torch.utils.draws import Draws
from parlayann_tpu_torch.index import Index
from parlayann_tpu_torch import interop

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture()
def gen():
    return np.random.default_rng(11)


def t(x, dev):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


@pytest.mark.parametrize("R8", [32, 40])
@pytest.mark.parametrize("d", [128, 96, 20])
def test_torch_cuda_expand_distances_bit_equal(gen, cuda, d, R8):
    """d=128 takes the 16-byte-load path, 96 and 20 the generic one; R8 = 40
    is HNSW's level 0 (2m = 40 neighbours)."""
    inl = t(gen.integers(-128, 128, (500, R8, d)).astype(np.int8), cuda)
    ids = t(gen.integers(-3, 503, 999).astype(np.int32), cuda)  # clamped
    q = t(gen.integers(-128, 128, (999, d)).astype(np.float32), cuda)
    for metric in (Metric.L2, Metric.MIPS):
        got = expand_distances(inl, ids, q, metric=metric)
        assert torch.equal(got, expand_distances_plain(inl, ids, q, metric=metric))


@pytest.mark.parametrize("R8", [16, 32, 40, 64])
@pytest.mark.parametrize("d", [128, 96, 21, 20])
def test_torch_cuda_expand_distances_f32_equal(gen, cuda, d, R8):
    """Kernel 1 on f32 rows equals its plain version (the same summation
    order) under L2 and MIPS; d = 21 is a row of 84 bytes (4-byte loads),
    20 of 80 (16-byte rows off a 16-byte boundary: 8-byte loads) and 96 a
    row whose last pass covers part of the 8 lanes; ids out of range are
    clamped; f32 launches are counted apart."""
    inl = t(gen.standard_normal((700, R8, d)).astype(np.float32), cuda)
    for B in (0, 1, 999):
        ids = t(gen.integers(-3, 703, B).astype(np.int32), cuda)
        q = t((gen.standard_normal((B, d)) * 3).astype(np.float32), cuda)
        for metric in (Metric.L2, Metric.MIPS):
            before = (expand_distances.launches, expand_distances.launches_f32)
            got = expand_distances(inl, ids, q, metric=metric)
            n = int(B > 0)
            assert (expand_distances.launches, expand_distances.launches_f32) == (
                before[0] + n, before[1] + n)
            assert got.shape == (B, R8)
            assert torch.equal(got, expand_distances_plain(inl, ids, q, metric=metric))


def test_torch_cuda_expand_distances_f32_main_shape(gen, cuda):
    """The f32 search's shape: B=10,000 over a (100000, 32, 128) f32 inline
    array, and a view whose rows start 4 bytes past a 16-byte boundary."""
    inl = t(gen.standard_normal((100_000, 32, 128)).astype(np.float32), cuda)
    ids = t(gen.integers(0, 100_000, 10_000).astype(np.int32), cuda)
    q = t(gen.standard_normal((10_000, 128)).astype(np.float32), cuda)
    for metric in (Metric.L2, Metric.MIPS):
        got = expand_distances(inl, ids, q, metric=metric)
        assert torch.equal(got, expand_distances_plain(inl, ids, q, metric=metric))
    small = inl[:500]
    flat = torch.empty(small.numel() + 4, dtype=torch.float32, device=cuda)
    view = flat[1:1 + small.numel()].view(small.shape)
    view.copy_(small)
    ids = ids[:700] % 500
    assert torch.equal(expand_distances(view, ids, q[:700], metric=Metric.L2),
                       expand_distances_plain(small, ids, q[:700], metric=Metric.L2))


def _int16_rows(gen, shape):
    """int16 levels with the first rows at the extremes (-32768 and 32767:
    16-bit L2 levels 0 and 65535 after the port's shift), where an int32
    sum would overflow."""
    x = gen.integers(-32768, 32768, shape).astype(np.int16)
    x[:4] = gen.choice(np.array([-32768, 32767], np.int16), (4,) + tuple(shape[1:]))
    return x


def _int16_queries(gen, B, d, n_pad):
    """Integer-valued f32 queries over the int16 range, the first ones at
    the extremes, with ids that send them to the extreme rows."""
    q = gen.integers(-32768, 32768, (B, d)).astype(np.float32)
    q[:8] = gen.choice(np.array([-32768.0, 32767.0], np.float32), q[:8].shape)
    ids = gen.integers(-3, n_pad + 3, B).astype(np.int32)
    ids[:8] = gen.integers(0, 4, min(B, 8))
    return q, ids


@pytest.mark.parametrize("R8", [13, 16, 32, 40])
@pytest.mark.parametrize("d", [128, 64, 96, 20, 7])
def test_torch_cuda_expand_distances_int16_equal(gen, cuda, d, R8):
    """Kernel 1 on int16 rows (the scalar tiers of 9 to 16 bits) equals its
    plain version under L2 and MIPS: both sum exactly in int64 and round
    once. d = 128 and 64 take the 16-byte path, 96 (12 chunks a row), 20
    and 7 the generic one; R8 = 13 is not a multiple of 8; rows and queries
    at the extreme levels pass 2^31; int16 launches are counted apart."""
    inl = t(_int16_rows(gen, (600, R8, d)), cuda)
    for B in (0, 1, 777):
        q, ids = _int16_queries(gen, B, d, 600)
        q, ids = t(q, cuda), t(ids, cuda)
        for metric in (Metric.L2, Metric.MIPS):
            before = (expand_distances.launches, expand_distances.launches_i16)
            got = expand_distances(inl, ids, q, metric=metric)
            n = int(B > 0)
            assert (expand_distances.launches, expand_distances.launches_i16) == (
                before[0] + n, before[1] + n)
            assert got.shape == (B, R8) and got.dtype == torch.float32
            assert torch.equal(got, expand_distances_plain(inl, ids, q, metric=metric))
            if B and d == 128:
                assert float(got.abs().max()) > 2**31


def test_torch_cuda_expand_distances_int16_main_shape(gen, cuda):
    """The 16-bit tier's search shape: B=10,000 over a (100000, 32, 128)
    int16 inline array, and a view whose rows start 2 bytes past a 16-byte
    boundary (the generic path)."""
    inl = t(_int16_rows(gen, (100_000, 32, 128)), cuda)
    q, ids = _int16_queries(gen, 10_000, 128, 100_000)
    q, ids = t(q, cuda), t(ids, cuda)
    for metric in (Metric.L2, Metric.MIPS):
        assert torch.equal(expand_distances(inl, ids, q, metric=metric),
                           expand_distances_plain(inl, ids, q, metric=metric))
    small = inl[:500]
    flat = torch.empty(small.numel() + 1, dtype=torch.int16, device=cuda)
    view = flat[1:1 + small.numel()].view(small.shape)
    view.copy_(small)
    ids = ids[:700].clamp(0, 499)
    assert torch.equal(expand_distances(view, ids, q[:700], metric=Metric.MIPS),
                       expand_distances_plain(small, ids, q[:700], metric=Metric.MIPS))


def test_torch_cuda_expand_distances_int16_rejects_bad_input(cuda):
    """A CUDA tensor of a dtype kernel 1 does not take raises; nothing
    falls back to the plain version."""
    inl = torch.zeros((8, 8, 16), dtype=torch.int16, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    q = torch.zeros((4, 16), device=cuda)
    before = expand_distances.launches
    with pytest.raises(ValueError, match="int8"):
        expand_distances(inl.to(torch.int32), ids, q, metric=Metric.L2)
    with pytest.raises(ValueError, match="float32"):
        expand_distances(inl, ids, q.double(), metric=Metric.L2)
    with pytest.raises(ValueError, match="int32"):
        expand_distances(inl, ids.long(), q, metric=Metric.MIPS)
    with pytest.raises(ValueError, match="shape"):
        expand_distances(inl, ids, q[:, :8].contiguous(), metric=Metric.L2)
    assert expand_distances.launches == before


INF32 = np.float32(3.0e38)


def _occl_rows(gen, B, C, d, metric, lim=128):
    """Rows as robustPrune sees them: the metric's distances to a point p,
    ascending, with an INF tail of up to C // 3 slots; int8 vectors in
    [-lim, lim)."""
    p = gen.integers(-lim, lim, (B, 1, d))
    vecs = gen.integers(-lim, lim, (B, C, d))
    dist = ((vecs - p) ** 2).sum(-1) if metric is Metric.L2 else -(vecs * p).sum(-1)
    tail = np.arange(C)[None, :] >= C - gen.integers(0, C // 3 + 1, (B, 1))
    dist = np.where(tail, INF32, dist.astype(np.float32))
    order = np.argsort(dist, axis=1, kind="stable")
    return (np.take_along_axis(dist, order, 1),
            np.take_along_axis(vecs, order[:, :, None], 1).astype(np.int8))


def _check_occl(dist, vecs, alpha, R, metric, dev):
    """The kernel's rounds equal the plain version's; one launch per call
    with rows."""
    dist, vecs = t(dist, dev), t(vecs, dev)
    before = occlusion_rounds.launches
    got = occlusion_rounds(dist, vecs, alpha, R=R, metric=metric)
    assert occlusion_rounds.launches == before + (dist.shape[0] > 0)
    assert torch.equal(got, occlusion_rounds_plain(dist, vecs, alpha, R=R, metric=metric))
    return got


@pytest.mark.parametrize("d", [20, 100, 128])
@pytest.mark.parametrize("C,R", [(37, 16), (40, 32), (50, 20), (64, 32), (96, 32),
                                 (100, 40), (192, 64), (80, 40)])
def test_torch_cuda_occlusion_rounds_equal(gen, cuda, C, R, d):
    """The build's C (40, 64, 96, 192), HNSW's forward prune (efc = 50,
    m = 20), pyNNDescent's undirect prune (2K, K) = (80, 40) and widths off
    the 16-candidate strip and 32-candidate word; d = 128 takes 16-byte copies, 100 and 20 4-byte
    ones. Each batch has a row with no live candidate and one with fewer
    than R; alpha = 1 on small integers makes d(star, c) = d(p, c) ties."""
    for metric in (Metric.L2, Metric.MIPS):
        dist, vecs = _occl_rows(gen, 64, C, d, metric)
        dist[3] = INF32
        dist[5, 3:] = INF32
        _check_occl(dist, vecs, 1.2, R, metric, cuda)
        dist, vecs = _occl_rows(gen, 64, C, d, metric, lim=3)
        _check_occl(dist, vecs, 1.0, R, metric, cuda)


def test_torch_cuda_occlusion_rounds_skipped_strips(gen, cuda):
    """Candidates 16..47 copy candidate 0, so the first star kills them: no
    star falls in strips 1 and 2, whose distances are never computed, and
    the L2 rounds go on to stars past them."""
    B, C, d, R = 8, 96, 128, 32
    vecs = gen.integers(-128, 128, (B, C, d))
    vecs[:, 16:48] = vecs[:, :1]
    dist = np.sort(gen.random((B, C)) * 1e6 + 1.0, axis=1).astype(np.float32)
    for metric in (Metric.L2, Metric.MIPS):
        got = _check_occl(dist, vecs.astype(np.int8), 1.2, R, metric, cuda)
        assert bool((got[:, 16:48] >= R).all())
        if metric is Metric.L2:
            assert bool((got[:, 48:] < R).any(dim=1).all())


@pytest.mark.parametrize("B", [0, 1])
def test_torch_cuda_occlusion_rounds_tiny_batches(gen, cuda, B):
    for metric in (Metric.L2, Metric.MIPS):
        dist, vecs = _occl_rows(gen, B, 96, 128, metric)
        assert _check_occl(dist, vecs, 1.2, 32, metric, cuda).shape == (B, 96)


@pytest.mark.parametrize("C,d", [(640, 128), (1100, 16), (1500, 144), (6000, 30)])
def test_torch_cuda_occlusion_rounds_large_rows(gen, cuda, C, d):
    """Rows past the tensor-core kernel's reach run the global-memory
    variant: (1100, 16) has more than 1024 candidates, and (1500, 144) and
    (6000, 30), with C * d + 8 C near the 227 KB the wrapper allows, do not
    fit one CTA's shared memory; (640, 128) still does."""
    assert C * d + 8 * C <= 227 * 1024
    for metric in (Metric.L2, Metric.MIPS):
        dist, vecs = _occl_rows(gen, 3, C, d, metric)
        _check_occl(dist, vecs, 1.2, 64, metric, cuda)


def test_torch_cuda_occlusion_rounds_misaligned_vectors(gen, cuda):
    """cand_vecs views 1, 4 and 8 bytes past a 16-byte boundary take the
    plain-load, 4-byte and 8-byte copy paths; the wrapper still refuses a
    row past 227 KB."""
    dist, vecs = _occl_rows(gen, 32, 96, 128, Metric.L2)
    dist, vecs = t(dist, cuda), t(vecs, cuda)
    want = occlusion_rounds_plain(dist, vecs, 1.2, R=32, metric=Metric.L2)
    for off in (1, 4, 8):
        flat = torch.empty(vecs.numel() + 16, dtype=torch.int8, device=cuda)
        view = flat[off:off + vecs.numel()].view(vecs.shape)
        view.copy_(vecs)
        assert view.data_ptr() % 16 == off
        assert torch.equal(occlusion_rounds(dist, view, 1.2, R=32, metric=Metric.L2), want)
    with pytest.raises(ValueError, match="shared memory"):
        occlusion_rounds(torch.zeros((1, 2000), device=cuda),
                         torch.zeros((1, 2000, 120), dtype=torch.int8, device=cuda),
                         1.2, R=32, metric=Metric.L2)


def _occl_rows_f32(gen, B, C, d, metric):
    """f32 rows as the f32 build's prunes see them: the metric's distances
    to a point p, ascending, with an INF tail of up to C // 3 slots."""
    p = gen.standard_normal((B, 1, d))
    vecs = gen.standard_normal((B, C, d))
    dist = ((vecs - p) ** 2).sum(-1) if metric is Metric.L2 else -(vecs * p).sum(-1)
    tail = np.arange(C)[None, :] >= C - gen.integers(0, C // 3 + 1, (B, 1))
    dist = np.where(tail, INF32, dist.astype(np.float32))
    order = np.argsort(dist, axis=1, kind="stable")
    return (np.take_along_axis(dist, order, 1),
            np.take_along_axis(vecs, order[:, :, None], 1).astype(np.float32))


@pytest.mark.parametrize("d", [128, 100, 21])
@pytest.mark.parametrize("C,R", [(40, 32), (64, 32), (96, 32), (192, 64), (37, 16),
                                 (50, 20), (80, 40)])
def test_torch_cuda_occlusion_rounds_f32_equal(gen, cuda, C, R, d):
    """Kernel 2 on f32 vectors at the Vamana build's four prune shapes,
    HNSW's (50, 20), pyNNDescent's (80, 40) and one off
    the strip and word widths: rounds equal to the plain version, whose
    serial sums the kernel rechecks in; d = 21 takes 4-byte
    copies. A row with no live candidate and one with fewer than R; f32
    launches are counted apart."""
    for metric in (Metric.L2, Metric.MIPS):
        dist, vecs = _occl_rows_f32(gen, 64, C, d, metric)
        dist[3] = INF32
        dist[5, 3:] = INF32
        before = occlusion_rounds.launches_f32
        got = _check_occl(dist, vecs, 1.2, R, metric, cuda)
        assert occlusion_rounds.launches_f32 == before + 1
        assert bool((got[:, 0] == 0).sum() == 63)


@pytest.mark.parametrize("C,d", [(300, 256), (1100, 16), (96, 700)])
def test_torch_cuda_occlusion_rounds_f32_large_rows(gen, cuda, C, d):
    """f32 rows past one CTA's shared memory ((300, 256): 309 KB; (96, 700))
    or past 1024 candidates run the global-memory variant: still equal."""
    for metric in (Metric.L2, Metric.MIPS):
        dist, vecs = _occl_rows_f32(gen, 3, C, d, metric)
        _check_occl(dist, vecs, 1.2, 64, metric, cuda)


def test_torch_cuda_occlusion_rounds_f32_build_shape(gen, cuda):
    """The chip check's shape, B=2048 rows of (C, R) = (96, 32), d=128."""
    for metric in (Metric.L2, Metric.MIPS):
        dist, vecs = _occl_rows_f32(gen, 2048, 96, 128, metric)
        _check_occl(dist, vecs, 1.2, 32, metric, cuda)


def _check_counted(dist, vecs, alpha, R, metric):
    """_check_occl on card tensors with the recheck counter -> (tests the
    rounds can read, rechecks)."""
    counts = torch.zeros(2, dtype=torch.int64, device=dist.device)
    got = occlusion_rounds(dist, vecs, alpha, R=R, metric=metric, counts=counts)
    assert torch.equal(got, occlusion_rounds_plain(dist, vecs, alpha, R=R, metric=metric))
    tests, rechecks = counts.tolist()
    assert 0 <= rechecks <= tests
    return tests, rechecks


@pytest.mark.parametrize("d", [128, 100, 21])
def test_torch_cuda_occlusion_rounds_f32_threshold_rows(gen, cuda, d):
    """Adversarial f32 rows: each candidate's d(p, c) is alpha times its
    pair distance to candidate 0, the first star, as the plain version
    rounds both (its serial order), or one ulp above or below that. Every
    test of the first star then sits on its threshold, inside the margin:
    each is rechecked serially (at least C - 1 a row), and the rounds stay
    equal to the plain version's, later stars included."""
    B, C, R, alpha = 64, 96, 32, 1.2
    for metric in (Metric.L2, Metric.MIPS):
        vecs = t(gen.standard_normal((B, C, d)).astype(np.float32), cuda)
        thr = torch.tensor(alpha, device=cuda) * pairwise_ordered(vecs, metric)[:, 0]
        step = t(gen.integers(-1, 2, (B, C)), cuda)
        inf = torch.full_like(thr, float("inf"))
        thr = torch.where(step > 0, torch.nextafter(thr, inf),
                          torch.where(step < 0, torch.nextafter(thr, -inf), thr))
        thr[:, 0] = thr[:, 1:].min(dim=1).values - 1.0  # candidate 0 first
        thr, order = torch.sort(thr, dim=1, stable=True)
        vecs = torch.gather(vecs, 1, order[:, :, None].expand(B, C, d)).contiguous()
        tests, rechecks = _check_counted(thr, vecs, alpha, R, metric)
        assert rechecks >= B * (C - 1), (metric, tests, rechecks)


@pytest.mark.parametrize("lim", [4, 256])
def test_torch_cuda_occlusion_rounds_f32_integer_rows(gen, cuda, lim):
    """Integer-valued f32 rows in [0, lim) (the exact float32 copies of
    uint8 builds) at alpha = 1: 3xTF32 is exact on them, and the ties
    d(star, c) = d(p, c) fall inside the margin and are rechecked (many at
    lim = 4); the rounds stay equal. An int8 launch adds nothing to the
    counter."""
    B, C, R = 256, 96, 32
    for d in (16, 128):
        for metric in (Metric.L2, Metric.MIPS):
            p = gen.integers(0, lim, (B, 1, d))
            vecs = gen.integers(0, lim, (B, C, d))
            dist = (((vecs - p) ** 2).sum(-1) if metric is Metric.L2
                    else -(vecs * p).sum(-1)).astype(np.float32)
            order = np.argsort(dist, axis=1, kind="stable")
            dist = np.take_along_axis(dist, order, 1)
            vecs = np.take_along_axis(vecs, order[:, :, None], 1)
            tests, rechecks = _check_counted(t(dist, cuda), t(vecs.astype(np.float32), cuda),
                                             1.0, R, metric)
            assert tests > 0 and (rechecks > 0 or lim > 4), (d, metric, tests, rechecks)
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    occlusion_rounds(t(dist, cuda), t((vecs - lim // 2).astype(np.int8), cuda), 1.0, R=R,
                     metric=metric, counts=counts)
    assert counts.tolist() == [0, 0]


def _walk_case(gen, dev, *, n=2000, d=128, R=32, B=128, S=3, lim=128, qkind="int"):
    """Kernel 3's inputs: an int8 tier of n valid rows and 8 pad rows
    (values in [-lim, lim)); duplicate-free neighbour rows with -1 and
    >= n_valid ids, short and empty rows; queries integer-valued ("int",
    the q8 path), integer + 0.5 ("half") or with one integer outside int8
    ("wide"), both of which take the f32 arithmetic and stay exact; (B, S)
    starts with a repeated start, an invalid one, a start >= n_valid and,
    in row 2, no valid start at all."""
    n_pad = n + 8
    tier = gen.integers(-lim, lim, (n_pad, d)).astype(np.int8)
    nbrs = np.stack([gen.choice(n, R, replace=False) for _ in range(n_pad)])
    nbrs[gen.random(nbrs.shape) < 0.05] = -1
    far = gen.random(nbrs.shape) < 0.03
    nbrs[far] = gen.integers(n, n_pad + 4, int(far.sum()))
    degs = gen.integers(R // 2, R + 1, n_pad)
    degs[gen.random(n_pad) < 0.02] = 0
    Q = gen.integers(-lim, lim, (B, d)).astype(np.float32)
    if qkind == "half":
        Q += 0.5
    elif qkind == "wide":
        Q[:, 0] = 200.0
    starts = gen.integers(0, n, (B, S))
    if B >= 4:
        starts[:, -1] = starts[:, 0]
        starts[1, 0] = -1
        starts[2, :] = -1
        starts[3, 1] = n + 3
    return (t(Q, dev), t(tier, dev), t(nbrs.astype(np.int32), dev),
            t(degs.astype(np.int32), dev), t(starts.astype(np.int32), dev))


def _check_walk(args, **kw):
    """All four outputs of kernel 3 equal its plain version's; one launch
    a call with queries."""
    before = beam_search_fused.launches
    got = beam_search_fused(*args, **kw)
    assert beam_search_fused.launches == before + (args[0].shape[0] > 0)
    want = beam_search_fused_plain(*args, **kw)
    for name, g, w in zip(("ids", "dists", "num_visited", "dist_cmps"), got, want):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("L", [8, 10, 64, 200, 1000])
@pytest.mark.parametrize("R", [16, 32, 64, 100])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
def test_torch_cuda_beam_search_fused_equal(gen, cuda, metric, R, L):
    """The register beam (L <= 64 and R <= 64: 1 or 2 beam registers and 1
    or 2 candidate registers a lane) and the shared-memory beam (L = 200
    and 1000, or R = 100)."""
    args = _walk_case(gen, cuda, R=R)
    ids, _, nv, _ = _check_walk(args, metric=metric, n_valid=2000, k=10, L=L)
    assert bool((nv[2] == 0) & (ids[2] == -1).all())  # no valid start
    assert int(nv.max()) > 1


@pytest.mark.parametrize("d,off", [(128, 0), (96, 0), (20, 0), (128, 1), (128, 4),
                                   (128, 8)])
def test_torch_cuda_beam_search_fused_row_widths(gen, cuda, d, off):
    """d = 128 and 96 take 16-byte loads, d = 20 4-byte ones; tier views 1,
    4 and 8 bytes past a 16-byte boundary take byte, 4- and 8-byte loads."""
    q, tier, nbrs, degs, starts = _walk_case(gen, cuda, d=d)
    if off:
        flat = torch.empty(tier.numel() + 16, dtype=torch.int8, device=cuda)
        view = flat[off:off + tier.numel()].view(tier.shape)
        view.copy_(tier)
        assert view.data_ptr() % 16 == off
        tier = view
    for metric in (Metric.L2, Metric.MIPS):
        for L in (10, 64):
            _check_walk((q, tier, nbrs, degs, starts), metric=metric, n_valid=2000,
                        k=10, L=L)


@pytest.mark.parametrize("limit,k,cut", [(1, 10, 1.35), (5, 10, 1.35), (2**30, 0, 1.35),
                                         (2**30, 64, 1.35), (2**30, 10, 1.0)])
def test_torch_cuda_beam_search_fused_stop_rules(gen, cuda, limit, k, cut):
    """A visit budget of 1 and 5; k = 0 and k >= L (no cut); cut = 1."""
    args = _walk_case(gen, cuda)
    for metric in (Metric.L2, Metric.MIPS):
        for L in (10, 64, 300):
            _, _, nv, _ = _check_walk(args, metric=metric, n_valid=2000, k=k, L=L,
                                      cut=cut, limit=limit)
            assert int(nv.max()) <= limit


@pytest.mark.parametrize("qkind", ["int", "half", "wide"])
@pytest.mark.parametrize("L", [10, 64, 1000])
def test_torch_cuda_beam_search_fused_ties(gen, cuda, L, qkind):
    """Integer data in [-3, 3): many equal distances, so the pack order
    decides; half-integer and out-of-range queries take the f32 path."""
    args = _walk_case(gen, cuda, lim=3, qkind=qkind)
    for metric in (Metric.L2, Metric.MIPS):
        _check_walk(args, metric=metric, n_valid=2000, k=10, L=L)


def test_torch_cuda_beam_search_fused_shared_starts(gen, cuda):
    """1-D starts shared by every query, with a repeat, -1 and >= n_valid."""
    q, tier, nbrs, degs, _ = _walk_case(gen, cuda)
    starts = torch.tensor([5, 17, 5, -1, 2003, 17, 9], dtype=torch.int32, device=cuda)
    for metric in (Metric.L2, Metric.MIPS):
        for L in (10, 64, 1000):
            _, _, _, cm = _check_walk((q, tier, nbrs, degs, starts), metric=metric,
                                      n_valid=2000, k=10, L=L)
            assert bool((cm >= 5).all())  # the repeated starts count as scored


@pytest.mark.parametrize("B", [0, 1, 10000])
def test_torch_cuda_beam_search_fused_batches(gen, cuda, B):
    """B = 10000 is many more queries than resident warps: the queue."""
    args = _walk_case(gen, cuda, n=3000, B=B)
    for L in (10, 64):
        ids, _, _, _ = _check_walk(args, metric=Metric.L2, n_valid=3000, k=10, L=L)
        assert ids.shape == (B, L)


def test_torch_cuda_beam_search_fused_widest_beam_and_rows(gen, cuda):
    """L = 4096 lanes (the limit; 4097 raises) and R = 300 neighbours, both
    on the shared-memory beam."""
    args = _walk_case(gen, cuda, n=5000, B=16)
    _check_walk(args, metric=Metric.L2, n_valid=5000, k=10, L=4096)
    with pytest.raises(ValueError, match="exceeds"):
        beam_search_fused(*args, metric=Metric.L2, n_valid=5000, k=10, L=4097)
    args = _walk_case(gen, cuda, R=300, B=64)
    for metric in (Metric.L2, Metric.MIPS):
        _check_walk(args, metric=metric, n_valid=2000, k=10, L=64)


@pytest.mark.parametrize("L", [10, 64, 80])
def test_torch_cuda_beam_search_fused_degree90_random_starts(gen, cuda, L):
    """HCNNG's shape: R = 90 (the shared-memory walk; 90 is not a power of
    two), degrees from 1 to 90 with most rows short, and one random start a
    query as ``random_starts=1`` draws them."""
    q, tier, nbrs, degs, _ = _walk_case(gen, cuda, R=90, B=512)
    n_pad = tier.shape[0]
    uneven = np.minimum(1 + gen.geometric(1 / 24, n_pad), 90).astype(np.int32)
    degs = t(uneven, cuda)
    starts = t(np.random.default_rng(0).integers(0, 2000, (512, 1)).astype(np.int32), cuda)
    for metric in (Metric.L2, Metric.MIPS):
        _, _, nv, _ = _check_walk((q, tier, nbrs, degs, starts), metric=metric,
                                  n_valid=2000, k=10, L=L)
        assert int(nv.max()) > 1


def _check_build_walk(args, **kw):
    """All four outputs of kernel 3's build mode (visited ids and
    distances, nv, cmps) equal its plain version's; one launch a call with
    queries, counted apart from the search's."""
    before, search = build_beam_fused.launches, beam_search_fused.launches
    got = build_beam_fused(*args, **kw)
    assert build_beam_fused.launches == before + (args[0].shape[0] > 0)
    assert beam_search_fused.launches == search
    want = build_beam_fused_plain(*args, **kw)
    for name, g, w in zip(("visited_ids", "visited_dists", "num_visited", "dist_cmps"),
                          got, want):
        assert torch.equal(g, w), name
    return got


@pytest.mark.parametrize("R,L,vmax", [(32, 64, 64), (64, 128, 128), (90, 64, 106),
                                       (48, 100, 100), (64, 129, 129)])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
def test_torch_cuda_build_beam_fused_equal(gen, cuda, metric, R, L, vmax):
    """The build mode, and the search (k = 10) over the same inputs, at the
    builds' (R, L, vmax) and the register walk's edges: phase 3's (64
    lanes), bench.py's R = 64, L = 128 (the widest register walk, 128
    lanes and 64 candidates), R = 48, L = 100 (neither a power of two:
    lanes 100-127 hold the sentinel), L = 129 (256 lanes: the
    shared-memory walk) and degree 90 (the shared-memory walk; vmax = R +
    16, which the walk does not reach); a build's starts (point 0, -1 on
    the last 40 rows, padded rows that do no work); half the queries are
    the tier's own rows, as a build's inserts are."""
    q, tier, nbrs, degs, _ = _walk_case(gen, cuda, R=R, B=256)
    q[:128] = tier[:128].float()
    starts = torch.zeros((256, 1), dtype=torch.int32, device=cuda)
    starts[-40:] = -1
    ids, dists, nv, cm = _check_build_walk((q, tier, nbrs, degs, starts), metric=metric,
                                           n_valid=2000, L=L, vmax=vmax)
    assert ids.shape == dists.shape == (256, vmax)
    assert bool((nv[-40:] == 0).all()) and bool((ids[-40:] == -1).all())
    if vmax == L:
        assert int(nv.max()) == vmax  # the budget binds
    else:  # degree 90 at L = 64 converges first: rows padded from nv
        assert int(nv[:-40].min()) > 0 and int(nv.max()) < vmax
    # the walk the launcher takes, and its count of rows not read again
    info = walk_info(128, L, R)
    regs = L <= 128 and R <= 64
    assert info["walk"] == (f"walk_regs<{max(pow2(L), 32) // 32},{max(pow2(R), 32) // 32}>"
                            if regs else "walk_smem")
    assert info["regs"] > 0 and info["resident_warps"] > 0
    counts = torch.zeros(2, dtype=torch.int64, device=cuda)
    build_beam_fused(q, tier, nbrs, degs, starts, metric=metric, n_valid=2000, L=L,
                     vmax=vmax, counts=counts)
    valid, skipped = counts.tolist()
    if regs:  # every step distance the walk counts, less the seeds'
        assert valid == int(cm.sum()) - 216 and 0 < skipped < valid
    else:
        assert valid == skipped == 0
    ids, _, nv, _ = _check_walk((q, tier, nbrs, degs, starts), metric=metric, n_valid=2000,
                                k=10, L=L)
    assert ids.shape == (256, L) and bool((nv[-40:] == 0).all()) and int(nv.max()) > 1


@pytest.mark.parametrize("B", [0, 1, 500])
def test_torch_cuda_build_beam_fused_small_n(gen, cuda, B):
    """n_valid = 40 < vmax = 64: the limit min(vmax, n_valid) binds and the
    rows pad from there; 1-D shared starts."""
    q, tier, nbrs, degs, _ = _walk_case(gen, cuda, n=40, R=16, B=max(B, 1))
    q = q[:B]
    starts = torch.zeros((1,), dtype=torch.int32, device=cuda)
    for metric in (Metric.L2, Metric.MIPS):
        ids, _, nv, _ = _check_build_walk((q, tier, nbrs, degs, starts), metric=metric,
                                          n_valid=40, L=64, vmax=64)
        assert ids.shape == (B, 64)
        if B:
            assert int(nv.max()) <= 40 and bool((ids[:, 40:] == -1).all())


def test_torch_cuda_vamana_fused_read_equals_cpu(cuda):
    """A fused_read=True q8 build on the card (kernel 3's build mode in its
    steady batch of 4,096) equals the same build on the CPU (the plain
    walk) row for row: every distance is an exact integer."""
    from parlayann_tpu_torch.utils import synthetic

    X = synthetic.clustered(8192, 32, n_queries=1, n_clusters=64, seed=11)[0]
    kw = dict(R=16, L=32, alpha=1.2, batch_cap_frac=0.5, fused_read=True)
    before = build_beam_fused.launches
    g, _, st = build_vamana_index(X, device=cuda, **kw)
    assert build_beam_fused.launches == before + 2  # one steady batch a pass
    h, _, sh = build_vamana_index(X, device="cpu", **kw)
    assert torch.equal(g.degrees.cpu(), h.degrees)
    assert torch.equal(g.neighbors.cpu(), h.neighbors)
    assert (st.total_visited, st.total_cmps) == (sh.total_visited, sh.total_cmps)


@pytest.mark.parametrize("W", [2, 256, 2048])
def test_torch_cuda_bitonic_rows(gen, cuda, W):
    keys = t(gen.integers(0, 16, (32, W)).astype(np.float32), cuda)
    vals = t(np.stack([gen.permutation(W) for _ in range(32)]).astype(np.int32), cuda)
    for g, w in zip(bitonic_sort_rows(keys, vals), lexsort((keys, vals))):
        assert torch.equal(g, w)


def test_torch_cuda_wrappers_reject_bad_input(cuda):
    inl = torch.zeros((8, 8, 16), dtype=torch.float64, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    q = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="int8"):
        expand_distances(inl, ids, q, metric=Metric.L2)
    with pytest.raises(ValueError, match="device"):
        expand_distances(inl.to(torch.int8), ids.cpu(), q, metric=Metric.L2)


def assert_same_topk(ids, dists, want_ids, want_d, scale):
    """(B, k) results equal up to the f32 tolerance of the module doc;
    ``scale`` (B,) is ||q||^2 + max ||x||^2."""
    ids, dists = ids.cpu().numpy(), dists.cpu().numpy()
    want_ids, want_d = want_ids.cpu().numpy(), want_d.cpu().numpy()
    assert ((ids < 0) == (want_ids < 0)).all()
    ok = want_ids >= 0
    tol = 1e-5 * np.abs(want_d) + 1e-6 * scale[:, None]
    assert (np.abs(dists - want_d)[ok] <= tol[ok]).all()
    for r in np.flatnonzero((ids != want_ids).any(axis=1)):
        last = ok[r].sum() - 1
        only = ~np.isin(ids[r], want_ids[r])
        assert (np.abs(dists[r][only] - want_d[r, last]) <= tol[r, last]).all(), r
        only = ~np.isin(want_ids[r], ids[r])
        assert (np.abs(want_d[r][only] - dists[r, last]) <= tol[r, last]).all(), r


def _flat_case(gen, dev, dtype, n, d, B):
    """-> (x, q, scale) for a dtype of the module doc's flat cases: "f32";
    "int8" (integer queries, exact); "int8-f32q" (int8 points, real-valued
    queries: the f32 tolerance)."""
    if dtype == "f32":
        X = gen.standard_normal((n, d)).astype(np.float32)
        Q = gen.standard_normal((B, d)).astype(np.float32)
    else:
        X = gen.integers(-128, 128, (n, d)).astype(np.int8)
        Q = gen.integers(-128, 128, (B, d)).astype(np.float32)
        if dtype == "int8-f32q":
            Q = Q + gen.standard_normal((B, d)).astype(np.float32)
    Xf = X.astype(np.float64)
    scale = (Q.astype(np.float64) ** 2).sum(1) + (Xf ** 2).sum(1).max()
    return t(X, dev), t(Q, dev), scale


def _check_flat(got, want, dtype, scale, excl=None):
    if dtype == "int8":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert_same_topk(*got, *want, scale)
    if excl is not None:
        assert not (got[0] == excl[:, None]).any()


@pytest.mark.parametrize("k", [1, 10, 64, 128, 256])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("dtype", ["f32", "int8", "int8-f32q"])
def test_torch_cuda_flat_topk_equal(gen, cuda, dtype, metric, k):
    """n, d and B off every tile multiple; a mask, an exclusion and 7
    invalid tail rows."""
    n, d, B = 5000, 100, 300
    x, q, scale = _flat_case(gen, cuda, dtype, n, d, B)
    mask = t(gen.random(n) < 0.8, cuda)
    excl = t(gen.integers(0, n, B).astype(np.int32), cuda)
    for mk, ex in ((None, None), (mask, excl)):
        kw = dict(k=k, metric=metric, n_valid=n - 7)
        _check_flat(flat_topk(q, x, mk, ex, **kw), flat_topk_plain(q, x, mk, ex, **kw),
                    dtype, scale, ex)


@pytest.mark.parametrize("B,n,d,k,many", [
    (64, 70000, 128, 10, True),   # S > 1: one block of queries, many splits
    (1, 100, 100, 10, False),     # fewer points than a tile, one query
    (3, 90, 37, 128, False),      # k > n; d = 37: 4-byte f32 copies, int8 plain loads
    (130, 9000, 10, 256, True),   # 8-byte f32 copies, int8 plain loads, S > 1
])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_cuda_flat_topk_splits_and_edges(gen, cuda, dtype, B, n, d, k, many):
    """The split of the point range (merged by merge_split_topk) and the
    copy widths the row lengths allow, against the plain version."""
    x, q, scale = _flat_case(gen, cuda, dtype, n, d, B)
    S, per = splits(B, n, k, dtype != "f32", cuda)
    assert (S > 1) == many and per % 128 == 0 and (S - 1) * per < n <= S * per
    excl = t(gen.integers(0, n, B).astype(np.int32), cuda)
    for metric in (Metric.L2, Metric.MIPS):
        kw = dict(k=k, metric=metric, n_valid=n)
        before = flat_topk.launches
        got = flat_topk(q, x, None, excl, **kw)
        assert flat_topk.launches == before + 1
        _check_flat(got, flat_topk_plain(q, x, None, excl, **kw), dtype, scale, excl)


def test_torch_cuda_flat_topk_rejects_wide_k(cuda):
    q = torch.zeros((4, 16), device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        flat_topk(q, torch.zeros((300, 16), device=cuda), k=MAX_K + 1,
                  metric=Metric.L2, n_valid=300)


@pytest.fixture(scope="module")
def cluster_data():
    rng = np.random.default_rng(5)
    centers = rng.standard_normal((40, 64))
    X = (centers[rng.integers(0, 40, 6000)]
         + 0.35 * rng.standard_normal((6000, 64))).astype(np.float32)
    Q = (centers[rng.integers(0, 40, 200)]
         + 0.35 * rng.standard_normal((200, 64))).astype(np.float32)
    return X, Q


@pytest.mark.parametrize("n_probe,cut", [(4, 0.0), (16, 0.0), (12, 1.35)])
@pytest.mark.parametrize("metric", ["l2", "mips"])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cuda_cluster_walk_equal(cluster_data, cuda, layout, metric,
                                       n_probe, cut):
    """n_probe 16 makes the beam 32 lanes wide (a 64-lane merge)."""
    X, Q = cluster_data
    ci = build_cluster_index(X, metric=metric, m=32, Rc=16, iters=2,
                             ext_dtype=layout, device=cuda)
    q = t(Q, cuda)
    if ci.qpoints is not None:
        q = quantize.translate_query(q, ci.qpoints).float()
    sd, sid = seed_centroids(q, ci.centroids_q, C=ci.C, S=2,
                             metric=ci.points.metric)
    args = (q, ci.ext, sd.contiguous(), sid.contiguous())
    kw = dict(metric=ci.points.metric, C=ci.C, m=ci.m, Rc=ci.Rc,
              n_points=ci.points.n, n_probe=n_probe, min_probe=2, cut=cut)
    pd, pi, nv = cluster_walk(*args, **kw)
    wd, wi, wnv = cluster_walk_plain(*args, **kw)
    assert torch.equal(nv, wnv)
    assert (nv <= n_probe).all() and (nv >= 1).all()
    if layout == "int8":
        assert torch.equal(pd, wd) and torch.equal(pi, wi)
        return
    # an L2 sum of squares cannot cancel (rtol 1e-5); a negated dot can, so
    # its error is bounded by 1e-5 of the largest magnitude instead
    ok = wi >= 0
    atol = 0.0 if metric == "l2" else 1e-5 * float(wd[ok].abs().max())
    for r in range(len(Q)):
        a = {int(i): float(x) for x, i in zip(pd[r].tolist(), pi[r].tolist()) if i >= 0}
        b = {int(i): float(x) for x, i in zip(wd[r].tolist(), wi[r].tolist()) if i >= 0}
        assert a.keys() == b.keys(), r
        np.testing.assert_allclose([a[i] for i in sorted(a)],
                                   [b[i] for i in sorted(b)], rtol=1e-5, atol=atol)



def _cluster_case(gen, dev, layout, *, C, m, Rc, d, B, S=2, n_points=None,
               int_q=True, ties=False, bad_seeds=False):
    """A random ext array of C clusters in ``layout`` with its queries and
    their S nearest centroids as seeds -> (queries, ext, seed_d, seed_i,
    n_points). Member slots hold empty (-1) and out-of-range ids; adjacent
    lists hold -1, ids >= C and repeats, and their vectors are the listed
    centroids' own. ``ties`` draws members and centroids from 3 vectors;
    with the f32 layout's non-integer queries, a seed's distance (from
    numpy) and a walked copy of its vector's (from the walk) are near-ties
    that any other summation order than the kernel's could flip.
    ``bad_seeds`` gives some queries INF seeds with ids -1 and C + 7, and
    some a finite seed of id -1."""
    n_points = n_points or 4 * C
    int8 = layout == "int8"

    def vecs(shape):
        if ties:
            pool = gen.integers(-20, 21, (3, d))
            return pool[gen.integers(0, 3, shape)]
        return gen.integers(-100, 101, shape + (d,)) if int8 else gen.standard_normal(shape + (d,))

    cents = vecs((C,)).astype(np.float32)
    members = vecs((C, m)).astype(np.float32)
    mid = gen.integers(0, n_points, (C, m))
    mid[gen.random((C, m)) < 0.25] = -1
    mid[gen.random((C, m)) < 0.03] = n_points + 3
    aid = gen.integers(0, C, (C, Rc))
    aid[gen.random((C, Rc)) < 0.1] = -1
    aid[gen.random((C, Rc)) < 0.05] = C + 2
    aid[:, -1] = aid[:, 0]  # a repeat in every list
    avec = cents[aid.clip(0, C - 1)]

    def plane(ids, width):
        ids = np.pad(ids, ((0, 0), (0, d - width)))
        if not int8:
            return ids[:, None, :].astype(np.float32)
        u = ids.astype(np.int64) & 0xFFFFFFFF
        return np.stack([((u >> (8 * k)) & 0xFF).astype(np.uint8).view(np.int8)
                         for k in range(4)], axis=1)

    dt = np.int8 if int8 else np.float32
    ext = np.concatenate([members.astype(dt), plane(mid, m), avec.astype(dt),
                          plane(aid, Rc)], axis=1)
    if int8:
        q = gen.integers(-100, 101, (B, d)).astype(np.float32)
        if not int_q:
            q += 0.5
    else:
        q = gen.standard_normal((B, d)).astype(np.float32)
    dist = ((cents[None, :, :] - q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    sid = np.argsort(dist, axis=1, kind="stable")[:, :S].astype(np.int32)
    sd = np.take_along_axis(dist, sid, 1).astype(np.float32)
    if bad_seeds and B >= 3 and S >= 2:
        sd[0::3, -1] = INF32
        sid[0::3, -1] = -1
        sd[1::3, -1] = INF32
        sid[1::3, -1] = C + 7
        sid[2::3, 0] = -1
    return (t(q, dev), t(ext, dev), t(sd, dev), t(sid, dev), n_points)


def _check_cluster(got, want, what=""):
    """Kernel 5 against its plain version: every output equal, on both
    layouts (the plain version sums f32 distances in the kernel's order)."""
    for a, b, name in zip(got, want, ("pool dists", "pool ids", "expansions")):
        assert torch.equal(a, b), f"{what} {name}"


def _cluster_walks(args, n_points, metric, **kw):
    q, ext, sd, sid = args
    C = ext.shape[0]
    m, Rc = kw.pop("m"), kw.pop("Rc")
    kw = dict(metric=metric, C=C, m=m, Rc=Rc, n_points=n_points, **kw)
    before = cluster_walk.launches
    got = cluster_walk(q, ext, sd, sid, **kw)
    assert cluster_walk.launches == before + (q.is_cuda and q.shape[0] > 0)
    return got, cluster_walk_plain(q, ext, sd, sid, **kw)


@pytest.mark.parametrize("m,Rc,d", [(8, 8, 20), (64, 16, 128), (128, 32, 128),
                                    (8, 32, 40), (64, 8, 100), (40, 16, 40)])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cuda_cluster_walk_shapes(gen, cuda, layout, metric, m, Rc, d):
    """m and Rc at and below the register walk's 128 and 32; d = 20, 40 and
    100 load 4, 8 and 4 bytes (int8) or 16, 16 and 16 (f32) at a time."""
    *args, n = _cluster_case(gen, cuda, layout, C=120, m=m, Rc=Rc, d=d, B=200)
    got, want = _cluster_walks(args, n, metric, m=m, Rc=Rc, n_probe=12)
    _check_cluster(got, want)
    assert bool((got[2] == 12).any())


@pytest.mark.parametrize("B", [0, 1, 33, 6000])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cuda_cluster_walk_batch_sizes(gen, cuda, layout, B):
    """6000 queries are more than the persistent grid's warps."""
    *args, n = _cluster_case(gen, cuda, layout, C=300, m=64, Rc=16, d=64, B=B)
    got, want = _cluster_walks(args, n, Metric.L2, m=64, Rc=16, n_probe=8)
    assert got[0].shape == (B, 4 * 64) and got[2].shape == (B,)
    _check_cluster(got, want)


@pytest.mark.parametrize("n_probe,S,m,Rc,d", [
    (40, 2, 8, 8, 20),      # Wc = 64
    (8, 40, 8, 8, 20),      # S = 40 seeds: Wc = 64
    (200, 2, 8, 8, 20),     # Wc = 256
    (900, 2, 8, 8, 20),     # Wc = 1024
    (12, 2, 160, 16, 160),  # m past 128
    (12, 2, 16, 40, 48),    # Rc past 32
])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cuda_cluster_walk_smem(gen, cuda, layout, n_probe, S, m, Rc, d):
    """Beams past 32 lanes, more than 32 adjacent centroids or more than
    128 members run the shared-memory walk."""
    C = 1200 if n_probe > 100 else 200
    *args, n = _cluster_case(gen, cuda, layout, C=C, m=m, Rc=Rc, d=d, B=48, S=S)
    for metric in (Metric.L2, Metric.MIPS):
        got, want = _cluster_walks(args, n, metric, m=m, Rc=Rc, n_probe=n_probe)
        _check_cluster(got, want)
    if n_probe > 32:  # the walks outgrow a register beam
        assert int(got[2].max()) > 32


def test_torch_cuda_cluster_walk_rejects_wide_beam(cuda):
    q = torch.zeros((2, 16), device=cuda)
    ext = torch.zeros((4, 8 + 8 + 2, 16), device=cuda)
    sd = torch.zeros((2, 1), device=cuda)
    sid = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        cluster_walk(q, ext, sd, sid, metric=Metric.L2, C=4, m=8, Rc=8,
                     n_points=10, n_probe=1021)


@pytest.mark.parametrize("case", ["float_query", "ties", "bad_seeds"])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cuda_cluster_walk_inputs(gen, cuda, layout, case):
    """A non-integer query on the int8 layout (the f32 arm); members and
    centroids drawn from three vectors (ties, broken by pack and by the
    pool's strict <); INF seeds with ids -1 and >= C, and finite seeds of
    id -1, which end a walk when they come first."""
    *args, n = _cluster_case(gen, cuda, layout, C=150, m=32, Rc=16, d=48, B=120, S=3,
                          int_q=case != "float_query", ties=case == "ties",
                          bad_seeds=case == "bad_seeds")
    for metric in (Metric.L2, Metric.MIPS):
        got, want = _cluster_walks(args, n, metric, m=32, Rc=16, n_probe=10)
        _check_cluster(got, want, f"{case} {metric}")
    if case == "bad_seeds":
        assert bool((got[2][2::3] == 0).all()) and bool((got[2][0::3] > 0).all())


@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("layout", ["int8", "f32"])
def test_torch_cuda_cluster_walk_cut(gen, cuda, layout, metric):
    """cut with min_probe: L2 stops early past min_probe; MIPS ignores the
    cut and walks n_probe."""
    *args, n = _cluster_case(gen, cuda, layout, C=200, m=32, Rc=16, d=48, B=150)
    for min_probe, cut in ((0, 1.2), (3, 1.05), (2, 1.35)):
        got, want = _cluster_walks(args, n, metric, m=32, Rc=16, n_probe=14,
                          min_probe=min_probe, cut=cut)
        _check_cluster(got, want)
        nv = got[2]
        assert bool((nv >= 1).all())
        if metric is Metric.L2:
            assert bool((nv < 14).any())
        else:
            assert bool((nv == 14).any())


def _bit_case(gen, dev, n_pad, R8, W, B):
    """Random int32 words over the full range (bit 31 set in about half)."""
    info = np.iinfo(np.int32)
    inl = t(gen.integers(info.min, info.max, (n_pad, R8, W), endpoint=True,
                         dtype=np.int32), dev)
    ids = t(gen.integers(-3, n_pad + 3, B).astype(np.int32), dev)  # clamped
    q = t(gen.integers(info.min, info.max, (B, W), endpoint=True, dtype=np.int32), dev)
    return inl, ids, q


@pytest.mark.parametrize("R8", [16, 32, 64])
@pytest.mark.parametrize("W", [1, 3, 4, 16, 32])
def test_torch_cuda_expand_bits_equal(gen, cuda, W, R8):
    """W = 4, 16, 32 take the 16-byte-load path, 1 and 3 the generic one;
    the bits=1 route of expand_distances is the same kernel."""
    inl, ids, q = _bit_case(gen, cuda, 300, R8, W, 777)
    assert bool((inl < 0).any()) and bool((q < 0).any())
    want = expand_bits_flat_plain(inl, ids, q)
    before = expand_bits_flat.launches
    assert torch.equal(expand_bits_flat(inl, ids, q), want)
    assert torch.equal(expand_distances(inl, ids, q, metric=Metric.L2, bits=1), want)
    assert expand_bits_flat.launches == before + 2
    assert torch.equal(expand_distances_plain(inl, ids, q, metric=Metric.L2, bits=1),
                       want)


def test_torch_cuda_expand_bits_unaligned_queries(gen, cuda):
    """A query array that starts 4 bytes off a 16-byte boundary takes the
    generic loop and gives the same counts."""
    inl, ids, q = _bit_case(gen, cuda, 200, 32, 4, 100)
    flat = torch.empty(q.numel() + 1, dtype=torch.int32, device=cuda)
    q_off = flat[1:].view(q.shape)
    q_off.copy_(q)
    assert q_off.data_ptr() % 16 == 4
    assert torch.equal(expand_bits_flat(inl, ids, q_off), expand_bits_flat_plain(inl, ids, q))


def test_torch_cuda_expand_bits_rejects_bad_input(cuda):
    inl = torch.zeros((8, 8, 4), dtype=torch.int32, device=cuda)
    ids = torch.zeros(4, dtype=torch.int32, device=cuda)
    q = torch.zeros((4, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        expand_bits_flat(inl.float(), ids, q)
    with pytest.raises(ValueError, match="int32"):
        expand_bits_flat(inl, ids, q.float())
    with pytest.raises(ValueError, match="shape mismatch"):
        expand_bits_flat(inl, ids, q[:, :3].contiguous())
    with pytest.raises(ValueError, match="shape mismatch"):
        expand_bits_flat(inl, ids[:3], q)
    with pytest.raises(ValueError, match="dims"):
        expand_bits_flat(inl[0], ids, q)
    with pytest.raises(ValueError, match="contiguous"):
        expand_bits_flat(inl, ids, q.t())
    with pytest.raises(ValueError, match="device"):
        expand_bits_flat(inl, ids.cpu(), q)


def test_torch_cuda_bit_tier_search_equals_cpu(cluster_data, cuda):
    """The bit tier's Index.batch_search on the card (kernel 6) equals the
    same search on the CPU (the plain version): beams, visits and distance
    counts exactly; the reranked f32 distances to rtol 1e-5."""
    X, Q = cluster_data
    g, ps, _ = build_vamana_index(X[:3000], R=16, L=32, device="cpu")
    idx = {}
    for dev in ("cpu", cuda):
        pts = interop.pointset_from_state(ps.data.numpy(), ps.n, ps.d, ps.metric,
                                          device=dev)
        gr = interop.graph_from_state(g.neighbors.numpy(), g.degrees.numpy(), g.n,
                                      g.max_degree, device=dev)
        idx[str(dev)] = Index(points=pts, graph=gr).enable_bit_tier()
    before = expand_bits_flat.launches
    got = idx[str(cuda)].batch_search(Q, k=10, beam_size=48, rerank_factor=4)
    assert expand_bits_flat.launches > before
    want = idx["cpu"].batch_search(Q, k=10, beam_size=48, rerank_factor=4)
    for name in ("beam_ids", "beam_dists", "num_visited", "dist_cmps"):
        assert torch.equal(getattr(got[2], name).cpu(), getattr(want[2], name)), name
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)


def test_torch_cuda_f32_tier_and_lock_step_search(cluster_data, cuda):
    """The f32 build and the lock-step searches on the card: the build
    launches kernel 2's f32 mode, the f32 tier's search kernel 1's f32 mode
    and the q8 tier's expand=2 and degree_limit < R searches its int8 mode;
    recall@10 against exact ground truth stays near the CPU build's (0.999
    f32, 0.9995 at expand=2, 0.917 at degree_limit=12 on the CPU)."""
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.search.exact import compute_groundtruth

    X, Q = cluster_data
    before = occlusion_rounds.launches_f32
    g, ps, _ = build_vamana_index(X[:3000], R=16, L=32, quantize_build=False, device=cuda)
    assert occlusion_rounds.launches_f32 > before and ps.data.dtype == torch.float32
    gt, gt_d = compute_groundtruth(ps, Q, 20)
    idx = Index(points=ps, graph=g)
    f32_before = expand_distances.launches_f32
    ids, _, res = idx.batch_search(Q, k=10, beam_size=32)
    assert expand_distances.launches_f32 > f32_before and idx.inline.dtype == torch.float32
    assert compute_recall(ids.cpu().numpy(), gt, gt_d, 10) >= 0.95
    idx.enable_quantized(bits=8)
    for kw, floor in ((dict(expand=2), 0.95), (dict(degree_limit=12), 0.85)):
        n, n_f32 = expand_distances.launches, expand_distances.launches_f32
        ids, _, _ = idx.batch_search(Q, k=10, beam_size=32, **kw)
        assert expand_distances.launches > n and expand_distances.launches_f32 == n_f32
        assert idx.inline.dtype == torch.int8
        assert compute_recall(ids.cpu().numpy(), gt, gt_d, 10) >= floor, kw


@pytest.mark.parametrize("k", [1, 10, 50, 64, 128, 256])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_cuda_flat_topk_masked_hnsw_shapes(gen, cuda, dtype, k):
    """Kernel 4's masked mode at HNSW's exact-scan shapes (a level of 5,300
    members of d = 128, up to the steady batch of 2,000 rows, k up to 256
    across the selection's four paths): random, prefix, all-false, all-true
    masks and one keeping fewer points than k, each row excluding one id,
    in or outside the mask, under L2 and MIPS. Every call launches the
    kernel once."""
    n, d = 5300, 128
    x, q, scale = _flat_case(gen, cuda, dtype, n, d, 2000)
    masks = {"random": gen.random(n) < 0.5, "prefix": np.arange(n) < 1300,
             "none": np.zeros(n, bool), "all": np.ones(n, bool),
             "few": gen.permutation(n) < max(k // 2, 1)}
    for B in (0, 1, 256, 2000):
        for name, m in masks.items():
            mk = t(m, cuda)
            ex = t(gen.integers(0, n, B).astype(np.int32), cuda)
            for metric in (Metric.L2, Metric.MIPS):
                kw = dict(k=k, metric=metric, n_valid=n)
                before = flat_topk.launches
                got = flat_topk(q[:B], x, mk, ex, **kw)
                assert flat_topk.launches == before + (B > 0)
                want = flat_topk_plain(q[:B], x, mk, ex, **kw)
                _check_flat(got, want, dtype, scale[:B], ex)
                if name == "none":
                    assert not (got[0] >= 0).any()
                else:
                    assert bool(mk[got[0][got[0] >= 0].long()].all())


@pytest.mark.parametrize("B,n_in", [(256, 128), (2000, 48_000), (2000, 100_000)])
def test_torch_cuda_flat_topk_masked_exact_build_prefix(gen, cuda, B, n_in):
    """The exact-candidate build's shape: 100K int8 points of d = 128, the
    inserted prefix of a random order as the mask (a doubling batch's 128,
    about half, all), each row excluding its own id (-1 on pad rows), k =
    64, n_valid below the padded rows: bit-equal to the plain version."""
    n_pad, n_valid, d, k = 100_032, 100_000, 128, 64
    x = t(gen.integers(-128, 128, (n_pad, d)).astype(np.int8), cuda)
    order = gen.permutation(n_valid)
    m = np.zeros(n_pad, bool)
    m[order[:n_in]] = True
    rows = order[n_in // 2:n_in // 2 + B] if n_in < n_valid else order[:B]
    q = x[t(rows.astype(np.int64), cuda)].float()
    ex = t(np.where(np.arange(B) < B - 7, rows, -1).astype(np.int32), cuda)
    kw = dict(k=k, metric=Metric.L2, n_valid=n_valid)
    got = flat_topk(q, x, t(m, cuda), ex, **kw)
    want = flat_topk_plain(q, x, t(m, cuda), ex, **kw)
    _check_flat(got, want, "int8", None, ex)
    assert bool((got[0] >= 0).all())


def _same_hierarchy(a, b):
    np.testing.assert_array_equal(a.entrances, b.entrances)
    assert len(a.levels) == len(b.levels)
    for la, lb in zip(a.levels, b.levels):
        np.testing.assert_array_equal(la.members, lb.members)
        ml = len(la.members)
        da, db = la.degs[:ml].cpu(), lb.degs[:ml].cpu()
        assert torch.equal(da, db)
        mask = torch.arange(la.cap)[None, :] < da[:, None]
        assert torch.equal(torch.where(mask, la.nbrs[:ml].cpu(), -1),
                           torch.where(mask, lb.nbrs[:ml].cpu(), -1))


def test_torch_cuda_hnsw_q8_build_equals_cpu(cluster_data, cuda):
    """The q8 HNSW build at n = 1500 (every level scanned exactly: kernel 4
    with mask and exclusion, kernel 2 in int8) equals the CPU build, whose
    distances are the same integers; so does the search (kernel 3)."""
    X, Q = cluster_data
    before = (flat_topk.launches, occlusion_rounds.launches)
    built = {str(dev): build_hnsw_index(X[:1500], m=8, efc=16, quantize_build=True,
                                        batch_cap_frac=0.1, device=dev)[0]
             for dev in ("cpu", cuda)}
    assert flat_topk.launches > before[0] and occlusion_rounds.launches > before[1]
    _same_hierarchy(built[str(cuda)], built["cpu"])
    n = beam_search_fused.launches
    got = built[str(cuda)].batch_search(Q, k=10, ef=32)
    assert beam_search_fused.launches > n
    want = built["cpu"].batch_search(Q, k=10, ef=32)
    assert torch.equal(got[0].cpu(), want[0])
    torch.testing.assert_close(got[1].cpu(), want[1], rtol=1e-5, atol=0)


def test_torch_cuda_hnsw_uint8_build_equals_cpu(cluster_data, cuda):
    """uint8 points with ``quantize_build=False`` (the default) build on an
    exact float32 copy: the card's build launches kernel 2's f32 mode and
    equals the CPU build (every distance an integer below 2^24)."""
    X, _ = cluster_data
    U = np.round((X[:1500] - X.min()) / (X.max() - X.min()) * 255).astype(np.uint8)
    before = occlusion_rounds.launches_f32
    built = {str(dev): build_hnsw_index(U, m=8, efc=16, batch_cap_frac=0.1, device=dev)[0]
             for dev in ("cpu", cuda)}
    assert occlusion_rounds.launches_f32 > before
    assert built[str(cuda)].levels[0].points_l.dtype == torch.uint8
    _same_hierarchy(built[str(cuda)], built["cpu"])


def test_torch_cuda_hnsw_q8_beam_level_equals_cpu(cluster_data, cuda, monkeypatch):
    """Level 0 through the efc-beam (FLAT_LEVEL_MAX lowered to 512) with
    inline rows on the card (kernel 1 on int8 rows; INLINE_MIN_ROWS lowered
    to 64), against the CPU build, which gathers rows: equal."""
    X, _ = cluster_data
    monkeypatch.setattr(hnsw, "FLAT_LEVEL_MAX", 512)
    monkeypatch.setattr(hnsw, "INLINE_MIN_ROWS", 64)
    n = expand_distances.launches
    built = {str(dev): build_hnsw_index(X[:3000], m=8, efc=16, quantize_build=True,
                                        batch_cap_frac=0.1, device=dev)[0]
             for dev in ("cpu", cuda)}
    assert expand_distances.launches > n
    _same_hierarchy(built[str(cuda)], built["cpu"])



def _bar(a, b, gt, Q, *, deg_tol=0.5, recall_tol=0.01, **search):
    """Two graphs over the same points: average degrees within ``deg_tol``,
    recall@10 of their q8 searches within ``recall_tol`` (the graph-build parity bar
    by default)."""
    (ga, pa), (gb, pb) = a, b
    assert abs(ga.stats()[0] - gb.stats()[0]) <= deg_tol
    ra = compute_recall(Index(points=pa, graph=ga).enable_quantized(8).batch_search(
        Q, k=10, **search)[0].cpu().numpy(), *gt, 10)
    rb = compute_recall(Index(points=pb, graph=gb).enable_quantized(8).batch_search(
        Q, k=10, **search)[0].cpu().numpy(), *gt, 10)
    assert abs(ra - rb) <= recall_tol, (ra, rb)


# The card's own draws give another random graph than the CPU's: held to
# the sanity bound of the CPU tests' own-draws builds (degree within 1.0,
# recall within 0.03) at a beam past the steep part of the recall curve
# (at beam 10 HCNNG's card draws gave 0.9155 against the CPU's 0.936)
OWN_DRAWS = dict(deg_tol=1.0, recall_tol=0.03)


@pytest.mark.parametrize("draws", ["host", "card"])
def test_torch_cuda_hcnng_build_matches_cpu(cluster_data, cuda, draws):
    """The f32 HCNNG build at n = 1500 on the card against the CPU build of
    the same seed. With the host's draws (``Draws(host=True)``) the two
    differ only where the card sums distances in another order: the
    graph-build parity bar at beam 10. With the card's generator, the default: the
    sanity bound at beam 24. The card's q8 search launches kernel 3."""
    X, Q = cluster_data
    bp = BuildParams(num_clusters=8, cluster_size=150, MST_deg=3)
    built = {}
    for dev in ("cpu", cuda):
        ps = PointSet.from_numpy(X[:1500], device=dev)
        dr = Draws(0, dev, host=True) if draws == "host" else None
        built[str(dev)] = hcnng.build_hcnng_graph(ps, bp, draws=dr)[0], ps
    g = built[str(cuda)][0]
    assert g.neighbors.is_cuda and g.max_degree == 24
    gt = compute_groundtruth(built["cpu"][1], Q, 20)
    n = beam_search_fused.launches
    if draws == "host":
        _bar(built[str(cuda)], built["cpu"], gt, Q, beam_size=10)
    else:
        _bar(built[str(cuda)], built["cpu"], gt, Q, beam_size=24, **OWN_DRAWS)
    assert beam_search_fused.launches > n


@pytest.mark.parametrize("quantize_build,draws", [(True, "host"), (False, "host"),
                                                  (False, "card")])
def test_torch_cuda_pynn_build_matches_cpu(gen, cuda, quantize_build, draws):
    """pyNNDescent at n = 1500 on the card against the CPU build of the
    same seed. With the host's draws (``Draws(host=True)``) the q8 build
    (every distance an integer) equals it row for row, and so does its
    random-start search through kernel 3; the f32 build is held to the
    graph-build parity bar. With the card's generator, the default, the f32 build is
    held to the sanity bound. Kernel 2 launches in the build's mode."""
    X = gen.standard_normal((1500, 32)).astype(np.float32)
    Q = gen.standard_normal((200, 32)).astype(np.float32)
    bp = BuildParams(R=20, cluster_size=80, num_clusters=6, alpha=1.2, delta=0.05)
    before = (occlusion_rounds.launches, occlusion_rounds.launches_f32)
    built = {}
    for dev in ("cpu", cuda):
        ps = PointSet.from_numpy(X, device=dev)
        dr = Draws(0, dev, host=True) if draws == "host" else None
        g, _ = pynndescent.build_pynndescent_graph(
            ps, bp, quantize_build=quantize_build, draws=dr)
        built[str(dev)] = (g, ps)
    n_f32 = occlusion_rounds.launches_f32 - before[1]
    n_int8 = occlusion_rounds.launches - before[0] - n_f32
    assert (n_int8 if quantize_build else n_f32) > 0
    (gc, pc), (gg, pg) = built["cpu"], built[str(cuda)]
    search = dict(beam_size=16, random_starts=1, seed=3)
    if quantize_build:
        assert torch.equal(gg.degrees.cpu(), gc.degrees)
        mask = torch.arange(20)[None, :] < gc.degrees[:, None]
        assert torch.equal(torch.where(mask, gg.neighbors.cpu(), -1),
                           torch.where(mask, gc.neighbors, -1))
        n = beam_search_fused.launches
        got = Index(points=pg, graph=gg).enable_quantized(8).batch_search(Q, k=10, **search)
        assert beam_search_fused.launches > n
        want = Index(points=pc, graph=gc).enable_quantized(8).batch_search(Q, k=10, **search)
        assert torch.equal(got[0].cpu(), want[0])
    elif draws == "host":
        _bar((gg, pg), (gc, pc), compute_groundtruth(pc, Q, 20), Q, **search)
    else:
        _bar((gg, pg), (gc, pc), compute_groundtruth(pc, Q, 20), Q,
             **dict(search, beam_size=32), **OWN_DRAWS)


def test_torch_cuda_draws_on_the_card(cuda):
    """A card build's default draws come from the card's generator, land
    on the card, in range, and repeat for a seed; ``host=True`` gives the
    CPU's draws on the card."""
    a, b = Draws(1, cuda), Draws(1, cuda)
    assert a.gen.device.type == "cuda"
    x = a.tree_bits(0, 0, 10_000)
    assert x.is_cuda and x.dtype == torch.int32 and torch.equal(x, b.tree_bits(0, 0, 10_000))
    c1, c2 = a.hops(0, 100, 16, 16, 80)
    assert c2.is_cuda and int(c2.min()) >= 0 and int(c2.max()) < 80
    assert torch.equal(Draws(1, cuda, host=True).tree_bits(0, 0, 1000).cpu(),
                       Draws(1).tree_bits(0, 0, 1000))


def test_torch_cuda_range_search_equals_cpu(gen, cuda):
    """range_search_batch and self_join on integer-valued (uint8) points on
    the card: every distance is an exact float32 integer, so ids, dists,
    counts, comparisons and the self-join's lists equal the CPU's."""
    from parlayann_tpu_torch.search.range import range_search_batch, self_join

    n, d = 3000, 32
    X = gen.integers(0, 256, (n, d)).astype(np.uint8)
    X[:1000] = np.clip(X[:1] + gen.integers(-3, 4, (1000, d)), 0, 255)  # a dense clump
    graph, ps, _ = build_vamana_index(X, R=16, L=32, alpha=1.0, quantize_build=False,
                                      device="cpu")
    rad = 150.5  # half-integer: no exact distance lies on it
    rows = np.arange(0, n, 11, dtype=np.int32)
    out = {}
    for dev in ("cpu", cuda):
        pts, nb, dg = ps.data.to(dev), graph.neighbors.to(dev), graph.degrees.to(dev)
        st = t(np.where(np.arange(16)[None, :] < graph.degrees.numpy()[rows][:, None],
                        graph.neighbors.numpy()[rows], -1).astype(np.int32), dev)
        rr = range_search_batch(pts[t(rows, dev).long()], pts, nb, dg, st, rad,
                                t(rows, dev), metric=Metric.L2, n_valid=n, cap=64,
                                exclude_self=True)
        sj = self_join(pts, nb, dg, rad, rad, metric=Metric.L2, n_valid=n, batch=1024)
        out[str(dev)] = ([x.cpu() for x in rr], sj)
    (rc, sc), (rg, sg) = out["cpu"], out[str(cuda)]
    for a, b in zip(rg, rc):
        assert torch.equal(a, b)
    assert int(rc[2].sum()) > 0 and (rc[2] == 64).any()  # some sets reach the cap
    assert sg[1] == sc[1] and len(sg[0]) == len(sc[0]) == n
    assert sum(len(r) for r in sc[0]) > 0
    assert all(np.array_equal(a, b) for a, b in zip(sg[0], sc[0]))


@pytest.mark.parametrize("dtype,Cm,cap,B", [("f32", 4070, 112, 8192), ("int8", 24415, 24, 10000)])
def test_torch_cuda_expand_distances_meta_blocks(gen, cuda, dtype, Cm, cap, B):
    """Kernel 1 on the meta quantizers' cell blocks at the 10M shapes: the
    build router's f32 blocks (R8 = 112: the f32 mode's last pass of 32
    rows is partial) and the query seed's int8 blocks (R8 = 24)."""
    if dtype == "f32":
        blocks = t(gen.standard_normal((Cm, cap, 128)).astype(np.float32), cuda)
        q = t(gen.standard_normal((B, 128)).astype(np.float32), cuda)
    else:
        blocks = t(gen.integers(-128, 128, (Cm, cap, 128)).astype(np.int8), cuda)
        q = t(gen.integers(-128, 128, (B, 128)).astype(np.float32), cuda)
    ids = t(gen.integers(0, Cm, B).astype(np.int32), cuda)
    for metric in (Metric.L2, Metric.MIPS):
        got = expand_distances(blocks, ids, q, metric=metric)
        assert got.shape == (B, cap)
        assert torch.equal(got, expand_distances_plain(blocks, ids, q, metric=metric))


def _multi_case(gen, dev, dtype, Cm, cap, d, B, E, ids=None):
    if dtype == "f32":
        blocks = t(gen.standard_normal((Cm, cap, d)).astype(np.float32), dev)
        q = t(gen.standard_normal((B, d)).astype(np.float32), dev)
    else:
        blocks = t(gen.integers(-128, 128, (Cm, cap, d)).astype(np.int8), dev)
        q = t(gen.integers(-128, 128, (B, d)).astype(np.float32), dev)
    if ids is None:
        ids = gen.integers(-2, Cm + 2, (B, E))  # a few out of range: clamped
    return blocks, t(np.asarray(ids, dtype=np.int32), dev), q


def _check_multi(blocks, ids, q, metric):
    """The multi mode against its plain version and the single mode's
    launches stacked, bit for bit, with one launch counted."""
    before = (expand_distances_multi.launches, expand_distances_multi.launches_f32)
    got = expand_distances_multi(blocks, ids, q, metric=metric)
    B, E = ids.shape
    n, f32 = int(B * E > 0), int(B * E > 0 and blocks.dtype == torch.float32)
    assert (expand_distances_multi.launches, expand_distances_multi.launches_f32) == (
        before[0] + n, before[1] + f32)
    assert got.shape == (B, E, blocks.shape[1])
    assert torch.equal(got, expand_distances_multi_plain(blocks, ids, q, metric=metric))
    if B > 0:
        single = torch.stack([expand_distances(blocks, ids[:, e].contiguous(), q, metric=metric)
                              for e in range(E)], dim=1)
        assert torch.equal(got, single)


@pytest.mark.parametrize("dtype,Cm,cap,d,B,E", [
    ("f32", 4070, 112, 128, 16384, 16),   # the 10M build's router chunk
    ("int8", 24415, 24, 128, 10000, 16),  # the 10M query seed
    ("f32", 300, 40, 100, 999, 3),        # 400-byte rows: bulk copies
    ("int8", 300, 24, 100, 999, 3),       # 100-byte rows: cp.async of 4 bytes
    ("f32", 300, 32, 21, 500, 5),         # 84-byte rows
    ("f32", 40, 112, 512, 300, 4),        # 229 KB blocks: three row tiles
    ("f32", 10, 16, 64, 0, 16),           # B = 0
])
def test_torch_cuda_expand_multi_equal(gen, cuda, dtype, Cm, cap, d, B, E):
    """Kernel 1's multi-probe mode equals its plain version and the single
    mode's launches stacked, bit for bit, under L2 and MIPS: at the 10M
    router's and seed's shapes, on rows whose bytes are not 16-byte
    multiples (d = 100 int8, d = 21 f32), on blocks that do not fit twice in
    shared memory, and at B = 0."""
    blocks, ids, q = _multi_case(gen, cuda, dtype, Cm, cap, d, B, E)
    for metric in (Metric.L2, Metric.MIPS):
        _check_multi(blocks, ids, q, metric)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_cuda_expand_multi_hot_block(gen, cuda, dtype):
    """Every pair on one block (one cell's 32,000 pairs spread over 1,000
    work items), and half the pairs on one block beside random ones."""
    B, E = 2000, 16
    ids = np.full((B, E), 7)
    blocks, ids, q = _multi_case(gen, cuda, dtype, 50, 112 if dtype == "f32" else 24, 128,
                                 B, E, ids=ids)
    _check_multi(blocks, ids, q, Metric.L2)
    mixed = np.where(gen.random((B, E)) < 0.5, 7, gen.integers(0, 50, (B, E)))
    _check_multi(blocks, t(mixed.astype(np.int32), cuda), q, Metric.MIPS)


def test_torch_cuda_expand_multi_misaligned_rows(gen, cuda):
    """A view whose f32 rows start 4 bytes past a 16-byte boundary takes
    the cp.async path and gives the same distances."""
    blocks, ids, q = _multi_case(gen, cuda, "f32", 300, 32, 128, 700, 4)
    flat = torch.empty(blocks.numel() + 4, dtype=torch.float32, device=cuda)
    view = flat[1:1 + blocks.numel()].view(blocks.shape)
    view.copy_(blocks)
    assert torch.equal(expand_distances_multi(view, ids, q, metric=Metric.L2),
                       expand_distances_multi_plain(blocks, ids, q, metric=Metric.L2))


def test_torch_cuda_expand_multi_rejects_bad_input(cuda):
    """Inputs the multi mode does not take raise, on the card, before any
    launch; nothing falls back to the single mode or the plain version."""
    blocks = torch.zeros((8, 8, 16), device=cuda)
    ids = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    q = torch.zeros((4, 16), device=cuda)
    before = expand_distances_multi.launches
    with pytest.raises(ValueError, match="int8"):
        expand_distances_multi(blocks.to(torch.int16), ids, q, metric=Metric.L2)
    with pytest.raises(ValueError, match="int32"):
        expand_distances_multi(blocks, ids.long(), q, metric=Metric.L2)
    with pytest.raises(ValueError, match="2 dims"):
        expand_distances_multi(blocks, ids[:, 0].contiguous(), q, metric=Metric.L2)
    with pytest.raises(ValueError, match="float32"):
        expand_distances_multi(blocks, ids, q.double(), metric=Metric.MIPS)
    with pytest.raises(ValueError, match="shape"):
        expand_distances_multi(blocks, ids, q[:3].contiguous(), metric=Metric.L2)
    with pytest.raises(ValueError, match="contiguous"):
        expand_distances_multi(blocks, ids.T, q[:2].contiguous(), metric=Metric.L2)
    with pytest.raises(ValueError, match="device"):
        expand_distances_multi(blocks, ids.cpu(), q, metric=Metric.L2)
    assert expand_distances_multi.launches == before


def test_torch_cuda_approx_assign_equals_cpu(cluster_data, cuda):
    """``approx_assign`` on the card against the CPU with one meta quantizer
    (built on the CPU: the card's k-means sums with atomics): distances
    equal where the ids are (kernel 1's f32 order is replayed), and ids
    equal but where the meta-centroid scan's P-th and (P + 1)-th cells or
    the k-th candidates tie within rtol 1e-5."""
    from parlayann_tpu_torch.build import clusterindex as tci

    X, _ = cluster_data
    xc = torch.from_numpy(X)
    cents = tci.kmeans(xc, 6000, 300, metric=Metric.L2, iters=2, seed=0)
    quant = tci._meta_quantizer(cents, 300, Metric.L2, meta_m=24, seed=0)
    P, k = 3, 8
    ci, cd = tci.approx_assign(xc, 6000, cents, 300, k, Metric.L2, P=P, quantizer=quant)
    before = (expand_distances.launches, expand_distances_multi.launches,
              expand_distances_multi.launches_f32)
    gi, gd = tci.approx_assign(xc.to(cuda), 6000, cents.to(cuda), 300, k, Metric.L2, P=P,
                               quantizer=tuple(a.to(cuda) for a in quant))
    # one chunk of 6,000 points: one multi launch over its P probes, and no
    # single-mode launch
    chunks = -(-6000 // tci._kmeans_chunk_for(quant[1].shape[0]))
    assert (expand_distances.launches, expand_distances_multi.launches,
            expand_distances_multi.launches_f32) == (
        before[0], before[1] + chunks, before[2] + chunks)
    same = (gi == ci).all(axis=1)
    np.testing.assert_array_equal(gd[same], cd[same])
    mc = quant[0].double().numpy()
    md = np.sort(((X[~same][:, None, :].astype(np.float64) - mc[None]) ** 2).sum(-1), axis=1)
    cell_tie = md[:, P] - md[:, P - 1] <= 1e-5 * md[:, P]
    s = np.sort(cd[~same], axis=1)
    cand_tie = (np.diff(s, axis=1) <= 1e-5 * np.abs(s[:, 1:])).any(axis=1)
    assert (cell_tie | cand_tie).all(), np.flatnonzero(~same)


def test_torch_cuda_hier_build_and_meta_seed(cluster_data, cuda, monkeypatch):
    """A hierarchical build on the card (``EXACT_LIMIT`` lowered) with the
    meta-routed query seed (``ARGMIN_SEED_CUTOFF`` lowered): kernel 1 runs
    on f32 router blocks and on int8 seed blocks, the partition is whole,
    and recall@10 at n_probe 8 is at least 0.9."""
    from parlayann_tpu_torch.build import clusterindex as tci
    from parlayann_tpu_torch.ops.kernels import clusterbeam as tcb

    X, Q = cluster_data
    monkeypatch.setattr(tci, "EXACT_LIMIT", 1.0)
    monkeypatch.setattr(tcb, "ARGMIN_SEED_CUTOFF", 8)
    multi = expand_distances_multi
    f32, single = multi.launches_f32, expand_distances.launches
    ci = build_cluster_index(X, m=32, Rc=16, ext_dtype="int8", device=cuda)
    assert multi.launches_f32 > f32 and ci.seed_meta is not None
    assert ci.seed_meta[1].dtype == torch.int8
    got = ci.members[ci.members >= 0]
    assert len(got) == 6000 and len(np.unique(got)) == 6000
    i8 = multi.launches - multi.launches_f32
    ids, _, _ = ci.search(t(Q, cuda), k=10, n_probe=8, cut=0.0, seed_probes=4)
    assert multi.launches - multi.launches_f32 > i8
    assert expand_distances.launches == single  # the router and seed: multi mode only
    gt_i, gt_d = compute_groundtruth(PointSet.from_numpy(X, device="cpu"), Q, 20)
    assert compute_recall(ids.cpu().numpy(), gt_i, gt_d, 10) >= 0.9


def test_torch_cuda_native_balance_matches_numpy(cuda):
    """The host library's balancer, built by this machine's g++, against the
    numpy ``balance_assign`` (tests/test_cluster.py:232-253's inputs)."""
    from parlayann_tpu_torch import native
    from parlayann_tpu_torch.build import clusterindex as tci

    rng = np.random.default_rng(3)
    n, C, m, k = 20000, 400, 64, 8
    ids = rng.integers(0, C, (n, k)).astype(np.int32)
    ids[rng.random((n, k)) < 0.05] = -1
    d = rng.random((n, k)).astype(np.float32)
    order = np.argsort(d[:, 0], kind="stable").astype(np.int64)
    np.testing.assert_array_equal(native.balance_assign(ids, order, C, m),
                                  tci.balance_assign(ids, d, C, m))


_NCCL_MODES = r'''
import json, sys
import numpy as np, torch, torch.distributed as dist
out_dir = sys.argv[1]
torch.cuda.set_device(0)
dist.init_process_group("nccl", init_method=f"file://{out_dir}/store", rank=0, world_size=1,
                        device_id=torch.device("cuda", 0))
from parlayann_tpu_torch.ops.kernels.occlude import occlusion_rounds
from parlayann_tpu_torch.parallel.mesh import make_mesh, make_mesh_1d
from parlayann_tpu_torch.parallel.sharded import build_sharded_vamana, sharded_search
from parlayann_tpu_torch.parallel.global_build import build_global_vamana, global_search
from parlayann_tpu_torch.types import BuildParams

rng = np.random.default_rng(5)
X = rng.standard_normal((3000, 32)).astype(np.float32)
XI = rng.integers(-40, 41, (3000, 32)).astype(np.int8)
Q = rng.standard_normal((200, 32)).astype(np.float32)
bp = BuildParams(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.1)
mesh, mesh1, cpu = make_mesh(), make_mesh_1d(), make_mesh(device="cpu")
res = {"backends": [mesh.backend, mesh1.backend, cpu.backend]}
arrays = {}
for name, build, search, m in (("replica", build_sharded_vamana, sharded_search, mesh),
                               ("global", build_global_vamana, global_search, mesh1)):
    occlusion_rounds.launches_f32 = 0
    idx = build(X, m, bp)
    res[name + "_f32_launches"] = occlusion_rounds.launches_f32
    arrays[name + "_ids"] = search(idx, Q, k=10, beam_size=32)[0]
card, host = build_sharded_vamana(XI, mesh, bp), build_sharded_vamana(XI, cpu, bp)
for name, idx in (("card", card), ("host", host)):
    arrays[name + "_nbrs"], arrays[name + "_degs"] = idx.nbrs.cpu().numpy(), idx.degs.cpu().numpy()
dist.destroy_process_group()
np.savez(f"{out_dir}/out.npz", X=X, Q=Q, **arrays)
print(json.dumps(res))
'''


def test_torch_cuda_nccl_world_of_one_modes(cuda, tmp_path):
    """The replica and global builds at world size 1 on NCCL, in a
    subprocess so that no process group outlives the test: kernel 2's f32
    mode launches in both, both searches reach recall@10 0.8 at beam 32
    (the CPU's builds reach 0.8525 on this standard-normal set),
    the int8 replica graph built on the card equals the one built on the
    CPU through a gloo sub-group row for row."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", _NCCL_MODES, str(tmp_path)],
                          cwd=Path(__file__).resolve().parents[1], capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["backends"] == ["nccl", "nccl", "gloo"]
    assert res["replica_f32_launches"] > 0 and res["global_f32_launches"] > 0, res
    a = np.load(tmp_path / "out.npz")
    d = ((a["Q"][:, None, :].astype(np.float64) - a["X"][None]) ** 2).sum(-1)
    gt = np.argsort(d, axis=1)[:, :20]
    gt_d = np.take_along_axis(d, gt, 1)
    for name in ("replica", "global"):
        assert compute_recall(a[name + "_ids"], gt, gt_d, 10) >= 0.8, name
    np.testing.assert_array_equal(a["card_degs"], a["host_degs"])
    for i, deg in enumerate(a["card_degs"].reshape(-1)):
        np.testing.assert_array_equal(a["card_nbrs"].reshape(-1, 16)[i, :deg],
                                      a["host_nbrs"].reshape(-1, 16)[i, :deg])


def test_torch_cuda_nccl_four_ranks_match_gloo(cuda, tmp_path):
    """Every multi-device mode on four NCCL ranks, one card each, against
    the same job on four gloo ranks on the CPU: the int8 replica graphs
    (over the (4, 1) and the (2, 2) mesh) and the int8 global graph equal
    row for row, with their searches equal; the f32 replica and global
    builds meet the builder bar (average degree within 0.5, recall@10 at
    beam 32 within 0.01) and launch kernel 2's f32 mode on the cards; the
    cluster-sharded build has the same C and recall@10 at n_probe 8 within
    0.03; the dryrun's three modes run. Skips on a machine with fewer than
    four cards."""
    import torch_ranks
    from parlayann_tpu_torch.ops.kernels import _lib
    from parlayann_tpu_torch.utils import synthetic

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four NVIDIA GPUs")
    _lib.build()  # once, before the ranks load it
    rng = np.random.default_rng(8)
    n, d = 4000, 32
    st = dict(bp=dict(R=16, L=32, alpha=1.2, num_passes=2, batch_cap_frac=0.1), n_u=1997,
              X_f32=rng.standard_normal((n, d)).astype(np.float32),
              Q_f32=rng.standard_normal((200, d)).astype(np.float32),
              X_int8=rng.integers(-40, 41, (n, d)).astype(np.int8),
              Q_int8=rng.integers(-40, 41, (200, d)).astype(np.float32))
    st["c_X"], st["c_Q"] = synthetic.clustered(4000, 64, n_queries=64, n_clusters=40,
                                               cluster_std=0.1, seed=6)
    runs = {}
    for device in ("cuda", "cpu"):
        (tmp_path / device).mkdir()
        runs[device] = torch_ranks.spawn(tmp_path / device, 4, "four_rank_job",
                                         dict(st, device=device))
    card, host = runs["cuda"], runs["cpu"]
    for tag in ("a_int8", "u_int8", "g_int8"):
        assert torch_ranks.rows_equal(host[tag + "_nbrs"], host[tag + "_degs"],
                                      card[tag + "_nbrs"], card[tag + "_degs"]).all(), tag
        torch_ranks.assert_same_search(card[tag + "_ids"], card[tag + "_dists"],
                                       host[tag + "_ids"], host[tag + "_dists"], tag)
    gt, gtd = torch_ranks.exact_knn(st["X_f32"], st["Q_f32"], 10)
    for tag in ("a_f32", "g_f32"):
        assert card[tag + "_f32_launches"] > 0, tag
        torch_ranks.builder_bar(host[tag + "_nbrs"], host[tag + "_degs"],
                                card[tag + "_nbrs"], card[tag + "_degs"], n,
                                compute_recall(host[tag + "_ids"], gt, gtd, 10),
                                compute_recall(card[tag + "_ids"], gt, gtd, 10), tag,
                                names=("gloo", "nccl"))
    assert card["c_C"] == host["c_C"]
    gt, gtd = torch_ranks.exact_knn(st["c_X"], st["c_Q"], 10)
    r_host, r_card = (compute_recall(r["c_ids"], gt, gtd, 10) for r in (host, card))
    assert abs(r_host - r_card) <= 0.03, (r_host, r_card)
    for mode in ("global", "sharded", "cluster"):
        assert card[f"dry_{mode}_ids"].shape == host[f"dry_{mode}_ids"].shape, mode


def test_torch_cuda_search_spans_on_the_card(cluster_data, cuda):
    """A q8 search recorded on the card: the same answers as unrecorded;
    the root's children have stream times, and the walk's counters equal
    the FusedResult's sums. A profiler session that traces the device
    alone turns the recorder on and times one search in SAMPLE."""
    from torch.profiler import ProfilerActivity, profile

    from parlayann_tpu_torch.utils import trace

    X, Q = cluster_data
    g, ps, _ = build_vamana_index(X, R=16, L=32, device=cuda)
    idx = Index(points=ps, graph=g).enable_quantized(8)
    idx.entry_min_n = 0
    want = idx.batch_search(Q, k=10, beam_size=32)
    trace.clear()
    with trace.recording():
        got = idx.batch_search(Q, k=10, beam_size=32)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    spans = trace.spans()
    names = [s.name for s in spans]
    assert names == ["search", "search.entry", "search.translate", "search.walk",
                     "search.rerank"]
    assert spans[0].stream_ms is None  # the root times the host alone
    assert all(s.stream_ms is not None and s.stream_ms > 0 for s in spans[1:])
    walk = spans[3]
    assert walk.counters["cmps"] == int(got[2].dist_cmps.sum())
    assert walk.counters["visits"] == int(got[2].num_visited.sum())
    trace.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        assert trace.on()
        for _ in range(trace.SAMPLE):
            idx.batch_search(Q, k=10, beam_size=32)
    torch.cuda.synchronize()
    spans = trace.spans()
    assert [s.name for s in spans] == names * trace.SAMPLE
    assert sum(s.timed for s in spans) == len(names)
    assert all((s.stream_ms is not None) is (s.timed and s.name != "search") for s in spans)
    trace.clear()
