"""Kernel 1's multi-probe mode (``expand_distances_multi``) and its one
caller, ``clusterbeam.meta_topk``, on the CPU, where the wrapper runs its
plain version. The plain version is held to the JAX package's
``expand_distances_multi`` (which flattens the pairs through the Pallas
kernel, in interpret mode on the CPU, as the package's own tests run it);
the CUDA kernel is held to this plain version on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from parlayann_tpu.types import Metric as JMetric
from parlayann_tpu.ops.pallas.expand import expand_distances_multi as jexpand_multi

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels import clusterbeam
from parlayann_tpu_torch.ops.kernels.expand import (
    expand_distances_multi, expand_distances_multi_plain, expand_distances_plain)
from parlayann_tpu_torch.ops.topk import smallest_k
from parlayann_tpu_torch.search.flat import flat_search_batch

torch.set_num_threads(1)
METRICS = [(Metric.L2, JMetric.L2), (Metric.MIPS, JMetric.MIPS)]


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(rng, dtype, n, R8, d, B, E):
    """Blocks, (B, E) ids heavily repeated (most pairs on 3 blocks) with a
    few out of range, and queries: integer-valued for int8 rows."""
    if dtype == "int8":
        inl = rng.integers(-128, 128, (n, R8, d)).astype(np.int8)
        q = rng.integers(-128, 128, (B, d)).astype(np.float32)
    else:
        inl = rng.standard_normal((n, R8, d)).astype(np.float32)
        q = (rng.standard_normal((B, d)) * 2).astype(np.float32)
    ids = np.where(rng.random((B, E)) < 0.7, rng.integers(0, 3, (B, E)),
                   rng.integers(-2, n + 2, (B, E))).astype(np.int32)
    return inl, ids, q


@pytest.mark.parametrize("E", [1, 3, 16])
@pytest.mark.parametrize("dtype", ["f32", "int8"])
@pytest.mark.parametrize("metric,jmetric", METRICS)
def test_torch_expand_multi_plain_matches_jax(rng, metric, jmetric, dtype, E):
    """(B, E, R8) distances equal JAX's ``expand_distances_multi``: bit for
    bit on int8 rows with integer-valued queries (exact integer sums); on
    f32 rows the two sum in other orders, so L2 agrees to rtol 1e-5 and a
    negated dot, which can cancel to near zero, to 1e-5 of the largest
    magnitude. JAX reads ids its caller has clipped (its contract); the
    port clamps them itself. The wrapper on CPU tensors is the plain
    version."""
    n, R8, d, B = 30, 16, 24, 8
    inl, ids, q = _case(rng, dtype, n, R8, d, B, E)
    want = np.asarray(jexpand_multi(jnp.asarray(inl), jnp.asarray(np.clip(ids, 0, n - 1)),
                                    jnp.asarray(q), metric=jmetric))
    got = expand_distances_multi_plain(t(inl), t(ids), t(q), metric=metric)
    assert got.shape == (B, E, R8) and got.dtype == torch.float32
    assert torch.equal(expand_distances_multi(t(inl), t(ids), t(q), metric=metric), got)
    if dtype == "int8":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        atol = 0.0 if metric is Metric.L2 else 1e-5 * np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "int8"])
def test_torch_expand_multi_plain_is_the_single_mode_stacked(rng, dtype):
    """Probe e of the multi mode is the single mode's plain version on
    column e, bit for bit (the kernel holds the same on the card)."""
    inl, ids, q = _case(rng, dtype, 40, 24, 100, 33, 5)
    got = expand_distances_multi_plain(t(inl), t(ids), t(q), metric=Metric.L2)
    for e in range(ids.shape[1]):
        assert torch.equal(got[:, e], expand_distances_plain(t(inl), t(ids[:, e]), t(q),
                                                             metric=Metric.L2))
    empty = expand_distances_multi(t(inl), t(ids[:0]), t(q[:0]), metric=Metric.L2)
    assert empty.shape == (0, 5, 24)


def _meta_topk_by_probe(q, mcents, blocks, idtab, *, k, P, metric):
    """``meta_topk`` as it was written before the multi mode: one
    single-mode distance call a probe, the candidates concatenated in probe
    order."""
    Cm = blocks.shape[0]
    mt_i, _ = flat_search_batch(q, mcents, k=P, metric=metric, n_valid=Cm,
                                chunk=min(Cm, 32768), select="sort")
    ds, ids = [], []
    for p in range(P):
        mi = mt_i[:, p].clamp(0, Cm - 1)
        dp = expand_distances_plain(blocks, mi, q, metric=metric)
        ip = idtab[mi.long()]
        ds.append(torch.where((ip >= 0) & (mt_i[:, p:p + 1] >= 0), dp, INF))
        ids.append(ip)
    d, i = smallest_k(torch.cat(ds, dim=1), torch.cat(ids, dim=1), k)
    return i, d


@pytest.mark.parametrize("dtype,P,k", [("f32", 3, 8), ("f32", 12, 20), ("int8", 4, 2)])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
def test_torch_meta_topk_multi_equals_per_probe_loop(rng, dtype, P, k, metric):
    """``meta_topk`` through one multi-mode call equals, with torch.equal,
    the per-probe loop: the same distances, and candidate p * cap + j, so
    equal distances keep probe order. P = 12 > Cm leaves probes without a
    cell (-1 from the scan), and empty slots (-1 in ``idtab``) and tied
    centroids (duplicated rows) are among the candidates."""
    Cm, cap, d, B = 10, 8, 16, 50
    if dtype == "int8":
        blocks = rng.integers(-128, 128, (Cm, cap, d)).astype(np.int8)
        q = rng.integers(-128, 128, (B, d)).astype(np.float32)
    else:
        blocks = rng.standard_normal((Cm, cap, d)).astype(np.float32)
        q = rng.standard_normal((B, d)).astype(np.float32)
    blocks[3, 2] = blocks[5, 1]  # a tie across two cells
    idtab = rng.permutation(Cm * cap).reshape(Cm, cap).astype(np.int32)
    idtab[rng.random((Cm, cap)) < 0.2] = -1
    blocks[idtab < 0] = 0
    mcents = blocks.astype(np.float32).mean(axis=1)
    args = (t(q), t(mcents), t(blocks), t(idtab))
    got = clusterbeam.meta_topk(*args, k=k, P=P, metric=metric)
    want = _meta_topk_by_probe(*args, k=k, P=P, metric=metric)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
