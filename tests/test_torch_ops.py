"""PyTorch port vs the JAX package: data layer, q8 quantization, sort and
scan helpers. Inputs are made with numpy from a seed and fed to both."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from parlayann_tpu.data.pointset import PointSet as JPointSet
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.utils.arrays import segment_bounds as jsegment_bounds

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.data.pointset import PointSet
from parlayann_tpu_torch.data.graph import GraphIndexData
from parlayann_tpu_torch.ops import distance, quantize
from parlayann_tpu_torch.ops.topk import lexsort, smallest_k
from parlayann_tpu_torch.utils.arrays import segment_bounds

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def test_torch_port_imports_no_jax():
    code = ("import sys, parlayann_tpu_torch, parlayann_tpu_torch.interop, "
            "parlayann_tpu_torch.search.exact, parlayann_tpu_torch.build.vamana, "
            "parlayann_tpu_torch.cli, parlayann_tpu_torch.search.range, "
            "parlayann_tpu_torch.harness.sweep, parlayann_tpu_torch.harness.range_sweep, "
            "parlayann_tpu_torch.harness.csv, parlayann_tpu_torch.defaults, "
            "parlayann_tpu_torch.tools.compute_groundtruth, "
            "parlayann_tpu_torch.tools.compute_range_groundtruth, "
            "parlayann_tpu_torch.tools.vec_to_bin, parlayann_tpu_torch.tools.crop, "
            "parlayann_tpu_torch.tools.random_sample, parlayann_tpu_torch.parallel.mesh, "
            "parlayann_tpu_torch.parallel.sharded, parlayann_tpu_torch.parallel.cluster_sharded, "
            "parlayann_tpu_torch.parallel.global_build, dryrun_multichip_torch; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert not any(m.startswith('parlayann_tpu.') or m == 'parlayann_tpu' "
            "for m in sys.modules)")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


@pytest.mark.parametrize("metric", ["l2", "mips"])
def test_torch_q8_quantize_bit_equal(rng, metric):
    """The q8 tier, its parameters and translated queries are bit-equal
    (round half to even on both sides; ties are forced by the half-step
    values below)."""
    X = rng.standard_normal((203, 32)).astype(np.float32) * 3.0
    X[:5, :4] = np.float32(0.5)  # exact .5 steps after the affine map
    Q = rng.standard_normal((17, 32)).astype(np.float32) * 4.0  # some clamp
    jps = jquantize.quantize_pointset(JPointSet.from_numpy(X, metric=metric), bits=8)
    tps = quantize.quantize_pointset(
        PointSet.from_numpy(X, metric=metric, device="cpu"), bits=8)
    np.testing.assert_array_equal(tps.data.numpy(), np.asarray(jps.data))
    assert tps.data.dtype == torch.int8 and tps.n_pad == jps.n_pad == 208
    assert np.float32(tps.quant_slope) == np.float32(jps.quant_slope)
    assert np.float32(tps.quant_offset) == np.float32(jps.quant_offset)
    np.testing.assert_array_equal(
        quantize.translate_query(torch.from_numpy(Q), tps).numpy(),
        np.asarray(jquantize.translate_query(jnp.asarray(Q), jps)))


def test_torch_q8_uint8_input_is_exact_affine(rng):
    X = rng.integers(0, 256, (64, 16)).astype(np.uint8)
    jps = jquantize.quantize_pointset(JPointSet.from_numpy(X), bits=8)
    tps = quantize.quantize_pointset(PointSet.from_numpy(X, device="cpu"), bits=8)
    np.testing.assert_array_equal(tps.data.numpy(), np.asarray(jps.data))


def test_torch_unported_tiers_raise():
    """The tiers this test once saw refused now run: a 4-bit scalar tier
    and a trimmed MIPS scale, each bit-equal to the JAX package's
    (tests/test_torch_tiers.py holds every width)."""
    X = np.arange(32, dtype=np.float32).reshape(8, 4) - 9.5
    for metric, bits, trim in (("l2", 4, 0.0), ("mips", 8, 0.01)):
        jps = jquantize.quantize_pointset(JPointSet.from_numpy(X, metric=metric),
                                          bits=bits, trim=trim)
        tps = quantize.quantize_pointset(PointSet.from_numpy(X, metric=metric, device="cpu"),
                                         bits=bits, trim=trim)
        np.testing.assert_array_equal(tps.data.numpy(), np.asarray(jps.data))
        assert np.float32(tps.quant_slope) == np.float32(jps.quant_slope)


def test_torch_int8_distances_accumulate_in_f32(rng):
    """Regression for the int8 trap (ROADMAP queue 3): an int8 matmul
    accumulates in int8 and wraps. Distances cast to f32 first and match
    float64 on int8 inputs exactly."""
    a = rng.integers(-128, 128, (6, 128)).astype(np.int8)
    b = rng.integers(-128, 128, (40, 128)).astype(np.int8)
    ref = ((a[:, None, :].astype(np.float64) - b[None].astype(np.float64)) ** 2).sum(-1)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(distance.all_pairs(ta, tb, Metric.L2).numpy(), ref)
    np.testing.assert_array_equal(
        distance.gathered(ta, tb[None].expand(6, -1, -1), Metric.L2).numpy(), ref)
    dot = a.astype(np.float64) @ b.astype(np.float64).T
    np.testing.assert_array_equal(distance.all_pairs(ta, tb, Metric.MIPS).numpy(), -dot)
    # the trap itself: an int8 product would not be these values
    assert np.abs(dot).max() > 127


def _lane_order_replay(q, v, mips, chunk):
    """One distance summed term by term in float32 numpy scalars, in the
    order stated at the top of csrc/warp.cuh."""
    f = np.float32
    d = len(q)
    nch = -(-d // chunk)
    part = []
    for s in range(8):
        acc = f(0)
        for k in range(s, nch, 8):
            for i in range(k * chunk, min(d, (k + 1) * chunk)):
                t = f(v[i]) if mips else f(f(v[i]) - f(q[i]))
                acc = f(acc + f(t * (f(q[i]) if mips else t)))
        part.append(acc)
    p = part
    total = f(f(f(p[0] + p[4]) + f(p[2] + p[6])) + f(f(p[1] + p[5]) + f(p[3] + p[7])))
    return -total if mips else total


@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("d,dtype", [(128, "f32"), (20, "f32"), (100, "int8"),
                                     (40, "int8"), (3, "f32")])
def test_torch_gathered_lane_order_replays_kernel_sum(rng, metric, d, dtype):
    """The cluster walk's plain distances equal a term-by-term float32
    replay of the warp kernels' order bit for bit, and the straightforward
    sum to rtol 1e-5 (1e-5 of the largest magnitude under MIPS)."""
    B, K = 3, 5
    q = rng.standard_normal((B, d)).astype(np.float32) * 7
    if dtype == "int8":
        v = rng.integers(-128, 128, (B, K, d)).astype(np.int8)
        chunk = 16
    else:
        v = rng.standard_normal((B, K, d)).astype(np.float32)
        chunk = 4
    tq, tv = torch.from_numpy(q), torch.from_numpy(v)
    got = distance.gathered_lane_order(tq, tv, metric, chunk).numpy()
    mips = metric is Metric.MIPS
    want = np.array([[_lane_order_replay(q[b], v[b, k], mips, chunk) for k in range(K)]
                     for b in range(B)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    plain = distance.gathered(tq, tv, metric).numpy()
    atol = 1e-5 * np.abs(plain).max() if mips else 0.0
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=atol)


def test_torch_lexsort_matches_lax_sort_num_keys_2(rng):
    """lax.sort(num_keys=2) is lexicographic and stable; so is lexsort."""
    k1 = rng.integers(0, 5, (8, 64)).astype(np.int32)
    k2 = rng.integers(0, 4, (8, 64)).astype(np.float32)
    pay = rng.permutation(8 * 64).reshape(8, 64).astype(np.int32)
    want = jax.lax.sort((jnp.asarray(k1), jnp.asarray(k2), jnp.asarray(pay)),
                        num_keys=2, is_stable=True)
    got = lexsort((torch.from_numpy(k1), torch.from_numpy(k2)), torch.from_numpy(pay))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_torch_smallest_k_matches_lax_top_k_ties(rng):
    d = rng.integers(0, 6, (5, 40)).astype(np.float32)
    ids = rng.permutation(200).reshape(5, 40).astype(np.int32)
    neg, idx = jax.lax.top_k(-jnp.asarray(d), 7)
    got_d, got_i = smallest_k(torch.from_numpy(d), torch.from_numpy(ids), 7)
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(
        got_i.numpy(), np.take_along_axis(ids, np.asarray(idx), 1))


def test_torch_segment_bounds(rng):
    s = np.sort(rng.integers(0, 9, 50)).astype(np.int32)
    jl, jr = jsegment_bounds(jnp.asarray(s))
    tl, tr = segment_bounds(torch.from_numpy(s))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_torch_argmax_of_mask_is_first_true():
    m = torch.tensor([[0, 1, 1, 0], [0, 0, 0, 0], [1, 0, 1, 1]], dtype=torch.int32)
    np.testing.assert_array_equal(m.argmax(dim=1).numpy(), [1, 0, 0])


def test_torch_data_layer_padding_and_stats(rng):
    X = rng.standard_normal((13, 4)).astype(np.float32)
    ps = PointSet.from_numpy(X, device="cpu")
    assert ps.n_pad == JPointSet.from_numpy(X).n_pad == 16
    np.testing.assert_array_equal(ps.data[:13].numpy(), X)
    assert not ps.data[13:].any()
    nb = rng.integers(0, 13, (13, 5)).astype(np.int32)
    dg = rng.integers(0, 6, 13).astype(np.int32)
    g = GraphIndexData.from_numpy(nb, dg, device="cpu")
    assert g.n_pad == 16 and g.stats() == (float(dg.mean()), int(dg.max()))


def _entry_points():
    """Every entry point that places data, called without ``device``."""
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch import interop
    from parlayann_tpu_torch.utils.device import resolve

    X = np.zeros((64, 32), np.float32)
    nb, dg = np.zeros((64, 8), np.int32), np.zeros(64, np.int32)
    return {
        "resolve": lambda: resolve(),
        "PointSet.from_numpy": lambda: PointSet.from_numpy(X),
        "GraphIndexData.from_numpy": lambda: GraphIndexData.from_numpy(nb, dg),
        "build_vamana_index": lambda: pt.build_vamana_index(X, R=8, L=16),
        "build_cluster_index": lambda: pt.build_cluster_index(X, m=32, Rc=8),
        "pointset_from_state": lambda: interop.pointset_from_state(X, 64, 32, "l2"),
        "graph_from_state": lambda: interop.graph_from_state(nb, dg, 64, 8),
    }


@pytest.mark.parametrize("entry", list(_entry_points()))
def test_torch_entry_points_default_to_the_card(entry):
    """No ``device``: the card, and without one a RuntimeError naming the
    way to the CPU, never a silent fall back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        _entry_points()[entry]()


def test_torch_resolve_keeps_an_explicit_device():
    from parlayann_tpu_torch.utils.device import resolve

    assert resolve("cpu") == torch.device("cpu")
    assert resolve(torch.device("meta")) == torch.device("meta")
