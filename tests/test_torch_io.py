"""File I/O, port vs JAX package: the reference's byte formats, the loaders
built on them, ``Index.load``/``save``, ``load_index``,
``batch_search_from_string`` and the auto tier at load.

Bars: files written by the two packages from the same arrays are
byte-equal; each package reads the other's files to equal arrays; searches
of indexes the two packages load from the same files return equal ids
(integer-valued queries on int8 tiers: every distance is exact). The
ClusterIndex files are tested in tests/test_torch_cluster.py, beside the
JAX-built index they load.
"""

import numpy as np
import pytest
import torch

import parlayann_tpu as jpt
from parlayann_tpu.data import io as jio
from parlayann_tpu.data.graph import GraphIndexData as JGraph
from parlayann_tpu.index import Index as JIndex

import parlayann_tpu_torch as pt
from parlayann_tpu_torch.data import io
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)
K, BEAM = 10, 24


def same_file(tmp_path, name, write, jwrite, *args):
    a, b = tmp_path / f"port_{name}", tmp_path / f"jax_{name}"
    write(str(a), *args)
    jwrite(str(b), *args)
    assert a.read_bytes() == b.read_bytes(), name
    return str(a), str(b)


@pytest.mark.parametrize("dtype,ext", [(np.float32, "fbin"), (np.int8, "i8bin"),
                                       (np.uint8, "u8bin")])
def test_torch_io_bin_byte_equal(tmp_path, dtype, ext):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((37, 13)) * 40).astype(dtype)
    a, b = same_file(tmp_path, f"x.{ext}", io.write_bin, jio.write_bin, x)
    assert io.infer_bin_dtype(a) == jio.infer_bin_dtype(b) == np.dtype(dtype)
    for path in (a, b):
        np.testing.assert_array_equal(io.read_bin(path, dtype), x)
        np.testing.assert_array_equal(jio.read_bin(path, dtype), x)
    # an extension that names no type: the element size decides
    c = tmp_path / "x.bin"
    io.write_bin(str(c), x)
    assert io.infer_bin_dtype(str(c)) == jio.infer_bin_dtype(str(c))
    np.testing.assert_array_equal(io.vectors_from_file(a), x)


@pytest.mark.parametrize("ext,dtype", [("fvecs", np.float32), ("ivecs", np.int32),
                                       ("bvecs", np.uint8)])
def test_torch_io_vecs_read_equal(tmp_path, ext, dtype):
    """.fvecs/.ivecs/.bvecs rows ([int32 d] + d values) read to equal
    arrays, and vecs_to_bin writes equal bytes."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((21, 9)) * 50).astype(dtype)
    raw = b"".join(np.int32(9).tobytes() + row.tobytes() for row in x)
    p = tmp_path / f"x.{ext}"
    p.write_bytes(raw)
    np.testing.assert_array_equal(io.read_vecs(str(p)), jio.read_vecs(str(p)))
    np.testing.assert_array_equal(io.read_vecs(str(p)), x)
    a, b = tmp_path / "a.bin", tmp_path / "b.bin"
    io.vecs_to_bin(str(p), str(a))
    jio.vecs_to_bin(str(p), str(b))
    assert a.read_bytes() == b.read_bytes()


def test_torch_io_graph_ibin_range_hdf5_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    n, R = 50, 7
    nb = rng.integers(0, n, (n, R)).astype(np.int32)
    dg = rng.integers(0, R + 1, n).astype(np.int32)
    a, b = same_file(tmp_path, "g.bin", io.write_graph, jio.write_graph, nb, dg)
    for read in (io.read_graph, jio.read_graph):
        for path in (a, b):
            got_nb, got_dg, mx = read(path)
            assert mx == R
            np.testing.assert_array_equal(got_dg, dg)
            mask = np.arange(R)[None, :] < dg[:, None]
            np.testing.assert_array_equal(got_nb[mask], nb[mask])
    ids = rng.integers(0, 1000, (9, 5)).astype(np.int32)
    dists = rng.random((9, 5)).astype(np.float32)
    a, b = same_file(tmp_path, "gt.ibin", io.write_ibin, jio.write_ibin, ids, dists)
    for got in (io.read_ibin(b), jio.read_ibin(a)):
        np.testing.assert_array_equal(got[0], ids)
        np.testing.assert_array_equal(got[1], dists)
    lists = [rng.integers(0, 99, rng.integers(0, 6)).astype(np.int32) for _ in range(8)]
    a, b = same_file(tmp_path, "range.ibin", io.write_range_ibin, jio.write_range_ibin,
                     lists)
    for got in (io.read_range_ibin(b), jio.read_range_ibin(a)):
        assert len(got) == len(lists)
        for g, w in zip(got, lists):
            np.testing.assert_array_equal(g, w)
    x = rng.standard_normal((11, 6)).astype(np.float32)
    a, b = same_file(tmp_path, "x.h5", io.write_hdf5, jio.write_hdf5, x)
    np.testing.assert_array_equal(io.read_hdf5(b), jio.read_hdf5(a))
    with pytest.raises(KeyError):
        io.read_hdf5(a, dataset="test")


def test_torch_io_pointset_and_graph_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((45, 10)).astype(np.float32)
    for ext, data in (("fbin", x), ("u8bin", (x * 30 + 128).clip(0, 255).astype(np.uint8))):
        p = str(tmp_path / f"x.{ext}")
        io.write_bin(p, data)
        ps = pt.PointSet.from_file(p, metric="mips", device="cpu")
        assert (ps.n, ps.d, ps.metric, ps.n_pad) == (45, 10, Metric.MIPS, 48)
        assert ps.data.dtype == torch.from_numpy(data).dtype
        np.testing.assert_array_equal(ps.data[:45].numpy(), data)
        assert not ps.data[45:].any()
    p = str(tmp_path / "x.fvecs")
    open(p, "wb").write(b"".join(np.int32(10).tobytes() + r.tobytes() for r in x))
    np.testing.assert_array_equal(pt.PointSet.from_file(p, device="cpu").data[:45].numpy(), x)
    p = str(tmp_path / "x.h5")
    io.write_hdf5(p, x)
    np.testing.assert_array_equal(pt.PointSet.from_file(p, device="cpu").data[:45].numpy(), x)
    nb = rng.integers(0, 45, (45, 6)).astype(np.int32)
    dg = rng.integers(1, 7, 45).astype(np.int32)
    g = pt.GraphIndexData.from_numpy(nb, dg, device="cpu")
    g.save(str(tmp_path / "g"))
    g2 = pt.GraphIndexData.load(str(tmp_path / "g"), device="cpu")
    assert (g2.n, g2.max_degree, g2.n_pad) == (45, 6, 48)
    assert torch.equal(g2.degrees, g.degrees)
    mask = torch.arange(6)[None, :] < g.degrees[:, None]
    assert torch.equal(torch.where(mask, g2.neighbors, -1), torch.where(mask, g.neighbors, -1))
    jg = JGraph.load(str(tmp_path / "g"))
    np.testing.assert_array_equal(np.asarray(jg.degrees), g2.degrees.numpy())


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A clustered set, its 12-NN graph (degrees 8-12) and its data in the
    three element types, written by the JAX package."""
    root = tmp_path_factory.mktemp("io")
    X, Q = synthetic.clustered(600, 24, n_queries=32, n_clusters=12, seed=3)
    d2 = ((X[:, None, :] - X[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nb = np.argsort(d2, axis=1, kind="stable")[:, :12].astype(np.int32)
    dg = np.random.default_rng(3).integers(8, 13, len(X)).astype(np.int32)
    jio.write_graph(str(root / "g.bin"), nb, dg)
    x8 = np.round(X / np.abs(X).max() * 127).astype(np.int8)
    xu = (x8.astype(np.int16) + 128).astype(np.uint8)
    for name, arr in (("x.fbin", X), ("x.i8bin", x8), ("x.u8bin", xu)):
        jio.write_bin(str(root / name), arr)
    return dict(root=root, X=X, Q=Q, x8=x8, xu=xu)


def test_torch_io_index_load_save_matches_jax(files, tmp_path):
    """An Index loaded by each package from the same two files (f32 points,
    the q8 tier): equal ids; the port's saved graph is byte-equal to the
    JAX package's."""
    g, x = str(files["root"] / "g.bin"), str(files["root"] / "x.fbin")
    jidx = JIndex.load(g, x)
    tidx = pt.load_index(g, x, device="cpu")
    assert tidx.qpoints is not None and tidx.jl_tier is None
    np.testing.assert_array_equal(tidx.qpoints.data.numpy(), np.asarray(jidx.qpoints.data))
    want = np.asarray(jidx.batch_search(files["Q"], k=K, beam_size=BEAM)[0])
    got = tidx.batch_search(files["Q"], k=K, beam_size=BEAM)[0].numpy()
    np.testing.assert_array_equal(got, want)
    a, b = tmp_path / "port.g", tmp_path / "jax.g"
    tidx.save(str(a))
    jidx.save(str(b))
    assert a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("kind", ["f32", "int8", "uint8"])
def test_torch_io_batch_search_from_string_matches_jax(files, kind):
    """The 1-byte decode rule: int8 payloads against int8 points, uint8
    ones against uint8 points; equal ids to the JAX package's."""
    root, Q = files["root"], files["Q"]
    name, q = {"f32": ("x.fbin", Q),
               "int8": ("x.i8bin", np.round(Q / np.abs(files["X"]).max() * 127).astype(np.int8)),
               "uint8": ("x.u8bin", (np.round(Q / np.abs(files["X"]).max() * 127) + 128)
                         .clip(0, 255).astype(np.uint8))}[kind]
    payload = np.array(q.shape, dtype=np.uint32).tobytes() + q.tobytes()
    jidx = JIndex.load(str(root / "g.bin"), str(root / name))
    tidx = pt.Index.load(str(root / "g.bin"), str(root / name), device="cpu")
    want = jidx.batch_search_from_string(payload, k=K, beam_size=BEAM)
    got = tidx.batch_search_from_string(payload, k=K, beam_size=BEAM)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert got[0].shape == (len(Q), K) and (got[0] >= 0).all()
    with pytest.raises(ValueError, match="dim"):
        tidx.batch_search_from_string(np.array([2, 5], np.uint32).tobytes()
                                      + np.zeros(10, np.float32).tobytes())


def test_torch_io_load_index_checks_paths(files):
    with pytest.raises(ValueError, match="graph_path"):
        pt.load_index(str(files["root"] / "missing.bin"), str(files["root"] / "x.fbin"),
                      device="cpu")
    with pytest.raises(ValueError, match="data_path"):
        pt.load_index(str(files["root"] / "g.bin"), None, device="cpu")
    with pytest.raises(ValueError, match="distance_metric"):
        pt.load_index(str(files["root"] / "g.bin"), str(files["root"] / "x.fbin"),
                      metric="cosine", device="cpu")


def test_torch_io_auto_tier(tmp_path):
    """L2 at d > 800 gets the JL 1024 sign-bit tier, as in the JAX package
    (the port draws its projection from its own generator, so the words
    equal the port's own ``enable_jl(1024, bits=1)``); MIPS at d > 200 gets
    the 2-bit tier, equal to the JAX package's."""
    rng = np.random.default_rng(6)
    n = 40
    g = str(tmp_path / "g.bin")
    ring = np.stack([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n], 1).astype(np.int32)
    jio.write_graph(g, ring, np.full(n, 2, np.int32))
    x = str(tmp_path / "x.fbin")
    jio.write_bin(x, rng.standard_normal((n, 801)).astype(np.float32))
    tidx = pt.load_index(g, x, device="cpu")
    jidx = jpt.load_index(g, x)
    assert tidx.jl_tier.bits == 1 and tidx.jl_tier.points.data.shape[1] == 1024 // 32
    assert (jidx.jl_tier.bits, np.asarray(jidx.jl_tier.points.data).shape) == (
        1, tuple(tidx.jl_tier.points.data.shape))
    own = pt.Index(points=tidx.points, graph=tidx.graph).enable_jl(jl_dims=1024, bits=1)
    assert torch.equal(tidx.jl_tier.points.data, own.jl_tier.points.data)
    assert pt.load_index(g, x, auto_tier=False, device="cpu").jl_tier is None
    jio.write_bin(x, rng.standard_normal((n, 201)).astype(np.float32))
    tidx = pt.load_index(g, x, metric="mips", device="cpu")
    jidx = jpt.load_index(g, x, metric="mips")
    assert tidx.t2_points.bits == 2 and tidx.t2_points.data.shape == (tidx.points.n_pad, 2 * 7)
    np.testing.assert_array_equal(tidx.t2_points.data.numpy(),
                                  np.asarray(jidx.t2_points.data).view(np.int32))
    assert np.float32(tidx.t2_points.quant_offset) == np.float32(jidx.t2_points.quant_offset)
    assert pt.load_index(g, x, metric="mips", auto_tier=False, device="cpu").qpoints is not None
