"""The command line and the data tools, port vs JAX package, on the CPU.

Both CLIs run in this process (``-device cpu`` for the port) on the same
files. Graphs are built once by the port's CLI and saved; both CLIs then
search the same graph file, so their recall, comparisons and visits (the
CSV's columns other than build time and QPS) are held to each other, and
the port's build itself is held to a recall floor. The JAX builders' own
parity lives in the builder tests (tests/test_torch_{slice,hnsw,hcnng,
pynndescent}.py).
"""

import csv
import re

import numpy as np
import pytest
import torch

from parlayann_tpu import cli as jcli
from parlayann_tpu.ops import quantize as jquantize
from parlayann_tpu.tools import (compute_groundtruth as jgt, compute_range_groundtruth as jrgt,
                                 crop as jcrop, random_sample as jsample, vec_to_bin as jv2b)

from parlayann_tpu_torch import cli as tcli
from parlayann_tpu_torch.data import io
from parlayann_tpu_torch.ops import quantize as tquantize
from parlayann_tpu_torch.tools import (compute_groundtruth as tgt, compute_range_groundtruth as trgt,
                                       crop as tcrop, random_sample as tsample, vec_to_bin as tv2b)

torch.set_num_threads(1)
N, D, NQ = 500, 16, 30
CPU = ["-device", "cpu"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((10, D)).astype(np.float32)
    X = (centers[rng.integers(0, 10, N)] + 0.3 * rng.standard_normal((N, D))).astype(np.float32)
    Q = (centers[rng.integers(0, 10, NQ)] + 0.3 * rng.standard_normal((NQ, D))).astype(np.float32)
    f = {k: str(d / k) for k in ("b.fbin", "q.fbin", "gt.ibin", "b.u8bin", "q.u8bin")}
    io.write_bin(f["b.fbin"], X)
    io.write_bin(f["q.fbin"], Q)
    lo, hi = X.min(), X.max()
    u8 = lambda A: np.clip(np.rint((A - lo) * (255 / (hi - lo))), 0, 255).astype(np.uint8)
    io.write_bin(f["b.u8bin"], u8(X))
    io.write_bin(f["q.u8bin"], u8(Q))
    jgt.main(["-base_path", f["b.fbin"], "-query_path", f["q.fbin"], "-gt_path", f["gt.ibin"],
              "-k", "10"])
    return dict(dir=d, X=X, Q=Q, **f)


def _csv_rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _without_time_and_qps(rows):
    """CSV rows with the build-time and QPS columns blanked."""
    out = []
    for r in rows:
        r = list(r)
        if len(r) == 6 and r[0] != "GRAPH":
            r[3] = "-"
        if len(r) == 11 and r[0] != "Num queries":
            r[3] = "-"
        out.append(r)
    return out


def _recall(path):
    return float(_csv_rows(path)[4][2])


def _opts(parser):
    return {a.option_strings[0]: (a.dest, a.default, a.type, a.nargs, a.required,
                                  type(a).__name__, None if a.choices is None else list(a.choices))
            for a in parser._actions if a.option_strings and a.dest != "help"}


def test_torch_cli_parser_matches_jax():
    jp, tp = jcli.make_parser(), tcli.make_parser()
    j, t = _opts(jp), _opts(tp)
    assert t.pop("-device") == ("device", None, str, None, False, "_StoreAction", None)
    assert t == j
    assert (tp.prefix_chars, tp.fromfile_prefix_chars) == (jp.prefix_chars, jp.fromfile_prefix_chars)


# ---- the tools -------------------------------------------------------------

@pytest.mark.parametrize("args", [["-data_type", "float"], ["-data_type", "uint8"],
                                  ["-dist_func", "mips", "-normalize"]],
                         ids=["float", "uint8", "mips_normalized"])
def test_torch_groundtruth_tool_matches_jax(files, args):
    u8 = "uint8" in args
    base, q = (files["b.u8bin"], files["q.u8bin"]) if u8 else (files["b.fbin"], files["q.fbin"])
    outs = []
    for main, extra, name in ((jgt.main, [], "j.ibin"), (tgt.main, CPU, "t.ibin")):
        path = str(files["dir"] / name)
        main(["-base_path", base, "-query_path", q, "-gt_path", path, "-k", "20"] + args + extra)
        outs.append(io.read_ibin(path))
    (ji, jd), (ti, td) = outs
    np.testing.assert_allclose(td, jd, rtol=1e-5)
    diff = ti != ji  # ids differ only between equal distances
    assert np.allclose(td[diff], jd[diff], rtol=1e-5)
    if u8:
        np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_torch_range_groundtruth_tool_matches_jax(files, kind):
    """The .rbin and the -nonzero_path .bin, byte for byte, at a radius with
    no pair within a relative 1e-5 of it."""
    base, q = ((files["b.u8bin"], files["q.u8bin"]) if kind == "uint8"
               else (files["b.fbin"], files["q.fbin"]))
    B = io.read_bin(base, io.infer_bin_dtype(base)).astype(np.float64)
    Qs = io.read_bin(q, io.infer_bin_dtype(q)).astype(np.float64)
    d = np.sort(((Qs[:, None] - B[None]) ** 2).sum(-1).ravel())
    i = int(0.02 * len(d))
    while d[i + 1] - d[i] <= 2e-4 * d[i]:
        i += 1
    rad = str((d[i] + d[i + 1]) / 2)
    got = []
    for main, extra, tag in ((jrgt.main, [], "j"), (trgt.main, CPU, "t")):
        gp, zp = str(files["dir"] / f"{tag}.rbin"), str(files["dir"] / f"{tag}.nz.bin")
        main(["-base_path", base, "-query_path", q, "-gt_path", gp, "-radius", rad,
              "-data_type", kind, "-nonzero_path", zp] + extra)
        got.append((open(gp, "rb").read(), open(zp, "rb").read()))
    assert got[0] == got[1]
    gt = io.read_range_ibin(str(files["dir"] / "t.rbin"))
    assert 0 < sum(len(g) > 0 for g in gt) < NQ


def test_torch_file_tools_match_jax(files):
    """vec_to_bin (.fvecs and .bvecs), crop and random_sample: byte for byte."""
    d = files["dir"]
    rng = np.random.default_rng(3)
    fv, bv = str(d / "x.fvecs"), str(d / "x.bvecs")
    with open(fv, "wb") as f:
        for row in rng.standard_normal((40, 6)).astype(np.float32):
            np.array([6], np.int32).tofile(f)
            row.tofile(f)
    with open(bv, "wb") as f:
        for row in rng.integers(0, 256, (40, 6)).astype(np.uint8):
            np.array([6], np.int32).tofile(f)
            row.tofile(f)
    runs = [(jv2b, tv2b, [fv], "fbin"), (jv2b, tv2b, [bv], "u8bin"),
            (jcrop, tcrop, [files["b.fbin"]], "fbin", "-n", "123"),
            (jsample, tsample, [files["b.u8bin"]], "u8bin", "-n", "77", "-seed", "5"),
            (jsample, tsample, [files["b.fbin"]], "fbin", "-n", "999")]
    for i, (jm, tm, ins, ext, *flags) in enumerate(runs):
        outs = [str(d / f"tool{i}.{tag}.{ext}") for tag in ("j", "t")]
        jm.main(ins + [outs[0]] + flags)
        tm.main(ins + [outs[1]] + flags)
        assert open(outs[0], "rb").read() == open(outs[1], "rb").read(), (i, ins)


# ---- the CLI ---------------------------------------------------------------

# the reference's flags for each builder (alg_type, types.h:196-209)
BUILDERS = {
    "vamana": ["-R", "12", "-L", "24", "-alpha", "1.2", "-two_pass", "1", "-quantize", "1"],
    "HCNNG": ["-num_clusters", "8", "-cluster_size", "100", "-mst_deg", "3"],
    "pyNNDescent": ["-R", "16", "-num_clusters", "4", "-cluster_size", "50", "-alpha", "1.2",
                    "-delta", "0.05"],
    "HNSW": ["-R", "8", "-L", "24", "-m_l", "0.34", "-alpha", "0.9"],
}
# recall@10 floors of the builds at -Q 32; a k-NN graph (pyNNDescent) of
# these 10 clusters searched from one start point stays on one island (the
# JAX CLI's own pyNNDescent build reaches 0.1667 on these flags and data)
FLOORS = {"vamana": 0.9, "HCNNG": 0.9, "pyNNDescent": 0.15, "HNSW": 0.9}


@pytest.fixture(scope="module")
def graphs(files):
    """Each builder's graph, built and saved once by the port's CLI, with the
    CSV of its -Q 32 search."""
    out = {}
    for name, flags in BUILDERS.items():
        g, res = str(files["dir"] / f"{name}.graph"), str(files["dir"] / f"{name}.build.csv")
        assert tcli.main(["-base_path", files["b.fbin"], "-query_path", files["q.fbin"],
                          "-gt_path", files["gt.ibin"], "-Q", "32", "-graph_outfile", g,
                          "-res_path", res] + flags + CPU) == 0
        out[name] = (g, res)
    return out


def _search_both(files, graph, tag, extra):
    """Both CLIs on one graph file at -Q 32 -> (JAX csv rows, port csv rows)."""
    out = []
    for main, dev, who in ((jcli.main, [], "j"), (tcli.main, CPU, "t")):
        res = str(files["dir"] / f"{tag}.{who}.csv")
        assert main(["-base_path", files["b.fbin"], "-query_path", files["q.fbin"],
                     "-gt_path", files["gt.ibin"], "-graph_path", graph, "-Q", "32",
                     "-res_path", res] + extra + dev) == 0
        out.append(_csv_rows(res))
    return out


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_torch_cli_builders_match_jax(files, graphs, builder):
    """The port's build reaches the recall floor, and both CLIs searching its
    graph file write the same CSV but for build time and QPS."""
    g, build_csv = graphs[builder]
    rows = _csv_rows(build_csv)
    assert rows[1][0] == builder and float(rows[1][3]) > 0
    assert _recall(build_csv) >= FLOORS[builder]
    quant = ["-quantize", "1"] if builder == "vamana" else []
    jrows, trows = _search_both(files, g, builder, quant)
    assert _without_time_and_qps(trows) == _without_time_and_qps(jrows)


@pytest.mark.parametrize("builder", list(BUILDERS))
def test_torch_cli_full_sweep(files, graphs, capsys, builder):
    """The full search_and_parse sweep (43 beams, 20 limits, the probe) on
    each builder's graph (vamana's on the q8 tier): every row prints, every
    bucket's row clears its bucket, and where the graph is navigable from
    the start point the top bucket's row has recall 1."""
    res = str(files["dir"] / f"sweep.{builder}.csv")
    quant = ["-quantize", "1"] if builder == "vamana" else []
    assert tcli.main(["-base_path", files["b.fbin"], "-query_path", files["q.fbin"],
                      "-gt_path", files["gt.ibin"], "-graph_path", graphs[builder][0],
                      "-res_path", res, "-verbose"] + quant + CPU) == 0
    printed = [l for l in capsys.readouterr().out.splitlines() if l.startswith("For 10@10")]
    assert len(printed) >= 43 + 20 + 1
    assert any("Q = 1000, cut = 10.0" in l for l in printed)
    rows = _csv_rows(res)[4:-2]
    assert rows and all(float(r[2]) >= float(r[1]) for r in rows)
    if FLOORS[builder] >= 0.9:
        assert float(rows[-1][2]) == 1.0


def test_torch_cli_cluster_matches_jax(files):
    """-algorithm cluster: the port builds and saves the index; both CLIs
    load the file and write the same CSV but for QPS (at one probe count:
    the JAX package compiles each)."""
    ci = str(files["dir"] / "ci.npz")
    base = ["-base_path", files["b.fbin"], "-query_path", files["q.fbin"],
            "-gt_path", files["gt.ibin"], "-algorithm", "cluster", "-cluster_m", "16"]
    assert tcli.main(base + ["-graph_outfile", ci, "-Q", "4"] + CPU) == 0
    out = []
    for main, dev, who in ((jcli.main, [], "j"), (tcli.main, CPU, "t")):
        res = str(files["dir"] / f"cluster.{who}.csv")
        assert main(base + ["-graph_path", ci, "-res_path", res, "-Q", "6"] + dev) == 0
        out.append(_without_time_and_qps(_csv_rows(res)))
    assert out[0] == out[1]
    assert float(out[1][-3][2]) >= 0.9
    # the port's own probe sweep (n_probe 4, 6, 8, ... until recall passes 0.999)
    res = str(files["dir"] / "cluster.sweep.csv")
    assert tcli.main(base + ["-graph_path", ci, "-res_path", res] + CPU) == 0
    rows = _csv_rows(res)[4:-2]
    assert rows and all(float(r[2]) >= float(r[1]) for r in rows)


@pytest.mark.parametrize("dist,mode", [("Euclidian", 1), ("Euclidian", 2), ("Euclidian", 3),
                                       ("mips", 2), ("mips", 4), ("mips", 5)])
def test_torch_cli_quantize_modes_match_jax(files, graphs, monkeypatch, dist, mode):
    """Each ported -quantize mode on one graph file: recall within 0.01 of
    the JAX CLI's. The port's JL tiers get the JAX package's matrix."""
    monkeypatch.setattr(tquantize, "jl_projection_matrix",
                        lambda d, jl, seed=0, sparse_nnz=0: torch.from_numpy(np.array(
                            jquantize.jl_projection_matrix(d, jl, seed, sparse_nnz))))
    jrows, trows = _search_both(files, graphs["vamana"][0], f"q{dist}{mode}",
                                ["-dist_func", dist, "-quantize", str(mode)])
    assert abs(float(trows[4][2]) - float(jrows[4][2])) <= 0.01, (trows[4], jrows[4])


@pytest.mark.parametrize("flags", [
    ["-dist_func", "mips", "-quantize", "3"],
    ["-single_batch", "8"],
    ["-quantize_bits", "4"],
    ["-dist_func", "mips", "-quantize", "1", "-trim", "0.01"],
], ids=["mips_2bit", "single_batch", "quantize_bits_4", "mips_trim"])
def test_torch_cli_unported_modes_raise(files, graphs, flags):
    """The four flags this test once saw refused now run in both CLIs. The
    MIPS 2-bit tier, the 4-bit scalar tier and the trimmed MIPS q8 tier
    (with the build's trimmed q8 points) search one graph file: recall
    within 0.01 of the JAX CLI's. A single-batch build replays the JAX
    build's draws on the q8 points: both CLIs build and search, and write
    the same CSV but for build time and QPS."""
    if flags[0] != "-single_batch":
        jrows, trows = _search_both(files, graphs["vamana"][0], "mode" + "".join(flags), flags)
        assert abs(float(trows[4][2]) - float(jrows[4][2])) <= 0.01, (trows[4], jrows[4])
        return
    out = []
    for main, dev, who in ((jcli.main, [], "j"), (tcli.main, CPU, "t")):
        res = str(files["dir"] / f"single_batch.{who}.csv")
        assert main(["-base_path", files["b.fbin"], "-query_path", files["q.fbin"],
                     "-gt_path", files["gt.ibin"], "-Q", "32", "-res_path", res]
                    + BUILDERS["vamana"] + flags + dev) == 0
        out.append(_without_time_and_qps(_csv_rows(res)))
    assert out[0] == out[1]
    assert float(out[1][4][2]) >= 0.9


def _lines(out):
    """Printed lines, with QPS and seconds masked."""
    out = re.sub(r"QPS = [0-9.e+]+", "QPS = -", out)
    return [l for l in out.splitlines() if l.strip()]


@pytest.mark.parametrize("mode", ["range", "self"])
def test_torch_cli_range_prints_match_jax(files, graphs, capsys, mode):
    X, Q = files["X"].astype(np.float64), files["Q"].astype(np.float64)
    other = X if mode == "self" else Q
    d = np.sort(((other[:, None] - X[None]) ** 2).sum(-1).ravel())
    i = int(0.01 * len(d)) + (N if mode == "self" else 0)  # past the zero self pairs
    while d[i + 1] - d[i] <= 2e-4 * d[i]:
        i += 1
    rad = str((d[i] + d[i + 1]) / 2)
    args = ["-base_path", files["b.fbin"], "-graph_path", graphs["vamana"][0], "-range",
            "-radius", rad]
    if mode == "self":
        args += ["-self", "-radius_2", rad]
    else:
        rgt = str(files["dir"] / "range_gt.rbin")
        trgt.main(["-base_path", files["b.fbin"], "-query_path", files["q.fbin"],
                   "-gt_path", rgt, "-radius", rad] + CPU)
        args += ["-query_path", files["q.fbin"], "-gt_path", rgt]
    capsys.readouterr()
    assert jcli.main(args) == 0
    jout = _lines(capsys.readouterr().out)
    assert tcli.main(args + CPU) == 0
    tout = _lines(capsys.readouterr().out)
    assert tout == jout
    if mode == "self":
        assert re.fullmatch(r"Self-join: [1-9]\d* edges, \d+ distance comparisons", tout[-1])
    else:
        assert len(tout) == 1 + 6  # the data line and beams 10-100 (1000+ > n)
