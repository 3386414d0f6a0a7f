"""The host C++ library of the port: per-leaf Kruskal for HCNNG and the
capacity balancer of the ClusterIndex build.

Counterpart of parlayann_tpu/native.py's ``kruskal_leaves`` and
``balance_assign``. The sources are the port's own copies,
``csrc/kruskal.cpp`` and ``csrc/balance.cpp``; at first use g++ builds both
with OpenMP into one library in ``_build/`` under a name hashed from the
sources and the flags (as ``ops/kernels/_lib.py`` does for the CUDA
library), and ctypes loads it. A failed build raises: there is no fallback
to Python, which would hide a broken build behind a slow one.
``kruskal_leaves_plain`` is the Python loop (JAX native.py:98-128), kept
for the tests; the balancer's plain version is the numpy
``build/clusterindex.py:balance_assign``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "kruskal.cpp"
BALANCE_SOURCE = _PKG / "csrc" / "balance.cpp"
BUILD_DIR = _PKG / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-fopenmp")

_lock = threading.Lock()
_loaded: dict = {}


def build() -> Path:
    """Compile the sources unless a library of the same hash exists."""
    sources = (SOURCE, BALANCE_SOURCE)
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in sources)
                            + " ".join(FLAGS).encode())
    out = BUILD_DIR / f"libparlayann_host_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *FLAGS, *map(str, sources), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        names = ", ".join(p.name for p in sources)
        raise RuntimeError(f"g++ failed on {names} ({proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded host library (built at first use)."""
    with _lock:
        if "lib" not in _loaded:
            lib = ctypes.CDLL(str(build()))
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.kruskal_leaves.argtypes = [
                i32p, i32p, i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, i32p, i32p, i32p]
            lib.kruskal_leaves.restype = None
            lib.balance_assign.argtypes = [
                i32p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, i32p]
            lib.balance_assign.restype = ctypes.c_int32
            _loaded["lib"] = lib
        return _loaded["lib"]


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _prepare(edges_u, edges_v, leaf_sizes):
    edges_u = np.ascontiguousarray(edges_u, dtype=np.int32)
    edges_v = np.ascontiguousarray(edges_v, dtype=np.int32)
    leaf_sizes = np.ascontiguousarray(leaf_sizes, dtype=np.int32)
    n_leaves, E = edges_u.shape
    return (edges_u, edges_v, leaf_sizes, np.full((n_leaves, E), -1, dtype=np.int32),
            np.full((n_leaves, E), -1, dtype=np.int32), np.zeros(n_leaves, dtype=np.int32))


def kruskal_leaves(edges_u: np.ndarray, edges_v: np.ndarray, leaf_sizes: np.ndarray,
                   max_leaf_size: int, mst_deg: int):
    """Degree-bounded Kruskal per leaf over (n_leaves, E) leaf-local edges
    in ascending weight (invalid slots -1) -> (sel_u, sel_v, counts): each
    leaf's selected edges compacted to the front of its row."""
    edges_u, edges_v, leaf_sizes, out_u, out_v, counts = _prepare(
        edges_u, edges_v, leaf_sizes)
    if int(leaf_sizes.max(initial=0)) > max_leaf_size:
        raise ValueError(f"a leaf of {leaf_sizes.max()} points exceeds {max_leaf_size}")
    n_leaves, E = edges_u.shape
    library().kruskal_leaves(
        _i32p(edges_u), _i32p(edges_v), _i32p(leaf_sizes), n_leaves, E,
        max_leaf_size, mst_deg, _i32p(out_u), _i32p(out_v), _i32p(counts))
    return out_u, out_v, counts


def kruskal_leaves_plain(edges_u: np.ndarray, edges_v: np.ndarray,
                         leaf_sizes: np.ndarray, max_leaf_size: int, mst_deg: int):
    """:func:`kruskal_leaves` as a Python loop (the tests' reference)."""
    edges_u, edges_v, leaf_sizes, out_u, out_v, counts = _prepare(
        edges_u, edges_v, leaf_sizes)
    n_leaves, E = edges_u.shape
    for leaf in range(n_leaves):
        s = int(leaf_sizes[leaf])
        parent = list(range(s))
        deg = [0] * s

        def find(x):
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        taken = 0
        comps = s
        for e in range(E):
            u, v = int(edges_u[leaf, e]), int(edges_v[leaf, e])
            if u < 0 or v < 0 or u >= s or v >= s or u == v:
                continue
            if deg[u] >= mst_deg or deg[v] >= mst_deg:
                continue
            ru, rv = find(u), find(v)
            if ru == rv:
                continue
            parent[ru] = rv
            deg[u] += 1
            deg[v] += 1
            out_u[leaf, taken] = u
            out_v[leaf, taken] = v
            counts[leaf] = taken = taken + 1
            comps -= 1
            if comps == 1:
                break
    return out_u, out_v, counts


def balance_assign(nbr_ids: np.ndarray, order: np.ndarray, C: int, m: int) -> np.ndarray:
    """Capacity-balanced assignment of (n, k) candidate centroids, points
    taken in the priority ``order`` -> members (C, m) int32, -1 padded;
    the same function as the numpy ``build/clusterindex.py:balance_assign``
    (rank rounds, then the emptiest clusters' free slots). Raises
    ``ValueError`` when C * m < n."""
    nbr_ids = np.ascontiguousarray(nbr_ids, dtype=np.int32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    n, k = nbr_ids.shape
    members = np.full((C, m), -1, dtype=np.int32)
    rc = library().balance_assign(
        _i32p(nbr_ids), order.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n, k, C,
        m, _i32p(members))
    if rc != 0:
        raise ValueError("capacity < n: raise slack")
    return members
