"""Synthetic datasets for tests and benchmarks.

Clustered Gaussian mixtures approximate the local structure of real ANN
benchmarks (SIFT-style): uniform random data has no neighborhood structure
and understates graph-index recall, so benchmarks default to clusters.
"""

from __future__ import annotations

import numpy as np


def clustered(
    n: int,
    d: int,
    n_queries: int = 0,
    n_clusters: int | None = None,
    cluster_std: float = 0.15,
    seed: int = 0,
    dtype=np.float32,
):
    """SIFT-like clustered data -> (base (n,d), queries (nq,d))."""
    rng = np.random.default_rng(seed)
    c = n_clusters if n_clusters is not None else max(16, n // 1000)
    centers = rng.standard_normal((c, d)).astype(np.float64)
    assign = rng.integers(0, c, n)
    base = centers[assign] + cluster_std * rng.standard_normal((n, d))
    queries = None
    if n_queries:
        qassign = rng.integers(0, c, n_queries)
        queries = centers[qassign] + cluster_std * rng.standard_normal((n_queries, d))
        queries = queries.astype(dtype)
    return base.astype(dtype), queries


def uniform(n: int, d: int, n_queries: int = 0, seed: int = 0,
            dtype=np.float32):
    """Single-blob standard normal — the ADVERSARIAL distribution for
    IVF-family structures (all pairwise distances concentrate; a query's
    true top-k scatters across cells). Graph indexes degrade gracefully
    here; benchmarks include it so the headline is dataset-honest."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(dtype)
    queries = (rng.standard_normal((n_queries, d)).astype(dtype)
               if n_queries else None)
    return base, queries


def heavy_tailed(
    n: int,
    d: int,
    n_queries: int = 0,
    n_clusters: int | None = None,
    seed: int = 0,
    dtype=np.float32,
):
    """Power-law cluster MASSES and lognormal cluster RADII — the
    skew real embedding corpora show (a few huge dense regions, a long
    tail of sparse ones). Stresses capacity balancing (hot clusters
    overflow m) and the beam's cut rule (radius heterogeneity)."""
    rng = np.random.default_rng(seed)
    c = n_clusters if n_clusters is not None else max(16, n // 1000)
    centers = rng.standard_normal((c, d)).astype(np.float64)
    # Zipf masses, normalized; radii lognormal around 0.35
    w = 1.0 / np.arange(1, c + 1) ** 1.2
    w /= w.sum()
    stds = 0.35 * np.exp(0.6 * rng.standard_normal(c))
    assign = rng.choice(c, n, p=w)
    base = centers[assign] + stds[assign, None] * rng.standard_normal((n, d))
    queries = None
    if n_queries:
        qa = rng.choice(c, n_queries, p=w)
        queries = centers[qa] + stds[qa, None] * rng.standard_normal(
            (n_queries, d))
        queries = queries.astype(dtype)
    return base.astype(dtype), queries


def sparse_clustered_u8(n: int, d: int, n_queries: int = 0, seed: int = 0):
    """BIGANN-class sparse clustered uint8 rows -> (base (n, d), queries
    (nq, d)), the construction of scripts/bench_mips_u8.py drawn with
    numpy: max(64, n // 100) centres, each coordinate nonzero with
    probability 0.35 and then Gamma(1.2) x 55; a row is its centre scaled
    coordinate-wise by Gamma(4) x 0.25, plus 4 x N(0, 1) noise, rounded and
    clipped to [0, 255]. Sparse rows keep normalized MIPS data spread out
    (dense positive bytes collapse into a narrow cone, where the alpha
    rule of robustPrune never fires; bench_mips_u8.py's note). Rows are
    drawn in chunks of 2^17 (centre ids, then the gammas, then the noise),
    so the chunk size is part of the construction and stays fixed."""
    chunk = 1 << 17
    rng = np.random.default_rng(seed)
    nc = max(64, n // 100)
    mask = rng.random((nc, d), dtype=np.float32) < 0.35
    centers = np.where(mask, rng.standard_gamma(1.2, (nc, d), dtype=np.float32) * 55.0,
                       0.0).astype(np.float32)

    def rows(m):
        out = np.empty((m, d), np.uint8)
        for lo in range(0, m, chunk):
            k = min(chunk, m - lo)
            x = centers[rng.integers(0, nc, k)]
            x *= rng.standard_gamma(4.0, (k, d), dtype=np.float32) * 0.25
            x += 4.0 * rng.standard_normal((k, d), dtype=np.float32)
            out[lo:lo + k] = np.clip(np.rint(x), 0, 255)
        return out

    base = rows(n)
    return base, (rows(n_queries) if n_queries else None)
