"""The trimmed MIPS q8 tier against the plain q8 tier, in the JAX package
and in the port, on the CPU, over a cut of chip_smoke.py phase 11c's data.

Phase 11c draws 1M x 128 sparse clustered uint8 rows and 10,000 queries
(``synthetic.sparse_clustered_u8``, seed 7, the construction of
scripts/bench_mips_u8.py). This script draws the same arrays, keeps the
first 50,000 rows and 1,000 queries (normalized, as phase 11c does),
builds one Vamana graph with the JAX package (R=32, L=64, two passes,
batch_cap_frac=0.16, the MIPS alpha of 0.98), carries it into the port,
and searches it with each package's q8 tier and its q8 tier trimmed at
0.001, at each beam. If the trim costs both packages the same recall, the
data is at fault, not the port.

    python trim_parity.py

Prints one line per package, tier and beam, and last the recall gaps
(trimmed minus plain) of both packages as one JSON object.
"""

import json
import time

import numpy as np

K = 10
N, NQ = 50_000, 1000  # rows and queries kept of phase 11c's draw
BEAMS = (10, 22, 50)
SEED = 7  # chip_smoke.py's SEED
TRIM = 0.001


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import parlayann_tpu as jpt
    from parlayann_tpu.build.vamana import build_vamana_graph
    from parlayann_tpu.data.pointset import PointSet as JPointSet
    from parlayann_tpu.ops import quantize as jquantize
    from parlayann_tpu.types import BuildParams
    import parlayann_tpu_torch as pt
    from parlayann_tpu_torch import interop
    from parlayann_tpu_torch.harness.recall import compute_recall
    from parlayann_tpu_torch.search import exact
    from parlayann_tpu_torch.utils import synthetic

    X, Q = synthetic.sparse_clustered_u8(1_000_000, 128, n_queries=10_000, seed=SEED)
    X = np.ascontiguousarray(X[:N])
    Q = Q[:NQ].astype(np.float32)
    Q /= np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-30)

    # api.build_vamana_index's steps, with phase 11c's batch_cap_frac
    t0 = time.perf_counter()
    jps = JPointSet.from_numpy(X, metric="mips", normalize=True)
    bp = BuildParams(R=32, L=64, alpha=0.98, num_passes=2, batch_cap_frac=0.16)
    jg, _ = build_vamana_graph(jquantize.quantize_pointset(jps, bits=8), bp)
    print(f"JAX q8 build of {X.shape}: {time.perf_counter() - t0:.1f} s; "
          f"degree avg {float(np.asarray(jg.degrees)[:jg.n].mean()):.3f}", flush=True)
    pts = interop.pointset_from_state(np.asarray(jps.data), jps.n, jps.d, "mips",
                                      device="cpu")
    g = interop.graph_from_state(np.asarray(jg.neighbors), np.asarray(jg.degrees),
                                 jg.n, jg.max_degree, device="cpu")
    gt = exact.compute_groundtruth(pts, Q, 2 * K)

    recall = {}
    for pkg, make in (("jax", lambda: jpt.Index(points=jps, graph=jg)),
                      ("port", lambda: pt.Index(points=pts, graph=g))):
        for tier, trim in (("q8", 0.0), ("q8_trim", TRIM)):
            idx = make().enable_quantized(bits=8, trim=trim)
            for beam in BEAMS:
                ids = np.asarray(idx.batch_search(Q, k=K, beam_size=beam)[0])
                r = compute_recall(ids, gt[0], gt[1], K)
                recall[pkg, tier, beam] = r
                print(f"{pkg} {tier} beam={beam}: recall@{K} {r:.4f}", flush=True)
    gaps = {pkg: {beam: recall[pkg, "q8_trim", beam] - recall[pkg, "q8", beam]
                  for beam in BEAMS} for pkg in ("jax", "port")}
    print(json.dumps({"n": N, "queries": NQ, "trim": TRIM,
                      "trimmed_minus_plain": gaps}))


if __name__ == "__main__":
    main()
