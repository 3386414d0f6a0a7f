"""A hierarchical ClusterIndex on the q8 tier, searched through
``ClusterIndex.search``.

Set-up builds the index through ``api.build_cluster_index`` with the
configuration's m, Rc, slack, cand and ext layout, seeded from the run's
seed, under the port's span recorder: the stream seconds of the build's
``build.assign`` and ``build.polish`` spans go to the run's spans as
``route_s`` and ``polish_s`` (absent where the port records no such
span). A search is the query translation, the seed (meta-routed past the
port's argmin cutoff), kernel 5's walk, the pool's sort and the float32
rerank, at the mix's k, n_probe, cut, starts, seed_probes and rerank
factor.
"""

from __future__ import annotations

import torch

SEARCH = ("n_probe", "min_probe", "cut", "starts", "seed_probes", "rerank_factor")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stream_s(spans, root, name):
    """Stream seconds of the spans ``name`` under ``root``, None if none
    has a stream time (none recorded, or no card)."""
    got = [s.stream_ms for s in spans
           if s.root == root.id and s.name == name and s.stream_ms is not None]
    return sum(got) * 1e-3 if got else None


class System:
    def __init__(self, config: dict, points: torch.Tensor, seed: int, spans: dict):
        import parlayann_tpu_torch as pt
        from parlayann_tpu_torch.types import Metric
        from parlayann_tpu_torch.utils import trace

        data, b = config["data"], config["build"]
        if points.shape[0] % 8:
            raise ValueError("the point count must be a multiple of 8 (the port's row pad)")
        ps = pt.PointSet(data=points, n=data["n"], d=data["d"],
                         metric=Metric.coerce(data["metric"]))
        with trace.recording(keep=False):
            self.index = pt.build_cluster_index(
                ps, m=b["m"], Rc=b["Rc"], slack=b["slack"], cand=b["cand"],
                ext_dtype=b["ext_dtype"], seed=seed)
            _sync(points.device)
            got = trace.spans()
        roots = [s for s in got if s.name == "build" and s.parent is None]
        if roots:
            for key, name in (("route_s", "build.assign"), ("polish_s", "build.polish")):
                value = stream_s(got, roots[-1], name)
                if value is not None:
                    spans[key] = value
        self.params = {}
        self.asked = {}  # the batches searched, by their first element's address

    def searcher(self, traffic: dict):
        """The search of a batch at the mix's settings -> (ids, dists)."""
        index, asked = self.index, self.asked
        kw = {key: traffic[key] for key in SEARCH}
        self.params = dict(kw, k=traffic["k"])

        def search(queries):
            asked.setdefault(queries.data_ptr(), queries)
            ids, dists, _ = index.search(queries, k=traffic["k"], **kw)
            return ids, dists

        return search

    def state(self) -> dict:
        """What set-up derived, for the reference to judge, and the queries
        the index was asked (None before the first): the pool's slots, views
        of one tensor, in the order of their addresses."""
        ci = self.index
        t = ci.qpoints
        seed = None
        if ci.seed_meta is not None:
            seed = tuple(ci.seed_meta)
        return dict(tier=t.data, slope=t.quant_slope, offset=t.quant_offset, bits=t.bits,
                    members=ci.members, adj=ci.adj, centroids=ci.centroids_q[:ci.C],
                    seed=seed, m=ci.m, Rc=ci.Rc, search=self.params,
                    queries=torch.cat([self.asked[a] for a in sorted(self.asked)])
                    if self.asked else None)
