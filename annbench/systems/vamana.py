"""A Vamana index on a scalar tier, searched through ``Index.batch_search``.

Set-up builds the graph through ``api.build_vamana_index`` with the
configuration's parameters and the port's defaults otherwise, then the
query handle ``Index(...).enable_quantized(bits)``. A search is the
entry top-1, ``translate_query``, kernel 3 (``beam_search_fused``) and
the float32 rerank.
"""

from __future__ import annotations

import time

import torch


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    def __init__(self, config: dict, points: torch.Tensor, seed: int, spans: dict):
        import parlayann_tpu_torch as pt
        from parlayann_tpu_torch.types import Metric

        data, b = config["data"], config["build"]
        n = data["n"]
        if points.shape[0] % 8:
            raise ValueError("the point count must be a multiple of 8 (the port's row pad)")
        ps = pt.PointSet(data=points, n=n, d=data["d"], metric=Metric.coerce(data["metric"]))
        t0 = time.perf_counter()
        graph, ps, _ = pt.build_vamana_index(
            ps, metric=data["metric"], R=b["R"], L=b["L"], alpha=b["alpha"],
            two_pass=b["two_pass"], quantize_build=b["quantize_bits"] == 8,
            batch_cap_frac=b["batch_cap_frac"], fused_read=b["fused_read"], seed=seed)
        _sync(points.device)
        spans["build_s"] = time.perf_counter() - t0
        self.index = pt.Index(points=ps, graph=graph).enable_quantized(config["search"]["bits"])
        self.R = b["R"]

    def searcher(self, traffic: dict):
        """The search of a batch at the mix's k and beam -> (ids, dists)."""
        index, k, beam = self.index, traffic["k"], traffic["beam"]

        def search(queries):
            ids, dists, _ = index.batch_search(queries, k=k, beam_size=beam)
            return ids, dists

        return search

    def state(self) -> dict:
        """What set-up derived, for the reference to judge."""
        t = self.index.qpoints
        return dict(tier=t.data, slope=t.quant_slope, offset=t.quant_offset, bits=t.bits,
                    nbrs=self.index.graph.neighbors, degs=self.index.graph.degrees, R=self.R)
