"""The flat exact search: ``FlatIndex`` on the float32 points with
``select="pallas"`` (kernel 4). Set-up only places the points."""

from __future__ import annotations

import torch


class System:
    def __init__(self, config: dict, points: torch.Tensor, seed: int, spans: dict):
        import parlayann_tpu_torch as pt
        from parlayann_tpu_torch.types import Metric

        data = config["data"]
        if points.shape[0] % 8:
            raise ValueError("the point count must be a multiple of 8 (the port's row pad)")
        ps = pt.PointSet(data=points, n=data["n"], d=data["d"],
                         metric=Metric.coerce(data["metric"]))
        self.index = pt.FlatIndex(ps, quantize=False)
        self.select = config["search"]["select"]

    def searcher(self, traffic: dict):
        """The search of a batch at the mix's k -> (ids, dists)."""
        index, k, select = self.index, traffic["k"], self.select
        return lambda queries: index.batch_search(queries, k=k, select=select)

    def state(self) -> dict:
        return {}
