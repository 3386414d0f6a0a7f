"""GraphIndexData — the padded fixed-degree adjacency.

Counterpart of parlayann_tpu/data/graph.py: ``neighbors (n_pad, max_degree)
int32`` and ``degrees (n_pad,) int32`` tensors. Slots ``>= degree`` are
padding and must be masked by consumers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from parlayann_tpu_torch.data.pointset import pad_to
from parlayann_tpu_torch.utils.device import resolve


@dataclasses.dataclass
class GraphIndexData:
    neighbors: torch.Tensor  # (n_pad, max_degree) int32
    degrees: torch.Tensor  # (n_pad,) int32
    n: int
    max_degree: int

    @property
    def n_pad(self) -> int:
        return self.neighbors.shape[0]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    @staticmethod
    def from_numpy(neighbors: np.ndarray, degrees: np.ndarray, n=None,
                   row_pad: int = 8, device=None) -> "GraphIndexData":
        """``device=None`` is the card (utils/device.py:resolve)."""
        device = resolve(device)
        n = n if n is not None else neighbors.shape[0]
        max_degree = neighbors.shape[1]
        n_p = pad_to(max(n, 1), row_pad)
        if n_p != neighbors.shape[0]:
            pad = n_p - neighbors.shape[0]
            neighbors = np.concatenate(
                [neighbors, np.zeros((pad, max_degree), neighbors.dtype)]
            )
            degrees = np.concatenate([degrees, np.zeros(pad, degrees.dtype)])
        return GraphIndexData(
            neighbors=torch.tensor(np.asarray(neighbors, dtype=np.int32)).to(device),
            degrees=torch.tensor(np.asarray(degrees, dtype=np.int32)).to(device),
            n=n,
            max_degree=max_degree,
        )

    def stats(self) -> tuple[float, int]:
        """Average and max degree (stats.h:47-55 graph_stats_)."""
        deg = self.degrees[: self.n].cpu().numpy()
        return float(deg.mean()), int(deg.max())
