"""Points and queries drawn from ``--seed`` on the device.

The mixture of ``parlayann_tpu_torch/utils/synthetic.py:clustered`` (the
shapes of ``bench.py``'s data: standard normal centres, each row a centre
plus ``cluster_std`` times standard normal noise), drawn with a
``torch.Generator`` on the device in a few large calls instead of numpy on
the host. The same seed on the same device gives the same tensors.
"""

from __future__ import annotations

import torch

SEED_MASK = (1 << 63) - 1


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & SEED_MASK)
    return g


def clustered(n: int, d: int, n_queries: int, clusters: int, cluster_std: float,
              seed: int, device: torch.device):
    """-> (points (n, d), queries (n_queries, d)), float32 on ``device``:
    ``clusters`` centres, every point and query of a centre drawn
    uniformly."""
    g = generator(seed, device)
    centres = torch.randn((clusters, d), generator=g, device=device)

    def rows(m):
        out = centres[torch.randint(0, clusters, (m,), generator=g, device=device)]
        out.add_(torch.randn((m, d), generator=g, device=device), alpha=cluster_std)
        return out

    return rows(n), rows(n_queries)


GENERATORS = {"clustered": clustered}


def make(config: dict, n_queries: int, seed: int, device: torch.device):
    """The configuration's points and a pool of ``n_queries`` queries."""
    spec = config["data"]
    if spec["dtype"] != "float32":
        raise ValueError(f"only float32 data is generated, not {spec['dtype']}")
    gen = GENERATORS[spec["generator"]]
    return gen(spec["n"], spec["d"], n_queries, spec["clusters"],
               spec["cluster_std"], seed, device)
