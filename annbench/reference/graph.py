"""The invariants of a graph index's adjacency: every one of the n
vertices has 1 to R out-edges, each to another vertex below n, none
repeated."""

from __future__ import annotations

import torch


def faults(nbrs: torch.Tensor, degs: torch.Tensor, n: int, R: int) -> int:
    """Adjacency faults among the first n rows of (n_pad, R) ``nbrs`` with
    (n_pad,) ``degs``: a degree outside [1, R] (n > 1), and each out-edge
    out of range, to itself or repeated in its row."""
    nb = nbrs[:n].long()
    dg = degs[:n].long()
    bad = int(((dg < (1 if n > 1 else 0)) | (dg > R)).sum())
    used = torch.arange(nb.shape[1], device=nb.device)[None, :] < dg[:, None]
    me = torch.arange(n, device=nb.device)[:, None]
    bad += int((used & ((nb < 0) | (nb >= n) | (nb == me))).sum())
    # repeats: sort each row's used entries (unused ones pushed past n)
    s = torch.sort(torch.where(used, nb, n + torch.arange(nb.shape[1], device=nb.device)),
                   dim=1).values
    bad += int((s[:, 1:] == s[:, :-1]).sum())
    return bad
