"""Kernel 2: robustPrune's α-occlusion rounds.

Counterpart of parlayann_tpu/ops/pallas/occlude.py:91 ``occlusion_rounds``.
For B rows of C candidates (sorted by distance to the pruned point, INF =
invalid) it runs R rounds: the first live candidate becomes the star and
kills every candidate c with ``alpha * d(star, c) <= d(p, c)``. The output
is the round in which each candidate became the star, ``R + C`` if never;
the caller recovers the (B, R) selection with one stable sort.

The CUDA kernel is ``csrc/occlude.cu``: one CTA a row (one warp for int8
vectors, four for f32); the occlusion tests of 16 candidates against the
later ones are made when the star first reaches them, from int8
tensor-core products (int8 vectors) or 3xTF32 tensor-core products (f32
vectors), and kept as bits; a round is bit arithmetic on the row's live
words. On f32 vectors a test whose tensor-core value lies within
:func:`occlusion_margin` of its threshold is decided again from the
serial dot product, so the rounds stay exact.
``occlusion_rounds_plain`` follows the JAX package's
``_occlusion_loop_xla`` (build/prune.py:111): one C x C pairwise matrix,
then R rounds of masks. On int8 candidates the matrix is one float32
matmul: every distance is an exact integer in both (below 2^24 for
d <= 258, where the f32 sums are exact), so the rounds are equal. On f32
candidates it is :func:`pairwise_ordered`, the serial order in which the
f32 kernel decides every test its tensor-core sum leaves in doubt, so the
rounds are equal bit for bit there too.
"""

from __future__ import annotations

import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops.distance import INF
from parlayann_tpu_torch.ops.kernels import _lib


def pairwise(cand_vecs: torch.Tensor, metric: Metric) -> torch.Tensor:
    """(B, C, d) -> (B, C, C) candidate-candidate distances in one float32
    batched matmul (int8 inputs are cast first: an int8 matmul wraps)."""
    v = cand_vecs.float()
    dot = torch.bmm(v, v.transpose(1, 2))
    if metric is Metric.MIPS:
        return -dot
    nrm = (v * v).sum(-1)
    return torch.clamp(nrm[:, :, None] - 2.0 * dot + nrm[:, None, :], min=0.0)


def pairwise_ordered(cand_vecs: torch.Tensor, metric: Metric,
                     max_elems: int = 1 << 24) -> torch.Tensor:
    """(B, C, d) float32 -> (B, C, C) in the serial order that the f32
    kernel's norms and rechecks use: each dot product and squared norm
    summed over the d values in order, one rounded product and one rounded
    add a term; L2 as max((n_i - 2 dot) + n_j, 0), MIPS as -dot. Rows go
    in chunks of at most ``max_elems`` pair entries."""
    B, C, d = cand_vecs.shape
    out = torch.empty((B, C, C), dtype=torch.float32, device=cand_vecs.device)
    step = max(1, max_elems // max(C * C, 1))
    for lo in range(0, B, step):
        vt = cand_vecs[lo:lo + step].transpose(1, 2)  # (b, d, C)
        dot = torch.zeros((vt.shape[0], C, C), dtype=torch.float32, device=vt.device)
        nrm = torch.zeros((vt.shape[0], C), dtype=torch.float32, device=vt.device)
        for k in range(d):
            col = vt[:, k]
            dot = dot + col[:, :, None] * col[:, None, :]
            nrm = nrm + col * col
        if metric is Metric.MIPS:
            out[lo:lo + step] = -dot
        else:
            out[lo:lo + step] = torch.clamp(
                (nrm[:, :, None] - 2.0 * dot) + nrm[:, None, :], min=0.0)
    return out


U = 2.0 ** -24  # the f32 unit roundoff


def dot_error_coeff(d: int) -> float:
    """c_d: |t - s| <= c_d * sum_k |a_k b_k| + 2^-100 for the f32 kernel's
    3xTF32 dot product t and the serial f32 dot product s of two d-vectors
    (the derivation is in ``csrc/occlude.cu``'s header): the split's dropped
    products (3.01 x 2^-20), the tensor core's accumulation (10 x 2^-23 an
    mma of 8 products, ceil(d / 8) of them a chain), t's two f32 adds
    (2^-23) and the serial sum's gamma_d."""
    g = d * U / (1.0 - d * U)
    return 3.01 * 2.0 ** -20 + 2.0 ** -23 * (1.0 + 10.04 * ((d + 7) // 8)) + g


def occlusion_margin(n_i, n_j, d: int, alpha: float, metric: Metric):
    """The f32 kernel's margin M (``csrc/occlude.cu:make_margin``, in float64):
    4 x the bound on |alpha pair(t) - alpha pair(s)| from the serial
    squared norms ``n_i`` and ``n_j`` (arrays or tensors). A test with
    |alpha pair(t) - d(p, c)| <= M is rechecked serially."""
    g = d * U / (1.0 - d * U)
    c, s, a = dot_error_coeff(d), 1.0 + 2.0 * g, abs(float(alpha))
    root = (n_i * n_j) ** 0.5
    if metric is Metric.MIPS:
        return 4 * a * (c + 3 * U) * s * root + 4 * a * 2.0 ** -100
    return 8 * a * c * s * root + 52 * a * U * (n_i + n_j) + 8 * a * 2.0 ** -100


def occlusion_rounds_plain(cand_dists: torch.Tensor, cand_vecs: torch.Tensor,
                           alpha, *, R: int, metric: Metric) -> torch.Tensor:
    """The kernel's function in PyTorch -> (B, C) int32 rounds."""
    B, C = cand_dists.shape
    lane = torch.arange(C, device=cand_dists.device)
    pair_d = (pairwise_ordered(cand_vecs, metric)
              if cand_vecs.dtype == torch.float32 else pairwise(cand_vecs, metric))
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=cand_dists.device)
    dead = cand_dists >= INF
    rounds = torch.full((B, C), R + C, dtype=torch.int32, device=cand_dists.device)
    for r in range(R):
        alive = ~dead
        any_alive = alive.any(dim=1)
        if not bool(any_alive.any()):
            break
        # first live lane (argmax over an int mask returns the first max)
        star = alive.to(torch.int32).argmax(dim=1)
        onehot = (lane[None, :] == star[:, None]) & any_alive[:, None]
        rounds = torch.where(onehot, r, rounds)
        d_sp = pair_d[torch.arange(B, device=star.device), star]  # (B, C)
        occl = alpha * d_sp <= cand_dists
        dead = dead | ((occl | onehot) & any_alive[:, None])
    return rounds


def occlusion_rounds(cand_dists: torch.Tensor, cand_vecs: torch.Tensor, alpha,
                     *, R: int, metric: Metric,
                     counts: torch.Tensor | None = None) -> torch.Tensor:
    """-> (B, C) int32: selection round per candidate, R + C if unselected.
    CPU tensors run :func:`occlusion_rounds_plain`; CUDA tensors launch the
    kernel, which takes f32 distances and int8 vectors (any alignment) of
    any C and d with C * d + 8 C <= 227 KB, or f32 vectors of any C and d
    (those launches are also counted in ``launches_f32``). A row whose
    workspace does not fit one CTA's shared memory, or with more than 1024
    candidates, runs the kernel's global-memory variant. ``counts``, an
    int64 tensor of 2 on the card, gains the f32 tensor-core tests the
    rounds can read and the rechecks among them (int8 vectors and the
    global-memory variant add nothing; the plain version leaves it as it
    is)."""
    if not _lib.route(cand_dists, cand_vecs):
        return occlusion_rounds_plain(cand_dists, cand_vecs, alpha, R=R,
                                      metric=metric)
    _lib.require(cand_dists, "cand_dists", torch.float32, 2)
    f32 = cand_vecs.dtype == torch.float32
    _lib.require(cand_vecs, "cand_vecs", torch.float32 if f32 else torch.int8, 3)
    B, C = cand_dists.shape
    d = cand_vecs.shape[2]
    if cand_vecs.shape[:2] != (B, C):
        raise ValueError(f"shape mismatch: cand_dists {tuple(cand_dists.shape)}, "
                         f"cand_vecs {tuple(cand_vecs.shape)}")
    if not f32 and C * d + 8 * C > 227 * 1024:
        raise ValueError(f"C={C} candidates of d={d} bytes exceed one block's "
                         "shared memory")
    if counts is not None:
        _lib.require(counts, "counts", torch.int64, 1)
        if counts.numel() != 2 or counts.device != cand_dists.device:
            raise ValueError("counts must hold 2 int64 on the inputs' device")
    rounds = torch.empty((B, C), dtype=torch.int32, device=cand_dists.device)
    if B == 0:
        return rounds
    fn = _lib.function(
        "pa_occlusion_rounds",
        [_lib.VP, _lib.VP, _lib.FLOAT, _lib.VP] + [_lib.INT] * 6 + [_lib.VP, _lib.VP])
    rc = fn(cand_dists.data_ptr(), cand_vecs.data_ptr(), float(alpha),
            rounds.data_ptr(), B, C, d, R, int(metric is Metric.MIPS), int(f32),
            None if counts is None else counts.data_ptr(), _lib.stream())
    occlusion_rounds.launches += 1
    occlusion_rounds.launches_f32 += f32
    _lib.check(rc, "occlusion_rounds")
    return rounds


occlusion_rounds.launches = 0
occlusion_rounds.launches_f32 = 0
