"""Kernel 2's f32 margin against emulated 3xTF32 dot products, on the CPU.

``csrc/occlude.cu`` decides an f32 α-test from a 3xTF32 tensor-core dot
product t unless |alpha pair(t) - d(p, c)| <= M, and then from the serial
f32 dot product s that the plain version sums. The rounds are exact only
if M bounds |alpha pair(t) - alpha pair(s)|. Here t is emulated bit for
bit up to its summation order, from the products lo_a hi_b, hi_a lo_b and
hi_a hi_b (exact in f32) of two splits: ``tf32.cuh:split_tf32``
(``cvt.rna.tf32`` on the f32 bit patterns, hi = rna(a), lo = rna(a - hi),
as kernel 4 splits) and the kernel's own ``split_tf32_rz`` (hi = a with
its low 13 bits cleared, lo = a - hi, which the tensor core reads with its
low 13 bits dropped or, to be safe, rounded). The products are summed in
several orders: forward, reverse and pairwise in one f32 accumulator, and
the kernel's own (three chains of 8-product blocks, each block added to
its chain with one rounding, to nearest or toward zero, then big + (lo1 +
lo2)). For every split and order |t - s| must stay within
``dot_error_coeff(d) * sqrt(n_i n_j) (1 + 2 g_d) + 2^-100``, the derived
bound before the kernel's 4x, and |alpha pair(t) - alpha pair(s)| within
``occlusion_margin``, under L2 and MIPS. Rows: normal values, integer
values in [0, 256) (the uint8 builds' float32 copies, where t = s
exactly), and values spread over 2^-20..2^20; d in {21, 100, 128, 256}.
"""

import numpy as np
import pytest
import torch

from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.ops.kernels.occlude import U, dot_error_coeff, occlusion_margin

P = 512  # vector pairs per case


def _bits(x):
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _float(b):
    return torch.where(b >= 2 ** 31, b - 2 ** 32, b).to(torch.int32).view(torch.float32)


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 as tf32.cuh writes it: add half a TF32 ulp to the
    bit pattern, clear the low 13 bits."""
    return _float((_bits(x) + 0x1000) & 0xFFFFE000)


def tf32_rz(x: torch.Tensor) -> torch.Tensor:
    """The low 13 bits cleared: what the tensor core reads of an f32."""
    return _float(_bits(x) & 0xFFFFE000)


SPLITS = {
    "rna": lambda x: (tf32_rna(x), tf32_rna(x - tf32_rna(x))),
    "rz_lo_dropped": lambda x: (tf32_rz(x), tf32_rz(x - tf32_rz(x))),
    "rz_lo_rounded": lambda x: (tf32_rz(x), tf32_rna(x - tf32_rz(x))),
}


def serial_dot(a, b):
    """The plain version's order: one rounded product and one rounded add
    a term."""
    acc = torch.zeros(a.shape[0], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = acc + a[:, k] * b[:, k]
    return acc


def to_f32_toward_zero(x64):
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def tf32_sums(a, b, split):
    """{order: t} for the 3xTF32 products of a and b."""
    ah, al = split(a)
    bh, bl = split(b)
    lh, hl, hh = al * bh, ah * bl, ah * bh  # exact: TF32 x TF32 fits f32
    terms = torch.stack([lh, hl, hh], dim=2).reshape(a.shape[0], -1)  # per k
    out = {}
    acc = torch.zeros(a.shape[0], dtype=torch.float32)
    for j in range(terms.shape[1]):
        acc = acc + terms[:, j]
    out["forward"] = acc
    acc = torch.zeros_like(acc)
    for j in reversed(range(terms.shape[1])):
        acc = acc + terms[:, j]
    out["reverse"] = acc
    level = terms
    while level.shape[1] > 1:
        if level.shape[1] % 2:
            level = torch.cat([level, torch.zeros_like(level[:, :1])], dim=1)
        level = level[:, 0::2] + level[:, 1::2]
    out["pairwise"] = level[:, 0]
    d = a.shape[1]
    for name, rnd in (("kernel_rn", lambda x: x.float()), ("kernel_rz", to_f32_toward_zero)):
        chains = []
        for prod in (hh, lh, hl):
            acc = torch.zeros(a.shape[0], dtype=torch.float32)
            for k0 in range(0, d, 8):  # one mma: 8 products into the accumulator
                acc = rnd(acc.double() + prod[:, k0:k0 + 8].double().sum(1))
            chains.append(acc)
        out[name] = chains[0] + (chains[1] + chains[2])
    return out


def pair_value(dot, ni, nj, alpha, metric):
    """alpha * pair in f32 as kernel and plain version form it."""
    a = torch.tensor(alpha, dtype=torch.float32)
    if metric is Metric.MIPS:
        return a * (-dot)
    return a * torch.clamp((ni - 2.0 * dot) + nj, min=0.0)


def rows(kind, d, gen):
    if kind == "normal":
        x = gen.standard_normal((2, P, d))
    elif kind == "integer":
        x = gen.integers(0, 256, (2, P, d))
    else:  # wide: each value's magnitude spread over 2^-20 .. 2^20
        x = gen.standard_normal((2, P, d)) * np.exp2(gen.uniform(-20, 20, (2, P, d)))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("d", [21, 100, 128, 256])
@pytest.mark.parametrize("kind", ["normal", "integer", "wide"])
def test_torch_occlude_tf32_margin_covers_tf32_sums(kind, d):
    gen = np.random.default_rng(d)
    a, b = rows(kind, d, gen)
    s = serial_dot(a, b)
    ni, nj = serial_dot(a, a), serial_dot(b, b)
    g = d * U / (1 - d * U)
    root = (ni.double() * nj.double()).sqrt()
    bound = dot_error_coeff(d) * root * (1 + 2 * g) + 2.0 ** -100
    assert bool((a.double() * b.double()).abs().sum(1).le(root * (1 + 2 * g)).all())
    for name, split in SPLITS.items():
        for order, tv in tf32_sums(a, b, split).items():
            err = (tv.double() - s.double()).abs()
            assert bool((err <= bound).all()), (name, order, float((err / bound).max()))
            if kind == "integer":  # integer sums below 2^24: exact in every order
                assert torch.equal(tv, s), (name, order)
            for metric in (Metric.L2, Metric.MIPS):
                for alpha in (1.0, 1.2, 1 / 0.9):
                    vt = pair_value(tv, ni, nj, alpha, metric).double()
                    vs = pair_value(s, ni, nj, alpha, metric).double()
                    m = occlusion_margin(ni.double(), nj.double(), d, alpha, metric)
                    assert bool(((vt - vs).abs() <= m).all()), (name, order, metric, alpha)


def test_torch_occlude_tf32_margin_is_narrow():
    """The margin stays a small fraction of the pair's scale, so few tests
    fall inside it: at most 3e-4 of sqrt(n_i n_j) at d = 128, alpha = 1.2
    (chip_smoke.py prints the card's recheck share), and it grows with d."""
    for metric in (Metric.L2, Metric.MIPS):
        m = occlusion_margin(1.0, 1.0, 128, 1.2, metric)
        assert 0 < m <= 3e-4
        assert (occlusion_margin(1.0, 1.0, 256, 1.2, metric)
                > occlusion_margin(1.0, 1.0, 21, 1.2, metric))
    assert dot_error_coeff(128) < 3e-5
