"""The entry top-1 on the CPU (``ops/kernels/entry.py``, ``index.py``):
the wrapper's plain path equals the former (B, E) matmul and argmin bit
for bit, the tier (float32 rows, bias, int32 ids) is made once a tier and
again when another tier is installed, the packed tier is the TF32 split,
and the kernel's plan (one wave of CTAs over the work items, the row
blocks that several CTAs share) covers every item once. The kernel itself
runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

import parlayann_tpu_torch as pt
from parlayann_tpu_torch import index as index_mod
from parlayann_tpu_torch import interop
from parlayann_tpu_torch.index import Index
from parlayann_tpu_torch.ops.kernels.entry import (
    ENTRY_TILE, PACK, ROWS, EntryTier, entry_bias, entry_pack, entry_tier, entry_top1,
    entry_top1_plain, grid)
from parlayann_tpu_torch.types import Metric
from parlayann_tpu_torch.utils import synthetic

torch.set_num_threads(1)


def _former(q, evecs, eids, metric):
    """The entry top-1 as the port computed it before the kernel: one (B, E)
    float32 matmul, the bias pass and a row argmin."""
    ev = evecs.float()
    dot = q.float() @ ev.T
    if metric is Metric.MIPS:
        dist = -dot
    else:
        dist = (ev * ev).sum(dim=1)[None, :] - 2.0 * dot
    return eids[dist.argmin(dim=1)][:, None]


@pytest.fixture(scope="module")
def built():
    X, Q = synthetic.clustered(1200, 16, n_queries=40, n_clusters=16,
                               cluster_std=0.35, seed=7)
    graph, ps, _ = pt.build_vamana_index(X, R=16, L=32, alpha=1.2, device="cpu")
    return X, Q, graph, ps


@pytest.mark.parametrize("src", ["f32", "u8"])
@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("B,E,d", [(1, 300, 16), (257, 1000, 37), (64, 4096, 128),
                                   (33, 500, 200)])
def test_plain_path_equals_the_former_chain(B, E, d, metric, src):
    """CPU tensors take the plain path, which is the former arithmetic bit
    for bit, through the wrapper over the tier and through the plain
    version itself."""
    g = np.random.default_rng(B + E + d)
    q = torch.from_numpy(g.normal(30, 20, (B, d)).astype(np.float32))
    if src == "u8":
        ev = torch.from_numpy(g.integers(0, 256, (E, d)).astype(np.uint8))
    else:
        ev = torch.from_numpy(g.normal(30, 20, (E, d)).astype(np.float32))
    eids = torch.from_numpy(g.permutation(3 * E)[:E].astype(np.int32))
    want = _former(q, ev, eids, metric)
    got = entry_top1(q, entry_tier(ev, eids, metric))
    assert torch.equal(got, want) and got.dtype == torch.int32
    evf = ev.float()
    assert torch.equal(entry_top1_plain(q, evf, entry_bias(evf, metric), eids,
                                        metric=metric), want)


def test_plain_path_ties_take_the_lowest_position():
    ev = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 0.0], [0.0, 1.0]])
    q = torch.tensor([[1.0, 0.0], [0.0, 2.0], [0.5, 0.5]])
    eids = torch.tensor([10, 11, 12, 13], dtype=torch.int32)
    for metric in (Metric.L2, Metric.MIPS):
        got = entry_top1(q, entry_tier(ev, eids, metric))
        assert got[:, 0].tolist() == [10, 11, 10]


def test_bias_is_the_squared_norms_or_zero():
    ev = torch.tensor([[3.0, 4.0], [1.0, -1.0]])
    assert entry_bias(ev, Metric.L2).tolist() == [25.0, 2.0]
    assert entry_bias(ev, Metric.MIPS).tolist() == [0.0, 0.0]


@pytest.mark.parametrize("metric", [Metric.L2, Metric.MIPS])
@pytest.mark.parametrize("dtype", [torch.float32, torch.uint8, torch.int8])
def test_tier_from_any_entry_dtype(dtype, metric):
    """entry_tier: the float32 rows (the same tensor when it already is
    one), their bias, the int32 ids; no pack off the card."""
    g = np.random.default_rng(5)
    ev = torch.from_numpy(g.integers(-100, 100, (70, 24))).to(dtype)
    ids = torch.arange(70, dtype=torch.int64) * 3
    tier = entry_tier(ev, ids, metric)
    assert tier.rows.dtype == torch.float32 and tier.rows.is_contiguous()
    assert torch.equal(tier.rows, ev.float()) and tier.metric is metric
    assert (tier.rows is ev) is (dtype == torch.float32)
    assert torch.equal(tier.bias, entry_bias(tier.rows, metric))
    assert tier.ids.dtype == torch.int32 and torch.equal(tier.ids.long(), ids)
    assert tier.pack is None


def _count_tiers(monkeypatch):
    """-> the sizes of the tiers that Index makes from now on."""
    calls = []

    def counted(ev, ids, metric):
        calls.append(ev.shape[0])
        return entry_tier(ev, ids, metric)

    monkeypatch.setattr(index_mod, "entry_tier", counted)
    return calls


def test_entry_state_made_once_a_tier(built, monkeypatch):
    """The tier's float32 rows, bias and ids are made when the tier is
    built and reused by every search; its starts are the former chain's."""
    X, Q, graph, ps = built
    calls = _count_tiers(monkeypatch)
    idx = Index(points=ps, graph=graph, entry_min_n=0).enable_quantized(bits=8)
    idx.build_entry_cache(E=256, seed=3)
    assert calls == [256]
    tier = idx._entry_tier()
    for _ in range(3):
        idx.batch_search(Q, k=5, beam_size=16)
    assert calls == [256] and idx._entry_tier() is tier
    assert isinstance(tier, EntryTier) and tier.pack is None  # made on the card only
    assert tier.rows.dtype == torch.float32 and tier.ids.dtype == torch.int32
    assert torch.equal(tier.bias, (tier.rows * tier.rows).sum(dim=1))
    qf = torch.as_tensor(Q, dtype=torch.float32)
    assert torch.equal(entry_top1(qf, tier),
                       _former(qf, idx.entry_vecs, idx.entry_ids, ps.metric))


@pytest.mark.parametrize("what", ["vecs", "ids", "both"])
def test_entry_state_rebuilt_when_another_tier_is_installed(built, monkeypatch, what):
    """A tier installed as ``interop`` and the HNSW index install it (new
    ``entry_vecs`` / ``entry_ids`` tensors) gets its own state at the next
    search, and only then."""
    X, Q, graph, ps = built
    idx = Index(points=ps, graph=graph, entry_min_n=0).enable_quantized(bits=8)
    idx.build_entry_cache(E=128, seed=1)
    calls = _count_tiers(monkeypatch)
    ids = torch.arange(0, 400, 3, dtype=torch.int32)
    if what in ("vecs", "both"):
        idx.entry_vecs = ps.data[idx.entry_ids.long()].clone()
    if what in ("ids", "both"):
        idx.entry_ids = ids[:idx.entry_vecs.shape[0]]
        idx.entry_vecs = ps.data[idx.entry_ids.long()]
    idx.batch_search(Q, k=5, beam_size=16)
    idx.batch_search(Q, k=5, beam_size=16)
    assert len(calls) == 1
    tier = idx._entry_tier()
    assert torch.equal(tier.rows, idx.entry_vecs.float())
    assert torch.equal(tier.ids, idx.entry_ids)


def test_interop_installed_tier_state(built, monkeypatch):
    X, Q, graph, ps = built
    calls = _count_tiers(monkeypatch)
    sample = np.random.default_rng(2).choice(ps.n, 200, replace=False).astype(np.int64)
    idx = interop.index_from_state(ps, graph, entry_ids=sample)
    idx.entry_min_n = 0
    idx.enable_quantized(bits=8)
    a = idx.batch_search(Q, k=5, beam_size=16)[0]
    b = idx.batch_search(Q, k=5, beam_size=16)[0]
    assert calls == [200] and torch.equal(a, b)
    assert idx._entry_tier().ids.dtype == torch.int32


def test_hnsw_base_index_entry_state():
    """HNSW's base index takes level 1's members as its entry tier; the
    state is made at its first search, from those members."""
    X, Q = synthetic.clustered(3000, 16, n_queries=20, n_clusters=16,
                               cluster_std=0.35, seed=5)
    hnsw, _, _ = pt.build_hnsw_index(X, m=8, efc=24, device="cpu", batch_cap_frac=0.2)
    hnsw.batch_search(Q, k=5, ef=24)
    base = hnsw._base_index()
    tier = base._entry_tier()
    assert base._entry_src[0] is base.entry_vecs and base._entry_src[1] is base.entry_ids
    assert torch.equal(tier.ids, base.entry_ids.to(torch.int32))
    assert torch.equal(tier.bias, (tier.rows * tier.rows).sum(dim=1))


@pytest.mark.parametrize("d", [16, 37, 100, 128, 129, 200, 960])
def test_pack_is_the_tf32_split(d):
    """entry_pack: each row's TF32 hi parts (low 13 bits clear, the value
    rounded to nearest), then its lo parts, over d rounded up to 32 with
    zeros; hi + lo is the value to within 2^-22 relative."""
    g = np.random.default_rng(d)
    ev = torch.from_numpy(g.normal(30, 20, (50, d)).astype(np.float32))
    pk = entry_pack(ev)
    dp = -(-d // PACK) * PACK
    assert pk.shape == (50, 2 * dp) and pk.dtype == torch.float32
    hi, lo = pk[:, :dp], pk[:, dp:]
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool((hi[:, d:] == 0).all() and (lo[:, d:] == 0).all())
    assert bool(((hi[:, :d] - ev).abs() <= ev.abs() * 2.0 ** -11).all())
    err = (hi[:, :d].double() + lo[:, :d].double() - ev.double()).abs()
    assert bool((err <= ev.abs().double() * 2.0 ** -22).all())


def _owners(W, G):
    """csrc/entry.cu's split: CTA c takes work items [c W / G, (c + 1) W / G);
    owner(w) as the kernel computes it."""
    ranges = [(c * W // G, (c + 1) * W // G) for c in range(G)]
    owner = [((w + 1) * G - 1) // W for w in range(W)]
    return ranges, owner


@pytest.mark.parametrize("B,E,slots", [(1, 4096, 132), (10_000, 4096, 132), (777, 1000, 132),
                                       (64, 40_000, 132), (5, 40_000, 264), (100_000, 4096, 132),
                                       (2000, 513, 132), (129, 128, 132), (96, 100, 2),
                                       (10_000, 40_000, 132), (1, 1, 132)])
def test_grid_covers_every_work_item_once(B, E, slots):
    """One wave over the R x T (row block, tile) items: every CTA takes a
    contiguous, non-empty, even share; the kernel's owner() agrees with the
    shares; a row block that several CTAs share implies G != R, which is
    when the wrapper hands the kernel its merge workspace."""
    R, T, G = grid(B, E, slots)
    assert R == -(-B // ROWS) and T == -(-E // ENTRY_TILE)
    assert G == min(R * T, slots)
    W = R * T
    ranges, owner = _owners(W, G)
    assert ranges[0][0] == 0 and ranges[-1][1] == W
    assert all(lo < hi for lo, hi in ranges)
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert max(hi - lo for lo, hi in ranges) - min(hi - lo for lo, hi in ranges) <= 1
    assert all(ranges[owner[w]][0] <= w < ranges[owner[w]][1] for w in range(W))
    shared = [owner[rb * T] != owner[rb * T + T - 1] for rb in range(R)]
    if any(shared):
        assert G != R
    if G == R:
        assert ranges == [(rb * T, rb * T + T) for rb in range(R)]


def test_wrapper_rejects_mixed_devices():
    tier = entry_tier(torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int32), Metric.L2)
    with pytest.raises(ValueError):
        entry_top1(torch.zeros((1, 2)), EntryTier(tier.rows, torch.zeros(4, device="meta"),
                                                  tier.ids, Metric.L2, None))
