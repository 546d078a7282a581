"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a machine without one.
The file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

Weights, w_tot, histogram and k-means counts must be bitwise equal to
the plain versions; s1 and k-means sums within 1e-5·Σw|x|, s2 within
1e-5·Σw·x² and k-means inertia within 1e-5·Σw·min-d² per entry; group
members bitwise equal to the dedicated kernels; keyed (GROUP BY) slots
bitwise equal to the dedicated kernels masked to their key.  The explicit-
weight kernels: weighted_moments' w_tot bitwise and s1/s2 within
1e-5·Σw|x| (and Σw·x²); weighted_histogram's counts of whole-number
weights bitwise, an (R, n) call bitwise R one-row calls, and fractional
weights within 1e-6·Σ|w| of the row a bin.  The streaming slice: the
output-tiled histogram (block_bins, kernel 7) bitwise the plain version,
keyed too; the double-buffered moments (stream=True, kernel 5) bitwise
kernel 2 on aligned and misaligned x; a streamed bootstrap on the card
bitwise bootstrap_chunked.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.reduce_api import (KMeansStep, Mean, Quantile,
                                         StatisticGroup, Std)
from repro_torch.data import synthetic_clusters
from repro_torch.kernels.fused_multi import ops as tfm
from repro_torch.kernels.kmeans_assign import ops as tka
from repro_torch.kernels.poisson_counts import ops as tpc
from repro_torch.kernels.weighted_hist import ops as twh
from repro_torch.kernels.weighted_stats import ops as tws

NBINS, LO, HI = 64, -2.0, 2.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d", [(3, 37, 1), (8, 300, 2), (100, 1000, 1),
                                   (130, 700, 3), (256, (1 << 16) + 37, 1)])
def test_cuda_kernels_match_plain(cuda, B, n, d):
    rng = np.random.default_rng(B + n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[1, 0], x[2, 0], x[3, 0] = np.nan, np.inf, HI
    mask = (rng.random(n) > 0.3).astype(np.float32)
    seed = int(rng.integers(0, 2 ** 31 - 1))
    xc, mc = torch.from_numpy(x).to(cuda), torch.from_numpy(mask).to(cuda)

    w = tpc.poisson_counts(seed, B, n, device=cuda)
    assert torch.equal(w.cpu(), tpc.poisson_counts(seed, B, n, device="cpu"))

    fin = torch.from_numpy(np.nan_to_num(x, posinf=0.0)).to(cuda)
    got = tws.fused_poisson_moments(seed, fin, B, valid_mask=mc)
    want = tws.fused_poisson_moments(seed, fin.cpu(), B, valid_mask=mc.cpu())
    wm = (w.cpu() * mc.cpu()).double()
    xd = fin.cpu().double()
    assert torch.equal(got[0].cpu(), want[0])
    for g, v, bound in ((got[1], want[1], wm @ xd.abs()),
                        (got[2], want[2], wm @ (xd * xd))):
        assert bool(((g.cpu().double() - v.double()).abs()
                     <= 1e-5 * bound).all())

    h = twh.fused_poisson_hist(seed, xc, LO, HI, NBINS, B, valid_mask=mc)
    assert torch.equal(h.cpu(), twh.fused_poisson_hist(
        seed, xc.cpu(), LO, HI, NBINS, B, valid_mask=mc.cpu()))

    group = StatisticGroup((Mean(), Quantile(0.5, nbins=NBINS, lo=LO, hi=HI),
                            Std()))
    g = tfm.fused_poisson_multi(group, seed, fin, B, valid_mask=mc)
    gh = tfm.fused_poisson_multi(StatisticGroup((Quantile(
        0.5, nbins=NBINS, lo=LO, hi=HI),)), seed, xc, B, valid_mask=mc)
    for a, b in zip((g[0].w, g[0].s1, g[0].s2), got):
        assert torch.equal(a, b)
    assert torch.equal(gh[0].counts, h)


@pytest.mark.cuda
def test_cuda_tensor_never_reaches_the_plain_version(cuda, monkeypatch):
    from repro_torch.kernels import _build

    def refuse(name, *args):
        raise RuntimeError(f"launch of {name} refused")

    monkeypatch.setattr(_build, "launch", refuse)
    x = torch.ones(100, 1, device=cuda)
    with pytest.raises(RuntimeError, match="refused"):
        tws.fused_poisson_moments(1, x, 8)
    with pytest.raises(RuntimeError, match="refused"):
        twh.fused_poisson_hist(1, x, 0.0, 2.0, 16, 8)
    with pytest.raises(RuntimeError, match="refused"):
        tka.kmeans_assign(x, None, torch.zeros(2, 1, device=cuda))
    with pytest.raises(RuntimeError, match="refused"):
        tka.fused_poisson_kmeans(1, x, torch.zeros(2, 1, device=cuda), 8)
    w = torch.ones(4, 100, device=cuda)
    with pytest.raises(RuntimeError, match="refused"):
        tws.weighted_moments(w, x)
    for weights in (None, w[0], w):
        with pytest.raises(RuntimeError, match="refused"):
            twh.weighted_histogram(x, weights, 0.0, 2.0, 16)


def _within(got, want, bound):
    return bool(((got.cpu().double() - want.double()).abs()
                 <= 1e-5 * bound + 1e-30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,k,d", [(3, 37, 3, 1), (24, 8000, 5, 2),
                                     (130, 700, 16, 8),
                                     (256, (1 << 16) + 37, 5, 2)])
def test_cuda_kmeans_kernels_match_plain(cuda, B, n, k, d):
    x, centers = synthetic_clusters(n, k=k, dim=d, seed=n + k)
    rng = np.random.default_rng(n)
    cent = (centers + rng.normal(0, 0.1, centers.shape)).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    w = rng.integers(0, 4, n).astype(np.float32)
    seed = int(rng.integers(0, 2 ** 31 - 1))
    xc, cc, mc = (torch.from_numpy(a).to(cuda) for a in (x, cent, mask))
    xt, ct, mt = (torch.from_numpy(a) for a in (x, cent, mask))
    xd = xt.double().abs()

    got = tka.kmeans_assign(xc, torch.from_numpy(w).to(cuda), cc)
    want = tka.kmeans_assign(xt, torch.from_numpy(w), ct)
    assert torch.equal(got[1].cpu(), want[1])
    assert _within(got[0], want[0], torch.from_numpy(w).double() @ xd)
    assert _within(got[2], want[2], want[2].double().abs())

    for kw in ({}, dict(n_valid=n - 5, valid_mask=mc)):
        got = tka.fused_poisson_kmeans(seed, xc, cc, B, **kw)
        cpu_kw = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in kw.items()}
        want = tka.fused_poisson_kmeans(seed, xt, ct, B, **cpu_kw)
        wts = tpc.poisson_counts(seed, B, n, device="cpu").double()
        if kw:
            wts[:, n - 5:] = 0.0
            wts = wts * mt.double()
        assert torch.equal(got[1].cpu(), want[1])
        assert _within(got[0], want[0], (wts @ xd)[:, None, :])
        assert _within(got[2], want[2], want[2].double().abs())

    # a KMeansStep group member is bitwise its dedicated kernel
    group = StatisticGroup((Mean(), KMeansStep(cc)))
    g = tfm.fused_poisson_multi(group, seed, xc, B)
    ded = tka.fused_poisson_kmeans(seed, xc, cc, B)
    for a, b in zip((g[1].sums, g[1].counts, g[1].inertia), ded):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kmeans_ties_go_to_the_lowest_cluster(cuda):
    y = torch.linspace(-1.0, 1.0, 300)
    x = torch.stack([torch.zeros_like(y), y], dim=1).to(cuda)
    cent = torch.tensor([[-1.0, 0.0], [1.0, 0.0], [0.0, 3.0]]).to(cuda)
    assert tka.kmeans_assign(x, None, cent)[1].tolist() == [300.0, 0.0, 0.0]
    counts = tka.fused_poisson_kmeans(3, x, cent, 8)[1]
    assert torch.equal(counts.cpu(), tka.fused_poisson_kmeans(
        3, x.cpu(), cent.cpu(), 8)[1])
    assert float(counts[:, 1:].abs().sum()) == 0.0


def _keyed(n, d, G, seed):
    """x (n, d) with NaN/inf-free values, f32 keys in [0, G) with key G-1
    absent, and a validity mask, numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    keys = rng.integers(0, max(1, G - 1), size=n).astype(np.float32)
    mask = (rng.random(n) > 0.3).astype(np.float32)
    return x, keys, mask


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,G", [(8, 300, 1, 3), (100, 1000, 2, 8),
                                     (130, 700, 4, 8), (24, 5000, 4, 16),
                                     (256, (1 << 16) + 37, 1, 8)])
def test_cuda_grouped_kernels_match_plain_and_masked(cuda, B, n, d, G):
    """Kernel ≡ plain (w_tot and counts bitwise, s1/s2 within 1e-5·Σw|x|
    and Σw·x²), and slot g ≡ the dedicated kernel masked to key g, bitwise.
    (24, 5000, 4, 16) has G·(2d+1) = 144 > 128 and takes two z chunks."""
    x, keys, mask = _keyed(n, d, G, seed=n + G)
    seed = 77 + n
    xc, kc, mc = (torch.from_numpy(a).to(cuda) for a in (x, keys, mask))
    xt, kt, mt = (torch.from_numpy(a) for a in (x, keys, mask))
    for valid, valid_cpu in ((None, None), (mc, mt)):
        kw = dict(group_ids=kc, num_groups=G, valid_mask=valid)
        kw_cpu = dict(group_ids=kt, num_groups=G, valid_mask=valid_cpu)
        got = tws.fused_poisson_moments(seed, xc, B, **kw)
        want = tws.fused_poisson_moments(seed, xt, B, **kw_cpu)
        absw = tws.fused_poisson_moments(seed, xt.abs(), B, **kw_cpu)
        assert torch.equal(got[0].cpu(), want[0])
        assert _within(got[1], want[1], absw[1].double())
        assert _within(got[2], want[2], want[2].double().abs())
        h = twh.fused_poisson_hist(seed, xc, LO, HI, NBINS, B, **kw)
        assert torch.equal(h.cpu(), twh.fused_poisson_hist(
            seed, xt, LO, HI, NBINS, B, **kw_cpu))
        cent = torch.from_numpy(x[:3].copy()).to(cuda)
        km = tka.fused_poisson_kmeans(seed, xc, cent, B, **kw)
        assert float(got[0][:, G - 1].abs().sum()) == 0.0
        assert float(h[:, G - 1].sum()) == 0.0
        for g in range(G):
            m = (kc == g).float() if valid is None else valid * (kc == g)
            for a, b in zip(got, tws.fused_poisson_moments(
                    seed, xc, B, valid_mask=m)):
                assert torch.equal(a[:, g], b)
            assert torch.equal(h[:, g], twh.fused_poisson_hist(
                seed, xc, LO, HI, NBINS, B, valid_mask=m))
            for a, b in zip(km, tka.fused_poisson_kmeans(seed, xc, cent, B,
                                                         valid_mask=m)):
                assert torch.equal(a[:, g], b)


@pytest.mark.cuda
def test_cuda_keyed_tensor_never_reaches_the_plain_version(cuda,
                                                           monkeypatch):
    from repro_torch.kernels import _build

    def refuse(name, *args):
        raise RuntimeError(f"launch of {name} refused")

    monkeypatch.setattr(_build, "launch", refuse)
    x = torch.ones(100, 1, device=cuda)
    keys = torch.zeros(100, device=cuda)
    kw = dict(group_ids=keys, num_groups=2)
    with pytest.raises(RuntimeError, match="refused"):
        tws.fused_poisson_moments(1, x, 8, **kw)
    with pytest.raises(RuntimeError, match="refused"):
        twh.fused_poisson_hist(1, x, 0.0, 2.0, 16, 8, **kw)
    with pytest.raises(RuntimeError, match="refused"):
        tka.fused_poisson_kmeans(1, x, torch.zeros(2, 1, device=cuda), 8,
                                 **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d", [(7, 1000, 3), (256, (1 << 16) + 37, 8)])
def test_cuda_weighted_moments_match_plain(cuda, B, n, d):
    rng = np.random.default_rng(B + n + d)
    x = rng.normal(3.0, 2.0, size=(n, d)).astype(np.float32)
    for w in (rng.poisson(1.0, size=(B, n)).astype(np.float32),
              rng.random((B, n)).astype(np.float32)):
        got = tws.weighted_moments(torch.from_numpy(w).to(cuda),
                                   torch.from_numpy(x).to(cuda))
        want = tws.weighted_moments(torch.from_numpy(w), torch.from_numpy(x))
        wd, xd = torch.from_numpy(w).double(), torch.from_numpy(x).double()
        if float((wd - wd.round()).abs().max()) == 0.0:
            assert torch.equal(got[0].cpu(), want[0])
        else:
            assert _within(got[0], want[0], wd.sum(1))
        assert _within(got[1], want[1], wd @ xd.abs())
        assert _within(got[2], want[2], wd @ (xd * xd))
        again = tws.weighted_moments(torch.from_numpy(w).to(cuda),
                                     torch.from_numpy(x).to(cuda))
        for a, b in zip(got, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("R,n,d,nbins", [(1, 5000, 1, 256),
                                         (256, (1 << 16) + 37, 4, 2048)])
def test_cuda_weighted_histogram_matches_plain(cuda, R, n, d, nbins):
    rng = np.random.default_rng(R + n)
    x = rng.normal(0.0, 1.5, size=(n, d)).astype(np.float32)
    x[:6, 0] = [np.nan, np.inf, -np.inf, LO, HI, 10 * HI]
    xc, xt = torch.from_numpy(x).to(cuda), torch.from_numpy(x)
    w = rng.poisson(1.0, size=(R, n)).astype(np.float32)
    wc, wt = torch.from_numpy(w).to(cuda), torch.from_numpy(w)
    got = twh.weighted_histogram(xc, wc, LO, HI, nbins)
    assert got.shape == (R, d, nbins)
    assert torch.equal(got.cpu(), twh.weighted_histogram(xt, wt, LO, HI,
                                                         nbins))
    for r in (0, R - 1):
        assert torch.equal(got[r], twh.weighted_histogram(xc, wc[r], LO, HI,
                                                          nbins))
    ones = twh.weighted_histogram(xc, None, LO, HI, nbins)
    assert torch.equal(ones.cpu(), twh.weighted_histogram(xt, None, LO, HI,
                                                          nbins))
    frac = rng.random((R, n)).astype(np.float32)
    got = twh.weighted_histogram(xc, torch.from_numpy(frac).to(cuda), LO, HI,
                                 nbins)
    want = twh.weighted_histogram(xt, torch.from_numpy(frac), LO, HI, nbins)
    bound = 1e-6 * torch.from_numpy(frac).double().sum(1)[:, None, None]
    assert bool(((got.cpu().double() - want.double()).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,G,nbins,block_bins", [
    (100, 1000, 1, None, NBINS, 16), (256, (1 << 16) + 37, 4, None, 2048,
                                      512),
    (64, 20_000, 4, 8, 2048, 2048)])
def test_cuda_binblocked_hist_matches_plain(cuda, B, n, d, G, nbins,
                                            block_bins):
    """Kernel 7 (block_bins): counts bitwise the plain version, keyed past
    the keyed histogram's shared-memory limit too."""
    rng = np.random.default_rng(B + n + d)
    x = rng.normal(0.0, 1.5, size=(n, d)).astype(np.float32)
    x[:4, 0] = [np.nan, np.inf, -np.inf, 10 * HI]
    mask = (rng.random(n) > 0.3).astype(np.float32)
    kw = {}
    if G is not None:
        kw = dict(group_ids=torch.from_numpy(
            rng.integers(0, G, size=n).astype(np.float32)), num_groups=G)
    for m in (None, torch.from_numpy(mask)):
        got = twh.fused_poisson_hist(
            11, torch.from_numpy(x).to(cuda), LO, HI, nbins, B,
            valid_mask=None if m is None else m.to(cuda),
            block_bins=block_bins,
            **{k: v.to(cuda) if torch.is_tensor(v) else v
               for k, v in kw.items()})
        want = twh.fused_poisson_hist(11, torch.from_numpy(x), LO, HI, nbins,
                                      B, valid_mask=m, **kw)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d", [(8, 300, 1), (256, (1 << 16) + 37, 3),
                                   (64, 5000, 64)])
def test_cuda_stream_moments_equal_kernel_2(cuda, B, n, d):
    """Kernel 5 (stream=True) is bitwise kernel 2, on an aligned and on a
    misaligned view of x, with and without a mask."""
    rng = np.random.default_rng(B + n + d)
    x = torch.from_numpy(rng.normal(3.0, 2.0, size=(n + 1, d)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy((rng.random(n) > 0.3).astype(np.float32)).to(
        cuda)
    for view in (x[:n], x[1:]):
        for m in (None, mask):
            a = tws.fused_poisson_moments(5, view, B, valid_mask=m)
            b = tws.fused_poisson_moments(5, view, B, valid_mask=m,
                                          stream=True)
            for u, v in zip(a, b):
                assert torch.equal(u, v)


@pytest.mark.cuda
def test_cuda_streaming_equals_chunked(cuda):
    from repro_torch import random as trandom
    from repro_torch.core import bootstrap_chunked, bootstrap_streaming
    from repro_torch.data import ShardedStore
    x = np.random.default_rng(1).normal(0.0, 1.5, size=(20_000, 4)).astype(
        np.float32)
    store = ShardedStore.from_array(x, 1234, interleave=False)
    for stat in (Mean(), Quantile(0.5, nbins=2048, lo=LO, hi=HI,
                                  block_bins=2048)):
        got = bootstrap_streaming(store, stat, 64, trandom.PRNGKey(0),
                                  chunk=4096)
        want = bootstrap_chunked(store.read_all(), stat, 64,
                                 trandom.PRNGKey(0), chunk=4096,
                                 backend="fused_rng")
        assert got.thetas.is_cuda
        assert torch.equal(got.thetas, want.thetas)
        assert torch.equal(got.estimate, want.estimate)


@pytest.mark.cuda
@pytest.mark.parametrize("queue_depth", [1, 2])
def test_cuda_streaming_reuses_chunk_buffers_safely(cuda, queue_depth):
    """A wide Quantile's chunks are slower to fold than to stage, so the
    prefetch thread refills every chunk buffer while the card still
    queues work; kernel 7's transposed copy of a chunk is a chunk's size,
    the block a careless allocation would hand back too early."""
    from repro_torch import random as trandom
    from repro_torch.core import bootstrap_chunked, bootstrap_streaming
    from repro_torch.data import ShardedStore
    x = np.random.default_rng(2).standard_normal((1 << 18, 64),
                                                 dtype=np.float32)
    store = ShardedStore.from_array(x, 8192, interleave=False)
    stat = Quantile(0.5, nbins=2048, lo=-6.0, hi=6.0, block_bins=2048)
    want = bootstrap_chunked(torch.from_numpy(x).to(cuda), stat, 256,
                             trandom.PRNGKey(3), chunk=8192,
                             backend="fused_rng")
    for _ in range(3):
        got = bootstrap_streaming(store, stat, 256, trandom.PRNGKey(3),
                                  chunk=8192, queue_depth=queue_depth)
        assert torch.equal(got.thetas, want.thetas)
        assert torch.equal(got.estimate, want.estimate)
