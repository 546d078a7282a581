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
weights bitwise (repeat launches too, all values in one bin, n off a
multiple of 4, and W a row slice off a 16-byte boundary), an (R, n) call
bitwise R one-row calls, and fractional weights within 1e-6·Σ|w| of the
row a bin.  The streaming slice: the output-tiled histogram (block_bins,
kernel 7) bitwise the plain version, keyed too, over one column range and
several, with n_valid, and within 1e-6 of the row's mass under a mask
value of 0.5; the double-buffered moments (stream=True, kernel 5) bitwise
kernel 2 on aligned and misaligned x; a streamed bootstrap on the card
bitwise bootstrap_chunked.  The serving slice: flash attention (kernel
12) against its plain version, f32 within atol 2e-5 and rtol 1e-4, bf16
within one bf16 rounding (1e-3 + 2^-7·|want|) plus the rounding of P to
bf16 before P·V (2^-8·(Σ p·|v|)/l), at the full-width prefill shape in
both; f32 takes the CUDA-core route, bf16 is bitwise repeatable and
takes more than 65,535 heads; one prefill launches it once a layer and
decode never, and decode equals teacher forcing.  The tiled scan (kernel 1 from an n-tile
offset) gives the CPU run's weights and w_tot bitwise, its dots within
1e-5·Σw|x|, and a group with keyed and custom members is bitwise their
dedicated runs.
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
                                         (256, (1 << 16) + 37, 4, 2048),
                                         # n = 1, 2, 3 (mod 4): rows of W
                                         # start off 16-byte boundaries
                                         (7, 4097, 1, 2048),
                                         (256, 4098, 2, 256),
                                         (3, 4099, 1, 2048)])
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
    # repeat launches give the same bits
    assert torch.equal(got, twh.weighted_histogram(xc, wc, LO, HI, nbins))
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
@pytest.mark.parametrize("R", [1, 256])
def test_cuda_weighted_histogram_all_in_one_bin(cuda, R):
    """Every value in one bin: the most contended adds, bitwise."""
    n = (1 << 18) + 3
    x = torch.full((n, 1), 0.25, device=cuda)
    w = torch.from_numpy(np.random.default_rng(R).poisson(
        1.0, size=(R, n)).astype(np.float32)).to(cuda)
    got = twh.weighted_histogram(x, w, LO, HI, 2048)
    assert torch.equal(got.cpu(), twh.weighted_histogram(
        x.cpu(), w.cpu(), LO, HI, 2048))
    assert torch.equal(got.sum(dim=(1, 2)), w.sum(1))
    ones = twh.weighted_histogram(x, None, LO, HI, 2048)
    assert float(ones.sum()) == n and int((ones != 0).sum()) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [1, 2, 3])
def test_cuda_weighted_histogram_misaligned_rows(cuda, offset):
    """W a row slice whose base is not 16-byte aligned: handled, every
    row read from its own offset, bitwise the plain version."""
    R, n = 9, 10_001
    rng = np.random.default_rng(offset)
    x = torch.from_numpy(rng.normal(0.0, 1.5, size=(n, 1)).astype(
        np.float32)).to(cuda)
    big = torch.from_numpy(rng.poisson(1.0, size=R * n + 8).astype(
        np.float32)).to(cuda)
    w = big[offset:offset + R * n].reshape(R, n)
    assert w.is_contiguous() and w.data_ptr() % 16 != 0
    got = twh.weighted_histogram(x, w, LO, HI, 256)
    assert torch.equal(got.cpu(), twh.weighted_histogram(
        x.cpu(), w.cpu(), LO, HI, 256))
    w1 = big[offset:offset + n]
    assert torch.equal(twh.weighted_histogram(x, w1, LO, HI, 256).cpu(),
                       twh.weighted_histogram(x.cpu(), w1.cpu(), LO, HI,
                                              256))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,G,nbins,block_bins,n_valid", [
    (100, 1000, 1, None, NBINS, 16, None), (256, (1 << 16) + 37, 4, None,
                                            2048, 512, None),
    (64, 20_000, 4, 8, 2048, 2048, None),
    # several column ranges (the atomic flush), and n_valid
    (256, (1 << 20) + 37, 64, None, 2048, 2048, None),
    (100, 30_000, 2, None, 2048, 2048, 29_000)])
def test_cuda_binblocked_hist_matches_plain(cuda, B, n, d, G, nbins,
                                            block_bins, n_valid):
    """Kernel 7 (block_bins): counts bitwise the plain version, keyed past
    the keyed histogram's shared-memory limit too, with one column range
    (plain stores) and several (global atomics)."""
    rng = np.random.default_rng(B + n + d)
    x = rng.normal(0.0, 1.5, size=(n, d)).astype(np.float32)
    x[:4, 0] = [np.nan, np.inf, -np.inf, 10 * HI]
    mask = (rng.random(n) > 0.3).astype(np.float32)
    kw = {}
    if G is not None:
        kw = dict(group_ids=torch.from_numpy(
            rng.integers(0, G, size=n).astype(np.float32)), num_groups=G)
    kwc = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()}
    xc = torch.from_numpy(x).to(cuda)
    for m in (None, torch.from_numpy(mask)):
        got = twh.fused_poisson_hist(
            11, xc, LO, HI, nbins, B, n_valid=n_valid,
            valid_mask=None if m is None else m.to(cuda),
            block_bins=block_bins, **kwc)
        # the plain version on the card: the CPU's takes minutes at 2^20
        pr = tws.prepare(xc, B, n_valid=n_valid,
                         valid_mask=None if m is None else m.to(cuda), **kwc)
        lo = torch.full((d,), LO, device=cuda)
        hi = torch.full((d,), HI, device=cuda)
        run = twh.grouped_hist_plain if G is not None else twh.hist_plain
        assert torch.equal(got, run(pr, 11, lo, hi, nbins)[:B])


@pytest.mark.cuda
def test_cuda_binblocked_hist_fractional_mask(cuda):
    """A mask value other than 0 or 1 makes the weights fractional: kernel
    7 then adds weight × mask as f32, within 1e-6 of the row's mass a bin
    of the plain version."""
    B, n, d = 64, 30_000, 2
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(0.0, 1.5, size=(n, d)).astype(
        np.float32)).to(cuda)
    mask = torch.from_numpy(rng.choice(
        np.array([0.0, 1.0, 0.5], np.float32), size=n)).to(cuda)
    got = twh.fused_poisson_hist(3, x, LO, HI, 2048, B, valid_mask=mask,
                                 block_bins=2048)
    lo = torch.full((d,), LO, device=cuda)
    hi = torch.full((d,), HI, device=cuda)
    want = twh.hist_plain(tws.prepare(x, B, valid_mask=mask), 3, lo, hi,
                          2048)[:B]
    bound = 1e-6 * want.double().sum(dim=(1, 2))[:, None, None]
    assert bool(((got.double() - want.double()).abs() <= bound).all())
    assert not torch.equal(got, got.round())


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


# ---------------------------------------------------------------------------
# the serving slice: kernel 12, the model on the card, the tiled scan
# ---------------------------------------------------------------------------
#: (b, hq, hkv, sq, skv, d), kwargs: tests/test_kernels.py's sweep, head
#: dims 16, 20 (padded to 24 for TMA), 64, 120 and 128, Sq and Skv off the
#: 128-row tiles (67, 200, 513), Hq / Hkv in {1, 2, 4, 8}, a query block
#: that sees no key at all, causal=False and the decode offset
FA_CASES = [
    ((2, 4, 2, 64, 64, 32), dict(causal=True)),
    ((1, 4, 4, 128, 128, 32), dict(causal=True, window=32)),
    ((2, 8, 2, 96, 96, 16), dict(causal=False)),
    ((1, 2, 1, 64, 192, 32), dict(causal=True, kv_offset=128)),
    ((1, 8, 1, 80, 80, 64), dict(causal=True)),
    ((1, 8, 2, 67, 67, 120), dict(causal=True)),
    ((1, 32, 8, 64, 4160, 120), dict(causal=True, window=4096,
                                     kv_offset=4096)),
    ((2, 4, 1, 200, 200, 20), dict(causal=True, window=50)),
    ((1, 8, 1, 513, 513, 128), dict(causal=True)),
    ((1, 4, 4, 200, 513, 64), dict(causal=False)),
    ((1, 8, 8, 513, 200, 120), dict(causal=True, kv_offset=-100,
                                    window=300)),
    ((1, 2, 1, 64, 32, 16), dict(causal=True, window=16, kv_offset=100)),
]


def _fa_inputs(shape, dtype, device, seed):
    b, hq, hkv, sq, skv, d = shape
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g).to(dtype).to(device)
                 for s in ((b, hq, sq, d), (b, hkv, skv, d),
                           (b, hkv, skv, d)))


def _fa_close(got, want, dtype, q=None, k=None, v=None, **kw):
    """f32 within atol 2e-5 and rtol 1e-4.  bf16 within one bf16 rounding
    of the output (1e-3 + 2^-7·|want|) plus the kernel's rounding of P to
    bf16 before P·V: at most 2^-8·(Σ p·|v|)/l an output, which the plain
    version gives when run on |v| with the same q, k and masks
    (tests/test_torch_attention.py shows the term is needed and enough)."""
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return bool((diff <= 2e-5 + 1e-4 * want.float().abs()).all())
    from repro_torch.kernels.flash_attention import ops as tfa
    pv_abs = tfa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       **kw)
    return bool((diff <= 1e-3 + 2.0 ** -7 * want.float().abs()
                 + 2.0 ** -8 * pv_abs).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kw", FA_CASES,
                         ids=[str(s) for s, _ in FA_CASES])
def test_cuda_flash_attention_matches_plain(cuda, shape, kw, dtype):
    from repro_torch.kernels.flash_attention import ops as tfa
    b, hq, hkv, sq, skv, d = shape
    q, k, v = _fa_inputs(shape, dtype, cuda, sq + d)
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, **kw)
    assert tfa.flash_attention.launches == before + 1
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert _fa_close(got, want, dtype, q, k, v, **kw)
    if kw.get("kv_offset") == 100:  # the window ends before the first key
        assert bool((got == 0).all())


@pytest.mark.cuda
def test_cuda_flash_attention_at_the_full_width_prefill_shape(cuda):
    """h2o-danube-3-4b's prefill of 4 x 8192 tokens: 32 query heads on 8
    KV heads, head_dim 120, window 4096, bf16."""
    from repro_torch.kernels.flash_attention import ops as tfa
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((4, 32, 8192, 120), generator=g, device=cuda
                    ).to(torch.bfloat16)
    k, v = (torch.randn((4, 8, 8192, 120), generator=g, device=cuda
                        ).to(torch.bfloat16) for _ in range(2))
    kw = dict(causal=True, window=4096)
    got = tfa.flash_attention(q, k, v, **kw)
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert _fa_close(got, want, torch.bfloat16, q, k, v, **kw)


@pytest.mark.cuda
def test_cuda_flash_attention_f32_at_the_full_width_prefill_shape(
        cuda, monkeypatch):
    """The same shape in f32, at f32's tolerance, which only the CUDA-core
    route (IEEE f32 products) meets: the call launches with dtype code 0.
    Past the window (Sq > 4096) the kernel skips the key tiles older than
    the window, and an off-by-one tile there moves an output by about
    1e-3."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as tfa
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((4, 32, 8192, 120), generator=g, device=cuda)
    k, v = (torch.randn((4, 8, 8192, 120), generator=g, device=cuda)
            for _ in range(2))
    codes, launch = [], _build.launch
    monkeypatch.setattr(_build, "launch", lambda name, *a: (
        codes.append(a[0]), launch(name, *a))[1])
    got = tfa.flash_attention(q, k, v, causal=True, window=4096)
    assert codes == [0]
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=4096)
    assert _fa_close(got, want, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((4, 32, 8, 1024, 1024, 120), dict(causal=True, window=512)),
    ((1, 8, 2, 67, 200, 20), dict(causal=False)),
], ids=["d120", "d20"])
def test_cuda_flash_attention_bf16_is_bitwise_repeatable(cuda, shape, kw):
    """A fixed accumulation order and no atomics: two launches on the
    same bf16 inputs give the same bits."""
    from repro_torch.kernels.flash_attention import ops as tfa
    q, k, v = _fa_inputs(shape, torch.bfloat16, cuda, 5)
    assert torch.equal(tfa.flash_attention(q, k, v, **kw),
                       tfa.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_head_dim_past_128_raises(cuda):
    from repro_torch.kernels.flash_attention import ops as tfa
    q, k, v = _fa_inputs((1, 2, 1, 16, 16, 136), torch.bfloat16, cuda, 6)
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError):
        tfa.flash_attention(q, k, v)
    assert tfa.flash_attention.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_past_65535_heads(cuda, dtype):
    """B·Hq = 70,000 query heads: (b·h, query block) is flattened on
    gridDim.x, so there is no 65,535 cap on heads."""
    from repro_torch.kernels.flash_attention import ops as tfa
    q, k, v = _fa_inputs((70_000, 1, 1, 8, 8, 16), dtype, cuda, 7)
    got = tfa.flash_attention(q, k, v, causal=True)
    want = tfa.flash_attention_plain(q, k, v, causal=True)
    assert _fa_close(got, want, dtype, q, k, v, causal=True)


def _smoke_model(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    cfg = get_config("h2o-danube-3-4b", smoke=True)
    return cfg, init_params(cfg, torch.Generator(device=cuda).manual_seed(0),
                            device=cuda)


@pytest.mark.cuda
def test_cuda_prefill_launches_the_kernel_once_a_layer(cuda):
    from repro_torch.kernels.flash_attention import ops as tfa
    from repro_torch.models import decode_step, prefill
    cfg, params = _smoke_model(cuda)
    toks = torch.randint(0, cfg.vocab, (2, 40), device=cuda)
    before = tfa.flash_attention.launches
    logits, cache = prefill(cfg, params, toks, cache_len=48)
    assert tfa.flash_attention.launches == before + cfg.n_layers
    for t in range(4):
        logits, cache = decode_step(cfg, params, cache,
                                    torch.argmax(logits, -1)[:, None],
                                    40 + t)
    assert tfa.flash_attention.launches == before + cfg.n_layers
    assert bool(torch.isfinite(logits[:, :cfg.vocab]).all())


@pytest.mark.cuda
def test_cuda_decode_matches_teacher_forcing(cuda):
    from repro_torch.models import (decode_step, forward_hidden,
                                    logits_from_hidden, prefill)
    cfg, params = _smoke_model(cuda)
    B, S = 2, 32
    toks = torch.randint(0, cfg.vocab, (B, S + 3), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    h, _ = forward_hidden(cfg, params, toks, mode="train")
    full = logits_from_hidden(cfg, params, h)
    lg, cache = prefill(cfg, params, toks[:, :S], cache_len=S + 3)
    torch.testing.assert_close(lg, full[:, S - 1], atol=2e-4, rtol=1e-3)
    for t in range(3):
        lg, cache = decode_step(cfg, params, cache, toks[:, S + t:S + t + 1],
                                S + t)
        torch.testing.assert_close(lg, full[:, S + t], atol=2e-4, rtol=1e-3)


class _AbsSum:
    """A user statistic with its own vectorized tile math: Σw and Σw|x|."""

    @staticmethod
    def make():
        from repro_torch.core import MomentState, Statistic

        class AbsSum(Statistic):
            def init_state(self, dim, device="cpu"):
                z = torch.zeros(dim, device=device)
                return MomentState(w=torch.zeros((), device=device), s1=z,
                                   s2=z)

            def update(self, state, values, weights=None):
                x = values.to(torch.float32)
                w = torch.ones(x.shape[0], device=x.device) \
                    if weights is None else weights
                return MomentState(w=state.w + w.sum(),
                                   s1=state.s1 + w @ x.abs(), s2=state.s2)

            def tile_update(self, states, x_tile, w_tile):
                return MomentState(w=states.w + w_tile.sum(dim=1),
                                   s1=states.s1 + w_tile @ x_tile.abs(),
                                   s2=states.s2)

            def finalize(self, state):
                return state.s1 / torch.clamp_min(state.w.unsqueeze(-1),
                                                  1.0)
        return AbsSum()


def _keyed_rows(n, G, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 1)).astype(np.float32)
    keys = rng.integers(0, G, size=(n, 1)).astype(np.float32)
    return torch.from_numpy(np.concatenate([x, keys], axis=1))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(8, 300), (256, (1 << 16) + 37)])
def test_cuda_tiled_scan_matches_its_cpu_run(cuda, B, n):
    from repro_torch.core import GroupedStatistic
    from repro_torch.kernels.fused_multi.ops import fused_poisson_tiled
    G = 4
    vals = _keyed_rows(n, G)
    stat = GroupedStatistic(_AbsSum.make(), G)
    got = fused_poisson_tiled(stat, 21, vals.to(cuda), B, n_valid=n - 5)
    want = fused_poisson_tiled(stat, 21, vals, B, n_valid=n - 5)
    assert torch.equal(got.w.cpu(), want.w)
    w = tpc.poisson_counts(21, B, n, device="cpu").double()
    w[:, n - 5:] = 0.0
    keys = vals[:, 1].long()
    bound = torch.stack([w[:, keys == g] @ vals[keys == g, :1].abs().double()
                         for g in range(G)], dim=1)
    assert bool(((got.s1.cpu().double() - want.s1.double()).abs()
                 <= 1e-5 * bound).all())


@pytest.mark.cuda
def test_cuda_group_with_keyed_and_custom_members(cuda):
    """Each member of the group is bitwise its dedicated run on the card:
    the keyed member its keyed kernels, the custom member its tiled scan,
    the moments slot kernel 2's."""
    from repro_torch.core import GroupedStatistic, Mean, StatisticGroup
    from repro_torch.kernels.fused_multi.ops import fused_poisson_tiled
    G, B, n = 4, 64, 50_000
    vals = _keyed_rows(n, G).to(cuda)
    custom = _AbsSum.make()
    keyed = GroupedStatistic(Mean(), G)
    group = StatisticGroup((Mean(), keyed, custom))
    mom, kst, cst = tfm.fused_poisson_multi(group, 5, vals, B)
    dedicated = (tws.fused_poisson_moments(5, vals, B),
                 keyed.fused_poisson_states(5, vals, B),
                 fused_poisson_tiled(custom, 5, vals, B))
    for a, b in zip((mom.w, mom.s1, mom.s2), dedicated[0]):
        assert torch.equal(a, b)
    for a, b in ((kst.w, dedicated[1].w), (kst.s1, dedicated[1].s1),
                 (cst.w, dedicated[2].w), (cst.s1, dedicated[2].s1)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_keyed_custom_statistic_stays_below_the_weight_matrix(cuda):
    from repro_torch.core import GroupedStatistic
    from repro_torch.core.bootstrap import fused_resample_states
    G, B, n = 4, 256, 1 << 22
    vals = _keyed_rows(n, G).to(cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    st = fused_resample_states(GroupedStatistic(_AbsSum.make(), G), 8, vals,
                               B)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert st.w.shape == (B, G)
    assert peak < B * n * 4 // 8
