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
bitwise equal to the dedicated kernels masked to their key.
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
