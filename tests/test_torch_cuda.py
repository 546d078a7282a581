"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here is marked ``cuda`` and skips on a machine without one.
The file imports neither jax nor the JAX package, so it also runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py

Weights, w_tot and histogram counts must be bitwise equal to the plain
versions; s1 within 1e-5·Σw|x| and s2 within 1e-5·Σw·x² per entry; group
members bitwise equal to the dedicated kernels.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.reduce_api import Mean, Quantile, StatisticGroup, Std
from repro_torch.kernels.fused_multi import ops as tfm
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
