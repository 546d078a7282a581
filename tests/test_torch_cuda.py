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
row a bin.  Kernels 3 and 4 and the key-major keyed histogram (u32 bins
for whole weights): bitwise the plain version (G in {1, 8, 32}, uniform
and skewed keys, d in {1, 4}, every value in one bin), kernel 4's moments
slot bitwise kernel 2, two launches bitwise equal, and within 1e-6 of
the row's mass a bin under a mask of 0.5; the keyed histogram raises,
naming block_bins, past one key's row of an SM.  The streaming slice:
the output-tiled histogram (block_bins,
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
dedicated runs.  Kernel 9 on ±inf and NaN values (NaN on a row of weight
0 too) gives the plain version's NaN and inf positions, is one launch a
call and bitwise repeatable, and reads no weights bitwise as unit ones.
Kernel 12 at head dims 168 and 256 (both routes) within its tolerance,
and past 256 it raises.  The live slice: a session whose batches span two
window panes launches kernel 2 (or 4) once a pane and holds each pane's
states against the CPU session's as above; a live session and an
EarlSession killed and resumed on the card are bitwise their
uninterrupted runs, with the restored states on the card.  The mesh
slice: a world of one NCCL rank (a fresh interpreter) gives the quickstart
group's and a GroupedStatistic's sharded states bitwise the unsharded
fused path, plain and at a delta step.  The MoE slice: the batched bf16
product with an f32 output (``bmm_out``) within the f32 dot bound of the
f32 product of the bf16 values; ``moe_ffn`` on the card against the CPU
(f32 and bf16 compute) with its choices agreeing but at near ties and y
within 1e-5 (f32) or 2e-2 (bf16) of max|y| at the agreeing tokens; the
kept slots bitwise the CPU's where no choice flipped.  The recurrent
slice: recurrentgemma-2b's and xlstm-350m's smoke models decode equal to
teacher forcing (atol 2e-4, rtol 1e-3), kernel 12 once a ``local`` layer
in the prefill and never in decode, and decode writing the recurrent
state into the cache in place.
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


def _same_or_nan(a, b):
    """Bitwise equal, NaN positions included (torch.equal is false on
    NaN)."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return (torch.equal(nan, torch.isnan(b))
            and torch.equal(a[~nan], b[~nan]))


def _positions_within(got, want, bound):
    """NaN and ±inf at the same places; the finite entries within
    1e-5·bound."""
    got, want = got.cpu().double(), want.double()
    fin = torch.isfinite(want)
    inf = float("inf")
    return (all(torch.equal(f(got), f(want)) for f in (
                torch.isnan, lambda t: t == inf, lambda t: t == -inf))
            and bool(((got[fin] - want[fin]).abs()
                      <= 1e-5 * bound.double().expand_as(want)[fin]
                      + 1e-30).all()))


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,d,G", [(64, 5000, 1, 8), (100, 1000, 2, 4),
                                     (24, 5000, 4, 16)])
def test_cuda_nonfinite_values_match_plain_and_masked(cuda, B, n, d, G):
    """±inf in one key's rows and NaN in another's: kernels 6 and 8 give
    the plain version's NaN and inf positions (finite entries within the
    usual bounds, w_tot and counts bitwise), and every keyed slot is the
    dedicated kernel masked to its key, bitwise, NaN positions equal."""
    x, keys, mask = _keyed(n, d, G, seed=n + d)
    one, two = np.where(keys == 1)[0], np.where(keys == 2)[0]
    x[one[3], 0], x[two[5], d - 1], x[one[9], d - 1] = (np.inf, np.nan,
                                                        -np.inf)
    seed = 91 + n
    xc, kc, mc = (torch.from_numpy(a).to(cuda) for a in (x, keys, mask))
    xt, kt, mt = (torch.from_numpy(a) for a in (x, keys, mask))
    cent_np = x[:3].copy()
    cent_np[0, 0] = 0.0
    cc, ct = torch.from_numpy(cent_np).to(cuda), torch.from_numpy(cent_np)
    for valid, valid_cpu in ((None, None), (mc, mt)):
        kw = dict(group_ids=kc, num_groups=G, valid_mask=valid)
        kw_cpu = dict(group_ids=kt, num_groups=G, valid_mask=valid_cpu)
        # Σw|x| per key and dim over the finite values
        bound = tws.fused_poisson_moments(
            seed, xt.abs().nan_to_num(0, 0, 0), B, **kw_cpu)[1]
        got = tws.fused_poisson_moments(seed, xc, B, **kw)
        want = tws.fused_poisson_moments(seed, xt, B, **kw_cpu)
        assert torch.equal(got[0].cpu(), want[0])
        # at d = 1 key 2's NaN poisons every key's only column
        assert torch.isnan(want[1]).any()
        assert d == 1 or torch.isinf(want[2]).any()
        assert _positions_within(got[1], want[1], bound)
        assert _positions_within(got[2], want[2], want[2].abs())
        for dedicated in (False, True):
            km = tka.fused_poisson_kmeans(
                seed, xc, cc, B, **(dict(valid_mask=valid) if dedicated
                                    else kw))
            km_want = tka.fused_poisson_kmeans(
                seed, xt, ct, B, **(dict(valid_mask=valid_cpu) if dedicated
                                    else kw_cpu))
            assert torch.equal(km[1].cpu(), km_want[1])
            assert torch.isnan(km_want[0]).any()
            sb = bound.sum(1) if dedicated else bound
            assert _positions_within(km[0], km_want[0], sb[..., None, :])
            assert _positions_within(km[2], km_want[2], km_want[2].abs())
        km = tka.fused_poisson_kmeans(seed, xc, cc, B, **kw)
        for g in range(G):
            m = (kc == g).float() if valid is None else valid * (kc == g)
            for a, b in zip(got, tws.fused_poisson_moments(
                    seed, xc, B, valid_mask=m)):
                assert _same_or_nan(a[:, g], b)
            for a, b in zip(km, tka.fused_poisson_kmeans(seed, xc, cc, B,
                                                         valid_mask=m)):
                assert _same_or_nan(a[:, g], b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(1000, 5, 1), (1000, 5, 2),
                                   ((1 << 16) + 37, 5, 2), (3000, 16, 8)])
@pytest.mark.parametrize("weights", ["unit", "whole"])
def test_cuda_kmeans_assign_nonfinite_matches_plain(cuda, n, k, d, weights):
    """Kernel 9 on +inf, -inf and NaN values, NaN on a row of weight 0:
    the plain version's NaN and inf positions (every other cluster's sums
    of that dimension NaN, whatever the weight), counts bitwise, finite
    entries within 1e-5·Σw|x|; (3000, 16, 8) takes the shared-slot
    layout."""
    x, centers = synthetic_clusters(n, k=k, dim=d, seed=n + d)
    rng = np.random.default_rng(n + k)
    cent = (centers + rng.normal(0, 0.1, centers.shape)).astype(np.float32)
    w = (np.ones(n, np.float32) if weights == "unit"
         else rng.integers(1, 4, n).astype(np.float32))
    x[7, 0], x[19, d - 1], x[n - 2, d - 1] = np.inf, -np.inf, np.nan
    x[31, d - 1] = np.nan
    w[31] = 0.0
    xc, cc, wc = (torch.from_numpy(a).to(cuda) for a in (x, cent, w))
    got = tka.kmeans_assign(xc, wc, cc)
    want = tka.kmeans_assign(torch.from_numpy(x), torch.from_numpy(w),
                             torch.from_numpy(cent))
    assert torch.isnan(want[0]).any()
    assert torch.equal(got[1].cpu(), want[1])
    bound = torch.from_numpy(w).double() @ torch.from_numpy(x).double(
        ).abs().nan_to_num(0, 0, 0)
    assert _positions_within(got[0], want[0], bound)
    assert _positions_within(got[2], want[2], want[2].abs())


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,d", [(400_000, 5, 2), (1001, 3, 1),
                                   (3000, 16, 8)])
def test_cuda_kmeans_assign_is_one_launch_and_repeatable(cuda, monkeypatch,
                                                         n, k, d):
    """One call is one kernel launch (the last CTA sums the partials; no
    second pass); two calls give the same bits; no weights is unit
    weights, bitwise; x a row slice off a 16-byte boundary (scalar loads)
    gives the plain version's counts."""
    from repro_torch.kernels import _build
    x, centers = synthetic_clusters(n + 1, k=k, dim=d, seed=n)
    cc = torch.from_numpy(centers.astype(np.float32)).to(cuda)
    xc = torch.from_numpy(x).to(cuda)
    calls, launch = [], _build.launch
    monkeypatch.setattr(_build, "launch", lambda name, *a: (
        calls.append(name), launch(name, *a))[1])
    torch.cuda.synchronize()
    a = tka.kmeans_assign(xc[:n], None, cc)
    torch.cuda.synchronize()
    assert calls == ["kmeans_assign"]
    b = tka.kmeans_assign(xc[:n], None, cc)
    ones = tka.kmeans_assign(xc[:n], torch.ones(n, device=cuda), cc)
    for u, v, o in zip(a, b, ones):
        assert torch.equal(u, v) and torch.equal(u, o)
    off = tka.kmeans_assign(xc[1:], None, cc)
    want = tka.kmeans_assign(torch.from_numpy(x[1:]), None,
                             torch.from_numpy(centers.astype(np.float32)))
    assert torch.equal(off[1].cpu(), want[1])
    assert _within(off[0], want[0], torch.from_numpy(x[1:]).double().abs(
        ).sum(0))


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


def _hist_inputs(n, d, seed, one_bin=False):
    """x (n, d) on the card (NaN, inf and the edges among the values, or
    every value in one bin) and a 0/1 mask."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.2, size=(n, d)).astype(np.float32)
    x[:4, 0] = [np.nan, np.inf, -np.inf, HI]
    if one_bin:
        x[:] = 0.25
    mask = (rng.random(n) > 0.3).astype(np.float32)
    return torch.from_numpy(x).cuda(), torch.from_numpy(mask).cuda()


def _keys(n, G, skew, seed):
    """f32 keys on the card: uniform over [0, G), or key g ∝ 2^-g."""
    rng = np.random.default_rng(seed)
    p = np.ones(G) if not skew else 2.0 ** -np.arange(G)
    return torch.from_numpy(rng.choice(G, size=n, p=p / p.sum()).astype(
        np.float32)).cuda()


def _hist_run(kind, seed, x, B, nbins, **kw):
    """Counts of kernel 3 ("k3"), of kernel 4's histogram slot ("k4", in a
    group with Mean and Std) or of the keyed histogram ("keyed")."""
    if kind == "k4":
        group = StatisticGroup((Mean(), Quantile(0.5, nbins=nbins, lo=LO,
                                                 hi=HI), Std()))
        return tfm.fused_poisson_multi(group, seed, x, B, **kw)[1].counts
    return twh.fused_poisson_hist(seed, x, LO, HI, nbins, B, **kw)


def _hist_plain(seed, x, B, nbins, **kw):
    """The plain version on the card (the CPU's takes long at 2^16 rows)."""
    d = x.shape[1]
    pr = tws.prepare(x, B, **kw)
    lo = torch.full((d,), LO, device=x.device)
    hi = torch.full((d,), HI, device=x.device)
    run = twh.grouped_hist_plain if "group_ids" in kw else twh.hist_plain
    return run(pr, seed, lo, hi, nbins)[:B]


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [1, 4])
def test_cuda_kernel_4_matches_plain_and_kernel_2(cuda, d, masked):
    """Kernel 4 (u32 bins, the slot table read once a CTA, DC = 1 at
    d = 1): its histogram slot bitwise the plain version and kernel 3, its
    moments slot bitwise kernel 2, and two launches bitwise equal."""
    n, B = (1 << 16) + 37, 256
    x, mask = _hist_inputs(n, d, seed=d + 10 * masked)
    x = torch.nan_to_num(x, posinf=HI, neginf=LO)
    kw = dict(valid_mask=mask if masked else None)
    group = StatisticGroup((Mean(), Quantile(0.5, nbins=2048, lo=LO, hi=HI),
                            Std()))
    g = tfm.fused_poisson_multi(group, 21, x, B, **kw)
    assert torch.equal(g[1].counts, _hist_plain(21, x, B, 2048, **kw))
    assert torch.equal(g[1].counts, _hist_run("k3", 21, x, B, 2048, **kw))
    for a, b in zip((g[0].w, g[0].s1, g[0].s2),
                    tws.fused_poisson_moments(21, x, B, **kw)):
        assert torch.equal(a, b)
    again = tfm.fused_poisson_multi(group, 21, x, B, **kw)
    for a, b in zip((g[0].w, g[0].s1, g[0].s2, g[1].counts),
                    (again[0].w, again[0].s1, again[0].s2, again[1].counts)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("skew", [False, True])
@pytest.mark.parametrize("d", [1, 4])
@pytest.mark.parametrize("G", [1, 8, 32])
def test_cuda_keyed_hist_matches_plain_and_masked(cuda, G, d, skew):
    """The key-major keyed histogram, with uniform and 2^-g-skewed keys:
    bitwise the plain version with and without a mask, two launches
    bitwise equal, and slot g bitwise kernel 3 masked to key g."""
    n, B, nbins = (1 << 16) + 37, 256, 2048 if d == 1 else 256
    x, mask = _hist_inputs(n, d, seed=G + d)
    keys = _keys(n, G, skew, seed=G * d)
    for m in (None, mask):
        kw = dict(group_ids=keys, num_groups=G, valid_mask=m)
        got = _hist_run("keyed", 31, x, B, nbins, **kw)
        assert torch.equal(got, _hist_plain(31, x, B, nbins, **kw))
        assert torch.equal(got, _hist_run("keyed", 31, x, B, nbins, **kw))
        for g in sorted({0, 1 % G, G - 1}):
            km = (keys == g).float() if m is None else m * (keys == g)
            assert torch.equal(got[:, g], _hist_run("k3", 31, x, B, nbins,
                                                    valid_mask=km))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["k3", "k4", "keyed"])
def test_cuda_hist_all_in_one_bin(cuda, kind):
    """Every value in one bin, the most contended shared adds: bitwise."""
    n, B = (1 << 16) + 37, 256
    x, _ = _hist_inputs(n, 1, seed=3, one_bin=True)
    kw = {}
    if kind == "keyed":
        kw = dict(group_ids=_keys(n, 8, True, seed=4), num_groups=8)
    got = _hist_run(kind, 41, x, B, 2048, **kw)
    assert torch.equal(got, _hist_plain(41, x, B, 2048, **kw))
    assert int((got.sum(dim=0) != 0).sum()) == (8 if kw else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["k3", "k4", "keyed"])
def test_cuda_hist_fractional_mask(cuda, kind):
    """A mask value other than 0/1 makes a CTA's weights fractional: the
    CTAs whose columns hold one add weight × mask as f32, the others whole
    counts as u32; counts within 1e-6 of the row's mass a bin of the plain
    version."""
    n, B = (1 << 16) + 37, 64
    x, mask = _hist_inputs(n, 2, seed=5)
    mask[:20_000:3] = 0.5
    kw = dict(valid_mask=mask)
    if kind == "keyed":
        kw.update(group_ids=_keys(n, 8, True, seed=6), num_groups=8)
    got = _hist_run(kind, 51, x, B, 2048, **kw)
    want = _hist_plain(51, x, B, 2048, **kw)
    dims = tuple(range(1, want.ndim))
    bound = 1e-6 * want.double().sum(dim=dims)
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= bound.reshape(-1, *[1] * len(dims))).all())
    assert not torch.equal(got, got.round())


@pytest.mark.cuda
def test_cuda_keyed_hist_limit(cuda):
    """The keyed histogram keeps one key's d·nbins bins a row: at G = 8,
    d = 4, nbins = 2048 (65,536 bins a row) it runs, bitwise kernel 7 and
    the plain version; at d = 32 (65,536 bins a key's row) it raises
    before any launch and names block_bins."""
    n, B, G = 20_000, 64, 8
    x, _ = _hist_inputs(n, 4, seed=7)
    kw = dict(group_ids=_keys(n, G, True, seed=8), num_groups=G)
    got = _hist_run("keyed", 61, x, B, 2048, **kw)
    assert torch.equal(got, _hist_plain(61, x, B, 2048, **kw))
    assert torch.equal(got, twh.fused_poisson_hist(61, x, LO, HI, 2048, B,
                                                   block_bins=2048, **kw))
    before = twh.grouped_hist_cuda.launches
    with pytest.raises(NotImplementedError, match="block_bins"):
        twh.fused_poisson_hist(61, torch.zeros(n, 32, device=cuda), LO, HI,
                               2048, B, **kw)
    assert twh.grouped_hist_cuda.launches == before


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
#: that sees no key at all, causal=False and the decode offset, and the
#: cross-attention serving path's non-causal geometries at batch 1
#: (llama-3.2-vision-90b's cross-attention, GQA 64/8 at D = 128 over 1600
#: keys; whisper-small's encoder over 1500 frames and its cross-attention
#: of 224 queries over them: the last key tile ragged)
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
    ((1, 64, 8, 8192, 1600, 128), dict(causal=False)),
    ((1, 12, 12, 1500, 1500, 64), dict(causal=False)),
    ((1, 12, 12, 224, 1500, 64), dict(causal=False)),
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


#: head dims past 128: gemma3-27b's 168 at its 32/16 heads (three TMA
#: boxes, the third 24 columns of zero fill) and 256 (four), causal and
#: windowed, Sq and Skv off the tiles
WIDE_FA_CASES = [
    ((1, 32, 16, 200, 200, 168), dict(causal=True)),
    ((2, 4, 2, 300, 300, 168), dict(causal=True, window=100)),
    ((1, 8, 2, 513, 513, 256), dict(causal=True)),
    ((1, 4, 4, 130, 260, 256), dict(causal=True, window=64,
                                    kv_offset=130)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kw", WIDE_FA_CASES,
                         ids=[str(s) for s, _ in WIDE_FA_CASES])
def test_cuda_flash_attention_head_dims_168_and_256_match_plain(
        cuda, shape, kw, dtype):
    """D = 168 and 256 in both routes at kernel 12's tolerance; bf16 twice
    bitwise."""
    from repro_torch.kernels.flash_attention import ops as tfa
    q, k, v = _fa_inputs(shape, dtype, cuda, shape[3] + shape[5])
    got = tfa.flash_attention(q, k, v, **kw)
    want = tfa.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert _fa_close(got, want, dtype, q, k, v, **kw)
    if dtype == torch.bfloat16:
        assert torch.equal(got, tfa.flash_attention(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_head_dim_past_256_raises(cuda, dtype):
    from repro_torch.kernels.flash_attention import ops as tfa
    q, k, v = _fa_inputs((1, 2, 1, 16, 16, 264), dtype, cuda, 6)
    before = tfa.flash_attention.launches
    with pytest.raises(ValueError, match="MAX_HEAD_DIM = 256"):
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


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "xlstm-350m"])
def test_cuda_recurrent_decode_matches_teacher_forcing(cuda, arch):
    """The recurrent smoke models (RG-LRU with local attention; sLSTM and
    mLSTM) in f32 on the card: decode step t's logits equal the full
    forward's at position S + t, the prefill launches kernel 12 once a
    ``local`` layer and decode never, and every decode step writes the
    recurrent state into the cache it was given."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as tfa
    from repro_torch.models import (decode_step, forward_hidden,
                                    init_params, logits_from_hidden, prefill)
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    B, S = 2, 32
    toks = torch.randint(0, cfg.vocab, (B, S + 3), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(2))
    h, _ = forward_hidden(cfg, params, toks, mode="train")
    full = logits_from_hidden(cfg, params, h)
    before = tfa.flash_attention.launches
    lg, cache = prefill(cfg, params, toks[:, :S], cache_len=S + 3)
    local = sum(cfg.layer_pattern[i % cfg.pattern_len] == "local"
                for i in range(cfg.n_layers))
    assert tfa.flash_attention.launches == before + local
    torch.testing.assert_close(lg, full[:, S - 1], atol=2e-4, rtol=1e-3)
    cell = cache["groups"]["0"]["cell"]
    for t in range(3):
        state = {k: v.clone() for k, v in cell.items()}
        lg, new = decode_step(cfg, params, cache, toks[:, S + t:S + t + 1],
                              S + t)
        torch.testing.assert_close(lg, full[:, S + t], atol=2e-4, rtol=1e-3)
        for k, v in new["groups"]["0"]["cell"].items():
            assert v is cell[k] and not torch.equal(v, state[k])
    assert tfa.flash_attention.launches == before + local


@pytest.mark.cuda
def test_cuda_whisper_smoke_matches_the_cpu(cuda):
    """whisper-small's smoke config in f32 (2 encoder and 2 decoder
    layers, the encoder over 37 frames, off the 16-row blocks) with its
    gates drawn from uniform [0.5, 1.0): the prefill with the stub frame
    embeddings and 4 greedy decode steps on the card within 1e-4 of
    max|logit| of the same on the CPU, the same greedy tokens, and kernel
    12 launched once an encoder layer and twice a decoder layer in the
    prefill, never in decode."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import ops as tfa
    from repro_torch.models import decode_step, init_params, prefill
    cfg = dataclasses.replace(get_config("whisper-small", smoke=True),
                              enc_seq=37)
    params = init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    gen = torch.Generator().manual_seed(4)
    gates = params["groups"]["0"]["xattn"]["gate"]
    gates.copy_(torch.rand(gates.shape, generator=gen) * 0.5 + 0.5)
    toks = torch.randint(0, cfg.vocab, (2, 20), generator=gen)
    aux = torch.randn(2, cfg.enc_seq, cfg.d_model, generator=gen)

    def to(tree, dev):
        return ({k: to(v, dev) for k, v in tree.items()}
                if isinstance(tree, dict) else tree.to(dev))
    card = to(params, cuda)
    runs = {}
    for dev, p in (("cpu", params), (cuda, card)):
        before = tfa.flash_attention.launches
        lg, cache = prefill(cfg, p, toks.to(dev), aux=aux.to(dev),
                            cache_len=24)
        n_pre = tfa.flash_attention.launches - before
        steps, out = [lg], []
        for t in range(4):
            tok = torch.argmax(lg, -1)[:, None]
            out.append(tok.cpu())
            lg, cache = decode_step(cfg, p, cache, tok, 20 + t)
            steps.append(lg)
        n_dec = tfa.flash_attention.launches - before - n_pre
        runs[str(dev)] = (torch.stack(steps).cpu(), torch.cat(out, 1),
                          n_pre, n_dec)
    (want, want_toks, _, _), (got, got_toks, n_pre, n_dec) = (
        runs["cpu"], runs[str(cuda)])
    assert (n_pre, n_dec) == (cfg.enc_layers + 2 * cfg.n_layers, 0)
    assert torch.equal(got_toks, want_toks)
    v = cfg.vocab
    assert float((got[..., :v] - want[..., :v]).abs().max()) <= (
        1e-4 * float(want[..., :v].abs().max()))


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


def _live_log(n_batches, rows, d, seed=31, absolute=False):
    from repro_torch.live import IngestLog
    rng = np.random.default_rng(seed)
    log = IngestLog()
    for _ in range(n_batches):
        x = rng.normal(size=(rows, d)).astype(np.float32)
        log.append(np.abs(x) if absolute else x)
    return log


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["var", "group"])
def test_cuda_live_fold_across_two_panes_matches_plain(cuda, kind):
    """Batches of 48 rows over 32-row panes: every fold spans two panes
    and launches the fused kernel once a pane (kernel 2 for Var, kernel 4
    for the quickstart group) over the whole batch under each pane's
    mask.  Each pane's states against the CPU session's (the plain
    versions): w_tot and counts bitwise, s1 within 1e-5·Σw|x|, s2 within
    1e-5·Σw·x²."""
    from repro_torch import random as trandom
    from repro_torch.core import SlidingWindow, Var
    from repro_torch.core.reduce_api import HistogramState, MomentState
    from repro_torch.live import LiveSession

    stat = (Var() if kind == "var" else
            StatisticGroup((Mean(), Quantile(0.5, NBINS, LO, HI), Std())))
    kernel = (tws.fused_poisson_moments if kind == "var"
              else tfm.fused_poisson_multi)
    log = _live_log(6, 48, 2)
    runs = {}
    for dev in ("cpu", "cuda"):
        s = LiveSession(log, SlidingWindow(stat, 128, 32), B=64,
                        key=trandom.PRNGKey(3), device=dev)
        before = kernel.launches
        reports = s.poll()
        runs[dev] = (s, reports, kernel.launches - before)
    cpu, gpu = runs["cpu"][0], runs["cuda"][0]
    # a 48-row batch at row r overlaps panes r // 32 .. (r + 47) // 32
    assert runs["cuda"][2] == sum((48 * i + 47) // 32 - 48 * i // 32 + 1
                                  for i in range(6))
    abs_s = LiveSession(_live_log(6, 48, 2, absolute=True),
                        SlidingWindow(stat, 128, 32), B=64,
                        key=trandom.PRNGKey(3), device="cpu")
    abs_s.poll()
    assert sorted(gpu._ring) == sorted(cpu._ring)

    def check(g, c, a):
        if isinstance(g, tuple):
            for parts in zip(g, c, a):
                check(*parts)
        elif isinstance(g, MomentState):
            assert torch.equal(g.w.cpu(), c.w)
            assert bool(((g.s1.cpu() - c.s1).abs() <= 1e-5 * a.s1).all())
            assert bool(((g.s2.cpu() - c.s2).abs() <= 1e-5 * c.s2).all())
        else:
            assert isinstance(g, HistogramState)
            assert torch.equal(g.counts.cpu(), c.counts)

    for p in gpu._ring:
        check(gpu._ring[p].states, cpu._ring[p].states,
              abs_s._ring[p].states)
        assert (gpu._ring[p].rows, gpu._ring[p].valid) == \
            (cpu._ring[p].rows, cpu._ring[p].valid)


@pytest.mark.cuda
def test_cuda_live_resume_is_bitwise_and_lands_on_the_card(cuda, tmp_path):
    """A windowed session on the card killed at a fold that is not a
    checkpoint boundary resumes from its last snapshot onto the card and
    ends bitwise the uninterrupted run."""
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import SlidingWindow, Var
    from repro_torch.live import LiveSession

    class Kill(Exception):
        pass

    class Dying(CheckpointManager):
        def save(self, *a, **kw):
            super().save(*a, **kw)
            raise Kill

    log = _live_log(10, 64, 1)
    window = SlidingWindow(Var(), 128, 32)
    base = LiveSession(log, window, B=32, key=trandom.PRNGKey(5))
    base.poll()
    want = base.report()
    root = str(tmp_path / "ckpt")
    # the first save is at fold 4; the run dies there, 6 folds short
    with pytest.raises(Kill):
        LiveSession(log, window, B=32, key=trandom.PRNGKey(5),
                    checkpoint=Dying(root, async_save=False),
                    checkpoint_every=4).poll()
    r = LiveSession(log, window, B=32, key=trandom.PRNGKey(5), resume=True,
                    checkpoint=CheckpointManager(root, async_save=False),
                    checkpoint_every=4)
    assert r.counters.folded == 4
    assert all(p.states.w.is_cuda and p.est.s1.is_cuda
               for p in r._ring.values())
    r.poll()
    got = r.report()
    assert torch.equal(got.thetas, want.thetas)
    assert torch.equal(got.estimate, want.estimate)
    assert got.p_eff == want.p_eff and r.counters.folded == 10


@pytest.mark.cuda
def test_cuda_session_resume_is_bitwise(cuda, tmp_path):
    """The quickstart group's session at 200,000 rows and sigma 0.002 on
    the card, killed after its first save and resumed, is bitwise the
    uninterrupted run; it takes the CPU run's B, rows and iterations."""
    from repro_torch import random as trandom
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import EarlSession
    from repro_torch.data import PreMapSampler, ShardedStore, \
        synthetic_numeric

    class Kill(Exception):
        pass

    class Dying(CheckpointManager):
        def save(self, *a, **kw):
            super().save(*a, **kw)
            raise Kill

    data = synthetic_numeric(200_000, mean=10.0, std=2.0, seed=0)

    def run(device=None, checkpoint=None, resume=False):
        store = ShardedStore.from_array(data, split_size=65_536)
        group = StatisticGroup((Mean(), Quantile(0.5, lo=0.0, hi=25.0),
                                Std()))
        return EarlSession(PreMapSampler(store, seed=1, device=device),
                           group, sigma=0.002, backend="fused_rng",
                           checkpoint=checkpoint, device=device).run(
            trandom.PRNGKey(0), resume=resume)

    base = run()
    root = str(tmp_path / "ckpt")
    with pytest.raises(Kill):
        run(checkpoint=Dying(root, async_save=False))
    got = run(checkpoint=CheckpointManager(root, async_save=False),
              resume=True)
    assert (got.B, got.n_used, got.iterations, got.cv) == \
        (base.B, base.n_used, base.iterations, base.cv)
    for a, b in zip(got.result, base.result):
        assert torch.equal(a, b) and a.is_cuda
    cpu = run("cpu")
    assert (cpu.B, cpu.n_used, cpu.iterations) == \
        (base.B, base.n_used, base.iterations)


_NCCL1_SCRIPT = r"""
import os, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.core import (GroupedStatistic, Mean, Quantile,
                              StatisticGroup, Std, fused_resample_states,
                              sharded_fused_states)
from repro_torch.core.bootstrap import offset_seed
from repro_torch.checkpoint.manager import _leaves

os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
dist.init_process_group("nccl", store=dist.FileStore(sys.argv[1], 1),
                        rank=0, world_size=1)
try:
    mesh = DeviceMesh("cuda", [0], mesh_dim_names=("data",))
    gen = torch.Generator().manual_seed(5)
    n = (1 << 16) + 37
    x = (torch.randn(n, 1, generator=gen) * 2 + 10).cuda()
    keyed = torch.cat([x, torch.randint(0, 8, (n, 1), generator=gen)
                       .float().cuda()], 1)
    cases = ((StatisticGroup((Mean(), Quantile(0.5, lo=0.0, hi=25.0),
                              Std())), x),
             (GroupedStatistic(Mean(), 8), keyed))
    for stat, v in cases:
        for step in (0, 2):
            got = sharded_fused_states(stat, 99, v, 64, mesh=mesh,
                                       step=step)
            want = fused_resample_states(stat, offset_seed(99, step), v, 64)
            for (p, a), (_, b) in zip(_leaves(got), _leaves(want)):
                assert a.is_cuda and torch.equal(a, b), (type(stat), p)
finally:
    dist.destroy_process_group()
print("nccl world of 1: bitwise")
"""


@pytest.mark.cuda
def test_cuda_nccl_world_of_one_is_the_unsharded_path(cuda, tmp_path):
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    out = subprocess.run(
        [sys.executable, "-c", _NCCL1_SCRIPT, str(tmp_path / "store")],
        env=dict(os.environ, PYTHONPATH=src), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "bitwise" in out.stdout


# ---------------------------------------------------------------------------
# the mixture-of-experts FFN
# ---------------------------------------------------------------------------
def _moe_inputs(compute_dtype, seed=0):
    """mixtral-8x22b's smoke config widened to 8 experts, d_model 256 and
    d_ff 512, f32 params, the given compute dtype; its params on the CPU
    and tokens skewed toward some experts, so the published capacity
    factor (1.25) drops slots."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models.layers import init_moe
    cfg = dataclasses.replace(get_config("mixtral-8x22b", smoke=True),
                              d_model=256, d_ff=512, num_experts=8,
                              compute_dtype=compute_dtype)
    p = init_moe(cfg, torch.Generator().manual_seed(seed), "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    x = (torch.randn((2, 64, cfg.d_model), generator=gen)
         + 1.5 * torch.randn((cfg.d_model,), generator=gen))
    return cfg, p, x.to(getattr(torch, compute_dtype))


@pytest.mark.cuda
def test_cuda_bmm_out_is_the_f32_product_of_the_bf16_values(cuda):
    from repro_torch.models.layers import bmm_out
    gen = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((8, 300, 256), device=cuda, generator=gen).bfloat16()
    b = torch.randn((8, 256, 520), device=cuda, generator=gen).bfloat16()
    got = bmm_out(a, b, torch.float32)
    assert got.dtype == torch.float32 and got.shape == (8, 300, 520)
    want = torch.bmm(a.float(), b.float())
    # the f32 dot bound: k · 2^-24 · Σ|a||b|, a rounding an addend
    bound = 256 * 2.0 ** -24 * torch.bmm(a.float().abs(), b.float().abs())
    assert bool(((got - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype,rel", [("float32", 1e-5),
                                               ("bfloat16", 2e-2)])
def test_cuda_moe_ffn_matches_the_cpu(cuda, compute_dtype, rel):
    """moe_ffn on the card against the CPU on the same params and tokens
    at capacity 1.25 (slots drop): the expert choices and kept slots
    agree at every token but near ties (a k-th and (k+1)-th probability
    within 1e-3 of each other), the dropped count agrees where no choice
    flipped, and y agrees at the agreeing tokens within rel·max|y| (f32
    compute: the dot bound's order; bf16: h rounded to bf16 before the
    down projection, 2e-2 as chip_smoke.py's logits)."""
    from repro_torch.models.layers import (dropped_slots, moe_ffn,
                                           moe_route, route_agreement)
    cfg, p, x = _moe_inputs(compute_dtype)
    pc = {k: v.to(cuda) for k, v in p.items()}
    xc = x.to(cuda)
    want = moe_ffn(cfg, p, x).float()
    got = moe_ffn(cfg, pc, xc).float().cpu()
    rw = moe_route(cfg, p, x.reshape(-1, cfg.d_model))
    rg = moe_route(cfg, pc, xc.reshape(-1, cfg.d_model))
    agree, ties, unexplained = route_agreement(rg, rw)
    assert unexplained == 0
    assert int(dropped_slots(rw)) > 0
    if bool(agree.all()):
        assert int(dropped_slots(rg)) == int(dropped_slots(rw))
    g = got.reshape(-1, cfg.d_model)[agree]
    w = want.reshape(-1, cfg.d_model)[agree]
    assert int(agree.sum()) >= x.shape[0] * x.shape[1] - int(ties.sum())
    assert float((g - w).abs().max()) <= rel * float(w.abs().max())


@pytest.mark.cuda
def test_cuda_moe_drops_the_cpu_slots(cuda):
    """At a capacity that drops many slots (0.5), f32 compute: where no
    token's choice of experts flipped (only a near tie can flip one), the
    sorted token-slots, which of them are kept and their dispatch rows
    on the card are the CPU's, bitwise."""
    import dataclasses
    from repro_torch.models.layers import moe_route, route_agreement
    cfg, p, x = _moe_inputs("float32", seed=4)
    cfg = dataclasses.replace(cfg, capacity_factor=0.5)
    xt = x.reshape(-1, cfg.d_model)
    rw = moe_route(cfg, p, xt)
    rg = moe_route(cfg, {k: v.to(cuda) for k, v in p.items()}, xt.to(cuda))
    _, _, unexplained = route_agreement(rg, rw)
    assert unexplained == 0
    assert int((~rw.keep).sum()) > 0
    same = bool((rg.eidx.cpu().sort(-1).values
                 == rw.eidx.sort(-1).values).all())
    if not same:
        return      # unexplained == 0: each flipped choice was a near tie
    for name in ("se", "st", "keep", "slot"):
        assert torch.equal(getattr(rg, name).cpu(), getattr(rw, name)), name


# ---------------------------------------------------------------------------
# the training slice: kernel 12's backward, lse, the f32-output products'
# gradients and a smoke train step, each on the card against the CPU or the
# plain version
# ---------------------------------------------------------------------------
#: (b, hq, hkv, sq, skv, d), kwargs: causal GQA 4:1, a window, not causal
#: with Sq != Skv, ragged 37 and 67, a negative and a positive kv_offset,
#: a query block that sees no key, and head dims 20, 168 and 256
FA_BWD_CASES = [
    ((2, 8, 2, 128, 128, 64), dict(causal=True)),
    ((1, 4, 1, 200, 200, 64), dict(causal=True, window=50)),
    ((1, 4, 4, 37, 67, 16), dict(causal=False)),
    ((1, 4, 2, 67, 37, 20), dict(causal=True, kv_offset=30)),
    ((1, 8, 8, 130, 100, 128), dict(causal=True, kv_offset=-20, window=60)),
    ((1, 2, 1, 64, 32, 16), dict(causal=True, window=16, kv_offset=100)),
    ((1, 4, 2, 96, 96, 168), dict(causal=True)),
    ((1, 2, 1, 80, 80, 256), dict(causal=True, window=32)),
]


def _bwd_bounds(q, k, v, o, do, lse, causal=True, window=None, kv_offset=0,
                scale=None):
    """Σ|terms| of each entry of dq, dk and dv (dense, f32): P from lse,
    |dS| bounded by P·(|dO|·|V|ᵀ + rowsum|dO ∘ O|)."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    f = [t.float() for t in (q, k, v, o, do)]
    qf, of, dof = f[0], f[3], f[4]
    kf, vf = (t.repeat_interleave(g, dim=1) for t in f[1:3])
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = attention_mask(sq, skv, causal, window, kv_offset, q.device)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hq, sq, 1)), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof.abs(), vf.abs())
              + (dof * of).abs().sum(-1, keepdim=True))
    bq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf.abs())
    bk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf.abs())
    bv = torch.einsum("bhqk,bhqd->bhkd", p, dof.abs())
    return bq, (bk.reshape(b, hkv, g, skv, d).sum(2),
                bv.reshape(b, hkv, g, skv, d).sum(2))


def _bwd_close(got, want, bound, tc=False):
    """f32 within 1e-5·Σ|terms|; bf16 also one bf16 rounding of the
    value, 2^-7·|want|, and on the tensor-core route (``tc``) 2^-8·Σ|terms|
    more: P and dS rounded to bf16 (RNE, relative 2^-8 at most) before the
    products that take them, one rounded factor in each term."""
    tol = (1e-5 + (2.0 ** -8 if tc else 0.0)) * bound
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    return bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kw", FA_BWD_CASES,
                         ids=[str(s) for s, _ in FA_BWD_CASES])
def test_cuda_flash_attention_backward_matches_plain(cuda, shape, kw, dtype):
    """The backward kernel against flash_attention_backward_plain on the
    same q, k, v, o, lse and dO (the kernel's forward), one launch a call
    (bf16 up to D = 128 on the tensor-core route, the rest on the CUDA
    cores), and lse against the plain version's; two launches give the
    same bits."""
    from repro_torch.kernels.flash_attention import ops as tfa
    q, k, v = _fa_inputs(shape, dtype, cuda, shape[3] + shape[4])
    do = torch.randn(q.shape, generator=torch.Generator().manual_seed(5)
                     ).to(dtype).to(cuda)
    scale = shape[5] ** -0.5
    kw = dict(kw, scale=scale, window=kw.get("window"),
              kv_offset=kw.get("kv_offset", 0))
    o, lse = tfa._forward_cuda(q, k, v, with_lse=True, **kw)
    assert torch.equal(o, tfa.flash_attention_cuda(q, k, v, **kw))
    _, lse_plain = tfa.flash_attention_plain_lse(q, k, v, **kw)
    fin = torch.isfinite(lse_plain)
    assert torch.equal(fin, torch.isfinite(lse))
    assert not bool(fin.any()) or \
        float((lse - lse_plain)[fin].abs().max()) <= 1e-4
    before = tfa.flash_attention_backward_cuda.launches
    tc0 = tfa.flash_attention_backward_cuda.tc_launches
    got = tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert tfa.flash_attention_backward_cuda.launches == before + 1
    tc = dtype == torch.bfloat16 and shape[5] <= 128
    assert tfa.flash_attention_backward_cuda.tc_launches == tc0 + int(tc)
    want = tfa.flash_attention_backward_plain(q, k, v, o, lse, do, **kw)
    bounds = _bwd_bounds(q, k, v, o, do, lse, kw["causal"], kw["window"],
                         kw["kv_offset"], scale)
    bounds = (bounds[0],) + bounds[1]
    for name, g_, w_, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        assert g_.dtype == dtype and g_.shape == w_.shape, name
        assert _bwd_close(g_, w_, bd, tc), name
    again = tfa.flash_attention_backward_cuda(q, k, v, o, lse, do, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if kw["kv_offset"] == 100:       # the window ends before the first key
        assert all(bool((t == 0).all()) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_flash_attention_gradients_match_the_cpu(cuda, dtype):
    """flash_attention with a gradient on the card (kernel 12 forward with
    lse, then the backward kernel: one launch each) against autograd on
    the CPU (the plain versions), on transposed (non-contiguous) inputs
    as self_attention passes them."""
    from repro_torch.kernels.flash_attention import ops as tfa
    shape, kw = (2, 8, 2, 96, 96, 64), dict(causal=True, window=40)
    g = torch.Generator().manual_seed(8)
    base = [torch.randn((s[0], s[2], s[1], s[3]), generator=g).to(dtype)
            for s in ((2, 8, 96, 64), (2, 2, 96, 64), (2, 2, 96, 64))]
    do = torch.randn((2, 8, 96, 64), generator=g).to(dtype)

    def run(dev):
        leaves = [t.to(dev).requires_grad_(True) for t in base]
        q, k, v = (t.transpose(1, 2) for t in leaves)
        out = tfa.flash_attention(q, k, v, **kw)
        out.backward(do.to(dev))
        return out.detach().cpu(), [t.grad.cpu() for t in leaves]

    f0, b0 = tfa.flash_attention.launches, \
        tfa.flash_attention_backward_cuda.launches
    out_c, grads_c = run(cuda)
    assert tfa.flash_attention.launches == f0 + 1
    assert tfa.flash_attention_backward_cuda.launches == b0 + 1
    out_h, grads_h = run("cpu")
    share = 1e-4 if dtype == torch.float32 else 2e-2
    for a, b in zip([out_c] + grads_c, [out_h] + grads_h):
        assert float((a.float() - b.float()).abs().max()) <= \
            share * float(b.float().abs().max())


@pytest.mark.cuda
def test_cuda_product_out_gradients_match_the_cpu(cuda):
    """matmul_out and bmm_out with bf16 operands and an f32 output
    differentiate on the card (torch.mm/bmm with out_dtype has no
    derivative of its own): the gradients are the CPU path's, f32
    products of the f32 cotangent and the bf16 operand rounded to bf16,
    within one bf16 rounding (f32 sums in another order)."""
    from repro_torch.models.layers import bmm_out, matmul_out
    g = torch.Generator().manual_seed(9)
    for fn, sa, sb in ((matmul_out, (48, 64), (64, 80)),
                       (bmm_out, (3, 40, 64), (3, 64, 24))):
        a = torch.randn(sa, generator=g).to(torch.bfloat16)
        b = torch.randn(sb, generator=g).to(torch.bfloat16)
        ct = torch.randn(sa[:-1] + sb[-1:], generator=g)
        grads = []
        for dev in (cuda, "cpu"):
            ad, bd = (t.to(dev).requires_grad_(True) for t in (a, b))
            out = fn(ad, bd, torch.float32)
            assert out.dtype == torch.float32
            out.backward(ct.to(dev))
            grads.append((ad.grad.cpu(), bd.grad.cpu()))
        for got, want in zip(*grads):
            assert got.dtype == torch.bfloat16
            diff = (got.float() - want.float()).abs()
            assert bool((diff <= 2.0 ** -7 * want.float().abs()
                         + 1e-5).all())


@pytest.mark.cuda
@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_cuda_smoke_train_step_matches_the_cpu(cuda, compute):
    """One granite-3-2b smoke train step on the card (kernel 12 forward
    with remat's recompute, its backward, the f32-output products'
    backward) against the same step on the CPU from the same params:
    loss, grad_norm and every updated parameter within 1e-4 (f32
    compute) or 2e-2 (bf16) of the largest value."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.kernels.flash_attention import ops as tfa
    from repro_torch.train import TrainState, make_train_step
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True),
                              compute_dtype=compute)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.randint(0, cfg.vocab, (2, 65),
                         generator=torch.Generator().manual_seed(4))
    batch = {"tokens": toks[:, :64], "labels": toks[:, 1:]}
    out = []
    for dev in (cuda, "cpu"):
        p = tree_map(lambda t: t.to(dev).clone(), params)
        state = TrainState(p, adamw_init(p, ocfg))
        f0 = tfa.flash_attention.launches
        b0 = tfa.flash_attention_backward_cuda.launches
        state, m = make_train_step(cfg, ocfg)(state, batch)
        if dev == cuda:
            assert tfa.flash_attention.launches - f0 == 2 * cfg.n_layers
            assert tfa.flash_attention_backward_cuda.launches - b0 == \
                cfg.n_layers
        out.append((m, dict(tree_leaves(state.params))))
    share = 1e-4 if compute == "float32" else 2e-2
    (mc, pc), (mh, ph) = out
    for key in ("loss", "grad_norm"):
        assert abs(float(mc[key]) - float(mh[key])) <= \
            share * abs(float(mh[key]))
    for path, want in ph.items():
        got = pc[path].cpu()
        assert float((got - want).abs().max()) <= \
            share * float(want.abs().max()), path
