"""The port's four kernel ops against the JAX package's scan lowering.

Inputs are made with numpy from a seed and handed to both packages.  The
JAX side runs ``backend="scan"`` plus ``ref.py``.  On the CPU the port runs
each kernel's plain version, so this holds the arithmetic the CUDA kernels
are compared with on the card:

* weights, w_tot and histogram counts bitwise;
* s1 within 1e-5·Σw|x| and s2 within 1e-5·Σw·x² per entry (f32 dots in
  another order);
* a StatisticGroup member bitwise equal to the port's dedicated run.

The CUDA kernels themselves are held against these plain versions in
tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reduce_api as jra
from repro.core.bootstrap import fused_resample_states as j_fused_states
from repro.kernels.fused_multi import ops as jfm
from repro.kernels.weighted_hist import ops as jwh
from repro.kernels.weighted_hist import ref as jwh_ref
from repro.kernels.weighted_stats import ops as jws
from repro_torch.core import reduce_api as tra
from repro_torch.core.bootstrap import fused_resample_states as t_fused_states
from repro_torch.kernels.fused_multi import ops as tfm
from repro_torch.kernels.poisson_counts import ops as tpc
from repro_torch.kernels.poisson_counts.ref import (POISSON_CDF_F32,
                                                    weight_tile_blocks)
from repro_torch.kernels.weighted_hist import ops as twh
from repro_torch.kernels.weighted_hist import ref as twh_ref
from repro_torch.kernels.weighted_stats import ops as tws

torch.set_num_threads(1)

# (B, n, d): B < 8, B = 100 (a non-power-of-two RNG tile), B > 128,
# ragged n below, inside and above the 128..512 clamp of block_n.
SHAPES = [(3, 37, 1), (8, 300, 2), (100, 1000, 1), (130, 700, 3)]
MASKS = ["none", "n_valid", "holes"]
NBINS, LO, HI = 64, -2.0, 2.0


def _case(B, n, d, mask_kind, seed=0, special=False):
    rng = np.random.default_rng(seed + 1000 * B + n)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if special:
        x[1, 0], x[2, 0], x[3, 0] = np.nan, np.inf, -np.inf
        x[4, 0], x[5, 0], x[6, 0] = HI, LO, 5.0
    n_valid = n - 5 if mask_kind == "n_valid" else None
    mask = None
    if mask_kind == "holes":
        mask = (rng.random(n) > 0.3).astype(np.float32)
    return int(rng.integers(0, 2 ** 31 - 1)), x, n_valid, mask


def _explicit_weights(seed, B, n, n_valid, mask):
    w = np.asarray(jws.implicit_weights(seed, B, n), np.float64)
    if n_valid is not None:
        w[:, n_valid:] = 0.0
    if mask is not None:
        w = w * mask[None, :]
    return w


def _assert_moments(got, want, x, w):
    """w_tot bitwise; s1/s2 within 1e-5 of Σw|x| / Σw·x² per entry."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(v) for v in want]
    np.testing.assert_array_equal(got[0], want[0])
    xd = np.asarray(x, np.float64)
    for g, v, bound in ((got[1], want[1], w @ np.abs(xd)),
                        (got[2], want[2], w @ (xd * xd))):
        assert g.shape == v.shape
        assert np.all(np.abs(g - v) <= 1e-5 * bound + 1e-30)


def test_cdf_ladder_is_the_reference_one():
    from repro.kernels.poisson_counts.kernel import _CDF
    assert POISSON_CDF_F32 == tuple(float(np.float32(c)) for c in _CDF)


@pytest.mark.parametrize("B,n", [(1, 1), (5, 130), (100, 300), (100, 8192),
                                 (200, 513)])
def test_weight_tile_blocks_and_weights_bitwise(B, n):
    assert weight_tile_blocks(B, n) == jws.weight_tile_blocks(B, n)
    seed = 2 ** 31 - 2 - B
    want = np.asarray(jws.implicit_weights(seed, B, n))
    got = tws.implicit_weights(seed, B, n, device="cpu")
    np.testing.assert_array_equal(want, got.numpy())
    np.testing.assert_array_equal(
        want, tpc.poisson_counts(seed, B, n, device="cpu").numpy())


@pytest.mark.parametrize("B", [1, 3, 5, 7, 8, 100, 129, 1000])
def test_tile_clamp_keeps_a_cta_within_two_b_tiles(B):
    # the CUDA pass puts MAX_ROWS rows of W in a CTA and assumes they
    # span at most two RNG b-tiles, which holds while bb >= MAX_ROWS
    from repro_torch.kernels._pass import MAX_ROWS
    bb, _ = weight_tile_blocks(B, 300)
    Bp = B + (-B) % bb
    assert bb >= MAX_ROWS
    for r0 in range(0, Bp, MAX_ROWS):
        rows = range(r0, min(Bp, r0 + MAX_ROWS))
        assert len({b // bb for b in rows}) <= 2


@pytest.mark.parametrize("t", [0, 2])
def test_implicit_weight_tile_bitwise(t):
    B, bb, bn, seed = 16, 8, 128, 77
    valid = np.tile(np.array([1.0, 0.0, 1.0, 1.0], np.float32), bn // 4)
    want = np.asarray(jws.implicit_weight_tile(
        jnp.int32(seed), jnp.int32(300), t, B, bb, bn,
        valid=jnp.asarray(valid)))
    got = tws.implicit_weight_tile(seed, 300, t, B, bb, bn,
                                   valid=torch.from_numpy(valid))
    np.testing.assert_array_equal(want, got.numpy())


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("B,n,d", SHAPES)
def test_fused_moments_plain_matches_jax(B, n, d, mask_kind):
    seed, x, n_valid, mask = _case(B, n, d, mask_kind)
    want = jws.fused_poisson_moments(seed, x, B, backend="scan",
                                     n_valid=n_valid, valid_mask=mask)
    got = tws.fused_poisson_moments(
        seed, torch.from_numpy(x), B, n_valid=n_valid,
        valid_mask=None if mask is None else torch.from_numpy(mask))
    _assert_moments(got, want, x, _explicit_weights(seed, B, n, n_valid,
                                                    mask))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("B,n,d", SHAPES)
def test_fused_hist_plain_matches_jax_bitwise(B, n, d, mask_kind):
    seed, x, n_valid, mask = _case(B, n, d, mask_kind, special=True)
    want = jwh.fused_poisson_hist(seed, x, LO, HI, NBINS, B, backend="scan",
                                  n_valid=n_valid, valid_mask=mask)
    got = twh.fused_poisson_hist(
        seed, torch.from_numpy(x), LO, HI, NBINS, B, n_valid=n_valid,
        valid_mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_bin_indices_and_scatter_ref_bitwise():
    x = np.array([[np.nan], [np.inf], [-np.inf], [HI], [LO], [0.0], [1e-7],
                  [HI - 1e-6], [7.0]], np.float32)
    lo = np.full((1,), LO, np.float32)
    hi = np.full((1,), HI, np.float32)
    for nbins in (1, 7, 2048):
        want = np.asarray(jwh_ref._bin_indices(x, lo[None], hi[None], nbins))
        got = twh_ref._bin_indices(torch.from_numpy(x),
                                   torch.from_numpy(lo)[None],
                                   torch.from_numpy(hi)[None], nbins)
        finite = ~np.isnan(x)
        np.testing.assert_array_equal(want[finite], got.numpy()[finite])
        w = np.arange(1, len(x) + 1, dtype=np.float32)
        np.testing.assert_array_equal(
            np.asarray(jwh_ref.weighted_hist_scatter_ref(x, w, lo, hi,
                                                         nbins)),
            twh_ref.weighted_hist_scatter_ref(
                torch.from_numpy(x), torch.from_numpy(w),
                torch.from_numpy(lo), torch.from_numpy(hi), nbins).numpy())


def _groups():
    return (jra.StatisticGroup((jra.Mean(), jra.Quantile(0.5, nbins=NBINS,
                                                         lo=LO, hi=HI),
                                jra.Std())),
            tra.StatisticGroup((tra.Mean(), tra.Quantile(0.5, nbins=NBINS,
                                                         lo=LO, hi=HI),
                                tra.Std())))


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("B,n,d", SHAPES)
def test_fused_multi_plain_matches_jax_and_dedicated(B, n, d, mask_kind):
    seed, x, n_valid, mask = _case(B, n, d, mask_kind)
    jg, tg = _groups()
    tmask = None if mask is None else torch.from_numpy(mask)
    want = jfm.fused_poisson_multi(
        jg, seed, jnp.asarray(x), B, n_valid=n_valid, backend="scan",
        valid_mask=None if mask is None else jnp.asarray(mask))
    got = tfm.fused_poisson_multi(tg, seed, torch.from_numpy(x), B,
                                  n_valid=n_valid, valid_mask=tmask)
    w = _explicit_weights(seed, B, n, n_valid, mask)
    _assert_moments((got[0].w, got[0].s1, got[0].s2),
                    (want[0].w, want[0].s1, want[0].s2), x, w)
    np.testing.assert_array_equal(np.asarray(want[1].counts),
                                  got[1].counts.numpy())
    np.testing.assert_array_equal(np.asarray(want[1].lo), got[1].lo.numpy())
    # members against the port's dedicated runs, bitwise
    xt = torch.from_numpy(x)
    ded = tws.fused_poisson_moments(seed, xt, B, n_valid=n_valid,
                                    valid_mask=tmask)
    for a, b in zip((got[0].w, got[0].s1, got[0].s2), ded):
        assert torch.equal(a, b)
    hist = twh.fused_poisson_hist(seed, xt, LO, HI, NBINS, B,
                                  n_valid=n_valid, valid_mask=tmask)
    assert torch.equal(got[1].counts, hist)


def test_prefix_mask_equals_n_valid_bitwise():
    seed, x, _, _ = _case(100, 1000, 1, "none")
    mask = np.zeros(1000, np.float32)
    mask[:700] = 1.0
    xt = torch.from_numpy(x)
    a = tws.fused_poisson_moments(seed, xt, 100, n_valid=700)
    b = tws.fused_poisson_moments(seed, xt, 100,
                                  valid_mask=torch.from_numpy(mask))
    for u, v in zip(a, b):
        assert torch.equal(u, v)


class _JRms(jra.Statistic):
    """A user statistic without a fused path (JAX package)."""

    def init_state(self, dim):
        z = jnp.zeros((dim,), jnp.float32)
        return jra.MomentState(w=jnp.zeros((), jnp.float32), s1=z, s2=z)

    def update(self, state, values, weights=None):
        x = jra._as_2d(values).astype(jnp.float32)
        w = jra._w(x, weights)
        return jra.MomentState(w=state.w + jnp.sum(w), s1=state.s1,
                               s2=state.s2 + w @ (x * x))


class _TRms(tra.Statistic):
    """The same user statistic in the port."""

    def init_state(self, dim, device="cpu"):
        z = torch.zeros(dim, device=device)
        return tra.MomentState(w=torch.zeros((), device=device), s1=z, s2=z)

    def update(self, state, values, weights=None):
        x = tra._as_2d(values).to(torch.float32)
        w = tra._w(x, weights)
        return tra.MomentState(w=state.w + w.sum(), s1=state.s1,
                               s2=state.s2 + w @ (x * x))


def test_materialized_fallback_matches_jax():
    """A statistic without a fused path gets the same implicit weights
    materialized (the poisson_counts kernel on a card)."""
    seed, x, _, mask = _case(8, 300, 1, "holes")
    want = j_fused_states(_JRms(), seed, jnp.asarray(x), 8, n_valid=290,
                          valid_mask=mask)
    got = t_fused_states(_TRms(), seed, torch.from_numpy(x), 8, n_valid=290,
                         valid_mask=torch.from_numpy(mask))
    w = _explicit_weights(seed, 8, 300, 290, mask)
    np.testing.assert_array_equal(np.asarray(want.w), got.w.numpy())
    xd = np.asarray(x, np.float64)
    assert np.all(np.abs(got.s2.numpy() - np.asarray(want.s2))
                  <= 1e-5 * (w @ (xd * xd)))


def test_unported_options_raise():
    x = torch.zeros(10, 1)
    with pytest.raises(NotImplementedError):
        twh.fused_poisson_hist(1, x, 0.0, 1.0, 8, 4, block_bins=128)
    with pytest.raises(NotImplementedError):
        tws.fused_poisson_moments(1, x, 4, stream=True)
    with pytest.raises(TypeError):
        tws.fused_poisson_moments(1, np.zeros((10, 1), np.float32), 4)
