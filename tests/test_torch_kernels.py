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
    """``block_bins`` (kernel 7) and ``stream=True`` (kernel 5) are ported:
    on the CPU both run the plain version and equal the calls without the
    knob.  A non-tensor argument still raises TypeError."""
    seed, x, n_valid, mask = _case(8, 300, 2, "holes")
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    np.testing.assert_array_equal(
        twh.fused_poisson_hist(seed, xt, LO, HI, NBINS, 8, valid_mask=mt,
                               block_bins=128).numpy(),
        twh.fused_poisson_hist(seed, xt, LO, HI, NBINS, 8,
                               valid_mask=mt).numpy())
    for a, b in zip(tws.fused_poisson_moments(seed, xt, 8, valid_mask=mt,
                                              stream=True),
                    tws.fused_poisson_moments(seed, xt, 8, valid_mask=mt)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(TypeError):
        tws.fused_poisson_moments(1, np.zeros((10, 1), np.float32), 4)


@pytest.mark.parametrize("block_bins", [1, 16, 128, 1 << 20])
@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("B,n,d", [(8, 300, 2), (130, 700, 3)])
def test_fused_hist_block_bins_matches_jax_bitwise(B, n, d, mask_kind,
                                                   block_bins):
    """Kernel 7's entry point: ``block_bins`` changes no count."""
    seed, x, n_valid, mask = _case(B, n, d, mask_kind, special=True)
    want = jwh.fused_poisson_hist(seed, x, LO, HI, NBINS, B, backend="scan",
                                  n_valid=n_valid, valid_mask=mask,
                                  block_bins=block_bins)
    got = twh.fused_poisson_hist(
        seed, torch.from_numpy(x), LO, HI, NBINS, B, n_valid=n_valid,
        valid_mask=None if mask is None else torch.from_numpy(mask),
        block_bins=block_bins)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("B,n,d", SHAPES)
def test_fused_moments_stream_matches_jax(B, n, d, mask_kind):
    """Kernel 5's entry point: ``stream=True`` is bitwise the default and
    within the dot-error bound of the JAX package's scan lowering."""
    seed, x, n_valid, mask = _case(B, n, d, mask_kind)
    m = None if mask is None else torch.from_numpy(mask)
    got = tws.fused_poisson_moments(seed, torch.from_numpy(x), B,
                                    n_valid=n_valid, valid_mask=m,
                                    stream=True)
    for a, b in zip(got, tws.fused_poisson_moments(
            seed, torch.from_numpy(x), B, n_valid=n_valid, valid_mask=m)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = jws.fused_poisson_moments(seed, x, B, backend="scan",
                                     n_valid=n_valid, valid_mask=mask,
                                     stream=True)
    _assert_moments(got, want, x, _explicit_weights(seed, B, n, n_valid,
                                                    mask))


@pytest.mark.parametrize("Bp,np_,total,block_bins", [
    # the streamed Quantile's chunk: B = 256, n = 65,536, d = 64
    (256, 65536, 64 * 2048, 2048), (256, (1 << 20) + 475, 2048, 128),
    (8, 512, 8 * 4 * 2048, 1 << 20), (16, 128, 7, 3),
    # n = 2^20 + 475 at d = 64 (several column ranges), keyed G = 8, d = 4,
    # and B = 100 (a row block past the last whole 8)
    (256, 2049 * 512, 64 * 2048, 2048), (256, 65536 + 512, 8 * 4 * 2048,
                                         2048),
    (100, 1024, 4 * 2048, 512)])
def test_binblocked_geometry(Bp, np_, total, block_bins):
    """Kernel 7's geometry: each (row, column) weight is drawn by exactly
    one CTA of one range; every window of every row block is walked once
    per range, by one CTA of its cluster; a CTA's bins, weight cache and
    keys fit in an SM's shared memory; a cluster has at most 8 CTAs."""
    from repro_torch.kernels._pass import (BINBLOCKED_ROWS,
                                           BINBLOCKED_STATIC_SMEM,
                                           MAX_CLUSTER, SMEM_BYTES,
                                           binblocked_geometry)
    bn = 512 if np_ >= 512 else np_
    nt = np_ // bn
    geo = binblocked_geometry(Bp, np_, bn, total, block_bins)
    assert 1 <= geo.width <= min(block_bins, total)
    assert 1 <= geo.rows <= BINBLOCKED_ROWS
    assert geo.cluster in (1, 2, 4, 8) and geo.cluster <= MAX_CLUSTER <= 8
    assert geo.windows == -(-total // geo.width)
    assert geo.smem_bytes(bn) + BINBLOCKED_STATIC_SMEM <= SMEM_BYTES
    # columns: the CTAs of all clusters cover every n-tile exactly once
    drawn = np.zeros(nt, np.int64)
    for i in range(geo.ranges):
        for rank in range(geo.cluster):
            t0, t1 = geo.tiles(i, rank, nt)
            assert 0 <= t0 <= t1 <= nt and t1 - t0 <= geo.tiles_per_cta
            drawn[t0:t1] += 1
    assert (drawn == 1).all()
    # rows: the row blocks cover every row exactly once (grid y)
    rowblocks = -(-Bp // geo.rows)
    assert (rowblocks - 1) * geo.rows < Bp <= rowblocks * geo.rows
    # windows: the ranks of a cluster walk every window once
    walked = np.zeros(geo.windows, np.int64)
    for rank in range(geo.cluster):
        walked[list(geo.windows_of(rank))] += 1
    assert (walked == 1).all()
    if (Bp, np_, total) == (256, 65536, 64 * 2048):
        # the table's shape: one range of 64 row blocks x 2 CTAs, so each
        # weight is hashed once where the earlier design hashed it 64 times
        assert (geo.ranges, geo.cluster, rowblocks) == (1, 2, 64)


def test_poisson_weight_fits_the_byte_cache():
    """Kernel 7 caches a weight in one byte: the count of Poisson(1) rungs
    below u is at most 10, which a byte (and a nibble) holds."""
    assert len(POISSON_CDF_F32) == 10
    assert len(POISSON_CDF_F32) <= 15 < 255
    w = tws.implicit_weights(12345, 64, 4096, device="cpu")
    assert float(w.max()) <= len(POISSON_CDF_F32)
    assert bool((w == w.round()).all())


@pytest.mark.parametrize("n", [4096, 4097, 4098, 4099, (1 << 20) + 37])
@pytest.mark.parametrize("R", [1, 7, 256])
def test_weighted_hist_aligned_split(n, R):
    """Kernel 10 reads each row of W as a scalar head, 16-byte groups split
    over the ranges, and a scalar tail: every column of every row is read
    exactly once, whatever the row's offset from a 16-byte boundary (rows
    start r·n floats apart; the base itself may be any float off)."""
    geo = twh.hist_geometry(R, n, 1, 2048, unit=False)
    assert geo.ranges * geo.groups >= n // 4
    for base in range(4):
        for r in range(min(R, 9)):
            head, groups = twh.aligned_split(n, (base + r * n) % 4)
            seen = np.zeros(n, np.int64)
            seen[:head] += 1                          # first range
            for i in range(geo.ranges):
                lo = i * geo.groups
                hi = min(lo + geo.groups, n // 4, groups)
                for g in range(lo, max(lo, hi)):
                    seen[head + 4 * g:head + 4 * g + 4] += 1
            seen[head + 4 * groups:] += 1             # last range
            assert (seen == 1).all(), (base, r)


@pytest.mark.parametrize("R,n,d,nbins,unit", [
    (256, (1 << 20) + 37, 1, 2048, False), (1, (1 << 24) - 1000, 1, 2048,
                                            True),
    (256, 5000, 4, 2048, False), (1, 5000, 4, 256, True),
    (8, 1000, 3, 30000, False)])
def test_weighted_hist_geometry_fits(R, n, d, nbins, unit):
    """Kernel 10's shared memory (the bins of its rows, u32 and f32 where
    both fit, and the threads' bin slots, or the unit path's private
    histograms) within an SM's."""
    from repro_torch.kernels._pass import MAX_ROWS, SMEM_BYTES
    geo = twh.hist_geometry(R, n, d, nbins, unit)
    if unit:
        assert geo.rows == 1 and 1 <= geo.copies <= twh.HIST_COPIES
        assert 4 * geo.copies * geo.dc * nbins <= SMEM_BYTES
        assert geo.ranges * geo.groups >= n * d // 4
    else:
        assert 1 <= geo.rows <= min(MAX_ROWS, R)
        sets = 2 if geo.whole_bins else 1
        assert (4 * sets * geo.rows * geo.dc * nbins
                + twh.HIST_SLOT_BYTES) <= SMEM_BYTES
        assert geo.ranges * geo.groups >= n // 4
    assert geo.groups % twh.HIST_THREADS == 0
    assert (geo.ranges - 1) * geo.groups < max(1, (n * d if unit else n) // 4)


def test_whole_counts_fit_u32_and_f32():
    """Kernels 3, 4 and the keyed histogram add whole counts into u32
    bins and flush them as f32: a CTA covers at most MAX_TILES_PER_CTA
    RNG tiles of BLOCK_N columns and a weight is at most the number of
    CDF rungs, so a bin stays below 2^24, where u32 and f32 are exact."""
    from repro_torch.kernels._pass import MAX_TILES_PER_CTA
    from repro_torch.kernels.poisson_counts.ref import BLOCK_N
    assert MAX_TILES_PER_CTA * BLOCK_N * len(POISSON_CDF_F32) < 2 ** 24


@pytest.mark.parametrize("B,n", [(8, 300), (256, (1 << 20) + 37),
                                 (256, (1 << 24) - 1000), (1000, 70_000)])
@pytest.mark.parametrize("n_hist,d,nbins", [(1, 1, 2048), (2, 1, 2048),
                                            (1, 4, 2048), (3, 8, 64),
                                            (1, 1, 14_000)])
def test_pass_hist_geometry_fits(B, n, n_hist, d, nbins):
    """Kernels 3 and 4: the tile keys, the slot table (nbins, offset, lo,
    hi, read once a CTA) and the rows' u32 bins fit in an SM's shared
    memory, with as many rows (up to 8) as fit; the moments ranges are
    pass_geometry's whatever the rows."""
    from repro_torch.kernels._pass import (MAX_ROWS, SMEM_BYTES, STATIC_SMEM,
                                           pass_geometry, pass_hist_rows,
                                           pass_smem_bytes)
    bb, bn = weight_tile_blocks(B, n)
    Bp, np_ = B + (-B) % bb, n + (-n) % bn
    tpc, ranges = pass_geometry(Bp, np_, bn)
    total = n_hist * d * nbins
    rows = pass_hist_rows(tpc, n_hist, d, total)
    assert 1 <= rows <= MAX_ROWS
    assert pass_smem_bytes(tpc, n_hist, d, rows, total) + STATIC_SMEM \
        <= SMEM_BYTES
    if rows < MAX_ROWS:
        assert pass_smem_bytes(tpc, n_hist, d, rows + 1, total) \
            + STATIC_SMEM > SMEM_BYTES
    if (B, n, n_hist, d, nbins) == (256, (1 << 20) + 37, 1, 1, 2048):
        # the table's shape: 8 rows, 64 KB of bins, 33 ranges x 32 blocks
        assert (rows, tpc, ranges) == (8, 63, 33)
        assert pass_smem_bytes(tpc, 1, 1, rows, total) == 1024 + 65536


def _keyed_row_limit(Bp, np_, bn):
    """The most bins one key's row (d·nbins) may hold in the keyed
    histogram: a row of them beside the tile keys."""
    from repro_torch.kernels._pass import (SMEM_BYTES, STATIC_SMEM,
                                           pass_geometry)
    tpc, _ = pass_geometry(Bp, np_, bn)
    return (SMEM_BYTES - STATIC_SMEM - 16 * tpc) // 4


@pytest.mark.parametrize("Bp,np_,G,d,nbins", [
    (256, 2049 * 512, 8, 1, 2048), (256, 2049 * 512, 8, 4, 256),
    (256, 2049 * 512, 32, 4, 2048), (16, 4 * 512, 6, 1, 512),
    (128, 300, 1, 1, 64), (8, 129, 33, 3, 7), (256, 65536 + 512, 8, 4, 2048),
    (1024, 16 * 512, 3000, 1, 1), (200, 20 * 512, 5, 2, 14_000)])
def test_keyed_hist_geometry(Bp, np_, G, d, nbins):
    """The keyed histogram's geometry: every key falls in exactly one key
    chunk; every (row, column) weight is drawn by exactly one CTA (the
    one of its column's range, its row's block and its key's chunk);
    shared memory fits; the index entry's fields (column 10 bits, tile 10,
    key 11) hold every value."""
    from repro_torch.kernels._pass import (KEYED_MAX_KG, MAX_ROWS,
                                           MAX_TILES_PER_CTA, SMEM_BYTES,
                                           STATIC_SMEM, keyed_hist_geometry)
    bn = min(512, np_)
    nt = np_ // bn
    geo = keyed_hist_geometry(Bp, np_, bn, G, d, nbins)
    assert 1 <= geo.rows <= MAX_ROWS and 1 <= geo.kg <= KEYED_MAX_KG
    assert geo.smem_bytes(d, nbins) + STATIC_SMEM <= SMEM_BYTES
    assert bn < 1 << 10 and geo.tiles_per_cta <= MAX_TILES_PER_CTA <= 1 << 10
    assert KEYED_MAX_KG <= 1 << 11
    # keys: the chunks partition [0, G)
    seen = np.zeros(G, np.int64)
    for ch in range(geo.chunks):
        keys = geo.keys_of(ch, G)
        assert 1 <= len(keys) <= geo.kg
        seen[list(keys)] += 1
    assert (seen == 1).all()
    # weights: a CTA (range i, row block, chunk) draws rows of its block on
    # the columns of its range whose key its chunk holds
    rowblocks = -(-Bp // geo.rows)
    tiles = np.zeros(nt, np.int64)
    for i in range(geo.ranges):
        t0 = i * geo.tiles_per_cta
        t1 = min(t0 + geo.tiles_per_cta, nt)
        assert t0 < t1
        tiles[t0:t1] += 1
    rows = np.zeros(Bp, np.int64)
    for b in range(rowblocks):
        rows[b * geo.rows:min(Bp, (b + 1) * geo.rows)] += 1
    assert (tiles == 1).all() and (rows == 1).all()
    # one CTA a (row, column, key): the product of the three partitions
    assert geo.ranges * rowblocks * geo.chunks == (
        len(set(range(geo.ranges))) * rowblocks * geo.chunks)
    if (Bp, np_, G, d, nbins) == (256, 2049 * 512, 8, 1, 2048):
        # the table's shape: one key a chunk, 8 rows, 64 KB of bins
        assert (geo.rows, geo.kg, geo.chunks, geo.ranges) == (8, 1, 8, 33)
        assert geo.smem_bytes(d, nbins) == 63 * 16 + 65536


@pytest.mark.parametrize("G", [1, 8, 500])
def test_keyed_hist_raises_exactly_past_its_limit(G):
    """The keyed histogram keeps one key's d·nbins bins a row: it runs up
    to the last row that fits in an SM, whatever G, and raises one bin
    past it, naming block_bins (the output-tiled kernel 7's knob)."""
    from repro_torch.kernels._pass import keyed_hist_geometry
    Bp, np_, bn = 256, 2049 * 512, 512
    limit = _keyed_row_limit(Bp, np_, bn)
    assert 57_000 < limit < 58_000
    geo = keyed_hist_geometry(Bp, np_, bn, G, 1, limit)
    assert (geo.rows, geo.kg) == (1, 1)
    with pytest.raises(NotImplementedError, match="block_bins"):
        keyed_hist_geometry(Bp, np_, bn, G, 1, limit + 1)
    with pytest.raises(NotImplementedError, match="block_bins"):
        keyed_hist_geometry(Bp, np_, bn, G, 4, limit // 4 + 1)
    keyed_hist_geometry(Bp, np_, bn, G, 4, limit // 4)


def _emulate_keyed_hist(pr, seed, lo, hi, nbins):
    """numpy emulation of the keyed histogram (csrc/fused_grouped.cu) in
    its scratch layout: the index pass sorts each range's columns that
    carry a weight by key chunk into packed entries (column in its tile,
    tile in the range, key in the chunk; a shuffle stands for the
    scatter's atomics, as the order within a chunk is free), records each
    segment's end and flags a mask value other than 0/1; each histogram
    CTA of keyed_hist_geometry unpacks its chunk's segment, adds each
    nonzero weight of its rows into u32 bins (f32 when its range is
    flagged) and flushes them into the output.  Returns the counts and
    how many times each (row, column) weight was drawn."""
    from repro_torch.kernels._pass import keyed_hist_geometry
    from repro_torch.kernels.poisson_counts.ref import weight_block
    from repro_torch.kernels.weighted_hist.ref import _bin_indices
    Bp, np_, bn, G, d = pr.Bp, pr.np_, pr.bn, pr.G, pr.d
    geo = keyed_hist_geometry(Bp, np_, bn, G, d, nbins)
    kg, nt = geo.kg, np_ // bn
    W = weight_block(seed, pr.n_valid, Bp, pr.bb, bn, 0, nt,
                     valid=pr.mp).numpy()
    x = pr.xp.numpy()
    bins_of = _bin_indices(pr.xp, lo[None, :], hi[None, :], nbins).numpy()
    keys = pr.gp.numpy()
    mask = None if pr.mp is None else pr.mp.numpy()
    rng = np.random.default_rng(7)
    index = np.full(geo.index_ints(np_), -1, np.int64)
    entries = index[:np_]
    ends = index[np_:np_ + geo.ranges * geo.chunks].reshape(geo.ranges,
                                                           geo.chunks)
    frac = index[np_ + geo.ranges * geo.chunks:]
    assert len(frac) == geo.ranges
    tiles = [(i * geo.tiles_per_cta,
              min((i + 1) * geo.tiles_per_cta, nt)) for i in range(geo.ranges)]
    for i, (t0, t1) in enumerate(tiles):      # keyed_index_kernel
        js = np.arange(t0 * bn, t1 * bn)
        ok = js < pr.n_valid
        if mask is not None:
            ok &= mask[js] != 0
        kf = keys[js]
        g = kf.astype(np.int64)
        ok &= (kf >= 0) & (kf < G) & (g == kf)
        ch = g // kg
        rel = js - t0 * bn
        entry = rel % bn | (rel // bn) << 10 | (g - ch * kg) << 20
        sel = np.flatnonzero(ok)
        sel = sel[rng.permutation(len(sel))]
        sel = sel[np.argsort(ch[sel], kind="stable")]
        entries[t0 * bn:t0 * bn + len(sel)] = entry[sel]
        ends[i] = t0 * bn + np.cumsum(np.bincount(ch[sel],
                                                  minlength=geo.chunks))
        m = mask[js[js < pr.n_valid]] if mask is not None else np.zeros(0)
        frac[i] = int(bool(((m != 0) & (m != 1)).any()))
    slot = d * nbins
    out = np.zeros((Bp, G * slot), np.float32)
    drawn = np.zeros((Bp, np_), np.int64)
    for i, (t0, t1) in enumerate(tiles):      # grouped_hist_kernel
        for r0 in range(0, Bp, geo.rows):
            nrows = min(geo.rows, Bp - r0)
            for ch in range(geo.chunks):
                g0 = ch * kg
                kgv = min(kg, G - g0)
                e0 = t0 * bn if ch == 0 else ends[i, ch - 1]
                e = entries[e0:ends[i, ch]]
                assert (e >= 0).all()
                c, tt, k = e & 1023, (e >> 10) & 1023, e >> 20
                assert (c < bn).all() and (tt < t1 - t0).all()
                assert (k < kgv).all()
                j = (t0 + tt) * bn + c
                assert (keys[j] == g0 + k).all()
                drawn[r0:r0 + nrows, j] += 1
                exact = frac[i] == 0
                bins = np.zeros((nrows, kg * slot),
                                np.uint32 if exact else np.float32)
                w = W[r0:r0 + nrows][:, j]
                for dd in range(d):
                    fin = ~np.isnan(x[j, dd])
                    idx = (k * d + dd) * nbins + bins_of[j, dd]
                    for r in range(nrows):
                        nz = fin & (w[r] != 0)
                        add = w[r, nz].astype(np.uint32 if exact
                                              else np.float32)
                        np.add.at(bins[r], idx[nz], add)
                flat = bins[:, :kgv * slot].astype(np.float32)
                out[r0:r0 + nrows, g0 * slot:(g0 + kgv) * slot] += flat
    return out.reshape(Bp, G, d, nbins), drawn


@pytest.mark.parametrize("G,d,nbins", [(5, 1, 2048), (6, 1, 512),
                                       (4, 2, 64)])
def test_keyed_hist_emulation_matches_plain_bitwise(G, d, nbins):
    """The keyed kernel's index and its indexing, emulated in numpy, give
    grouped_hist_plain's counts bitwise: keys skewed 2^-g with key 2
    absent and a key outside [0, G), NaN and inf among the values, and a
    mask of 0, 1 and 0.5 (a CTA whose columns hold 0.5 adds f32; halves
    sum exactly) beside one of 0 and 1 only (u32).  Every (row, column)
    weight with a key in [0, G), inside n_valid and not masked to 0 is
    drawn exactly once; the rest are never drawn."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(G * 100 + d)
    B, n, n_valid = 16, 1900, 1800
    p = 2.0 ** -np.arange(G)
    p[2] = 0.0
    keys = rng.choice(G, size=n, p=p / p.sum()).astype(np.float32)
    keys[7] = G + 0.5
    x = rng.normal(0.0, 1.0, size=(n, d)).astype(np.float32)
    x[3, 0], x[4, 0] = np.nan, np.inf
    lo, hi = torch.full((d,), -2.0), torch.full((d,), 2.0)
    mask = rng.choice(np.array([0.0, 1.0], np.float32), size=n)
    # 0.5 in the first range's columns only: its CTAs add f32, the rest u32
    mask[rng.integers(0, 400, size=20)] = 0.5
    for m in (None, mask):
        pr = tws.prepare(torch.from_numpy(x), B, n_valid=n_valid,
                         valid_mask=None if m is None else torch.from_numpy(m),
                         group_ids=torch.from_numpy(keys), num_groups=G)
        got, drawn = _emulate_keyed_hist(pr, 99, lo, hi, nbins)
        want = twh.grouped_hist_plain(pr, 99, lo, hi, nbins)
        np.testing.assert_array_equal(got, want.numpy())
        kp = pr.gp.numpy()
        ok = (np.arange(pr.np_) < n_valid) & (kp == np.floor(kp)) & \
            (kp >= 0) & (kp < G)
        if m is not None:
            ok &= pr.mp.numpy() != 0
        np.testing.assert_array_equal(drawn, np.broadcast_to(
            ok.astype(np.int64), drawn.shape))
        assert want.numpy()[:, 2].sum() == 0.0


@pytest.mark.parametrize("kind", ["grouped", "kmeans"])
@pytest.mark.parametrize("Bp,np_,keys,d", [
    (256, 2049 * 512, 8, 1), (256, 2049 * 512, 1, 1),
    (256, 2049 * 512, 32, 1), (256, 2049 * 512, 16, 4),
    (256, 8192 * 512, 5, 2), (24, 16 * 512, 5, 2), (256, 2049 * 512, 16, 8),
    (8, 129, 3, 3), (128, 300, 200, 1), (1024, 16 * 512, 3000, 9)])
def test_slot_geometry(kind, Bp, np_, keys, d):
    """The slot kernels' geometry (kernel 6, keys = G; kernel 8, keys =
    k clusters): the key chunks partition the keys and the column chunks
    the d columns, so each (row, column) weight is drawn by exactly one
    CTA of each column chunk (the one of its row's block, its column's
    range and its key's chunk); a row's slots stay within SLOT_FLOATS;
    the rows are the most (a power of two up to 8) that leave room for
    SLOT_CTAS CTAs an SM, or one; the CTA's shared memory fits an SM."""
    from repro_torch.kernels._pass import (MAX_ROWS, SLOT_CTAS, SLOT_FLOATS,
                                           SM_SMEM_BYTES, SMEM_BYTES,
                                           STATIC_SMEM, grouped_geometry,
                                           kmeans_geometry)
    bn = min(512, np_)
    nt = np_ // bn
    geometry = grouped_geometry if kind == "grouped" else kmeans_geometry
    geo = geometry(Bp, np_, bn, keys, d)
    dc = 1 if d <= 1 else 2 if d <= 2 else 4
    assert geo.dc == dc
    # kernel 6: w, s1 and s2 of DC columns a key; kernel 8: DC sums and
    # the count a cluster, and the row's inertia
    assert (geo.per_key, geo.per_row) == ((2 * dc + 1, 0) if kind ==
                                          "grouped" else (dc + 1, 1))
    assert geo.row_slots == geo.kc * geo.per_key + geo.per_row
    assert geo.rows in (1, 2, 4, 8) and geo.rows <= MAX_ROWS
    assert geo.row_slots <= SLOT_FLOATS
    per_sm = SM_SMEM_BYTES // SLOT_CTAS
    slots = 4 * 256 * geo.row_slots
    assert geo.rows == 1 or geo.smem_bytes() + 1024 <= per_sm
    assert geo.rows == MAX_ROWS or geo.smem_bytes() + geo.rows * slots + \
        1024 > per_sm
    assert geo.smem_bytes() == (16 * geo.tiles_per_cta
                                + 4 * 256 * geo.rows * geo.row_slots)
    assert geo.smem_bytes() + STATIC_SMEM <= SMEM_BYTES
    key_chunks = -(-keys // geo.kc)
    assert geo.key_chunks == key_chunks
    assert geo.chunks == key_chunks * -(-d // dc)
    seen = np.zeros(keys, np.int64)
    for ch in range(key_chunks):
        ks = geo.keys_of(ch, keys)
        assert 1 <= len(ks) <= geo.kc
        seen[list(ks)] += 1
    assert (seen == 1).all()
    cols = np.zeros(d, np.int64)
    for z in range(-(-d // dc)):
        cols[z * dc:min(d, (z + 1) * dc)] += 1
    assert (cols == 1).all()
    tiles = np.zeros(nt, np.int64)
    for i in range(geo.ranges):
        t0 = i * geo.tiles_per_cta
        t1 = min(t0 + geo.tiles_per_cta, nt)
        assert t0 < t1
        tiles[t0:t1] += 1
    rows = np.zeros(Bp, np.int64)
    for b in range(-(-Bp // geo.rows)):
        rows[b * geo.rows:min(Bp, (b + 1) * geo.rows)] += 1
    assert (tiles == 1).all() and (rows == 1).all()
    if (Bp, np_, keys, d) == (256, 2049 * 512, 8, 1) and kind == "grouped":
        # the kernel table's shape: 2 rows of 8 keys, 48 KB of slots
        assert (geo.rows, geo.kc, geo.chunks, geo.ranges) == (2, 8, 1, 33)
    if (Bp, np_, keys, d) == (256, 8192 * 512, 5, 2) and kind == "kmeans":
        # the k-means bootstrap: 4 rows of 5 clusters and an inertia
        assert (geo.rows, geo.kc, geo.chunks, geo.row_slots) == (4, 5, 1, 16)


def test_slot_geometry_raises_exactly_past_an_sm(monkeypatch):
    """The slot pass raises once its tile keys and slots pass an SM's
    shared memory, and not one slot before."""
    from repro_torch.kernels import _pass
    Bp, np_, bn = 256, 2049 * 512, 512
    tpc, _ = _pass.pass_geometry(Bp, np_, bn)
    room = (_pass.SMEM_BYTES - _pass.STATIC_SMEM - 16 * tpc) // (4 * 256)
    monkeypatch.setattr(_pass, "SLOT_FLOATS", room + 1)
    geo = _pass.slot_geometry(Bp, np_, bn, room, 1, 1)
    assert (geo.rows, geo.kc) == (1, room)
    assert geo.smem_bytes() + _pass.STATIC_SMEM <= _pass.SMEM_BYTES
    with pytest.raises(NotImplementedError, match="shared memory"):
        _pass.slot_geometry(Bp, np_, bn, room + 1, 1, 1)


def test_probe_knockouts_match_the_slot_sources(monkeypatch):
    """probe_slots.py's edits of the slot design each match its source
    once, and each of its variants is a knock-out or a knob of a module
    attribute that exists, so a probe run on the card neither fails on a
    stale edit nor times an unchanged kernel under another name."""
    import importlib
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    probe = importlib.import_module("probe_slots")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    assert (csrc / "slot_tile.cuh").exists()
    for variant, edits in probe.KNOCKOUTS["slots"].items():
        for fname, old, _ in edits:
            assert (csrc / fname).read_text().count(old) == 1, (variant,
                                                                 fname)
    knobs = probe.KNOBS["slots"]
    for variants in probe.VARIANTS["slots"].values():
        for v in variants:
            assert v == "base" or v in probe.KNOCKOUTS["slots"] or v in knobs
    for module, attr, _ in knobs.values():
        assert hasattr(importlib.import_module(module), attr), attr


def test_probe_kernel9_variants_match_its_source(monkeypatch):
    """probe_slots.py --kernel9's edits of csrc/kmeans_assign.cu each match
    the source once, and every variant it times is a knock-out, a knob of
    a module attribute that exists, or the base."""
    import importlib
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    probe = importlib.import_module("probe_slots")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    for variant, edits in probe.K9_KNOCKOUTS.items():
        for fname, old, _ in edits:
            assert (csrc / fname).read_text().count(old) == 1, (variant,
                                                                 fname)
    for v in probe.K9_VARIANTS:
        assert (v == "base" or v in probe.K9_KNOCKOUTS
                or v in probe.K9_KNOBS), v
    for module, attr, _ in probe.K9_KNOBS.values():
        assert hasattr(importlib.import_module(module), attr), attr


def test_probe_attention_variant_matches_its_source(monkeypatch):
    """probe_slots.py --attention's edit of csrc/flash_attention.cu (the
    other K/V tiling past head dim 128) matches the source once."""
    import importlib
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    probe = importlib.import_module("probe_slots")
    csrc = root / "src" / "repro_torch" / "kernels" / "csrc"
    for variant, edits in probe.K12_KNOCKOUTS.items():
        for fname, old, new in edits:
            assert (csrc / fname).read_text().count(old) == 1, variant
            assert old != new
