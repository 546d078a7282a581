"""The port's GROUP BY path against the JAX package on the CPU.

Inputs are made with numpy from a seed and go through both packages; the
JAX package runs its ``backend="scan"`` lowering (its Pallas-interpret
lowering disagrees with scan in the last bits of f32 dots on this jax).
Tolerances: implicit weights, w_tot, histogram and k-means counts are
bitwise; s1, s2 and k-means sums within 1e-5·Σw|x| per entry (Σw·x² for
s2), k-means inertia within 1e-5 of itself.  The port's own contract, slot
g ≡ the dedicated run masked to key g, is bitwise.  Keyed sessions must
take the same B, rows, iterations, worst key and per-key fractions as the
JAX session, with per-key results within f32 rounding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import EarlSession as JSession
from repro.core import GroupedStatistic as JGrouped
from repro.core import KMeansStep as JKMeans
from repro.core import Mean as JMean
from repro.core import MomentState as JMomentState
from repro.core import Quantile as JQuantile
from repro.core import Statistic as JStatistic
from repro.core import StatisticGroup as JGroup
from repro.core import Sum as JSum
from repro.core import bootstrap as j_bootstrap
from repro.core.accuracy import report_for as j_report_for
from repro.core.delta import poisson_delta_extend as j_extend
from repro.core.delta import poisson_delta_init as j_init
from repro.core.delta import poisson_delta_result as j_result
from repro.core.ssabe import ssabe as j_ssabe
from repro.data import StratifiedSampler as JStratified
from repro.data.store import ShardedStore as JStore
from repro.kernels.fused_multi import ops as jfm
from repro.kernels.kmeans_assign import ops as jka
from repro.kernels.weighted_hist import ops as jwh
from repro.kernels.weighted_stats import ops as jws
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.core import (AccuracyReport, Count, EarlSession,
                              GroupedStatistic, KeyedAccuracyReport,
                              KMeansStep, Mean, MomentState, Quantile,
                              Statistic, StatisticGroup, Sum, Var,
                              bootstrap, fused_resample_states,
                              poisson_delta_extend, poisson_delta_init,
                              poisson_delta_result, report_for)
from repro_torch.core.ssabe import _cv_of, ssabe
from repro_torch.data import ShardedStore, StratifiedSampler
from repro_torch.kernels.fused_multi.ops import (fused_poisson_multi,
                                                 fused_poisson_tiled,
                                                 slot_route)
from repro_torch.kernels.kmeans_assign import ops as tka
from repro_torch.kernels.poisson_counts.ops import poisson_counts
from repro_torch.kernels.weighted_hist import ops as twh
from repro_torch.kernels.weighted_stats import ops as tws

torch.set_num_threads(1)

N, D, G, B, SEED = 700, 2, 4, 32, 1234
NBINS, LO, HI = 64, -4.0, 4.0
# f32 sums in another order move a moment estimate by a few ulps and a cv
# by a few parts in 1e5.
EST_RTOL, CV_RTOL = 1e-5, 1e-3


@pytest.fixture(scope="module")
def keyed():
    """(values with the key as last column, data columns, keys), numpy."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, D)).astype(np.float32)
    gid = rng.integers(0, G, size=N).astype(np.float32)
    return np.concatenate([x, gid[:, None]], axis=1), x, gid


def _masks(gid, hole):
    """The interior validity mask (or None) and the per-key masks."""
    valid = None
    if hole:
        valid = (np.random.default_rng(1).random(N) > 0.3).astype(np.float32)
    keys = [(gid == g).astype(np.float32) for g in range(G)]
    return valid, keys


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _weights(valid, n_valid):
    """The implicit (B, N) weights under n_valid and the mask, float64."""
    w = poisson_counts(SEED, B, N, device="cpu").double()
    w[:, n_valid:] = 0.0
    if valid is not None:
        w = w * torch.from_numpy(valid).double()
    return w


def _within(got, want, bound):
    got, want, bound = (torch.from_numpy(np.array(a, dtype=np.float64))
                        for a in (got, want, bound))
    assert bool(((got - want).abs() <= 1e-5 * bound + 1e-30).all())


# ---------------------------------------------------------------------------
# the three keyed plain versions against the JAX package's scan lowerings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("hole", [False, True])
def test_grouped_moments_match_jax_scan(keyed, hole):
    _, x, gid = keyed
    valid, keys = _masks(gid, hole)
    n_valid = N - 9
    want = jws.fused_poisson_moments(
        SEED, jnp.asarray(x), B, backend="scan", n_valid=n_valid,
        valid_mask=None if valid is None else jnp.asarray(valid),
        group_ids=jnp.asarray(gid), num_groups=G)
    got = tws.fused_poisson_moments(SEED, _t(x), B, n_valid=n_valid,
                                    valid_mask=_t(valid), group_ids=_t(gid),
                                    num_groups=G)
    assert got[0].shape == (B, G) and got[1].shape == (B, G, D)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    w = _weights(valid, n_valid)
    xd = torch.from_numpy(x).double()
    for g, m in enumerate(keys):
        wg = w * torch.from_numpy(m).double()
        _within(got[1][:, g], want[1][:, g], wg @ xd.abs())
        _within(got[2][:, g], want[2][:, g], wg @ (xd * xd))


@pytest.mark.parametrize("hole", [False, True])
def test_grouped_hist_matches_jax_scan(keyed, hole):
    _, x, gid = keyed
    x = x.copy()
    x[3, 0], x[5, 1], x[7, 0] = np.nan, np.inf, HI
    valid, _ = _masks(gid, hole)
    want = jwh.fused_poisson_hist(
        SEED, jnp.asarray(x), LO, HI, NBINS, B, backend="scan",
        valid_mask=None if valid is None else jnp.asarray(valid),
        group_ids=jnp.asarray(gid), num_groups=G)
    got = twh.fused_poisson_hist(SEED, _t(x), LO, HI, NBINS, B,
                                 valid_mask=_t(valid), group_ids=_t(gid),
                                 num_groups=G)
    assert got.shape == (B, G, D, NBINS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("hole", [False, True])
def test_grouped_kmeans_matches_jax_scan(keyed, hole):
    _, x, gid = keyed
    valid, keys = _masks(gid, hole)
    cent = np.random.default_rng(2).normal(size=(3, D)).astype(np.float32)
    want = jka.fused_poisson_kmeans(
        SEED, jnp.asarray(x), jnp.asarray(cent), B, backend="scan",
        valid_mask=None if valid is None else jnp.asarray(valid),
        group_ids=jnp.asarray(gid), num_groups=G)
    got = tka.fused_poisson_kmeans(SEED, _t(x), _t(cent), B,
                                   valid_mask=_t(valid), group_ids=_t(gid),
                                   num_groups=G)
    assert got[0].shape == (B, G, 3, D)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    w = _weights(valid, N)
    xd = torch.from_numpy(x).double().abs()
    for g, m in enumerate(keys):
        wg = w * torch.from_numpy(m).double()
        _within(got[0][:, g], want[0][:, g], (wg @ xd)[:, None, :])
    _within(got[2], want[2], np.abs(np.asarray(want[2])))


@pytest.mark.parametrize("kind", ["moments", "hist", "kmeans"])
@pytest.mark.parametrize("hole", [False, True])
def test_slot_is_the_masked_dedicated_run_bitwise(keyed, kind, hole):
    _, x, gid = keyed
    valid, keys = _masks(gid, hole)
    cent = _t(np.random.default_rng(2).normal(size=(3, D))
              .astype(np.float32))
    n_valid = N - 9

    def run(mask, **kw):
        xt = _t(x)
        if kind == "moments":
            return tws.fused_poisson_moments(SEED, xt, B, n_valid=n_valid,
                                             valid_mask=mask, **kw)
        if kind == "hist":
            return (twh.fused_poisson_hist(SEED, xt, LO, HI, NBINS, B,
                                           n_valid=n_valid, valid_mask=mask,
                                           **kw),)
        return tka.fused_poisson_kmeans(SEED, xt, cent, B, n_valid=n_valid,
                                        valid_mask=mask, **kw)

    grouped = run(_t(valid), group_ids=_t(gid), num_groups=G)
    for g, m in enumerate(keys):
        mask = m if valid is None else valid * m
        for a, b in zip(grouped, run(_t(mask))):
            assert torch.equal(a[:, g], b)


def test_a_key_without_rows_gets_zero_states(keyed):
    _, x, gid = keyed
    G5 = G + 1
    w_tot, s1, s2 = tws.fused_poisson_moments(SEED, _t(x), B,
                                              group_ids=_t(gid),
                                              num_groups=G5)
    assert float(w_tot[:, G].abs().sum()) == 0.0
    assert float(s1[:, G].abs().sum()) == 0.0
    counts = twh.fused_poisson_hist(SEED, _t(x), LO, HI, NBINS, B,
                                    group_ids=_t(gid), num_groups=G5)
    assert float(counts[:, G].sum()) == 0.0


def test_grouped_op_argument_checks(keyed):
    _, x, gid = keyed
    with pytest.raises(ValueError, match="num_groups"):
        tws.fused_poisson_moments(SEED, _t(x), B, group_ids=_t(gid),
                                  num_groups=0)
    with pytest.raises(ValueError, match="num_groups"):
        twh.fused_poisson_hist(SEED, _t(x), LO, HI, NBINS, B,
                               group_ids=_t(gid))
    with pytest.raises(ValueError, match="stream"):
        tws.fused_poisson_moments(SEED, _t(x), B, stream=True,
                                  group_ids=_t(gid), num_groups=G)
    # keyed block_bins (kernel 7 on the card): the same counts as the
    # JAX package's keyed scan, which ignores the knob
    got = twh.fused_poisson_hist(SEED, _t(x), LO, HI, NBINS, B,
                                 block_bins=128, group_ids=_t(gid),
                                 num_groups=G)
    want = jwh.fused_poisson_hist(SEED, x, LO, HI, NBINS, B, backend="scan",
                                  block_bins=128, group_ids=gid,
                                  num_groups=G)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


# ---------------------------------------------------------------------------
# GroupedStatistic
# ---------------------------------------------------------------------------
class _CustomInner(Statistic):
    """A statistic with no fused path: the materialized route alone, the
    tiled scan (fused_poisson_tiled) as a keyed inner or a group member."""

    def init_state(self, dim, device="cpu"):
        return MomentState(w=torch.zeros((), device=device),
                           s1=torch.zeros(dim, device=device),
                           s2=torch.zeros(dim, device=device))

    def update(self, state, values, weights=None):
        x = values.to(torch.float32)
        w = (torch.ones(x.shape[0]) if weights is None else weights)
        return MomentState(w=state.w + w.sum(), s1=state.s1 + w @ x,
                           s2=state.s2)

    def finalize(self, state):
        return state.s1 / torch.clamp_min(state.w.unsqueeze(-1), 1.0)


class _JCustomInner(JStatistic):
    """``_CustomInner`` in the JAX package."""

    def init_state(self, dim):
        return JMomentState(w=jnp.zeros((), jnp.float32),
                            s1=jnp.zeros((dim,), jnp.float32),
                            s2=jnp.zeros((dim,), jnp.float32))

    def update(self, state, values, weights=None):
        x = jnp.asarray(values, jnp.float32)
        w = jnp.ones(x.shape[0]) if weights is None else weights
        return JMomentState(w=state.w + jnp.sum(w), s1=state.s1 + w @ x,
                            s2=state.s2)

    def finalize(self, state):
        return state.s1 / jnp.maximum(state.w[..., None], 1.0)


@pytest.mark.parametrize("make,error,match", [
    (lambda: GroupedStatistic(GroupedStatistic(Mean(), 2), 3), TypeError,
     "nest"),
    (lambda: GroupedStatistic(StatisticGroup([Mean()]), 2), TypeError,
     "StatisticGroup"),
    (lambda: GroupedStatistic(lambda v: v, 2), TypeError, "Statistic"),
    (lambda: GroupedStatistic(Mean(), 2, backend="scan"), ValueError,
     "backend"),
    (lambda: GroupedStatistic(Mean(), 0), ValueError, "num_groups"),
    (lambda: GroupedStatistic(Mean(), 2)._split_key(torch.ones(5)),
     ValueError, "key"),
])
def test_construction_errors(make, error, match):
    with pytest.raises(error, match=match):
        make()


def test_update_matches_per_key_update(keyed):
    vals, x, gid = keyed
    stat = GroupedStatistic(Mean(), G)
    st = stat.update(stat.init_state(D + 1), _t(vals))
    assert st.s1.shape == (G, D)
    for g in range(G):
        ref = Mean().update(Mean().init_state(D), _t(x),
                            _t((gid == g).astype(np.float32)))
        for a, b in ((st.w[g], ref.w), (st.s1[g], ref.s1),
                     (st.s2[g], ref.s2)):
            assert torch.equal(a, b)
    merged = stat.merge(st, st)
    assert torch.equal(merged.s1, 2 * st.s1)


def _inners():
    cent = np.random.default_rng(2).normal(size=(3, D)).astype(np.float32)
    return [(Mean(), JMean()), (Sum(), JSum()), (Count(), None),
            (Var(), None),
            (Quantile(0.5, nbins=NBINS, lo=LO, hi=HI),
             JQuantile(0.5, nbins=NBINS, lo=LO, hi=HI)),
            (KMeansStep(cent), JKMeans(jnp.asarray(cent))),
            (_CustomInner(), None)]


@pytest.mark.parametrize("pair", _inners(),
                         ids=lambda p: type(p[0]).__name__)
def test_keyed_thetas_are_the_masked_inner_runs(keyed, pair):
    inner, j_inner = pair
    vals, x, gid = keyed
    stat = GroupedStatistic(inner, G)
    thetas = stat.finalize_batch(fused_resample_states(stat, SEED, _t(vals),
                                                       B))
    lead = thetas if not isinstance(thetas, tuple) else thetas[0]
    assert lead.shape[:2] == (B, G)
    for g in range(G):
        mask = _t((gid == g).astype(np.float32))
        # a custom inner's keyed run is the tiled scan, so its key-g run is
        # the tiled scan masked to key g
        states = (fused_poisson_tiled if isinstance(inner, _CustomInner)
                  else fused_resample_states)(inner, SEED, _t(x), B,
                                              valid_mask=mask)
        ref = inner.finalize_batch(states)
        assert torch.equal(thetas[:, g], ref)
    if j_inner is not None:
        from repro.core.bootstrap import fused_resample_states as j_states
        jstat = JGrouped(j_inner, G, backend="scan")
        want = jax.vmap(jstat.finalize)(j_states(jstat, SEED,
                                                 jnp.asarray(vals), B))
        np.testing.assert_allclose(thetas.numpy(), np.asarray(want),
                                   rtol=EST_RTOL, atol=1e-5)


def test_correct_per_key():
    stat = GroupedStatistic(Sum(), 3)
    est = torch.tensor([[10.0], [20.0], [30.0]])
    out = stat.correct_per_key(est, [0.5, 0.25, 1.0])
    np.testing.assert_allclose(out[:, 0].numpy(), [20.0, 80.0, 30.0])
    thetas = torch.ones(B, 3, 1)
    out = stat.correct_per_key(thetas, [0.5, 0.25, 1.0], key_axis=1)
    np.testing.assert_allclose(out[0, :, 0].numpy(), [2.0, 4.0, 1.0])
    # p_g == 0 (a stratum absent from the prefix) passes through
    out = stat.correct_per_key(torch.ones(3, 1), [0.5, 0.0, 1.0])
    np.testing.assert_allclose(out[:, 0].numpy(), [2.0, 1.0, 1.0])
    with pytest.raises(ValueError, match="p_keys"):
        stat.correct_per_key(torch.ones(3, 1), [0.5, 0.5])
    with pytest.raises(ValueError, match="key_axis"):
        stat.correct_per_key(torch.ones(3, 1), [0.5, 0.5, 1.0], key_axis=2)
    jstat = JGrouped(JSum(), 3)
    np.testing.assert_array_equal(
        stat.correct_per_key(est, [0.5, 0.0, 0.3]).numpy(),
        np.asarray(jstat.correct_per_key(jnp.asarray(est.numpy()),
                                         [0.5, 0.0, 0.3])))


def test_correct_per_key_matches_the_masked_inner(keyed):
    vals, x, gid = keyed
    stat = GroupedStatistic(Sum(), G)
    p_keys = [0.5, 0.25, 1.0, 0.8]
    thetas = stat.finalize_batch(fused_resample_states(stat, SEED, _t(vals),
                                                       B))
    corrected = stat.correct_per_key(thetas, p_keys, key_axis=1)
    for g in range(G):
        mask = _t((gid == g).astype(np.float32))
        ref = Sum().finalize_batch(fused_resample_states(
            Sum(), SEED, _t(x), B, valid_mask=mask))
        assert torch.equal(corrected[:, g], Sum().correct(ref, p_keys[g]))


def test_a_grouped_member_raises_on_the_card_path(keyed):
    """No member raises any more.  On the card a group routes each slot
    (``slot_route``): the moments slot to fused_pass, a GroupedStatistic
    to its keyed kernels, a custom member to the tiled scan, each with the
    group's seed.  On the CPU the group is the JAX package's ``"scan"``
    group: w_tot bitwise, s1 within 1e-5·Σw|x| per entry."""
    vals, x, gid = keyed
    group = StatisticGroup((Mean(), GroupedStatistic(Mean(), G),
                            _CustomInner()))
    assert [slot_route(s) for s in group.slots] == ["moments", "keyed",
                                                   "custom"]
    got = fused_poisson_multi(group, SEED, _t(vals), B)
    jgroup = JGroup((JMean(), JGrouped(JMean(), G, backend="scan"),
                     _JCustomInner()))
    want = jfm.fused_poisson_multi(jgroup, SEED, jnp.asarray(vals), B,
                                   backend="scan")
    w = np.asarray(jws.implicit_weights(SEED, B, N), np.float64)
    absx = np.abs(vals.astype(np.float64))
    keys = (gid[None, :] == np.arange(G)[:, None]).astype(np.float64)
    bounds = (w @ absx, np.einsum("bn,gn,nd->bgd", w, keys, absx[:, :-1]),
              w @ absx)
    for g_st, j_st, bound in zip(got, want, bounds):
        np.testing.assert_array_equal(g_st.w.numpy(), np.asarray(j_st.w))
        assert np.all(np.abs(g_st.s1.numpy() - np.asarray(j_st.s1))
                      <= 1e-5 * bound)


# ---------------------------------------------------------------------------
# StratifiedSampler, reports, ssabe, delta, bootstrap
# ---------------------------------------------------------------------------
def _skewed(n, g, seed=0):
    """Rows [value, key], key frequencies ∝ 2^-k, values Normal(10+k, 2)."""
    rng = np.random.default_rng(seed)
    p = 2.0 ** -np.arange(g)
    keys = rng.choice(g, size=n, p=p / p.sum())
    return np.stack([rng.normal(10.0 + keys, 2.0), keys],
                    axis=1).astype(np.float32)


@pytest.mark.parametrize("shares", [None, [4.0, 2.0, 1.0, 1.0]])
def test_stratified_sampler_is_the_reference_order(shares):
    data = _skewed(5000, G)
    want = JStratified(JStore.from_array(data, 512), G, seed=3,
                       shares=shares)
    got = StratifiedSampler(ShardedStore.from_array(data, 512), G, seed=3,
                            shares=shares, device="cpu")
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.stratum_sizes, want.stratum_sizes)
    for stop in (0, 17, 400, 5000, 9999):
        np.testing.assert_array_equal(got.stratum_counts(stop),
                                      want.stratum_counts(stop))
    np.testing.assert_array_equal(got.take(100, 300).numpy(),
                                  np.asarray(want.take(100, 300)))


def test_stratified_sampler_keys_on_the_last_column():
    rows = _skewed(3000, G)
    data = np.concatenate([rows[:, :1] * 2.0, rows], axis=1)
    want = JStratified(JStore.from_array(data, 256), G, seed=4)
    got = StratifiedSampler(ShardedStore.from_array(data, 256), G, seed=4,
                            device="cpu")
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.stratum_sizes,
                                  np.bincount(rows[:, 1].astype(int),
                                              minlength=G))


@pytest.mark.parametrize("data,match", [
    (np.ones((10, 1), np.float32), "keyed rows"),
    (np.array([[1.0, 0.5], [2.0, 1.0]], np.float32), "integers"),
    (np.array([[1.0, 0.0], [2.0, 4.0]], np.float32), r"\[0, 4\)"),
])
def test_stratified_sampler_rejects_bad_keys(data, match):
    with pytest.raises(ValueError, match=match):
        StratifiedSampler(ShardedStore.from_array(data, 8), G, device="cpu")


def test_keyed_report_matches_the_reference():
    thetas = (np.random.default_rng(5).normal(size=(16, 3, 2))
              .astype(np.float32) + 5.0)
    got = report_for(torch.from_numpy(thetas), num_groups=3,
                     p_keys=[0.5, 0.25, 1.0])
    want = j_report_for(jnp.asarray(thetas), num_groups=3,
                        p_keys=[0.5, 0.25, 1.0])
    assert isinstance(got, KeyedAccuracyReport)
    assert got.worst_key == want.worst_key
    assert got.p_keys == want.p_keys == (0.5, 0.25, 1.0)
    np.testing.assert_allclose(got.cvs, want.cvs, rtol=CV_RTOL)
    for g in range(3):
        solo = AccuracyReport.from_thetas(torch.from_numpy(thetas[:, g]))
        assert got.members[g].cv == solo.cv
        np.testing.assert_allclose(got.members[g].ci_lo.numpy(),
                                   np.asarray(want.members[g].ci_lo),
                                   rtol=1e-6)
    assert got.cv == max(got.cvs)


def test_ssabe_gates_on_the_worst_key():
    data = _skewed(4096, G, seed=1)
    thetas = torch.from_numpy(np.random.default_rng(2).normal(
        10.0, [0.1, 0.5, 0.2, 0.05], size=(64, G)).astype(np.float32))
    cvs = [_cv_of(thetas[:, g]) for g in range(G)]
    assert _cv_of(thetas, num_groups=G) == max(cvs) == cvs[1]
    want = j_ssabe(jnp.asarray(data), JGrouped(JMean(), G), 0.05, 0.01,
                   jax.random.PRNGKey(3), N=100_000, backend="fused_rng")
    got = ssabe(torch.from_numpy(data), GroupedStatistic(Mean(), G), 0.05,
                0.01, trandom.PRNGKey(3), N=100_000, backend="fused_rng",
                device="cpu")
    assert (got.B, got.n) == (want.B, want.n)
    assert [b for b, _ in got.cv_history_B] == \
        [b for b, _ in want.cv_history_B]
    np.testing.assert_allclose([c for _, c in got.cv_history_n],
                               [c for _, c in want.cv_history_n],
                               rtol=CV_RTOL)


def test_delta_result_corrects_per_key(keyed):
    vals, _, _ = keyed
    stat = GroupedStatistic(Sum(), G)
    pd = poisson_delta_init(stat, B, D + 1, trandom.PRNGKey(SEED),
                            backend="fused_rng", device="cpu")
    pd = poisson_delta_extend(pd, _t(vals))
    p_keys = [0.5, 0.25, 1.0, 0.8]
    res = poisson_delta_result(pd, p_keys=p_keys)
    assert isinstance(res.report, KeyedAccuracyReport)
    assert res.report.p_keys == tuple(p_keys)
    raw = poisson_delta_result(pd).estimate
    for g in range(G):
        np.testing.assert_allclose(res.estimate[g].numpy(),
                                   raw[g].numpy() / p_keys[g], rtol=1e-6)
    jpd = j_extend(j_init(JGrouped(JSum(), G), B, D + 1,
                          jax.random.PRNGKey(SEED), backend="fused_rng"),
                   jnp.asarray(vals))
    want = j_result(jpd, p_keys=p_keys)
    np.testing.assert_allclose(res.thetas.numpy(), np.asarray(want.thetas),
                               rtol=EST_RTOL, atol=1e-4)
    np.testing.assert_allclose(res.report.cvs, want.report.cvs,
                               rtol=CV_RTOL)
    plain = poisson_delta_init(Sum(), B, 2, trandom.PRNGKey(0),
                               backend="fused_rng", device="cpu")
    with pytest.raises(ValueError, match="keyed"):
        poisson_delta_result(poisson_delta_extend(plain, torch.ones(16, 2)),
                             p_keys=[0.5])


def test_bootstrap_gives_a_keyed_report(keyed):
    vals, _, _ = keyed
    want = j_bootstrap(jnp.asarray(vals), JGrouped(JMean(), G), B,
                       jax.random.PRNGKey(7), backend="fused_rng")
    got = bootstrap(_t(vals), GroupedStatistic(Mean(), G), B,
                    trandom.PRNGKey(7), backend="fused_rng", device="cpu")
    assert isinstance(got.report, KeyedAccuracyReport)
    assert got.thetas.shape == (B, G, D)
    assert got.report.worst_key == want.report.worst_key
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas),
                               rtol=EST_RTOL, atol=1e-6)
    np.testing.assert_allclose(got.estimate.numpy(),
                               np.asarray(want.estimate), rtol=EST_RTOL,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the keyed session end to end, and a keyed delta run carried across
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mean", "quantile"])
def test_keyed_session_matches_jax(kind):
    data = _skewed(20_000, G)
    if kind == "mean":
        jstat, tstat = JGrouped(JMean(), G), GroupedStatistic(Mean(), G)
    else:
        jstat = JGrouped(JQuantile(0.5, lo=0.0, hi=25.0), G)
        tstat = GroupedStatistic(Quantile(0.5, lo=0.0, hi=25.0), G)
    jsession = JSession(JStratified(JStore.from_array(data, 4096), G,
                                    seed=1), jstat, sigma=0.05,
                        backend="fused_rng")
    tsession = EarlSession(StratifiedSampler(
        ShardedStore.from_array(data, 4096), G, seed=1, device="cpu"),
        tstat, sigma=0.05, backend="fused_rng", device="cpu")
    want = jsession.run(jax.random.PRNGKey(0))
    got = tsession.run(trandom.PRNGKey(0))
    assert (got.B, got.n_used, got.iterations, got.fell_back) == \
        (want.B, want.n_used, want.iterations, want.fell_back)
    assert not got.fell_back and len(got.reports) == G
    assert KeyedAccuracyReport(got.reports).worst_key == \
        max(range(G), key=lambda g: want.reports[g].cv)
    np.testing.assert_array_equal(tsession._p_keys(got.n_used),
                                  jsession._p_keys(want.n_used))
    assert got.cv == max(r.cv for r in got.reports)
    assert got.history[-1]["member_cvs"] == tuple(r.cv for r in got.reports)
    np.testing.assert_allclose([r.cv for r in got.reports],
                               [r.cv for r in want.reports], rtol=CV_RTOL)
    result, wres = got.result.numpy(), np.asarray(want.result)
    if kind == "quantile":
        np.testing.assert_array_equal(result, wres)
    else:
        np.testing.assert_allclose(result, wres, rtol=EST_RTOL)


def test_keyed_session_full_job_reports_every_key():
    data = _skewed(600, G, seed=2)
    got = EarlSession(StratifiedSampler(ShardedStore.from_array(data, 128),
                                        G, seed=1, device="cpu"),
                      GroupedStatistic(Mean(), G), sigma=0.001,
                      backend="fused_rng",
                      device="cpu").run(trandom.PRNGKey(0))
    assert got.fell_back and len(got.reports) == G
    for g, r in enumerate(got.reports):
        assert r.cv == 0.0 and torch.equal(r.ci_lo, got.result[g])


def test_keyed_delta_run_continues_in_the_port():
    data = _skewed(3000, G, seed=4)
    parts = np.split(data, [700, 1900])
    jstat = JGrouped(JQuantile(0.5, lo=0.0, hi=25.0), G)
    tstat = GroupedStatistic(Quantile(0.5, lo=0.0, hi=25.0), G)
    jmean, tmean = JGrouped(JMean(), G), GroupedStatistic(Mean(), G)
    for js, ts in ((jstat, tstat), (jmean, tmean)):
        pd = j_init(js, 24, 2, jax.random.PRNGKey(4), backend="fused_rng")
        for p in parts[:2]:
            pd = j_extend(pd, jnp.asarray(p))
        numpy = jax.tree_util.tree_map(np.asarray, (pd.states, pd.est_state))
        tpd = interop.poisson_delta_from_numpy(
            ts, pd.B, numpy[0], numpy[1], np.asarray(pd.key), pd.n, pd.step,
            backend="fused_rng", device="cpu")
        pd = j_extend(pd, jnp.asarray(parts[2]))
        tpd = poisson_delta_extend(tpd, torch.from_numpy(parts[2]))
        assert (tpd.n, tpd.step) == (pd.n, pd.step)
        want = j_result(pd, p=0.5)
        got = poisson_delta_result(tpd, p=0.5)
        if ts is tstat:
            np.testing.assert_array_equal(tpd.states.counts.numpy(),
                                          np.asarray(pd.states.counts))
            np.testing.assert_array_equal(got.thetas.numpy(),
                                          np.asarray(want.thetas))
        else:
            np.testing.assert_array_equal(tpd.states.w.numpy(),
                                          np.asarray(pd.states.w))
            np.testing.assert_allclose(got.thetas.numpy(),
                                       np.asarray(want.thetas),
                                       rtol=EST_RTOL)
        assert got.thetas.shape[:2] == (24, G)


# ---------------------------------------------------------------------------
# non-finite values: a ±inf in one key's rows, a NaN in another's
# ---------------------------------------------------------------------------
def _nonfinite(x, gid):
    """x with +inf in a row of key 1 (dim 0), NaN in a row of key 2 (last
    dim) and -inf in another row of key 1 (last dim)."""
    x = x.copy()
    one, two = np.where(gid == 1)[0], np.where(gid == 2)[0]
    x[one[3], 0], x[two[5], D - 1], x[one[7], D - 1] = np.inf, np.nan, -np.inf
    return x


def _same_positions(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isinf(got) * np.sign(got),
                                  np.isinf(want) * np.sign(want))


def _slot_moments_emulation(x, gid, w):
    """What the slot design of grouped_moments_kernel computes, order
    aside, in float64 with IEEE products: a column adds w, w·x and w·x²
    (x² rounded to f32) to its own key only, and a non-finite x (x²)
    poisons s1 (s2) of every other key."""
    xd = np.asarray(x, np.float64)
    x2 = (np.asarray(x, np.float32) ** 2).astype(np.float64)
    out = [np.zeros((w.shape[0], G)), np.zeros((w.shape[0], G, D)),
           np.zeros((w.shape[0], G, D))]
    with np.errstate(all="ignore"):
        for g in range(G):
            on = gid == g
            out[0][:, g] = w[:, on].sum(1)
            for a, v in ((out[1], xd), (out[2], x2)):
                a[:, g] = w[:, on] @ v[on]
                a[:, g, ~np.isfinite(v[~on]).all(0)] = np.nan
    return out


@pytest.mark.parametrize("hole", [False, True])
def test_grouped_moments_nonfinite_match_jax_scan(keyed, hole):
    """The plain version gives the JAX scan's NaN and inf positions: key
    g's s1 and s2 are NaN where another key's row holds ±inf or NaN (0·x
    in the dense scan), ±inf or NaN where its own does; w_tot is bitwise.
    The kernel's rule, emulated, gives the same positions."""
    _, x, gid = keyed
    x = _nonfinite(x, gid)
    valid, _ = _masks(gid, hole)
    want = jws.fused_poisson_moments(
        SEED, jnp.asarray(x), B, backend="scan",
        valid_mask=None if valid is None else jnp.asarray(valid),
        group_ids=jnp.asarray(gid), num_groups=G)
    got = tws.fused_poisson_moments(SEED, _t(x), B, valid_mask=_t(valid),
                                    group_ids=_t(gid), num_groups=G)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    emu = _slot_moments_emulation(x, gid, _weights(valid, N).numpy())
    for i in (1, 2):
        _same_positions(got[i].numpy(), want[i])
        _same_positions(got[i].numpy(), emu[i])
        fin = np.isfinite(np.asarray(want[i]))
        np.testing.assert_allclose(got[i].numpy()[fin],
                                   np.asarray(want[i])[fin], rtol=1e-5,
                                   atol=1e-4)
    assert np.isnan(got[1].numpy()).any()


@pytest.mark.parametrize("hole", [False, True])
def test_grouped_kmeans_nonfinite_match_jax_scan(keyed, hole):
    """The keyed k-means plain version on ±inf and NaN values: the JAX
    scan's NaN and inf positions, counts bitwise."""
    _, x, gid = keyed
    x = _nonfinite(x, gid)
    valid, _ = _masks(gid, hole)
    cent = np.random.default_rng(2).normal(size=(3, D)).astype(np.float32)
    cent[0, 0] = 0.0
    want = jka.fused_poisson_kmeans(
        SEED, jnp.asarray(x), jnp.asarray(cent), B, backend="scan",
        valid_mask=None if valid is None else jnp.asarray(valid),
        group_ids=jnp.asarray(gid), num_groups=G)
    got = tka.fused_poisson_kmeans(SEED, _t(x), _t(cent), B,
                                   valid_mask=_t(valid), group_ids=_t(gid),
                                   num_groups=G)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    for i in (0, 2):
        _same_positions(got[i].numpy(), want[i])
        fin = np.isfinite(np.asarray(want[i]))
        np.testing.assert_allclose(got[i].numpy()[fin],
                                   np.asarray(want[i])[fin], rtol=1e-5,
                                   atol=1e-4)
    assert np.isnan(got[0].numpy()).any() and np.isnan(got[2].numpy()).any()
