"""The materialized bootstrap engines (the JAX package's default
``backend=None``) against the JAX package on the CPU.

Both packages get the same numpy inputs, keys and seeds.  Tolerances:

* random draws: ``uniform``, ``randint`` and multinomial counts bitwise;
  Poisson weights bitwise but for rare entries whose running log sum lies
  within an ulp of -1, where XLA's and torch's f32 ``log`` may disagree (at
  least 99.99% equal, the count reported);
* w_tot and histogram counts of whole-number weights bitwise, and so the
  thetas of quantiles; moments within 1e-5·Σw|x| (and Σw·x²), estimates
  and thetas of moment statistics within 1e-5 relative (Std scaled by
  E[x²]/Var[x] for its cancellation), cvs within 1e-3 relative;
* sessions, SSABE and the multinomial delta baseline take the same B,
  rows, iterations, resamples and counts.
"""
import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.data.sampler import PreMapSampler as JPreMap
from repro.data.store import ShardedStore as JStore
from repro.kernels.weighted_hist.ref import weighted_hist_scatter_ref as j_hist
from repro.kernels.weighted_stats import ops as jws
from repro_torch import core as T
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric
from repro_torch.kernels.weighted_hist import ops as twh
from repro_torch.kernels.weighted_stats import ops as tws

# the modules (each package's ``core`` exports functions of these names)
jboot, jdelta, jssabe, tboot, tdelta, tssabe = (
    importlib.import_module(f"{pkg}.core.{m}")
    for pkg in ("repro", "repro_torch")
    for m in ("bootstrap", "delta", "ssabe"))

torch.set_num_threads(1)

LO, HI = 0.0, 25.0
EST_RTOL, CV_RTOL = 1e-5, 1e-3
STD_SCALE = (10.0 ** 2 + 2.0 ** 2) / 2.0 ** 2


def _data(n, seed=0):
    return np.random.default_rng(seed).normal(10.0, 2.0, n).astype(
        np.float32)


def _stats(kind):
    """(JAX statistic, port statistic) of one kind."""
    return {
        "mean": (J.Mean(), T.Mean()),
        "var": (J.Var(), T.Var()),
        "std": (J.Std(), T.Std()),
        "median": (J.Median(lo=LO, hi=HI), T.Median(lo=LO, hi=HI)),
        "group": (J.StatisticGroup((J.Mean(), J.Quantile(0.5, lo=LO, hi=HI),
                                    J.Std())),
                  T.StatisticGroup((T.Mean(), T.Quantile(0.5, lo=LO, hi=HI),
                                    T.Std()))),
    }[kind]


def _np(v):
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def _same_result(got, want, kind):
    """Thetas or estimates of one statistic kind: quantiles bitwise,
    moment statistics within f32 rounding."""
    if kind == "group":
        for g, w, k in zip(got, want, ("mean", "median", "std")):
            _same_result(g, w, k)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if kind == "median":
        np.testing.assert_array_equal(g, w)
    else:
        scale = STD_SCALE if kind in ("std", "var") else 1.0
        np.testing.assert_allclose(g, w, rtol=EST_RTOL * scale, atol=1e-6)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,seed", [((64, 4096), 0), ((3, 5, 7), 11)])
def test_uniform_is_bitwise_jax(shape, seed):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    got = trandom.uniform(trandom.PRNGKey(seed), shape, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_poisson_matches_jax(seed, record_property):
    shape = (64, 4096)
    want = np.asarray(jax.random.poisson(jax.random.PRNGKey(seed), 1.0,
                                         shape))
    got = trandom.poisson(trandom.PRNGKey(seed), 1.0, shape,
                          device="cpu").numpy()
    unequal = int((got != want).sum())
    record_property("unequal_entries", unequal)
    assert got.dtype == np.int32
    assert unequal <= 1e-4 * got.size, f"{unequal} unequal entries"
    assert abs(got.mean() - 1.0) < 0.01 and abs(got.var() - 1.0) < 0.01
    # the block and the live-entry compaction give the draw of one block
    small = trandom.poisson(trandom.PRNGKey(seed), 1.0, (64, 64),
                            device="cpu")
    np.testing.assert_array_equal(small.numpy(), np.asarray(
        jax.random.poisson(jax.random.PRNGKey(seed), 1.0, (64, 64))))
    assert not trandom.poisson(trandom.PRNGKey(seed), 0.0, (4, 4),
                              device="cpu").any()


def test_poisson_in_blocks_equals_one_block(monkeypatch):
    whole = trandom.poisson(trandom.PRNGKey(3), 1.0, (16, 1000),
                            device="cpu")
    monkeypatch.setattr(trandom, "BLOCK", 777)
    torch.testing.assert_close(
        trandom.poisson(trandom.PRNGKey(3), 1.0, (16, 1000),
                        dtype=torch.float32, device="cpu"),
        whole.float(), rtol=0, atol=0)
    np.testing.assert_array_equal(
        trandom.randint(trandom.PRNGKey(3), (16, 1000), 0, 97,
                        device="cpu").numpy(),
        np.asarray(jax.random.randint(jax.random.PRNGKey(3), (16, 1000), 0,
                                      97)))


@pytest.mark.parametrize("resample_size", [None, 50])
def test_multinomial_counts_are_bitwise(resample_size):
    want = jboot.multinomial_counts(jax.random.PRNGKey(4), 9, 300,
                                    resample_size=resample_size)
    got = tboot.multinomial_counts(trandom.PRNGKey(4), 9, 300,
                                   resample_size=resample_size, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(1) == (resample_size or 300)).all()


# ---------------------------------------------------------------------------
# the two kernels' plain versions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("B,n,d", [(1, 1, 1), (7, 1000, 3), (33, 517, 8)])
def test_weighted_moments_match_jax(B, n, d):
    rng = np.random.default_rng(B * n + d)
    x = rng.normal(2.0, 3.0, size=(n, d)).astype(np.float32)
    for w in (rng.poisson(1.0, size=(B, n)).astype(np.float32),
              rng.random((B, n)).astype(np.float32)):
        want = jws.weighted_moments(jnp.asarray(w), jnp.asarray(x),
                                    backend="jnp")
        got = tws.weighted_moments(torch.from_numpy(w), torch.from_numpy(x))
        wd, xd = w.astype(np.float64), x.astype(np.float64)
        if np.array_equal(w, np.round(w)):
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        else:
            assert np.all(np.abs(got[0].numpy() - np.asarray(want[0]))
                          <= 1e-6 * wd.sum(1))
        for i, bound in ((1, wd @ np.abs(xd)), (2, wd @ (xd * xd))):
            assert got[i].shape == (B, d)
            assert np.all(np.abs(got[i].numpy().astype(np.float64)
                                 - np.asarray(want[i])) <= 1e-5 * bound)


@pytest.mark.parametrize("R,n,d,nbins", [(1, 300, 1, 64), (6, 1000, 2, 256)])
def test_weighted_histogram_matches_jax(R, n, d, nbins):
    rng = np.random.default_rng(R + n)
    x = rng.normal(0.0, 1.5, size=(n, d)).astype(np.float32)
    x[:6, 0] = [np.nan, np.inf, -np.inf, -2.0, 2.0, 40.0]
    lo, hi = np.full(d, -2.0, np.float32), np.full(d, 2.0, np.float32)
    w = rng.poisson(1.0, size=(R, n)).astype(np.float32)
    w[:, 10:20] = 0.0
    got = twh.weighted_histogram(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(lo), torch.from_numpy(hi),
                                 nbins)
    assert got.shape == (R, d, nbins)
    for r in range(R):
        want = j_hist(jnp.asarray(x), jnp.asarray(w[r]), jnp.asarray(lo),
                      jnp.asarray(hi), nbins)
        np.testing.assert_array_equal(got[r].numpy(), np.asarray(want))
        one = twh.weighted_histogram(torch.from_numpy(x),
                                     torch.from_numpy(w[r]), -2.0, 2.0,
                                     nbins)
        np.testing.assert_array_equal(one.numpy(), got[r].numpy())
    ones = twh.weighted_histogram(torch.from_numpy(x), None, -2.0, 2.0, nbins)
    np.testing.assert_array_equal(ones.numpy(), np.asarray(j_hist(
        jnp.asarray(x), jnp.ones(n), jnp.asarray(lo), jnp.asarray(hi),
        nbins)))
    frac = rng.random(n).astype(np.float32)
    got = twh.weighted_histogram(torch.from_numpy(x), torch.from_numpy(frac),
                                 -2.0, 2.0, nbins)
    want = j_hist(jnp.asarray(x), jnp.asarray(frac), jnp.asarray(lo),
                  jnp.asarray(hi), nbins)
    assert np.all(np.abs(got.numpy() - np.asarray(want))
                  <= 1e-6 * frac.astype(np.float64).sum())


@pytest.mark.parametrize("kind", ["group", "grouped"])
def test_tile_math_never_reaches_weighted_histogram(kind, monkeypatch):
    """``tile_update`` (the fused plain versions' tile math, ``_multi_scan``
    among them) scatters a Quantile's tile itself: ``weighted_histogram``
    launches kernel 10 on a card tensor, which would then stand in for the
    plain version kernel 4 is held against.  ``update_batch`` goes through
    it, and the two agree bitwise on whole-number weights."""
    from repro_torch.core.reduce_api import tree_map
    from repro_torch.kernels.fused_multi.ops import _multi_scan
    rng = np.random.default_rng(5)
    n, B = 700, 6
    x = rng.normal(10.0, 2.0, (n, 1)).astype(np.float32)
    if kind == "grouped":
        x = np.concatenate([x, rng.integers(0, 3, (n, 1))], 1).astype(
            np.float32)
    x, w = torch.from_numpy(x), torch.from_numpy(
        rng.poisson(1.0, (B, n)).astype(np.float32))
    group = T.StatisticGroup((T.Mean(), T.Quantile(0.5, lo=LO, hi=HI),
                              T.Std()))
    stat = group if kind == "group" else T.GroupedStatistic(
        T.Median(lo=LO, hi=HI), 3)
    batch = stat.update_batch(stat.init_batch(x.shape[1], B), x, w)

    def refuse(*args, **kw):
        raise AssertionError("plain tile math reached weighted_histogram")
    monkeypatch.setattr(twh, "weighted_histogram", refuse)
    tile = stat.tile_update(stat.init_batch(x.shape[1], B), x, w)
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(),
                                                        b.numpy()),
             tile, batch)
    if kind == "group":
        _multi_scan(group.slots, 17, tws.prepare(x, B))


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["mean", "var", "std", "median", "group"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_bootstrap_thetas_match_jax(kind, use_kernel):
    x = _data(900, seed=5)
    w = np.random.default_rng(6).poisson(1.0, (24, 900)).astype(np.float32)
    jstat, tstat = _stats(kind)
    want = jboot.bootstrap_thetas(jnp.asarray(x), jstat, jnp.asarray(w),
                                  use_kernel=use_kernel)
    got = tboot.bootstrap_thetas(torch.from_numpy(x), tstat,
                                 torch.from_numpy(w), use_kernel=use_kernel)
    _same_result(got, want, kind)


@pytest.mark.parametrize("engine", ["poisson", "multinomial"])
@pytest.mark.parametrize("kind", ["mean", "median", "group"])
def test_default_bootstrap_matches_jax(engine, kind):
    x = _data(3000, seed=1)
    jstat, tstat = _stats(kind)
    want = J.bootstrap(jnp.asarray(x), jstat, 40, jax.random.PRNGKey(3),
                       engine=engine)
    got = T.bootstrap(x, tstat, 40, trandom.PRNGKey(3), engine=engine,
                      device="cpu")
    _same_result(got.thetas, want.thetas, kind)
    _same_result(got.estimate, want.estimate, kind)
    cvs = (got.report.cvs, want.report.cvs) if kind == "group" else \
        (got.cv, want.cv)
    np.testing.assert_allclose(*cvs, rtol=CV_RTOL)


@pytest.mark.parametrize("backend", [None, "fused_rng"])
@pytest.mark.parametrize("kind", ["mean", "median", "group"])
def test_bootstrap_chunked_matches_jax(backend, kind):
    x = _data(2500, seed=2)                 # 2 chunks of 1024 and a tail
    jstat, tstat = _stats(kind)
    want = jboot.bootstrap_chunked(jnp.asarray(x), jstat, 16,
                                   jax.random.PRNGKey(5), chunk=1024,
                                   backend=backend)
    got = tboot.bootstrap_chunked(x, tstat, 16, trandom.PRNGKey(5),
                                  chunk=1024, backend=backend, device="cpu")
    _same_result(got.thetas, want.thetas, kind)
    _same_result(got.estimate, want.estimate, kind)
    assert (got.B, got.n) == (want.B, want.n)


def test_bootstrap_checks_its_arguments():
    with pytest.raises(ValueError, match="poisson engine"):
        T.bootstrap(_data(10), T.Mean(), 4, trandom.PRNGKey(0),
                    engine="multinomial", backend="fused_rng", device="cpu")
    with pytest.raises(ValueError, match="unknown bootstrap backend"):
        T.bootstrap(_data(10), T.Mean(), 4, trandom.PRNGKey(0),
                    backend="scan", device="cpu")
    with pytest.raises(ValueError, match="unknown bootstrap engine"):
        T.bootstrap(_data(10), T.Mean(), 4, trandom.PRNGKey(0),
                    engine="jackknife", device="cpu")
    with pytest.raises(ValueError, match="poisson engine"):
        tboot.bootstrap_chunked(_data(10), T.Mean(), 4, trandom.PRNGKey(0),
                                engine="multinomial", device="cpu")


# ---------------------------------------------------------------------------
# delta maintenance, SSABE and the session
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["median", "group"])
def test_materialized_delta_matches_and_continues_from_jax(kind):
    parts = [_data(m, seed=m)[:, None] for m in (300, 700, 1100)]
    jstat, tstat = _stats(kind)
    jpd = jdelta.poisson_delta_init(jstat, 24, 1, jax.random.PRNGKey(4))
    tpd = T.poisson_delta_init(tstat, 24, 1, trandom.PRNGKey(4),
                               device="cpu")
    for p in parts[:2]:
        jpd = jdelta.poisson_delta_extend(jpd, jnp.asarray(p))
        tpd = T.poisson_delta_extend(tpd, torch.from_numpy(p))
    numpy = jax.tree_util.tree_map(np.asarray, (jpd.states, jpd.est_state))
    cpd = interop.poisson_delta_from_numpy(
        tstat, jpd.B, numpy[0], numpy[1], np.asarray(jpd.key), jpd.n,
        jpd.step, device="cpu")
    jpd = jdelta.poisson_delta_extend(jpd, jnp.asarray(parts[2]))
    want = jdelta.poisson_delta_result(jpd, p=0.5)
    for pd in (tpd, cpd):
        pd = T.poisson_delta_extend(pd, torch.from_numpy(parts[2]))
        assert (pd.n, pd.step) == (jpd.n, jpd.step)
        got = T.poisson_delta_result(pd, p=0.5)
        _same_result(got.thetas, want.thetas, kind)
        _same_result(got.estimate, want.estimate, kind)


@pytest.mark.parametrize("engine", ["poisson", "multinomial"])
def test_estimate_B_and_n_match_jax(engine):
    x = _data(2048, seed=3)
    jstat, tstat = _stats("group")
    jB, jhist = jssabe.estimate_B(jnp.asarray(x), jstat, 0.01,
                                  jax.random.PRNGKey(8), engine=engine)
    tB, thist = tssabe.estimate_B(x, tstat, 0.01, trandom.PRNGKey(8),
                                  engine=engine, device="cpu")
    assert tB == jB and [b for b, _ in thist] == [b for b, _ in jhist]
    np.testing.assert_allclose([c for _, c in thist], [c for _, c in jhist],
                               rtol=CV_RTOL)
    want = jssabe.estimate_n(jnp.asarray(x), jstat, 0.02, jB,
                             jax.random.PRNGKey(9), l=3)
    got = tssabe.estimate_n(x, tstat, 0.02, tB, trandom.PRNGKey(9), l=3,
                            device="cpu")
    assert got[0] == want[0]
    assert [n for n, _ in got[1]] == [n for n, _ in want[1]]
    np.testing.assert_allclose([c for _, c in got[1]],
                               [c for _, c in want[1]], rtol=CV_RTOL)


@pytest.mark.parametrize("kind", ["group", "median"])
def test_default_session_matches_jax(kind):
    data = synthetic_numeric(200_000, mean=10.0, std=2.0, seed=0)
    jstat, tstat = _stats(kind)
    jstore = JStore.from_array(data, split_size=65_536)
    tstore = ShardedStore.from_array(data, split_size=65_536)
    want = J.EarlSession(JPreMap(jstore, seed=1), jstat,
                         sigma=0.05).run(jax.random.PRNGKey(0))
    got = T.EarlSession(PreMapSampler(tstore, seed=1, device="cpu"), tstat,
                        sigma=0.05, device="cpu").run(trandom.PRNGKey(0))
    assert (got.B, got.n_used, got.iterations, got.fell_back) == \
        (want.B, want.n_used, want.iterations, want.fell_back)
    assert tstore.stats.rows_read == jstore.stats.rows_read
    assert [b for b, _ in got.ssabe.cv_history_B] == \
        [b for b, _ in want.ssabe.cv_history_B]
    np.testing.assert_allclose(got.cv, want.cv, rtol=CV_RTOL)
    _same_result(got.result, want.result, kind)


# ---------------------------------------------------------------------------
# the paper-faithful baselines (§4.1, §4.2)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("use_sketch", [True, False])
@pytest.mark.parametrize("kind", ["mean", "median"])
def test_multinomial_delta_matches_jax(use_sketch, kind):
    jstat, tstat = _stats(kind)
    jm = jdelta.MultinomialDeltaBootstrap(jstat, 12, seed=3,
                                          use_sketch=use_sketch)
    tm = T.MultinomialDeltaBootstrap(tstat, 12, seed=3, use_sketch=use_sketch,
                                     device="cpu")
    for m in (400, 400, 900):
        part = _data(m, seed=m + 1)
        jm.extend(part)
        tm.extend(part)
        assert (tm.n, tm.disk_accesses, tm.items_moved) == \
            (jm.n, jm.disk_accesses, jm.items_moved)
        for a, b in zip(tm.resamples, jm.resamples):
            np.testing.assert_array_equal(a, b)
    want, got = jm.result(p=0.25), tm.result(p=0.25)
    _same_result(got.thetas, want.thetas, kind)
    _same_result(got.estimate, want.estimate, kind)


def test_multinomial_delta_refuses_groups():
    with pytest.raises(TypeError, match="StatisticGroup"):
        T.MultinomialDeltaBootstrap(_stats("group")[1], 4, device="cpu")
    with pytest.raises(TypeError, match="per-key"):
        T.MultinomialDeltaBootstrap(T.GroupedStatistic(T.Mean(), 2), 4,
                                    device="cpu")


def test_sketch_matches_jax():
    js = jdelta.Sketch(np.arange(1000), 2.0, np.random.default_rng(1))
    ts = T.Sketch(np.arange(1000), 2.0, np.random.default_rng(1))
    for k in (10, 63, 200, 1):
        np.testing.assert_array_equal(ts.take(k), js.take(k))
    assert ts.disk_accesses == js.disk_accesses


@pytest.mark.parametrize("n", [1, 10, 400, 4000])
def test_intra_iteration_helpers_match_jax(n):
    for y in (0.0, 0.01, 0.3, 1.0):
        assert T.p_shared(n, y) == jdelta.p_shared(n, y)
        assert T.work_saved(n, y) == jdelta.work_saved(n, y)
    assert T.optimal_y(n) == jdelta.optimal_y(n)


@pytest.mark.parametrize("kind,y", [("median", None), ("mean", None),
                                    ("median", 1.0)])
def test_shared_base_bootstrap_matches_jax(kind, y):
    x = _data(400, seed=7)
    jstat, tstat = _stats(kind)
    want = jdelta.shared_base_bootstrap(jnp.asarray(x), jstat, 8,
                                        jax.random.PRNGKey(2), y=y, p=0.5)
    got = T.shared_base_bootstrap(x, tstat, 8, trandom.PRNGKey(2), y=y,
                                  p=0.5, device="cpu")
    _same_result(got.thetas, want.thetas, kind)
    _same_result(got.estimate, want.estimate, kind)


# ---------------------------------------------------------------------------
# the defaults and signatures are the JAX package's
# ---------------------------------------------------------------------------
def _params(fn):
    return inspect.signature(fn).parameters


@pytest.mark.parametrize("name", ["bootstrap", "bootstrap_chunked",
                                  "estimate_B", "estimate_n", "ssabe",
                                  "poisson_delta_init", "EarlSession"])
def test_backend_defaults_match_jax(name):
    mods = {"bootstrap": (jboot, tboot), "bootstrap_chunked": (jboot, tboot),
            "estimate_B": (jssabe, tssabe), "estimate_n": (jssabe, tssabe),
            "ssabe": (jssabe, tssabe),
            "poisson_delta_init": (jdelta, tdelta),
            "EarlSession": (J, T)}[name]
    jp, tp = (_params(getattr(m, name)) for m in mods)
    assert jp["backend"].default is None
    assert tp["backend"].default is None


@pytest.mark.parametrize("name", ["bootstrap", "bootstrap_chunked",
                                  "bootstrap_thetas"])
def test_bootstrap_parameter_order_matches_jax(name):
    """The JAX order, with ``data_axis`` (no mesh is ported) dropped and
    ``device`` last: a positional argument lands in the same slot."""
    jp, tp = _params(getattr(jboot, name)), _params(getattr(tboot, name))
    want = [p for p in jp if p != "data_axis"]
    got = list(tp)
    if "device" in got:
        assert got[-1] == "device"
        got = got[:-1]
    assert got == want
    for p in want:
        assert tp[p].default == jp[p].default, p
