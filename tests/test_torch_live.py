"""The port's live sessions and windows against the JAX package on the CPU,
and the port's own bitwise contracts.

Both packages fold the same numpy batches (made from a seed) under the
same key.  On the CPU the port runs each kernel's plain version and the
JAX package its scan lowering, so, pane by pane:

* w_tot, histogram counts and bin ranges are bitwise;
* s1 is within 1e-5·Σw|x| and s2 within 1e-5·Σw·x² of the JAX package's
  (f32 dots in another order; Σw|x| is s1 of the same session over |x|);
* thetas, estimates and CI ends are within the bound those derive:
  a Mean moves by at most 1e-5·Σw|x|/Σw, a Var = s2/w - (s1/w)² by
  e2/w + (2|s1/w| + e1/w)·e1/w (e1, e2 the two bounds above), each plus
  1e-6 of the value for the finalize's own f32 rounding; a CI end moves
  by at most the largest bound among the resamples it orders;
  histogram-derived thetas are bitwise.

The port's own contracts are bitwise, as the JAX package's tests hold
them: a kill at every batch boundary then resume equals the
uninterrupted run; duplicated and reordered delivery equals in-order
delivery; a shed run equals the oracle fold with the same masks; late
batches fold or drop as ``LagPolicy.late`` says; the fingerprint rejects
another window, key or statistic.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import reduce_api as jra
from repro.live import IngestLog as JLog
from repro.live import LiveSession as JLive
from repro_torch import random as trandom
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import reduce_api as tra
from repro_torch.core import (GroupedStatistic, KMeansStep, Mean, Quantile,
                              SlidingWindow, StatisticGroup, TumblingWindow,
                              Var, Window, bind_params)
from repro_torch.core.bootstrap import (fused_resample_states, offset_seed,
                                        seed_from_key)
from repro_torch.core.reduce_api import (HistogramState, MomentState,
                                         split_params)
from repro_torch.core.streaming import bootstrap_streaming
from repro_torch.data.store import ShardedStore
from repro_torch.ft import FaultyStore, LagPolicy
from repro_torch.live import (BackpressureError, IngestLog, LiveSession,
                              LogBatch)

torch.set_num_threads(1)

SEED = 13
KEY = trandom.PRNGKey(SEED)
B = 8
ROWS = 32                      # rows per appended batch
N_BATCHES = 6
G = 4
LO, HI, NBINS = -4.0, 4.0, 64


class _Kill(Exception):
    """The simulated mid-stream death."""


class _DyingManager(CheckpointManager):
    """Commits its first ``die_after`` saves, then kills the run: with
    ``checkpoint_every=1`` that is a kill at fold boundary ``die_after``."""

    def __init__(self, root, die_after, **kw):
        kw.setdefault("async_save", False)
        super().__init__(root, **kw)
        self.die_after = die_after
        self.saves = 0

    def save(self, *a, **kw):
        super().save(*a, **kw)
        self.saves += 1
        if self.saves >= self.die_after:
            raise _Kill(f"simulated crash after save #{self.saves}")


def _leaves(t):
    return list(t) if isinstance(t, (tuple, list)) else [t]


def _bitwise(a, b):
    for u, v in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _keyed(stat):
    return getattr(stat, "num_groups", None) is not None


def _batch_data(stat, i, rows=ROWS):
    rng = np.random.default_rng((17, i))
    if _keyed(stat):
        x = rng.normal(size=(rows, 1)).astype(np.float32)
        k = rng.integers(0, stat.num_groups,
                         size=(rows, 1)).astype(np.float32)
        return np.concatenate([x, k], axis=1)
    return rng.normal(size=(rows, 2)).astype(np.float32)


def _fill_log(stat, n=N_BATCHES, absolute=False):
    log = IngestLog()
    for i in range(n):
        x = _batch_data(stat, i)
        log.append(np.abs(x) if absolute else x)
    return log


def _wrap(stat, wkind):
    """Windows sized against 32-row batches: a tumbling pane is 2
    batches; a sliding pane is 1 batch in a 4-pane ring."""
    if wkind == "cumulative":
        return stat
    if wkind == "tumbling":
        return TumblingWindow(stat, 64)
    return SlidingWindow(stat, 128, 32)


def _session(stat, wkind, log=None, **kw):
    return LiveSession(_fill_log(stat) if log is None else log,
                       _wrap(stat, wkind), B=B, key=KEY, device="cpu", **kw)


# ---------------------------------------------------------------------------
# windows and the parameter API
# ---------------------------------------------------------------------------
def test_window_geometry_and_validation_match_jax():
    for size, slide in ((128, 32), (96, 96)):
        t, j = SlidingWindow(Mean(), size, slide), jra.SlidingWindow(
            jra.Mean(), size, slide)
        assert (t.size, t.slide, t.panes) == (j.size, j.slide, j.panes)
        assert [t.pane_of(r) for r in (0, 95, 96, 200)] == \
            [j.pane_of(r) for r in (0, 95, 96, 200)]
        assert t.pane_rows(3) == j.pane_rows(3)
    tw = TumblingWindow(Mean(), 96)
    assert isinstance(tw, Window) and (tw.size, tw.slide, tw.panes) == \
        (96, 96, 1)
    for args, err in (((100, 32), ValueError), ((32, 0), ValueError),
                      ((16, 32), ValueError)):
        with pytest.raises(err) as got:
            SlidingWindow(Mean(), *args)
        with pytest.raises(err) as want:
            jra.SlidingWindow(jra.Mean(), *args)
        assert str(got.value) == str(want.value)
    with pytest.raises(TypeError, match="Statistic"):
        SlidingWindow(object(), 64, 32)

    class Reservoir(tra.Mean):
        mergeable = False

    with pytest.raises(ValueError, match="not mergeable"):
        TumblingWindow(Reservoir(), 64)


@pytest.mark.parametrize("kind", ["group", "grouped", "grouped_kmeans"])
def test_bind_params_inverts_split_params(kind):
    cent = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 2)).astype(np.float32))
    stat = {"group": StatisticGroup((Mean(), Quantile(0.5, NBINS, LO, HI),
                                     KMeansStep(cent))),
            "grouped": GroupedStatistic(Var(), G),
            "grouped_kmeans": GroupedStatistic(KMeansStep(cent), G)}[kind]
    spec, params = split_params(stat)
    bound = bind_params(spec, params)
    assert type(bound) is type(stat) and bound == stat
    assert split_params(bound)[0] == spec
    for path, t in split_params(bound)[1].items():
        assert t is params[path]
    if kind == "group":
        assert bound.member_slot == stat.member_slot
        assert bound.slots[2] is bound.members[2]
    else:
        assert bound.num_groups == G and bound.mergeable


def test_bind_params_refuses_a_missing_parameter():
    spec, params = split_params(KMeansStep(torch.zeros(2, 2)))
    with pytest.raises(ValueError, match="centroids"):
        bind_params(spec, {})
    assert bind_params(*split_params(Mean())) == Mean()


def test_bind_params_refuses_a_statistic_it_does_not_know():
    class Shifted(tra.Mean):
        pass

    with pytest.raises(TypeError, match="not the spec of one of"):
        bind_params(*split_params(Shifted()))


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------
# name -> (port statistic, JAX statistic)
PAIRS = {
    "Var": (lambda: Var(), lambda: jra.Var()),
    "Quantile": (lambda: Quantile(0.5, NBINS, LO, HI),
                 lambda: jra.Quantile(0.5, NBINS, LO, HI)),
    "StatisticGroup": (
        lambda: StatisticGroup((Mean(), Quantile(0.5, NBINS, LO, HI))),
        lambda: jra.StatisticGroup((jra.Mean(),
                                    jra.Quantile(0.5, NBINS, LO, HI)))),
    "Grouped": (lambda: GroupedStatistic(Mean(), G),
                lambda: jra.GroupedStatistic(jra.Mean(), G)),
}


def _jwrap(jstat, wkind):
    if wkind == "cumulative":
        return jstat
    return jra.SlidingWindow(jstat, 128, 32)


def _check_state(t, j, tabs, where):
    """One pane's port state against the JAX package's: w and counts
    bitwise, s1 within 1e-5·Σw|x| (``tabs``: the |x| session's state),
    s2 within 1e-5·Σw·x²."""
    if isinstance(t, tuple):
        for i, (a, b, c) in enumerate(zip(t, j, tabs)):
            _check_state(a, b, c, f"{where} slot {i}")
    elif isinstance(t, MomentState):
        np.testing.assert_array_equal(t.w.numpy(), np.asarray(j.w),
                                      err_msg=f"w_tot {where}")
        for got, want, bound, what in (
                (t.s1, j.s1, tabs.s1, "s1"), (t.s2, j.s2, j.s2, "s2")):
            diff = np.abs(got.numpy() - np.asarray(want))
            assert np.all(diff <= 1e-5 * np.abs(np.asarray(bound))), \
                f"{what} {where}: max |err| {diff.max()}"
    else:
        assert isinstance(t, HistogramState)
        for f in ("counts", "lo", "hi"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f"{f} {where}")


def _merged(session):
    stat, ring = session.stat, session._ring
    panes = sorted(ring)
    states, est = ring[panes[0]].states, ring[panes[0]].est
    for p in panes[1:]:
        states = stat.merge(states, ring[p].states)
        est = stat.merge(est, ring[p].est)
    return states, est


def _theta_bounds(stat, states, tabs):
    """Per-entry bounds on the port's corrected results (a tuple for a
    group), None for a histogram-derived (bitwise) result."""
    if isinstance(stat, StatisticGroup):
        return tuple(_theta_bounds(m, states[s], tabs[s])
                     for m, s in zip(stat.members, stat.member_slot))
    if isinstance(stat, GroupedStatistic):
        return _theta_bounds(stat.inner, states, tabs)
    if isinstance(stat, Quantile):
        return None
    w = states.w.double().unsqueeze(-1) + 1e-12
    m = states.s1.double() / w
    e1 = 1e-5 * tabs.s1.double() / w
    if isinstance(stat, tra.Var):
        e2 = 1e-5 * states.s2.double() / w
        val = states.s2.double() / w + m * m
        return (e2 + (2 * m.abs() + e1) * e1 + 1e-6 * val).numpy()
    return (e1 + 1e-6 * m.abs()).numpy()


def _within(got, want, bound, what):
    """Each leaf within its bound (of the leaf's shape), or bitwise where
    the bound is None."""
    for g, w, b in zip(_leaves(got), _leaves(want),
                       bound if isinstance(bound, tuple) else [bound]):
        g, w = np.asarray(g), np.asarray(w)
        if b is None:
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            diff = np.abs(g - w)
            assert np.all(diff <= b.reshape(diff.shape)), \
                f"{what}: max |err| {diff.max()}"


def _reports(rep):
    members = getattr(rep.report, "members", None)
    return members if members is not None else (rep.report,)


@pytest.mark.parametrize("wkind", ["cumulative", "sliding"])
@pytest.mark.parametrize("name", list(PAIRS))
def test_live_session_matches_jax(name, wkind):
    tstat, jstat = (f() for f in PAIRS[name])
    log = _fill_log(tstat)
    jlog = JLog()
    for i in range(N_BATCHES):
        jlog.append(_batch_data(tstat, i))
    got = LiveSession(log, _wrap(tstat, wkind), B=B, key=KEY,
                      device="cpu").poll()
    js = JLive(jlog, _jwrap(jstat, wkind), B=B,
               key=jax.random.PRNGKey(SEED))
    want = js.poll()
    ts = got[-1]
    # |x| through the same session: its s1 is Σw|x| pane by pane
    abs_s = LiveSession(_fill_log(tstat, absolute=True), _wrap(tstat, wkind),
                        B=B, key=KEY, device="cpu")
    abs_s.poll()
    assert len(got) == len(want) == N_BATCHES
    for g, w in zip(got, want):
        assert (g.seq, g.watermark_seq, g.watermark_row, g.window_start,
                g.window_end, g.rows, g.valid_rows, g.p_eff, g.panes_live) \
            == (w.seq, w.watermark_seq, w.watermark_row, w.window_start,
                w.window_end, w.rows, w.valid_rows, w.p_eff, w.panes_live)
    tl = LiveSession(log, _wrap(tstat, wkind), B=B, key=KEY, device="cpu")
    tl.poll()
    assert sorted(tl._ring) == sorted(js._ring) == sorted(abs_s._ring)
    for p in tl._ring:
        tp, jp, ap = tl._ring[p], js._ring[p], abs_s._ring[p]
        _check_state(tp.states, jp.states, ap.states, f"pane {p} states")
        _check_state(tp.est, jp.est, ap.est, f"pane {p} estimate")
        assert (tp.rows, tp.valid) == (jp.rows, jp.valid)
    states, est = _merged(tl)
    abs_states, abs_est = _merged(abs_s)
    tb = _theta_bounds(tstat, states, abs_states)
    eb = _theta_bounds(tstat, est, abs_est)
    w = want[-1]
    _within(ts.thetas, w.thetas, tb, f"{name} {wkind} thetas")
    _within(ts.estimate, w.estimate, eb, f"{name} {wkind} estimate")
    for i, (gr, wr) in enumerate(zip(_reports(ts), _reports(w))):
        b = tb[i] if isinstance(tb, tuple) else tb
        # a CI end is an order statistic of the thetas (interpolated):
        # it moves by at most the largest theta bound, plus its rounding
        for end in ("ci_lo", "ci_hi"):
            g, wv = np.asarray(getattr(gr, end)), np.asarray(getattr(wr, end))
            lim = (0.0 if b is None else b.max()) + 1e-6 * np.abs(wv)
            assert np.all(np.abs(g - wv) <= lim), \
                f"{name} {wkind} member {i} {end}"


# ---------------------------------------------------------------------------
# the port's own bitwise contracts
# ---------------------------------------------------------------------------
STATS = {
    "Mean": lambda: Mean(),
    "Var": lambda: Var(),
    "Quantile": lambda: Quantile(0.5, NBINS, LO, HI),
    "StatisticGroup": lambda: StatisticGroup((Mean(), Var())),
    "Grouped": lambda: GroupedStatistic(Mean(), G),
}
_CLEAN = {}


def _clean_report(name, wkind):
    """The uninterrupted run, cached across the kill parametrization."""
    if (name, wkind) not in _CLEAN:
        s = _session(STATS[name](), wkind)
        s.poll()
        _CLEAN[name, wkind] = s.report()
    return _CLEAN[name, wkind]


@pytest.mark.parametrize("die_after", range(1, N_BATCHES + 1))
@pytest.mark.parametrize("wkind", ["cumulative", "tumbling", "sliding"])
@pytest.mark.parametrize("name", list(STATS))
def test_kill_at_every_batch_boundary_resumes_bitwise(name, wkind,
                                                      die_after, tmp_path):
    stat = STATS[name]()
    base = _clean_report(name, wkind)
    log = _fill_log(stat)
    root = str(tmp_path / "ckpt")
    dying = _session(stat, wkind, log,
                     checkpoint=_DyingManager(root, die_after))
    with pytest.raises(_Kill):
        dying.poll()
    resumed = _session(stat, wkind, log, resume=True,
                       checkpoint=CheckpointManager(root, async_save=False))
    assert resumed.counters.folded == die_after
    for pane in resumed._ring.values():
        for t in _leaves(pane.est):
            for f in (vars(t).values() if not isinstance(t, torch.Tensor)
                      else [t]):
                assert f.device.type == "cpu"
    resumed.poll()
    rep = resumed.report()
    assert resumed.counters.folded == N_BATCHES          # exactly once
    _bitwise(base.thetas, rep.thetas)
    _bitwise(base.estimate, rep.estimate)
    assert (rep.rows, rep.valid_rows, rep.p_eff) == \
        (base.rows, base.valid_rows, base.p_eff)
    assert (rep.watermark_seq, rep.watermark_row, rep.window_start) == \
        (base.watermark_seq, base.watermark_row, base.window_start)


def test_checkpointing_is_an_observer(tmp_path):
    """A checkpointed run gives the plain run's bits; a path scopes its
    snapshots by fingerprint (``CheckpointManager.for_run``)."""
    base = _clean_report("Mean", "sliding")
    s = _session(Mean(), "sliding", checkpoint=str(tmp_path / "ckpt"),
                 checkpoint_every=2)
    s.poll()
    rep = s.report()
    _bitwise(base.thetas, rep.thetas)
    _bitwise(base.estimate, rep.estimate)
    assert s.checkpoint.root.endswith(f"run_{s.fingerprint[:16]}")
    s.checkpoint.wait()
    assert s.checkpoint.steps() == [2, 4, 6]


@pytest.mark.parametrize("other", ["window", "key", "statistic"])
def test_fingerprint_rejects_another_run(other, tmp_path):
    log = _fill_log(Mean(), n=2)
    root = str(tmp_path / "ckpt")
    LiveSession(log, SlidingWindow(Mean(), 128, 32), B=B, key=KEY,
                device="cpu",
                checkpoint=CheckpointManager(root, async_save=False)).poll()
    kw = dict(stat=SlidingWindow(Mean(), 128, 32), key=KEY)
    if other == "window":
        kw["stat"] = TumblingWindow(Mean(), 128)
    elif other == "key":
        kw["key"] = trandom.PRNGKey(99)
    else:
        kw["stat"] = SlidingWindow(Var(), 128, 32)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        LiveSession(log, B=B, device="cpu", resume=True,
                    checkpoint=CheckpointManager(root, async_save=False),
                    **kw)


def test_resume_validation(tmp_path):
    with pytest.raises(ValueError, match="resume"):
        LiveSession(IngestLog(), Mean(), B=B, key=KEY, resume=True,
                    device="cpu")
    root = str(tmp_path / "ckpt")
    mgr = CheckpointManager(root, async_save=False)
    mgr.save(0, {"weights": torch.zeros(3)}, extra={"note": "training"})
    with pytest.raises(ValueError, match="cursor"):
        LiveSession(IngestLog(), Mean(), B=B, key=KEY, resume=True,
                    checkpoint=mgr, device="cpu")
    with pytest.raises(TypeError, match="Statistic"):
        LiveSession(IngestLog(), object(), B=B, key=KEY, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_every"):
        LiveSession(IngestLog(), Mean(), B=B, key=KEY, checkpoint_every=0,
                    device="cpu")
    with pytest.raises(ValueError, match="poll"):
        LiveSession(None, Mean(), B=B, key=KEY, device="cpu").poll()


def _split_store(n_splits=10):
    data = np.random.default_rng(5).normal(
        size=(n_splits * ROWS, 2)).astype(np.float32)
    return ShardedStore.from_array(data, ROWS, interleave=False)


def _run_plan(inner, plan, **kw):
    s = LiveSession(None, SlidingWindow(Var(), 128, 32), B=B, key=KEY,
                    device="cpu", **kw)
    for sq, data in plan:
        s.feed(LogBatch(seq=sq, row0=int(inner.offsets[sq]), data=data))
        assert s.panes_live <= s.memory_bound
    return s


def test_duplicates_and_reorder_fold_exactly_once_bitwise():
    inner = _split_store()
    clean = _run_plan(inner, ((i, inner.read_split(i)) for i in range(10)))
    faulty = FaultyStore(inner)
    deliveries = list(faulty.iter_delivery(seed=42, p_duplicate=0.3,
                                           max_reorder=3))
    assert faulty.injected.duplicates > 0 and faulty.injected.reordered > 0
    s = _run_plan(inner, iter(deliveries))
    assert s.counters.folded == 10
    assert s.counters.duplicates == faulty.injected.duplicates
    a, b = clean.report(), s.report()
    _bitwise(a.thetas, b.thetas)
    _bitwise(a.estimate, b.estimate)
    assert a.p_eff == b.p_eff == 1.0


def test_backwards_delivery_stays_within_the_memory_bound():
    inner = _split_store(8)
    s = _run_plan(inner, ((i, inner.read_split(i)) for i in range(7, -1, -1)),
                  policy=LagPolicy(max_lag_batches=16))
    assert s.counters.folded == 8 and s.counters.reordered == 7
    clean = _run_plan(inner, ((i, inner.read_split(i)) for i in range(8)))
    _bitwise(clean.report().thetas, s.report().thetas)


def test_shed_equals_the_masked_oracle_bitwise():
    """A backlogged poll sheds seqs 0..6 with (shed_seed, seq)-keyed numpy
    masks; the report is bitwise the same masks folded by hand."""
    policy = LagPolicy(max_lag_batches=16, shed_backlog=2, p_shed=0.5,
                       shed_seed=99)
    window = SlidingWindow(Var(), 128, 32)
    log = _fill_log(Var(), n=10)
    s = LiveSession(log, window, B=B, key=KEY, policy=policy, device="cpu")
    reports = s.poll()
    assert [r.shed for r in reports] == [True] * 7 + [False] * 3
    assert s.counters.shed_batches == 7 and s.counters.shed_rows > 0
    rep = s.report()
    stat, base = window.stat, seed_from_key(KEY)
    states, est = stat.init_batch(2, B), stat.init_state(2)
    rows = valid = 0
    for sq in range(6, 10):              # the window: panes 6..9
        xb = torch.from_numpy(log.store.read_split(sq))
        m = (np.random.default_rng((99, sq)).random(ROWS) < 0.5
             ).astype(np.float32) if sq <= 6 else np.ones(ROWS, np.float32)
        mt = torch.from_numpy(m)
        est = stat.update(est, xb, mt)
        states = stat.merge(states, fused_resample_states(
            stat, offset_seed(base, sq), xb, B, valid_mask=mt))
        rows += ROWS
        valid += int(m.sum())
    p_eff = valid / rows
    assert rep.p_eff == p_eff < 1.0
    _bitwise(rep.thetas, stat.correct(stat.finalize_batch(states), p_eff))
    _bitwise(rep.estimate, stat.correct(stat.finalize(est), p_eff))


def test_shed_is_deterministic_across_resume(tmp_path):
    policy = LagPolicy(max_lag_batches=16, shed_backlog=2, p_shed=0.5,
                       shed_seed=7)
    clean = LiveSession(_fill_log(Mean(), n=10), Mean(), B=B, key=KEY,
                        policy=policy, device="cpu")
    clean.poll()
    base = clean.report()
    log = _fill_log(Mean(), n=10)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        LiveSession(log, Mean(), B=B, key=KEY, policy=policy, device="cpu",
                    checkpoint=_DyingManager(root, 4)).poll()
    r = LiveSession(log, Mean(), B=B, key=KEY, policy=policy, device="cpu",
                    resume=True,
                    checkpoint=CheckpointManager(root, async_save=False))
    r.poll()
    rep = r.report()
    assert rep.p_eff == base.p_eff
    assert r.counters.shed_rows == clean.counters.shed_rows
    _bitwise(base.thetas, rep.thetas)
    _bitwise(base.estimate, rep.estimate)


def _lost_one(policy, window=None, lost=2, n=8):
    inner = _split_store(n)
    bs = [LogBatch(seq=i, row0=i * ROWS, data=inner.read_split(i))
          for i in range(n)]
    s = LiveSession(None, window or Mean(), B=B, key=KEY, policy=policy,
                    device="cpu")
    for b in bs[:lost] + bs[lost + 1:]:
        s.feed(b)
    return s, bs


def test_gap_charges_invalid_rows():
    s, _ = _lost_one(LagPolicy(max_lag_batches=3))
    assert (s.counters.gaps_skipped, s.counters.gap_rows,
            s.counters.folded) == (1, ROWS, 7)
    rep = s.report()
    assert (rep.rows, rep.valid_rows, rep.watermark_seq) == \
        (8 * ROWS, 7 * ROWS, 7)
    assert rep.p_eff == pytest.approx(7 / 8)


def test_late_drop_counts_the_batch():
    s, bs = _lost_one(LagPolicy(max_lag_batches=3, late="drop"))
    assert s.feed(bs[2]) == []
    assert s.counters.late_dropped == 1
    assert s.report().p_eff == pytest.approx(7 / 8)


def test_late_fold_restores_p_eff():
    s, bs = _lost_one(LagPolicy(max_lag_batches=3, late="fold"))
    out = s.feed(bs[2])
    assert len(out) == 1 and s.counters.late_folded == 1
    rep = s.report()
    assert rep.p_eff == 1.0
    clean = LiveSession(None, Mean(), B=B, key=KEY, device="cpu")
    for b in bs:
        clean.feed(b)
    # the fold order differs, so this agrees to rounding (the documented
    # limit of late folding), not bitwise
    np.testing.assert_allclose(rep.estimate.numpy(),
                               clean.report().estimate.numpy(), rtol=1e-5)


def test_late_fold_into_an_evicted_pane_drops():
    s, bs = _lost_one(LagPolicy(max_lag_batches=2, late="fold"),
                      window=SlidingWindow(Mean(), 64, 32), lost=1)
    assert s.feed(bs[1]) == []
    assert s.counters.late_dropped == 1


def test_duplicate_after_fold_is_dropped():
    inner = _split_store(4)
    s = LiveSession(None, Mean(), B=B, key=KEY, device="cpu")
    bs = [LogBatch(seq=i, row0=i * ROWS, data=inner.read_split(i))
          for i in range(4)]
    for b in bs:
        s.feed(b)
    before = s.report()
    assert s.feed(bs[1]) == []
    assert s.counters.duplicates == 1
    _bitwise(before.thetas, s.report().thetas)


def test_a_batch_across_two_panes_folds_masked_not_sliced():
    """48-row batches over 32-row panes: a batch spans two panes and
    folds the whole batch under each pane's mask, so every fold launches
    one pass a pane over the same columns; the window's report equals the
    hand fold of those masks."""
    rng = np.random.default_rng(8)
    log = IngestLog()
    for _ in range(4):
        log.append(rng.normal(size=(48, 1)).astype(np.float32))
    window = SlidingWindow(Var(), 64, 32)
    s = LiveSession(log, window, B=B, key=KEY, device="cpu")
    s.poll()
    rep = s.report()
    assert (rep.window_start, rep.window_end, rep.panes_live) == \
        (128, 192, 2)
    stat, base = window.stat, seed_from_key(KEY)
    panes = {}
    for sq in range(4):
        xb = torch.from_numpy(log.store.read_split(sq))
        for p in range(sq * 48 // 32, (sq * 48 + 47) // 32 + 1):
            m = torch.zeros(48)
            lo, hi = max(p * 32, sq * 48) - sq * 48, \
                min((p + 1) * 32, sq * 48 + 48) - sq * 48
            m[lo:hi] = 1.0
            st, est = panes.get(p, (stat.init_batch(1, B),
                                    stat.init_state(1)))
            panes[p] = (stat.merge(st, fused_resample_states(
                stat, offset_seed(base, sq), xb, B, valid_mask=m)),
                stat.update(est, xb, m))
    states = stat.merge(panes[4][0], panes[5][0])
    _bitwise(rep.thetas, stat.finalize_batch(states))


def test_window_tracks_the_slide_and_the_bound():
    log = _fill_log(Mean(), n=8)
    s = LiveSession(log, SlidingWindow(Mean(), 128, 32), B=B, key=KEY,
                    device="cpu")
    reports = s.poll()
    assert s.memory_bound == 4
    assert all(r.panes_live <= 4 and r.window_end - r.window_start <= 128
               for r in reports)
    assert (reports[-1].window_start, reports[-1].window_end) == (128, 256)
    np.testing.assert_allclose(reports[-1].estimate.numpy(),
                               log.store.read_all()[128:].mean(axis=0),
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["Mean", "Var", "Grouped"])
def test_cumulative_session_is_the_streaming_bootstrap(name):
    """A cumulative session over the log is ``bootstrap_streaming`` over
    the log's store with chunk = the batch size, bitwise."""
    stat = STATS[name]()
    log = _fill_log(stat)
    s = LiveSession(log, stat, B=B, key=KEY, device="cpu")
    s.poll()
    rep = s.report()
    ref = bootstrap_streaming(log.store, stat, B, KEY, chunk=ROWS,
                              device="cpu")
    _bitwise(rep.thetas, ref.thetas)
    _bitwise(rep.estimate, ref.estimate)


def test_windowed_kmeans_folds_the_bootstrap_over_kmeans():
    """A windowed KMeansStep folds through its fused path (kernel 8's
    plain version here) and re-merges its panes: the window's centroids
    are the hand fold's."""
    cent = torch.tensor([[-1.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    stat = KMeansStep(cent)
    log = _fill_log(Mean(), n=5)
    s = LiveSession(log, TumblingWindow(stat, 64), B=B, key=KEY,
                    device="cpu")
    s.poll()
    rep = s.report()
    base = seed_from_key(KEY)
    states = stat.init_batch(2, B)
    xb = torch.from_numpy(log.store.read_split(4))
    states = stat.merge(states, fused_resample_states(
        stat, offset_seed(base, 4), xb, B, valid_mask=torch.ones(ROWS)))
    _bitwise(rep.thetas, stat.finalize_batch(states))


class TestBackpressure:
    def test_append_blocks_then_raises(self):
        log = IngestLog(capacity=2)
        s = LiveSession(log, Mean(), B=B, key=KEY, device="cpu")
        log.append(_batch_data(Mean(), 0))
        log.append(_batch_data(Mean(), 1))
        with pytest.raises(BackpressureError, match="backlog"):
            log.append(_batch_data(Mean(), 2), timeout=0.05)
        s.poll()                             # folds and acks both batches
        assert log.append(_batch_data(Mean(), 2), timeout=0.05) == 2

    def test_unregistered_log_never_gates(self):
        log = IngestLog(capacity=1)
        for i in range(5):
            log.append(_batch_data(Mean(), i), timeout=0.01)
        assert log.next_seq == 5

    def test_capacity_validation(self):
        with pytest.raises(ValueError, match="capacity"):
            IngestLog(capacity=0)


def test_live_session_signature_follows_the_jax_order():
    import inspect
    want = [p for p in inspect.signature(JLive.__init__).parameters
            if p != "self"]
    got = [p for p in inspect.signature(LiveSession.__init__).parameters
           if p != "self"]
    assert got == want + ["device"]


def test_without_a_device_a_session_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LiveSession(IngestLog(), Mean(), B=B, key=KEY)


def test_a_fold_stages_the_batch_once(monkeypatch):
    """One host-to-device copy a fold, whatever the panes it spans: the
    batch and its pane masks travel in one buffer."""
    log = IngestLog()
    log.append(np.ones((48, 2), np.float32))
    s = LiveSession(log, SlidingWindow(Mean(), 64, 32), B=B, key=KEY,
                    device="cpu")
    staged, stage = [], s._stage
    monkeypatch.setattr(s, "_stage", lambda xb, masks: (
        staged.append(len(masks)), stage(xb, masks))[1])
    s.poll()
    assert staged == [2]
    copies, to = [], torch.Tensor.to

    def counting(self, *a, **kw):
        copies.append(tuple(self.shape))
        return to(self, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "to", counting)
    xd, md = stage(np.ones((48, 2), np.float32),
                   [np.ones(48, np.float32), np.zeros(48, np.float32)])
    assert copies == [(96 + 32 + 2 * 48,)]
    assert xd.shape == (48, 2) and md.shape == (2, 48)
    assert float(md[0].sum()) == 48 and float(md[1].sum()) == 0
