"""The port's EarlSession checkpoint and resume against its own
uninterrupted run and against the JAX package's runs, on the CPU.

The session runs over the quickstart's data law at 200,000 rows and
σ = 0.002, a shape where it grows its sample over several rounds (at
σ = 0.01 on these rows it falls back to the exact job and never saves).
A run killed right after a save and resumed is bitwise the port's
uninterrupted run: result, cv, CI, n_used, iterations and history.
Against the JAX package's uninterrupted and resumed runs, B, n_used and
iterations are equal and the results agree as tests/test_torch_session.py
holds them: the histogram median bitwise, moment estimates within 1e-5
relative (f32 sums in another order), Std's scaled by E[x²]/Var[x] = 26,
and cv within 1e-3 relative.
"""
import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import EarlSession as JSession
from repro.core import Mean as JMean
from repro.core import Quantile as JQuantile
from repro.core import StatisticGroup as JGroup
from repro.core import Std as JStd
from repro.data.sampler import PreMapSampler as JPreMap
from repro.data.store import ShardedStore as JStore
from repro_torch import random as trandom
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (EarlSession, Mean, Quantile, StatisticGroup,
                              Std, Var)
from repro_torch.core import session as session_mod
from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric

torch.set_num_threads(1)

N, SIGMA, SEED = 200_000, 0.002, 0
EST_RTOL, CV_RTOL = 1e-5, 1e-3
STD_SCALE = (10.0 ** 2 + 2.0 ** 2) / 2.0 ** 2


class _Kill(Exception):
    """The simulated crash."""


def _dying(base):
    class Dying(base):
        """Commits its first ``die_after`` saves, then kills the run."""

        def __init__(self, root, die_after):
            super().__init__(root, async_save=False)
            self.die_after, self.saves = die_after, 0

        def save(self, *a, **kw):
            super().save(*a, **kw)
            self.saves += 1
            if self.saves >= self.die_after:
                raise _Kill(f"simulated crash after save #{self.saves}")

    return Dying


_TDying, _JDying = _dying(CheckpointManager), _dying(JManager)


@pytest.fixture(scope="module")
def data():
    return synthetic_numeric(N, mean=10.0, std=2.0, seed=0)


STATS = {
    "mean": (lambda: Mean(), lambda: JMean()),
    "group": (lambda: StatisticGroup((Mean(), Quantile(0.5, lo=0.0, hi=25.0),
                                      Std())),
              lambda: JGroup((JMean(), JQuantile(0.5, lo=0.0, hi=25.0),
                              JStd()))),
}


def _session(data, name, checkpoint=None, stat=None, **kw):
    store = ShardedStore.from_array(data, split_size=65_536)
    return EarlSession(PreMapSampler(store, seed=1, device="cpu"),
                       stat or STATS[name][0](), sigma=SIGMA,
                       backend="fused_rng", checkpoint=checkpoint,
                       device="cpu", **kw), store


def _jsession(data, jstat, checkpoint=None):
    store = JStore.from_array(data, split_size=65_536)
    return JSession(JPreMap(store, seed=1), jstat, sigma=SIGMA,
                    backend="fused_rng", checkpoint=checkpoint)


def _leaves(t):
    return list(t) if isinstance(t, tuple) else [t]


def _bitwise(a, b):
    for u, v in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


def _same_run(got, want):
    """Bitwise: the resume contract."""
    assert (got.B, got.n_used, got.iterations, got.fell_back) == \
        (want.B, want.n_used, want.iterations, want.fell_back)
    assert got.cv == want.cv
    _bitwise(got.result, want.result)
    _bitwise(got.ci_lo, want.ci_lo)
    _bitwise(got.ci_hi, want.ci_hi)
    assert [(e["iteration"], e["n"], e["B"], e["cv"],
             e.get("member_cvs")) for e in got.history] == \
        [(e["iteration"], e["n"], e["B"], e["cv"], e.get("member_cvs"))
         for e in want.history]


_BASE = {}


def _base(data, name):
    if name not in _BASE:
        _BASE[name] = _session(data, name)[0].run(trandom.PRNGKey(SEED))
    return _BASE[name]


@pytest.mark.parametrize("die_after", [1, 3])
@pytest.mark.parametrize("name", list(STATS))
def test_kill_after_a_save_resumes_bitwise(data, name, die_after, tmp_path):
    base = _base(data, name)
    assert not base.fell_back and base.iterations > die_after
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _session(data, name, _TDying(root, die_after))[0].run(
            trandom.PRNGKey(SEED))
    got = _session(data, name, CheckpointManager(root, async_save=False)
                   )[0].run(trandom.PRNGKey(SEED), resume=True)
    _same_run(got, base)


def _close_to_jax(got, want, name):
    assert (got.B, got.n_used, got.iterations, got.fell_back) == \
        (want.B, want.n_used, want.iterations, want.fell_back)
    np.testing.assert_allclose(got.cv, want.cv, rtol=CV_RTOL)
    members = ("mean", "median", "std") if name == "group" else ("mean",)
    for m, g, w in zip(members, _leaves(got.result), _leaves(want.result)):
        g, w = float(np.asarray(g).reshape(-1)[0]), \
            float(np.asarray(w).reshape(-1)[0])
        if m == "median":
            assert g == w
        else:
            np.testing.assert_allclose(
                g, w, rtol=EST_RTOL * (STD_SCALE if m == "std" else 1.0))


@pytest.mark.parametrize("name", list(STATS))
def test_resumed_run_matches_the_jax_packages_runs(data, name, tmp_path):
    """The port's resumed run against the JAX package's uninterrupted run
    and its resumed run, which is sound at this shape.  The JAX package's
    fingerprint of a group holds its members' object addresses, so its
    killed and resumed runs share one statistic instance."""
    key = jax.random.PRNGKey(SEED)
    jstat = STATS[name][1]()
    j_base = _jsession(data, jstat).run(key)
    jroot = str(tmp_path / "jax")
    with pytest.raises(_Kill):
        _jsession(data, jstat, _JDying(jroot, 1)).run(key)
    j_resumed = _jsession(data, jstat, JManager(jroot, async_save=False)).run(
        key, resume=True)
    root = str(tmp_path / "port")
    with pytest.raises(_Kill):
        _session(data, name, _TDying(root, 1))[0].run(trandom.PRNGKey(SEED))
    got = _session(data, name, CheckpointManager(root, async_save=False)
                   )[0].run(trandom.PRNGKey(SEED), resume=True)
    _close_to_jax(got, j_base, name)
    _close_to_jax(got, j_resumed, name)
    assert len(got.history) == len(j_base.history) == len(j_resumed.history)


def test_resume_after_a_completed_run_rederives_without_extending(
        data, tmp_path, monkeypatch):
    root = str(tmp_path / "ckpt")
    full = _session(data, "mean", CheckpointManager(root, async_save=False)
                    )[0].run(trandom.PRNGKey(SEED))
    extends = []
    orig = session_mod.poisson_delta_extend
    monkeypatch.setattr(session_mod, "poisson_delta_extend",
                        lambda *a: (extends.append(1), orig(*a))[1])
    s, store = _session(data, "mean", CheckpointManager(root,
                                                        async_save=False))
    again = s.run(trandom.PRNGKey(SEED), resume=True)
    assert extends == []
    _same_run(again, full)
    # only the capped pilot is read again, not the main sample
    assert store.stats.rows_read < full.n_used


def test_checkpointing_is_an_observer_and_a_path_works(data, tmp_path):
    base = _base(data, "mean")
    s, _ = _session(data, "mean", str(tmp_path / "ckpt"), checkpoint_every=2)
    got = s.run(trandom.PRNGKey(SEED))
    _same_run(got, base)
    steps = CheckpointManager(str(tmp_path / "ckpt")).steps()
    assert steps == [i for i in range(2, base.iterations + 1, 2)]
    meta = CheckpointManager(str(tmp_path / "ckpt")).meta()["cursor"]
    assert meta["kind"] == "session" and meta["iterations"] == steps[-1]
    assert set(meta) == {"kind", "fingerprint", "n_have", "step",
                         "iterations", "n_target_next", "history"}


def test_the_group_cursor_keeps_member_cvs(data, tmp_path):
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _session(data, "group", _TDying(root, 2))[0].run(
            trandom.PRNGKey(SEED))
    hist = CheckpointManager(root).meta()["cursor"]["history"]
    assert len(hist) == 2 and all(len(e["member_cvs"]) == 3 for e in hist)


def test_the_fingerprint_rejects_another_statistic(data, tmp_path):
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _session(data, "mean", _TDying(root, 1))[0].run(
            trandom.PRNGKey(SEED))
    s, _ = _session(data, "mean", CheckpointManager(root, async_save=False),
                    stat=Var())
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        s.run(trandom.PRNGKey(SEED), resume=True)


def test_resume_validation(data, tmp_path):
    with pytest.raises(ValueError, match="resume"):
        _session(data, "mean")[0].run(trandom.PRNGKey(SEED), resume=True)
    with pytest.raises(ValueError, match="checkpoint_every"):
        _session(data, "mean", str(tmp_path), checkpoint_every=0)
    mgr = CheckpointManager(str(tmp_path / "foreign"), async_save=False)
    mgr.save(0, {"weights": torch.zeros(3)}, extra={"cursor": {
        "kind": "live"}})
    with pytest.raises(ValueError, match="not an EarlSession checkpoint"):
        _session(data, "mean", mgr)[0].run(trandom.PRNGKey(SEED),
                                           resume=True)
