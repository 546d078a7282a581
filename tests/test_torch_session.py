"""The port's EarlSession and bootstrap against the JAX package on the CPU.

Both packages run the quickstart's group session and a Mean() session over
the same 200k synthetic rows, sampler seed and key: they must take the same
B, rows and iterations, the histogram-derived median bitwise, and the moment
estimates, cvs and CIs within f32 rounding.  Also: the port imports neither
jax nor the JAX package, and an entry point asked for no device raises on a
machine without a card.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import EarlSession as JSession
from repro.core import Mean as JMean
from repro.core import Quantile as JQuantile
from repro.core import StatisticGroup as JGroup
from repro.core import Std as JStd
from repro.core import bootstrap as j_bootstrap
from repro.data.sampler import PreMapSampler as JPreMap
from repro.data.store import ShardedStore as JStore
from repro.data.synthetic import synthetic_numeric as j_synthetic
from repro_torch import random as trandom
from repro_torch.core import (EarlSession, Mean, Quantile, StatisticGroup,
                              Std, bootstrap, poisson_delta_init)
from repro_torch.data import PreMapSampler, ShardedStore, synthetic_numeric
from repro_torch.kernels.poisson_counts.ops import poisson_counts

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 200_000
# f32 sums in another order move a moment estimate by a few ulps and a cv
# by a few parts in 1e5; a CI end moves with the thetas it interpolates.
# Std is sqrt(E[x²] - E[x]²): the cancellation scales its relative error
# by E[x²] / Var[x] (26 for mean 10, std 2).
EST_RTOL, CV_RTOL, CI_RTOL = 1e-5, 1e-3, 1e-5
STD_SCALE = (10.0 ** 2 + 2.0 ** 2) / 2.0 ** 2


def _j_group():
    return JGroup((JMean(), JQuantile(0.5, lo=0.0, hi=25.0), JStd()))


def _t_group():
    return StatisticGroup((Mean(), Quantile(0.5, lo=0.0, hi=25.0), Std()))


def _first(v):
    return float(np.asarray(v).reshape(-1)[0])


def test_synthetic_data_is_the_reference_data():
    np.testing.assert_array_equal(j_synthetic(1000, seed=3),
                                  synthetic_numeric(1000, seed=3))


@pytest.mark.parametrize("kind", ["group", "mean"])
def test_session_matches_jax(kind):
    data = synthetic_numeric(N, mean=10.0, std=2.0, seed=0)
    jstat = _j_group() if kind == "group" else JMean()
    tstat = _t_group() if kind == "group" else Mean()
    jstore = JStore.from_array(data, split_size=65_536)
    tstore = ShardedStore.from_array(data, split_size=65_536)
    want = JSession(JPreMap(jstore, seed=1), jstat, sigma=0.05,
                    backend="fused_rng").run(jax.random.PRNGKey(0))
    got = EarlSession(PreMapSampler(tstore, seed=1, device="cpu"), tstat,
                      sigma=0.05, backend="fused_rng",
                      device="cpu").run(trandom.PRNGKey(0))

    assert (got.B, got.n_used, got.iterations, got.fell_back) == \
        (want.B, want.n_used, want.iterations, want.fell_back)
    assert tstore.stats.rows_read == jstore.stats.rows_read
    assert got.ssabe.n == want.ssabe.n
    assert [b for b, _ in got.ssabe.cv_history_B] == \
        [b for b, _ in want.ssabe.cv_history_B]
    np.testing.assert_allclose(got.cv, want.cv, rtol=CV_RTOL)
    if kind == "group":
        names = ("mean", "median", "std")
        results = zip(names, got.result, want.result, got.reports,
                      want.reports)
    else:
        results = [("mean", got.result, want.result, None, None)]
        np.testing.assert_allclose(_first(got.ci_lo), _first(want.ci_lo),
                                   rtol=CI_RTOL)
        np.testing.assert_allclose(_first(got.ci_hi), _first(want.ci_hi),
                                   rtol=CI_RTOL)
    for name, g, w, grep, wrep in results:
        scale = STD_SCALE if name == "std" else 1.0
        if name == "median":
            assert _first(g) == _first(w)
        else:
            np.testing.assert_allclose(_first(g), _first(w),
                                       rtol=EST_RTOL * scale)
        if grep is not None:
            np.testing.assert_allclose(grep.cv, wrep.cv, rtol=CV_RTOL)
            np.testing.assert_allclose(_first(grep.ci_lo),
                                       _first(wrep.ci_lo),
                                       rtol=CI_RTOL * scale)
            np.testing.assert_allclose(_first(grep.ci_hi),
                                       _first(wrep.ci_hi),
                                       rtol=CI_RTOL * scale)


def test_one_shot_bootstrap_matches_jax():
    x = synthetic_numeric(5000, seed=4)
    want = j_bootstrap(x, _j_group(), 40, jax.random.PRNGKey(9),
                       backend="fused_rng")
    got = bootstrap(x, _t_group(), 40, trandom.PRNGKey(9),
                    backend="fused_rng", device="cpu")
    assert (got.B, got.n) == (want.B, want.n)
    jt, tt = want.thetas, got.thetas
    np.testing.assert_array_equal(np.asarray(jt[1]), tt[1].numpy())
    for i, scale in ((0, 1.0), (2, STD_SCALE)):
        np.testing.assert_allclose(tt[i].numpy(), np.asarray(jt[i]),
                                   rtol=EST_RTOL * scale)
        np.testing.assert_allclose(_first(got.estimate[i]),
                                   _first(want.estimate[i]),
                                   rtol=EST_RTOL * scale)
    assert _first(got.estimate[1]) == _first(want.estimate[1])
    np.testing.assert_allclose(got.report.cvs, want.report.cvs, rtol=CV_RTOL)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ,
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def _no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["session", "sampler", "bootstrap",
                                   "delta", "poisson_counts"])
def test_entry_points_without_a_device_raise_on_a_cardless_machine(
        monkeypatch, entry):
    _no_card(monkeypatch)
    store = ShardedStore.from_array(np.ones((100, 1), np.float32), 10)
    calls = {
        "session": lambda: EarlSession(PreMapSampler(store, device="cpu"),
                                       Mean()),
        "sampler": lambda: PreMapSampler(store),
        "bootstrap": lambda: bootstrap(np.ones(10, np.float32), Mean(), 4,
                                       trandom.PRNGKey(0)),
        "delta": lambda: poisson_delta_init(Mean(), 4, 1, trandom.PRNGKey(0)),
        "poisson_counts": lambda: poisson_counts(1, 4, 10),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_exact_job_fallback_matches_jax():
    """When the predicted sample reaches max_fraction·N the session runs
    the exact job instead."""
    data = synthetic_numeric(3000, mean=10.0, std=2.0, seed=2)
    jstore = JStore.from_array(data, split_size=512)
    tstore = ShardedStore.from_array(data, split_size=512)
    want = JSession(JPreMap(jstore, seed=3), JMean(), sigma=0.05,
                    max_fraction=0.01,
                    backend="fused_rng").run(jax.random.PRNGKey(1))
    got = EarlSession(PreMapSampler(tstore, seed=3, device="cpu"), Mean(),
                      sigma=0.05, max_fraction=0.01, backend="fused_rng",
                      device="cpu").run(trandom.PRNGKey(1))
    assert want.fell_back and got.fell_back
    assert (got.n_used, got.B, got.iterations, got.cv) == \
        (want.n_used, want.B, want.iterations, want.cv)
    np.testing.assert_allclose(_first(got.result), _first(want.result),
                               rtol=EST_RTOL)
