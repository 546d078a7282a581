"""Carrying a JAX run across into the port (repro_torch.interop).

Two delta extends run in the JAX package; their state, key and step cross
into the port as numpy copies; a third extend then runs in each package and
the two must agree: histogram counts, w_tot and median thetas bitwise,
moments within f32 rounding.  A store's splits cross the same way.
"""
import jax
import numpy as np
import torch

from repro.core import Mean as JMean
from repro.core import Quantile as JQuantile
from repro.core import StatisticGroup as JGroup
from repro.core import Std as JStd
from repro.core.delta import poisson_delta_extend as j_extend
from repro.core.delta import poisson_delta_init as j_init
from repro.core.delta import poisson_delta_result as j_result
from repro.data.store import ShardedStore as JStore
from repro_torch import interop
from repro_torch.core import (Mean, Quantile, StatisticGroup, Std,
                              poisson_delta_extend, poisson_delta_result)
from repro_torch.data import PreMapSampler

torch.set_num_threads(1)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_delta_run_continues_in_the_port():
    rng = np.random.default_rng(21)
    parts = [rng.normal(10.0, 2.0, size=(m, 1)).astype(np.float32)
             for m in (700, 1300, 2100)]
    jstat = JGroup((JMean(), JQuantile(0.5, lo=0.0, hi=25.0), JStd()))
    tstat = StatisticGroup((Mean(), Quantile(0.5, lo=0.0, hi=25.0), Std()))
    pd = j_init(jstat, 24, 1, jax.random.PRNGKey(4), backend="fused_rng")
    for p in parts[:2]:
        pd = j_extend(pd, p)

    tpd = interop.poisson_delta_from_numpy(
        tstat, pd.B, _numpy(pd.states), _numpy(pd.est_state),
        np.asarray(pd.key), pd.n, pd.step, backend="fused_rng",
        device="cpu")
    pd = j_extend(pd, parts[2])
    tpd = poisson_delta_extend(tpd, torch.from_numpy(parts[2]))
    assert (tpd.n, tpd.step) == (pd.n, pd.step)

    jm, jh = pd.states
    tm, th = tpd.states
    np.testing.assert_array_equal(np.asarray(jh.counts), th.counts.numpy())
    np.testing.assert_array_equal(np.asarray(jm.w), tm.w.numpy())
    np.testing.assert_allclose(tm.s1.numpy(), np.asarray(jm.s1), rtol=1e-6)
    np.testing.assert_allclose(tm.s2.numpy(), np.asarray(jm.s2), rtol=1e-6)

    want = j_result(pd, p=0.5)
    got = poisson_delta_result(tpd, p=0.5)
    np.testing.assert_array_equal(np.asarray(want.thetas[1]),
                                  got.thetas[1].numpy())
    # Std = sqrt(E[x²] - E[x]²) scales the moments' rounding by
    # E[x²] / Var[x] = 26 for this data
    for i, rtol in ((0, 1e-5), (2, 26e-5)):
        np.testing.assert_allclose(got.thetas[i].numpy(),
                                   np.asarray(want.thetas[i]), rtol=rtol)
    np.testing.assert_allclose(got.report.cvs, want.report.cvs, rtol=1e-3)


def test_key_and_single_states_cross():
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    np.testing.assert_array_equal(interop.key_from_numpy(np.asarray(key))
                                  .numpy(), np.asarray(key))
    st = JMean().init_state(2)
    ts = interop.state_from_numpy(_numpy(st), device="cpu")
    assert ts.s1.shape == (2,) and ts.w.shape == ()


def test_store_splits_cross_and_sample_the_same_rows():
    data = np.arange(1000, dtype=np.float32).reshape(-1, 1)
    jstore = JStore.from_array(data, split_size=64)
    tstore = interop.store_from_splits(jstore.splits)
    assert tstore.N == jstore.N
    rows = PreMapSampler(tstore, seed=1, device="cpu").take(10, 200)
    from repro.data.sampler import PreMapSampler as JPreMap
    want = np.asarray(JPreMap(jstore, seed=1).take(10, 200))
    np.testing.assert_array_equal(rows.numpy(), want)
