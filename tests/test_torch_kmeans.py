"""The port's k-means path against the JAX package on the CPU.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs ``backend="scan"`` (and the jnp path for ``update``).  On
the CPU the port runs the plain versions, the arithmetic the CUDA kernels
are held to on the card (tests/test_torch_cuda.py, chip_smoke.py).

Tolerances:

* counts bitwise: they are sums of whole weights, exact in any order, and
  both packages put each point in the same cluster;
* sums within 1e-5·Σw|x| per entry (Σ over all points of the row, per
  dim) and inertia within 1e-5·Σw·min-d²: f32 contractions in another
  order;
* centroids after Lloyd and bootstrap thetas, which are sums / counts,
  within 1e-5 of the data's largest |x| (the sums' bound over a count).

Boundary points: XLA's dot and the port's elementwise d² can differ in the
last bit, so a point within a few ulps of a cluster boundary could land in
another cluster in the two packages.  ``_ambiguous`` finds, in float64,
the points whose two smallest d² differ by less than 1e-5·(xx + cc); the
tests assert there are none on their data, so every assignment is the
same and counts must be bitwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import KMeansStep as JKMeansStep
from repro.core import bootstrap as j_bootstrap
from repro.core import kmeans_fit as j_kmeans_fit
from repro.core.delta import poisson_delta_extend as j_extend
from repro.core.delta import poisson_delta_init as j_init
from repro.core.delta import poisson_delta_result as j_result
from repro.data.sampler import PreMapSampler as JPreMap
from repro.data.store import ShardedStore as JStore
from repro.data.synthetic import synthetic_clusters as j_clusters
from repro.kernels.kmeans_assign import ops as jka
from repro.kernels.kmeans_assign.ref import kmeans_assign_ref as j_ref
from repro.kernels.weighted_stats import ops as jws
from repro_torch import interop
from repro_torch import random as trandom
from repro_torch.core import (KMeansStep, Mean, Quantile, StatisticGroup,
                              bootstrap, kmeans_fit, poisson_delta_extend,
                              poisson_delta_init, poisson_delta_result)
from repro_torch.data import PreMapSampler, ShardedStore, synthetic_clusters
from repro_torch.kernels.fused_multi import ops as tfm
from repro_torch.kernels.kmeans_assign import ops as tka
from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_ref
from repro_torch.kernels.weighted_stats.ops import prepare, tile_scan

torch.set_num_threads(1)

# (n, k, d): d = 1, the example's k = 5, d = 2 with a ragged n past one
# 512-row tile, and a wide k = 16, d = 8.
ASSIGN_SHAPES = [(37, 3, 1), (1300, 5, 2), (700, 4, 3), (600, 16, 8)]
# (B, n, k, d): B < 8, B = 100 (a non-power-of-two RNG tile), B > 128.
FUSED_SHAPES = [(3, 37, 3, 1), (24, 900, 5, 2), (100, 700, 4, 3),
                (130, 300, 16, 8)]
MASKS = ["none", "n_valid", "holes"]


def _data(n, k, d, seed=0):
    """Gaussian blobs and centroids near their true centers."""
    x, centers = synthetic_clusters(n, k=k, dim=d, seed=seed + 10 * k + d)
    rng = np.random.default_rng(seed)
    cent = (centers + rng.normal(0, 0.1, centers.shape)).astype(np.float32)
    return x, cent


def _d2_64(x, cent):
    xd, cd = np.asarray(x, np.float64), np.asarray(cent, np.float64)
    return ((xd[:, None, :] - cd[None]) ** 2).sum(-1)


def _ambiguous(x, cent):
    """Points whose two nearest centroids are within 1e-5·(xx + cc)."""
    d2 = _d2_64(x, cent)
    if d2.shape[1] < 2:
        return np.zeros(len(x), bool)
    two = np.sort(d2, axis=1)[:, :2]
    xd, cd = np.asarray(x, np.float64), np.asarray(cent, np.float64)
    scale = (xd * xd).sum(1) + (cd * cd).sum(1)[d2.argmin(1)]
    return two[:, 1] - two[:, 0] < 1e-5 * scale


def _assert_state(got, want, x, w, cent):
    """got/want = (sums, counts, inertia), with a leading batch axis when
    w is (B, n); w are the explicit float64 weights."""
    got = [np.asarray(g) for g in got]
    want = [np.asarray(v) for v in want]
    assert not _ambiguous(x, cent).any()
    np.testing.assert_array_equal(got[1], want[1])
    xd = np.asarray(x, np.float64)
    bound = (w @ np.abs(xd))[..., None, :]            # (.., 1, d)
    assert got[0].shape == want[0].shape
    assert np.all(np.abs(got[0] - want[0]) <= 1e-5 * bound + 1e-30)
    ib = w @ _d2_64(x, cent).min(1)
    assert np.all(np.abs(got[2] - want[2]) <= 1e-5 * ib + 1e-30)


def _explicit_weights(seed, B, n, n_valid, mask):
    w = np.asarray(jws.implicit_weights(seed, B, n), np.float64)
    if n_valid is not None:
        w[:, n_valid:] = 0.0
    if mask is not None:
        w = w * mask[None, :]
    return w


def test_synthetic_clusters_are_the_reference_data():
    for a, b in zip(j_clusters(500, k=4, dim=3, seed=2),
                    synthetic_clusters(500, k=4, dim=3, seed=2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,k", [(10, 3), (8000, 5), (400_000, 5)])
def test_default_init_draws_the_reference_rows(n, k):
    key = jax.random.PRNGKey(n)
    want = np.asarray(jax.random.choice(key, n, (k,), replace=False))
    got = trandom.permutation(trandom.PRNGKey(n), n, device="cpu")[:k].numpy()
    np.testing.assert_array_equal(want, got)


@pytest.mark.parametrize("n,k,d", ASSIGN_SHAPES)
def test_assign_plain_matches_jax_scan_and_ref(n, k, d):
    x, cent = _data(n, k, d)
    w = np.random.default_rng(n).integers(0, 4, n).astype(np.float32)
    got = tka.kmeans_assign(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(cent))
    for want in (jka.kmeans_assign(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(cent), backend="scan"),
                 j_ref(x, w, cent),
                 kmeans_assign_ref(x, w, cent)):
        _assert_state(got, want, x, w.astype(np.float64), cent)


def test_ties_go_to_the_lowest_cluster():
    # (0, y) is exactly equidistant from (1, 0) and (-1, 0)
    x = np.array([[0.0, 0.5], [0.0, -2.0], [0.9, 0.0]], np.float32)
    cent = np.array([[-1.0, 0.0], [1.0, 0.0]], np.float32)
    w = np.ones(3, np.float32)
    sums, counts, _ = tka.kmeans_assign(torch.from_numpy(x),
                                        torch.from_numpy(w),
                                        torch.from_numpy(cent))
    np.testing.assert_array_equal(counts.numpy(), [2.0, 1.0])
    want = jka.kmeans_assign(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(cent), backend="scan")
    np.testing.assert_array_equal(np.asarray(want[1]), counts.numpy())
    np.testing.assert_array_equal(np.asarray(want[0]), sums.numpy())


@pytest.mark.parametrize("backend", [None, "scan"])
def test_update_matches_jax(backend):
    x, cent = _data(1000, 5, 2, seed=3)
    w = np.random.default_rng(3).integers(0, 3, 1000).astype(np.float32)
    js = JKMeansStep(jnp.asarray(cent), backend=backend)
    want = js.update(js.update(js.init_state(2), x[:600], w[:600]),
                     x[600:], w[600:])
    ts = KMeansStep(torch.from_numpy(cent))
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    got = ts.update(ts.update(ts.init_state(2), xt[:600], wt[:600]),
                    xt[600:], wt[600:])
    _assert_state((got.sums, got.counts, got.inertia),
                  (want.sums, want.counts, want.inertia), x,
                  w.astype(np.float64), cent)
    np.testing.assert_allclose(ts.finalize_inertia(got).numpy(),
                               np.asarray(js.finalize_inertia(want)),
                               rtol=1e-5)


@pytest.mark.parametrize("mask_kind", MASKS)
@pytest.mark.parametrize("B,n,k,d", FUSED_SHAPES)
def test_fused_kmeans_plain_matches_jax(B, n, k, d, mask_kind):
    x, cent = _data(n, k, d, seed=B)
    rng = np.random.default_rng(B + n)
    seed = int(rng.integers(0, 2 ** 31 - 1))
    n_valid = n - 5 if mask_kind == "n_valid" else None
    mask = ((rng.random(n) > 0.3).astype(np.float32)
            if mask_kind == "holes" else None)
    want = jka.fused_poisson_kmeans(
        seed, jnp.asarray(x), jnp.asarray(cent), B, backend="scan",
        n_valid=n_valid, valid_mask=None if mask is None else
        jnp.asarray(mask))
    got = tka.fused_poisson_kmeans(
        seed, torch.from_numpy(x), torch.from_numpy(cent), B,
        n_valid=n_valid,
        valid_mask=None if mask is None else torch.from_numpy(mask))
    _assert_state(got, want, x, _explicit_weights(seed, B, n, n_valid, mask),
                  cent)


def test_tile_update_is_the_fused_plain_tile_math():
    B, n, k, d, seed = 24, 1300, 5, 2, 17
    x, cent = _data(n, k, d, seed=1)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    step = KMeansStep(ct)
    pr = prepare(xt, B)
    states = [step.init_batch(d, pr.Bp)]
    states[0] = type(states[0])(*(a.double() for a in (
        states[0].sums, states[0].counts, states[0].inertia)))

    def consume(w, x_tile):
        states[0] = step.tile_update(states[0], x_tile, w)

    tile_scan(pr, seed, consume)
    plain = tka.fused_kmeans_plain(pr, seed, ct)
    for a, b in zip((states[0].sums, states[0].counts, states[0].inertia),
                    plain):
        assert torch.equal(a.float(), b)
    # one tile against the JAX package's tile_update
    w = np.array(jws.implicit_weights(seed, B, 512), np.float32)
    js = JKMeansStep(jnp.asarray(cent))
    zeros = jax.tree_util.tree_map(
        lambda a: jnp.zeros((B,) + a.shape, a.dtype), js.init_state(d))
    want = js.tile_update(zeros, jnp.asarray(x[:512]), jnp.asarray(w))
    got = step.tile_update(step.init_batch(d, B), xt[:512],
                           torch.from_numpy(w))
    _assert_state((got.sums, got.counts, got.inertia),
                  (want.sums, want.counts, want.inertia), x[:512],
                  w.astype(np.float64), cent)


@pytest.mark.parametrize("mask_kind", ["none", "holes"])
def test_group_member_is_its_dedicated_run(mask_kind):
    B, n, k, d, seed = 24, 900, 5, 2, 5
    x, cent = _data(n, k, d, seed=2)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cent)
    mask = None
    if mask_kind == "holes":
        mask = torch.from_numpy(
            (np.random.default_rng(1).random(n) > 0.3).astype(np.float32))
    group = StatisticGroup((Mean(), KMeansStep(ct),
                            Quantile(0.5, nbins=64, lo=-6.0, hi=6.0)))
    got = tfm.fused_poisson_multi(group, seed, xt, B, valid_mask=mask)
    ded = tka.fused_poisson_kmeans(seed, xt, ct, B, valid_mask=mask)
    for a, b in zip((got[1].sums, got[1].counts, got[1].inertia), ded):
        assert torch.equal(a, b)


def test_kmeans_fit_matches_jax():
    x, cent = _data(4000, 5, 2, seed=4)
    w = np.random.default_rng(4).integers(1, 3, 4000).astype(np.float32)
    for weights in (None, w):
        want_c, want_i = j_kmeans_fit(jnp.asarray(x), 5, 8,
                                      jax.random.PRNGKey(0),
                                      weights=None if weights is None
                                      else jnp.asarray(weights),
                                      init=jnp.asarray(cent),
                                      backend="scan")
        got_c, got_i = kmeans_fit(
            torch.from_numpy(x), 5, 8, trandom.PRNGKey(0),
            weights=None if weights is None else torch.from_numpy(weights),
            init=torch.from_numpy(cent), device="cpu")
        assert not _ambiguous(x, got_c.numpy()).any()
        atol = 1e-5 * np.abs(x).max()
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(float(got_i), float(want_i), rtol=1e-5)
    # the default init draws the reference's rows
    want_c, _ = j_kmeans_fit(jnp.asarray(x), 5, 3, jax.random.PRNGKey(7),
                             backend="scan")
    got_c, _ = kmeans_fit(torch.from_numpy(x), 5, 3, trandom.PRNGKey(7),
                          device="cpu")
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), rtol=0,
                               atol=1e-5 * np.abs(x).max())


def test_example_bootstrap_matches_jax():
    """examples/analytics_kmeans.py at N = 40,000: both Lloyd fits, then
    the bootstrap certificate at B = 24 over the 2% sample."""
    N, K, ITERS, B = 40_000, 5, 8, 24
    x_np, _ = j_clusters(N, k=K, dim=2, seed=5)
    n = N // 50
    jxs = JPreMap(JStore.from_array(x_np, 65_536), seed=6).take(0, n)
    txs = PreMapSampler(ShardedStore.from_array(x_np, 65_536), seed=6,
                        device="cpu").take(0, n)
    np.testing.assert_array_equal(np.asarray(jxs), txs.numpy())
    atol = 1e-5 * np.abs(x_np).max()
    for values_j, values_t in ((jnp.asarray(x_np), torch.from_numpy(x_np)),
                               (jxs, txs)):
        jc, _ = j_kmeans_fit(values_j, K, ITERS, jax.random.PRNGKey(0),
                             init=jxs[:K], backend="scan")
        tc, _ = kmeans_fit(values_t, K, ITERS, trandom.PRNGKey(0),
                           init=txs[:K], device="cpu")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=atol)
    # both bootstraps over the same centroids (the port's fit)
    want = j_bootstrap(jxs, JKMeansStep(jnp.asarray(tc.numpy())), B=B,
                       key=jax.random.PRNGKey(0), backend="fused_rng")
    got = bootstrap(txs, KMeansStep(tc), B, trandom.PRNGKey(0),
                    backend="fused_rng", device="cpu")
    assert not _ambiguous(txs.numpy(), tc.numpy()).any()
    assert got.thetas.shape == (B, K, 2)
    np.testing.assert_allclose(got.thetas.numpy(), np.asarray(want.thetas),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(got.estimate.numpy(),
                               np.asarray(want.estimate), rtol=0, atol=atol)
    np.testing.assert_allclose(got.cv, want.cv, rtol=1e-3)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_delta_run_matches_and_continues_from_jax():
    x, cent = _data(3000, 5, 2, seed=8)
    parts = [x[:700], x[700:1900], x[1900:]]
    jstat, tstat = JKMeansStep(jnp.asarray(cent)), KMeansStep(
        torch.from_numpy(cent))
    jpd = j_init(jstat, 16, 2, jax.random.PRNGKey(4), backend="fused_rng")
    tpd = poisson_delta_init(tstat, 16, 2, trandom.PRNGKey(4),
                             backend="fused_rng", device="cpu")
    for p in parts[:2]:
        jpd = j_extend(jpd, p)
        tpd = poisson_delta_extend(tpd, torch.from_numpy(p))
    # the JAX run's state crosses into the port and both extend once more
    cpd = interop.poisson_delta_from_numpy(
        tstat, jpd.B, _numpy(jpd.states), _numpy(jpd.est_state),
        np.asarray(jpd.key), jpd.n, jpd.step, backend="fused_rng",
        device="cpu")
    jpd = j_extend(jpd, parts[2])
    tpd = poisson_delta_extend(tpd, torch.from_numpy(parts[2]))
    cpd = poisson_delta_extend(cpd, torch.from_numpy(parts[2]))
    assert (tpd.n, tpd.step) == (cpd.n, cpd.step) == (jpd.n, jpd.step)
    w = np.concatenate([_explicit_weights(
        trandom_seed(jpd.key, i), 16, len(p), None, None)
        for i, p in enumerate(parts)], axis=1)
    want = (jpd.states.sums, jpd.states.counts, jpd.states.inertia)
    for pd in (tpd, cpd):
        assert isinstance(pd.states, type(tstat.init_state(2)))
        _assert_state((pd.states.sums, pd.states.counts, pd.states.inertia),
                      want, x, w, cent)
        res, jres = poisson_delta_result(pd), j_result(jpd)
        np.testing.assert_allclose(res.thetas.numpy(),
                                   np.asarray(jres.thetas), rtol=0,
                                   atol=1e-5 * np.abs(x).max())


def trandom_seed(key, step):
    from repro_torch.core.bootstrap import offset_seed, seed_from_key
    return offset_seed(seed_from_key(np.asarray(key, np.uint32)), step)


def test_kmeans_state_crosses():
    js = JKMeansStep(jnp.ones((3, 2))).init_state(2)
    ts = interop.state_from_numpy(_numpy(js), device="cpu")
    assert type(ts).__name__ == "KMeansState"
    assert ts.sums.shape == (3, 2) and ts.counts.shape == (3,)
    assert ts.inertia.shape == ()


def test_kmeans_fit_without_a_device_raises_on_a_cardless_machine(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kmeans_fit(np.ones((10, 2), np.float32), 2, 1, trandom.PRNGKey(0),
                   init=np.zeros((2, 2), np.float32))
