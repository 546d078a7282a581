"""The port's crash-safe streaming bootstrap against the JAX package and
against its own oracle.

Inputs are made with numpy from a seed and handed to both packages.  On
the CPU the port runs each kernel's plain version, and the JAX package
resolves to its scan lowering, so:

* the port's ``bootstrap_streaming`` is bitwise its own
  ``bootstrap_chunked(store.read_all(), ..., backend="fused_rng")`` (the
  contract the card holds too, in chip_smoke.py);
* against the JAX package's ``bootstrap_streaming`` w_tot (``Count``)
  and histogram medians are bitwise, k-means centroids agree within
  1e-5·max|x|, and moment thetas within
  1e-5·Σw|x|/Σw (f32 dots in another order; Σw|x|/Σw is the streamed Mean
  of |x| under the same weights);
* a run killed at any chunk boundary and resumed is bitwise the port's
  uninterrupted run, and within the tolerance above of the JAX package's.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reduce_api as jra
from repro.core.streaming import bootstrap_streaming as j_streaming
from repro.data.store import ShardedStore as JStore
from repro_torch import random as trandom
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import reduce_api as tra
from repro_torch.core.bootstrap import bootstrap_chunked
from repro_torch.core.reduce_api import split_params
from repro_torch.core.streaming import (bootstrap_streaming,
                                        run_fingerprint,
                                        store_content_digest)
from repro_torch.data.store import ReadStats, ShardedStore

torch.set_num_threads(1)

SEED = 5
CHUNK = 3000                  # n = 10,000: a ragged 1,000-row tail
N_PIN = 9500                  # the pinned extent ends mid-split
B = 16
LO, HI, NBINS = -4.0, 4.0, 64
CENT = np.random.default_rng(2).normal(size=(4, 3)).astype(np.float32)


def _data(n=10_000, d=3, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _store(data, split_size=1234):
    return ShardedStore.from_array(data, split_size, interleave=False)


def _run(store, stat, **kw):
    kw.setdefault("chunk", CHUNK)
    return bootstrap_streaming(store, stat, B, trandom.PRNGKey(SEED),
                               device="cpu", **kw)


def _leaves(t):
    return list(t) if isinstance(t, tuple) else [t]


def _bitwise(a, b):
    for u, v in zip(_leaves(a), _leaves(b)):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


class _Kill(Exception):
    """The simulated mid-run death."""


class _DyingManager(CheckpointManager):
    """Commits its first ``die_after`` saves, then kills the run: a
    deterministic stand-in for SIGKILL at a chunk boundary."""

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


# name -> (port statistic, JAX statistic)
PAIRS = {
    "Mean": (lambda: tra.Mean(), lambda: jra.Mean()),
    "Count": (lambda: tra.Count(), lambda: jra.Count()),
    "Quantile": (lambda: tra.Quantile(0.5, NBINS, LO, HI),
                 lambda: jra.Quantile(0.5, NBINS, LO, HI)),
    "Quantile_block_bins": (
        lambda: tra.Quantile(0.5, NBINS, LO, HI, block_bins=128),
        lambda: jra.Quantile(0.5, NBINS, LO, HI, block_bins=128)),
    "StatisticGroup": (
        lambda: tra.StatisticGroup((tra.Mean(),
                                    tra.Quantile(0.25, 32, LO, HI))),
        lambda: jra.StatisticGroup((jra.Mean(),
                                    jra.Quantile(0.25, 32, LO, HI)))),
    "KMeansStep": (lambda: tra.KMeansStep(torch.from_numpy(CENT)),
                   lambda: jra.KMeansStep(jnp.asarray(CENT))),
}


# which result leaves are moments (within the dot-error bound); the others
# (w_tot, medians) are bitwise across packages
MOMENT_LEAVES = {"Mean": (True,), "Count": (False,), "Quantile": (False,),
                 "Quantile_block_bins": (False,),
                 "StatisticGroup": (True, False)}


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def abs_mean(data):
    """Σw|x|/Σw per resample and column, pinned and not: the streamed Mean
    of |x| under the same weights."""
    a = _store(np.abs(data))
    return {pin: _run(a, tra.Mean(), n_rows=pin).thetas.numpy()
            for pin in (None, N_PIN)}


@pytest.mark.parametrize("pin", [None, N_PIN], ids=["full", "pinned"])
@pytest.mark.parametrize("name", list(PAIRS))
def test_streaming_matches_jax(name, pin, data, abs_mean):
    tstat, jstat = (f() for f in PAIRS[name])
    got = _run(_store(data), tstat, n_rows=pin)
    want = j_streaming(JStore.from_array(data, 1234, interleave=False),
                       jstat, B, jax.random.PRNGKey(SEED), chunk=CHUNK,
                       n_rows=pin)
    assert got.n == want.n == (pin or len(data))
    bound = 1e-5 * abs_mean[pin]
    if name == "KMeansStep":
        # centroids = sums / counts: counts bitwise in the plain versions,
        # so a centroid is within 1e-5·max|x| (sums within 1e-5·Σw|x|)
        np.testing.assert_allclose(got.thetas.numpy(),
                                   np.asarray(want.thetas), rtol=0,
                                   atol=1e-5 * float(np.abs(data).max()))
        return
    for g, w, moment in zip(_leaves(got.thetas), _leaves(want.thetas),
                            MOMENT_LEAVES[name]):
        g, w = g.numpy(), np.asarray(w)
        if moment:
            assert np.all(np.abs(g - w) <= bound.reshape(g.shape))
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("pin", [None, N_PIN], ids=["full", "pinned"])
@pytest.mark.parametrize("name", list(PAIRS) + ["Var", "Grouped"])
def test_streaming_bitwise_chunked(name, pin, data):
    """The port's own oracle: ``bootstrap_chunked`` over the rows read."""
    stat = (tra.Var() if name == "Var" else
            tra.GroupedStatistic(tra.Mean(), 4) if name == "Grouped" else
            PAIRS[name][0]())
    if name == "Grouped":
        data = np.concatenate(
            [data[:, :2], (np.arange(len(data)) % 4)[:, None]], axis=1
        ).astype(np.float32)
    store = _store(data)
    got = _run(store, stat, n_rows=pin)
    want = bootstrap_chunked(store.read_all()[:pin], stat, B,
                             trandom.PRNGKey(SEED), chunk=CHUNK,
                             backend="fused_rng", device="cpu")
    _bitwise(got.thetas, want.thetas)
    _bitwise(got.estimate, want.estimate)
    assert got.n == want.n


def test_1d_values_and_chunk_equal_to_n():
    store = ShardedStore.from_array(_data(4096, 1)[:, 0], 1000,
                                    interleave=False)
    got = _run(store, tra.Mean(), chunk=4096)
    want = bootstrap_chunked(store.read_all(), tra.Mean(), B,
                             trandom.PRNGKey(SEED), chunk=4096,
                             backend="fused_rng", device="cpu")
    _bitwise(got.thetas, want.thetas)


def test_stream_report_and_one_pass_over_the_store(data):
    store = _store(data)
    store.stats.reset()
    r = _run(store, tra.Mean())
    sr = r.stream
    assert sr.n_chunks == 4 and sr.rows == len(data)
    assert sr.wall_s > 0 and sr.dispatch_s >= 0 and sr.wait_s >= 0
    assert sr.stage_s >= 0 and sr.faults is None and sr.lost_splits == ()
    assert store.stats.splits_opened == len(store.splits)
    assert store.stats.rows_read == store.N


# ---------------------------------------------------------------------------
# kill and resume
# ---------------------------------------------------------------------------
KILL_N, KILL_CHUNK = 1000, 256   # chunks [256, 256, 256, 232]
KILL_STATS = {
    "Mean": lambda: tra.Mean(),
    "Var": lambda: tra.Var(),
    "Quantile": lambda: tra.Quantile(0.5, NBINS, LO, HI, block_bins=16),
    "KMeansStep": lambda: tra.KMeansStep(torch.from_numpy(CENT[:3, :2])),
    "StatisticGroup": lambda: tra.StatisticGroup(
        (tra.Mean(), tra.Quantile(0.25, 32, LO, HI))),
    "Grouped": lambda: tra.GroupedStatistic(tra.Mean(), 4),
}


def _kill_store(stat):
    x = _data(KILL_N, 2, seed=1)
    if getattr(stat, "num_groups", None) is not None:
        keys = np.random.default_rng(2).integers(0, 4, size=(KILL_N, 1))
        x = np.concatenate([x, keys], axis=1).astype(np.float32)
    return ShardedStore.from_array(x, 137, interleave=False)


@pytest.mark.parametrize("die_after", range(1, 5))
@pytest.mark.parametrize("name", list(KILL_STATS))
def test_kill_resume_bitwise_at_every_chunk_boundary(name, die_after,
                                                     tmp_path):
    stat = KILL_STATS[name]()
    store = _kill_store(stat)
    base = _run(store, stat, chunk=KILL_CHUNK)
    assert base.stream.n_chunks == 4
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, stat, chunk=KILL_CHUNK,
             checkpoint=_DyingManager(root, die_after))
    r = _run(store, stat, chunk=KILL_CHUNK, resume=True,
             checkpoint=CheckpointManager(root, async_save=False))
    assert r.stream.resumed_from_chunk == die_after
    assert r.stream.n_chunks == 4 - die_after
    _bitwise(base.thetas, r.thetas)
    _bitwise(base.estimate, r.estimate)
    assert base.n == r.n


def test_resumed_run_matches_jax_uninterrupted_run(tmp_path):
    x = _data(KILL_N, 2, seed=1)
    store = ShardedStore.from_array(x, 137, interleave=False)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, tra.Mean(), chunk=KILL_CHUNK,
             checkpoint=_DyingManager(root, 2, async_save=True))
    r = _run(store, tra.Mean(), chunk=KILL_CHUNK, resume=True,
             checkpoint=CheckpointManager(root))
    want = j_streaming(JStore.from_array(x, 137, interleave=False),
                       jra.Mean(), B, jax.random.PRNGKey(SEED),
                       chunk=KILL_CHUNK)
    bound = 1e-5 * _run(ShardedStore.from_array(np.abs(x), 137,
                                                interleave=False),
                        tra.Mean(), chunk=KILL_CHUNK).thetas.numpy()
    assert np.all(np.abs(r.thetas.numpy() - np.asarray(want.thetas))
                  <= bound)
    assert r.n == want.n


def test_resume_onto_other_queue_depth_and_ragged_tail(tmp_path):
    """The cursor pins the math; the queue depth is mechanics.  A kill
    before the ragged last chunk resumes mid-split and re-reads only the
    rows past the cursor."""
    store = _kill_store(tra.Mean())
    base = _run(store, tra.Mean(), chunk=KILL_CHUNK, queue_depth=2)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, tra.Mean(), chunk=KILL_CHUNK, queue_depth=2,
             checkpoint=_DyingManager(root, 3))
    store.stats.reset()
    r = _run(store, tra.Mean(), chunk=KILL_CHUNK, queue_depth=5,
             resume=True,
             checkpoint=CheckpointManager(root, async_save=False))
    _bitwise(base.thetas, r.thetas)
    assert store.stats.rows_read < store.N


def test_checkpointing_is_an_observer(tmp_path):
    store = _kill_store(tra.Var())
    base = _run(store, tra.Var(), chunk=KILL_CHUNK)
    r = _run(store, tra.Var(), chunk=KILL_CHUNK,
             checkpoint=str(tmp_path / "ckpt"), checkpoint_every=2)
    _bitwise(base.thetas, r.thetas)
    _bitwise(base.estimate, r.estimate)
    assert r.stream.n_checkpoints == 2


# ---------------------------------------------------------------------------
# resume validation and fingerprints
# ---------------------------------------------------------------------------
def _ckpt(root):
    return CheckpointManager(root, async_save=False)


def test_fingerprint_rejects_other_statistic_and_knobs(tmp_path):
    store = _kill_store(tra.Mean())
    root = str(tmp_path / "ckpt")
    _run(store, tra.Mean(), chunk=KILL_CHUNK, checkpoint=_ckpt(root))
    for stat, kw in ((tra.Var(), {}), (tra.Mean(), dict(chunk=128)),
                     (tra.Mean(), dict(n_rows=900))):
        kw.setdefault("chunk", KILL_CHUNK)
        with pytest.raises(ValueError, match="fingerprint mismatch"):
            _run(store, stat, resume=True, checkpoint=_ckpt(root), **kw)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        bootstrap_streaming(store, tra.Mean(), B, trandom.PRNGKey(8),
                            chunk=KILL_CHUNK, resume=True,
                            checkpoint=_ckpt(root), device="cpu")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        bootstrap_streaming(store, tra.Mean(), 8, trandom.PRNGKey(SEED),
                            chunk=KILL_CHUNK, resume=True,
                            checkpoint=_ckpt(root), device="cpu")


def test_fingerprint_binds_tensor_params(tmp_path):
    rng = np.random.default_rng(3)
    c1, c2 = (torch.from_numpy(rng.normal(size=(3, 2)).astype(np.float32))
              for _ in range(2))
    store = _kill_store(tra.Mean())
    root = str(tmp_path / "ckpt")
    _run(store, tra.KMeansStep(c1), chunk=KILL_CHUNK, checkpoint=_ckpt(root))
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _run(store, tra.KMeansStep(c2), chunk=KILL_CHUNK, resume=True,
             checkpoint=_ckpt(root))
    spec, params = split_params(tra.StatisticGroup((tra.Mean(),
                                                    tra.KMeansStep(c1))))
    assert list(params) == [".members[1].centroids", ".slots[1].centroids"]
    assert run_fingerprint(spec, params, 1) == run_fingerprint(
        *split_params(tra.StatisticGroup((tra.Mean(),
                                          tra.KMeansStep(c1.clone())))), 1)


def test_fingerprint_content_and_digest(tmp_path):
    x = _data(KILL_N, 2, seed=1)
    store = ShardedStore.from_array(x, 137, interleave=False)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, tra.Mean(), chunk=KILL_CHUNK, fingerprint_content=True,
             checkpoint=_DyingManager(root, 2))
    changed = x.copy()
    changed[500, 0] += 1.0
    bad = ShardedStore.from_array(changed, 137, interleave=False)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        _run(bad, tra.Mean(), chunk=KILL_CHUNK, resume=True,
             fingerprint_content=True, checkpoint=_ckpt(root))
    base = _run(store, tra.Mean(), chunk=KILL_CHUNK)
    r = _run(ShardedStore.from_array(x.copy(), 137, interleave=False),
             tra.Mean(), chunk=KILL_CHUNK, resume=True,
             fingerprint_content=True, checkpoint=_ckpt(root))
    _bitwise(base.thetas, r.thetas)
    # the digest is the JAX package's, bit for bit
    from repro.core.streaming import store_content_digest as j_digest
    for upto in (None, 500):
        assert store_content_digest(store, upto) == j_digest(
            JStore.from_array(x, 137, interleave=False), upto)
    assert store_content_digest(store) != store_content_digest(bad)


def test_default_fingerprint_binds_shape_not_content(tmp_path):
    x = _data(KILL_N, 2, seed=2)
    store = ShardedStore.from_array(x, 137, interleave=False)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, tra.Mean(), chunk=KILL_CHUNK,
             checkpoint=_DyingManager(root, 2))
    changed = x.copy()
    changed[0, 0] += 1.0
    r = _run(ShardedStore.from_array(changed, 137, interleave=False),
             tra.Mean(), chunk=KILL_CHUNK, resume=True,
             checkpoint=_ckpt(root))
    assert r.stream.resumed_from_chunk == 2


def test_pinned_resume_over_a_grown_store(tmp_path):
    rng = np.random.default_rng(9)
    splits = [rng.normal(size=(250, 2)).astype(np.float32)
              for _ in range(6)]
    n_rows = 250 * 4
    base = _run(ShardedStore([s.copy() for s in splits[:4]]), tra.Mean(),
                chunk=KILL_CHUNK)
    store = ShardedStore([s.copy() for s in splits[:4]])
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, tra.Mean(), chunk=KILL_CHUNK, n_rows=n_rows,
             fingerprint_content=True, checkpoint=_DyingManager(root, 2))
    for s in splits[4:]:
        store.append_split(s.copy())
    r = _run(store, tra.Mean(), chunk=KILL_CHUNK, n_rows=n_rows,
             resume=True, fingerprint_content=True, checkpoint=_ckpt(root))
    assert r.stream.resumed_from_chunk == 2
    _bitwise(base.thetas, r.thetas)
    assert base.n == r.n == n_rows


def test_foreign_checkpoint_and_resume_without_checkpoint(tmp_path):
    store = _kill_store(tra.Mean())
    with pytest.raises(ValueError, match="resume"):
        _run(store, tra.Mean(), resume=True)
    mgr = _ckpt(str(tmp_path / "ckpt"))
    stat = tra.Mean()
    mgr.save(0, (stat.init_batch(2, B), stat.init_state(2)),
             extra={"note": "foreign"})
    with pytest.raises(ValueError, match="cursor"):
        _run(store, tra.Mean(), chunk=KILL_CHUNK, resume=True,
             checkpoint=mgr)


# ---------------------------------------------------------------------------
# validation and the producer thread
# ---------------------------------------------------------------------------
class _Unmergeable(tra.Mean):
    mergeable = False


def test_validation_errors():
    store = _kill_store(tra.Mean())
    cases = [
        (dict(backend=None), "fused_rng"),
        (dict(queue_depth=0), "queue_depth"),
        (dict(checkpoint_every=0), "checkpoint_every"),
    ] + [(dict(n_rows=bad), "n_rows") for bad in (0, -1, KILL_N + 1)]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            _run(store, tra.Mean(), **kw)
    with pytest.raises(ValueError, match="non-empty"):
        _run(ShardedStore([]), tra.Mean())
    with pytest.raises(ValueError, match="mergeable"):
        _run(store, _Unmergeable())
    with pytest.raises(ValueError, match="mergeable"):
        _run(store, tra.StatisticGroup((tra.Mean(), _Unmergeable())))
    with pytest.raises(TypeError, match="Statistic"):
        _run(store, object())


def _prefetch_threads():
    return [t for t in threading.enumerate()
            if t.name == "earl-stream-prefetch" and t.is_alive()]


def test_store_error_propagates_from_prefetch_thread():
    store = _kill_store(tra.Mean())

    def boom(i):
        raise OSError("split unreadable")

    store.read_split = boom
    with pytest.raises(OSError, match="split unreadable"):
        _run(store, tra.Mean(), chunk=64)
    assert not _prefetch_threads()


def test_poisoned_chunk_does_not_leak_the_producer():
    rng = np.random.default_rng(3)
    splits = [rng.normal(size=(64, 3)).astype(np.float32)
              for _ in range(8)]
    splits[1] = rng.normal(size=(64, 2)).astype(np.float32)
    assert not _prefetch_threads()
    with pytest.raises(Exception):
        _run(ShardedStore(splits), tra.Mean(), chunk=64, queue_depth=2)
    assert not _prefetch_threads()


def test_read_stats_under_threads():
    """More threads than cores and a short switch interval: a lost update
    of the counters' read-modify-write would show."""
    import sys
    stats = ReadStats()

    def hammer():
        for _ in range(5000):
            stats.add(splits=1, rows=3)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=hammer, daemon=True)
              for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert (stats.splits_opened, stats.rows_read) == (80_000, 240_000)


def test_pinned_run_equals_the_prefix_store():
    data = _data(300, 2, seed=5)
    r_pin = _run(ShardedStore.from_array(data, 128, interleave=False),
                 tra.Mean(), chunk=64, n_rows=200)
    r_ref = _run(ShardedStore.from_array(data[:200], 128, interleave=False),
                 tra.Mean(), chunk=64)
    _bitwise(r_pin.thetas, r_ref.thetas)
    assert r_pin.n == 200 and r_pin.stream.rows == 200


def test_streaming_defaults_to_the_card():
    """Without ``device=`` the run goes to the card, so with no card it
    raises before reading a row."""
    store = _kill_store(tra.Mean())
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs it")
    store.stats.reset()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bootstrap_streaming(store, tra.Mean(), B, trandom.PRNGKey(0))
    assert store.stats.rows_read == 0


def test_resume_with_a_fresh_group_instance(tmp_path):
    """The fingerprint binds the statistic's structure, not its identity:
    an equal StatisticGroup built anew (as a restarted process builds it)
    resumes, bitwise.  (The JAX package's fingerprint of a group includes
    its members' object addresses, so there two equal groups differ.)"""
    def group():
        return tra.StatisticGroup((tra.Mean(),
                                   tra.Quantile(0.25, 32, LO, HI)))
    store = _kill_store(tra.Mean())
    base = _run(store, group(), chunk=KILL_CHUNK)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(store, group(), chunk=KILL_CHUNK,
             checkpoint=_DyingManager(root, 2))
    r = _run(store, group(), chunk=KILL_CHUNK, resume=True,
             checkpoint=_ckpt(root))
    assert r.stream.resumed_from_chunk == 2
    _bitwise(base.thetas, r.thetas)
