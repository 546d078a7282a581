"""The port's checkpointing and fault tolerance against the JAX package.

* ``CheckpointManager``: atomic commits, keep-k and orphan GC, concurrent
  managers under one root, ENOSPC and torn writes, and a snapshot taken
  before an asynchronous save returns (the carry may be folded in place
  right after).
* ``FaultyStore``/``ResilientStore``: each fault kind detected, counted,
  retried, raised or degraded; the seeded fault plan and delivery plan
  equal to the JAX package's for the same seed (host NumPy in both).
* Streaming under faults: transient faults absorbed bitwise, a split lost
  mid-run bitwise equal to a fold with the lost rows masked out (the
  port's ``bootstrap_chunked`` chunk update under the same holes), and
  the JAX package's degraded run within the moments' dot-error bound.
"""
import errno
import os
import subprocess
import time
import zlib

import jax
import numpy as np
import pytest
import torch

from repro.core import Mean as JMean
from repro.core.streaming import bootstrap_streaming as j_streaming
from repro.data.store import ShardedStore as JStore
from repro.ft import inject as jinject
from repro_torch import random as trandom
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import STALE_TMP_S
from repro_torch.core import reduce_api as tra
from repro_torch.core.bootstrap import (fused_resample_states, offset_seed,
                                        seed_from_key)
from repro_torch.core.reduce_api import MomentState
from repro_torch.core.streaming import bootstrap_streaming
from repro_torch.data.store import ShardedStore
from repro_torch.ft import (CONTINUE, RESTART, FailurePolicy, Fault,
                            FaultCounters, FaultExhaustedError, FaultyStore,
                            LagPolicy, ResilientStore, RetryPolicy,
                            ShardEvents, bit_flip, enospc_after, torn_write)

from test_torch_streaming import _DyingManager, _Kill

torch.set_num_threads(1)

SEED, B, CHUNK = 3, 16, 256


def _data(n=1000, d=2, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(
        np.float32)


def _store(n=1000, d=2, split_size=137, seed=0):
    return ShardedStore.from_array(_data(n, d, seed), split_size,
                                   interleave=False)


def _run(store, stat=None, **kw):
    return bootstrap_streaming(store, stat or tra.Mean(), B,
                               trandom.PRNGKey(SEED), chunk=CHUNK,
                               device="cpu", **kw)


def _bitwise(a, b):
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


# ---------------------------------------------------------------------------
# CheckpointManager
# ---------------------------------------------------------------------------
def _state(v=1.0):
    return {"w": torch.full((4,), float(v)),
            "m": MomentState(w=torch.tensor(7.0), s1=torch.arange(3.0),
                             s2=torch.ones(3))}


def test_checkpoint_roundtrip_onto_template_device_and_dtype(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    state = _state(2.5)
    mgr.save(7, state, extra={"pipeline": {"epoch": 1, "step": 40}})
    template = {"w": torch.zeros(4, dtype=torch.float64),
                "m": MomentState(w=torch.zeros(()), s1=torch.zeros(3),
                                 s2=torch.zeros(3))}
    got, extra = mgr.restore(template)
    assert extra == {"pipeline": {"epoch": 1, "step": 40}}
    assert got["w"].dtype == torch.float64 and got["m"].w.shape == ()
    assert torch.equal(got["w"], state["w"].double())
    assert torch.equal(got["m"].s1, state["m"].s1)
    assert mgr.meta() == extra
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.zeros(5), "m": template["m"]})
    with pytest.raises(KeyError, match="missing"):
        mgr.restore({"v": torch.zeros(4), "m": template["m"]})


def test_async_save_snapshots_before_returning(tmp_path):
    """The streaming carry may be folded in place right after a save: the
    checkpoint holds the values at ``save`` time."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    state = _state(1.0)
    mgr.save(1, state)
    state["w"].add_(100.0)
    state["m"].s1.mul_(0.0)
    mgr.wait()
    got, _ = mgr.restore(_state(0.0))
    assert torch.equal(got["w"], torch.full((4,), 1.0))
    assert torch.equal(got["m"].s1, torch.arange(3.0))


def test_keep_last_atomicity_and_lifecycle(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2, async_save=True)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    mgr.close()
    mgr.close()                          # idempotent
    assert mgr.steps() == [3, 4] and mgr.latest_step() == 4
    assert not [d for d in os.listdir(tmp_path) if d.startswith(".tmp")]
    with CheckpointManager(str(tmp_path / "ctx")) as m2:
        m2.save(5, _state())
    assert m2.steps() == [5]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(_state())


def test_steps_skip_malformed_entries(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(2, _state())
    (tmp_path / "ckpt_old").mkdir()
    (tmp_path / "ckpt_00000009").write_text("not a dir")
    (tmp_path / "notes.txt").write_text("x")
    assert mgr.steps() == [2]


def test_orphan_gc(tmp_path):
    """Dead writers' staging dirs and commit backups go; a live peer's
    in-flight staging dir stays unless it is older than STALE_TMP_S (a
    recycled pid); an absurd pid suffix is swept, not fatal."""
    proc = subprocess.Popen(["sleep", "0"])
    proc.wait()
    dead = tmp_path / f".tmp_ckpt_00000001.{proc.pid}"
    backup = tmp_path / f"ckpt_00000001.old.{proc.pid}"
    bogus = tmp_path / ".tmp_ckpt_00000001.99999999999999999999"
    live = tmp_path / f".tmp_ckpt_00000002.{os.getpid()}"
    stale = tmp_path / f".tmp_ckpt_00000003.{os.getpid()}"
    for p in (dead, backup, bogus, live, stale):
        p.mkdir()
    old = time.time() - STALE_TMP_S - 60.0
    os.utime(stale, (old, old))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert [p.exists() for p in (dead, backup, bogus, live, stale)] == [
        False, False, False, True, False]
    assert mgr.steps() == []


def test_concurrent_managers_under_one_root(tmp_path):
    a = CheckpointManager.for_run(str(tmp_path), "a" * 64, keep_last=1,
                                  async_save=False)
    b = CheckpointManager.for_run(str(tmp_path), "b" * 64, keep_last=1,
                                  async_save=False)
    assert a.root != b.root
    for s in (1, 2, 3):
        a.save(s, _state(s))
    b.save(1, _state(10.0))
    assert a.steps() == [3] and b.steps() == [1]
    again = CheckpointManager.for_run(str(tmp_path), "a" * 64)
    assert again.root == a.root and again.latest_step() == 3


def test_crash_mid_swap_keeps_the_old_snapshot(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state(1.0))
    mgr.save(1, _state(2.0))             # same step: commit by swap
    got, _ = mgr.restore(_state(0.0))
    assert float(got["w"][0]) == 2.0
    assert os.listdir(tmp_path) == ["ckpt_00000001"]


@pytest.mark.parametrize("async_save", [False, True])
def test_enospc_save_raises_and_previous_checkpoint_survives(tmp_path,
                                                             async_save):
    mgr = CheckpointManager(str(tmp_path), async_save=async_save)
    mgr.save(1, _state(1.0))
    mgr.wait()
    with enospc_after(100) as budget:
        with pytest.raises(OSError) as e:
            mgr.save(2, _state(2.0))
            mgr.wait()
    assert e.value.errno == errno.ENOSPC and budget["left"] == 0
    assert not [d for d in os.listdir(tmp_path)
                if d.startswith(".tmp_ckpt_")], "staging debris left"
    assert mgr.steps() == [1]
    got, _ = mgr.restore(_state(0.0))
    assert float(got["w"][0]) == 1.0
    mgr.save(3, _state(3.0))             # the manager is not wedged
    mgr.wait()
    assert mgr.latest_step() == 3
    with pytest.raises(ValueError, match="nbytes"):
        with enospc_after(-1):
            pass


def test_torn_and_flipped_checkpoint_files_fail_loudly(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, _state(1.0))
    arrays = tmp_path / "ckpt_00000001" / "arrays.npz"
    meta = tmp_path / "ckpt_00000001" / "meta.json"
    size = os.path.getsize(arrays)
    torn_write(str(arrays), size // 2)
    assert os.path.getsize(arrays) == size // 2
    with pytest.raises(Exception):
        mgr.restore(_state(0.0))
    bit_flip(str(meta), 0, 0xFF)
    with pytest.raises(ValueError):
        mgr.meta()
    with pytest.raises(ValueError, match="keep_bytes"):
        torn_write(str(arrays), size * 4)
    with pytest.raises(ValueError, match="mask"):
        bit_flip(str(meta), 0, 0x100)
    with pytest.raises(ValueError, match="offset"):
        bit_flip(str(meta), 10 ** 6)


# ---------------------------------------------------------------------------
# the injector, against the JAX package's
# ---------------------------------------------------------------------------
def _jstore(n=1000, d=2, split_size=137, seed=0):
    return JStore.from_array(_data(n, d, seed), split_size, interleave=False)


@pytest.mark.parametrize("seed", [0, 5, 6, 123])
def test_seeded_plans_equal_the_jax_package(seed):
    kw = dict(p_io=0.3, p_latency=0.1, p_short=0.1, p_corrupt=0.2,
              attempts=2)
    got = FaultyStore.seeded(_store(), seed=seed, **kw)
    want = jinject.FaultyStore.seeded(_jstore(), seed=seed, **kw)
    assert [dataclass_tuple(f) for f in got.faults] == [
        dataclass_tuple(f) for f in want.faults]
    for p_dup, mr in ((0.0, 0), (0.4, 3), (0.6, 1)):
        tf, jf = FaultyStore(_store()), jinject.FaultyStore(_jstore())
        assert tf.delivery_plan(seed, p_dup, mr) == jf.delivery_plan(
            seed, p_dup, mr)
        assert (tf.injected.duplicates, tf.injected.reordered) == (
            jf.injected.duplicates, jf.injected.reordered)
    assert FaultyStore.seeded(_store(), seed=seed).faults == ()


def dataclass_tuple(f):
    return (f.split, f.kind, f.attempts, f.latency_s, f.permanent)


def test_faulty_store_reads():
    store = _store()
    with pytest.raises(ValueError, match="kind"):
        Fault(split=0, kind="gremlin")
    with pytest.raises(ValueError, match="split"):
        FaultyStore(store, [Fault(split=99, kind="io")])
    fs = FaultyStore(store, [Fault(split=1, kind="io", attempts=2),
                             Fault(split=0, kind="io", permanent=True),
                             Fault(split=2, kind="short"),
                             Fault(split=3, kind="corrupt")])
    for _ in range(2):
        with pytest.raises(IOError):
            fs.read_split(1)
    np.testing.assert_array_equal(fs.read_split(1), store.splits[1])
    for _ in range(3):
        with pytest.raises(IOError):
            fs.read_split(0)
    assert len(fs.read_split(2)) < store.split_sizes[2]
    bad = fs.read_split(3)
    assert zlib.crc32(np.ascontiguousarray(bad).tobytes()) != \
        fs.split_checksum(3), "corruption must not forge the checksum"
    np.testing.assert_array_equal(store.splits[3], fs.inner.splits[3])
    assert fs.injected.io_errors == 5


def test_delivery_plan_properties():
    fs = FaultyStore(_store())
    assert fs.delivery_plan(seed=1) == list(range(len(fs.splits)))
    plan = fs.delivery_plan(seed=2, p_duplicate=0.5, max_reorder=4)
    assert set(plan) == set(range(len(fs.splits)))
    got = list(FaultyStore(_store()).iter_delivery(seed=7, p_duplicate=0.3,
                                                   max_reorder=2))
    assert [s for s, _ in got] == FaultyStore(_store()).delivery_plan(
        seed=7, p_duplicate=0.3, max_reorder=2)
    for s, rows in got:
        np.testing.assert_array_equal(rows, fs.splits[s])
    with pytest.raises(ValueError, match="p_duplicate"):
        fs.delivery_plan(seed=0, p_duplicate=1.5)
    with pytest.raises(ValueError, match="max_reorder"):
        fs.delivery_plan(seed=0, max_reorder=-1)


# ---------------------------------------------------------------------------
# the resilient read path
# ---------------------------------------------------------------------------
def _resilient(faults, **retry):
    store = _store()
    retry.setdefault("base_delay", 0.0)
    return store, ResilientStore(FaultyStore(store, faults),
                                 RetryPolicy(**retry))


@pytest.mark.parametrize("kind,counter", [
    ("io", "io_errors"), ("corrupt", "checksum_failures"),
    ("short", "short_reads")])
def test_transient_faults_retried_to_success(kind, counter):
    store, rs = _resilient([Fault(split=1, kind=kind, attempts=2)],
                           max_attempts=3)
    np.testing.assert_array_equal(rs.read_split(1), store.splits[1])
    assert getattr(rs.counters, counter) == 2
    assert rs.counters.retries == 2


def test_deadlines_and_backoff():
    store, rs = _resilient([Fault(split=1, kind="latency", latency_s=0.05)],
                           max_attempts=3, timeout=0.01)
    np.testing.assert_array_equal(rs.read_split(1), store.splits[1])
    assert rs.counters.deadline_misses >= 1
    # every attempt slow: the final attempt's late data beats losing it
    store, rs = _resilient([Fault(split=1, kind="latency", latency_s=0.02,
                                  permanent=True)],
                           max_attempts=2, timeout=0.001)
    np.testing.assert_array_equal(rs.read_split(1), store.splits[1])
    assert rs.counters.deadline_misses == 2
    p = RetryPolicy(max_attempts=4, base_delay=0.01)
    assert [p.delay(k) for k in (1, 2, 3)] == [0.01, 0.02, 0.04]
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


def test_exhausted_budget_raises_or_degrades():
    _, rs = _resilient([Fault(split=1, kind="io", permanent=True)],
                       max_attempts=3)
    with pytest.raises(FaultExhaustedError, match="split 1"):
        rs.read_split(1)
    store = _store()
    rs = ResilientStore(FaultyStore(store, [Fault(split=2, kind="io",
                                                  permanent=True)]),
                        RetryPolicy(max_attempts=2, base_delay=0.0),
                        on_exhausted="degrade")
    out = rs.read_split(2)
    assert out.shape == store.splits[2].shape and not out.any()
    assert rs.lost_splits == [2] and rs.counters.splits_lost == 1
    assert rs.invalid_row_ranges() == [(int(store.offsets[2]),
                                        int(store.offsets[3]))]
    with pytest.raises(ValueError, match="on_exhausted"):
        ResilientStore(store, RetryPolicy(), on_exhausted="panic")


# ---------------------------------------------------------------------------
# streaming under faults
# ---------------------------------------------------------------------------
def test_transient_faults_within_budget_bitwise_clean():
    store = _store()
    base = _run(store)
    fs = FaultyStore(store, [Fault(split=1, kind="io", attempts=2),
                             Fault(split=3, kind="corrupt"),
                             Fault(split=5, kind="short"),
                             Fault(split=6, kind="latency", latency_s=0.05)])
    r = _run(fs, retry=RetryPolicy(max_attempts=4, base_delay=0.0,
                                   timeout=0.02))
    _bitwise(base.thetas, r.thetas)
    _bitwise(base.estimate, r.estimate)
    f: FaultCounters = r.stream.faults
    assert f.io_errors == fs.injected.io_errors == 2
    assert f.checksum_failures == fs.injected.checksum_failures == 1
    assert f.short_reads == fs.injected.short_reads == 1
    assert f.deadline_misses >= 1
    assert r.stream.lost_splits == ()


def test_exhausted_raise_propagates():
    fs = FaultyStore(_store(), [Fault(split=1, kind="io", permanent=True)])
    with pytest.raises(FaultExhaustedError):
        _run(fs, retry=RetryPolicy(max_attempts=2, base_delay=0.0))


def _masked_fold(data, lost, stat):
    """The oracle: the port's chunk update (``bootstrap_chunked``'s) over
    the data with the lost rows zeroed and masked out, chunk by chunk."""
    data = data.copy()
    for lo, hi in lost:
        data[lo:hi] = 0.0
    n, d = data.shape
    states, est = stat.init_batch(d, B), stat.init_state(d)
    base, valid = seed_from_key(trandom.PRNGKey(SEED)), 0
    for i in range(-(-n // CHUNK)):
        xb = np.zeros((CHUNK, d), np.float32)
        rows = data[i * CHUNK:(i + 1) * CHUNK]
        xb[:len(rows)] = rows
        mask = np.zeros(CHUNK, np.float32)
        mask[:len(rows)] = 1.0
        for lo, hi in lost:
            a, b = max(lo, i * CHUNK) - i * CHUNK, min(hi, i * CHUNK +
                                                       len(rows)) - i * CHUNK
            mask[max(a, 0):max(b, 0)] = 0.0
        valid += int(mask.sum())
        x, m = torch.from_numpy(xb), torch.from_numpy(mask)
        est = stat.update(est, x, m)
        states = stat.merge(states, fused_resample_states(
            stat, offset_seed(base, i), x, B, valid_mask=m))
    p_eff = valid / n
    return (stat.correct(stat.finalize_batch(states), p_eff),
            stat.correct(stat.finalize(est), p_eff), valid)


DEGRADE = FailurePolicy(retry=RetryPolicy(max_attempts=2, base_delay=0.0),
                        on_exhausted="degrade")


@pytest.mark.parametrize("stat", [
    tra.Mean(), tra.Var(), tra.Quantile(0.5, 64, -4.0, 4.0, block_bins=32),
], ids=lambda s: type(s).__name__)
def test_mid_run_shard_loss_matches_the_masked_oracle(stat):
    store = _store()
    fs = FaultyStore(store, [Fault(split=2, kind="io", permanent=True)])
    r = _run(fs, stat, policy=DEGRADE)
    assert r.stream.lost_splits == (2,) and r.stream.faults.splits_lost == 1
    lost = [(int(store.offsets[2]), int(store.offsets[3]))]
    thetas, estimate, valid = _masked_fold(store.read_all(), lost, stat)
    assert r.stream.valid_rows == r.n == valid == store.N - 137
    _bitwise(thetas, r.thetas)
    _bitwise(estimate, r.estimate)


def test_degraded_run_agrees_with_the_jax_package():
    """Moment thetas within 1e-5·Σw|x|/Σw of the survivors (the degraded
    run's Mean of |x|)."""
    from repro.ft import FailurePolicy as JPolicy, RetryPolicy as JRetry
    data = _data()

    def port(x):
        return _run(FaultyStore(ShardedStore.from_array(x, 137,
                                                        interleave=False),
                                [Fault(split=3, kind="io", permanent=True)]),
                    policy=DEGRADE)

    tr = port(data)
    jr = j_streaming(
        jinject.FaultyStore(JStore.from_array(data, 137, interleave=False),
                            [jinject.Fault(split=3, kind="io",
                                           permanent=True)]),
        JMean(), B, jax.random.PRNGKey(SEED), chunk=CHUNK,
        policy=JPolicy(retry=JRetry(max_attempts=2, base_delay=0.0),
                       on_exhausted="degrade"))
    assert tr.stream.lost_splits == tuple(jr.stream.lost_splits) == (3,)
    assert tr.n == jr.n
    bound = 1e-5 * port(np.abs(data)).thetas.numpy()
    assert np.all(np.abs(tr.thetas.numpy() - np.array(jr.thetas)) <= bound)


def test_degraded_run_is_resumable(tmp_path):
    store = _store()

    def faulty():
        return FaultyStore(store, [Fault(split=0, kind="io",
                                         permanent=True)])

    base = _run(faulty(), policy=DEGRADE)
    root = str(tmp_path / "ckpt")
    with pytest.raises(_Kill):
        _run(faulty(), policy=DEGRADE, checkpoint=_DyingManager(root, 2))
    r = _run(faulty(), policy=DEGRADE, resume=True,
             checkpoint=CheckpointManager(root, async_save=False))
    _bitwise(base.thetas, r.thetas)
    assert r.stream.lost_splits == (0,) and r.n == base.n


# ---------------------------------------------------------------------------
# the policies
# ---------------------------------------------------------------------------
def test_policies():
    ev = ShardEvents(n_shards=4, lost=(1,), completion_s=[0.1, 0.2, 5.0,
                                                           0.3])
    assert ev.late(1.0) == (2,) and ev.late(None) == ()
    with pytest.raises(ValueError, match="completion_s"):
        ShardEvents(n_shards=3, completion_s=[0.1]).late(1.0)
    pol = FailurePolicy()
    assert (pol.decide(True), pol.decide(False)) == (CONTINUE, RESTART)
    assert pol.on_exhausted == "raise" and pol.retry.max_attempts == 3
    LagPolicy(max_lag_batches=2, late="fold", shed_backlog=0, p_shed=1.0)
    for kw, match in ((dict(max_lag_batches=0), "max_lag_batches"),
                      (dict(late="keep"), "late"),
                      (dict(shed_backlog=-1), "shed_backlog"),
                      (dict(p_shed=0.0), "p_shed")):
        with pytest.raises(ValueError, match=match):
            LagPolicy(**kw)
