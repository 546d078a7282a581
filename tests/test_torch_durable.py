"""The port's durable ingest (live/segment.py, live/durable_log.py) against
the JAX package on the CPU, and its recovery contracts.

Segments are numpy and file I/O only, so the packages must agree byte for
byte: the port's ``build_segment`` is the JAX package's on the same data,
and a segment (or a whole log directory) written by either package reads
in the other, bitwise.  Recovery holds the JAX package's contracts:
truncating the tail segment at every byte offset recovers the surviving
prefix, bitwise an in-memory ``IngestLog`` fed those batches, and a
``LiveSession`` over it reproduces that log's reports bitwise; a bit flip
anywhere truncates at its segment; a hole truncates after it; one writer
holds the pid lock and a dead one's lock is reclaimed; a tailing consumer
degrades an unreadable segment to a lost split and ``reload`` restores it.
The fsync policy never changes the bytes.

Every test that waits on the writer or syncer threads runs under its own
timeout (``_bounded``).
"""
import functools
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
from repro.live import DurableIngestLog as JDurable
from repro.live import LogLockedError as JLocked
from repro.live import segment as jseg
from repro_torch import random as trandom
from repro_torch.core import Mean
from repro_torch.core.streaming import bootstrap_streaming
from repro_torch.data.store import ShardedStore
from repro_torch.ft import (FailurePolicy, LagPolicy, bit_flip, enospc_after,
                            torn_write)
from repro_torch.live import (CorruptSegmentError, DurableIngestLog,
                              IngestLog, LiveSession, LogLockedError,
                              RecoveryReport, SegmentError, TornSegmentError)
from repro_torch.live import segment as seg

torch.set_num_threads(1)

KEY = trandom.PRNGKey(29)
B = 4
ROWS = 8
DIM = 2
N_BATCHES = 4
TIMEOUT_S = 60.0


def _bounded(test):
    """Run ``test`` on a thread and fail it if it has not finished within
    TIMEOUT_S: a writer or syncer thread that never stops fails the test
    instead of hanging the suite."""

    @functools.wraps(test)
    def run(*a, **kw):
        out = {}

        def body():
            try:
                test(*a, **kw)
            except BaseException as exc:        # noqa: BLE001 — re-raised
                out["exc"] = exc

        t = threading.Thread(target=body, daemon=True)
        t.start()
        t.join(TIMEOUT_S)
        assert not t.is_alive(), f"{test.__name__} ran past {TIMEOUT_S} s"
        if "exc" in out:
            raise out["exc"]

    return run


def _batches(n=N_BATCHES, rows=ROWS, dim=DIM, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((rows, dim)).astype(np.float32)
            for _ in range(n)]


def _mem_log(batches):
    log = IngestLog()
    for b in batches:
        log.append(b)
    return log


def _write_log(root, batches, fsync="never"):
    with DurableIngestLog(root, fsync=fsync) as log:
        for b in batches:
            log.append(b)
        log.flush()


def _assert_store_bitwise(a, b):
    assert len(a.splits) == len(b.splits)
    for i in range(len(a.splits)):
        np.testing.assert_array_equal(np.asarray(a.splits[i]),
                                      np.asarray(b.splits[i]),
                                      err_msg=f"split {i}")
        assert a.split_checksum(i) == b.split_checksum(i)


def _session_reports(log):
    return LiveSession(log, Mean(), B=B, key=KEY, device="cpu").poll()


def _assert_reports_bitwise(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.seq == w.seq and g.p_eff == w.p_eff
        np.testing.assert_array_equal(g.thetas.numpy(), w.thetas.numpy())
        np.testing.assert_array_equal(g.estimate.numpy(),
                                      w.estimate.numpy())


# ---------------------------------------------------------------------------
# the format, against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rows,dim,seq", [(1, 1, 0), (8, 2, 7), (1000, 3, 12),
                                          (300, 64, 2 ** 40)])
def test_segment_bytes_are_the_jax_packages(rows, dim, seq):
    x = np.random.default_rng(rows).standard_normal((rows, dim)).astype(
        np.float32)
    got = seg.build_segment(seq, x)
    assert got == jseg.build_segment(seq, x)
    assert len(got) == (seg.HEADER_SIZE + seg.REC_HEADER_SIZE
                        + rows * dim * 4 + 4 + seg.FOOTER_SIZE)
    assert (seg.HEADER_SIZE, seg.REC_HEADER_SIZE, seg.FOOTER_SIZE) == \
        (28, 24, 24)
    if dim == 1:
        assert seg.build_segment(seq, x[:, 0]) == got


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_segment_cross_read(writer, tmp_path):
    """A segment written by either package reads in the other, bitwise;
    so does its probe."""
    x = _batches(1, rows=37, dim=3)[0]
    write, read = ((seg.write_segment, jseg.read_segment)
                   if writer == "port" else
                   (jseg.write_segment, seg.read_segment))
    path = write(str(tmp_path), 5, x, sync=True)
    assert os.path.basename(path) == "seg_00000005.seg"
    first, dim, recs = read(path, expect_seq=5, expect_dim=3)
    assert (first, dim, len(recs), recs[0][0]) == (5, 3, 1, 5)
    np.testing.assert_array_equal(recs[0][1], x)
    tp, jp = seg.probe_segment(path), jseg.probe_segment(path)
    assert (tp.ok, tp.first_seq, tp.dim, tp.rows) == \
        (jp.ok, jp.first_seq, jp.dim, jp.rows) == (True, 5, 3, 37)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_log_directory_cross_read(writer, tmp_path):
    """A whole log written by either package recovers in the other,
    bitwise the in-memory log fed the same batches."""
    batches = _batches()
    root = str(tmp_path)
    kind = DurableIngestLog if writer == "port" else JDurable
    with kind(root, fsync="batch") as log:
        for b in batches:
            log.append(b)
    reader = (JDurable if writer == "port" else DurableIngestLog)(root)
    try:
        assert reader.recovery.batches == N_BATCHES
        assert reader.recovery.truncated_at is None
        mem = _mem_log(batches)
        assert len(reader.store.splits) == N_BATCHES
        for i in range(N_BATCHES):
            np.testing.assert_array_equal(np.asarray(reader.store.splits[i]),
                                          mem.store.splits[i])
            assert reader.store.split_checksum(i) == \
                mem.store.split_checksum(i)
    finally:
        reader.close()


@pytest.mark.parametrize("damage", ["torn", "flip"])
def test_damage_verdicts_are_the_jax_packages(damage, tmp_path):
    """Every truncation point and every bit position of a small segment
    gets the same verdict (torn or corrupt) and the same message."""
    data = seg.build_segment(3, _batches(1, rows=2, dim=1)[0])
    cases = ([data[:cut] for cut in range(len(data))] if damage == "torn"
             else [data[:i] + bytes([data[i] ^ (1 << b)]) + data[i + 1:]
                   for i in range(len(data)) for b in (0, 5)])
    for buf in cases:
        outcome = []
        for parse, torn, corrupt in (
                (seg.parse_segment, seg.TornSegmentError,
                 seg.CorruptSegmentError),
                (jseg.parse_segment, jseg.TornSegmentError,
                 jseg.CorruptSegmentError)):
            try:
                parse(buf)
                outcome.append(("ok", ""))
            except torn as exc:
                outcome.append(("torn", str(exc)))
            except corrupt as exc:
                outcome.append(("corrupt", str(exc)))
        assert outcome[0] == outcome[1]
        assert outcome[0][0] == ("torn" if damage == "torn" else "corrupt")


def test_segment_round_trip_and_names(tmp_path):
    data = _batches(1)[0]
    path = seg.write_segment(str(tmp_path), 7, data, sync=True)
    first_seq, dim, recs = seg.read_segment(path, expect_seq=7,
                                            expect_dim=DIM)
    assert (first_seq, dim, recs[0][0]) == (7, DIM, 7)
    np.testing.assert_array_equal(recs[0][1], data)
    assert seg.parse_segment_name("seg_00000042.seg") == 42
    for bad in ("seg_.seg", "seg_0001.tmp", "ckpt_0001", "seg_x1.seg"):
        assert seg.parse_segment_name(bad) is None
    with pytest.raises(CorruptSegmentError):
        seg.read_segment(path, expect_seq=8)
    with pytest.raises(CorruptSegmentError):
        seg.read_segment(path, expect_dim=DIM + 1)
    with pytest.raises(ValueError, match="non-empty"):
        seg.build_segment(0, np.zeros((0, 2), np.float32))
    assert issubclass(TornSegmentError, SegmentError)


# ---------------------------------------------------------------------------
# round trips and fsync policies
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fsync", ["never", "batch", "always"])
@_bounded
def test_append_recover_bitwise(fsync, tmp_path):
    batches = _batches()
    root = str(tmp_path / fsync)
    _write_log(root, batches, fsync=fsync)
    mem = _mem_log(batches)
    log = DurableIngestLog(root)
    assert isinstance(log.recovery, RecoveryReport)
    assert (log.recovery.batches, log.recovery.truncated_at) == \
        (N_BATCHES, None)
    assert log.next_seq == N_BATCHES and log.total_rows == mem.total_rows
    _assert_store_bitwise(log.store, mem.store)
    extra = _batches(1, seed=99)[0]
    assert log.append(extra) == N_BATCHES
    log.close()
    mem.append(extra)
    log2 = DurableIngestLog(root)
    _assert_store_bitwise(log2.store, mem.store)
    log2.close()


@_bounded
def test_fsync_policy_does_not_change_bytes(tmp_path):
    batches = _batches()
    blobs = {}
    for fsync in ("never", "batch", "always"):
        root = str(tmp_path / fsync)
        _write_log(root, batches, fsync=fsync)
        blobs[fsync] = [open(os.path.join(root, seg.segment_name(i)),
                             "rb").read() for i in range(N_BATCHES)]
    assert blobs["never"] == blobs["batch"] == blobs["always"]
    assert blobs["batch"] == [jseg.build_segment(i, b)
                              for i, b in enumerate(batches)]


@_bounded
def test_close_stops_both_threads(tmp_path):
    log = DurableIngestLog(str(tmp_path), fsync="batch", group=2)
    for b in _batches(5):
        log.append(b)
    threads = (log._writer, log._syncer)
    log.close()
    assert not any(t.is_alive() for t in threads)
    log.close()                                  # idempotent
    assert not os.path.exists(os.path.join(str(tmp_path), "writer.lock"))


@_bounded
def test_read_paths_work_unchanged_over_a_durable_log(tmp_path):
    batches = _batches()
    _write_log(str(tmp_path), batches)
    log = DurableIngestLog(str(tmp_path))
    r_log = bootstrap_streaming(log.store, Mean(), 16, KEY, chunk=8,
                                device="cpu")
    r_ref = bootstrap_streaming(ShardedStore([np.array(b) for b in batches]),
                                Mean(), 16, KEY, chunk=8, device="cpu")
    np.testing.assert_array_equal(r_log.thetas.numpy(), r_ref.thetas.numpy())
    log.close()


def test_append_copies_the_callers_buffer():
    buf = np.ones((4, 2), np.float32)
    mem = IngestLog()
    mem.append(buf)
    crc0 = mem.store.split_checksum(0)
    buf[:] = 7.0
    np.testing.assert_array_equal(mem.store.splits[0], np.ones((4, 2)))
    assert mem.store.split_checksum(0) == crc0


def test_validation():
    with pytest.raises(ValueError, match="fsync"):
        DurableIngestLog("unused", fsync="sometimes")
    with pytest.raises(ValueError, match="mode"):
        DurableIngestLog("unused", mode="read")
    with pytest.raises(ValueError, match="group"):
        DurableIngestLog("unused", group=0)


# ---------------------------------------------------------------------------
# one writer
# ---------------------------------------------------------------------------
@_bounded
def test_writer_lock_is_exclusive(tmp_path):
    log = DurableIngestLog(str(tmp_path))
    with pytest.raises(LogLockedError):
        DurableIngestLog(str(tmp_path))
    with pytest.raises(JLocked):
        JDurable(str(tmp_path))                  # the lock is the format's
    log.close()
    DurableIngestLog(str(tmp_path)).close()      # released on close


@_bounded
def test_a_stale_pid_lock_is_reclaimed(tmp_path):
    proc = subprocess.Popen(["sleep", "0"])
    proc.wait()                                  # a pid that is now dead
    (tmp_path / "writer.lock").write_text(f"{proc.pid}\n")
    DurableIngestLog(str(tmp_path)).close()
    (tmp_path / "writer.lock").write_text("not-a-pid\n")
    DurableIngestLog(str(tmp_path)).close()


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------
@_bounded
def test_torn_write_recovery_at_every_byte_offset(tmp_path):
    """Cut the tail segment at every byte: recovery keeps the surviving
    prefix, bitwise the in-memory log fed it, counts one short read, and a
    LiveSession over it gives that log's reports bitwise; appending
    resumes at the cut, bitwise."""
    batches = _batches()
    pristine = str(tmp_path / "pristine")
    _write_log(pristine, batches)
    mem = _mem_log(batches[:-1])
    want_reports = _session_reports(mem)
    full_mem = _mem_log(batches)
    tail = seg.segment_name(N_BATCHES - 1)
    size = os.path.getsize(os.path.join(pristine, tail))
    assert size == (seg.HEADER_SIZE + seg.REC_HEADER_SIZE
                    + ROWS * DIM * 4 + 4 + seg.FOOTER_SIZE)
    work = str(tmp_path / "work")
    for cut in range(size):
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(pristine, work)
        torn_write(os.path.join(work, tail), cut)
        log = DurableIngestLog(work)
        r = log.recovery
        assert (r.batches, r.truncated_at, r.files_dropped) == \
            (N_BATCHES - 1, N_BATCHES - 1, 1), f"cut at byte {cut}: {r}"
        assert (log.counters.short_reads,
                log.counters.checksum_failures) == (1, 0), f"cut at {cut}"
        _assert_store_bitwise(log.store, mem.store)
        _assert_reports_bitwise(_session_reports(log), want_reports)
        assert log.append(batches[-1]) == N_BATCHES - 1
        log.close()
        full = DurableIngestLog(work)
        _assert_store_bitwise(full.store, full_mem.store)
        full.close()


@_bounded
def test_bit_flip_recovery(tmp_path):
    """A flipped bit anywhere truncates at its segment with one checksum
    failure counted, never a torn read."""
    batches = _batches()
    pristine = str(tmp_path / "pristine")
    _write_log(pristine, batches)
    sizes = [os.path.getsize(os.path.join(pristine, seg.segment_name(i)))
             for i in range(N_BATCHES)]
    rng = np.random.default_rng(17)
    work = str(tmp_path / "work")
    for _ in range(40):
        s = int(rng.integers(0, N_BATCHES))
        off = int(rng.integers(0, sizes[s]))
        mask = 1 << int(rng.integers(0, 8))
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(pristine, work)
        bit_flip(os.path.join(work, seg.segment_name(s)), off, mask)
        log = DurableIngestLog(work)
        where = f"seg {s} byte {off} mask {mask:#x}"
        assert (log.recovery.batches, log.recovery.truncated_at,
                log.recovery.files_dropped) == (s, s, N_BATCHES - s), where
        assert (log.counters.checksum_failures,
                log.counters.short_reads) == (1, 0), where
        _assert_store_bitwise(log.store, _mem_log(batches[:s]).store)
        log.close()


@_bounded
def test_a_hole_in_the_sequence_truncates(tmp_path):
    batches = _batches()
    _write_log(str(tmp_path), batches)
    os.unlink(str(tmp_path / seg.segment_name(1)))
    open(tmp_path / ".tmp_seg_00000009.1", "wb").close()
    log = DurableIngestLog(str(tmp_path))
    r = log.recovery
    assert (r.batches, r.truncated_at, r.files_dropped, r.tmp_reaped) == \
        (1, 2, 2, 1)
    assert "hole at seq 1" in r.reason
    _assert_store_bitwise(log.store, _mem_log(batches[:1]).store)
    log.close()


@_bounded
def test_enospc_mid_append_is_loud_and_leaves_the_log_readable(tmp_path):
    batches = _batches()
    root = str(tmp_path)
    log = DurableIngestLog(root, fsync="never")
    log.append(batches[0])
    log.flush()
    with enospc_after(30):                      # dies mid-record
        log.append(batches[1])
        with pytest.raises(OSError):
            log.flush()
    assert log.counters.io_errors == 1
    with pytest.raises(OSError):
        log.close()                             # still loud, but releases
    assert [n for n in os.listdir(root) if n.startswith(".tmp_seg_")] == []
    log2 = DurableIngestLog(root)
    assert log2.recovery.batches == 1
    for b in batches[1:]:
        log2.append(b)
    log2.close()
    log3 = DurableIngestLog(root)
    _assert_store_bitwise(log3.store, _mem_log(batches).store)
    log3.close()


@_bounded
def test_enospc_under_always_raises_from_append(tmp_path):
    log = DurableIngestLog(str(tmp_path), fsync="always")
    log.append(_batches(1)[0])
    with enospc_after(0):
        with pytest.raises(OSError):
            log.append(_batches(1, seed=6)[0])
    with pytest.raises(OSError):
        log.close()
    log2 = DurableIngestLog(str(tmp_path))
    assert log2.recovery.batches == 1
    log2.close()


# ---------------------------------------------------------------------------
# tailing consumers
# ---------------------------------------------------------------------------
@_bounded
def test_tail_in_the_same_process(tmp_path):
    batches = _batches(6)
    root = str(tmp_path)
    prod = DurableIngestLog(root, fsync="batch", group=2)
    tail = DurableIngestLog(root, mode="tail")
    sess = LiveSession(tail, Mean(), B=B, key=KEY, device="cpu")
    got = []
    for b in batches:
        prod.append(b)
        prod.flush()
        got.extend(sess.poll())
    prod.close()
    assert [r.seq for r in got] == list(range(6))
    assert sess.counters.folded == 6 and sess.counters.duplicates == 0
    _assert_reports_bitwise(got, _session_reports(_mem_log(batches)))


def test_tail_mode_cannot_append(tmp_path):
    seg.write_segment(str(tmp_path), 0, _batches(1)[0])
    tail = DurableIngestLog(str(tmp_path), mode="tail")
    with pytest.raises(RuntimeError, match="tail"):
        tail.append(_batches(1)[0])
    tail.close()


@_bounded
def test_tail_degrade_then_reload(tmp_path):
    """An unreadable segment under the degrade policy becomes invalid rows
    (p_eff drops by its extent, the session lives); ``reload`` after the
    repair swaps the real bytes back with a fresh checksum."""
    batches = _batches(6)
    root = str(tmp_path)
    _write_log(root, batches)
    bad = os.path.join(root, seg.segment_name(2))
    pristine_bytes = open(bad, "rb").read()
    bit_flip(bad, seg.HEADER_SIZE + seg.REC_HEADER_SIZE + 5, 0x20)
    tail = DurableIngestLog(root, mode="tail",
                            policy=FailurePolicy(on_exhausted="degrade"))
    sess = LiveSession(tail, Mean(), B=B, key=KEY, device="cpu",
                       policy=LagPolicy(max_lag_batches=1))
    reports = sess.poll()
    assert [r.seq for r in reports] == [0, 1, 3, 4, 5]
    assert tail.lost_seqs == {2}
    assert (tail.counters.checksum_failures, tail.counters.splits_lost) == \
        (1, 1)
    assert reports[-1].counters.gap_rows == ROWS
    assert reports[-1].p_eff == pytest.approx(5 / 6)
    assert not np.any(tail.store.splits[2])
    crc_zero = tail.store.split_checksum(2)
    with open(bad, "wb") as f:
        f.write(pristine_bytes)
    tail.reload(2)
    assert tail.lost_seqs == set()
    np.testing.assert_array_equal(tail.store.splits[2], batches[2])
    assert tail.store.split_checksum(2) != crc_zero
    assert tail.store.split_checksum(2) == \
        _mem_log(batches).store.split_checksum(2)


@_bounded
def test_tail_raise_policy_is_loud(tmp_path):
    _write_log(str(tmp_path), _batches())
    bit_flip(str(tmp_path / seg.segment_name(1)), seg.HEADER_SIZE + 3, 0x01)
    tail = DurableIngestLog(str(tmp_path), mode="tail")
    with pytest.raises(SegmentError):
        tail.next_seq


@_bounded
def test_tail_degrade_with_unknown_extent_stalls(tmp_path):
    _write_log(str(tmp_path), _batches())
    torn_write(str(tmp_path / seg.segment_name(1)), 10)     # header gone
    tail = DurableIngestLog(str(tmp_path), mode="tail",
                            policy=FailurePolicy(on_exhausted="degrade"))
    assert tail.next_seq == 1
    assert tail.counters.short_reads == 1
    assert tail.lost_seqs == set()


_PRODUCER = """
import sys, time
import numpy as np
from repro_torch.live import DurableIngestLog

root, n = sys.argv[1], int(sys.argv[2])
rng = np.random.default_rng(23)
with DurableIngestLog(root, fsync="never") as log:
    for _ in range(n):
        log.append(rng.standard_normal((16, 2)).astype(np.float32))
        log.flush()
        time.sleep(0.05)
print("producer done", log.next_seq)
"""


def test_a_consumer_tails_a_producer_in_another_process(tmp_path):
    """A port producer process appends while this process tails the
    sealed segments through a LiveSession: every batch folds exactly
    once, and the last report is bitwise an in-memory session's."""
    n = 6
    root = str(tmp_path / "log")
    os.makedirs(root)
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen([sys.executable, "-c", _PRODUCER, root, str(n)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)
    try:
        tail = DurableIngestLog(root, mode="tail")
        sess = LiveSession(tail, Mean(), B=4, key=KEY, device="cpu")
        seqs, last = [], None
        deadline = time.monotonic() + 120.0
        while len(seqs) < n:
            for r in sess.poll():
                seqs.append(r.seq)
                last = r
            assert time.monotonic() < deadline, seqs
            time.sleep(0.01)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out.decode()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert seqs == list(range(n))
    assert sess.counters.folded == n and sess.counters.duplicates == 0
    rng = np.random.default_rng(23)
    mem = IngestLog()
    for _ in range(n):
        mem.append(rng.standard_normal((16, 2)).astype(np.float32))
    want = LiveSession(mem, Mean(), B=4, key=KEY, device="cpu").poll()
    np.testing.assert_array_equal(last.thetas.numpy(),
                                  want[-1].thetas.numpy())


def test_jax_key_and_port_key_seed_the_same_stream():
    """Both packages draw the same stream seed from the same key: the
    sessions' weight streams, and so the tail consumers' reports, rest on
    it."""
    from repro.core.bootstrap import seed_from_key as j_seed
    from repro_torch.core.bootstrap import seed_from_key
    assert seed_from_key(KEY) == int(j_seed(jax.random.PRNGKey(29)))
