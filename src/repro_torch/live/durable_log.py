"""DurableIngestLog: a crash-safe, cross-process ``IngestLog``.

The port's own copy of the JAX package's ``live/durable_log.py`` (numpy,
threads and file I/O only).  The in-memory ``IngestLog`` dies with its
process; this subclass also seals every appended batch as one on-disk
segment file (``live/segment.py``), keeping the ``IngestLog`` API and
the seq = split index contract, so ``LiveSession``,
``bootstrap_streaming`` and every other read path work unchanged over
the growing log.  Producers and consumers share only a directory:

* **Producer** (``mode="append"``, one writer, held by a pid lock file):
  ``append`` seals the batch in memory and hands it to a background
  segment writer thread (write-behind group commit).  ``fsync`` picks the
  durability point, never the bytes:

  - ``"never"``: write and atomic rename, no fsync.  Safe against the
    process dying (a sealed name is always a whole file); an OS crash may
    tear the tail, which recovery handles.
  - ``"batch"``: group commit.  Sealed files go to a syncer thread that
    fsyncs them in groups of up to ``group`` files per directory sync;
    fsync releases the GIL, so the commits overlap the writer's segment
    writes.  ``flush()`` drains both threads.
  - ``"always"``: ``append`` returns only after the batch and its
    directory entry are fsynced.

  ``flush()`` is the durability barrier; ``close()`` flushes, stops both
  threads and releases the lock.  A writer failure (ENOSPC mid-append)
  is loud: the failed segment's staging file is removed, the sealed
  prefix stays readable, and the error re-raises from the next
  ``append``/``flush``.

* **Recovery** (producer start-up): scan ``seg_*.seg`` in seq order,
  validate each, and load the valid prefix into the in-memory store.  At
  the first torn, corrupt or missing segment the log TRUNCATES: that file
  and every later one are unlinked, the damage is counted in
  ``FaultCounters`` (torn: ``short_reads``; CRC: ``checksum_failures``),
  and appending resumes there.  The recovered prefix is bitwise an
  in-memory ``IngestLog`` fed the surviving batches.

* **Consumer** (``mode="tail"``): read-only; ``next_seq`` and
  ``batches_from`` re-scan the directory for newly sealed segments
  (``refresh``), so a ``LiveSession`` polls a producer in another process
  and sees every sealed batch exactly once.  An unreadable segment
  follows ``FailurePolicy``: ``on_exhausted="degrade"`` zero-fills the
  batch's extent (known from its record header) as a LOST split that is
  never delivered, so the session's watermark charges those rows invalid
  and ``correct(p_eff)`` widens the CI; ``"raise"`` (the default) raises.
  ``reload(seq)`` re-reads a repaired segment.

Known limits, as in the JAX package: backpressure ack cursors are
per-process, and the in-memory store mirrors the whole log.
"""
from __future__ import annotations

import dataclasses
import os
import queue
import threading
from typing import List, Optional

import numpy as np

from repro_torch.ft.inject import FaultCounters
from repro_torch.ft.policy import FailurePolicy
from repro_torch.live.log import IngestLog, LogBatch
from repro_torch.live.segment import (CorruptSegmentError, SegmentError,
                                      TornSegmentError, list_segments,
                                      probe_segment, read_segment,
                                      segment_name, sync_dir, sync_file,
                                      write_segment)

_LOCK_NAME = "writer.lock"
_STOP = object()

FSYNC_POLICIES = ("never", "batch", "always")


class LogLockedError(RuntimeError):
    """The log directory already has a live producer."""


@dataclasses.dataclass(frozen=True)
class RecoveryReport:
    """What the start-up scan found and did."""
    batches: int                 # sealed batches recovered into the store
    rows: int                    # total rows recovered
    truncated_at: Optional[int]  # first seq dropped (None: clean log)
    reason: str                  # why truncation happened ("" if clean)
    files_dropped: int           # segment files unlinked at/after the cut
    bytes_dropped: int           # their total size on disk
    tmp_reaped: int              # stale .tmp_seg_* staging files removed


def _pid_alive(pid_s: str) -> bool:
    try:
        pid = int(pid_s)
    except ValueError:
        return False
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    except (OverflowError, ValueError):
        return False
    return True


class DurableIngestLog(IngestLog):
    """On-disk ``IngestLog`` over a directory of sealed segment files
    (see module docstring)."""

    def __init__(self, root: str, capacity: Optional[int] = None,
                 fsync: str = "batch", group: int = 8,
                 mode: str = "append",
                 policy: Optional[FailurePolicy] = None,
                 counters: Optional[FaultCounters] = None,
                 queue_depth: int = 32):
        if fsync not in FSYNC_POLICIES:
            raise ValueError(f"fsync must be one of {FSYNC_POLICIES}, "
                             f"got {fsync!r}")
        if mode not in ("append", "tail"):
            raise ValueError(f"mode must be 'append' or 'tail', "
                             f"got {mode!r}")
        if group < 1:
            raise ValueError(f"group must be >= 1, got {group}")
        super().__init__(capacity)
        self.root = root
        self.fsync = fsync
        self.group = int(group)
        self.mode = mode
        self.policy = policy
        self.counters = counters if counters is not None else FaultCounters()
        self.lost_seqs: set = set()          # degraded (zero-filled) seqs
        self.recovery: Optional[RecoveryReport] = None
        self._stalled: set = set()           # unreadable, extent unknown
        self._lock_owned = False
        self._closed = False
        os.makedirs(root, exist_ok=True)

        if mode == "append":
            self._acquire_lock()
            self.recovery = self.recover()
            self._writer_exc: Optional[BaseException] = None
            self._wq: "queue.Queue" = queue.Queue(maxsize=queue_depth)
            self._writer = threading.Thread(
                target=self._writer_loop, name="segment-writer", daemon=True)
            self._writer.start()
            self._syncer: Optional[threading.Thread] = None
            if fsync == "batch":
                # group fsyncs run on their own thread: fsync is device
                # I/O that releases the GIL, so it overlaps the writer's
                # CPU-bound segment writes instead of serializing behind
                # them
                self._sq: "queue.Queue" = queue.Queue()
                self._syncer = threading.Thread(
                    target=self._syncer_loop, name="segment-syncer",
                    daemon=True)
                self._syncer.start()

    # -- geometry helpers ----------------------------------------------
    def _dim(self) -> Optional[int]:
        return int(self.store.splits[0].shape[1]) if self.store.splits \
            else None

    # -- producer side --------------------------------------------------
    def _acquire_lock(self) -> None:
        """Single-writer exclusivity via a pid lock file.  A lock whose
        owner is dead (or unparseable) is stale and reclaimed — the same
        liveness discipline as the checkpoint manager's orphan GC."""
        path = os.path.join(self.root, _LOCK_NAME)
        for _ in range(3):
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                try:
                    os.write(fd, f"{os.getpid()}\n".encode())
                finally:
                    os.close(fd)
                self._lock_owned = True
                return
            except FileExistsError:
                try:
                    with open(path) as f:
                        pid_s = f.read().strip()
                except OSError:
                    pid_s = ""
                if pid_s and _pid_alive(pid_s):
                    raise LogLockedError(
                        f"{self.root} already has a live producer "
                        f"(pid {pid_s}); one writer per log")
                try:
                    os.unlink(path)          # stale lock: owner is dead
                except OSError:
                    pass
        raise LogLockedError(f"could not acquire writer lock in {self.root}")

    def recover(self) -> RecoveryReport:
        """Start-up scan: load the valid sealed prefix, truncate the rest
        (see module docstring).  Runs once, on an empty store."""
        if self.store.splits:
            raise RuntimeError("recover() runs at producer start-up, "
                               "before any batch is loaded")
        tmp_reaped = 0
        for name in os.listdir(self.root):
            # any staging file is garbage: we hold the writer lock, so
            # its writer is either us-in-a-past-life or dead
            if name.startswith(".tmp_seg_"):
                try:
                    os.unlink(os.path.join(self.root, name))
                    tmp_reaped += 1
                except OSError:
                    pass
        segs = list_segments(self.root)
        expect, rows, reason = 0, 0, ""
        while expect in segs:
            try:
                _, _, recs = read_segment(segs[expect], expect_seq=expect,
                                          expect_dim=self._dim())
                if len(recs) != 1:
                    raise CorruptSegmentError(
                        f"{len(recs)} records in one segment (the log "
                        "seals exactly one batch per segment)")
            except TornSegmentError as exc:
                self.counters.short_reads += 1
                reason = f"torn segment {expect}: {exc}"
                break
            except CorruptSegmentError as exc:
                self.counters.checksum_failures += 1
                reason = f"corrupt segment {expect}: {exc}"
                break
            self.store.append_split(np.asarray(recs[0][1]))
            rows += len(recs[0][1])
            expect += 1
        dropped = sorted(s for s in segs if s >= expect)
        if dropped and not reason:
            reason = (f"hole at seq {expect} "
                      f"(later segments {dropped} are unreachable)")
        bytes_dropped = 0
        for s in dropped:
            try:
                bytes_dropped += os.path.getsize(segs[s])
                os.unlink(segs[s])
            except OSError:
                pass
        return RecoveryReport(
            batches=expect, rows=rows,
            truncated_at=dropped[0] if dropped else None,
            reason=reason, files_dropped=len(dropped),
            bytes_dropped=bytes_dropped, tmp_reaped=tmp_reaped)

    def _seal(self, data: np.ndarray) -> int:
        """In-memory seal + hand-off to the segment writer, under ``_cv``
        so the on-disk sealing order is the sequence order."""
        if self.mode != "append":
            raise RuntimeError("append() needs mode='append' "
                               "(this log is a tailing consumer)")
        self._raise_writer_failure()
        seq = super()._seal(data)
        while True:
            try:
                self._wq.put((seq, data), timeout=0.1)
                return seq
            except queue.Full:
                self._raise_writer_failure()

    def append(self, data: np.ndarray,
               timeout: Optional[float] = None) -> int:
        seq = super().append(data, timeout)
        if self.fsync == "always":
            self.flush()
        return seq

    def _raise_writer_failure(self) -> None:
        if getattr(self, "_writer_exc", None) is not None:
            raise self._writer_exc

    def _writer_loop(self) -> None:
        while True:
            item = self._wq.get()
            try:
                if item is _STOP:
                    return
                if self._writer_exc is not None:
                    continue                 # drain after failure
                seq, data = item
                try:
                    path = write_segment(self.root, seq, data,
                                         sync=self.fsync == "always")
                    if self.fsync == "always":
                        pass                 # write_segment synced the dir
                    elif self.fsync == "batch":
                        self._sq.put(path)
                except BaseException as exc:
                    if isinstance(exc, OSError):
                        self.counters.io_errors += 1
                    self._writer_exc = exc
            finally:
                self._wq.task_done()

    def _syncer_loop(self) -> None:
        """Group commit: coalesce up to ``group`` sealed segments per
        commit cycle — one fsync per file plus ONE directory sync — so
        the dir-entry flush amortizes across the group while the device
        I/O overlaps the writer's next segment."""
        while True:
            paths = [self._sq.get()]
            done = 1
            try:
                while len(paths) < self.group:      # coalesce what's queued
                    try:
                        paths.append(self._sq.get_nowait())
                        done += 1
                    except queue.Empty:
                        break
                if paths[-1] is _STOP:
                    paths.pop()
                if not paths:
                    return
                if self._writer_exc is None:
                    try:
                        for path in paths:
                            sync_file(path)
                        # a full group earns its dir sync here; smaller
                        # drains defer it to the flush() barrier, which
                        # always dir-syncs — one rename flush per group
                        # instead of one per segment
                        if len(paths) >= self.group:
                            sync_dir(self.root)
                    except OSError as exc:
                        self.counters.io_errors += 1
                        self._writer_exc = exc
            finally:
                for _ in range(done):
                    self._sq.task_done()
            if done > len(paths):                   # _STOP was coalesced
                return

    def flush(self) -> None:
        """Durability barrier: every batch appended so far is sealed and
        (under ``fsync != "never"``) fsynced when this returns.  Re-raises
        a writer failure (e.g. ENOSPC) loudly."""
        if self.mode != "append" or self._closed:
            return
        self._wq.join()
        if self.fsync == "batch":
            self._sq.join()
            if self._writer_exc is None:
                try:
                    sync_dir(self.root)      # make every rename durable
                except OSError as exc:
                    self.counters.io_errors += 1
                    self._writer_exc = exc
        self._raise_writer_failure()

    def close(self) -> None:
        """Flush, stop the writer and syncer threads, release the lock.
        Raises if the final flush finds a writer failure, or if a thread
        has not stopped 30 s after its stop signal; always releases."""
        if self.mode != "append" or self._closed:
            return
        try:
            self.flush()
        finally:
            self._closed = True
            self._wq.put(_STOP)
            self._writer.join(timeout=30.0)
            if self._syncer is not None:
                self._sq.put(_STOP)
                self._syncer.join(timeout=30.0)
            if self._lock_owned:
                try:
                    os.unlink(os.path.join(self.root, _LOCK_NAME))
                except OSError:
                    pass
                self._lock_owned = False
        stuck = [t.name for t in (self._writer, self._syncer)
                 if t is not None and t.is_alive()]
        if stuck:
            raise RuntimeError(f"{', '.join(stuck)} did not stop within "
                               "30 s of close()")

    # -- consumer side (cross-process tailing) -------------------------
    def refresh(self) -> int:
        """Pull newly sealed segments from disk into the in-memory store
        (tail mode only; the producer's own store is authoritative).
        Returns how many new batches became readable."""
        if self.mode != "append":
            return self._refresh_tail()
        return 0

    def _refresh_tail(self) -> int:
        added = 0
        while True:
            seq = len(self.store.splits)
            if seq in self._stalled:
                return added
            path = os.path.join(self.root, segment_name(seq))
            if not os.path.exists(path):
                return added
            try:
                _, _, recs = read_segment(path, expect_seq=seq,
                                          expect_dim=self._dim())
                if len(recs) != 1:
                    raise CorruptSegmentError(
                        f"{len(recs)} records in one segment")
            except SegmentError as exc:
                if isinstance(exc, TornSegmentError):
                    self.counters.short_reads += 1
                else:
                    self.counters.checksum_failures += 1
                if not (self.policy is not None
                        and self.policy.on_exhausted == "degrade"):
                    raise
                probe = probe_segment(path)
                dim = self._dim() if probe.dim is None else probe.dim
                if probe.rows is None or dim is None:
                    # extent unknown: later batches cannot be placed —
                    # stop here (and stay stopped) rather than guess
                    self._stalled.add(seq)
                    return added
                with self._cv:
                    self.store.append_split(
                        np.zeros((probe.rows, dim), np.float32))
                self.lost_seqs.add(seq)
                self.counters.splits_lost += 1
                continue
            with self._cv:
                self.store.append_split(np.asarray(recs[0][1]))
            added += 1

    def reload(self, seq: int) -> None:
        """Re-read segment ``seq`` from disk after out-of-band repair
        (e.g. the file was restored from a replica).  A batch previously
        degraded to zeros gets its real bytes swapped back in via
        ``replace_split`` — the identity-keyed checksum cache hands out a
        fresh crc for the new bytes.  Validation failures propagate."""
        if seq in self._stalled:
            self._stalled.discard(seq)       # retry the stalled scan
            self.refresh()
            return
        path = os.path.join(self.root, segment_name(seq))
        _, _, recs = read_segment(path, expect_seq=seq,
                                  expect_dim=self._dim())
        if len(recs) != 1:
            raise CorruptSegmentError(f"{len(recs)} records in one segment")
        with self._cv:
            self.store.replace_split(seq, np.asarray(recs[0][1]))
        self.lost_seqs.discard(seq)

    @property
    def next_seq(self) -> int:
        self.refresh()
        return IngestLog.next_seq.fget(self)        # type: ignore[attr-defined]

    def batches_from(self, seq: int) -> List[LogBatch]:
        """Sealed batches >= ``seq``, skipping degraded (lost) ones — the
        session's watermark sees the gap and charges it invalid."""
        self.refresh()
        return [b for b in super().batches_from(seq)
                if b.seq not in self.lost_seqs]

    def __enter__(self) -> "DurableIngestLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
