"""IngestLog: an append-only batch log with backpressure.

The port's own copy of the JAX package's ``live/log.py`` (numpy and
threads only), over the port's ``data/store.ShardedStore``.  Every
appended batch is sealed as one immutable split (``append_split``) and
stamped with a monotone *sequence number*, its split index, so

* the log IS a ShardedStore: every read path (``iter_batches``,
  checksums, ``bootstrap_streaming``) works over the growing log;
* a batch's global row offset is ``store.offsets[seq]``, which lets a
  standing session place a late or re-delivered batch into the right
  window pane and key its Poisson weight stream by position
  (``offset_seed(base, seq)``, the bitwise-resume contract);
* crash recovery is replay: a session checkpoint records its fold cursor
  (``next_seq``) and a resumed session re-reads the log from there.

Backpressure is explicit: with ``capacity=k``, ``append`` blocks while the
slowest *registered* consumer is more than ``k`` batches behind, and
raises ``BackpressureError`` on timeout.  (A session that would rather
shed than block sets ``LagPolicy.shed_backlog``; the two compose.)
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.store import ShardedStore


class BackpressureError(RuntimeError):
    """``append`` timed out waiting for consumers to drain the backlog."""


@dataclasses.dataclass(frozen=True)
class LogBatch:
    """One delivered batch: its sequence number, the global row offset of
    its first row, and the rows themselves (2-D float32)."""
    seq: int
    row0: int
    data: np.ndarray

    @property
    def rows(self) -> int:
        return len(self.data)

    @property
    def row_end(self) -> int:
        return self.row0 + len(self.data)


class IngestLog:
    """Append-only batch log (see module docstring)."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.store = ShardedStore([])
        self._cv = threading.Condition()
        self._acked: Dict[str, int] = {}     # consumer -> last folded seq

    # -- producer side --------------------------------------------------
    @property
    def next_seq(self) -> int:
        return len(self.store.splits)

    @property
    def total_rows(self) -> int:
        return self.store.N

    def _backlog(self) -> int:
        """Batches the slowest registered consumer has not folded yet."""
        if not self._acked:
            return 0
        return self.next_seq - 1 - min(self._acked.values())

    def append(self, data: np.ndarray,
               timeout: Optional[float] = None) -> int:
        """Seal ``data`` as the next batch; returns its sequence number.

        Blocks while the backlog is at ``capacity``; ``timeout`` seconds
        without progress raise ``BackpressureError``.  With no registered
        consumer the log cannot measure lag and never gates.  ``data`` is
        copied, so a producer that reuses its staging buffer cannot change
        sealed history (or stale a cached split checksum), and a durable
        log's writer thread can seal the batch after ``append`` returns.
        """
        data = np.array(data, np.float32, copy=True)
        if data.ndim == 1:
            data = data[:, None]
        with self._cv:
            if self.capacity is not None and self._acked:
                ok = self._cv.wait_for(
                    lambda: self._backlog() < self.capacity,
                    timeout=timeout)
                if not ok:
                    raise BackpressureError(
                        f"backlog {self._backlog()} >= capacity "
                        f"{self.capacity} for {timeout}s: consumers are "
                        "not keeping up")
            return self._seal(data)

    def _seal(self, data: np.ndarray) -> int:
        """Commit one normalized batch as the next split (under ``_cv``).
        ``DurableIngestLog`` also hands the batch to its segment writer
        here, so the on-disk order is the sequence order."""
        return self.store.append_split(data)

    def flush(self) -> None:
        """Durability barrier: a no-op for the in-memory log."""

    def close(self) -> None:
        """Release producer-side resources: a no-op for the in-memory log
        (kept so producer code is generic over log kinds)."""

    def __enter__(self) -> "IngestLog":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- consumer side --------------------------------------------------
    def register(self, name: str) -> None:
        """Declare a consumer; its ack cursor now gates ``capacity``."""
        with self._cv:
            self._acked.setdefault(name, -1)

    def ack(self, name: str, seq: int) -> None:
        """Consumer ``name`` has folded everything through ``seq``, which
        releases backpressured producers."""
        with self._cv:
            if seq > self._acked.get(name, -1):
                self._acked[name] = int(seq)
                self._cv.notify_all()

    def batch(self, seq: int) -> LogBatch:
        return LogBatch(seq=int(seq), row0=int(self.store.offsets[seq]),
                        data=self.store.read_split(seq))

    def batches_from(self, seq: int) -> List[LogBatch]:
        """All sealed batches with sequence number >= ``seq`` (snapshot)."""
        with self._cv:
            n = self.next_seq
        return [self.batch(s) for s in range(max(seq, 0), n)]
