"""Deterministic fault injection and resilient counted reads.

The port of the JAX package's ``ft/inject.py``: host NumPy over the port's
own ``ShardedStore``, so the same seed draws the same fault plan and the
same delivery plan in both packages.

The paper's §3.4 fault-tolerance story is only testable if failures are
*reproducible*: a flaky test that sometimes loses a shard proves nothing.
This module provides both halves of the harness:

* ``FaultyStore`` — a ``ShardedStore`` wrapper that injects a declared (or
  seeded, via ``FaultyStore.seeded``) plan of faults at read time:
  transient ``IOError``\\ s, latency spikes (stragglers), short reads, and
  corrupted batches.  Faults are keyed by ``(split, attempt)``, so a rerun
  with the same plan injects the identical failure sequence — and a
  *transient* fault clears after its declared number of attempts, while a
  ``permanent`` one models a shard that is simply gone.

* ``ResilientStore`` — the defensive read path the streaming driver's
  prefetch thread uses: every split read is validated (expected row count
  + crc32 against ``split_checksum``, which wrappers delegate to the
  PRISTINE underlying store, so corruption cannot forge it) and retried
  under a bounded ``RetryPolicy`` with exponential backoff; a read that
  overruns ``timeout`` counts as a deadline miss (the straggler signal)
  and is retried in the hope a replica answers faster.  When the budget is
  exhausted the policy decides: ``on_exhausted="raise"`` kills the run
  (the checkpoint-restart path picks it up), ``"degrade"`` marks the split
  LOST — its rows are zeroed and masked out downstream, the EARL §3.4
  move: survivors stay a uniform sample, the CI widens honestly via
  ``correct(p)``.

All observed faults/retries accumulate in a ``FaultCounters`` that the
streaming driver surfaces in its ``StreamReport``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import os
import time
import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.store import ShardedStore

FAULT_KINDS = ("io", "latency", "short", "corrupt")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injected fault: ``kind`` on ``split`` for its first ``attempts``
    reads (``permanent=True`` = never clears — a lost shard)."""
    split: int
    kind: str                 # "io" | "latency" | "short" | "corrupt"
    attempts: int = 1
    latency_s: float = 0.05
    permanent: bool = False

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")


@dataclasses.dataclass
class RetryPolicy:
    """Bounded retry with exponential backoff and a per-read deadline.

    ``max_attempts`` total read attempts per split; the k-th retry sleeps
    ``base_delay * 2**(k-1)`` seconds first; a successful read slower than
    ``timeout`` seconds counts as a deadline miss and is retried (a
    straggler is a temporarily-failed shard) — except on the final
    attempt, where valid-but-late data is accepted rather than discarded.
    """
    max_attempts: int = 3
    base_delay: float = 0.01
    timeout: Optional[float] = None

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1, "
                             f"got {self.max_attempts}")

    def delay(self, failures: int) -> float:
        return float(self.base_delay) * (2.0 ** max(failures - 1, 0))


@dataclasses.dataclass
class FaultCounters:
    """Observed fault/retry totals (surfaced in ``StreamReport``)."""
    io_errors: int = 0
    short_reads: int = 0
    checksum_failures: int = 0
    deadline_misses: int = 0
    retries: int = 0
    backoff_s: float = 0.0
    splits_lost: int = 0
    duplicates: int = 0
    reordered: int = 0

    @property
    def total_faults(self) -> int:
        return (self.io_errors + self.short_reads +
                self.checksum_failures + self.deadline_misses)


class FaultExhaustedError(IOError):
    """A split failed every attempt the ``RetryPolicy`` allowed."""

    def __init__(self, split: int, attempts: int, last: str):
        self.split = split
        self.attempts = attempts
        super().__init__(
            f"split {split} failed all {attempts} read attempts "
            f"(last failure: {last})")


class FaultyStore(ShardedStore):
    """``ShardedStore`` with a deterministic fault plan injected at read
    time.  Shares the inner store's ``ReadStats`` (every injected retry is
    a real counted read) and delegates ``split_checksum`` to the pristine
    inner store, so corrupted/short reads are *detectable*."""

    def __init__(self, inner: ShardedStore, faults: Sequence[Fault] = ()):
        super().__init__(inner.splits)
        self.inner = inner
        self.stats = inner.stats
        self.faults = tuple(faults)
        for f in self.faults:
            if not (0 <= f.split < len(self.splits)):
                raise ValueError(f"fault names split {f.split}, but the "
                                 f"store has {len(self.splits)} splits")
        self._attempts = [0] * len(self.splits)
        self.injected = FaultCounters()

    @classmethod
    def seeded(cls, inner: ShardedStore, seed: int,
               p_io: float = 0.0, p_latency: float = 0.0,
               p_short: float = 0.0, p_corrupt: float = 0.0,
               latency_s: float = 0.05,
               attempts: int = 1) -> "FaultyStore":
        """Draw a reproducible fault plan: each split independently gets at
        most one transient fault, chosen by a ``default_rng(seed)`` — the
        same seed always yields the same plan."""
        rng = np.random.default_rng(seed)
        plan: List[Fault] = []
        probs = (("io", p_io), ("latency", p_latency),
                 ("short", p_short), ("corrupt", p_corrupt))
        for s in range(len(inner.splits)):
            u = float(rng.random())
            acc = 0.0
            for kind, p in probs:
                acc += p
                if u < acc:
                    plan.append(Fault(split=s, kind=kind, attempts=attempts,
                                      latency_s=latency_s))
                    break
        return cls(inner, plan)

    def _active_fault(self, i: int, attempt: int) -> Optional[Fault]:
        for f in self.faults:
            if f.split == i and (f.permanent or attempt < f.attempts):
                return f
        return None

    def split_checksum(self, i: int) -> int:
        return self.inner.split_checksum(i)

    def read_split(self, i: int) -> np.ndarray:
        attempt = self._attempts[i]
        self._attempts[i] += 1
        fault = self._active_fault(i, attempt)
        data = self.inner.read_split(i)
        if fault is None:
            return data
        if fault.kind == "io":
            self.injected.io_errors += 1
            raise IOError(f"injected IOError on split {i} "
                          f"(attempt {attempt})")
        if fault.kind == "latency":
            self.injected.deadline_misses += 1
            time.sleep(fault.latency_s)
            return data
        if fault.kind == "short":
            self.injected.short_reads += 1
            return data[:max(len(data) - max(1, len(data) // 3), 0)]
        # corrupt: flip a deterministic subset of values on a COPY
        self.injected.checksum_failures += 1
        bad = np.array(data, copy=True)
        flat = bad.reshape(-1)
        flat[::max(1, flat.size // 7)] = flat[::max(1, flat.size // 7)] + 1.0
        return bad

    # -- delivery-order faults (live-ingest path) ----------------------
    def delivery_plan(self, seed: int, p_duplicate: float = 0.0,
                      max_reorder: int = 0) -> List[int]:
        """A seeded, perturbed delivery ORDER over this store's splits.

        Read faults above corrupt *what* a split returns; a live ingest
        channel additionally corrupts *when and how often* a batch shows
        up.  The plan is a list of split indices in delivery order where

        * each split may be displaced backward by at most ``max_reorder``
          positions (stable sort on ``i + U{0..max_reorder}``, so the
          displacement bound is exact — a watermark with lateness bound
          ``max_reorder`` never has to skip a batch that still shows up),
        * each split is independently re-delivered with probability
          ``p_duplicate`` a few slots after its first delivery.

        Every split appears at least once — these are delivery faults, not
        data loss.  The same ``seed`` always yields the same plan;
        ``injected.duplicates`` / ``injected.reordered`` record what the
        plan contains so ingest tests can assert exactly-once folding
        against known injection counts.
        """
        if not 0.0 <= p_duplicate <= 1.0:
            raise ValueError(f"p_duplicate must be in [0, 1], "
                             f"got {p_duplicate}")
        if max_reorder < 0:
            raise ValueError(f"max_reorder must be >= 0, got {max_reorder}")
        rng = np.random.default_rng(seed)
        n = len(self.splits)
        keys = np.arange(n) + rng.integers(0, max_reorder + 1, size=n)
        order = list(np.argsort(keys, kind="stable"))
        self.injected.reordered += int(
            sum(1 for pos, s in enumerate(order) if s != pos))
        echoes = []                      # (insert_after_pos, split)
        for pos, s in enumerate(order):
            if float(rng.random()) < p_duplicate:
                # echo the batch a couple of slots after its delivery
                echoes.append((pos + 1 + int(rng.integers(0, 3)), int(s)))
                self.injected.duplicates += 1
        plan = [int(s) for s in order]
        for at, s in sorted(echoes, reverse=True):
            plan.insert(min(at, len(plan)), s)
        return plan

    def iter_delivery(self, seed: int, p_duplicate: float = 0.0,
                      max_reorder: int = 0):
        """Yield ``(split_index, data)`` in the perturbed delivery order of
        ``delivery_plan`` — the faulty channel a live session drinks from.
        Reads go through ``read_split`` so per-split read faults compose
        with delivery faults."""
        for s in self.delivery_plan(seed, p_duplicate, max_reorder):
            yield s, self.read_split(s)


# -- disk faults -----------------------------------------------------------
# The read-time injectors above corrupt what a SPLIT returns; a file on
# disk additionally fails at the file layer.  These three injectors
# produce, deterministically, the on-disk images a recovery path must
# survive: a torn tail, a flipped bit, a full disk.

def torn_write(path: str, keep_bytes: int) -> None:
    """Truncate ``path`` to its first ``keep_bytes`` bytes: the on-disk
    image of a writer killed mid-write (or an OS crash dropping the
    un-fsynced tail of a file)."""
    size = os.path.getsize(path)
    if not 0 <= keep_bytes <= size:
        raise ValueError(f"keep_bytes must be in [0, {size}], "
                         f"got {keep_bytes}")
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)


def bit_flip(path: str, offset: int, mask: int = 0x01) -> None:
    """XOR one byte of ``path`` with ``mask``: silent media corruption."""
    if not mask & 0xFF:
        raise ValueError(f"mask must flip at least one bit, got {mask:#x}")
    size = os.path.getsize(path)
    if not 0 <= offset < size:
        raise ValueError(f"offset must be in [0, {size}), got {offset}")
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)[0]
        f.seek(offset)
        f.write(bytes([b ^ (mask & 0xFF)]))


@contextlib.contextmanager
def enospc_after(nbytes: int):
    """Within this context the 'disk' accepts ``nbytes`` more bytes, then
    every further write raises ``ENOSPC``, mid-file if the budget runs out
    there.  Patches the two write seams every byte of a checkpoint
    (``checkpoint.manager._write``) and of a log segment
    (``live.segment._write``) funnels through, one budget for both, so the
    failure is exactly a real full disk: a partial staging file and a
    loud OSError."""
    from repro_torch.checkpoint import manager as _manager
    from repro_torch.live import segment as _segment

    if nbytes < 0:
        raise ValueError(f"nbytes must be >= 0, got {nbytes}")
    budget = {"left": int(nbytes)}
    seams = (_manager, _segment)
    origs = [m._write for m in seams]

    def failing(orig):
        def _failing(f, data):
            take = min(len(data), budget["left"])
            if take:
                orig(f, data[:take])
                budget["left"] -= take
            if take < len(data):
                raise OSError(errno.ENOSPC,
                              "No space left on device (injected)")
        return _failing

    for m, orig in zip(seams, origs):
        m._write = failing(orig)
    try:
        yield budget
    finally:
        for m, orig in zip(seams, origs):
            m._write = orig


class ResilientStore(ShardedStore):
    """Retry/verify wrapper: every split read is validated against the
    pristine checksum and expected row count, retried under ``retry``, and
    — if the budget is exhausted — either raised (``on_exhausted="raise"``)
    or degraded to a LOST split whose rows are zeroed and recorded in
    ``lost_splits`` for downstream masking (``on_exhausted="degrade"``).
    """

    def __init__(self, store: ShardedStore, retry: RetryPolicy,
                 counters: Optional[FaultCounters] = None,
                 on_exhausted: str = "raise"):
        if on_exhausted not in ("raise", "degrade"):
            raise ValueError(f"on_exhausted must be 'raise' or 'degrade', "
                             f"got {on_exhausted!r}")
        super().__init__(store.splits)
        self.store = store
        self.stats = store.stats
        self.retry = retry
        self.counters = counters if counters is not None else FaultCounters()
        self.on_exhausted = on_exhausted
        self.lost_splits: List[int] = []

    def split_checksum(self, i: int) -> int:
        return self.store.split_checksum(i)

    def invalid_row_ranges(self) -> List[Tuple[int, int]]:
        """Global row ranges of splits lost so far (for chunk masking)."""
        return [(int(self.offsets[s]), int(self.offsets[s + 1]))
                for s in sorted(self.lost_splits)]

    def _validate(self, i: int, data: np.ndarray) -> Optional[str]:
        if len(data) != self.split_sizes[i]:
            self.counters.short_reads += 1
            return f"short read ({len(data)}/{self.split_sizes[i]} rows)"
        crc = zlib.crc32(np.ascontiguousarray(data).tobytes())
        if crc != self.store.split_checksum(i):
            self.counters.checksum_failures += 1
            return "checksum mismatch"
        return None

    def read_split(self, i: int) -> np.ndarray:
        policy = self.retry
        failures = 0
        last = "unknown"
        for attempt in range(policy.max_attempts):
            final = attempt == policy.max_attempts - 1
            t0 = time.perf_counter()
            try:
                data = self.store.read_split(i)
            except (IOError, OSError) as exc:
                self.counters.io_errors += 1
                last = f"{type(exc).__name__}: {exc}"
                data = None
            if data is not None:
                elapsed = time.perf_counter() - t0
                bad = self._validate(i, data)
                if bad is None:
                    slow = (policy.timeout is not None
                            and elapsed > policy.timeout)
                    if slow:
                        self.counters.deadline_misses += 1
                        last = (f"deadline miss "
                                f"({elapsed:.3f}s > {policy.timeout}s)")
                    if not slow or final:
                        # valid data: accept (even late data on the final
                        # attempt — slow beats lost)
                        return data
                else:
                    last = bad
            if not final:
                failures += 1
                self.counters.retries += 1
                d = policy.delay(failures)
                self.counters.backoff_s += d
                time.sleep(d)
        if self.on_exhausted == "degrade":
            # EARL §3.4: the shard is LOST — zero its rows, mask them out
            # downstream, widen the CI via correct(p).  Survivors remain a
            # uniform sample because the store interleaves at ingest.
            self.lost_splits.append(i)
            self.counters.splits_lost += 1
            head = self.splits[i]
            return np.zeros((self.split_sizes[i],) + head.shape[1:],
                            head.dtype)
        raise FaultExhaustedError(i, policy.max_attempts, last)
