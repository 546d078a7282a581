"""ShardedStore — the HDFS-splits analogue (paper §3.3).

The port's own copy of ``repro/data/store.py`` (numpy only): importing it
from the JAX package would import jax through ``repro.data``.  Its users
here are the samplers, the streaming bootstrap (core/streaming.py) and
the fault-injection wrappers (ft/inject.py).

A dataset is a set of fixed-size *splits* (shards).  Reads are split-
granular and counted, so the benchmarks can report load cost exactly the
way the paper does (pre-map sampling reads only the splits/rows it needs;
post-map reads everything).

The paper warns (§7, block sampling) that naive split-level sampling is
non-uniform when the layout is clustered; ingest therefore offers an
``interleave`` option that scatters rows across splits by a hash
permutation, making every split an unbiased slice (tests/test_sampler.py
checks this with a chi-square bound).
"""
from __future__ import annotations

import dataclasses
import threading
import zlib
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass
class ReadStats:
    """Counted-read totals.  Thread-safe: the streaming driver's prefetch
    thread and the main thread both touch the counters (core/streaming.py),
    so all mutation goes through ``add``/``reset`` under a lock.  Reading
    the plain int attributes without the lock stays safe (int loads are
    atomic under the GIL); only read-modify-write needed guarding."""
    splits_opened: int = 0
    rows_read: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()

    def add(self, splits: int = 0, rows: int = 0) -> None:
        with self._lock:
            self.splits_opened += splits
            self.rows_read += rows

    def reset(self) -> None:
        with self._lock:
            self.splits_opened = 0
            self.rows_read = 0


class ShardedStore:
    """Row-oriented store partitioned into splits of ``split_size`` rows."""

    def __init__(self, splits: List[np.ndarray]):
        self.splits = splits
        self.split_sizes = [len(s) for s in splits]
        self.offsets = np.cumsum([0] + self.split_sizes)
        self.N = int(self.offsets[-1])
        self.stats = ReadStats()
        self._checksums: dict = {}

    def split_checksum(self, i: int) -> int:
        """crc32 of split ``i``'s pristine bytes (computed lazily, cached).

        This is the per-batch integrity oracle the fault-tolerant read path
        (ft/inject.py) validates against: a wrapper that corrupts or
        truncates a read cannot also forge this checksum, because wrappers
        delegate ``split_checksum`` to the underlying store.

        The cache is keyed by split IDENTITY, not index: when
        ``replace_split`` swaps in a recovered/rewritten segment's bytes,
        the stale crc must not survive the swap (the cached entry holds a
        reference to the array it hashed, so the identity check is safe
        against id() reuse)."""
        s = self.splits[i]
        cached = self._checksums.get(i)
        if cached is not None and cached[0] is s:
            return cached[1]
        crc = zlib.crc32(np.ascontiguousarray(s).tobytes())
        self._checksums[i] = (s, crc)
        return crc

    # -- construction --------------------------------------------------
    @staticmethod
    def from_array(data: np.ndarray, split_size: int,
                   interleave: bool = True,
                   seed: int = 0) -> "ShardedStore":
        data = np.asarray(data)
        if interleave:
            # hash-permute rows at ingest so clustered layouts (paper §7's
            # block-sampling hazard) cannot bias split-level samples.
            rng = np.random.default_rng(seed)
            data = data[rng.permutation(len(data))]
        splits = [data[i:i + split_size]
                  for i in range(0, len(data), split_size)]
        return ShardedStore(splits)

    # -- append (live-ingest path) -------------------------------------
    def append_split(self, data: np.ndarray) -> int:
        """Seal ``data`` as a new split at the end of the store and return
        its split index.

        This is the segmented-writer primitive the live ``IngestLog``
        builds on: ingest batches become immutable splits one at a time,
        so every existing read path (``iter_batches``, ``read_split``,
        checksums) works over a growing store without rebuilding it.
        Cached checksums of earlier splits stay valid because splits are
        immutable once sealed."""
        data = np.asarray(data)
        if len(data) == 0:
            raise ValueError("append_split needs a non-empty batch")
        if self.splits and data.shape[1:] != self.splits[0].shape[1:]:
            raise ValueError(
                f"append_split shape {data.shape[1:]} does not match the "
                f"store's row shape {self.splits[0].shape[1:]}")
        i = len(self.splits)
        self.splits.append(data)
        self.split_sizes.append(len(data))
        self.offsets = np.append(self.offsets, self.N + len(data))
        self.N = int(self.offsets[-1])
        return i

    def replace_split(self, i: int, data: np.ndarray) -> None:
        """Swap split ``i``'s bytes in place — the repaired-segment path
        (a batch the durable log degraded to zeros is re-read after its
        file is restored from a replica).  The geometry is immutable:
        the replacement must match the split's shape exactly, so offsets
        and every downstream row placement stay valid.  The checksum
        cache is identity-keyed, so the new bytes get a fresh crc."""
        data = np.asarray(data)
        if data.shape != self.splits[i].shape:
            raise ValueError(
                f"replace_split must preserve the split's shape "
                f"{self.splits[i].shape}, got {data.shape}")
        if data.dtype != self.splits[i].dtype:
            raise ValueError(
                f"replace_split must preserve the split's dtype "
                f"{self.splits[i].dtype}, got {data.dtype}")
        self.splits[i] = data

    # -- counted reads ---------------------------------------------------
    def read_split(self, i: int) -> np.ndarray:
        self.stats.add(splits=1, rows=self.split_sizes[i])
        return self.splits[i]

    def read_rows(self, split: int, rows: np.ndarray) -> np.ndarray:
        """Pre-map style row-granular read (the LineRecordReader analogue)."""
        self.stats.add(splits=1, rows=len(rows))
        return self.splits[split][rows]

    def iter_batches(self, chunk: int,
                     start_row: int = 0) -> Iterator[np.ndarray]:
        """Counted sequential read as fixed-size ``chunk``-row batches.

        Yields ``ceil((N - start_row) / chunk)`` arrays of ``chunk`` rows
        each (the last one ragged), crossing split boundaries — the
        disk-order stream the streaming bootstrap driver
        (core/streaming.py) consumes.  Each split is opened exactly once,
        so ``stats`` records one full pass.  Batches that fall inside a
        single split are zero-copy views of it; treat them as read-only.

        ``start_row`` resumes the stream at that global row (the
        checkpoint-restart path): splits entirely before it are SKIPPED
        without being opened (no counted read — a resumed run pays only
        for the rows it still needs), and a split straddling it is opened
        once with only its tail consumed.
        """
        if chunk <= 0:
            raise ValueError(f"chunk must be positive, got {chunk}")
        if start_row < 0 or start_row > self.N:
            raise ValueError(f"start_row must be in [0, {self.N}], "
                             f"got {start_row}")
        parts: List[np.ndarray] = []
        have = 0
        for i in range(len(self.splits)):
            if self.offsets[i + 1] <= start_row:
                continue                       # entirely consumed: skip read
            s = self.read_split(i)
            pos = max(0, start_row - int(self.offsets[i]))
            while pos < len(s):
                take = min(chunk - have, len(s) - pos)
                parts.append(s[pos:pos + take])
                have += take
                pos += take
                if have == chunk:
                    yield (parts[0] if len(parts) == 1
                           else np.concatenate(parts, axis=0))
                    parts, have = [], 0
        if have:
            yield (parts[0] if len(parts) == 1
                   else np.concatenate(parts, axis=0))

    def read_all(self) -> np.ndarray:
        """Everything, in store order — one preallocated buffer filled from
        ``iter_batches`` (the old ``np.concatenate`` of all splits held two
        full copies live at the peak)."""
        if not self.splits:
            return np.empty((0,), np.float32)
        head = self.splits[0]
        out = np.empty((self.N,) + head.shape[1:], head.dtype)
        pos = 0
        for b in self.iter_batches(max(self.split_sizes)):
            out[pos:pos + len(b)] = b
            pos += len(b)
        return out

    def locate(self, global_rows: np.ndarray):
        """global row ids -> (split ids, local rows)."""
        split = np.searchsorted(self.offsets, global_rows, side="right") - 1
        local = global_rows - self.offsets[split]
        return split, local
