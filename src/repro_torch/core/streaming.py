"""Double-buffered streaming bootstrap over a ShardedStore, crash-safe.

The port of the JAX package's ``core/streaming.py``.  ``bootstrap_chunked``
starts from a sample already on the device; a real EARL run starts from a
sharded store whose rows must cross to the card first.  This driver
overlaps the two:

* a host *prefetch thread* pulls fixed-size batches from
  ``ShardedStore.iter_batches(chunk)``, pads the ragged tail, builds the
  chunk's 0/1 validity mask and stages both onto the device.  On the card
  it copies each batch into a pinned host buffer and starts the
  host-to-device copy with ``non_blocking=True`` on a side CUDA stream,
  recording an event after it (a ring of ``queue_depth + 2`` pinned and
  device buffers, ``_Stager``, so the device holds the same chunk buffers
  whatever n);
* a bounded hand-off queue (``queue_depth``, default 2) gives double
  buffering: one chunk in compute, the next staged or in flight;
* the main thread makes its stream wait on the chunk's event (no host
  sync), then folds the chunk into the running per-resample states with
  the same update as ``bootstrap_chunked``: chunk i draws its implicit
  Poisson(1) weights from ``offset_seed(seed_from_key(key), i)`` and the
  unweighted estimate rides the same pass.

So the result is bitwise ``bootstrap_chunked(store.read_all(), stat, B,
key, chunk=chunk, backend="fused_rng")`` on the same device (a chunk's
prefix mask weights exactly as its ``n_valid``), while the device holds
O(B·state + queue_depth·chunk·d), whatever n.

Crash safety, all off by default:

* ``checkpoint=``/``checkpoint_every=``/``resume=``: every k chunks the
  carry ``(states, est)`` and a cursor (next chunk, rows consumed, base
  seed, run fingerprint) are saved atomically by ``CheckpointManager``,
  which copies the carry to the host before it returns.  Chunk i's weights
  are keyed by ``offset_seed(base_seed, i)`` and the fold is a left merge
  in chunk order, so a killed run resumed from its last checkpoint is
  bitwise the uninterrupted run, and re-reads only the rows past the
  cursor.
* ``retry=``/``policy=``: the prefetch thread reads through
  ``ft.ResilientStore`` (per-split checksum and row-count validation,
  bounded retry with exponential backoff, a per-read deadline); the fault
  counts surface in ``StreamReport.faults``.
* degradation: with ``policy.on_exhausted="degrade"`` a split that fails
  its whole retry budget is LOST: its rows enter their chunk as zeros under
  a zero mask (chunk boundaries and weight streams stay aligned) and the
  result is corrected by ``p·valid_rows/N``, so the CI widens honestly.
"""
from __future__ import annotations

import dataclasses
import hashlib
import queue as queue_mod
import threading
import time
import zlib
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import accuracy
from repro_torch.core.bootstrap import (BootstrapResult, fused_resample_states,
                                        offset_seed, seed_from_key)
from repro_torch.core.reduce_api import Statistic, split_params
from repro_torch.device import resolve_device


@dataclasses.dataclass
class StreamReport:
    """Where the streamed run's wall time went (host clock).

    ``stage_s`` is the prefetch thread's time to read, pad and stage its
    batches (on the card: the pinned copy and the asynchronous transfer's
    enqueue); ``wait_s`` is how long the main thread sat idle on the
    hand-off queue (transfer-bound when large); ``dispatch_s`` is the main
    thread's per-chunk dispatch time plus the one trailing synchronize
    (compute-bound when large).  Perfect overlap drives ``wall_s`` toward
    max(stage, compute) instead of their sum.

    ``checkpoint_s``/``n_checkpoints`` are the snapshots' cost,
    ``resumed_from_chunk`` where a resumed run picked up (None for a fresh
    run), ``faults`` the resilient read path's counters (None without
    ``retry``/``policy``), ``lost_splits`` the splits degraded to masked
    zeros and ``valid_rows`` the rows that contributed.
    """
    wall_s: float
    stage_s: float
    wait_s: float
    dispatch_s: float
    n_chunks: int
    rows: int
    checkpoint_s: float = 0.0
    n_checkpoints: int = 0
    resumed_from_chunk: Optional[int] = None
    faults: Optional[object] = None          # ft.FaultCounters
    lost_splits: Tuple[int, ...] = ()
    valid_rows: int = -1


@dataclasses.dataclass
class StreamingBootstrapResult(BootstrapResult):
    stream: StreamReport = None


def _put_until(out_q, item, stop) -> bool:
    """Blocking put that gives up when the consumer sets ``stop``, so the
    producer never blocks forever on a full queue after the consumer
    died."""
    while not stop.is_set():
        try:
            out_q.put(item, timeout=0.05)
            return True
        except queue_mod.Full:
            continue
    return False


class _Stager:
    """Moves a padded host batch and its mask onto ``device``.  On the card
    it owns a ring of ``slots`` pinned host buffers and as many device
    buffers: batch j goes to slot j % slots, through the pinned buffer
    (reused once its previous copy has landed) and an asynchronous copy on
    the side stream, which first waits until the consumer has folded the
    slot's previous batch.  The ring holds at most queue_depth + 1 unfolded
    batches and the one being staged, so ``queue_depth + 2`` slots never
    overwrite a batch still in use, and the device holds the same
    ``slots`` buffers whatever n."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.slots = slots
        self.bufs = []              # (pinned x, pinned mask, x, mask, copy)
        self.done = [None] * slots  # fold of each slot's batch (consumer)
        self.k = 0
        self.side = self.consumer = None
        if device.type == "cuda":
            self.side = torch.cuda.Stream(device)
            self.consumer = torch.cuda.current_stream(device)

    def __call__(self, xb: np.ndarray, mask: np.ndarray):
        """(x, mask, event of their copy or None, slot or None)."""
        if self.side is None:
            return torch.from_numpy(xb), torch.from_numpy(mask), None, None
        k = self.k
        if len(self.bufs) <= k:
            # Allocated on the side stream, which writes them: a block
            # freed on the consumer's stream may still be read there by a
            # queued kernel (a chunk's transposed copy is this size), and
            # the side stream's copy is not ordered after it.  Kept from
            # reuse until the consumer's last use of them.
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self.side):
                dx = torch.empty(xb.shape, device=self.device)
                dm = torch.empty(mask.shape, device=self.device)
            dx.record_stream(self.consumer)
            dm.record_stream(self.consumer)
            self.bufs.append((torch.empty(xb.shape, pin_memory=True),
                              torch.empty(mask.shape, pin_memory=True),
                              dx, dm, None))
        px, pm, dx, dm, copied = self.bufs[k]
        if copied is not None:
            copied.synchronize()    # the pinned buffers' last copy landed
        np.copyto(px.numpy(), xb)
        np.copyto(pm.numpy(), mask)
        with torch.cuda.device(self.device), torch.cuda.stream(self.side):
            if self.done[k] is not None:
                self.side.wait_event(self.done[k])
            dx.copy_(px, non_blocking=True)
            dm.copy_(pm, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.side)
        self.bufs[k] = (px, pm, dx, dm, copied)
        self.k = (k + 1) % self.slots
        return dx, dm, copied, k

    def folded(self, k) -> None:
        """The consumer has enqueued its last use of slot ``k``."""
        if k is not None:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self.done[k] = ev


def _stage_batches(store, chunk: int, dim: int, out_q, timings: dict, stop,
                   stage: _Stager, start_row: int = 0,
                   stop_row: Optional[int] = None) -> None:
    """Prefetch-thread body: read → pad → mask → stage → enqueue.

    Each item carries the chunk's 0/1 validity mask: zeros for the padded
    tail and for rows of splits the resilient read path declared lost
    (``invalid_row_ranges``, known by the time the batch is assembled).
    ``stop_row`` bounds the pass to the store's first ``stop_row`` rows:
    the stream is exactly what a store holding only those rows would
    yield.  Exceptions are forwarded to the consumer; ``stop`` (set by the
    consumer's cleanup) aborts a blocked enqueue."""
    stage_s = 0.0
    try:
        row0 = start_row
        for batch in store.iter_batches(chunk, start_row=start_row):
            if stop_row is not None and row0 >= stop_row:
                break
            t0 = time.perf_counter()
            xb = np.asarray(batch, np.float32).reshape(len(batch), dim)
            if stop_row is not None and row0 + len(xb) > stop_row:
                xb = xb[:stop_row - row0]
            nb = len(xb)
            mask = np.zeros((chunk,), np.float32)
            mask[:nb] = 1.0
            for lo, hi in (store.invalid_row_ranges()
                           if hasattr(store, "invalid_row_ranges") else ()):
                a, b = max(lo, row0) - row0, min(hi, row0 + nb) - row0
                if a < b:
                    mask[a:b] = 0.0
            if nb < chunk:
                xb = np.concatenate([xb, np.zeros((chunk - nb, dim),
                                                  np.float32)])
            else:
                xb = np.ascontiguousarray(xb)
            xd, md, ev, slot = stage(xb, mask)
            stage_s += time.perf_counter() - t0
            row0 += nb
            if not _put_until(out_q, (xd, md, ev, slot, nb,
                                      int(mask.sum())), stop):
                return
        _put_until(out_q, None, stop)
    except BaseException as exc:                # noqa: BLE001 — forwarded
        _put_until(out_q, exc, stop)
    finally:
        timings["stage_s"] = stage_s


def run_fingerprint(spec, params, *extra: int,
                    content: Optional[int] = None) -> str:
    """Digest of everything a bitwise resume depends on: the statistic's
    structural spec and its tensor parameters (``reduce_api.split_params``;
    a resume with other KMeans centroids is another run), the caller's
    integer run knobs (B, chunk, base seed, extent, ...) and, optionally,
    a content digest of the data (``store_content_digest``)."""
    h = hashlib.sha256()
    h.update(repr(spec).encode())
    for path in sorted(params):
        t = params[path].detach().to("cpu").contiguous()
        h.update(path.encode())
        h.update(t.numpy().tobytes())
    h.update(repr(tuple(int(e) for e in extra)).encode())
    if content is not None:
        h.update(b"content:" + repr(int(content)).encode())
    return h.hexdigest()


def store_content_digest(store, upto_row: Optional[int] = None) -> int:
    """Order-sensitive combination of every split's cached crc32: the
    opt-in content half of the resume fingerprint, equal to the JAX
    package's for the same store.  ``upto_row`` restricts it to the splits
    that overlap the first ``upto_row`` rows (the pinned-extent path)."""
    h = 0
    for s in range(len(store.splits)):
        if upto_row is not None and int(store.offsets[s]) >= upto_row:
            break
        h = zlib.crc32(int(store.split_checksum(s)).to_bytes(4, "little"),
                       h)
    return h


def bootstrap_streaming(store, stat: Statistic, B: int, key,
                        chunk: int = 65536, p: float = 1.0,
                        alpha: float = 0.05,
                        backend: Optional[str] = "fused_rng",
                        queue_depth: int = 2,
                        checkpoint=None, checkpoint_every: int = 1,
                        resume: bool = False,
                        retry=None, policy=None,
                        fingerprint_content: bool = False,
                        n_rows: Optional[int] = None,
                        device=None) -> StreamingBootstrapResult:
    """Streamed bootstrap over ``store`` (the module docstring says how),
    bitwise ``bootstrap_chunked(store.read_all(), stat, B, key,
    chunk=chunk, backend="fused_rng", device=device)``.

    Matrix-free only (``backend="fused_rng"``): nothing of size n may
    exist on either side of the link.  ``checkpoint=`` (a
    ``CheckpointManager`` or a root path) snapshots the carry every
    ``checkpoint_every`` chunks; ``resume=True`` restores the latest
    snapshot, fingerprint-checked, and continues.  ``retry=`` (an
    ``ft.RetryPolicy``) or ``policy=`` (an ``ft.FailurePolicy``, which
    also decides raise or degrade when the budget is spent) route the
    reads through ``ft.ResilientStore``.  ``fingerprint_content=True``
    also binds the fingerprint to the store's bytes (one full read the
    first time); save and resume must both opt in.  ``n_rows=`` pins the
    pass to the store's first ``n_rows`` rows, so a resume over a store
    that grew in between stays bitwise.  ``device=None`` means the card.
    """
    if not isinstance(stat, Statistic):
        raise TypeError("stat must be a reduce_api.Statistic")
    if backend != "fused_rng":
        raise ValueError(
            f"bootstrap_streaming is matrix-free only and got "
            f"backend={backend!r}; the only supported backend is "
            "'fused_rng' (a materialized (B, chunk) weight matrix would "
            "defeat the streaming memory contract)")
    # Fail before the prefetch thread starts: a non-mergeable statistic
    # cannot fold chunk i+1's states into chunk i's carry.
    if not getattr(stat, "mergeable", True):
        raise ValueError(
            f"bootstrap_streaming folds per-chunk states with merge(), but "
            f"{type(stat).__name__} sets mergeable=False: stream a "
            "mergeable statistic, or run the single-pass bootstrap "
            "(backend='fused_rng') on the materialized sample instead")
    if store.N == 0:
        raise ValueError("bootstrap_streaming needs a non-empty store")
    if n_rows is None:
        n_rows = int(store.N)
    elif not 0 < n_rows <= store.N:
        raise ValueError(f"n_rows must be in [1, {store.N}] "
                         f"(the store's current extent), got {n_rows}")
    else:
        n_rows = int(n_rows)
    if queue_depth < 1:
        raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}")
    if resume and checkpoint is None:
        raise ValueError("resume=True needs checkpoint= (where would the "
                         "cursor come from?)")
    dev = resolve_device(device)
    head = store.splits[0]
    dim = int(np.prod(head.shape[1:])) if head.ndim > 1 else 1

    mgr = checkpoint
    if isinstance(mgr, str):
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(mgr, async_save=True)

    # resilient read path: policy wins over bare retry
    reader = store
    counters = None
    if policy is not None or retry is not None:
        from repro_torch.ft.inject import FaultCounters, ResilientStore
        counters = FaultCounters()
        if policy is not None:
            reader = ResilientStore(store, policy.retry, counters,
                                    on_exhausted=policy.on_exhausted)
        else:
            reader = ResilientStore(store, retry, counters,
                                    on_exhausted="raise")

    B = int(B)
    spec, params = split_params(stat)
    base_seed = seed_from_key(key)
    fp = run_fingerprint(spec, params, B, chunk, base_seed, n_rows, dim,
                         content=(store_content_digest(store,
                                                       upto_row=n_rows)
                                  if fingerprint_content else None))
    states = stat.init_batch(dim, B, dev)
    est = stat.init_state(dim, dev)

    start_chunk = 0
    rows_done = 0
    valid_rows = 0
    prior_lost: Tuple[int, ...] = ()
    resumed_from = None
    if resume:
        # the cursor first: a wrong-run checkpoint must fail on the
        # fingerprint, not on a shape mismatch
        cur = mgr.meta().get("cursor")
        if cur is None:
            raise ValueError(
                f"checkpoint under {mgr.root} has no streaming cursor: "
                "not a bootstrap_streaming checkpoint")
        if cur["fingerprint"] != fp:
            raise ValueError(
                "checkpoint fingerprint mismatch: the snapshot was taken "
                "under a different (statistic, B, chunk, key, store); "
                "resuming it would silently produce a different estimator "
                f"(checkpoint {cur['fingerprint'][:12]}…, run {fp[:12]}…)")
        (states, est), _ = mgr.restore((states, est))
        start_chunk = int(cur["next_chunk"])
        rows_done = int(cur["rows_done"])
        valid_rows = int(cur["valid_rows"])
        prior_lost = tuple(cur.get("lost_splits", ()))
        resumed_from = start_chunk

    q = queue_mod.Queue(maxsize=queue_depth)
    timings: dict = {}
    stop = threading.Event()
    stager = _Stager(dev, queue_depth + 2)
    producer = threading.Thread(
        target=_stage_batches,
        args=(reader, chunk, dim, q, timings, stop, stager, rows_done,
              n_rows),
        name="earl-stream-prefetch", daemon=True)
    t_start = time.perf_counter()
    producer.start()

    wait_s = dispatch_s = ckpt_s = 0.0
    n_ckpts = 0
    i = start_chunk

    def _save_checkpoint():
        # the cursor names the NEXT chunk; lost splits ride along so a
        # resumed run keeps correcting by the right surviving fraction.
        lost_now = tuple(sorted(set(prior_lost)
                                | set(getattr(reader, "lost_splits", ()))))
        mgr.save(i, (states, est), extra={"cursor": {
            "next_chunk": i, "rows_done": rows_done,
            "valid_rows": valid_rows, "lost_splits": list(lost_now),
            "fingerprint": fp, "B": B, "chunk": int(chunk),
            "base_seed": base_seed, "N": int(n_rows)}})

    try:
        while True:
            t0 = time.perf_counter()
            item = q.get()
            wait_s += time.perf_counter() - t0
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            xd, md, ev, slot, nb, nv = item
            t0 = time.perf_counter()
            if ev is not None:
                torch.cuda.current_stream(dev).wait_event(ev)
            est = stat.update(est, xd, md)
            delta = fused_resample_states(stat, offset_seed(base_seed, i),
                                          xd, B, valid_mask=md)
            states = stat.merge(states, delta)
            stager.folded(slot)
            dispatch_s += time.perf_counter() - t0
            rows_done += nb
            valid_rows += nv
            i += 1
            if mgr is not None and (i - start_chunk) % checkpoint_every == 0:
                t0 = time.perf_counter()
                _save_checkpoint()
                ckpt_s += time.perf_counter() - t0
                n_ckpts += 1
    finally:
        # a consumer-side failure (poisoned chunk, checkpoint error, kill)
        # must not strand the producer on a full queue: signal stop, drain
        # what it already staged, and join it.
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue_mod.Empty:
            pass
        producer.join(timeout=10.0)
        if stager.side is not None:
            stager.side.synchronize()   # no copy outlives the run's buffers

    # trailing-edge sync, and a final checkpoint if the cadence missed the
    # end
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dispatch_s += time.perf_counter() - t0
    if mgr is not None and (i - start_chunk) % checkpoint_every != 0:
        t0 = time.perf_counter()
        _save_checkpoint()
        ckpt_s += time.perf_counter() - t0
        n_ckpts += 1
    if mgr is not None:
        mgr.wait()                      # durable before we report success
    wall_s = time.perf_counter() - t_start

    lost = tuple(sorted(set(prior_lost)
                        | set(getattr(reader, "lost_splits", ()))))
    # the survivors represent p·(valid/N) of the population; with no loss
    # valid == N exactly and this is the plain p.
    p_eff = p * (valid_rows / n_rows)
    thetas = stat.correct(stat.finalize_batch(states), p_eff)
    estimate = stat.correct(stat.finalize(est), p_eff)
    return StreamingBootstrapResult(
        estimate=estimate, thetas=thetas,
        report=accuracy.report_for(thetas, alpha=alpha,
                                   num_groups=getattr(stat, "num_groups",
                                                      None)),
        B=B, n=int(valid_rows),
        stream=StreamReport(wall_s=wall_s,
                            stage_s=timings.get("stage_s", 0.0),
                            wait_s=wait_s, dispatch_s=dispatch_s,
                            n_chunks=i - start_chunk, rows=int(n_rows),
                            checkpoint_s=ckpt_s, n_checkpoints=n_ckpts,
                            resumed_from_chunk=resumed_from,
                            faults=counters, lost_splits=lost,
                            valid_rows=int(valid_rows)),
    )
