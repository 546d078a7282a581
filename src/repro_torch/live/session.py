"""LiveSession: a standing windowed bootstrap over an ingest stream.

The port of the JAX package's ``live/session.py``.  One session is one
statistic (optionally windowed by ``core.reduce_api.TumblingWindow`` or
``SlidingWindow``) kept warm against a stream of ``LogBatch``es.  Every
arrival folds O(Δn) work into mergeable per-pane states on the session's
device and re-emits a ``LiveReport`` (estimate, CI and stream health):
the live form of the paper's ever-improving early results.

A fold copies the batch and its pane masks to the device in one buffer,
then runs ``fused_resample_states`` once for every pane the batch
overlaps, each time over the WHOLE batch under that pane's exact 0/1 mask
and the batch's own seed ``offset_seed(base_seed, seq)``.  Slicing the
batch instead would move every weight's column (and the RNG tile
clamp), so the bits would part from the JAX package's and from resume.

The robustness contract, bitwise where it says so:

* **Exactly-once folding.**  Batches fold strictly in sequence order
  through a reorder buffer; a re-delivered sequence number is counted and
  dropped.  Batch ``seq``'s weights are keyed by position, not arrival,
  so any duplicated or reordered delivery that folds the same batches
  gives bitwise the same states.
* **Watermark and late data.**  The watermark is the contiguous fold
  point.  When the newest delivered seq runs ``LagPolicy.max_lag_batches``
  ahead of it, the missing batches are declared lost: their rows are
  charged to their panes as invalid (``p_eff`` drops and the CI widens,
  EARL §3.4) and the watermark advances.  A lost batch that shows up later
  is folded into its pane if the pane is still live (``late="fold"``) or
  counted and dropped (``late="drop"``).
* **Sample shedding.**  When the backlog at fold time exceeds
  ``LagPolicy.shed_backlog``, the batch is thinned by a seeded numpy row
  mask (survival ``p_shed``, keyed by (shed_seed, seq)) folded through
  the same exact 0/1 ``valid_mask`` as every degraded path, and
  ``correct(p_eff)`` widens the CI by the shed fraction.
* **Bounded memory.**  Windowed state is a ring of at most
  ``window.panes`` per-pane states; eviction drops a pane and re-merges
  the survivors.  Exceeding the bound raises.
* **Crash safety.**  ``checkpoint=`` snapshots the pane ring and the fold
  cursor through ``CheckpointManager`` every ``checkpoint_every`` folds;
  ``resume=True`` restores it (fingerprint-checked) onto the session's
  device and replays the log from ``next_seq``, bitwise the
  uninterrupted run wherever it was killed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import accuracy
from repro_torch.core.bootstrap import (fused_resample_states, offset_seed,
                                        seed_from_key)
from repro_torch.core.reduce_api import Statistic, Window, split_params
from repro_torch.core.streaming import run_fingerprint
from repro_torch.device import resolve_device
from repro_torch.ft.policy import LagPolicy
from repro_torch.live.log import IngestLog, LogBatch

# floats of padding that keep the masks' part of a fold's staging buffer
# 256-byte aligned on the device
_ALIGN = 64


@dataclasses.dataclass
class LiveCounters:
    """Stream-health totals for one standing session."""
    folded: int = 0              # batches folded exactly once
    duplicates: int = 0          # re-deliveries dropped by seq dedup
    reordered: int = 0           # arrivals ahead of the fold point
    gaps_skipped: int = 0        # batches declared lost by the watermark
    gap_rows: int = 0            # rows charged invalid for those batches
    late_folded: int = 0         # lost batches that arrived and folded
    late_dropped: int = 0        # lost batches dropped per policy
    shed_batches: int = 0        # batches folded through a shed mask
    shed_rows: int = 0           # rows removed by shedding


@dataclasses.dataclass(frozen=True)
class LiveReport:
    """One per-arrival emission: the windowed estimate and CI, the
    ``p_eff`` it was corrected with, and where the stream stands."""
    seq: int                     # the batch this emission folded
    watermark_seq: int           # highest contiguously folded seq
    watermark_row: int           # rows accounted below the watermark
    window_start: int            # first row the report covers (pane-aligned)
    window_end: int              # == watermark_row
    rows: int                    # rows charged to the window (incl. lost/shed)
    valid_rows: int              # rows that actually contributed
    p_eff: float                 # valid_rows / rows: the correct() fraction
    panes_live: int              # ring occupancy (<= memory bound)
    shed: bool                   # this fold went through a shed mask
    estimate: Any                # corrected point estimate
    thetas: Any                  # corrected bootstrap distribution
    report: Any                  # AccuracyReport / Group- / KeyedAccuracyReport
    counters: LiveCounters       # snapshot at emission time


@dataclasses.dataclass
class _Pane:
    """Ring slot: per-resample states (leading B), the unweighted estimate
    state, and the rows charged to and validated in this pane."""
    states: Any
    est: Any
    rows: int = 0
    valid: int = 0


class LiveSession:
    """Standing session over an ``IngestLog`` (see module docstring).

    ``stat`` is a ``Statistic`` (cumulative over the whole stream: one
    ever-growing pane) or a ``Window`` around one.  ``feed(batch)`` is the
    delivery entry point (fault-injected tests drive it directly);
    ``poll()`` pulls everything new from the log and feeds it.  Both return
    the ``LiveReport``s of the folds they caused.  ``device=None`` folds on
    the card.
    """

    def __init__(self, log: Optional[IngestLog], stat, B: int, key,
                 policy: Optional[LagPolicy] = None, alpha: float = 0.05,
                 checkpoint=None, checkpoint_every: int = 1,
                 resume: bool = False, name: str = "live", device=None):
        if isinstance(stat, Window):
            self.window: Optional[Window] = stat
            stat = stat.stat
        else:
            self.window = None
        if not isinstance(stat, Statistic):
            raise TypeError("stat must be a reduce_api.Statistic or a "
                            "Window around one")
        if not getattr(stat, "mergeable", True):
            raise ValueError(
                f"LiveSession folds per-batch states with merge(), but "
                f"{type(stat).__name__} sets mergeable=False")
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        if resume and checkpoint is None:
            raise ValueError("resume=True needs checkpoint= (where would "
                             "the cursor come from?)")
        self.device = resolve_device(device)
        self.log = log
        self.stat = stat
        self.B = int(B)
        self.alpha = float(alpha)
        self.policy = policy if policy is not None else LagPolicy()
        self.name = name
        self._slide = self.window.slide if self.window else None
        #: hard ring-occupancy bound: the window's panes, or the single
        #: cumulative pane.  Checked after every fold and eviction.
        self.memory_bound = self.window.panes if self.window else 1

        spec, params = split_params(stat)
        self._base_seed = seed_from_key(key)
        wsz = self.window.size if self.window else 0
        wsl = self.window.slide if self.window else 0
        self.fingerprint = run_fingerprint(spec, params, self.B,
                                           self._base_seed, wsz, wsl)

        mgr = checkpoint
        if isinstance(mgr, str):
            from repro_torch.checkpoint.manager import CheckpointManager
            # sessions sharing one root path are scoped by fingerprint, so
            # their steps and keep-k GC never touch each other's snapshots
            mgr = CheckpointManager.for_run(mgr, self.fingerprint)
        self.checkpoint = mgr
        self.checkpoint_every = int(checkpoint_every)

        self._dim: Optional[int] = None
        self._ring: Dict[int, _Pane] = {}
        self._buffer: Dict[int, LogBatch] = {}
        self._lost: set = set()
        self._next_seq = 0
        self._max_seen = -1
        self._end_row = 0
        self.counters = LiveCounters()

        if resume:
            self._restore()
        if log is not None:
            log.register(self.name)
            if self._next_seq > 0:
                log.ack(self.name, self._next_seq - 1)

    # -- geometry -------------------------------------------------------
    def _pane_of(self, row: int) -> int:
        return 0 if self._slide is None else int(row) // self._slide

    def _keep_lo(self) -> int:
        """Lowest pane index the ring keeps at the current watermark."""
        if self.window is None:
            return 0
        hi = self._pane_of(max(self._end_row - 1, 0))
        return max(0, hi - self.window.panes + 1)

    @property
    def panes_live(self) -> int:
        return len(self._ring)

    @property
    def watermark_seq(self) -> int:
        return self._next_seq - 1

    @property
    def watermark_row(self) -> int:
        return self._end_row

    # -- pane plumbing --------------------------------------------------
    def _init_pane(self) -> _Pane:
        return _Pane(states=self.stat.init_batch(self._dim, self.B,
                                                 self.device),
                     est=self.stat.init_state(self._dim, self.device))

    def _pane(self, p: int) -> _Pane:
        if p not in self._ring:
            self._ring[p] = self._init_pane()
        return self._ring[p]

    def _account_gap(self, row_a: int, row_b: int) -> None:
        """Charge lost rows [row_a, row_b) to their panes as invalid, so
        they lower ``p_eff`` instead of leaving a silent hole.  Panes the
        advancing watermark evicts anyway are not created."""
        if row_b <= row_a:
            return
        if self.window is None:
            self._pane(0).rows += row_b - row_a
            return
        keep_lo = max(0, self._pane_of(row_b - 1) - self.window.panes + 1)
        for p in range(max(self._pane_of(row_a), keep_lo),
                       self._pane_of(row_b - 1) + 1):
            lo, hi = self.window.pane_rows(p)
            self._pane(p).rows += min(row_b, hi) - max(row_a, lo)

    def _evict(self) -> None:
        keep_lo = self._keep_lo()
        for p in [p for p in self._ring if p < keep_lo]:
            del self._ring[p]
        if len(self._ring) > self.memory_bound:
            raise RuntimeError(
                f"pane ring holds {len(self._ring)} panes, bound is "
                f"{self.memory_bound}: memory-bound invariant violated")

    # -- delivery -------------------------------------------------------
    def feed(self, batch: LogBatch) -> List[LiveReport]:
        """Deliver one batch (any order, any multiplicity); returns the
        reports of the folds this delivery unlocked."""
        s = int(batch.seq)
        self._max_seen = max(self._max_seen, s)
        if s < self._next_seq:
            if s in self._lost:
                return self._late(batch)
            self.counters.duplicates += 1
            return []
        if s in self._buffer:
            self.counters.duplicates += 1
            return []
        if s != self._next_seq:
            self.counters.reordered += 1
        self._buffer[s] = batch
        return self._drain()

    def poll(self) -> List[LiveReport]:
        """Pull everything new from the log and fold it.  The backlog is
        observed first (``_max_seen`` jumps to the newest sealed batch),
        so shedding depends on the log at poll time, and a resumed session
        polling the same log makes the same decisions."""
        if self.log is None:
            raise ValueError("poll() needs a log; feed() batches directly")
        avail = self.log.next_seq
        self._max_seen = max(self._max_seen, avail - 1)
        out: List[LiveReport] = []
        for b in self.log.batches_from(self._next_seq):
            if b.seq in self._buffer or b.seq < self._next_seq:
                continue
            out.extend(self.feed(b))
        return out

    # -- folding --------------------------------------------------------
    def _drain(self) -> List[LiveReport]:
        out: List[LiveReport] = []
        while True:
            if self._next_seq in self._buffer:
                b = self._buffer.pop(self._next_seq)
                # advance before folding, so the report's watermark_seq
                # includes the batch it folded
                self._next_seq += 1
                out.append(self._fold(b))
                if self.log is not None:
                    self.log.ack(self.name, self._next_seq - 1)
                if (self.checkpoint is not None and
                        self.counters.folded % self.checkpoint_every == 0):
                    self._save()
                continue
            if (self._buffer and
                    self._max_seen - self._next_seq
                    >= self.policy.max_lag_batches):
                # watermark advance: the gap [next_seq, first buffered) is
                # declared lost, charged invalid, and the CI widens
                m = min(self._buffer)
                self.counters.gaps_skipped += m - self._next_seq
                gap = self._buffer[m].row0 - self._end_row
                self.counters.gap_rows += gap
                self._lost.update(range(self._next_seq, m))
                self._account_gap(self._end_row, self._buffer[m].row0)
                self._end_row = self._buffer[m].row0
                self._next_seq = m
                self._evict()
                continue
            return out

    def _masks_for(self, row0: int, nb: int, valid: np.ndarray):
        """(pane, 0/1 mask over the batch) for every pane that rows
        [row0, row0+nb) overlap: ``valid`` restricted to the pane's rows,
        exact 0.0/1.0 f32."""
        if self.window is None:
            return [(0, valid)]
        out = []
        for p in range(self._pane_of(row0), self._pane_of(row0 + nb - 1) + 1):
            lo, hi = self.window.pane_rows(p)
            m = np.zeros(nb, np.float32)
            a, b = max(lo, row0) - row0, min(hi, row0 + nb) - row0
            m[a:b] = valid[a:b]
            out.append((p, m))
        return out

    def _stage(self, xb: np.ndarray, masks: List[np.ndarray]):
        """The batch (nb, d) and its pane masks (P, nb) on the device,
        through one host-to-device copy of one buffer."""
        nb, d = xb.shape
        x_end = nb * d
        m0 = x_end + (-x_end) % _ALIGN
        buf = np.empty(m0 + len(masks) * nb, np.float32)
        buf[:x_end] = xb.reshape(-1)
        buf[x_end:m0] = 0.0
        buf[m0:] = np.concatenate(masks)
        t = torch.from_numpy(buf).to(self.device)
        return t[:x_end].view(nb, d), t[m0:].view(len(masks), nb)

    def _fold_into_panes(self, batch: LogBatch, valid: np.ndarray) -> None:
        xb = np.asarray(batch.data, np.float32)
        if xb.ndim == 1:
            xb = xb[:, None]
        panes = self._masks_for(batch.row0, len(xb), valid)
        xd, md = self._stage(xb, [m for _, m in panes])
        seed = offset_seed(self._base_seed, batch.seq)
        stat = self.stat
        for (p, m), mask in zip(panes, md):
            pane = self._pane(p)
            # the same math as the streaming driver's chunk fold:
            # merge(pane, delta), in that order
            pane.est = stat.update(pane.est, xd, mask)
            delta = fused_resample_states(stat, seed, xd, self.B,
                                          valid_mask=mask)
            pane.states = stat.merge(pane.states, delta)
            pane.valid += int(m.sum())

    def _shed_mask(self, seq: int, nb: int) -> np.ndarray:
        """Seeded Poisson thinning mask for batch ``seq``: a function of
        (shed_seed, seq) only, so a resumed run sheds the same rows."""
        rng = np.random.default_rng((int(self.policy.shed_seed), int(seq)))
        return (rng.random(nb) < self.policy.p_shed).astype(np.float32)

    def _fold(self, batch: LogBatch) -> LiveReport:
        if self._dim is None:
            d = np.asarray(batch.data)
            self._dim = 1 if d.ndim == 1 else int(d.shape[1])
        nb = batch.rows
        lag = self._max_seen - batch.seq
        shed = (self.policy.shed_backlog is not None
                and lag > self.policy.shed_backlog)
        valid = self._shed_mask(batch.seq, nb) if shed \
            else np.ones(nb, np.float32)
        if shed:
            self.counters.shed_batches += 1
            self.counters.shed_rows += nb - int(valid.sum())
        # charge the batch's whole extent to its panes (shed rows stay in
        # the denominator: that is what widens the CI)
        for p, m in self._masks_for(batch.row0, nb, np.ones(nb, np.float32)):
            self._pane(p).rows += int(m.sum())
        self._fold_into_panes(batch, valid)
        self._end_row = batch.row_end
        self.counters.folded += 1
        self._evict()
        return self._emit(batch.seq, shed)

    def _late(self, batch: LogBatch) -> List[LiveReport]:
        """A batch the watermark already declared lost showed up."""
        self._lost.discard(batch.seq)
        panes = ([0] if self.window is None else
                 list(range(self._pane_of(batch.row0),
                            self._pane_of(batch.row_end - 1) + 1)))
        if (self.policy.late != "fold"
                or any(p not in self._ring for p in panes)):
            self.counters.late_dropped += 1
            return []
        # its rows were charged at gap time; folding now adds their valid
        # contribution under the batch's own position-keyed stream
        self._fold_into_panes(batch, np.ones(batch.rows, np.float32))
        self.counters.late_folded += 1
        return [self._emit(batch.seq, False)]

    # -- reporting ------------------------------------------------------
    def _emit(self, seq: int, shed: bool) -> LiveReport:
        stat = self.stat
        panes = sorted(self._ring)
        merged = self._ring[panes[0]]
        states, est = merged.states, merged.est
        for p in panes[1:]:          # ascending pane order, every report
            states = stat.merge(states, self._ring[p].states)
            est = stat.merge(est, self._ring[p].est)
        rows = sum(self._ring[p].rows for p in panes)
        valid = sum(self._ring[p].valid for p in panes)
        p_eff = (valid / rows) if rows > 0 else 1.0
        thetas = stat.correct(stat.finalize_batch(states), p_eff)
        estimate = stat.correct(stat.finalize(est), p_eff)
        window_start = (self._keep_lo() * self._slide
                        if self.window is not None else 0)
        return LiveReport(
            seq=int(seq), watermark_seq=self.watermark_seq,
            watermark_row=self._end_row, window_start=int(window_start),
            window_end=self._end_row, rows=int(rows), valid_rows=int(valid),
            p_eff=float(p_eff), panes_live=len(self._ring), shed=bool(shed),
            estimate=estimate, thetas=thetas,
            report=accuracy.report_for(
                thetas, alpha=self.alpha,
                num_groups=getattr(stat, "num_groups", None)),
            counters=dataclasses.replace(self.counters))

    def report(self) -> Optional[LiveReport]:
        """The current window's report without folding anything."""
        if not self._ring:
            return None
        return self._emit(self.watermark_seq, False)

    # -- crash safety ---------------------------------------------------
    def _save(self) -> None:
        state = {f"p{p}": (self._ring[p].states, self._ring[p].est)
                 for p in sorted(self._ring)}
        self.checkpoint.save(self.counters.folded, state, extra={"cursor": {
            "kind": "live", "fingerprint": self.fingerprint,
            "next_seq": int(self._next_seq), "end_row": int(self._end_row),
            "max_seen": int(self._max_seen), "dim": int(self._dim),
            "lost": sorted(int(s) for s in self._lost),
            "counters": dataclasses.asdict(self.counters),
            "panes": {str(p): [int(self._ring[p].rows),
                               int(self._ring[p].valid)]
                      for p in sorted(self._ring)}}})

    def _restore(self) -> None:
        mgr = self.checkpoint
        cur = mgr.meta().get("cursor")
        if cur is None or cur.get("kind") != "live":
            raise ValueError(
                f"checkpoint under {mgr.root} has no LiveSession cursor: "
                "not a LiveSession checkpoint")
        if cur["fingerprint"] != self.fingerprint:
            raise ValueError(
                "checkpoint fingerprint mismatch: the snapshot was taken "
                "under a different (statistic, B, key, window); resuming "
                "it would silently produce a different estimator "
                f"(checkpoint {cur['fingerprint'][:12]}…, "
                f"run {self.fingerprint[:12]}…)")
        self._dim = int(cur["dim"])
        # fresh panes on the session's device are the template, so the
        # restored tensors land there
        template = {}
        for p in sorted(int(k) for k in cur["panes"]):
            fresh = self._init_pane()
            template[f"p{p}"] = (fresh.states, fresh.est)
        state, _ = mgr.restore(template)
        for p_str, (rows, valid) in cur["panes"].items():
            states, est = state[f"p{int(p_str)}"]
            self._ring[int(p_str)] = _Pane(states=states, est=est,
                                           rows=int(rows), valid=int(valid))
        self._next_seq = int(cur["next_seq"])
        self._end_row = int(cur["end_row"])
        self._max_seen = int(cur["max_seen"])
        self._lost = set(int(s) for s in cur["lost"])
        self.counters = LiveCounters(**cur["counters"])
