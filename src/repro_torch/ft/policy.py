"""One FailurePolicy for a run's failure behaviour, end to end.

At the reduce a dead shard and a late shard are the same event, a missing
partial, and EARL's §3.4 answer is never "wait" but "sum what arrived,
bound the error of the survivors, and restart only if the bound misses
sigma".  This module is that one path:

* ``ShardEvents``: what happened to the shards of a run (lost outright,
  per-shard completion times against ``FailurePolicy.deadline_s``).
* ``elastic_estimate``: every failed or late shard folded into ONE row
  mask (``failure_mask``, the mesh path's ceil-sized extents) and the
  mesh step run once with it; a lost shard's partial is exactly zero,
  the survivors' work is not recomputed, and the CI widens through
  ``correct(p)`` with p the surviving fraction.
* ``FailurePolicy``: the verdict (``meets_bound`` -> continue
  approximate, else checkpoint restart), and the prefetch path's
  ``retry``/``on_exhausted`` that the streaming driver reads.
* ``LagPolicy``: a live session's answer to gaps, late batches and
  backlog.

``ft.recovery.estimate_with_failures`` and ``ft.straggler.DeadlineReducer``
are thin veneers over ``elastic_estimate``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.reduce_api import _as_2d
from repro_torch.device import as_tensor
from repro_torch.ft.inject import RetryPolicy
from repro_torch.ft.recovery import ShardLossReport, failure_mask

CONTINUE = "continue_approximate"
RESTART = "checkpoint_restart"


@dataclasses.dataclass
class ShardEvents:
    """What happened to the shards of one run."""
    n_shards: int
    lost: Tuple[int, ...] = ()
    completion_s: Optional[Sequence[float]] = None

    def late(self, deadline_s: Optional[float]) -> Tuple[int, ...]:
        if self.completion_s is None or deadline_s is None:
            return ()
        if len(self.completion_s) != self.n_shards:
            raise ValueError(
                f"completion_s has {len(self.completion_s)} entries for "
                f"{self.n_shards} shards")
        return tuple(i for i, t in enumerate(self.completion_s)
                     if t > deadline_s)


@dataclasses.dataclass
class FailurePolicy:
    """How a run responds to failure, end to end.

    ``sigma``/``deadline_s`` govern the reduce-side verdict
    (``elastic_estimate``); ``retry``/``on_exhausted`` govern the
    prefetch-side read path (``bootstrap_streaming``'s ``ResilientStore``);
    ``checkpoint`` names where a restart would restore from.
    """
    sigma: float = 0.05
    deadline_s: Optional[float] = None
    retry: RetryPolicy = dataclasses.field(default_factory=RetryPolicy)
    on_exhausted: str = "raise"      # "raise" -> checkpoint restart path;
    #                                  "degrade" -> mask the lost split
    checkpoint: Optional[CheckpointManager] = None

    def decide(self, meets_bound: bool) -> str:
        return CONTINUE if meets_bound else RESTART


@dataclasses.dataclass(frozen=True)
class LagPolicy:
    """How a standing live session responds to ingest pathology.

    The live analogue of ``FailurePolicy``: instead of dead shards the
    hazards are a *gap* in the sequence (a batch that never shows up), a
    *late* batch (arrives after the watermark already passed it), and a
    *backlog* (arrivals outpace folding).  The responses mirror EARL's
    §3.4 stance — never wait unboundedly, degrade honestly:

    * ``max_lag_batches`` bounds the reorder buffer.  Once the newest
      delivered sequence number runs this far ahead of the fold point, the
      missing batches are declared lost, their row extent is masked out of
      ``p_eff``, and the watermark advances (the CI widens instead of the
      session stalling).
    * ``late`` decides what to do with a batch that arrives below the
      watermark after being declared lost: ``"fold"`` folds it into its
      pane if that pane is still live in the ring, ``"drop"`` counts and
      discards it.
    * ``shed_backlog``/``p_shed`` is the BlinkDB move: when the observed
      backlog at fold time exceeds ``shed_backlog`` batches, the session
      Poisson-subsamples each backlog batch (row survival probability
      ``p_shed``, seeded by ``shed_seed`` + sequence number) instead of
      falling further behind, and reports the widened CI via
      ``correct(p_eff)``.  ``None`` disables shedding.
    """
    max_lag_batches: int = 16
    late: str = "drop"               # "drop" | "fold"
    shed_backlog: Optional[int] = None
    p_shed: float = 0.5
    shed_seed: int = 0x5EED

    def __post_init__(self):
        if self.max_lag_batches < 1:
            raise ValueError(f"max_lag_batches must be >= 1, "
                             f"got {self.max_lag_batches}")
        if self.late not in ("drop", "fold"):
            raise ValueError(f"late must be 'drop' or 'fold', "
                             f"got {self.late!r}")
        if self.shed_backlog is not None and self.shed_backlog < 0:
            raise ValueError(f"shed_backlog must be >= 0, "
                             f"got {self.shed_backlog}")
        if not 0.0 < self.p_shed <= 1.0:
            raise ValueError(f"p_shed must be in (0, 1], got {self.p_shed}")


@dataclasses.dataclass
class ElasticReport:
    """Outcome of one degraded reduce."""
    report: ShardLossReport
    lost: Tuple[int, ...]            # shards that died mid-run
    late: Tuple[int, ...]            # shards past the deadline
    decision: str                    # CONTINUE or RESTART
    can_restart: bool                # a CheckpointManager is configured


def elastic_estimate(earl, values, key, events: ShardEvents,
                     policy: FailurePolicy) -> ElasticReport:
    """Degraded mesh estimate under mid-run shard loss and lateness.

    Every failed or late shard goes into one ``failure_mask`` and the
    mesh step runs once with it: the fused backend multiplies its
    implicit weight tiles by each shard's mask block (interior holes
    included), so a dead shard adds a zero partial and no surviving
    shard's work is recomputed.  The result is bitwise
    ``earl.estimate_with_loss_mask`` under the same mask."""
    late = events.late(policy.deadline_s)
    dead = tuple(sorted(set(events.lost) | set(late)))
    x = _as_2d(as_tensor(values, earl.device))
    mask = failure_mask(x.shape[0], events.n_shards, dead)
    p = float(mask.mean())
    res = earl.estimate_with_loss_mask(x, mask, key, p=p)
    ok = res.cv <= policy.sigma
    rep = ShardLossReport(
        result=res.estimate, cv=res.cv,
        ci_lo=res.report.ci_lo, ci_hi=res.report.ci_hi,
        shards_total=events.n_shards, shards_lost=len(dead),
        p_surviving=p, meets_bound=ok,
        recommendation=("serve approximate result (within bound); "
                        "defer node recovery" if ok else
                        "error bound exceeded: trigger checkpoint restart "
                        "of lost shards"))
    return ElasticReport(report=rep, lost=tuple(sorted(events.lost)),
                         late=late, decision=policy.decide(ok),
                         can_restart=policy.checkpoint is not None)
