"""One FailurePolicy for a run's failure behaviour, end to end.

The port of the JAX package's ``ft/policy.py`` as far as the streaming
driver needs it: ``ShardEvents`` (what happened to the shards of a run),
``FailurePolicy`` (the prefetch path's ``retry`` and ``on_exhausted``, the
reduce-side ``sigma``/``deadline_s`` verdict and the ``checkpoint`` a
restart would restore from) and ``LagPolicy`` (a live session's answer to
gaps, late batches and backlog).  EARL's §3.4 stance throughout: never
wait unboundedly, degrade honestly, widen the CI through ``correct(p)``.
``ElasticReport``/``elastic_estimate`` need the mesh path and are not
ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.ft.inject import RetryPolicy

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

    ``sigma``/``deadline_s`` govern the reduce-side verdict (``decide``;
    the mesh path's ``elastic_estimate`` is not ported yet);
    ``retry``/``on_exhausted`` govern the
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
