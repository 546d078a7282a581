"""Deadline-based straggler mitigation through EARL's early termination.

A straggler is a shard whose partial result misses the reduce deadline.
Classical systems wait or re-execute; EARL emits the on-time shards'
statistic with a bootstrap bound (they are a uniform sample) and only
restarts if the bound misses sigma: the paper's fault-tolerance argument
applied to slowness instead of death, which look the same at a deadline.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from repro_torch.core.distributed import DistributedEarl
from repro_torch.ft.recovery import ShardLossReport


@dataclasses.dataclass
class StragglerReport:
    on_time: int
    late: int
    deadline_s: float
    report: ShardLossReport


class DeadlineReducer:
    """A simulated deadline reduce over per-shard completion times."""

    def __init__(self, earl: DistributedEarl, n_shards: int,
                 sigma: float = 0.05):
        self.earl = earl
        self.n_shards = n_shards
        self.sigma = sigma

    def reduce(self, values, completion_s: Sequence[float],
               deadline_s: float, key) -> StragglerReport:
        from repro_torch.ft.policy import (FailurePolicy, ShardEvents,
                                           elastic_estimate)
        er = elastic_estimate(
            self.earl, values, key,
            ShardEvents(n_shards=self.n_shards,
                        completion_s=tuple(completion_s)),
            FailurePolicy(sigma=self.sigma, deadline_s=deadline_s))
        return StragglerReport(on_time=self.n_shards - len(er.late),
                               late=len(er.late), deadline_s=deadline_s,
                               report=er.report)
