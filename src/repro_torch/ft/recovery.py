"""Approximation-based node-failure recovery (paper §3.4).

"Given a user specified approximation bound, even when most of the nodes
have been lost, a reasonable result can still be provided": the surviving
shards are a uniform sample of the data (the store interleaves rows at
ingest), so the bootstrap bounds the error of the survivors-only result,
and ``correct(·, p)`` rescales count-like statistics.

``failure_mask`` zeroes interior row blocks, so this path runs on every
``DistributedEarl`` backend: the fused one multiplies its implicit weight
tiles by the mask (``valid_mask``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core.distributed import DistributedEarl


@dataclasses.dataclass
class ShardLossReport:
    result: Any
    cv: float
    ci_lo: Any
    ci_hi: Any
    shards_total: int
    shards_lost: int
    p_surviving: float
    meets_bound: bool             # cv <= sigma -> no recovery needed
    recommendation: str


def failure_mask(n_rows: int, n_shards: int,
                 lost: Sequence[int]) -> torch.Tensor:
    """(n_rows,) f32 row mask with the given shards' rows zeroed.

    Shard extents are the mesh path's: rows padded to a multiple of
    ``n_shards`` and split into ceil-sized blocks, so shard s owns rows
    [s·m, min((s+1)·m, n)) with m = ceil(n / n_shards)."""
    if not 0 < n_shards:
        raise ValueError(f"n_shards must be positive, got {n_shards}")
    for s in lost:
        if not 0 <= s < n_shards:
            raise ValueError(f"lost shard {s} out of range "
                             f"[0, {n_shards})")
    m = -(-n_rows // n_shards)
    mask = torch.ones(n_rows, dtype=torch.float32)
    for s in lost:
        mask[s * m:min((s + 1) * m, n_rows)] = 0.0
    return mask


def estimate_with_failures(earl: DistributedEarl, values,
                           lost_shards: Sequence[int], n_shards: int,
                           sigma: float, key) -> ShardLossReport:
    """Bound the error of the survivors-only statistic (no task restart):
    ``ft.policy.elastic_estimate`` with ``ShardEvents(lost=lost_shards)``,
    whose report this is."""
    from repro_torch.ft.policy import (FailurePolicy, ShardEvents,
                                       elastic_estimate)
    er = elastic_estimate(
        earl, values, key,
        ShardEvents(n_shards=n_shards, lost=tuple(lost_shards)),
        FailurePolicy(sigma=sigma))
    return er.report
