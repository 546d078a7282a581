"""The matrix-free Poisson bootstrap (paper §3).

A resample is a weight vector over the sample, so f(resample) is a
weighted statistic.  With ``backend="fused_rng"`` the Poisson(1) weights
are drawn inside the contraction from the counter-based threefry tile
stream, and the (B, n) weight matrix never exists: statistics opt in
through ``Statistic.fused_poisson_states`` (moments, histogram sketches,
groups); others fall back to materializing the same implicit weights.
The stream seed derives from the key, so delta maintenance and common
random numbers carry over from the JAX package bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as trandom
from repro_torch.core import accuracy
from repro_torch.core.reduce_api import Statistic, _as_2d, tree_map
from repro_torch.device import as_tensor, resolve_device

_SEED_MOD = (1 << 31) - 1


@dataclasses.dataclass
class BootstrapResult:
    estimate: object           # f on the full sample (unweighted), corrected
    thetas: object             # (B, ...) bootstrap result distribution
    report: object             # AccuracyReport (or a group/keyed report)
    B: int
    n: int

    @property
    def cv(self) -> float:
        return self.report.cv


def seed_from_key(key) -> int:
    """The int32 stream seed of ``key``: ``randint(key, (), 0, 2^31 - 1)``."""
    return int(trandom.randint(key, (), 0, _SEED_MOD))


def offset_seed(base_seed: int, i: int) -> int:
    """The i-th derived stream seed, (base + i) mod (2^31 - 1), taken the
    way the JAX package takes it so that it never leaves int32."""
    base = int(base_seed)
    off = int(i) % _SEED_MOD
    room = _SEED_MOD - off
    return base - room if base >= room else base + off


def fused_resample_states(stat: Statistic, seed: int, x2: torch.Tensor,
                          B: int, n_valid=None, valid_mask=None):
    """B-leading per-resample states of ``x2`` under implicit Poisson(1)
    weights.  Statistics without a fused path get the same implicit
    weights materialized (the poisson_counts kernel on a card)."""
    states = stat.fused_poisson_states(seed, x2, B, n_valid=n_valid,
                                       valid_mask=valid_mask)
    if states is not None:
        return states
    from repro_torch.kernels.weighted_stats import ops as ws_ops
    n, dim = x2.shape
    w = ws_ops.implicit_weights(seed, B, n, device=x2.device)
    if n_valid is not None:
        w = w * (torch.arange(n, device=x2.device) < n_valid).to(w.dtype)
    if valid_mask is not None:
        w = w * torch.as_tensor(valid_mask, dtype=w.dtype,
                                device=w.device).reshape(1, -1)
    rows = [stat.update(stat.init_state(dim, x2.device), x2, w[b])
            for b in range(B)]
    return tree_map(lambda *xs: torch.stack(xs), *rows)


def bootstrap(values, stat: Statistic, B: int, key, engine: str = "poisson",
              p: float = 1.0, alpha: float = 0.05,
              backend: Optional[str] = "fused_rng", mesh=None,
              device=None) -> BootstrapResult:
    """One bootstrap pass: B resamples, their result distribution and its
    accuracy.  ``p`` (the sampled fraction) goes to ``stat.correct``.

    Only the matrix-free ``backend="fused_rng"`` with the poisson engine is
    ported; ``device=None`` means the card."""
    if not isinstance(stat, Statistic):
        raise TypeError("stat must be a reduce_api.Statistic")
    if backend != "fused_rng" or engine != "poisson":
        raise NotImplementedError("only backend='fused_rng' with the "
                                  "poisson engine is ported")
    if mesh is not None:
        raise NotImplementedError("bootstrap(mesh=) is not ported yet")
    dev = resolve_device(device)
    x2 = _as_2d(as_tensor(values, dev))
    states = fused_resample_states(stat, seed_from_key(key), x2, int(B))
    thetas = stat.correct(stat.finalize_batch(states), p)
    estimate = stat.correct(stat(x2), p)
    return BootstrapResult(estimate=estimate, thetas=thetas,
                           report=accuracy.report_for(thetas, alpha=alpha),
                           B=int(B), n=int(x2.shape[0]))
