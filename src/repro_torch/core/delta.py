"""Delta-maintained Poisson resampling (paper §4.1, exact path).

Under Poisson(1) weights an old item's weight does not depend on n, so
growing the sample s -> s ∪ Δs draws weights for Δs only and merges the
per-resample states.  Extension ``step`` draws the stream
``offset_seed(seed_from_key(key), step)``, as the JAX package does, so a
run carried across from it continues bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core import accuracy
from repro_torch.core.bootstrap import (BootstrapResult,
                                        fused_resample_states, offset_seed,
                                        seed_from_key)
from repro_torch.core.reduce_api import Statistic, _as_2d
from repro_torch.device import as_tensor, resolve_device
from repro_torch.random import key_data


@dataclasses.dataclass
class PoissonDelta:
    stat: Statistic
    key: torch.Tensor    # uint32[2] PRNG key (int64 tensor)
    states: Any          # B-leading per-resample states
    est_state: Any       # unweighted state over the whole sample
    B: int
    n: int
    step: int            # one per extend
    device: torch.device = torch.device("cpu")


def _check_backend(backend, mesh) -> None:
    if backend != "fused_rng":
        raise NotImplementedError(
            f"delta backend {backend!r} is not ported; use 'fused_rng'")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet")


def poisson_delta_init(stat: Statistic, B: int, dim: int, key,
                       backend: Optional[str] = "fused_rng", mesh=None,
                       device=None) -> PoissonDelta:
    _check_backend(backend, mesh)
    dev = resolve_device(device)
    return PoissonDelta(stat=stat, key=key_data(key),
                        states=stat.init_batch(dim, B, dev),
                        est_state=stat.init_state(dim, dev), B=int(B), n=0,
                        step=0, device=dev)


def poisson_delta_extend(pd: PoissonDelta, new_values) -> PoissonDelta:
    """Fold Δs into the resample states and the point-estimate state."""
    x = _as_2d(as_tensor(new_values, pd.device))
    seed = offset_seed(seed_from_key(pd.key), pd.step)
    delta = fused_resample_states(pd.stat, seed, x, pd.B)
    return dataclasses.replace(
        pd, states=pd.stat.merge(pd.states, delta),
        est_state=pd.stat.update(pd.est_state, x), n=pd.n + x.shape[0],
        step=pd.step + 1)


def poisson_delta_result(pd: PoissonDelta, estimate: Any = None,
                         p: float = 1.0, p_keys=None) -> BootstrapResult:
    """Finalize a delta run; ``p`` is the sampled fraction for correct.

    For a keyed statistic under stratified sampling pass ``p_keys`` (one
    sampled fraction per key) instead: each key's thetas and estimate are
    corrected by its own fraction (``GroupedStatistic.correct_per_key``),
    and the fractions appear on the ``KeyedAccuracyReport``."""
    num_groups = getattr(pd.stat, "num_groups", None)
    raw_thetas = pd.stat.finalize_batch(pd.states)
    if estimate is None:
        estimate = pd.stat.finalize(pd.est_state)
    if p_keys is not None:
        if num_groups is None:
            raise ValueError("p_keys needs a keyed statistic "
                             "(GroupedStatistic)")
        thetas = pd.stat.correct_per_key(raw_thetas, p_keys, key_axis=1)
        estimate = pd.stat.correct_per_key(estimate, p_keys, key_axis=0)
    else:
        thetas = pd.stat.correct(raw_thetas, p)
        estimate = pd.stat.correct(estimate, p)
    return BootstrapResult(
        estimate=estimate, thetas=thetas,
        report=accuracy.report_for(thetas, num_groups=num_groups,
                                   p_keys=p_keys),
        B=pd.B, n=pd.n)
