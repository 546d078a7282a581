"""SSABE — Sample Size And Bootstrap Estimation (paper §3.2).

Run on a pilot sample:

  Phase A: grow B over a doubling ladder up to ceil(1/τ) until
           |c_v(B_i) − c_v(B_{i−1})| < τ; the thetas of all B_max
           resamples come from one pass (over a (B_max, n) weight matrix,
           or fused) and B is a prefix of them.
  Phase B: grow nested prefixes n_i = n/2^{l−i} with delta maintenance,
           fit c_v(n) = a·n^(−1/2) + c by least squares and invert it for
           the n that meets σ.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from repro_torch import random as trandom
from repro_torch.core import accuracy
from repro_torch.core.bootstrap import (bootstrap_thetas, check_backend,
                                        fused_resample_states, seed_from_key,
                                        weights_for)
from repro_torch.core.delta import (poisson_delta_extend, poisson_delta_init,
                                    poisson_delta_result)
from repro_torch.core.reduce_api import Statistic, _as_2d, tree_map
from repro_torch.device import as_tensor, resolve_device


def _cv_of(thetas, num_groups=None) -> float:
    """c_v of a theta distribution; the WORST member's for a group, and
    with ``num_groups`` (a GroupedStatistic's (B, G, ...) thetas) the
    WORST key's."""
    if isinstance(thetas, (tuple, list)):
        return max(float(accuracy.coefficient_of_variation(t))
                   for t in thetas)
    if num_groups is not None:
        return max(float(accuracy.coefficient_of_variation(thetas[:, g]))
                   for g in range(int(num_groups)))
    return float(accuracy.coefficient_of_variation(thetas))


@dataclasses.dataclass
class SSABEResult:
    B: int                      # estimated number of bootstraps
    n: int                      # estimated sample size for target sigma
    cv_history_B: List[Tuple[int, float]]   # phase A trace (B_i, cv_i)
    cv_history_n: List[Tuple[int, float]]   # phase B trace (n_i, cv_i)
    fit_a: float
    fit_c: float
    B_theory: int               # 0.5·eps0^-2 (paper §3)
    n_theory: int               # CLT prediction


def estimate_B(values, stat: Statistic, tau: float, key,
               engine: str = "poisson", B_min: int = 2,
               B_max: int | None = None, backend: str | None = None,
               mesh=None, device=None) -> Tuple[int, List[Tuple[int, float]]]:
    """Phase A.  The thetas of B_max resamples come from one pass, and
    prefixes of them are nested resample sets (common random numbers):
    rows of one (B_max, n) weight matrix of ``engine``, or with
    ``backend="fused_rng"`` implicit weights keyed per (resample tile,
    item tile), whose row b does not depend on B_max."""
    check_backend(backend, engine, mesh)
    if B_max is None:
        B_max = max(B_min + 1, int(math.ceil(1.0 / tau)))
    dev = resolve_device(device)
    x = _as_2d(as_tensor(values, dev))
    if backend == "fused_rng":
        states = fused_resample_states(stat, seed_from_key(key), x, B_max)
        thetas_full = stat.finalize_batch(states)
    else:
        thetas_full = bootstrap_thetas(
            x, stat, weights_for(engine, key, B_max, x.shape[0], device=dev))

    # doubling candidates measure convergence of the bootstrap variance
    # estimate (consecutive integers would differ by O(1/B) and stop early)
    candidates = []
    b = max(2, B_min)
    while b < B_max:
        candidates.append(b)
        b *= 2
    candidates.append(B_max)

    history: List[Tuple[int, float]] = []
    prev_cv = None
    chosen = B_max
    for B in candidates:
        cv = _cv_of(tree_map(lambda t, B=B: t[:B], thetas_full),
                    num_groups=getattr(stat, "num_groups", None))
        history.append((B, cv))
        if prev_cv is not None and abs(cv - prev_cv) < tau:
            chosen = B
            break
        prev_cv = cv
    return chosen, history


def fit_cv_curve(ns: np.ndarray, cvs: np.ndarray) -> Tuple[float, float]:
    """Least-squares fit  cv = a·n^(-1/2) + c ;  returns (a, c)."""
    A = np.stack([1.0 / np.sqrt(ns.astype(np.float64)),
                  np.ones_like(ns, dtype=np.float64)], axis=1)
    coef, *_ = np.linalg.lstsq(A, cvs.astype(np.float64), rcond=None)
    return float(coef[0]), float(coef[1])


def invert_cv_curve(a: float, c: float, sigma: float, n_cap: int) -> int:
    """Smallest n with a/sqrt(n) + c <= sigma, capped (the paper falls
    back to the full data set when no n achieves sigma)."""
    if a <= 0:
        return 1 if c <= sigma else n_cap
    if c >= sigma:
        return n_cap
    n = (a / (sigma - c)) ** 2
    return int(min(max(1, math.ceil(n)), n_cap))


def estimate_n(values, stat: Statistic, sigma: float, B: int, key,
               l: int = 5, n_cap: int | None = None,
               backend: str | None = None, mesh=None, device=None
               ) -> Tuple[int, List[Tuple[int, float]], float, float]:
    """Phase B: nested prefixes extend one delta-maintained run."""
    dev = resolve_device(device)
    x = _as_2d(as_tensor(values, dev))
    n, dim = x.shape
    if n_cap is None:
        n_cap = 1 << 62
    pd = poisson_delta_init(stat, B, dim, key, backend=backend, mesh=mesh,
                            device=dev)
    history: List[Tuple[int, float]] = []
    prev = 0
    for i in range(1, l + 1):
        ni = max(2, n // (2 ** (l - i)))
        pd = poisson_delta_extend(pd, x[prev:ni])
        prev = ni
        res = poisson_delta_result(pd, estimate=stat(x[:ni]))
        history.append((ni, res.cv))
    ns = np.array([h[0] for h in history])
    cvs = np.array([h[1] for h in history])
    a, c = fit_cv_curve(ns, cvs)
    return invert_cv_curve(a, c, sigma, n_cap), history, a, c


def ssabe(pilot_values, stat: Statistic, sigma: float, tau: float, key,
          l: int = 5, N: int | None = None, engine: str = "poisson",
          backend: str | None = None, mesh=None,
          device=None) -> SSABEResult:
    """Both SSABE phases on a pilot sample; ``engine`` draws phase A's
    materialized weights."""
    check_backend(backend, engine, mesh)
    dev = resolve_device(device)
    kb, kn = trandom.split(trandom.fold_in(key, 0xEA))
    B_hat, hist_B = estimate_B(pilot_values, stat, tau, kb, engine=engine,
                               backend=backend, device=dev)
    n_cap = N if N is not None else int(1e12)
    n_hat, hist_n, a, c = estimate_n(pilot_values, stat, sigma, B_hat, kn,
                                     l=l, n_cap=n_cap, backend=backend,
                                     device=dev)
    x = _as_2d(as_tensor(pilot_values, dev)).cpu().numpy()
    return SSABEResult(
        B=B_hat, n=n_hat, cv_history_B=hist_B, cv_history_n=hist_n,
        fit_a=a, fit_c=c,
        B_theory=accuracy.theoretical_num_bootstraps(tau),
        n_theory=accuracy.theoretical_sample_size(sigma, float(x.std()),
                                                  float(x.mean())))
