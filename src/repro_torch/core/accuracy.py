"""Accuracy measures for early-result estimation (paper §3).

The headline error measure is the coefficient of variation
``c_v = std / |mean|`` over the bootstrap result distribution; variance,
standard error, relative CI half-width and percentile CIs come from the
same distribution.  Variances use ddof=1 and percentiles linear
interpolation, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

_EPS = 1e-12


def _flatten_thetas(thetas) -> torch.Tensor:
    """(B, ...) -> (B, K) flat view of the bootstrap result distribution."""
    thetas = torch.as_tensor(thetas)
    if thetas.ndim == 1:
        return thetas[:, None]
    return thetas.reshape(thetas.shape[0], -1)


def coefficient_of_variation(thetas) -> torch.Tensor:
    """c_v of a result distribution with leading axis B; for vector
    statistics sqrt(mean_k var_k) / rms_k(mean_k)."""
    t = _flatten_thetas(thetas)
    mean = t.mean(dim=0)
    var = (t.var(dim=0, correction=1) if t.shape[0] > 1
           else torch.zeros_like(mean))
    num = torch.sqrt(var.mean())
    den = torch.sqrt((mean * mean).mean())
    return num / (den + _EPS)


def standard_error(thetas) -> torch.Tensor:
    t = _flatten_thetas(thetas)
    if t.shape[0] <= 1:
        return torch.zeros(())
    return torch.sqrt(t.var(dim=0, correction=1).mean())


def relative_halfwidth(thetas, z: float = 1.96) -> torch.Tensor:
    """z·SE / |mean|: the relative CI half-width at confidence z."""
    t = _flatten_thetas(thetas)
    mean = torch.sqrt((t.mean(dim=0) ** 2).mean())
    return z * standard_error(thetas) / (mean + _EPS)


def percentile_ci(thetas, alpha: float = 0.05
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Efron percentile bootstrap CI (per flattened component)."""
    t = _flatten_thetas(thetas)
    lo = torch.quantile(t, alpha / 2.0, dim=0, interpolation="linear")
    hi = torch.quantile(t, 1.0 - alpha / 2.0, dim=0, interpolation="linear")
    return lo, hi


@dataclasses.dataclass(frozen=True)
class AccuracyReport:
    """Everything the AES stage (paper §3.1) derives from one bootstrap."""
    cv: float
    se: float
    rel_halfwidth: float
    ci_lo: torch.Tensor
    ci_hi: torch.Tensor
    boot_mean: torch.Tensor

    @staticmethod
    def from_thetas(thetas, alpha: float = 0.05) -> "AccuracyReport":
        lo, hi = percentile_ci(thetas, alpha)
        return AccuracyReport(
            cv=float(coefficient_of_variation(thetas)),
            se=float(standard_error(thetas)),
            rel_halfwidth=float(relative_halfwidth(thetas)),
            ci_lo=lo, ci_hi=hi,
            boot_mean=_flatten_thetas(thetas).mean(dim=0))


@dataclasses.dataclass(frozen=True)
class GroupAccuracyReport:
    """Per-member reports of a ``StatisticGroup`` run.  The scalar gates
    are the WORST member's, so ``report.cv <= sigma`` means every member
    meets the target; the member CIs are joint (same resamples)."""
    members: Tuple[AccuracyReport, ...]

    @property
    def cv(self) -> float:
        return max(m.cv for m in self.members)

    @property
    def se(self) -> float:
        return max(m.se for m in self.members)

    @property
    def rel_halfwidth(self) -> float:
        return max(m.rel_halfwidth for m in self.members)

    @property
    def ci_lo(self):
        return tuple(m.ci_lo for m in self.members)

    @property
    def ci_hi(self):
        return tuple(m.ci_hi for m in self.members)

    @property
    def boot_mean(self):
        return tuple(m.boot_mean for m in self.members)

    @property
    def cvs(self) -> Tuple[float, ...]:
        return tuple(m.cv for m in self.members)


@dataclasses.dataclass(frozen=True)
class KeyedAccuracyReport(GroupAccuracyReport):
    """Per-key reports of a keyed (GROUP BY) run, in key order; the scalar
    gates are the worst key's.  ``p_keys`` records per-key sampled
    fractions when the run was stratified."""
    p_keys: "Tuple[float, ...] | None" = None

    @property
    def worst_key(self) -> int:
        cvs = self.cvs
        return max(range(len(cvs)), key=lambda g: cvs[g])


def report_for(thetas, alpha: float = 0.05, num_groups=None, p_keys=None):
    """AccuracyReport for (B, ...) thetas, GroupAccuracyReport for a tuple
    of member thetas, KeyedAccuracyReport for (B, G, ...) keyed thetas."""
    if isinstance(thetas, (tuple, list)):
        return GroupAccuracyReport(tuple(
            AccuracyReport.from_thetas(t, alpha) for t in thetas))
    if num_groups is not None:
        thetas = torch.as_tensor(thetas)
        return KeyedAccuracyReport(tuple(
            AccuracyReport.from_thetas(thetas[:, g], alpha)
            for g in range(int(num_groups))),
            p_keys=None if p_keys is None
            else tuple(float(p) for p in p_keys))
    return AccuracyReport.from_thetas(thetas, alpha)


def theoretical_num_bootstraps(eps0: float) -> int:
    """Paper §3: theory suggests B = 0.5 · eps0^-2 [Efron '87]."""
    return int(round(0.5 * eps0 ** (-2)))


def theoretical_sample_size(sigma: float, pilot_std: float,
                            pilot_mean: float) -> int:
    """CLT n for the mean: (s/|mu|)/sqrt(n) <= sigma (ceil taken in f32,
    as the JAX package does)."""
    rel = pilot_std / (abs(pilot_mean) + _EPS)
    return max(1, int(np.ceil(np.float32((rel / sigma) ** 2))))


__all__ = ["AccuracyReport", "GroupAccuracyReport", "KeyedAccuracyReport",
           "coefficient_of_variation", "percentile_ci", "relative_halfwidth",
           "report_for", "standard_error", "theoretical_num_bootstraps",
           "theoretical_sample_size"]
