"""EarlSession — the end-to-end early-accurate-result driver (paper Fig. 1).

Pipeline: pilot sample → SSABE (B̂, n̂) → main job on n̂ with B̂ resamples →
AES check c_v ≤ σ → if not, grow the sample (Δs, delta-maintained) and
repeat → correct() the result with p = n/N.  If SSABE predicts B·n ≥ N,
early estimation cannot beat the exact job, which then runs instead
(paper §3.1).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, List, Optional

import numpy as np

from repro_torch import random as trandom
from repro_torch.core import ssabe as ssabe_mod
from repro_torch.core.accuracy import AccuracyReport
from repro_torch.core.bootstrap import check_backend
from repro_torch.core.delta import (poisson_delta_extend, poisson_delta_init,
                                    poisson_delta_result)
from repro_torch.core.reduce_api import Statistic, _as_2d
from repro_torch.device import as_tensor, resolve_device


@dataclasses.dataclass
class EarlyResult:
    result: Any                 # corrected estimate (tuple for groups)
    cv: float                   # achieved error (worst member for groups)
    ci_lo: Any
    ci_hi: Any
    n_used: int
    N: int
    fraction: float             # p = n/N
    B: int
    iterations: int
    fell_back: bool             # True => exact full-data computation
    history: List[dict]
    wall_time_s: float
    ssabe: Optional[ssabe_mod.SSABEResult]
    #: StatisticGroup runs: one AccuracyReport per member, from the SAME
    #: resamples (joint CIs); GroupedStatistic runs: one per key (the
    #: KeyedAccuracyReport's members); None for a single statistic.
    reports: Optional[tuple] = None


class EarlSession:
    """Drives early approximation of ``stat`` over a sampler.

    ``sampler`` provides ``N`` and ``take(start, stop)``: rows [start,
    stop) of a fixed uniform random permutation of the population, so
    prefixes are uniform samples without replacement and growth is a
    prefix extension.  ``device=None`` runs on the card.  ``backend=None``
    materializes Poisson weights for SSABE and the delta-maintained main
    loop (the paper's engine); ``"fused_rng"`` runs both matrix-free.
    """

    def __init__(self, sampler, stat: Statistic, sigma: float = 0.05,
                 tau: float = 0.01, p_pilot: float = 0.01,
                 growth: float = 2.0, max_fraction: float = 1.0,
                 min_pilot: int = 64, max_pilot: int = 8192, l: int = 5,
                 backend: Optional[str] = None, mesh=None,
                 checkpoint=None, device=None):
        check_backend(backend, "poisson", mesh)
        if checkpoint is not None:
            raise NotImplementedError(
                "EarlSession(checkpoint=) is not ported yet")
        self.device = resolve_device(device)
        self.sampler = sampler
        self.stat = stat
        self.sigma = float(sigma)
        self.tau = float(tau)
        self.p_pilot = float(p_pilot)
        self.growth = float(growth)
        self.max_fraction = float(max_fraction)
        self.min_pilot = int(min_pilot)
        # the pilot only needs to be large enough for a stable c_v(n) fit
        # (paper §3.2), so it is capped.
        self.max_pilot = int(max_pilot)
        self.l = int(l)
        self.backend = backend

    def _take(self, start: int, stop: int):
        return as_tensor(self.sampler.take(start, stop), self.device)

    def _p_keys(self, n_have: int) -> Optional[np.ndarray]:
        """Per-key sampled fractions when the sampler stratifies a keyed
        statistic, else None (the whole-table p applies): a stratified
        prefix is uniform within each key but not across keys."""
        if getattr(self.stat, "num_groups", None) is None:
            return None
        counts = getattr(self.sampler, "stratum_counts", None)
        sizes = getattr(self.sampler, "stratum_sizes", None)
        if counts is None or sizes is None:
            return None
        have = np.asarray(counts(n_have), dtype=np.float64)
        total = np.asarray(sizes, dtype=np.float64)
        return have / np.maximum(total, 1.0)

    def _full_job(self, t0: float, history) -> EarlyResult:
        N = self.sampler.N
        res = self.stat(self._take(0, N))
        # groups, and keyed runs per key, get degenerate reports on the
        # exact job too
        reports = None
        if isinstance(res, tuple):
            reports = tuple(AccuracyReport(cv=0.0, se=0.0, rel_halfwidth=0.0,
                                           ci_lo=r, ci_hi=r, boot_mean=r)
                            for r in res)
        elif getattr(self.stat, "num_groups", None) is not None:
            reports = tuple(AccuracyReport(cv=0.0, se=0.0, rel_halfwidth=0.0,
                                           ci_lo=res[g], ci_hi=res[g],
                                           boot_mean=res[g])
                            for g in range(int(self.stat.num_groups)))
        return EarlyResult(
            result=res, cv=0.0, ci_lo=res, ci_hi=res, n_used=N, N=N,
            fraction=1.0, B=1, iterations=len(history), fell_back=True,
            history=history, wall_time_s=time.perf_counter() - t0,
            ssabe=None, reports=reports)

    def run(self, key, resume: bool = False) -> EarlyResult:
        if resume:
            raise NotImplementedError("resume needs checkpoint=, which is "
                                      "not ported yet")
        t0 = time.perf_counter()
        N = self.sampler.N
        history: List[dict] = []

        # ---- pilot + SSABE (local mode) --------------------------------
        n_pilot = min(N, self.max_pilot,
                      max(self.min_pilot, int(self.p_pilot * N)))
        pilot = self._take(0, n_pilot)
        est = ssabe_mod.ssabe(pilot, self.stat, self.sigma, self.tau,
                              trandom.fold_in(key, 1), l=self.l, N=N,
                              backend=self.backend, device=self.device)
        B, n_target = est.B, max(est.n, n_pilot)

        # ---- fallback check (paper §3.1) -------------------------------
        if B * n_target >= N or n_target >= self.max_fraction * N:
            return self._full_job(t0, history)

        # ---- main loop with delta-maintained resamples ------------------
        dim = _as_2d(pilot).shape[1]
        pd = poisson_delta_init(self.stat, B, dim, trandom.fold_in(key, 2),
                                backend=self.backend, device=self.device)
        n_have = 0
        iterations = 0
        while True:
            iterations += 1
            n_goal = min(int(n_target), N)
            pd = poisson_delta_extend(pd, self._take(n_have, n_goal))
            n_have = n_goal
            p = n_have / N
            # the point estimate is delta-maintained in pd.est_state
            res = poisson_delta_result(pd, p=p,
                                       p_keys=self._p_keys(n_have))
            entry = dict(iteration=iterations, n=n_have, B=int(B),
                         cv=float(res.cv), t=time.perf_counter() - t0)
            member_reports = getattr(res.report, "members", None)
            if member_reports is not None:
                entry["member_cvs"] = tuple(float(r.cv)
                                            for r in member_reports)
            history.append(entry)
            if res.cv <= self.sigma or n_have >= self.max_fraction * N:
                return EarlyResult(
                    result=res.estimate, cv=res.cv,
                    ci_lo=res.report.ci_lo, ci_hi=res.report.ci_hi,
                    n_used=n_have, N=N, fraction=p, B=B,
                    iterations=iterations, fell_back=False,
                    history=history,
                    wall_time_s=time.perf_counter() - t0, ssabe=est,
                    reports=member_reports)
            if n_have >= N:
                return self._full_job(t0, history)
            n_target = min(N, int(n_have * self.growth))
