"""Delta-maintained resampling (paper §4).

Inter-iteration (§4.1), as in the JAX package:

* ``PoissonDelta``: under Poisson(1) weights an old item's weight does not
  depend on n, so growing the sample s -> s ∪ Δs draws weights for Δs
  only.  Extension ``step`` draws ``poisson_weights(fold_in(key, step),
  B, Δn)`` and updates every row (``backend=None``), or the matrix-free
  stream ``offset_seed(seed_from_key(key), step)`` merged into the states
  (``"fused_rng"``), so a run carried across from the JAX package
  continues bit for bit.  With ``mesh=`` (fused backend only) each rank
  draws extension ``step``'s weights for its own block of Δs
  (``sharded_fused_states(..., step=step)``) and only the delta states
  are summed across ranks before the merge.
* ``MultinomialDeltaBootstrap``: the paper-faithful baseline that fig10
  compares against.  Item-level resamples on the host in NumPy, grown
  through the §4.1 two-layer ``Sketch``, with the simulated disk accesses
  and the items moved counted; the same NumPy code as the JAX package's,
  so the same seed gives the same resamples and counts.  Only ``thetas``
  touches the device: it gathers each resample there and runs the
  statistic on it (kernel 10 for a Quantile on the card).

Intra-iteration (§4.2): resamples share identical fractions; a shared-base
resample's state is computed once and merged into every resample (Eq. 4
gives the work saved).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import accuracy
from repro_torch.core.bootstrap import (BootstrapResult, check_backend,
                                        fused_resample_states, offset_seed,
                                        poisson_weights, seed_from_key,
                                        sharded_fused_states)
from repro_torch.core.reduce_api import Statistic, StatisticGroup, _as_2d
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
    backend: Optional[str] = None   # None: materialized Poisson weights;
    #                                 "fused_rng": matrix-free
    mesh: Any = None                # fused backend only: a DeviceMesh
    data_axis: str = "data"         # whose data axis splits each Δs
    device: Optional[torch.device] = None   # None: the card

    def __post_init__(self):
        check_backend(self.backend, "poisson", self.mesh)
        self.device = resolve_device(self.device)


def poisson_delta_init(stat: Statistic, B: int, dim: int, key,
                       backend: Optional[str] = None, mesh=None,
                       data_axis: str = "data",
                       device=None) -> PoissonDelta:
    check_backend(backend, "poisson", mesh)
    dev = resolve_device(device)
    return PoissonDelta(stat=stat, key=key_data(key),
                        states=stat.init_batch(dim, B, dev),
                        est_state=stat.init_state(dim, dev), B=int(B), n=0,
                        step=0, backend=backend, mesh=mesh,
                        data_axis=data_axis, device=dev)


def poisson_delta_extend(pd: PoissonDelta, new_values) -> PoissonDelta:
    """Fold Δs into the resample states and the point-estimate state."""
    x = _as_2d(as_tensor(new_values, pd.device))
    if pd.backend == "fused_rng":
        if pd.mesh is not None:
            delta = sharded_fused_states(pd.stat, seed_from_key(pd.key), x,
                                         pd.B, mesh=pd.mesh,
                                         data_axis=pd.data_axis,
                                         step=pd.step)
        else:
            seed = offset_seed(seed_from_key(pd.key), pd.step)
            delta = fused_resample_states(pd.stat, seed, x, pd.B)
        states = pd.stat.merge(pd.states, delta)
    else:
        w = poisson_weights(trandom.fold_in(pd.key, pd.step), pd.B,
                            x.shape[0], device=pd.device)
        states = pd.stat.update_batch(pd.states, x, w)
    return dataclasses.replace(
        pd, states=states, est_state=pd.stat.update(pd.est_state, x),
        n=pd.n + x.shape[0], step=pd.step + 1)


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


# ============================================================================
# Paper-faithful multinomial delta maintenance with sketches (§4.1)
# ============================================================================
class Sketch:
    """Two-layer memory/disk structure of §4.1.

    ``data`` lives on "disk"; ``c·sqrt(len(data))`` random items live in the
    memory layer.  Consuming memory items in order avoids disk access;
    exhausting the sketch triggers a (counted) disk refill.
    """

    def __init__(self, data: np.ndarray, c: float, rng: np.random.Generator):
        self.data = data
        self.c = c
        self.rng = rng
        self.disk_accesses = 0
        self._refill()

    def _refill(self) -> None:
        self.disk_accesses += 1           # one bulk disk read
        k = min(len(self.data),
                max(1, int(self.c * math.sqrt(len(self.data)))))
        idx = self.rng.choice(len(self.data), size=k, replace=False)
        self.mem = self.data[idx]
        self.pos = 0

    def take(self, k: int) -> np.ndarray:
        out = []
        while k > 0:
            avail = len(self.mem) - self.pos
            if avail == 0:
                self._refill()
                avail = len(self.mem)
            t = min(k, avail)
            out.append(self.mem[self.pos:self.pos + t])
            self.pos += t
            k -= t
        return np.concatenate(out) if out else self.data[:0]


class MultinomialDeltaBootstrap:
    """Item-level implementation of §4.1 (the fig10 baseline).

    Resamples are index arrays into the growing sample, kept on the host.
    ``use_sketch`` toggles the memory-layer optimization; ``use_gaussian``
    the Eq. 3 Gaussian approximation of the Eq. 2 binomial.  The sample is
    also kept on ``device`` (None: the card), where ``thetas`` gathers each
    resample and runs the statistic on it.
    """

    def __init__(self, stat: Statistic, B: int, seed: int = 0,
                 c: float = 4.0, use_sketch: bool = True,
                 use_gaussian: bool = True, device=None):
        if isinstance(stat, StatisticGroup):
            raise TypeError(
                "MultinomialDeltaBootstrap is the host/NumPy fig10 baseline"
                " and stacks scalar thetas — run StatisticGroup through the"
                " Poisson delta path (poisson_delta_init) instead")
        if getattr(stat, "num_groups", None) is not None:
            raise TypeError(
                "MultinomialDeltaBootstrap does not produce per-key reports"
                " — run GroupedStatistic through the Poisson delta path"
                " (poisson_delta_init) instead")
        self.stat = stat
        self.B = B
        self.rng = np.random.default_rng(seed)
        self.c = c
        self.use_sketch = use_sketch
        self.use_gaussian = use_gaussian
        self.device = resolve_device(device)
        self.sample = None                 # np.ndarray (n, d)
        self.sample_t = None               # the sample on the device
        self.resamples = None              # list of np index arrays
        self.disk_accesses = 0
        self.items_moved = 0               # total delete+add work performed

    @property
    def n(self) -> int:
        return 0 if self.sample is None else len(self.sample)

    def _old_part_size(self, n: int, n_new: int) -> int:
        """|b'_{i,s}| ~ Binomial(n', n/n')  (Eq. 2), Gaussian approx (Eq. 3)."""
        p = n / n_new
        if self.use_gaussian and n_new >= 64:
            k = int(round(self.rng.normal(n, math.sqrt(n * (1.0 - p)))))
        else:
            k = int(self.rng.binomial(n_new, p))
        return int(np.clip(k, 0, n_new))

    def extend(self, delta: np.ndarray) -> None:
        delta = np.asarray(delta)
        if delta.ndim == 1:
            delta = delta[:, None]
        delta_t = as_tensor(delta, self.device)
        if self.sample is None:
            # first iteration: Δs_1 against the empty set (paper §4.1)
            self.sample, self.sample_t = delta, delta_t
            n = len(delta)
            self.resamples = [self.rng.integers(0, n, size=n)
                              for _ in range(self.B)]
            return

        n = self.n
        n_new = n + len(delta)
        base = len(self.sample)
        self.sample = np.concatenate([self.sample, delta], axis=0)
        self.sample_t = torch.cat([self.sample_t, delta_t])

        s_sketch = (Sketch(np.arange(n), self.c, self.rng)
                    if self.use_sketch else None)
        d_sketch = (Sketch(np.arange(base, n_new), self.c, self.rng)
                    if self.use_sketch else None)

        new_resamples = []
        for b in self.resamples:
            k = self._old_part_size(n, n_new)
            if k < n:                                   # random deletions
                keep = self.rng.permutation(n)[:k]
                b = b[keep]
                self.items_moved += n - k
            elif k > n:                                 # additions from s
                if s_sketch is not None:
                    add = s_sketch.take(k - n)
                else:
                    self.disk_accesses += k - n         # item-wise disk reads
                    add = self.rng.integers(0, n, size=k - n)
                b = np.concatenate([b, add])
                self.items_moved += k - n
            # additions from Δs
            m = n_new - k
            if d_sketch is not None:
                add_d = d_sketch.take(m)
            else:
                self.disk_accesses += m
                add_d = self.rng.integers(base, n_new, size=m)
            self.items_moved += m
            new_resamples.append(np.concatenate([b, add_d]))
        if s_sketch is not None:
            self.disk_accesses += s_sketch.disk_accesses
            self.disk_accesses += d_sketch.disk_accesses
        self.resamples = new_resamples

    def thetas(self):
        outs = [self.stat(self.sample_t[torch.from_numpy(b).to(
            self.device)]) for b in self.resamples]
        return torch.stack(outs)

    def result(self, p: float = 1.0) -> BootstrapResult:
        thetas = self.stat.correct(self.thetas(), p)
        est = self.stat.correct(self.stat(self.sample_t), p)
        return BootstrapResult(
            estimate=est, thetas=thetas,
            report=accuracy.report_for(thetas),
            B=self.B, n=self.n)


# ============================================================================
# Intra-iteration optimization (§4.2)
# ============================================================================
def p_shared(n: int, y: float) -> float:
    """Eq. 4: P(X=y) = n! / ((n - y·n)! · n^{y·n}), in log space."""
    k = int(round(y * n))
    if k <= 0:
        return 1.0
    if k > n:
        return 0.0
    logp = (math.lgamma(n + 1) - math.lgamma(n - k + 1) - k * math.log(n))
    return min(1.0, math.exp(logp))


def work_saved(n: int, y: float) -> float:
    """Expected fraction of resample work saved: P(X=y)·y (paper §4.2)."""
    return p_shared(n, y) * y


def optimal_y(n: int, grid: int = 200) -> Tuple[float, float]:
    """argmax_y work_saved(n, y) by scan (paper: simple binary search)."""
    best_y, best_w = 0.0, 0.0
    for i in range(1, grid + 1):
        y = i / grid
        w = work_saved(n, y)
        if w > best_w:
            best_y, best_w = y, w
    return best_y, best_w


def shared_base_bootstrap(values, stat: Statistic, B: int, key,
                          y: Optional[float] = None, p: float = 1.0,
                          device=None) -> BootstrapResult:
    """Intra-iteration optimized bootstrap: a shared y·n sub-resample's
    state is computed once and merged into every resample's remainder
    state.  Work: n·y (once) + B·n·(1−y) against B·n for the standard
    bootstrap.  The index draws are the JAX package's, bit for bit."""
    dev = resolve_device(device)
    x = _as_2d(as_tensor(values, dev))
    n, dim = x.shape
    if y is None:
        y, _ = optimal_y(n)
    k_base = int(round(y * n))
    k_rest = n - k_base

    kb, kr = trandom.split(key)
    base_idx = trandom.randint(kb, (k_base,), 0, n, device=dev)
    shared_state = stat.update(stat.init_state(dim, dev), x[base_idx.long()])
    rest_idx = trandom.randint(kr, (B, max(k_rest, 1)), 0, n, device=dev)

    def one(idx_row):
        if k_rest <= 0:
            return stat.finalize(shared_state)
        st = stat.update(stat.init_state(dim, dev), x[idx_row.long()])
        return stat.finalize(stat.merge(shared_state, st))

    thetas = stat.correct(torch.stack([one(r) for r in rest_idx]), p)
    est = stat.correct(stat(x), p)
    return BootstrapResult(estimate=est, thetas=thetas,
                           report=accuracy.report_for(thetas), B=B, n=n)
