"""Incremental reduce API (paper §2.1): statistics over dataclass states.

EARL extends Hadoop's reducer with initialize / update / finalize /
correct; ``merge`` is the associative combine that lets per-chunk and
per-extension states add up.  Every statistic is weighted: a bootstrap
resample is a weight vector over the sample, so ``update`` takes
``(values, weights)`` and ``weights=None`` means all ones.

States are frozen dataclasses of tensors (or tuples of them for a
``StatisticGroup``).  A *batch* of B per-resample states carries a leading
B axis on every field; ``finalize`` broadcasts over it, and
``finalize_batch`` gives the (B, ...) result distribution.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

State = Any
Result = Any

_EPS = 1e-12


def tree_map(fn, *trees):
    """Map ``fn`` over the tensors of matching states (dataclasses of
    tensors, tuples of states, or tensors)."""
    t0 = trees[0]
    if isinstance(t0, torch.Tensor):
        return fn(*trees)
    if isinstance(t0, (tuple, list)):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    if dataclasses.is_dataclass(t0):
        return type(t0)(**{f.name: tree_map(fn, *(getattr(t, f.name)
                                                   for t in trees))
                           for f in dataclasses.fields(t0)})
    raise TypeError(f"not a state tree: {type(t0).__name__}")


def _as_2d(values: torch.Tensor) -> torch.Tensor:
    values = torch.as_tensor(values)
    if values.ndim == 1:
        return values[:, None]
    return values.reshape(values.shape[0], -1)


def _w(values: torch.Tensor, weights: Optional[torch.Tensor]
       ) -> torch.Tensor:
    if weights is None:
        return torch.ones(values.shape[0], dtype=torch.float32,
                          device=values.device)
    return torch.as_tensor(weights).to(device=values.device,
                                       dtype=torch.float32)


class Statistic:
    """Base class: the paper's reducer protocol on dataclass states."""

    # Structural hash/eq: Mean() == Mean(); configured statistics compare
    # by their scalar attributes.
    def _static_key(self):
        items = []
        for k in sorted(self.__dict__):
            v = self.__dict__[k]
            if isinstance(v, Statistic):
                items.append((k, v._static_key()))
            elif isinstance(v, (int, float, str, bool, tuple, type(None))):
                items.append((k, v))
            else:
                items.append((k, id(v)))
        return (type(self), tuple(items))

    def __hash__(self):
        return hash(self._static_key())

    def __eq__(self, other):
        return (isinstance(other, Statistic)
                and self._static_key() == other._static_key())

    def init_state(self, dim: int, device="cpu") -> State:
        raise NotImplementedError

    def init_batch(self, dim: int, B: int, device="cpu") -> State:
        """B copies of the initial state, stacked on a leading axis."""
        return tree_map(lambda a: a.expand(B, *a.shape).clone(),
                        self.init_state(dim, device))

    def update(self, state: State, values: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> State:
        raise NotImplementedError

    def merge(self, a: State, b: State) -> State:
        """Associative combine: merge(update(s0, x), update(s0, y)) equals
        update(update(s0, x), y) (the delta-maintenance contract)."""
        return tree_map(torch.add, a, b)

    def finalize(self, state: State) -> Result:
        raise NotImplementedError

    def finalize_batch(self, states: State) -> Result:
        """(B, ...) results of B-leading states."""
        return self.finalize(states)

    def correct(self, result: Result, p: float) -> Result:
        """Rescale a sample-based result to the population (paper §2.1);
        p is the fraction of the data used.  Default: p-invariant."""
        del p
        return result

    def fused_poisson_states(self, seed: int, values: torch.Tensor, B: int,
                             n_valid=None, valid_mask=None
                             ) -> Optional[State]:
        """B per-resample states under implicit Poisson(1) weights,
        without a (B, n) weight matrix, or None when the statistic has no
        fused path (``fused_resample_states`` then materializes the same
        implicit weights)."""
        del seed, values, B, n_valid, valid_mask
        return None

    def accumulator_key(self) -> Optional[Tuple]:
        """Identity of this statistic's accumulator, shared inside a
        ``StatisticGroup``; None if it can never be shared."""
        return None

    def tile_update(self, states: State, x_tile: torch.Tensor,
                    w_tile: torch.Tensor) -> State:
        """Advance B-leading ``states`` by one (x tile, (B, bn) weight
        tile) block.  The default runs ``update`` once per weight row."""
        rows = [self.update(tree_map(lambda a, b=b: a[b], states), x_tile,
                            w_tile[b]) for b in range(w_tile.shape[0])]
        return tree_map(lambda *xs: torch.stack(xs), *rows)

    def __call__(self, values: torch.Tensor,
                 weights: Optional[torch.Tensor] = None) -> Result:
        x = _as_2d(values)
        return self.finalize(self.update(
            self.init_state(x.shape[1], x.device), x, weights))


@dataclasses.dataclass(frozen=True)
class MomentState:
    w: torch.Tensor      # () total weight; (B,) in a batch
    s1: torch.Tensor     # (d,) Σ w·x
    s2: torch.Tensor     # (d,) Σ w·x²


class _MomentStatistic(Statistic):
    def init_state(self, dim: int, device="cpu") -> MomentState:
        z = torch.zeros(dim, dtype=torch.float32, device=device)
        return MomentState(w=torch.zeros((), dtype=torch.float32,
                                         device=device), s1=z, s2=z)

    def update(self, state: MomentState, values, weights=None
               ) -> MomentState:
        x = _as_2d(values).to(torch.float32)
        w = _w(x, weights)
        return MomentState(w=state.w + w.sum(), s1=state.s1 + w @ x,
                           s2=state.s2 + w @ (x * x))

    def from_moments(self, w, s1, s2) -> MomentState:
        return MomentState(w=w, s1=s1, s2=s2)

    def fused_poisson_states(self, seed, values, B, n_valid=None,
                             valid_mask=None):
        from repro_torch.kernels.weighted_stats import ops as ws_ops
        w_tot, s1, s2 = ws_ops.fused_poisson_moments(
            seed, values, B, n_valid=n_valid, valid_mask=valid_mask)
        return self.from_moments(w_tot, s1, s2)

    def accumulator_key(self):
        # every moment statistic accumulates the same (w, s1, s2)
        return ("moments",)

    def tile_update(self, states: MomentState, x_tile, w_tile
                    ) -> MomentState:
        """The tile math of the moments scan lowering."""
        x = x_tile.to(torch.float32)
        return MomentState(w=states.w + w_tile.sum(dim=1),
                           s1=states.s1 + w_tile @ x,
                           s2=states.s2 + w_tile @ (x * x))


def _total(state: MomentState) -> torch.Tensor:
    """Total weight + eps, broadcastable against s1 with or without a
    leading batch axis."""
    return state.w.unsqueeze(-1) + _EPS


class Mean(_MomentStatistic):
    def finalize(self, state: MomentState):
        return state.s1 / _total(state)


class Sum(_MomentStatistic):
    def finalize(self, state: MomentState):
        return state.s1

    def correct(self, result, p: float):
        return result / p


class Count(_MomentStatistic):
    def finalize(self, state: MomentState):
        return state.w

    def correct(self, result, p: float):
        return result / p


class Var(_MomentStatistic):
    def finalize(self, state: MomentState):
        m = state.s1 / _total(state)
        return state.s2 / _total(state) - m * m


class Std(Var):
    def finalize(self, state: MomentState):
        return torch.sqrt(torch.clamp_min(super().finalize(state), 0.0))


@dataclasses.dataclass(frozen=True)
class HistogramState:
    counts: torch.Tensor       # (d, nbins)
    lo: torch.Tensor           # (d,)
    hi: torch.Tensor           # (d,)


class Quantile(Statistic):
    """Mergeable weighted quantile from a fixed-range histogram sketch.

    The bin range must cover the data (values are clipped into the edge
    bins); accuracy is about (hi - lo) / nbins."""

    def __init__(self, q: float, nbins: int = 2048, lo: float = 0.0,
                 hi: float = 1.0):
        self.q = float(q)
        self.nbins = int(nbins)
        self.lo = float(lo)
        self.hi = float(hi)

    def init_state(self, dim: int, device="cpu") -> HistogramState:
        return HistogramState(
            counts=torch.zeros(dim, self.nbins, device=device),
            lo=torch.full((dim,), self.lo, device=device),
            hi=torch.full((dim,), self.hi, device=device))

    def update(self, state: HistogramState, values, weights=None):
        from repro_torch.kernels.weighted_hist.ref import \
            weighted_hist_scatter_ref
        x = _as_2d(values).to(torch.float32)
        delta = weighted_hist_scatter_ref(x, _w(x, weights), state.lo,
                                          state.hi, self.nbins)
        return HistogramState(counts=state.counts + delta, lo=state.lo,
                              hi=state.hi)

    def merge(self, a: HistogramState, b: HistogramState) -> HistogramState:
        return HistogramState(counts=a.counts + b.counts, lo=a.lo, hi=a.hi)

    def fused_poisson_states(self, seed, values, B, n_valid=None,
                             valid_mask=None):
        from repro_torch.kernels.weighted_hist import ops as wh_ops
        d = values.shape[1]
        counts = wh_ops.fused_poisson_hist(seed, values, self.lo, self.hi,
                                           self.nbins, B, n_valid=n_valid,
                                           valid_mask=valid_mask)
        return HistogramState(
            counts=counts,
            lo=torch.full((B, d), self.lo, device=values.device),
            hi=torch.full((B, d), self.hi, device=values.device))

    def accumulator_key(self):
        # quantiles over one bin range share one sketch, whatever q
        return ("hist", self.nbins, self.lo, self.hi)

    def tile_update(self, states: HistogramState, x_tile, w_tile
                    ) -> HistogramState:
        """The tile math of the histogram scan lowering."""
        from repro_torch.kernels.weighted_hist.ops import hist_tile_update
        x = x_tile.to(torch.float32)
        d = x.shape[1]
        B = w_tile.shape[0]
        counts = states.counts.reshape(B, d * self.nbins).clone()
        hist_tile_update(counts, x, w_tile,
                         torch.full((d,), self.lo, device=x.device),
                         torch.full((d,), self.hi, device=x.device),
                         self.nbins)
        return HistogramState(counts=counts.reshape(B, d, self.nbins),
                              lo=states.lo, hi=states.hi)

    def _centers(self, state: HistogramState) -> torch.Tensor:
        cdf = torch.cumsum(state.counts, dim=-1)
        cdf = cdf / (cdf[..., -1:] + _EPS)
        # first bin where cdf >= q, at its center
        idx = (cdf >= self.q).to(torch.uint8).argmax(dim=-1).to(
            torch.float32)
        return state.lo + (idx + 0.5) / self.nbins * (state.hi - state.lo)

    def finalize(self, state: HistogramState):
        out = self._centers(state)
        return out[0] if out.shape == (1,) else out

    def finalize_batch(self, states: HistogramState):
        out = self._centers(states)
        return out[:, 0] if out.shape[1:] == (1,) else out


def Median(nbins: int = 2048, lo: float = 0.0, hi: float = 1.0) -> Quantile:
    return Quantile(0.5, nbins=nbins, lo=lo, hi=hi)


class StatisticGroup(Statistic):
    """k member statistics answered from ONE pass over the sample under ONE
    shared Poisson(1) resample stream.

    State is a tuple of slot states, one per distinct ``accumulator_key``
    (Mean/Var/Std share one MomentState; same-range Quantiles share one
    sketch).  ``finalize``/``correct`` return one entry per member."""

    def __init__(self, members):
        members = tuple(members)
        if not members:
            raise ValueError("StatisticGroup needs at least one member")
        for m in members:
            if isinstance(m, StatisticGroup):
                raise TypeError("StatisticGroup members cannot be groups "
                                "themselves: flatten the member list")
            if not isinstance(m, Statistic):
                raise TypeError(f"group member {m!r} is not a Statistic")
        self.members = members
        slots, keys, member_slot = [], {}, []
        for m in members:
            k = m.accumulator_key()
            if k is None:
                member_slot.append(len(slots))
                slots.append(m)
            elif k in keys:
                member_slot.append(keys[k])
            else:
                keys[k] = len(slots)
                member_slot.append(len(slots))
                slots.append(m)
        #: one representative Statistic per shared accumulator
        self.slots = tuple(slots)
        #: member i finalizes slot state ``self.member_slot[i]``
        self.member_slot = tuple(member_slot)

    def init_state(self, dim: int, device="cpu") -> Tuple:
        return tuple(s.init_state(dim, device) for s in self.slots)

    def init_batch(self, dim: int, B: int, device="cpu") -> Tuple:
        return tuple(s.init_batch(dim, B, device) for s in self.slots)

    def update(self, state, values, weights=None):
        return tuple(s.update(st, values, weights)
                     for s, st in zip(self.slots, state))

    def merge(self, a, b):
        return tuple(s.merge(ai, bi) for s, ai, bi in zip(self.slots, a, b))

    def tile_update(self, states, x_tile, w_tile):
        return tuple(s.tile_update(st, x_tile, w_tile)
                     for s, st in zip(self.slots, states))

    def finalize(self, state) -> Tuple:
        return tuple(m.finalize(state[slot])
                     for m, slot in zip(self.members, self.member_slot))

    def finalize_batch(self, states) -> Tuple:
        return tuple(m.finalize_batch(states[slot])
                     for m, slot in zip(self.members, self.member_slot))

    def correct(self, result, p: float) -> Tuple:
        return tuple(m.correct(r, p) for m, r in zip(self.members, result))

    def fused_poisson_states(self, seed, values, B, n_valid=None,
                             valid_mask=None):
        from repro_torch.kernels.fused_multi import ops as fm_ops
        return fm_ops.fused_poisson_multi(self, seed, values, B,
                                          n_valid=n_valid,
                                          valid_mask=valid_mask)
