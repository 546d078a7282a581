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

import numpy as np
import torch

from repro_torch.device import check_ieee_matmul

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


def split_params(stat: "Statistic") -> Tuple[tuple, dict]:
    """(spec, params) of a statistic, what a resume fingerprint binds: the
    spec is a nested tuple of plain Python values (class name, scalar
    attributes, member and inner statistics) with every tensor or array
    attribute replaced by a ("tensor", shape, dtype) marker; params maps
    the path of each such attribute (e.g. ".centroids") to its tensor.
    Attributes of other types bind by their type's name only."""
    params = {}

    def walk(obj, path):
        if isinstance(obj, Statistic):
            return (type(obj).__qualname__,
                    tuple((k, walk(v, f"{path}.{k}"))
                          for k, v in sorted(vars(obj).items())))
        if isinstance(obj, (torch.Tensor, np.ndarray)):
            t = torch.as_tensor(obj)
            params[path] = t
            return ("tensor", tuple(t.shape), str(t.dtype))
        if isinstance(obj, (tuple, list)):
            return tuple(walk(v, f"{path}[{i}]") for i, v in enumerate(obj))
        if isinstance(obj, (int, float, str, bool, type(None))):
            return obj
        return ("object", type(obj).__qualname__)

    return walk(stat, ""), params


def bind_params(spec: tuple, params: dict) -> "Statistic":
    """Inverse of ``split_params``: the statistic that ``spec`` describes,
    with each tensor of ``params`` re-attached at its path.  A group is
    rebuilt around its members (``with_members``) and a keyed statistic
    around its inner one (``with_inner``), so their derived attributes are
    the constructors' own.  Only the statistics of this module rebuild
    (``_BINDABLE``, by the class name ``split_params`` records).  The port
    itself never calls this: a live session folds with the statistic it
    was given."""

    def build(node, path):
        if path in params:
            return params[path]
        if (isinstance(node, tuple) and len(node) == 2
                and node[0] in _BINDABLE and isinstance(node[1], tuple)):
            cls = _BINDABLE[node[0]]
            obj = cls.__new__(cls)
            for k, v in node[1]:
                obj.__dict__[k] = build(v, f"{path}.{k}")
            if isinstance(obj, StatisticGroup):
                return obj.with_members(obj.members)
            if isinstance(obj, GroupedStatistic):
                return obj.with_inner(obj.inner)
            return obj
        if isinstance(node, tuple):
            if node and node[0] in ("tensor", "object"):
                raise ValueError(f"bind_params: nothing to bind at "
                                 f"{path!r} ({node!r})")
            return tuple(build(v, f"{path}[{i}]") for i, v in enumerate(node))
        return node

    stat = build(spec, "")
    if not isinstance(stat, Statistic):
        raise TypeError(f"bind_params: {spec!r} is not the spec of one of "
                        f"{sorted(_BINDABLE)}")
    return stat


def _rows_of_update(stat, states, values: torch.Tensor,
                    weights: torch.Tensor):
    """B-leading ``states`` advanced by ``stat.update`` once per row of
    the (B, n) ``weights``."""
    rows = [stat.update(tree_map(lambda a, b=b: a[b], states), values,
                        weights[b]) for b in range(weights.shape[0])]
    return tree_map(lambda *xs: torch.stack(xs), *rows)


class Statistic:
    """Base class: the paper's reducer protocol on dataclass states."""

    #: (0, 1, 2) for statistics that are functions of (Σw, Σw·x, Σw·x²),
    #: which ``bootstrap_thetas(use_kernel=True)`` contracts in one
    #: weighted_moments pass; None otherwise.
    moment_powers: Optional[Tuple[int, ...]] = None

    #: whether ``merge`` is an associative combine of this statistic's
    #: states.  Every built-in is; a custom statistic whose state depends
    #: on arrival order sets False, and the streaming driver, which folds
    #: per-chunk states with ``merge``, rejects it before reading a row.
    mergeable: bool = True

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

    def psum_state(self, state: State, axis_names) -> State:
        """Cross-rank ``merge``: the per-shard states of a mesh summed over
        its data axes.  ``axis_names`` is the port's handle for them, the
        process group ``DeviceMesh.get_group`` returns (or a tuple of
        groups, outermost axis first).  Every rank's leaves are gathered
        and folded left to right in flat shard order, the order the
        sequential ``nshards=`` oracle merges in, so a mesh run is bitwise
        the oracle.  The default sums every leaf, as ``merge`` does; a
        state with non-additive leaves (Quantile's lo/hi) overrides it."""
        from repro_torch.core._mesh import psum_tree
        return psum_tree(state, axis_names)

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

    def update_batch(self, states: State, values: torch.Tensor,
                     weights: torch.Tensor) -> State:
        """Advance B-leading ``states`` by ``values`` under the (B, n)
        ``weights``, row b under row b: the JAX package's
        ``vmap(update)`` written as a batch dimension, on the values'
        device (a statistic with a kernel for it launches the kernel on
        the card).  The default is the plain ``tile_update``."""
        return self.tile_update(states, values, weights)

    def tile_update(self, states: State, x_tile: torch.Tensor,
                    w_tile: torch.Tensor) -> State:
        """Advance B-leading ``states`` by one (x tile, (B, bn) weight
        tile) block in plain PyTorch, launching no kernel: the tile math
        of the fused paths' plain versions.  The default runs ``update``
        once per weight row."""
        return _rows_of_update(self, states, x_tile, w_tile)

    def chunk_update(self, states: State, x: torch.Tensor, w: torch.Tensor,
                     bn: int) -> State:
        """Advance B-leading ``states`` by a chunk of weight tiles in plain
        PyTorch: w (B, T·bn), x (T·bn, d), tile t the columns [t·bn,
        (t+1)·bn), each tile as ``tile_update`` takes it, in tile order.
        The default calls ``tile_update`` a tile at a time; a statistic
        whose tile math batches over a chunk overrides it."""
        for t in range(w.shape[1] // bn):
            c = slice(t * bn, (t + 1) * bn)
            states = self.tile_update(states, x[c], w[:, c])
        return states

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
    moment_powers = (0, 1, 2)

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
        """The tile math of the moments scan lowering, and the batch
        update: (B, n) W against x and x² as f32 matrix products (on the
        card in IEEE f32, never TF32); ``chunk_update`` of one tile."""
        return self.chunk_update(states, x_tile, w_tile, w_tile.shape[1])

    def chunk_update(self, states: MomentState, x, w, bn: int
                     ) -> MomentState:
        """Each tile's f32 Σw, Σw·x and Σw·x² folded into the states in
        tile order (``moments_chunk``)."""
        from repro_torch.kernels.weighted_stats.ops import moments_chunk
        x = _as_2d(x).to(torch.float32)
        check_ieee_matmul(x)
        return MomentState(*moments_chunk((states.w, states.s1, states.s2),
                                          w, x, bn))


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
    bins); accuracy is about (hi - lo) / nbins.

    ``block_bins`` is a lowering knob of the matrix-free sketch, not part
    of the accumulator: on the card ``fused_poisson_states`` (and a
    ``GroupedStatistic`` over this quantile) runs the output-tiled kernel 7
    with windows of at most ``block_bins`` bins, the escape hatch for a
    d·nbins row too wide for one SM's shared memory; the counts are the
    same.  Inside a ``StatisticGroup`` the fused multi pass ignores it, as
    the JAX package's does."""

    def __init__(self, q: float, nbins: int = 2048, lo: float = 0.0,
                 hi: float = 1.0, block_bins: Optional[int] = None):
        self.q = float(q)
        self.nbins = int(nbins)
        self.lo = float(lo)
        self.hi = float(hi)
        self.block_bins = None if block_bins is None else int(block_bins)

    def with_range(self, lo: float, hi: float) -> "Quantile":
        """Re-ranged copy with a 1% margin each side; keeps ``nbins`` and
        ``block_bins``."""
        span = max(hi - lo, _EPS)
        return Quantile(self.q, self.nbins, lo - 0.01 * span,
                        hi + 0.01 * span, block_bins=self.block_bins)

    def init_state(self, dim: int, device="cpu") -> HistogramState:
        return HistogramState(
            counts=torch.zeros(dim, self.nbins, device=device),
            lo=torch.full((dim,), self.lo, device=device),
            hi=torch.full((dim,), self.hi, device=device))

    def update(self, state: HistogramState, values, weights=None):
        """One weighted_histogram pass: kernel 10 for values on the card,
        its plain version on the CPU; ``weights=None`` is unit weights."""
        from repro_torch.kernels.weighted_hist.ops import weighted_histogram
        x = _as_2d(values).to(torch.float32)
        w = None if weights is None else _w(x, weights)
        delta = weighted_histogram(x, w, state.lo, state.hi, self.nbins)
        return HistogramState(counts=state.counts + delta, lo=state.lo,
                              hi=state.hi)

    def update_batch(self, states: HistogramState, values, weights
                     ) -> HistogramState:
        """All B rows of ``weights`` in one weighted_histogram pass (kernel
        10 at R = B on the card)."""
        from repro_torch.kernels.weighted_hist.ops import weighted_histogram
        x = _as_2d(values).to(torch.float32)
        d, B = x.shape[1], weights.shape[0]
        delta = weighted_histogram(x, weights, self.lo, self.hi, self.nbins)
        return HistogramState(
            counts=states.counts + delta.reshape(B, d, self.nbins),
            lo=states.lo, hi=states.hi)

    def merge(self, a: HistogramState, b: HistogramState) -> HistogramState:
        return HistogramState(counts=a.counts + b.counts, lo=a.lo, hi=a.hi)

    def psum_state(self, state: HistogramState, axis_names
                   ) -> HistogramState:
        """Only the counts are additive; lo/hi are replicated configuration
        (summed, they would scale the bin range by the shard count)."""
        from repro_torch.core._mesh import psum_tensors
        counts, = psum_tensors([state.counts], axis_names)
        return HistogramState(counts=counts, lo=state.lo, hi=state.hi)

    def fused_poisson_states(self, seed, values, B, n_valid=None,
                             valid_mask=None):
        from repro_torch.kernels.weighted_hist import ops as wh_ops
        d = values.shape[1]
        counts = wh_ops.fused_poisson_hist(seed, values, self.lo, self.hi,
                                           self.nbins, B, n_valid=n_valid,
                                           valid_mask=valid_mask,
                                           block_bins=self.block_bins)
        return HistogramState(
            counts=counts,
            lo=torch.full((B, d), self.lo, device=values.device),
            hi=torch.full((B, d), self.hi, device=values.device))

    def accumulator_key(self):
        # quantiles over one bin range share one sketch, whatever q
        return ("hist", self.nbins, self.lo, self.hi)

    def tile_update(self, states: HistogramState, x_tile, w_tile
                    ) -> HistogramState:
        """The tile math of the histogram scan lowering: a plain
        scatter-add, never kernel 10; ``chunk_update`` of one tile."""
        return self.chunk_update(states, x_tile, w_tile, w_tile.shape[1])

    def chunk_update(self, states: HistogramState, x, w, bn: int
                     ) -> HistogramState:
        """The chunk's tiles as one scatter-add (their adds land in the
        order of one scatter a tile)."""
        from repro_torch.kernels.weighted_hist.ops import hist_tile_update
        del bn
        x = x.to(torch.float32)
        d = x.shape[1]
        B = w.shape[0]
        counts = states.counts.reshape(B, d * self.nbins).clone()
        hist_tile_update(counts, x, w,
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


def Median(nbins: int = 2048, lo: float = 0.0, hi: float = 1.0,
           block_bins: Optional[int] = None) -> Quantile:
    return Quantile(0.5, nbins=nbins, lo=lo, hi=hi, block_bins=block_bins)


@dataclasses.dataclass(frozen=True)
class KMeansState:
    sums: torch.Tensor      # (k, d) weighted point sums per cluster
    counts: torch.Tensor    # (k,) weighted counts
    inertia: torch.Tensor   # () weighted within-cluster SSE


class KMeansStep(Statistic):
    """One weighted Lloyd assignment pass against ``centroids`` (paper
    §6.3 runs K-Means over the sample).

    ``finalize`` gives the new centroids, ``finalize_inertia`` the mean
    within-cluster SSE; ``kmeans_fit`` drives the Lloyd loop.  The device
    of the values picks the kernels (kernels/kmeans_assign): ``update``
    is one kmeans_assign pass, ``fused_poisson_states`` the bootstrap over
    k-means; the centroids move to the values' device there."""

    def __init__(self, centroids):
        self.centroids = torch.as_tensor(centroids).to(torch.float32)

    def init_state(self, dim: int, device="cpu") -> KMeansState:
        k, d = self.centroids.shape
        return KMeansState(
            sums=torch.zeros(k, d, dtype=torch.float32, device=device),
            counts=torch.zeros(k, dtype=torch.float32, device=device),
            inertia=torch.zeros((), dtype=torch.float32, device=device))

    def update(self, state: KMeansState, values, weights=None
               ) -> KMeansState:
        from repro_torch.kernels.kmeans_assign import ops as ka_ops
        x = _as_2d(values).to(torch.float32)
        sums, counts, inertia = ka_ops.kmeans_assign(x, weights,
                                                     self.centroids)
        return KMeansState(sums=state.sums + sums,
                           counts=state.counts + counts,
                           inertia=state.inertia + inertia)

    def fused_poisson_states(self, seed, values, B, n_valid=None,
                             valid_mask=None):
        from repro_torch.kernels.kmeans_assign import ops as ka_ops
        sums, counts, inertia = ka_ops.fused_poisson_kmeans(
            seed, values, self.centroids, B, n_valid=n_valid,
            valid_mask=valid_mask)
        return KMeansState(sums=sums, counts=counts, inertia=inertia)

    def update_batch(self, states: KMeansState, values, weights
                     ) -> KMeansState:
        """One kmeans_assign pass per weight row (kernel 9 on the card)."""
        return _rows_of_update(self, states, values, weights)

    def tile_update(self, states: KMeansState, x_tile, w_tile
                    ) -> KMeansState:
        """The tile math of the fused plain version, so a group member
        consumes the shared weight tile as its dedicated run does;
        ``chunk_update`` of one tile."""
        return self.chunk_update(states, x_tile, w_tile, w_tile.shape[1])

    def chunk_update(self, states: KMeansState, x, w, bn: int
                     ) -> KMeansState:
        """Each tile's f32 contraction (``contract_chunk``) folded into
        the states in tile order."""
        from repro_torch.kernels.kmeans_assign import ops as ka_ops
        from repro_torch.kernels.weighted_stats.ops import fold_tiles
        x = x.to(torch.float32)
        cent = ka_ops.centroids_on(self.centroids, x.device, x.shape[1])
        parts = ka_ops.contract_chunk(w, ka_ops.tile_operands(x, cent),
                                      x.shape[1], bn)
        return KMeansState(*(fold_tiles(a, t) for a, t in zip(
            (states.sums, states.counts, states.inertia), parts)))

    def finalize(self, state: KMeansState):
        return state.sums / (state.counts.unsqueeze(-1) + _EPS)

    def finalize_inertia(self, state: KMeansState):
        """Inertia per unit weight; over the last axis, so a B-leading
        batch of states gives (B,)."""
        return state.inertia / (state.counts.sum(-1) + _EPS)


def kmeans_fit(values, k: int, iters: int, key, weights=None, init=None,
               device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted Lloyd's on in-memory values; returns (centroids, the
    inertia of the last pass).

    ``init`` (k, d) pins the starting centroids; by default they are k
    distinct rows drawn as ``jax.random.choice(key, n, (k,),
    replace=False)`` draws them.  ``device=None`` means the card."""
    from repro_torch.device import as_tensor, resolve_device
    from repro_torch.random import permutation
    x = _as_2d(as_tensor(values, resolve_device(device)))
    if init is None:
        init = x[permutation(key, x.shape[0], device=x.device)[:k]]
    elif init.shape[0] != k:
        raise ValueError(f"init has {init.shape[0]} centroids, expected "
                         f"k={k}")
    cent = torch.as_tensor(init).to(device=x.device, dtype=torch.float32)
    inertia = torch.zeros((), device=x.device)
    for _ in range(int(iters)):
        step = KMeansStep(cent)
        st = step.update(step.init_state(x.shape[1], x.device), x, weights)
        cent, inertia = step.finalize(st), step.finalize_inertia(st)
    return cent, inertia


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
        self.mergeable = all(m.mergeable for m in members)
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

    def with_members(self, members) -> "StatisticGroup":
        """The group rebuilt around new member instances (same length):
        how ``bind_params`` re-attaches the members' parameters."""
        return StatisticGroup(members)

    def init_state(self, dim: int, device="cpu") -> Tuple:
        return tuple(s.init_state(dim, device) for s in self.slots)

    def init_batch(self, dim: int, B: int, device="cpu") -> Tuple:
        return tuple(s.init_batch(dim, B, device) for s in self.slots)

    def update(self, state, values, weights=None):
        return tuple(s.update(st, values, weights)
                     for s, st in zip(self.slots, state))

    def merge(self, a, b):
        return tuple(s.merge(ai, bi) for s, ai, bi in zip(self.slots, a, b))

    def psum_state(self, state, axis_names):
        return tuple(s.psum_state(st, axis_names)
                     for s, st in zip(self.slots, state))

    def update_batch(self, states, values, weights):
        return tuple(s.update_batch(st, values, weights)
                     for s, st in zip(self.slots, states))

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


def _tree_take(state, g: int, axis: int):
    """Index ``g`` off ``axis`` of every leaf: one key's view of a G-keyed
    state or result."""
    return tree_map(lambda a: a.select(axis, g), state)


def _tree_stack(states, axis: int):
    """Inverse of ``_tree_take``: stack per-key states into a G axis."""
    return tree_map(lambda *ls: torch.stack(ls, dim=axis), *states)


class GroupedStatistic(Statistic):
    """GROUP BY for the bootstrap: the inner statistic per key, in one pass,
    under ONE shared Poisson(1) resample stream.

    The key is the LAST column of ``values``: integers 0..num_groups-1
    stored as floats; the other columns are the inner statistic's data.
    The state is the inner state with a leading (G, ...) key axis on every
    leaf, (B, G, ...) in a batch; ``finalize``/``correct`` give the inner
    result with a leading G axis, so bootstrap thetas are (B, G, ...) and
    sessions and ``bootstrap`` build a ``KeyedAccuracyReport`` from
    ``num_groups``.

    Key g's thetas are bitwise the inner statistic run alone with
    ``valid_mask = (key == g)`` under the same seed: each implicit weight
    is drawn once and routed to its key's slot by an exact 0/1 mask.
    ``fused_poisson_states`` takes the keyed kernels for moment, Quantile
    and KMeansStep inners; a custom inner takes the tiled scan
    (``fused_multi.ops.fused_poisson_tiled``), whose ``tile_update`` here
    key-masks each block of the shared weights, so no (B, n) weight
    matrix exists.  The device of the values picks the kernel, so the
    only ``backend`` is None.
    """

    _BACKENDS = (None,)

    def __init__(self, inner: Statistic, num_groups: int, backend=None):
        if isinstance(inner, GroupedStatistic):
            raise TypeError("GroupedStatistic cannot nest another "
                            "GroupedStatistic: use a single key column "
                            "with the product of the key spaces")
        if isinstance(inner, StatisticGroup):
            raise TypeError("GroupedStatistic over a StatisticGroup is not "
                            "supported: group the keyed statistics "
                            "instead, StatisticGroup([GroupedStatistic(m, "
                            "G) for m in members])")
        if not isinstance(inner, Statistic):
            raise TypeError(f"inner statistic {inner!r} is not a Statistic")
        if backend not in self._BACKENDS:
            raise ValueError(f"unknown grouped backend: {backend!r} (the "
                             "device of the values picks the kernel)")
        num_groups = int(num_groups)
        if num_groups < 1:
            raise ValueError(f"num_groups must be >= 1, got {num_groups}")
        self.inner = inner
        self.num_groups = num_groups
        self.mergeable = bool(inner.mergeable)

    def with_inner(self, inner: Statistic) -> "GroupedStatistic":
        """Rebuilt around a new inner instance: how ``bind_params``
        re-attaches the inner statistic's parameters (KMeansStep
        centroids)."""
        return GroupedStatistic(inner, self.num_groups)

    @staticmethod
    def _split_key(values) -> Tuple[torch.Tensor, torch.Tensor]:
        x = _as_2d(values)
        if x.shape[1] < 2:
            raise ValueError("GroupedStatistic needs at least 2 columns: "
                             "data columns plus the key as the LAST column")
        return x[:, :-1], x[:, -1]

    def init_state(self, dim: int, device="cpu") -> State:
        # ``dim`` counts the key column; the inner statistic sees one fewer.
        return _tree_stack([self.inner.init_state(dim - 1, device)
                            for _ in range(self.num_groups)], 0)

    def update(self, state, values, weights=None):
        x, gid = self._split_key(values)
        w = _w(x, weights)
        return _tree_stack([
            self.inner.update(_tree_take(state, g, 0), x,
                              w * (gid == g).to(torch.float32))
            for g in range(self.num_groups)], 0)

    def merge(self, a, b):
        return self.inner.merge(a, b)

    def psum_state(self, state, axis_names):
        return self.inner.psum_state(state, axis_names)

    def finalize(self, state) -> Result:
        return _tree_stack([self.inner.finalize(_tree_take(state, g, 0))
                            for g in range(self.num_groups)], 0)

    def finalize_batch(self, states) -> Result:
        return _tree_stack([
            self.inner.finalize_batch(_tree_take(states, g, 1))
            for g in range(self.num_groups)], 1)

    def correct(self, result, p: float) -> Result:
        return self.inner.correct(result, p)

    def correct_per_key(self, result, p_keys, key_axis: int = 0) -> Result:
        """Key g's slice corrected by its OWN sampled fraction p_keys[g].

        Under stratified sampling each key is drawn at its own rate, so a
        whole-table p mis-scales count-like inners (Sum, Count).
        ``key_axis`` is 0 for an estimate (G, ...), 1 for thetas
        (B, G, ...).  A key with p_g = 0 was never sampled: its result
        passes through uncorrected instead of being divided to NaN."""
        if key_axis not in (0, 1):
            raise ValueError(f"key_axis must be 0 (an estimate) or 1 "
                             f"(thetas), got {key_axis}")
        if len(p_keys) != self.num_groups:
            raise ValueError(f"p_keys has {len(p_keys)} entries for "
                             f"{self.num_groups} keys")
        outs = []
        for g in range(self.num_groups):
            pg = float(p_keys[g])
            outs.append(self.inner.correct(
                _tree_take(result, g, key_axis), pg if pg > 0.0 else 1.0))
        return _tree_stack(outs, key_axis)

    def _per_key_batch(self, advance, states, values, weights):
        x, gid = self._split_key(values)
        return _tree_stack([
            advance(_tree_take(states, g, 1), x,
                    weights * (gid == g).to(torch.float32)[None, :])
            for g in range(self.num_groups)], 1)

    def update_batch(self, states, values, weights):
        """Each key's slot advances by the inner ``update_batch`` under
        weights · (key == g); ``states`` leaves are (B, G, ...)."""
        return self._per_key_batch(self.inner.update_batch, states, values,
                                   weights)

    def tile_update(self, states, x_tile, w_tile):
        """As ``update_batch``, with the inner statistic's plain tile
        math."""
        return self._per_key_batch(self.inner.tile_update, states, x_tile,
                                   w_tile)

    def fused_poisson_states(self, seed, values, B, n_valid=None,
                             valid_mask=None):
        """(B, G, ...) states under one implicit Poisson(1) stream,
        segment-reduced per key in the kernels: no (B, n) weight matrix
        and no (n, G) one-hot.  A custom inner takes the tiled scan over
        the same stream."""
        x, gid = self._split_key(values)
        G, inner = self.num_groups, self.inner
        kw = dict(n_valid=n_valid, valid_mask=valid_mask, group_ids=gid,
                  num_groups=G)
        if isinstance(inner, _MomentStatistic):
            from repro_torch.kernels.weighted_stats import ops as ws_ops
            return inner.from_moments(*ws_ops.fused_poisson_moments(
                seed, x, B, **kw))
        if isinstance(inner, Quantile):
            from repro_torch.kernels.weighted_hist import ops as wh_ops
            counts = wh_ops.fused_poisson_hist(seed, x, inner.lo, inner.hi,
                                               inner.nbins, B,
                                               block_bins=inner.block_bins,
                                               **kw)
            d = x.shape[1]
            return HistogramState(
                counts=counts,
                lo=torch.full((B, G, d), inner.lo, device=x.device),
                hi=torch.full((B, G, d), inner.hi, device=x.device))
        if isinstance(inner, KMeansStep):
            from repro_torch.kernels.kmeans_assign import ops as ka_ops
            return KMeansState(*ka_ops.fused_poisson_kmeans(
                seed, x, inner.centroids, B, **kw))
        from repro_torch.kernels.fused_multi import ops as fm_ops
        return fm_ops.fused_poisson_tiled(self, seed, values, B,
                                          n_valid=n_valid,
                                          valid_mask=valid_mask)


class Window:
    """A windowed view of a mergeable statistic over a live row stream.

    Rows fall into fixed-width *panes* of ``slide`` rows; pane ``p`` covers
    global rows ``[p*slide, (p+1)*slide)``.  A window of ``size`` rows is
    a whole number of panes (``size % slide == 0``), so a live session
    keeps one mergeable state per pane in a ring and answers a window by
    re-merging its ``size // slide`` newest panes: eviction drops a pane
    and re-merges the survivors, never subtracts and never re-reads the
    log, and device memory is O(panes · state) whatever the stream's
    length.  The wrapped statistic must be ``mergeable``.
    """

    def __init__(self, stat: Statistic, size: int, slide: int):
        if not isinstance(stat, Statistic):
            raise TypeError(f"{stat!r} is not a Statistic")
        if not getattr(stat, "mergeable", False):
            raise ValueError(
                f"{type(stat).__name__} is not mergeable; windowed folding "
                f"re-merges per-pane states and needs an associative merge")
        size, slide = int(size), int(slide)
        if slide < 1:
            raise ValueError(f"slide must be >= 1, got {slide}")
        if size < slide:
            raise ValueError(f"size ({size}) must be >= slide ({slide})")
        if size % slide != 0:
            raise ValueError(f"size ({size}) must be a multiple of the "
                             f"slide ({slide}) so a window is a whole "
                             f"number of panes")
        self.stat = stat
        self.size = size
        self.slide = slide

    @property
    def panes(self) -> int:
        """Panes per window: the ring's steady-state occupancy bound."""
        return self.size // self.slide

    def pane_of(self, row: int) -> int:
        return int(row) // self.slide

    def pane_rows(self, pane: int) -> Tuple[int, int]:
        return pane * self.slide, (pane + 1) * self.slide

    def _static_key(self):
        return (type(self).__name__, self.size, self.slide,
                self.stat._static_key())

    def __repr__(self):
        return (f"{type(self).__name__}({self.stat!r}, size={self.size}, "
                f"slide={self.slide})")


class TumblingWindow(Window):
    """Non-overlapping windows: one pane a window, reset every ``size``
    rows.  ``TumblingWindow(stat, s)`` is ``SlidingWindow(stat, s, s)``."""

    def __init__(self, stat: Statistic, size: int):
        super().__init__(stat, size, size)


class SlidingWindow(Window):
    """Overlapping windows of ``size`` rows advancing by ``slide`` rows;
    the ring holds ``size // slide`` panes and a report re-merges them."""

    def __init__(self, stat: Statistic, size: int, slide: int):
        super().__init__(stat, size, slide)


class MeanLoss(Mean):
    """Alias used by train/earl_eval: the statistic is the per-example loss."""


#: the statistics ``bind_params`` rebuilds, by their ``split_params`` name
_BINDABLE = {cls.__qualname__: cls for cls in (
    Mean, Sum, Count, Var, Std, Quantile, KMeansStep, StatisticGroup,
    GroupedStatistic, MeanLoss)}
