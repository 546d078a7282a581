"""Bootstrap engines (paper §3).

A resample is a weight vector over the sample, so f(resample) is a
weighted statistic.  Two backends, as in the JAX package:

* ``None`` (the default) materializes the (B, n) weights, the paper's
  engine: ``engine="multinomial"`` draws exact multinomial counts (Efron's
  bootstrap), ``"poisson"`` iid Poisson(1) weights, bitwise the JAX
  package's draws (up to rare ulp flips of ``log``, see ``random``).
  ``bootstrap_thetas`` applies the statistic under every row, as one batch
  (``Statistic.update_batch``); with ``use_kernel`` moment statistics go
  through one weighted_moments pass (kernel 11), and a Quantile's rows are
  one weighted_histogram pass (kernel 10) on the card either way.
* ``"fused_rng"`` is matrix-free: the Poisson(1) weights are drawn inside
  the contraction from the counter-based threefry tile stream, and the
  (B, n) weight matrix never exists: statistics opt in through
  ``Statistic.fused_poisson_states`` (moments, histogram sketches, groups);
  others fall back to materializing the same implicit weights.  The
  stream seed derives from the key, so delta maintenance and common random
  numbers carry over from the JAX package bit for bit.

Multi-rank (``mesh=`` and ``data_axis=`` on the fused backend): the n axis
is split over the mesh's data axis, each rank (one process per rank,
every rank holding the same global values) draws its implicit weights
in-kernel on its own contiguous block of rows, from a stream keyed by
``(base_seed, shard, chunk)`` through ``offset_seed``, and only the small
per-resample states cross ranks (``Statistic.psum_state``).  The paper's
Hadoop mapping: mapper = a shard's fused update, combiner = ``merge``,
reducer = the ordered sum of mergeable states.
``sharded_fused_states(..., mesh=None, nshards=s)`` runs the same
decomposition in one process and is bitwise the mesh run (both fold the
shards left to right in shard order): the oracle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as trandom
from repro_torch.core import accuracy
from repro_torch.core._mesh import (check_mesh, data_groups, num_shards,
                                    shard_index)
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
    """The int32 stream seed of ``key``: ``randint(key, (), 0, 2^31 - 1)``,
    drawn on the host (a seed is control state)."""
    return int(trandom.randint(key, (), 0, _SEED_MOD, device="cpu"))


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


def _block(x: torch.Tensor, start: int, rows: int) -> torch.Tensor:
    """Rows [start, start + rows) of ``x``, zero-padded past its end."""
    blk = x[start:start + rows]
    if blk.shape[0] == rows:
        return blk
    return torch.cat([blk, blk.new_zeros(rows - blk.shape[0], x.shape[1])])


def _shard_local_states(stat: Statistic, base_seed: int,
                        x_local: torch.Tensor, B: int, shard_idx: int,
                        nshards: int, n_valid_local: int,
                        chunk: Optional[int] = None, step: int = 0,
                        with_estimate: bool = False):
    """Fused states of ONE shard's local rows.

    Local chunk c of shard i draws the stream ``offset_seed(base_seed,
    (step + c) * nshards + i)``: distinct per (shard, chunk) within a call
    and per (shard, step) across delta extends, and with one shard the
    index collapses to the chunk or step counter, the unsharded seeds.
    ``chunk=None`` is one fused call over the local rows.
    ``with_estimate=True`` also folds the shard's valid rows into one
    unweighted estimate state in the same pass: ``(states, est_state)``.
    """
    n_local, dim = x_local.shape
    dev = x_local.device

    def estimate(est, xc, nv):
        vi = (torch.arange(xc.shape[0], device=dev) < nv).to(torch.float32)
        return stat.update(est, xc, vi)

    if chunk is None:
        seed = offset_seed(base_seed, step * nshards + shard_idx)
        states = fused_resample_states(stat, seed, x_local, B,
                                       n_valid=n_valid_local)
        if not with_estimate:
            return states
        return states, estimate(stat.init_state(dim, dev), x_local,
                                n_valid_local)
    nchunks = -(-n_local // chunk)
    states = stat.init_batch(dim, B, dev)
    est = stat.init_state(dim, dev)
    for c in range(nchunks):
        xc = _block(x_local, c * chunk, chunk)
        nv = min(max(n_valid_local - c * chunk, 0), chunk)
        seed = offset_seed(base_seed, (step + c) * nshards + shard_idx)
        delta = fused_resample_states(stat, seed, xc, B, n_valid=nv)
        if with_estimate:
            est = estimate(est, xc, nv)
        states = stat.merge(states, delta)
    return (states, est) if with_estimate else states


def sharded_fused_states(stat: Statistic, base_seed: int,
                         x2: torch.Tensor, B: int, mesh=None,
                         data_axis: str = "data",
                         nshards: Optional[int] = None,
                         chunk: Optional[int] = None, step: int = 0,
                         with_estimate: bool = False):
    """B-leading fused per-resample states of ``x2`` split over ``mesh``'s
    ``data_axis`` (the multi-rank matrix-free path).

    Rows go to ``nshards`` contiguous blocks of ``m = ceil(n / nshards)``
    (the tail zero-padded, shard i valid for ``clip(n - i·m, 0, m)``
    rows); each shard draws its implicit Poisson(1) weights in-kernel
    from its own stream (``_shard_local_states``) and only the states are
    summed across ranks (``Statistic.psum_state``).  Every rank passes the
    same global ``x2`` and gets the same replicated states.

    ``mesh=None`` with ``nshards`` runs the same decomposition in this
    process, merging the shards left to right: the oracle a mesh run is
    bitwise equal to.  ``chunk`` streams each shard's rows through
    fixed-size fused calls; ``step`` offsets the stream counter for delta
    extends.  They are mutually exclusive: the index (step + c)·nshards +
    shard would alias across (step, chunk) pairs.  ``with_estimate=True``
    returns ``(states, est_state)``, the unweighted estimate state summed
    over the shards the same way.  The device of ``x2`` runs the
    kernels."""
    if not getattr(stat, "mergeable", True):
        raise ValueError(
            f"sharded_fused_states requires a mergeable statistic, but "
            f"{type(stat).__name__} sets mergeable=False — its per-shard "
            "states cannot be merge/psum-combined.  Use the single-device "
            "bootstrap (backend='fused_rng' without mesh=/nshards=), or "
            "implement an associative merge and set mergeable=True")
    if not isinstance(x2, torch.Tensor):
        raise TypeError("sharded_fused_states takes a torch.Tensor; its "
                        "device picks the kernel (cuda) or the plain "
                        "version (cpu)")
    if mesh is not None:
        nshards = num_shards(check_mesh(mesh), data_axis)
    if nshards is None:
        raise ValueError("sharded_fused_states needs mesh= or nshards=")
    if chunk is not None and step != 0:
        raise ValueError("chunk= and step= are mutually exclusive (their "
                         "stream indices would alias; see docstring)")
    x2 = _as_2d(x2)
    n = x2.shape[0]
    B, nshards = int(B), int(nshards)
    m = -(-n // nshards)

    def local(i):
        nv = min(max(n - i * m, 0), m)
        return _shard_local_states(stat, base_seed, _block(x2, i * m, m), B,
                                   i, nshards, nv, chunk=chunk, step=step,
                                   with_estimate=with_estimate)

    if mesh is None:
        states = est = None
        for i in range(nshards):
            si = local(i)
            if with_estimate:
                si, ei = si
                est = ei if est is None else stat.merge(est, ei)
            states = si if states is None else stat.merge(states, si)
        return (states, est) if with_estimate else states
    groups = data_groups(mesh, data_axis)
    st = local(shard_index(mesh, data_axis))
    if with_estimate:
        st, est = st
        return (stat.psum_state(st, groups), stat.psum_state(est, groups))
    return stat.psum_state(st, groups)


def multinomial_counts(key, B: int, n: int,
                       resample_size: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """Exact multinomial bootstrap counts, (B, n) int32: ``resample_size``
    (default n) uniform draws a row, counted by one scatter-add.
    ``device=None`` draws on the card."""
    device = resolve_device(device)
    m = n if resample_size is None else int(resample_size)
    idx = trandom.randint(key, (B, m), 0, n, device=device)
    counts = torch.zeros(B, n, dtype=torch.int32, device=device)
    return counts.scatter_add_(1, idx.long(), torch.ones_like(idx))


def poisson_weights(key, B: int, n: int, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Poisson(1) bootstrap weights, (B, n) of ``dtype``; ``device=None``
    draws on the card."""
    return trandom.poisson(key, 1.0, (B, n), dtype=dtype,
                           device=resolve_device(device))


def weights_for(engine: str, key, B: int, n: int,
                device=None) -> torch.Tensor:
    """(B, n) f32 bootstrap weights of ``engine``; ``device=None`` draws
    on the card."""
    if engine == "multinomial":
        return multinomial_counts(key, B, n, device=device).to(
            torch.float32)
    if engine == "poisson":
        return poisson_weights(key, B, n, device=device)
    raise ValueError(f"unknown bootstrap engine: {engine!r}")


def bootstrap_thetas(values, stat: Statistic, weights: torch.Tensor,
                     use_kernel: bool = False):
    """``stat`` under every row of the (B, n) ``weights``: (B, ...)
    results.  ``use_kernel`` sends moment statistics through one
    weighted_moments pass; otherwise the rows are one batched update."""
    x2 = _as_2d(values)
    B = weights.shape[0]
    if use_kernel and stat.moment_powers is not None:
        from repro_torch.kernels.weighted_stats import ops as ws_ops
        states = stat.from_moments(*ws_ops.weighted_moments(weights, x2))
    else:
        states = stat.update_batch(
            stat.init_batch(x2.shape[1], B, x2.device), x2, weights)
    return stat.finalize_batch(states)


def check_backend(backend, engine, mesh) -> None:
    """The backend rules the JAX package's entry points share; a mesh must
    also be a ``DeviceMesh`` (TypeError)."""
    if backend not in (None, "fused_rng"):
        raise ValueError(f"unknown bootstrap backend: {backend!r}")
    if backend == "fused_rng" and engine != "poisson":
        raise ValueError("backend='fused_rng' requires the poisson engine "
                         "(in-kernel RNG draws iid Poisson(1) weights)")
    if mesh is not None:
        if backend != "fused_rng":
            raise ValueError("mesh= requires backend='fused_rng' (the "
                             "sharded path psums fused states; materialized "
                             "weights would ship a (B, n) matrix across "
                             "devices)")
        check_mesh(mesh)


def bootstrap(values, stat: Statistic, B: int, key, engine: str = "poisson",
              p: float = 1.0, use_kernel: bool = False, alpha: float = 0.05,
              backend: Optional[str] = None, mesh=None,
              data_axis: str = "data", device=None) -> BootstrapResult:
    """One bootstrap pass: B resamples, their result distribution and its
    accuracy.  ``p`` (the sampled fraction) goes to ``stat.correct``.

    ``backend=None`` materializes the weights of ``engine``;
    ``"fused_rng"`` runs the matrix-free pass (module docstring), and
    with ``mesh=`` (a ``DeviceMesh``) splits the rows over ``data_axis``
    and sums the per-shard states: every rank passes the same values.
    ``device=None`` means the card."""
    if not isinstance(stat, Statistic):
        raise TypeError("stat must be a reduce_api.Statistic")
    check_backend(backend, engine, mesh)
    dev = resolve_device(device)
    x2 = _as_2d(as_tensor(values, dev))
    B, n = int(B), x2.shape[0]
    if backend == "fused_rng":
        if mesh is not None:
            states = sharded_fused_states(stat, seed_from_key(key), x2, B,
                                          mesh=mesh, data_axis=data_axis)
        else:
            states = fused_resample_states(stat, seed_from_key(key), x2, B)
        thetas = stat.finalize_batch(states)
    else:
        thetas = bootstrap_thetas(x2, stat,
                                  weights_for(engine, key, B, n, device=dev),
                                  use_kernel=use_kernel)
    thetas = stat.correct(thetas, p)
    estimate = stat.correct(stat(x2), p)
    report = accuracy.report_for(thetas, alpha=alpha,
                                 num_groups=getattr(stat, "num_groups",
                                                    None))
    return BootstrapResult(estimate=estimate, thetas=thetas, report=report,
                           B=B, n=n)


def bootstrap_chunked(values, stat: Statistic, B: int, key,
                      chunk: int = 65536, engine: str = "poisson",
                      p: float = 1.0, backend: Optional[str] = None,
                      mesh=None, data_axis: str = "data",
                      device=None) -> BootstrapResult:
    """The sample in chunks of ``chunk`` rows, merging per-resample states,
    so no (B, n) matrix exists: (B, chunk) at most with ``backend=None``,
    whose chunk i draws ``poisson_weights(fold_in(key, i), B, chunk)``;
    with ``"fused_rng"`` chunk i is the stream ``offset_seed(base, i)``.
    The unweighted estimate rides the same pass over each chunk.  With
    ``mesh=`` (fused backend only) each rank streams its own block of rows
    in ``chunk``-row fused calls and the states are summed once at the
    end."""
    if engine != "poisson":
        raise ValueError("chunked bootstrap requires the poisson engine "
                         "(multinomial couples all chunks)")
    check_backend(backend, engine, mesh)
    dev = resolve_device(device)
    x = _as_2d(as_tensor(values, dev))
    n, dim = x.shape
    B = int(B)
    if mesh is not None:
        states, est = sharded_fused_states(
            stat, seed_from_key(key), x, B, mesh=mesh, data_axis=data_axis,
            chunk=chunk, with_estimate=True)
        return _chunked_result(stat, states, est, p, B, n)
    xp = torch.cat([x, x.new_zeros((-n) % chunk, dim)])
    states = stat.init_batch(dim, B, dev)
    est = stat.init_state(dim, dev)
    base_seed = seed_from_key(key)
    for i in range(xp.shape[0] // chunk):
        xi = xp[i * chunk:(i + 1) * chunk]
        n_valid = min(chunk, n - i * chunk)
        vi = (torch.arange(chunk, device=dev) < n_valid).to(torch.float32)
        est = stat.update(est, xi, vi)
        if backend == "fused_rng":
            delta = fused_resample_states(stat, offset_seed(base_seed, i),
                                          xi, B, n_valid=n_valid)
            states = stat.merge(states, delta)
        else:
            w = poisson_weights(trandom.fold_in(key, i), B, chunk,
                                device=dev) * vi[None, :]
            states = stat.update_batch(states, xi, w)
    return _chunked_result(stat, states, est, p, B, n)


def _chunked_result(stat, states, est, p, B, n) -> BootstrapResult:
    thetas = stat.correct(stat.finalize_batch(states), p)
    estimate = stat.correct(stat.finalize(est), p)
    return BootstrapResult(
        estimate=estimate, thetas=thetas,
        report=accuracy.report_for(thetas,
                                   num_groups=getattr(stat, "num_groups",
                                                      None)),
        B=B, n=n)
