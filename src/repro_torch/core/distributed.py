"""Distributed EARL: the bootstrap over a mesh's data axes.

MapReduce mapping, as in the JAX package:
  mapper  -> per-shard state update under shard-local Poisson weights
  combine -> Statistic.merge (associative)
  reducer -> the ordered sum of states across the data axes
             (``Statistic.psum_state``), finalized on every rank.

Shard independence is why the Poisson engine is the distributed default:
the weights of the rows on shard d depend only on (key, d, row), never on
other shards.

The port runs one process per rank of a ``DeviceMesh``: every rank passes
the same global values, ``shard_values`` gives it its own padded block of
rows and of the validity mask, and ``build_bootstrap_step``'s step runs on
that block.  ``DistributedEarl`` wraps the step with accuracy reports and
the ft/ shard-loss paths.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch import random as trandom
from repro_torch.core import accuracy
from repro_torch.core._mesh import (check_mesh, data_groups, num_shards,
                                    shard_index)
from repro_torch.core.bootstrap import (BootstrapResult, _block,
                                        fused_resample_states, offset_seed,
                                        seed_from_key)
from repro_torch.core.reduce_api import Statistic, _as_2d
from repro_torch.device import as_tensor, resolve_device


def _poisson_for_shard(key, shard_id: int, B: int, n_local: int,
                       device=None) -> torch.Tensor:
    """(B, n_local) f32 Poisson(1) weights of one shard: ``poisson(
    fold_in(key, shard_id), 1.0, (B, n_local))``, bitwise the JAX
    package's draw.  ``device=None`` draws on the card."""
    return trandom.poisson(trandom.fold_in(key, shard_id), 1.0,
                           (B, n_local), dtype=torch.float32,
                           device=resolve_device(device))


def build_bootstrap_step(mesh, stat: Statistic, B: int,
                         data_axes: Sequence[str] = ("data",),
                         donate: bool = True,
                         backend: Optional[str] = None):
    """A step ``(values, mask, key) -> (thetas, estimate)`` over this
    rank's block of a sample (what ``shard_values`` returns).

    values: (n_local, d), mask: (n_local,) 1.0 for real rows, 0.0 for
    padding or a lost shard's rows.  ``backend=None`` materializes the
    shard's (B, n_local) Poisson weights (``_poisson_for_shard``, keyed
    by the flat shard index) times the mask and advances the states in
    one ``update_batch``; ``"fused_rng"`` draws them in-kernel from the
    stream ``offset_seed(seed_from_key(key), shard)`` with the mask as
    ``valid_mask``, so any mask works, interior holes included.  The
    states, and the unweighted estimate's state under the mask, are summed
    across the data axes by ``Statistic.psum_state`` (Quantile's lo/hi
    stay as they are).  ``donate`` stands in the JAX package's place (the
    step keeps no reference to its inputs either way)."""
    del donate
    if backend not in (None, "fused_rng"):
        raise ValueError(f"unknown distributed backend: {backend!r}")
    check_mesh(mesh)
    data_axes = tuple(data_axes)
    groups = data_groups(mesh, data_axes)
    B = int(B)

    def step(values, mask, key):
        idx = shard_index(mesh, data_axes)
        n_local, dim = values.shape
        dev = values.device
        if backend == "fused_rng":
            states = fused_resample_states(
                stat, offset_seed(seed_from_key(key), idx), values, B,
                valid_mask=mask)
        else:
            w = _poisson_for_shard(key, idx, B, n_local, device=dev) \
                * mask[None, :]
            states = stat.update_batch(stat.init_batch(dim, B, dev), values,
                                       w)
        states = stat.psum_state(states, groups)
        thetas = stat.finalize_batch(states)
        est_state = stat.update(stat.init_state(dim, dev), values, mask)
        estimate = stat.finalize(stat.psum_state(est_state, groups))
        return thetas, estimate

    return step


def pad_to_shards(values, nshards: int):
    """Rows padded to a multiple of ``nshards``: (padded, mask)."""
    x = _as_2d(torch.as_tensor(values))
    n = x.shape[0]
    pad = (-n) % nshards
    xp = torch.cat([x, x.new_zeros(pad, x.shape[1])])
    mask = torch.cat([torch.ones(n, dtype=torch.float32, device=x.device),
                      torch.zeros(pad, dtype=torch.float32,
                                  device=x.device)])
    return xp, mask


def _local(mesh, data_axes, x: torch.Tensor, mask: torch.Tensor):
    """This rank's contiguous block of rows of ``x`` and ``mask``,
    ceil(n / nshards) rows, zero-padded past the end."""
    nshards = num_shards(mesh, data_axes)
    m = -(-x.shape[0] // nshards)
    start = shard_index(mesh, data_axes) * m
    return _block(x, start, m), _block(mask[:, None], start, m)[:, 0]


def shard_values(mesh, values, data_axes: Sequence[str] = ("data",),
                 device=None):
    """This rank's (values, mask) block of the padded sample: the rows
    ``pad_to_shards`` gives the rank's flat shard index over
    ``data_axes``.  ``device=None`` puts them on the card."""
    check_mesh(mesh)
    data_axes = tuple(data_axes)
    x = _as_2d(as_tensor(values, resolve_device(device)))
    xp, mask = pad_to_shards(x, num_shards(mesh, data_axes))
    return _local(mesh, data_axes, xp, mask)


@dataclasses.dataclass
class DistributedEarl:
    """Mesh-wide EARL estimator over a global sample that every rank
    passes whole (each keeps its own block).  Used by the ft/ recovery,
    straggler and elastic paths.  ``device=None`` runs on the card."""
    mesh: object
    stat: Statistic
    B: int
    sigma: float = 0.05
    data_axes: Sequence[str] = ("data",)
    backend: Optional[str] = None   # "fused_rng" = in-kernel shard weights
    device: Optional[torch.device] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._step = build_bootstrap_step(self.mesh, self.stat, self.B,
                                          self.data_axes, donate=False,
                                          backend=self.backend)

    def _result(self, thetas, est, p: float, n: int) -> BootstrapResult:
        thetas = self.stat.correct(thetas, p)
        est = self.stat.correct(est, p)
        return BootstrapResult(
            estimate=est, thetas=thetas,
            report=accuracy.report_for(
                thetas, num_groups=getattr(self.stat, "num_groups", None)),
            B=self.B, n=n)

    def estimate(self, values, key, p: float = 1.0) -> BootstrapResult:
        xs, ms = shard_values(self.mesh, values, self.data_axes,
                              device=self.device)
        thetas, est = self._step(xs, ms, key)
        return self._result(thetas, est, p, len(values))

    def estimate_with_loss_mask(self, values, mask, key, p: float = 1.0
                                ) -> BootstrapResult:
        """ft/ path: ``mask`` (n,) already zeroes the lost shards' rows.

        Works on both backends: the fused one multiplies its implicit
        weight tiles by the mask's block (interior holes included), the
        materialized one its weight matrix; the same estimator either
        way.  The report's n is the mask's sum."""
        x = _as_2d(as_tensor(values, self.device))
        m = as_tensor(mask, self.device).reshape(-1)
        xs, ms = _local(self.mesh, tuple(self.data_axes), x, m)
        thetas, est = self._step(xs, ms, key)
        return self._result(thetas, est, p, int(m.sum()))

    def estimate_elastic(self, values, key, events, policy):
        """Mid-run degradation: the shards in ``events`` that died or
        missed the deadline feed masked partial sums (their mask block is
        zero; the survivors' work is not recomputed), the CI widens
        through ``correct(p_surviving)``, and ``policy`` turns
        ``meets_bound`` into continue-approximate or checkpoint-restart.
        ``events`` is an ``ft.ShardEvents``, ``policy`` an
        ``ft.FailurePolicy``; returns an ``ft.ElasticReport``."""
        from repro_torch.ft.policy import elastic_estimate
        return elastic_estimate(self, values, key, events, policy)
