"""Carry a JAX run's state across into the port.

The JAX package's objects arrive as numpy copies (``np.asarray`` of every
leaf, e.g. ``jax.tree_util.tree_map(np.asarray, state)``); nothing here
imports jax or the JAX package.  What crosses:

* a PRNG key: uint32[2];
* statistic states: anything with ``w, s1, s2`` (a moment state),
  ``counts, lo, hi`` (a histogram state) or ``sums, counts, inertia`` (a
  k-means state), or a tuple of them (a group); a GroupedStatistic's
  states cross the same way, with the key axis G on every leaf;
* a Poisson delta run: its states, point-estimate state, key, n, step
  and backend;
* a sharded store: its splits;
* a model's params (or serve caches): the nested dict of arrays, in the
  JAX package's layout, which the port keeps;
* a train state: its params and its AdamW state (m, v and step, each
  leaf in its own dtype: arctic-480b's bf16 m and v stay bf16).

This is the system's counterpart of carrying weights across: a run begun
in one package continues in the other from the same RNG stream.  A tree
carried across reaches a mesh as a JAX run's sharded state does, through
``launch.sharding.distribute_tree`` with the shardings ``resolve_tree``
gives (``jax.device_put``'s counterpart).
"""
from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from repro_torch.core.bootstrap import check_backend
from repro_torch.core.delta import PoissonDelta
from repro_torch.core.reduce_api import (HistogramState, KMeansState,
                                         MomentState, Statistic)
from repro_torch.data.store import ShardedStore
from repro_torch.device import resolve_device
from repro_torch.random import key_data


def key_from_numpy(key) -> torch.Tensor:
    return key_data(np.asarray(key, dtype=np.uint32))


def state_from_numpy(state: Any, device=None):
    """A moment / histogram / k-means state, or a tuple of them, as port
    states."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    if isinstance(state, (tuple, list)):
        return tuple(state_from_numpy(s, dev) for s in state)
    if all(hasattr(state, f) for f in ("w", "s1", "s2")):
        return MomentState(w=t(state.w), s1=t(state.s1), s2=t(state.s2))
    if all(hasattr(state, f) for f in ("counts", "lo", "hi")):
        return HistogramState(counts=t(state.counts), lo=t(state.lo),
                              hi=t(state.hi))
    if all(hasattr(state, f) for f in ("sums", "counts", "inertia")):
        return KMeansState(sums=t(state.sums), counts=t(state.counts),
                           inertia=t(state.inertia))
    raise TypeError(f"no port state for {type(state).__name__}")


def poisson_delta_from_numpy(stat: Statistic, B: int, states, est_state,
                             key, n: int, step: int, backend=None,
                             device=None) -> PoissonDelta:
    """A port ``PoissonDelta`` continuing a JAX package delta run;
    ``backend`` is the run's own (the JAX package's default is None)."""
    check_backend(backend, "poisson", None)
    dev = resolve_device(device)
    return PoissonDelta(stat=stat, key=key_from_numpy(key),
                        states=state_from_numpy(states, dev),
                        est_state=state_from_numpy(est_state, dev),
                        B=int(B), n=int(n), step=int(step), device=dev,
                        backend=backend)


def store_from_splits(splits: Iterable[np.ndarray]) -> ShardedStore:
    """A port store over copies of another store's splits."""
    return ShardedStore([np.array(s, copy=True) for s in splits])


def _tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy leaf as a tensor of the same type.  A bf16 leaf arrives as an
    ``ml_dtypes.bfloat16`` array, which ``torch.from_numpy`` rejects: its
    bits cross through a uint16 view."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a, copy=True).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device=None):
    """A JAX parameter (or cache) tree, ``jax.tree_util.tree_map(np.asarray,
    params)``, as the port's nested dict of tensors on ``device`` (the
    card unless ``device="cpu"``), every leaf in its own type."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    return _tensor_from_numpy(tree, dev)


def train_state_from_numpy(params, opt_state, device=None):
    """A JAX ``TrainState`` as the port's: ``params`` its params tree and
    ``opt_state`` its ``OptState`` (anything with ``m``, ``v`` and
    ``step``), each a numpy copy; on ``device`` (the card unless
    ``device="cpu"``)."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.steps import TrainState
    dev = resolve_device(device)
    step = torch.tensor(int(np.asarray(opt_state.step)), dtype=torch.int32,
                        device=dev)
    return TrainState(
        params=params_from_numpy(params, dev),
        opt=OptState(m=params_from_numpy(opt_state.m, dev),
                     v=params_from_numpy(opt_state.v, dev), step=step))
