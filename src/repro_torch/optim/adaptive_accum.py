"""EARL-adaptive gradient accumulation, the JAX package's
``repro/optim/adaptive_accum.py``.

Microbatch gradients g_1..g_M are an iid sample of the full-batch
gradient.  EARL's question — "is the sample accurate enough to stop
early?" — applies verbatim: bootstrap the per-microbatch gradient *norms*
(a cheap scalar proxy), and stop accumulating when the coefficient of
variation of the mean-gradient estimate drops below sigma.

This is a host-side control decision between steps: ``gradient_cv``
draws its bootstrap weights on the CPU (the port's ``poisson_weights``,
bitwise ``jax.random.poisson``) over a handful of norms, and takes the
c_v of the B bootstrap means as ``core.accuracy.coefficient_of_variation``
does, with its f32 sums taken one value after another: the order of the
JAX package's CPU reduction over B values, which keeps the two within
one f32 ulp (torch's vectorised sums differ by up to five).  The
accumulator is the first microbatch's gradient tree; each later one is
added into it in place and dropped, so at most two gradient trees are
live at once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.bootstrap import poisson_weights
from repro_torch.optim.adamw import tree_leaves


@dataclasses.dataclass
class AccumDecision:
    stop: bool
    cv: float
    microbatches_used: int
    mean_loss: float = float("nan")


def gradient_cv(norms: np.ndarray, B: int = 32, seed: int = 0) -> float:
    """Bootstrap c_v of the mean gradient-norm estimate from per-microbatch
    norms (scalar proxy for the gradient's sampling error)."""
    n = len(norms)
    if n < 2:
        return float("inf")
    w = poisson_weights(trandom.PRNGKey(seed), B, n, device="cpu").numpy()
    boots = (w @ norms) / np.maximum(w.sum(axis=1), 1e-9)
    return _cv_f32(np.asarray(boots, dtype=np.float32))


def _sum_f32(x: np.ndarray) -> np.float32:
    s = np.float32(0.0)
    for v in x:
        s = np.float32(s + v)
    return s


def _cv_f32(t: np.ndarray) -> float:
    """std/|mean| of the B values ``t`` (ddof 1), in f32, the sums in
    order; 1e-12 guards the division as in core.accuracy."""
    b = np.float32(len(t))
    mean = np.float32(_sum_f32(t) / b)
    var = np.float32(_sum_f32(np.square(t - mean)) / np.float32(b - 1))
    den = np.float32(np.sqrt(np.float32(mean * mean)))
    return float(np.float32(np.sqrt(var) / np.float32(den + np.float32(
        1e-12))))


@torch.no_grad()
def earl_accumulate_gradients(
        grad_fn: Callable[[Any, Any], Tuple[Any, torch.Tensor]],
        params: Any, microbatches: List[Any], sigma: float = 0.02,
        min_micro: int = 2) -> Tuple[Any, AccumDecision]:
    """grad_fn(params, mb) -> (grads tree, grad_norm scalar[, loss]).

    Accumulates microbatch gradients; after each one, bootstraps the norm
    history and stops early when cv <= sigma (the remaining microbatches
    are skipped).  Returns the mean of the used microbatches' gradients
    (the first microbatch's tree, divided in place) and the decision."""
    acc = None
    norms: List[float] = []
    losses: List[float] = []
    used = 0
    for mb in microbatches:
        out = grad_fn(params, mb)
        grads, gnorm = out[0], out[1]
        if len(out) > 2:
            losses.append(float(out[2]))
        if acc is None:
            acc = grads
        else:
            into = dict(tree_leaves(acc))
            for path, g in tree_leaves(grads):
                into[path].add_(g)
        del out, grads
        norms.append(float(gnorm))
        used += 1
        if used >= min_micro:
            cv = gradient_cv(np.asarray(norms), seed=used)
            if cv <= sigma:
                break
    for _, g in tree_leaves(acc):
        g.div_(used)
    final_cv = gradient_cv(np.asarray(norms), seed=0)
    return acc, AccumDecision(
        stop=used < len(microbatches), cv=final_cv, microbatches_used=used,
        mean_loss=float(np.mean(losses)) if losses else float("nan"))
