"""Early-accurate evaluation — EARL's flagship integration, as in the JAX
package's ``repro/train/earl_eval.py``.

Estimating a model's loss over a huge eval corpus IS the paper's problem
("compute statistic f over data set S"): the statistic is the mean
per-example loss, a sampled example is one document, and the model forward
is the user's job j.  The eval step is wrapped in a sampler whose
``take(a, b)`` *computes* the per-example losses of permutation rows
[a, b); EarlSession (pilot → SSABE → expand-until-accurate, with
delta-maintained resamples) then works unchanged on top, its Mean through
the ported bootstrap kernels.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.reduce_api import Mean
from repro_torch.core.session import EarlSession, EarlyResult
from repro_torch.data.pipeline import EvalSamplePipeline


class LossValuesSampler:
    """Adapter: EarlSession sampler whose rows are model losses.

    Lazily evaluates (and caches, on the host) per-example losses of
    permutation prefixes, in minibatches of ``eval_batch``."""

    def __init__(self, eval_step: Callable, params: Any,
                 pipeline: EvalSamplePipeline, eval_batch: int = 16,
                 aux_fn: Optional[Callable[[int], Any]] = None):
        self.eval_step = eval_step
        self.params = params
        self.pipeline = pipeline
        self.eval_batch = eval_batch
        self.aux_fn = aux_fn
        self.N = pipeline.N
        self._losses = np.full((self.N,), np.nan, np.float32)
        self._have = 0
        self.forwards = 0           # model forwards spent (for the speedup)

    def _ensure(self, upto: int) -> None:
        upto = min(upto, self.N)
        while self._have < upto:
            a = self._have
            b = min(a + self.eval_batch, upto)
            tokens, labels = self.pipeline.take(a, b)
            batch = {"tokens": tokens, "labels": labels}
            if self.aux_fn is not None:
                batch["aux"] = self.aux_fn(b - a)
            losses = self.eval_step(self.params, batch)
            self._losses[a:b] = losses.to(torch.float32).cpu().numpy()
            self.forwards += b - a
            self._have = b

    def take(self, start: int, stop: int) -> torch.Tensor:
        self._ensure(stop)
        return torch.from_numpy(self._losses[start:stop].copy())


@dataclasses.dataclass
class EarlEval:
    """Early-accurate eval-loss estimation for a model + eval corpus.
    ``device`` is the session's (the card unless ``"cpu"``)."""
    eval_step: Callable
    params: Any
    pipeline: EvalSamplePipeline
    sigma: float = 0.01
    tau: float = 0.02
    eval_batch: int = 16
    aux_fn: Optional[Callable[[int], Any]] = None
    device: Any = None

    def run(self, key) -> EarlyResult:
        sampler = LossValuesSampler(self.eval_step, self.params,
                                    self.pipeline, self.eval_batch,
                                    self.aux_fn)
        session = EarlSession(sampler, Mean(), sigma=self.sigma,
                              tau=self.tau, device=self.device)
        result = session.run(key)
        # attach the real cost (model forwards), the paper's speedup metric
        result.history.append({"model_forwards": sampler.forwards,
                               "full_pass_forwards": sampler.N})
        return result
