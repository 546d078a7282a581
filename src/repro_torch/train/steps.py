"""The step functions of the JAX package's ``repro/train/steps.py`` for
serving and evaluation: the eval, prefill and decode steps.  PyTorch runs
eagerly, so a step is the plain function (no jit).  The train step waits
with ``optim/`` and attention's backward kernel (ROADMAP.md §1)."""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import decoder
from repro_torch.models.config import ModelConfig

Params = Any


def make_eval_step(cfg: ModelConfig):
    """(params, batch) -> per-example loss (B,) — the earl_eval statistic."""
    @torch.no_grad()
    def eval_step(params: Params, batch: Dict[str, Any]) -> torch.Tensor:
        return decoder.per_example_loss(cfg, params, batch)
    return eval_step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def prefill_step(params: Params, batch: Dict[str, Any]):
        return decoder.prefill(cfg, params, batch["tokens"],
                               aux=batch.get("aux"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params: Params, cache: Params, token: torch.Tensor,
                    pos):
        return decoder.decode_step(cfg, params, cache, token, pos)
    return decode_step
