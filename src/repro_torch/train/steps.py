"""The step functions of the JAX package's ``repro/train/steps.py``: the
train and grad steps, and the eval, prefill and decode steps.  PyTorch
runs eagerly, so a step is the plain function (no jit).

The train step is ``jax.value_and_grad`` of ``decoder.loss_fn`` then
``adamw_update``, which here writes the new params and optimizer state
into the state's own tensors (``optim/adamw.py``): the returned state is
the state passed in.  Gradients come from ``torch.autograd.grad`` over
every parameter leaf (detached leaves sharing the params' storage);
kernel 12's backward on the card, the projections' f32 backward products
(``models/layers._ProductOut``), remat (``models/decoder``).  A leaf that
gets no gradient raises, naming the leaf.  A state placed on a mesh
(``launch/sharding.distribute_tree``: DTensor leaves) runs through the
same steps, as ``jax.jit(step, in_shardings=...)`` runs the same step
function: the sharding comes from the inputs and the installed
``act_shard.activation_sharding`` context."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import decoder
from repro_torch.models.config import ModelConfig
from repro_torch.models.partitioning import param_axes
from repro_torch.optim.adamw import (AdamWConfig, OptState, adamw_init,
                                     adamw_update, global_norm,
                                     opt_state_axes, tree_leaves)

Params = Any


@dataclasses.dataclass
class TrainState:
    params: Params
    opt: OptState


def init_train_state(generator: Optional[torch.Generator],
                     cfg: ModelConfig, opt_cfg: AdamWConfig,
                     device=None) -> TrainState:
    """Random params (``decoder.init_params``: the JAX package's law, drawn
    from ``generator``, which takes the place of the JAX package's key)
    and zero AdamW states, on ``device`` (the card unless ``"cpu"``)."""
    params = decoder.init_params(cfg, generator, device)
    return TrainState(params=params, opt=adamw_init(params, opt_cfg))


def train_state_axes(state_shapes: Any) -> Any:
    """Logical axes for a TrainState (m/v mirror params)."""
    p_axes = param_axes(state_shapes.params)
    return TrainState(params=p_axes, opt=opt_state_axes(p_axes))


def _rebuild(tree, leaves):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def value_and_grad(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                   ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """(grads, metrics) of ``decoder.loss_fn`` at ``params``: grads a tree
    of params' structure, one tensor a leaf; metrics ``loss`` and
    ``tokens``, detached."""
    paths, leaves = zip(*tree_leaves(params))
    live = [t.detach().requires_grad_(True) for t in leaves]
    with torch.enable_grad():
        loss, metrics = decoder.loss_fn(cfg, _rebuild(params, iter(live)),
                                        batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    missing = [p for p, g in zip(paths, grads) if g is None]
    if missing:
        raise RuntimeError(f"no gradient reached the parameter leaves "
                           f"{missing}")
    return (_rebuild(params, iter(grads)),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """(state, batch) -> (state, metrics): loss, tokens, grad_norm, lr.
    The state is updated in place and returned."""
    def train_step(state: TrainState, batch: Dict[str, Any]):
        grads, metrics = value_and_grad(cfg, state.params, batch)
        _, _, opt_metrics = adamw_update(state.params, grads, state.opt,
                                         opt_cfg)
        del grads
        return state, dict(metrics, **opt_metrics)
    return train_step


def make_grad_step(cfg: ModelConfig):
    """(params, batch) -> (grads, grad_norm, loss) — EARL-adaptive accum."""
    def grad_step(params: Params, batch: Dict[str, Any]):
        grads, metrics = value_and_grad(cfg, params, batch)
        return grads, global_norm(grads), metrics["loss"]
    return grad_step


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
