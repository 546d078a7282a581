"""AdamW, the JAX package's ``repro/optim/adamw.py``, updating in place.

States mirror the parameter tree with a configurable state dtype
(arctic-480b holds m and v in bf16).  The arithmetic is the JAX
package's, in its order and in f32: ``g·scale``, ``m``, ``v``,
``mh = m/b1c``, ``vh = v/b2c``, ``delta = mh/(sqrt(vh)+eps) + wd·p`` and
``p - lr·delta``, then cast to the state dtype and to the parameter's.

The JAX package returns new trees; ``adamw_update`` here writes the new
params, m, v and step into the tensors it is given and returns those same
tensors: at granite-3-2b's full width a functional update would hold old
and new params, m and v at once, about 30 GB more than fits one card.
Each leaf is updated a chunk of ``CHUNK`` elements at a time, so the f32
temporaries of the update stay small whatever the leaf's size; the update
is elementwise, so the chunking changes no result.

On a state placed on a mesh (DTensor leaves, ``launch/sharding``) the
update runs the same chunks on each rank's local shards, and the global
norm sums each leaf's local squares, then sums them over the mesh axes
that split the leaf (an all-reduce; a leaf replicated over an axis is
counted once).  On a mesh of one rank both are bitwise the unsharded
update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator, Tuple

import torch

from repro_torch.models.decoder import tree_map
from repro_torch.models.layers import dtype_of
from repro_torch.models.sharded import is_dtensor, local_of, sum_over_shards

Params = Any
#: elements of a leaf updated (or squared and summed) at once
CHUNK = 1 << 24


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    state_dtype: str = "float32"


@dataclasses.dataclass
class OptState:
    m: Params
    v: Params
    step: torch.Tensor            # () int32, on the params' device


def tree_leaves(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted: the order in which
    ``jax.tree_util`` flattens a dict."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], f"{path}/{k}")
    else:
        yield path, tree


def _chunks(t: torch.Tensor) -> Iterator[torch.Tensor]:
    """Views of a contiguous tensor's elements, ``CHUNK`` at a time."""
    flat = t.view(-1)
    for i in range(0, flat.numel(), CHUNK):
        yield flat[i:i + CHUNK]


def adamw_init(params: Params, cfg: AdamWConfig) -> OptState:
    sd = dtype_of(cfg.state_dtype)
    leaves = [t for _, t in tree_leaves(params)]

    def zeros(p):       # a DTensor's zeros keep its placements
        if is_dtensor(p):
            return torch.zeros_like(p, dtype=sd)
        return torch.zeros(p.shape, dtype=sd, device=p.device)
    return OptState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                    step=torch.zeros((), dtype=torch.int32,
                                     device=leaves[0].device))


def _schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    warm = torch.clamp_max((step + 1).to(torch.float32)
                           / max(cfg.warmup_steps, 1), 1.0)
    return warm * cfg.lr


@torch.no_grad()
def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares in f32, leaves in
    ``tree_leaves`` order (the JAX package's).  A DTensor leaf's local
    squares are summed over the mesh axes that split it."""
    total = None
    for _, leaf in tree_leaves(tree):
        s = None
        for c in _chunks(local_of(leaf).contiguous()):
            cs = torch.sum(torch.square(c.to(torch.float32)))
            s = cs if s is None else s + cs
        if is_dtensor(leaf):
            s = sum_over_shards(s, leaf)
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: OptState,
                 cfg: AdamWConfig) -> Tuple[Params, OptState, dict]:
    """One AdamW step with global-norm clipping and decoupled weight
    decay.  Mutates ``params``, ``state.m``, ``state.v`` and
    ``state.step`` in place and returns them (the same objects), with
    ``{"grad_norm", "lr"}`` as 0-d f32 tensors on the params' device.
    ``grads`` are read only.  DTensor params need m, v and grads placed
    as they are; each rank updates its local shards."""
    gnorm = global_norm(grads)
    clip = torch.full_like(gnorm, cfg.grad_clip)
    scale = torch.clamp_max(clip / (gnorm + 1e-9), 1.0)
    step_t = local_of(state.step)
    lr = _schedule(cfg, step_t)
    step_t.add_(1)
    step = step_t.to(torch.float32)
    b1c = 1.0 - torch.pow(torch.full_like(step, cfg.b1), step)
    b2c = 1.0 - torch.pow(torch.full_like(step, cfg.b2), step)
    sd = dtype_of(cfg.state_dtype)
    flat_g = dict(tree_leaves(grads))
    flat_m = dict(tree_leaves(state.m))
    flat_v = dict(tree_leaves(state.v))
    for path, p in tree_leaves(params):
        g, m, v = flat_g[path], flat_m[path], flat_v[path]
        if is_dtensor(p):       # each rank updates its own shards
            for name, t in (("gradient", g), ("m", m), ("v", v)):
                if not is_dtensor(t) or t.placements != p.placements:
                    raise ValueError(
                        f"{path}: the {name} must be placed as the "
                        f"parameter ({p.placements}), got "
                        f"{getattr(t, 'placements', 'a plain tensor')}")
            p, g, m, v = (t.to_local() for t in (p, g, m, v))
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError(f"adamw_update updates contiguous leaves in "
                             f"place; {path} is not")
        for pc, gc, mc, vc in zip(_chunks(p), _chunks(g.contiguous()),
                                  _chunks(m), _chunks(v)):
            g32 = gc.to(torch.float32) * scale
            m_new = cfg.b1 * mc.to(torch.float32) + (1 - cfg.b1) * g32
            v_new = cfg.b2 * vc.to(torch.float32) + (1 - cfg.b2) * g32 * g32
            mh = m_new / b1c
            vh = v_new / b2c
            p32 = pc.to(torch.float32)
            delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
            pc.copy_((p32 - lr * delta).to(p.dtype))
            mc.copy_(m_new.to(sd))
            vc.copy_(v_new.to(sd))
    return params, state, {"grad_norm": gnorm, "lr": lr}


def opt_state_axes(params_axes: Any) -> Any:
    """Logical axes for OptState given the params' axes (m/v mirror them)."""
    return OptState(m=params_axes, v=params_axes, step=())
