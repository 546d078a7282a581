"""Plain AdamW with global-norm clipping and decoupled weight decay, in
float32, over a flat dict of leaves, from the optimizer's equations:

    scale = min(1, clip / (‖g‖ + 1e-9))          ‖g‖ over every leaf
    g ← g·scale;  m ← b1·m + (1 - b1)·g;  v ← b2·v + (1 - b2)·g²
    p ← p - lr_t·(m/(1 - b1^t) / (sqrt(v/(1 - b2^t)) + eps) + wd·p)

with lr_t = lr·min(t / warmup_steps, 1) at step t = 1, 2, ...
"""
from __future__ import annotations

import math
from typing import Dict

import torch


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 grad_clip: float, warmup_steps: int, **_):
        self.params = params
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip, self.warmup = weight_decay, grad_clip, warmup_steps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0
        self.total = math.nan

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, float]:
        """One update in place; returns each leaf's gradient norm as the
        update takes it (after clipping).  ``total`` keeps the global norm
        before the clip."""
        total = math.sqrt(sum(float(torch.sum(g.double() ** 2))
                              for g in grads.values()))
        self.total = total
        scale = min(1.0, self.clip / (total + 1e-9))
        self.t += 1
        lr = self.lr * min(self.t / max(self.warmup, 1), 1.0)
        b1c, b2c = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        norms = {}
        for k, p in self.params.items():
            g = grads[k] * scale
            norms[k] = float(torch.linalg.vector_norm(g.double()))
            m, v = self.m[k], self.v[k]
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + self.eps) + self.wd * p
            p.sub_(lr * delta)
            del g, delta
        return norms
