"""Oracle for the weighted moments: an explicit (B, n) W against X."""
from __future__ import annotations

import torch


def weighted_moments_ref(weights: torch.Tensor, values: torch.Tensor):
    """weights (B, n), values (n, d) -> (w_tot (B,), s1 (B, d), s2 (B, d))."""
    w = weights.to(torch.float32)
    x = values.to(torch.float32)
    return w.sum(dim=1), w @ x, w @ (x * x)
