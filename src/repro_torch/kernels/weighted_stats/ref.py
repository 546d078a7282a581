"""Oracle for the weighted moments: an explicit (B, n) W against X."""
from __future__ import annotations

import torch


def weighted_moments_ref(weights: torch.Tensor, values: torch.Tensor):
    """weights (B, n), values (n, d) -> (w_tot (B,), s1 (B, d), s2 (B, d)).

    w_tot is summed in float64 and rounded once: the exact total of
    whole-number weights at any n, as the kernel sums it (an f32 sum
    rounds, in an order of its own, once the total passes 2^24)."""
    w = weights.to(torch.float32)
    x = values.to(torch.float32)
    return w.double().sum(dim=1).float(), w @ x, w @ (x * x)
