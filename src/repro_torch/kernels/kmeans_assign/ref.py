"""The materialized oracle of one weighted Lloyd pass.

It builds exactly what the kernels avoid: the (n, k) distance matrix and
the (n, k) one-hot assignment.  Tests hold the tiled versions against it;
nothing else calls it.
"""
from __future__ import annotations

from typing import Tuple

import torch


def kmeans_assign_ref(values, weights, centroids
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """values (n, d), weights (n,), centroids (k, d) ->
    (sums (k, d), counts (k,), inertia ()).

    d² is the expanded form ‖x‖² − 2x·c + ‖c‖², clamped at 0 (f32
    cancellation can take it below 0 for a point at a centroid)."""
    x = torch.as_tensor(values, dtype=torch.float32)
    w = torch.as_tensor(weights, dtype=torch.float32)
    c = torch.as_tensor(centroids, dtype=torch.float32)
    d2 = ((x * x).sum(-1, keepdim=True) - 2.0 * x @ c.T
          + (c * c).sum(-1)).clamp_min(0.0)                   # (n, k)
    min_d2, a = d2.min(dim=-1)
    wa = torch.nn.functional.one_hot(a, c.shape[0]).to(torch.float32) \
        * w[:, None]
    return wa.T @ x, wa.sum(0), (w * min_d2).sum()
