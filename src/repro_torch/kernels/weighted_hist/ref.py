"""The shared binning rule and the scatter-add histogram oracle.

Out-of-range values are clipped into the edge bins (x <= lo to bin 0,
x >= hi and +-inf to bin nbins-1); NaN values carry no mass.  The same
rule, bit for bit, is ``bin_index`` in csrc/hist_tile.cuh: f32 span with
an epsilon, IEEE division, clip in f32, truncate, clip again.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def _bin_indices(values: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 nbins: int) -> torch.Tensor:
    """int64 bin index per element, clipped into [0, nbins-1]."""
    x = values.to(torch.float32)
    span = hi - lo + _EPS
    idx_f = torch.clamp((x - lo) / span * nbins, 0.0, float(nbins - 1))
    return torch.clamp(idx_f.to(torch.int32), 0, nbins - 1).to(torch.int64)


def finite_mass_mask(values: torch.Tensor) -> torch.Tensor:
    """1.0 where the value carries histogram mass, 0.0 for NaN."""
    return (~torch.isnan(values)).to(torch.float32)


def weighted_hist_scatter_ref(values: torch.Tensor, weights: torch.Tensor,
                              lo: torch.Tensor, hi: torch.Tensor,
                              nbins: int) -> torch.Tensor:
    """(n, d) values, (n,) weights, (d,) lo/hi -> (d, nbins) counts."""
    idx = _bin_indices(values, lo[None, :], hi[None, :], nbins)
    d = idx.shape[1]
    flat = idx + torch.arange(d, device=idx.device)[None, :] * nbins
    w = weights.to(torch.float32)[:, None].expand(idx.shape)
    w = w * finite_mass_mask(values)
    counts = torch.zeros(d * nbins, dtype=torch.float32, device=idx.device)
    counts.index_add_(0, flat.reshape(-1), w.reshape(-1))
    return counts.reshape(d, nbins)
