"""Matrix-free bootstrap histogram sketch.

``fused_poisson_hist`` gives B per-resample (d, nbins) histograms under
the shared implicit Poisson(1) weights.  A CUDA tensor launches the
hand-written kernel (csrc/fused_pass.cu without moments, replacing the
TPU kernel repro/kernels/weighted_hist/kernel.py: fused_poisson_hist_kernel)
or raises; a CPU tensor runs the plain version, the JAX package's scatter
scan tile by tile.  Counts are sums of small integer weights, exact in
f32, so the two agree bit for bit.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (check_cuda_f32, hist_rows,
                                       pass_geometry, stream_ptr)
from repro_torch.kernels.weighted_hist.ref import (_bin_indices,
                                                   finite_mass_mask)
from repro_torch.kernels.weighted_stats.ops import (Prepared, mask_ptr,
                                                    prepare, tile_scan)


def hist_tile_update(counts: torch.Tensor, xt: torch.Tensor,
                     w: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     nbins: int) -> None:
    """Scatter one (B, bn) weight tile into (B, d·nbins) ``counts`` in
    place: the tile math of the JAX package's ``_fused_hist_scan``."""
    bn, d = xt.shape
    idx = _bin_indices(xt, lo[None, :], hi[None, :], nbins)     # (bn, d)
    flat = (idx + torch.arange(d, device=xt.device)[None, :] * nbins
            ).reshape(-1)
    wm = (w[:, :, None] * finite_mass_mask(xt)[None, :, :]).reshape(
        w.shape[0], bn * d)
    counts.index_add_(1, flat, wm)


def hist_plain(pr: Prepared, seed: int, lo: torch.Tensor, hi: torch.Tensor,
               nbins: int) -> torch.Tensor:
    counts = torch.zeros(pr.Bp, pr.d * nbins, device=pr.device)
    tile_scan(pr, seed, lambda w, xt: hist_tile_update(counts, xt, w, lo, hi,
                                                       nbins))
    return counts.reshape(pr.Bp, pr.d, nbins)


def to_card(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on the card.  A host tensor goes through pinned memory and an
    asynchronous copy, so the stream is not drained before the launch."""
    if t.device.type == "cpu":
        t = t.contiguous().pin_memory()
    return t.to(device, non_blocking=True)


def hist_slots_args(pr: Prepared, slots: Sequence[Tuple[int, torch.Tensor,
                                                         torch.Tensor]]):
    """Device tensors describing histogram slots (nbins, lo (d,), hi (d,)):
    the (nbins, column offset) table, the stacked lo/hi and the total
    output width Σ d·nbins."""
    meta, off = [], 0
    for nbins, _, _ in slots:
        meta += [int(nbins), off]
        off += pr.d * int(nbins)
    meta_t = to_card(torch.tensor(meta, dtype=torch.int32), pr.device)
    lo_t, hi_t = (to_card(torch.stack([s[i].to(slots[0][i].device)
                                       for s in slots]), pr.device)
                  for i in (1, 2))
    return meta_t, lo_t, hi_t, off


def hist_cuda(pr: Prepared, seed: int, lo: torch.Tensor, hi: torch.Tensor,
              nbins: int) -> torch.Tensor:
    check_cuda_f32("values", pr.xp)
    meta, lo_t, hi_t, total = hist_slots_args(pr, [(nbins, lo, hi)])
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    rows = hist_rows(total, tpc)
    out = torch.zeros(pr.Bp, total, dtype=torch.float32, device=pr.device)
    fused_poisson_hist.launches += 1
    _build.launch("fused_pass", int(seed), pr.n_valid, pr.Bp, pr.np_, pr.bb,
                  pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr), rows, tpc,
                  ranges, *(None,) * 6, 1, meta.data_ptr(), lo_t.data_ptr(),
                  hi_t.data_ptr(), total, out.data_ptr(),
                  stream_ptr(pr.device))
    return out.reshape(pr.Bp, pr.d, nbins)


def range_vector(v, d: int) -> torch.Tensor:
    """A scalar or (d,) bin edge as a (d,) f32 tensor, on the device of
    ``v`` when it is a tensor, else on the host."""
    return torch.as_tensor(v, dtype=torch.float32).expand(d).contiguous()


def fused_poisson_hist(seed: int, values: torch.Tensor, lo, hi, nbins: int,
                       B: int, n_valid=None, valid_mask=None, block_bins=None,
                       group_ids=None, num_groups=None) -> torch.Tensor:
    """values (n, d) or (n,), lo/hi scalar or (d,) -> (B, d, nbins) f32.

    ``n_valid`` and ``valid_mask`` act as in ``fused_poisson_moments``."""
    if block_bins is not None:
        raise NotImplementedError("fused_poisson_hist(block_bins=) (the "
                                  "output-tiled kernel) is not ported yet")
    if group_ids is not None or num_groups is not None:
        raise NotImplementedError("fused_poisson_hist(group_ids=) (GROUP "
                                  "BY) is not ported yet")
    pr = prepare(values, B, n_valid, valid_mask)
    lo_v, hi_v = range_vector(lo, pr.d), range_vector(hi, pr.d)
    if pr.device.type == "cuda":
        counts = hist_cuda(pr, seed, lo_v, hi_v, int(nbins))
    else:
        counts = hist_plain(pr, seed, lo_v.cpu(), hi_v.cpu(), int(nbins))
    return counts[:pr.B]


fused_poisson_hist.launches = 0
