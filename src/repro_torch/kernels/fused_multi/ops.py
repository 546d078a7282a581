"""The fused multi-statistic bootstrap pass (the StatisticGroup hot path).

``fused_poisson_multi`` gives, for every slot accumulator of a
``StatisticGroup``, the B per-resample states under ONE implicit Poisson(1)
weight stream and one pass over x.  A CUDA tensor launches the
hand-written kernel (csrc/fused_pass.cu, replacing the TPU kernel
repro/kernels/fused_multi/kernel.py: fused_poisson_multi_kernel), which
takes at most one moments slot and any number of histogram slots, or
raises; a CPU tensor runs the plain version, the JAX package's
``_multi_scan``: each weight tile is drawn once and handed to every
slot's ``tile_update``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (MAX_ROWS, check_cuda_f32, hist_rows,
                                       pass_geometry, stream_ptr)
from repro_torch.kernels.weighted_hist.ops import (hist_slots_args,
                                                   range_vector)
from repro_torch.kernels.weighted_stats.ops import (Prepared, mask_ptr,
                                                    moment_buffers, prepare,
                                                    tile_scan)


def _multi_scan(slots, seed: int, pr: Prepared) -> Tuple:
    """Plain version: one scan, one weight tile per step, every slot fed.

    A moments slot carries its running sums across tiles in float64 and
    rounds them to f32 once, as ``moments_plain`` does."""
    from repro_torch.core.reduce_api import MomentState

    def sums_as(st, dtype):
        if not isinstance(st, MomentState):
            return st
        return MomentState(w=st.w.to(dtype), s1=st.s1.to(dtype),
                           s2=st.s2.to(dtype))

    states = [sums_as(s.init_batch(pr.d, pr.Bp, pr.device), torch.float64)
              for s in slots]

    def consume(w, xt):
        for i, s in enumerate(slots):
            states[i] = s.tile_update(states[i], xt, w)

    tile_scan(pr, seed, consume)
    return tuple(sums_as(st, torch.float32) for st in states)


def _multi_cuda(slots, seed: int, pr: Prepared) -> Tuple:
    from repro_torch.core.reduce_api import (HistogramState, MomentState,
                                             Quantile, _MomentStatistic)
    kinds = []
    for s in slots:
        if isinstance(s, _MomentStatistic):
            kinds.append("moments")
        elif isinstance(s, Quantile):
            kinds.append("hist")
        else:
            raise ValueError(
                f"the fused_multi CUDA kernel takes moment and histogram "
                f"slots only, not {type(s).__name__}")
    if kinds.count("moments") > 1:
        raise ValueError("a group holds at most one moments slot")
    check_cuda_f32("values", pr.xp)
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    hists = [s for s, k in zip(slots, kinds) if k == "hist"]
    mom = "moments" in kinds
    bufs = moment_buffers(pr, ranges) if mom else (None,) * 6
    ptrs = [None if b is None else b.data_ptr() for b in bufs]
    rows, hist_args, out = MAX_ROWS, (0, None, None, None, 0, None), None
    if hists:
        meta, lo_t, hi_t, total = hist_slots_args(pr, [
            (s.nbins, range_vector(s.lo, pr.d), range_vector(s.hi, pr.d))
            for s in hists])
        rows = hist_rows(total, tpc)
        out = torch.zeros(pr.Bp, total, dtype=torch.float32,
                          device=pr.device)
        hist_args = (len(hists), meta.data_ptr(), lo_t.data_ptr(),
                     hi_t.data_ptr(), total, out.data_ptr())
    fused_poisson_multi.launches += 1
    _build.launch("fused_pass", int(seed), pr.n_valid, pr.Bp, pr.np_, pr.bb,
                  pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr), rows, tpc,
                  ranges, *ptrs, *hist_args, stream_ptr(pr.device))

    states, off = [], 0
    for s, kind in zip(slots, kinds):
        if kind == "moments":
            states.append(MomentState(w=bufs[3], s1=bufs[4], s2=bufs[5]))
        else:
            width = pr.d * s.nbins
            counts = out[:, off:off + width].reshape(pr.Bp, pr.d, s.nbins)
            off += width
            states.append(HistogramState(
                counts=counts,
                lo=torch.full((pr.Bp, pr.d), s.lo, device=pr.device),
                hi=torch.full((pr.Bp, pr.d), s.hi, device=pr.device)))
    return tuple(states)


def fused_poisson_multi(group, seed: int, values: torch.Tensor, B: int,
                        n_valid=None, valid_mask=None) -> Tuple:
    """Slot-ordered tuple of B-leading per-resample states of ``group``
    under one shared implicit Poisson(1) weight stream."""
    from repro_torch.core.reduce_api import tree_map
    pr = prepare(values, B, n_valid, valid_mask)
    if pr.device.type == "cuda":
        states = _multi_cuda(group.slots, seed, pr)
    else:
        states = _multi_scan(group.slots, seed, pr)
    return tree_map(lambda a: a[:pr.B], states)


fused_poisson_multi.launches = 0
