"""The fused multi-statistic bootstrap pass (the StatisticGroup hot path),
and the generic tiled scan.

``fused_poisson_multi`` gives, for every slot accumulator of a
``StatisticGroup``, the B per-resample states under ONE implicit Poisson(1)
weight stream.  A CUDA tensor routes each slot to its kernel with the
group's seed, so every member is bitwise its dedicated run: the moment
slot (at most one) and the histogram slots share one launch of the
hand-written kernel (csrc/fused_pass.cu, replacing the TPU kernel
repro/kernels/fused_multi/kernel.py: fused_poisson_multi_kernel); a
KMeansStep slot runs the k-means kernel (``fused_poisson_kmeans``) and a
GroupedStatistic slot its keyed kernels (``fused_poisson_states``), each
paying the hash once more; a custom slot runs ``fused_poisson_tiled``.  A
CPU tensor runs the plain version, the JAX package's ``_multi_scan``: each
chunk of weight tiles is drawn once and handed to every slot's
``chunk_update``.

``fused_poisson_tiled`` is the JAX package's generic matrix-free scan for
one statistic: the implicit weights a bounded block of tiles at a time,
each block fed to the statistic's plain ``tile_update``, so no (B, n)
weight matrix exists.  On the card kernel 1 (csrc/poisson_counts.cu, from
its n-tile offset) draws a chunk of tiles and the chunk is one
``tile_update``; on the CPU the plain scan feeds one tile at a time, in
the JAX package's order.  Weights, and so integer outputs, are bitwise
the same; float sums differ by their order only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (MAX_ROWS, check_cuda_f32,
                                       pass_geometry, pass_hist_rows,
                                       stream_ptr)
from repro_torch.kernels.kmeans_assign.ops import centroids_on, kmeans_cuda
from repro_torch.kernels.poisson_counts.ops import poisson_tiles
from repro_torch.kernels.poisson_counts.ref import tiles_per_chunk
from repro_torch.kernels.weighted_hist.ops import (hist_slots_args,
                                                   range_vector)
from repro_torch.kernels.weighted_stats.ops import (Prepared, chunk_scan,
                                                    mask_ptr, moment_buffers,
                                                    prepare, tile_scan)


def _multi_scan(slots, seed: int, pr: Prepared) -> Tuple:
    """Plain version: one scan, each chunk of weight tiles drawn once and
    handed to every slot's ``chunk_update``.

    A moments or k-means slot carries its running sums across tiles in
    float64 and rounds them to f32 once, as its dedicated plain version
    (``moments_plain``, ``fused_kmeans_plain``) does."""
    from repro_torch.core.reduce_api import KMeansState, MomentState, tree_map

    def sums_as(st, dtype):
        if not isinstance(st, (MomentState, KMeansState)):
            return st
        return tree_map(lambda a: a.to(dtype), st)

    states = [sums_as(s.init_batch(pr.d, pr.Bp, pr.device), torch.float64)
              for s in slots]

    def consume(w, x):
        for i, s in enumerate(slots):
            states[i] = s.chunk_update(states[i], x, w, pr.bn)

    chunk_scan(pr, seed, consume)
    return tuple(sums_as(st, torch.float32) for st in states)


def slot_route(slot) -> str:
    """Where a group's slot goes on the card: "moments" and "hist" share
    the fused_pass launch, "kmeans" the k-means kernel, "keyed" the
    GroupedStatistic's own keyed kernels, "custom" the tiled scan."""
    from repro_torch.core.reduce_api import (GroupedStatistic, KMeansStep,
                                             Quantile, _MomentStatistic)
    if isinstance(slot, GroupedStatistic):
        return "keyed"
    if isinstance(slot, _MomentStatistic):
        return "moments"
    if isinstance(slot, Quantile):
        return "hist"
    if isinstance(slot, KMeansStep):
        return "kmeans"
    return "custom"


def _multi_cuda(slots, seed: int, pr: Prepared, values: torch.Tensor,
                n_valid, valid_mask) -> Tuple:
    from repro_torch.core.reduce_api import (HistogramState, KMeansState,
                                             MomentState)
    kinds = [slot_route(s) for s in slots]
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
        rows = pass_hist_rows(tpc, len(hists), pr.d, total)
        out = torch.zeros(pr.Bp, total, dtype=torch.float32,
                          device=pr.device)
        hist_args = (len(hists), meta.data_ptr(), lo_t.data_ptr(),
                     hi_t.data_ptr(), total, out.data_ptr())
    if mom or hists:
        fused_poisson_multi.launches += 1
        _build.launch("fused_pass", int(seed), pr.n_valid, pr.Bp, pr.np_,
                      pr.bb, pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr),
                      rows, tpc, ranges, *ptrs, *hist_args,
                      stream_ptr(pr.device))

    states, off = [], 0
    for s, kind in zip(slots, kinds):
        if kind == "moments":
            states.append(MomentState(w=bufs[3], s1=bufs[4], s2=bufs[5]))
        elif kind == "kmeans":
            states.append(KMeansState(*kmeans_cuda(
                pr, seed, centroids_on(s.centroids, pr.device, pr.d))))
        elif kind == "keyed":
            states.append(s.fused_poisson_states(
                seed, values, pr.B, n_valid=n_valid, valid_mask=valid_mask))
        elif kind == "custom":
            states.append(fused_poisson_tiled(
                s, seed, values, pr.B, n_valid=n_valid,
                valid_mask=valid_mask))
        else:
            width = pr.d * s.nbins
            counts = out[:, off:off + width].reshape(pr.Bp, pr.d, s.nbins)
            off += width
            states.append(HistogramState(
                counts=counts,
                lo=torch.full((pr.Bp, pr.d), s.lo, device=pr.device),
                hi=torch.full((pr.Bp, pr.d), s.hi, device=pr.device)))
    return tuple(states)


def fused_poisson_tiled(stat, seed: int, values: torch.Tensor, B: int,
                        n_valid=None, valid_mask=None):
    """B-leading per-resample states of ``stat`` under the implicit
    Poisson(1) weights, fed to ``stat.tile_update`` a block of weight
    tiles at a time (module docstring): the fused path of a statistic that
    segments or transforms the tile itself, e.g. a GroupedStatistic over a
    custom inner, whose ``tile_update`` key-masks the shared weights."""
    from repro_torch.core.reduce_api import tree_map
    pr = prepare(values, B, n_valid, valid_mask)
    states = stat.init_batch(pr.d, pr.Bp, pr.device)
    if pr.device.type == "cpu":
        def consume(w, xt):
            nonlocal states
            states = stat.tile_update(states, xt, w)
        tile_scan(pr, seed, consume)
    else:
        nt = pr.np_ // pr.bn
        step = tiles_per_chunk(pr.Bp, pr.bn)
        for c0 in range(0, nt, step):
            c1 = min(nt, c0 + step)
            cols = slice(c0 * pr.bn, c1 * pr.bn)
            w = poisson_tiles(seed, pr.n_valid, pr.Bp, pr.bb, pr.bn, c0, c1,
                              valid=None if pr.mp is None else pr.mp[cols],
                              device=pr.device)
            states = stat.tile_update(states, pr.xp[cols], w)
    return tree_map(lambda a: a[:pr.B], states)


def fused_poisson_multi(group, seed: int, values: torch.Tensor, B: int,
                        n_valid=None, valid_mask=None) -> Tuple:
    """Slot-ordered tuple of B-leading per-resample states of ``group``
    under one shared implicit Poisson(1) weight stream."""
    from repro_torch.core.reduce_api import tree_map
    pr = prepare(values, B, n_valid, valid_mask)
    if pr.device.type == "cuda":
        states = _multi_cuda(group.slots, seed, pr, values, n_valid,
                             valid_mask)
    else:
        states = _multi_scan(group.slots, seed, pr)
    return tree_map(lambda a: a[:pr.B], states)


fused_poisson_multi.launches = 0
