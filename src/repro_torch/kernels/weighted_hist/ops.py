"""Histogram sketches: of explicit weights, and matrix-free.

``weighted_histogram`` gives the (d, nbins) sketch of values under one
weight vector (``Quantile.update``), or (R, d, nbins) under R rows of an
explicit weight matrix (the materialized engines).  A CUDA tensor launches
the hand-written kernel 10 (csrc/weighted_hist.cu, replacing the TPU
kernel repro/kernels/weighted_hist/kernel.py: weighted_hist_kernel), which
streams W with 16-byte loads around each row's scalar head and tail and
adds whole-number weights with u32 shared atomics, or raises; a CPU tensor
runs the plain version, a batched ``weighted_hist_scatter_ref``.

``fused_poisson_hist`` gives B per-resample (d, nbins) histograms under
the shared implicit Poisson(1) weights, and with ``group_ids`` (GROUP BY)
one per key, (B, G, d, nbins).  A CUDA tensor launches the hand-written
kernel (csrc/fused_pass.cu without moments, replacing the TPU kernel
repro/kernels/weighted_hist/kernel.py: fused_poisson_hist_kernel; keyed,
the key-major histogram of csrc/fused_grouped.cu, an index pass and then
one chunk of keys a CTA, for which the reference has no TPU kernel; with
``block_bins``, keyed or not, the output-tiled kernel 7 of
csrc/fused_binblocked.cu, replacing fused_poisson_hist_binblocked_kernel,
which draws each weight once into a shared cache and walks the bin
windows over it) or raises; a CPU tensor runs the plain version, the JAX
package's scatter scan tile by tile.  Counts are sums of small integer weights,
exact in f32, so the two agree bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (SMEM_BYTES, binblocked_geometry,
                                       check_cuda_f32, hist_rows,
                                       keyed_hist_geometry, pass_geometry,
                                       pass_hist_rows, stream_ptr)
from repro_torch.kernels.weighted_hist.ref import (_bin_indices,
                                                   finite_mass_mask)
from repro_torch.kernels.weighted_stats.ops import (Prepared, key_masks,
                                                    chunk_scan, mask_ptr,
                                                    prepare)


def tile_bins(xt: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
              nbins: int):
    """(flat (bn·d,) bin index into a (d·nbins) row, finite-mass mask
    (bn, d)) of (bn, d) x rows: a tile, or a chunk of tiles."""
    d = xt.shape[1]
    idx = _bin_indices(xt, lo[None, :], hi[None, :], nbins)     # (bn, d)
    flat = (idx + torch.arange(d, device=xt.device)[None, :] * nbins
            ).reshape(-1)
    return flat, finite_mass_mask(xt)


def scatter_tile(counts: torch.Tensor, flat: torch.Tensor, fm: torch.Tensor,
                 w: torch.Tensor) -> None:
    """Add a (B, bn) weight tile at ``flat`` into (B, ·) ``counts``."""
    wm = (w[:, :, None] * fm[None, :, :]).reshape(w.shape[0], -1)
    counts.index_add_(1, flat, wm)


def hist_tile_update(counts: torch.Tensor, xt: torch.Tensor,
                     w: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                     nbins: int) -> None:
    """Scatter one (B, bn) weight tile into (B, d·nbins) ``counts`` in
    place: the tile math of the JAX package's ``_fused_hist_scan``."""
    flat, fm = tile_bins(xt, lo, hi, nbins)
    scatter_tile(counts, flat, fm, w)


def weighted_hist_plain(x: torch.Tensor, w, lo: torch.Tensor,
                        hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """Plain version of kernel 10: (R, d, nbins) counts of x (n, d) under
    w (R, n), or under unit weights (R = 1) when w is None; each row is
    ``weighted_hist_scatter_ref``'s flattened scatter-add."""
    n, d = x.shape
    if w is None:
        w = torch.ones(1, n, dtype=torch.float32, device=x.device)
    counts = torch.zeros(w.shape[0], d * nbins, device=x.device)
    hist_tile_update(counts, x, w, lo, hi, nbins)
    return counts.reshape(w.shape[0], d, nbins)


#: Threads of a kernel 10 CTA with W (csrc/weighted_hist.cu), each with a
#: shared slot of 9 u32 bin indices for the 7 columns its 4-column group
#: of each row can reach.
HIST_THREADS = 512
HIST_SLOT_BYTES = 4 * 9 * HIST_THREADS
#: Rows of W a kernel 10 CTA takes at most (kHistRows).
HIST_ROWS = 4
#: CTAs kernel 10 aims for on a 132-SM H100: two an SM with W; four an SM
#: for unit weights, each warp of 8 adding into one of 4 private copies
#: of the bins (measured faster than 8 copies at two an SM).
HIST_CTAS, UNIT_CTAS, HIST_COPIES = 264, 528, 4


def hist_dims(R: int, d: int, nbins: int) -> int:
    """Dimensions a CTA of kernel 10 bins: all d while one row's d·nbins
    f32 bins fit in shared memory beside the threads' bin slots, else as
    many as fit beside min(HIST_ROWS, R) rows (grid z covers the rest)."""
    room = SMEM_BYTES - 64 - HIST_SLOT_BYTES
    if d * 4 * nbins <= room:
        return d
    # raises when one dimension's bins do not fit
    hist_rows(nbins, HIST_SLOT_BYTES)
    return max(1, min(d, room // (4 * nbins * min(HIST_ROWS, max(R, 1)))))


def aligned_split(length: int, phase: int) -> Tuple[int, int]:
    """(head, groups) of a row of ``length`` floats whose first lies
    ``phase`` floats past a 16-byte boundary: ``head`` floats read one at
    a time, then ``groups`` 16-byte groups of 4; the tail is the rest."""
    head = min((4 - phase) % 4, length)
    return head, (length - head) // 4


class HistGeometry(NamedTuple):
    """Launch geometry of kernel 10.  Grid: x = ``ranges`` ranges of
    ``groups`` 4-column groups (range i: groups [i·groups, (i+1)·groups) of
    each row; the first range also takes every row's head, the last its
    tail), y = blocks of ``rows`` rows of W, z = chunks of ``dc``
    dimensions.  With W, ``whole_bins`` keeps u32 bins for whole-number
    weights beside the f32 ones where both fit.  Unit weights stream the
    flat n·d values of x the same way, one row, into ``copies`` private
    histograms."""
    dc: int
    rows: int
    groups: int
    ranges: int
    copies: int
    whole_bins: bool


def hist_geometry(R: int, n: int, d: int, nbins: int,
                  unit: bool) -> HistGeometry:
    dc = hist_dims(R, d, nbins)
    room = SMEM_BYTES - 64
    if unit:
        rows, copies, whole, target = 1, min(
            HIST_COPIES, room // (4 * dc * nbins)), False, UNIT_CTAS
        groups = n * d // 4
    else:
        def fit(sets):
            return (room - HIST_SLOT_BYTES) // (4 * sets * dc * nbins)
        whole = fit(2) >= 1
        rows = min(HIST_ROWS, max(R, 1), fit(2 if whole else 1))
        copies, target, groups = 1, HIST_CTAS, n // 4
    blocks = -(-max(R, 1) // rows) * -(-d // dc)
    ranges = max(1, min(-(-groups // HIST_THREADS), target // blocks))
    per = -(-groups // ranges)
    per = max(HIST_THREADS, per + (-per) % HIST_THREADS)
    return HistGeometry(dc, rows, per, max(1, -(-groups // per)), copies,
                        whole)


def weighted_hist_cuda(x: torch.Tensor, w, lo: torch.Tensor,
                       hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """Kernel 10 (csrc/weighted_hist.cu) on the card: (R, d, nbins)."""
    check_cuda_f32("values", x)
    if w is not None:
        check_cuda_f32("weights", w)
    n, d = x.shape
    R = 1 if w is None else w.shape[0]
    out = torch.zeros(R, d * nbins, dtype=torch.float32, device=x.device)
    if R == 0 or n == 0:
        return out.reshape(R, d, nbins)
    geo = hist_geometry(R, n, d, nbins, w is None)
    lo_t, hi_t = to_card(lo, x.device), to_card(hi, x.device)
    weighted_histogram.launches += 1
    _build.launch("weighted_hist", R, n, d, nbins, x.data_ptr(),
                  None if w is None else w.data_ptr(), lo_t.data_ptr(),
                  hi_t.data_ptr(), geo.dc, geo.rows, geo.groups, geo.ranges,
                  geo.copies, int(geo.whole_bins), out.data_ptr(),
                  stream_ptr(x.device))
    return out.reshape(R, d, nbins)


def weighted_histogram(values: torch.Tensor, weights, lo, hi,
                       nbins: int) -> torch.Tensor:
    """values (n, d) or (n,), weights None (all ones), (n,) or (R, n),
    lo/hi scalar or (d,) -> (d, nbins), or (R, d, nbins) for (R, n)
    weights.

    Out-of-range values clip to the edge bins; NaN carries no mass.  On
    the card, kernel 10: counts of whole-number weights are bitwise the
    plain version's (below 2^24 a bin), and an (R, n) call is bitwise R
    one-row calls; fractional weights agree within 1e-6·Σ|w| a bin."""
    if not isinstance(values, torch.Tensor):
        raise TypeError("weighted_histogram takes torch.Tensors; the device "
                        "of the values picks the kernel or the plain "
                        "version")
    x = values if values.ndim == 2 else values.reshape(values.shape[0], -1)
    x = x.to(torch.float32).contiguous()
    n, d = x.shape
    w = None
    if weights is not None:
        w = weights.to(torch.float32)
        if w.shape[-1] != n or w.ndim not in (1, 2):
            raise ValueError(f"weights {tuple(w.shape)} do not match "
                             f"values {tuple(x.shape)}: expected (n,) or "
                             "(R, n)")
        w = (w[None] if w.ndim == 1 else w).contiguous()
    card = x.device if x.device.type == "cuda" else None
    lo_v, hi_v = range_vector(lo, d, card), range_vector(hi, d, card)
    if x.device.type == "cuda":
        counts = weighted_hist_cuda(x, w, lo_v, hi_v, int(nbins))
    else:
        counts = weighted_hist_plain(x, w, lo_v.cpu(), hi_v.cpu(),
                                     int(nbins))
    return counts if weights is not None and weights.ndim == 2 else counts[0]


weighted_histogram.launches = 0


def hist_plain(pr: Prepared, seed: int, lo: torch.Tensor, hi: torch.Tensor,
               nbins: int) -> torch.Tensor:
    """Plain version: (Bp, d, nbins), a chunk of tiles a scatter (the tiles'
    adds in the same order as one scatter a tile)."""
    counts = torch.zeros(pr.Bp, pr.d * nbins, device=pr.device)
    chunk_scan(pr, seed, lambda w, x: hist_tile_update(counts, x, w, lo, hi,
                                                       nbins))
    return counts.reshape(pr.Bp, pr.d, nbins)


def grouped_hist_plain(pr: Prepared, seed: int, lo: torch.Tensor,
                       hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """Plain keyed version, the JAX package's ``_grouped_fused_hist_scan``:
    (Bp, G, d, nbins), slot g the same scatter under w · (key == g)."""
    width = pr.d * nbins
    counts = torch.zeros(pr.Bp, pr.G * width, device=pr.device)

    def consume(w, x, keys):
        flat, fm = tile_bins(x, lo, hi, nbins)
        for g, m in enumerate(key_masks(pr, keys)):
            scatter_tile(counts, flat + g * width, fm, w * m[None, :])

    chunk_scan(pr, seed, consume)
    return counts.reshape(pr.Bp, pr.G, pr.d, nbins)


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
    rows = pass_hist_rows(tpc, 1, pr.d, total)
    out = torch.zeros(pr.Bp, total, dtype=torch.float32, device=pr.device)
    fused_poisson_hist.launches += 1
    _build.launch("fused_pass", int(seed), pr.n_valid, pr.Bp, pr.np_, pr.bb,
                  pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr), rows, tpc,
                  ranges, *(None,) * 6, 1, meta.data_ptr(), lo_t.data_ptr(),
                  hi_t.data_ptr(), total, out.data_ptr(),
                  stream_ptr(pr.device))
    return out.reshape(pr.Bp, pr.d, nbins)


def grouped_hist_cuda(pr: Prepared, seed: int, lo: torch.Tensor,
                      hi: torch.Tensor, nbins: int) -> torch.Tensor:
    """The keyed histogram pass (csrc/fused_grouped.cu) over a prepared
    keyed call: (Bp, G, d, nbins) on the card, at keyed_hist_geometry's
    geometry (it raises, naming block_bins, once one key's d·nbins bins a
    row do not fit in an SM)."""
    check_cuda_f32("values", pr.xp)
    check_cuda_f32("group_ids", pr.gp)
    geo = keyed_hist_geometry(pr.Bp, pr.np_, pr.bn, pr.G, pr.d, nbins)
    lo_t, hi_t = to_card(lo, pr.device), to_card(hi, pr.device)
    out = torch.zeros(pr.Bp, pr.G * pr.d * nbins, dtype=torch.float32,
                      device=pr.device)
    index = torch.empty(geo.index_ints(pr.np_), dtype=torch.int32,
                        device=pr.device)
    grouped_hist_cuda.launches += 1
    _build.launch("fused_grouped", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, pr.G, pr.xp.data_ptr(), mask_ptr(pr),
                  pr.gp.data_ptr(), 0, geo.kg, geo.rows, geo.tiles_per_cta,
                  geo.ranges, *(None,) * 6, nbins, lo_t.data_ptr(),
                  hi_t.data_ptr(), out.data_ptr(), index.data_ptr(),
                  stream_ptr(pr.device))
    return out.reshape(pr.Bp, pr.G, pr.d, nbins)


grouped_hist_cuda.launches = 0


def binblocked_cuda(pr: Prepared, seed: int, lo: torch.Tensor,
                    hi: torch.Tensor, nbins: int,
                    block_bins: int) -> torch.Tensor:
    """Kernel 7 (csrc/fused_binblocked.cu) over a prepared call, keyed or
    not: (Bp, d, nbins), or (Bp, G, d, nbins) with keys, on the card."""
    check_cuda_f32("values", pr.xp)
    G = 1 if pr.gp is None else pr.G
    if pr.gp is not None:
        check_cuda_f32("group_ids", pr.gp)
    total = G * pr.d * nbins
    geo = binblocked_geometry(pr.Bp, pr.np_, pr.bn, total, block_bins)
    # one dimension a row, so a window's values are read coalesced, on a
    # 16-byte boundary for the kernel's 16-byte loads
    xt = pr.xp.t().contiguous()
    if xt.data_ptr() % 16:
        xt = xt.clone()
    lo_t, hi_t = to_card(lo, pr.device), to_card(hi, pr.device)
    # one range stores every bin; more ranges add into zeros
    make = torch.empty if geo.ranges == 1 else torch.zeros
    out = make(pr.Bp, total, dtype=torch.float32, device=pr.device)
    binblocked_cuda.launches += 1
    _build.launch("fused_binblocked", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, G, xt.data_ptr(), mask_ptr(pr),
                  None if pr.gp is None else pr.gp.data_ptr(), nbins,
                  lo_t.data_ptr(), hi_t.data_ptr(), geo.width, geo.rows,
                  geo.tiles_per_cta, geo.cluster, geo.ranges,
                  out.data_ptr(), stream_ptr(pr.device))
    shape = (pr.Bp, pr.d, nbins) if pr.gp is None else (pr.Bp, G, pr.d,
                                                         nbins)
    return out.reshape(shape)


binblocked_cuda.launches = 0


def range_vector(v, d: int, device=None) -> torch.Tensor:
    """A scalar or (d,) bin edge as a (d,) f32 tensor, on the device of
    ``v`` when it is a tensor; a Python scalar is filled in on ``device``
    (no host copy to wait for), else on the host."""
    t = torch.as_tensor(v, dtype=torch.float32)
    if device is not None and not isinstance(v, torch.Tensor) and t.ndim == 0:
        return torch.full((d,), float(t), dtype=torch.float32, device=device)
    return t.expand(d).contiguous()


def fused_poisson_hist(seed: int, values: torch.Tensor, lo, hi, nbins: int,
                       B: int, n_valid=None, valid_mask=None, block_bins=None,
                       group_ids=None, num_groups=None) -> torch.Tensor:
    """values (n, d) or (n,), lo/hi scalar or (d,) -> (B, d, nbins) f32.

    ``n_valid``, ``valid_mask`` and ``group_ids`` act as in
    ``fused_poisson_moments``; keyed counts are (B, G, d, nbins), slot g
    bitwise the call under ``valid_mask = valid · (group_ids == g)``.

    ``block_bins`` tiles the flat bin axis of a row ((G·)d·nbins) into
    windows of at most that many bins: on the card it runs the
    output-tiled kernel 7, which draws each weight of a block of rows once
    into shared memory and then keeps one window of their bins there at a
    time, the knob for a sketch whose row does not fit in an SM.  It
    changes no count.  As in the JAX package's scan lowering, a CPU tensor
    ignores it."""
    pr = prepare(values, B, n_valid, valid_mask, group_ids, num_groups)
    card = pr.device if pr.device.type == "cuda" else None
    lo_v, hi_v = range_vector(lo, pr.d, card), range_vector(hi, pr.d, card)
    nbins = int(nbins)
    if pr.device.type == "cuda" and block_bins is not None:
        counts = binblocked_cuda(pr, seed, lo_v, hi_v, nbins,
                                 int(block_bins))
    elif pr.device.type == "cuda":
        run = grouped_hist_cuda if pr.gp is not None else hist_cuda
        counts = run(pr, seed, lo_v, hi_v, nbins)
    else:
        run = grouped_hist_plain if pr.gp is not None else hist_plain
        counts = run(pr, seed, lo_v.cpu(), hi_v.cpu(), nbins)
    return counts[:pr.B]


fused_poisson_hist.launches = 0
