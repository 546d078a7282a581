"""Launch geometry and argument checks shared by the fused kernels' wrappers.

The column ranges of a pass (``pass_geometry``) are a function of the
shapes alone, never of the card: the moments' fixed accumulation order
depends on them, and with them repeated runs and the dedicated-versus-group
runs are bitwise equal.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

#: CTAs a pass aims for: 8 per SM of a 132-SM H100.  A constant, so the
#: ranges (and with them the moments' summation order) never follow the
#: card a run lands on.
TARGET_CTAS = 1056
#: Longest column range in RNG tiles (bounds the CTA's shared key table).
MAX_TILES_PER_CTA = 1024
#: Rows of W per CTA (kMaxRows in csrc/moments_tile.cuh).
MAX_ROWS = 8
#: Shared memory a CTA may use on Hopper, in bytes.
SMEM_BYTES = 232448
#: f32 accumulators a thread of the grouped moments kernel keeps in
#: registers (kGroupedAccs in csrc/fused_grouped.cu).
GROUPED_ACCS = 128
#: (dims, largest key chunk) of its instances: a CTA sums DC columns of x
#: (1, 2 or 4) for KG keys (a power of two up to KEY_CHUNKS[DC]).
KEY_CHUNKS = {1: 32, 2: 16, 4: 8}


def pass_geometry(Bp: int, np_: int, bn: int) -> Tuple[int, int]:
    """(tiles_per_cta, ranges) of a pass over a (Bp, np_) implicit W cut
    into RNG tiles bn columns wide."""
    nt = np_ // bn
    rowblocks = -(-Bp // MAX_ROWS)
    ranges = min(nt, max(-(-TARGET_CTAS // rowblocks),
                         -(-nt // MAX_TILES_PER_CTA)))
    tpc = -(-nt // ranges)
    return tpc, -(-nt // tpc)


def explicit_geometry(R: int, n: int, rows: int) -> Tuple[int, int]:
    """(cols, ranges) of a pass over an explicit (R, n) weight matrix,
    ``rows`` rows of it a CTA: about TARGET_CTAS CTAs, each over a range
    of ``cols`` columns, a whole number of warps wide."""
    rowblocks = -(-R // rows)
    ranges = max(1, min(-(-n // 256), -(-TARGET_CTAS // rowblocks)))
    cols = -(-n // ranges)
    cols += (-cols) % 32
    return cols, -(-n // cols)


def hist_rows(hist_total: int, tiles_per_cta: int) -> int:
    """Rows of W per CTA whose bins fit in shared memory beside the keys."""
    free = SMEM_BYTES - 16 * tiles_per_cta - 64
    rows = min(MAX_ROWS, free // (4 * hist_total))
    if rows < 1:
        raise NotImplementedError(
            f"a histogram pass needs {hist_total} floats (d·nbins, times G "
            "when keyed) of shared memory per row of W, more than a Hopper "
            "SM holds; pass block_bins= (a Quantile's or "
            "fused_poisson_hist's) to run the output-tiled kernel")
    return int(rows)


#: Rows of W a kernel 7 CTA keeps (kCacheRows in csrc/fused_binblocked.cu):
#: a 4-column group of them is one 16-byte word of its weight cache.
BINBLOCKED_ROWS = 4
#: Largest thread block cluster of kernel 7: an H100 keeps 66 clusters of
#: 2 CTAs (one an SM) resident, but only 30 of 4.
MAX_CLUSTER = 2
#: CTAs kernel 7 aims for: one an SM of a 132-SM H100, as its weight cache
#: fills an SM's shared memory at the streamed Quantile's shape.
BINBLOCKED_CTAS = 132
#: Static shared memory of a kernel 7 CTA (its cluster's mask flag, as
#: ptxas reports it), beside the dynamic part ``BinBlocked.smem_bytes``.
BINBLOCKED_STATIC_SMEM = 16


def _align16(v: int) -> int:
    return v + (-v) % 16


class BinBlocked(NamedTuple):
    """Launch geometry of kernel 7 (csrc/fused_binblocked.cu).

    Grid: x = ranges · cluster CTAs (a cluster of ``cluster`` CTAs for
    each column range), y = blocks of ``rows`` rows of W.  CTA ``rank`` of
    the cluster of range ``i`` draws the weights of its rows on RNG
    n-tiles ``tiles(i, rank, nt)`` once, into its shared weight cache;
    after a cluster barrier it walks windows ``windows_of(rank)`` over the
    cluster's columns, reading its peer's cache through distributed
    shared memory."""
    width: int           # bins a window
    rows: int            # rows of W a CTA
    tiles_per_cta: int   # RNG n-tiles whose weights a CTA caches
    cluster: int         # CTAs a cluster
    ranges: int          # column ranges, one cluster each
    windows: int         # windows a row

    def tiles(self, i: int, rank: int, nt: int) -> Tuple[int, int]:
        t0 = min((i * self.cluster + rank) * self.tiles_per_cta, nt)
        return t0, min(t0 + self.tiles_per_cta, nt)

    def windows_of(self, rank: int) -> range:
        return range(rank, self.windows, self.cluster)

    def smem_bytes(self, bn: int) -> int:
        """Bins, then the weight cache (a 16-byte word of 4 rows for every
        4 columns), then two tile keys an n-tile."""
        return (_align16(4 * self.rows * self.width)
                + 16 * -(-self.tiles_per_cta * bn // 4)
                + 16 * self.tiles_per_cta)


def binblocked_geometry(Bp: int, np_: int, bn: int, total: int,
                        block_bins: int) -> BinBlocked:
    """Geometry of an output-tiled histogram pass (kernel 7) over ``total``
    bins a row, for a (Bp, np_) implicit W cut into RNG tiles bn columns
    wide.

    A window is ``block_bins`` bins wide, cut to the row and to what fits
    beside one n-tile's cache; a CTA keeps up to BINBLOCKED_ROWS rows of
    it.  Each weight is drawn once, by the one CTA whose cache holds its
    column; the cache limits the columns a cluster covers, so the ranges
    are the fewest the largest cluster allows, and the cluster the
    smallest that reaches them.  Only a grid below one CTA an SM takes
    more ranges.  Every range adds one flush of the row's bins into the
    output."""
    nt = np_ // bn
    tile = 16 + 16 * -(-bn // 4)
    free = SMEM_BYTES - BINBLOCKED_STATIC_SMEM
    room = free - 16 - tile
    width = max(1, min(int(block_bins), total, room // 4))
    rows = min(BINBLOCKED_ROWS, room // (4 * width))
    tpc_max = (free - _align16(4 * rows * width)) // tile
    windows = -(-total // width)
    sizes = [c for c in range(1, MAX_CLUSTER + 1)
             if c == 1 or c <= min(windows, nt)]
    fewest = -(-nt // (sizes[-1] * tpc_max))
    cluster = next(c for c in sizes if -(-nt // (c * tpc_max)) == fewest)
    rowblocks = -(-Bp // rows)
    ranges = max(fewest, min(nt // cluster,
                             BINBLOCKED_CTAS // (rowblocks * cluster)))
    tpc = -(-nt // (ranges * cluster))
    return BinBlocked(width, rows, tpc, cluster,
                      -(-nt // (cluster * tpc)), windows)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, int(v) - 1).bit_length()


def grouped_geometry(G: int, d: int) -> Tuple[int, int, int, int]:
    """(dims DC, keys KG, rows, z chunks) of a grouped moments pass.

    A thread keeps rows · KG·(2·DC+1) accumulators (w, DC of s1 and DC
    of s2 per key and row), at most GROUPED_ACCS.  Rows shrink before
    anything is chunked: a weight is still drawn by exactly one CTA.  Only
    past d > 4 or KG·(2·DC+1) > 128 does grid z cover the rest in chunks
    of DC columns and KG keys, each paying the hash again."""
    dc = min(4, _pow2_at_least(d))
    kg = min(KEY_CHUNKS[dc], _pow2_at_least(G))
    rows = min(MAX_ROWS, GROUPED_ACCS // (kg * (2 * dc + 1)))
    chunks = -(-d // dc) * -(-G // kg)
    return dc, kg, rows, chunks


def check_cuda_f32(name: str, t: torch.Tensor) -> None:
    if not (t.is_cuda and t.dtype == torch.float32 and t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
