"""Launch geometry and argument checks shared by the fused kernels' wrappers.

The column ranges of a pass (``pass_geometry``) are a function of the
shapes alone, never of the card: the moments' fixed accumulation order
depends on them, and with them repeated runs and the dedicated-versus-group
runs are bitwise equal.
"""
from __future__ import annotations

from typing import Tuple

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


def hist_rows(hist_total: int, tiles_per_cta: int) -> int:
    """Rows of W per CTA whose bins fit in shared memory beside the keys."""
    free = SMEM_BYTES - 16 * tiles_per_cta - 64
    rows = min(MAX_ROWS, free // (4 * hist_total))
    if rows < 1:
        raise NotImplementedError(
            f"a histogram pass needs {hist_total} floats (d·nbins, times G "
            "when keyed) of shared memory per row of W, more than a Hopper "
            "SM holds; the output-tiled (block_bins) kernel is not ported "
            "yet")
    return int(rows)


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
