"""Matrix-free bootstrap moments, and the tile scan every fused path shares.

``fused_poisson_moments`` gives, for B resamples under implicit Poisson(1)
weights W (never stored), w_tot = ΣW (B,), s1 = W·X and s2 = W·X² (B, d).
Dispatch is on the device of ``values``: a CUDA tensor launches the
hand-written kernel (csrc/fused_pass.cu without histograms, replacing
the TPU kernel repro/kernels/weighted_stats/kernel.py:
fused_poisson_moments_kernel) or raises; a CPU tensor runs the plain
version, the JAX package's scan lowering tile by tile in the same tile
order.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import (MAX_ROWS, check_cuda_f32,
                                       pass_geometry, stream_ptr)
from repro_torch.kernels.poisson_counts.ops import poisson_counts
from repro_torch.kernels.poisson_counts.ref import (tiles_per_chunk,
                                                    weight_block,
                                                    weight_tile_blocks)


def _pad_to(x: torch.Tensor, mult: int, axis: int,
            value: float = 0.0) -> torch.Tensor:
    """Pad ``axis`` with ``value`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, value, dtype=x.dtype,
                                     device=x.device)], dim=axis)


def implicit_weight_tile(seed: int, n_valid: int, t: int, B: int,
                         block_b: int, block_n: int,
                         valid: Optional[torch.Tensor] = None,
                         device="cpu") -> torch.Tensor:
    """The (B, block_n) weight tile at n-tile ``t`` (B a block_b multiple)."""
    return weight_block(int(seed), int(n_valid), B, block_b, block_n, t,
                        t + 1, valid=valid, device=device)


def implicit_weights(seed: int, B: int, n: int, device=None) -> torch.Tensor:
    """The (B, n) weight matrix the fused paths use implicitly."""
    return poisson_counts(seed, B, n, device=device)


class Prepared:
    """A fused call's arguments, padded to whole RNG tiles."""

    def __init__(self, values: torch.Tensor, B: int, n_valid, valid_mask):
        x = values if values.ndim == 2 else values.reshape(values.shape[0],
                                                           -1)
        self.n, self.d = x.shape
        self.bb, self.bn = weight_tile_blocks(B, self.n)
        self.B = B
        self.Bp = B + (-B) % self.bb
        self.n_valid = self.n if n_valid is None else int(n_valid)
        self.xp = _pad_to(x.to(torch.float32), self.bn, 0).contiguous()
        self.np_ = self.xp.shape[0]
        self.mp = None
        if valid_mask is not None:
            m = torch.as_tensor(valid_mask).to(device=x.device,
                                               dtype=torch.float32)
            self.mp = _pad_to(m.reshape(self.n), self.bn, 0).contiguous()
        self.device = x.device


def prepare(values: torch.Tensor, B: int, n_valid=None,
            valid_mask=None) -> Prepared:
    if not isinstance(values, torch.Tensor):
        raise TypeError("fused ops take a torch.Tensor; its device picks "
                        "the kernel (cuda) or the plain version (cpu)")
    if values.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {values.device}")
    return Prepared(values, int(B), n_valid, valid_mask)


def tile_scan(pr: Prepared, seed: int,
              consume: Callable[[torch.Tensor, torch.Tensor], None]) -> None:
    """The scan lowering: every (Bp, bn) weight tile in n order,
    handed to ``consume(w_tile, x_tile)`` with its (bn, d) x tile.
    Weights are drawn a chunk of tiles at a time."""
    nt = pr.np_ // pr.bn
    step = tiles_per_chunk(pr.Bp, pr.bn)
    for c0 in range(0, nt, step):
        c1 = min(nt, c0 + step)
        valid = None if pr.mp is None else pr.mp[c0 * pr.bn:c1 * pr.bn]
        w = weight_block(int(seed), pr.n_valid, pr.Bp, pr.bb, pr.bn, c0, c1,
                         valid=valid, device=pr.device)
        for t in range(c0, c1):
            lo = (t - c0) * pr.bn
            consume(w[:, lo:lo + pr.bn], pr.xp[t * pr.bn:(t + 1) * pr.bn])


def moments_plain(pr: Prepared, seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: (w_tot (Bp,), s1 (Bp, d), s2 (Bp, d)).

    Each tile's sums are f32, as in the JAX package's scan; the running
    sums across tiles are float64, rounded to f32 once at the end.  So
    w_tot is the exact total of the integer weights, bitwise the kernel's
    at any n, and s1/s2 carry no error that grows with the tile count.
    (The JAX package's f32 running sums give the same w_tot while it stays
    below 2^24, and round at every tile past that.)"""
    acc = [torch.zeros(pr.Bp, dtype=torch.float64, device=pr.device),
           torch.zeros(pr.Bp, pr.d, dtype=torch.float64, device=pr.device),
           torch.zeros(pr.Bp, pr.d, dtype=torch.float64, device=pr.device)]

    def consume(w, xt):
        acc[0] = acc[0] + w.sum(dim=1)
        acc[1] = acc[1] + w @ xt
        acc[2] = acc[2] + w @ (xt * xt)

    tile_scan(pr, seed, consume)
    return tuple(a.float() for a in acc)


def moment_buffers(pr: Prepared, ranges: int):
    """Partials and outputs of a moments pass, allocated on the card."""
    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=pr.device)
    return (e(pr.Bp, ranges), e(pr.Bp, ranges, pr.d),
            e(pr.Bp, ranges, pr.d), e(pr.Bp), e(pr.Bp, pr.d),
            e(pr.Bp, pr.d))


def mask_ptr(pr: Prepared) -> Optional[int]:
    if pr.mp is None:
        return None
    check_cuda_f32("valid_mask", pr.mp)
    return pr.mp.data_ptr()


def moments_cuda(pr: Prepared, seed: int):
    check_cuda_f32("values", pr.xp)
    tpc, ranges = pass_geometry(pr.Bp, pr.np_, pr.bn)
    bufs = moment_buffers(pr, ranges)
    fused_poisson_moments.launches += 1
    _build.launch("fused_pass", int(seed), pr.n_valid, pr.Bp, pr.np_,
                  pr.bb, pr.bn, pr.d, pr.xp.data_ptr(), mask_ptr(pr),
                  MAX_ROWS, tpc, ranges, *[b.data_ptr() for b in bufs],
                  0, None, None, None, 0, None, stream_ptr(pr.device))
    return bufs[3], bufs[4], bufs[5]


def fused_poisson_moments(seed: int, values: torch.Tensor, B: int,
                          n_valid=None, valid_mask=None):
    """values (n, d) or (n,) -> (w_tot (B,), s1 (B, d), s2 (B, d)).

    ``n_valid`` zeroes weight columns >= n_valid; ``valid_mask`` ((n,)
    exact 0/1) multiplies the weights after that, so a prefix-shaped mask
    reproduces ``n_valid`` bit for bit."""
    pr = prepare(values, B, n_valid, valid_mask)
    if pr.device.type == "cuda":
        w_tot, s1, s2 = moments_cuda(pr, seed)
    else:
        w_tot, s1, s2 = moments_plain(pr, seed)
    return w_tot[:pr.B], s1[:pr.B], s2[:pr.B]


fused_poisson_moments.launches = 0
