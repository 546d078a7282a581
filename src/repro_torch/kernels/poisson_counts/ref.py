"""The implicit Poisson(1) weight tile, in plain PyTorch.

This is the one RNG discipline every fused path shares.  The (B, n)
weight matrix is cut into (block_b, block_n) tiles; tile (i, k) draws its
bits from ``fold_in(fold_in(PRNGKey(seed), i), k)`` with the partitionable
threefry counter of each element's flat index *within the tile*, and each
weight is the number of Poisson(1) CDF rungs strictly below
``u = (bits >> 8) / 2^24``.  Columns at or past ``n_valid`` are 0, and an
optional exact 0/1 ``valid`` mask multiplies the tile afterwards.

``POISSON_CDF_F32`` is the single source of the ladder: the CUDA build
writes these same f32 values into a generated header (kernels/_build.py).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.random import MASK32, threefry2x32


def _poisson_cdf_f32() -> Tuple[float, ...]:
    acc, out = 0.0, []
    for k in range(10):
        acc += math.exp(-1.0) / math.factorial(k)
        out.append(float(np.float32(acc)))
    return tuple(out)


#: Poisson(1) CDF rungs P(K <= k), k = 0..9, rounded once to float32.
POISSON_CDF_F32 = _poisson_cdf_f32()

#: Elements of weight tensor generated per step of the plain versions
#: (bounds their int64 temporaries to a few hundred MB on any device).
CHUNK_ELEMS = 1 << 22


#: Largest RNG tile, (rows, columns): the JAX package's default blocks.
BLOCK_B, BLOCK_N = 128, 512


def weight_tile_blocks(B: int, n: int) -> Tuple[int, int]:
    """Clamped (bb, bn) RNG tile shape, bb in [8, 128], bn in [128, 512].
    Every fused path keys its weights through this clamp, which is what
    keeps them bitwise equal to one another (common random numbers); the
    CUDA pass relies on bb >= 8."""
    return min(BLOCK_B, max(8, B)), min(BLOCK_N, max(128, n))


def poisson_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64 tensor) -> f32 Poisson(1) counts by the ladder:
    the number of rungs strictly below u (``bucketize``)."""
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    rungs = torch.tensor(POISSON_CDF_F32, dtype=torch.float32,
                         device=bits.device)
    return torch.bucketize(u, rungs, out_int32=True).to(torch.float32)


def tile_keys(seed: int, b_tiles: torch.Tensor,
              n_tiles: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Keys ``fold_in(fold_in(PRNGKey(seed), i), k)`` for every pair of
    b-tile ``i`` and n-tile ``k``: two (len(i), len(k)) int64 tensors."""
    s = int(seed) & MASK32
    i0, i1 = threefry2x32(0, s, torch.zeros_like(b_tiles), b_tiles)
    return threefry2x32(i0[:, None], i1[:, None],
                        torch.zeros_like(n_tiles)[None, :], n_tiles[None, :])


def block_keys(seed: int, Bp: int, block_b: int, t0: int, t1: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """The tile keys of n-tiles [t0, t1) for every b-tile: two
    (Bp / block_b, t1 - t0) int64 tensors."""
    ki = torch.arange(Bp // block_b, dtype=torch.int64, device=device)
    kt = torch.arange(t0, t1, dtype=torch.int64, device=device)
    return tile_keys(seed, ki, kt)


def weight_block(seed: int, n_valid: int, Bp: int, block_b: int,
                 block_n: int, t0: int, t1: int,
                 valid: Optional[torch.Tensor] = None,
                 device="cpu", keys=None) -> torch.Tensor:
    """(Bp, (t1 - t0)·block_n) f32 implicit weights of n-tiles [t0, t1).

    ``valid`` is the matching (t1 - t0)·block_n slice of the 0/1 mask;
    ``keys``, the tiles' ``block_keys`` when the caller holds them (a scan
    derives every tile's key once, not a few hundred small operations a
    chunk)."""
    T = t1 - t0
    k0, k1 = (block_keys(seed, Bp, block_b, t0, t1, device) if keys is None
              else keys)                                      # (nb_b, T)
    ctr = torch.arange(block_b * block_n, dtype=torch.int64,
                       device=device).reshape(block_b, block_n)
    o0, o1 = threefry2x32(k0[:, :, None, None], k1[:, :, None, None],
                          0, ctr[None, None])
    w = poisson_from_bits(o0 ^ o1)                   # (nb_b, T, bb, bn)
    w = w.permute(0, 2, 1, 3).reshape(Bp, T * block_n)
    col = torch.arange(t0 * block_n, t1 * block_n, device=device)
    w = torch.where((col < n_valid)[None, :], w, 0.0)
    if valid is not None:
        w = w * valid[None, :]
    return w


def tiles_per_chunk(Bp: int, block_n: int) -> int:
    return max(1, CHUNK_ELEMS // (Bp * block_n))


def poisson_weights_plain(seed: int, Bp: int, np_: int, block_b: int,
                          block_n: int, device="cpu") -> torch.Tensor:
    """The whole padded (Bp, np_) implicit weight matrix, tile by tile."""
    nt = np_ // block_n
    step = tiles_per_chunk(Bp, block_n)
    k0, k1 = block_keys(seed, Bp, block_b, 0, nt, device)
    return torch.cat([weight_block(seed, np_, Bp, block_b, block_n, t,
                                   min(nt, t + step), device=device,
                                   keys=(k0[:, t:t + step],
                                         k1[:, t:t + step]))
                      for t in range(0, nt, step)], dim=1)
