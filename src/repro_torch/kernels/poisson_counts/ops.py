"""The (B, n) implicit Poisson(1) weight matrix.

On a CUDA device this launches the hand-written kernel
(csrc/poisson_counts.cu, replacing the TPU kernel
repro/kernels/poisson_counts/kernel.py: poisson_counts_kernel); on the CPU
it runs the plain version (ref.py), tile by tile.  Both give the weights
of the threefry lowering of the JAX package bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import _build
from repro_torch.kernels._pass import stream_ptr
from repro_torch.kernels.poisson_counts.ref import (poisson_weights_plain,
                                                    weight_block,
                                                    weight_tile_blocks)


def poisson_counts(seed: int, B: int, n: int, device=None) -> torch.Tensor:
    """(B, n) f32 Poisson(1) weights from an int32 seed."""
    dev = resolve_device(device)
    bb, bn = weight_tile_blocks(B, n)
    Bp = B + (-B) % bb
    np_ = n + (-n) % bn
    if dev.type == "cpu":
        out = poisson_weights_plain(int(seed), Bp, np_, bb, bn)
    else:
        out = torch.empty((Bp, np_), dtype=torch.float32, device=dev)
        poisson_counts.launches += 1
        _build.launch("poisson_counts", int(seed), Bp, np_, bb, bn, 0,
                      out.data_ptr(), stream_ptr(dev))
    return out[:B, :n]


poisson_counts.launches = 0


def poisson_tiles(seed: int, n_valid: int, Bp: int, bb: int, bn: int,
                  t0: int, t1: int, valid=None, device="cpu") -> torch.Tensor:
    """(Bp, (t1 - t0)·bn) f32 weights of n-tiles [t0, t1), columns at or
    past ``n_valid`` zeroed and multiplied by the matching slice ``valid``
    of a 0/1 mask: ``ref.weight_block``, whose plain version a CPU device
    runs.  On a CUDA device kernel 1 draws the tiles at their own keys
    (counted in ``poisson_counts.launches``) and the masking is the plain
    version's, so the block is bitwise the same."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return weight_block(int(seed), int(n_valid), Bp, bb, bn, t0, t1,
                            valid=valid, device=dev)
    w = torch.empty((Bp, (t1 - t0) * bn), dtype=torch.float32, device=dev)
    poisson_counts.launches += 1
    _build.launch("poisson_counts", int(seed), Bp, (t1 - t0) * bn, bb, bn,
                  int(t0), w.data_ptr(), stream_ptr(dev))
    col = torch.arange(t0 * bn, t1 * bn, device=dev)
    w = torch.where((col < n_valid)[None, :], w, 0.0)
    if valid is not None:
        w = w * valid[None, :]
    return w
