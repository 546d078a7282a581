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
        _build.launch("poisson_counts", int(seed), Bp, np_, bb, bn,
                      out.data_ptr(), stream_ptr(dev))
    return out[:B, :n]


poisson_counts.launches = 0
