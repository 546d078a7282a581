"""Threefry-2x32 key derivation and random bits in torch integer ops.

Bitwise equal to ``jax.random`` with ``jax_threefry_partitionable=True``
(the default of the JAX versions this port is held against):

* ``PRNGKey(seed)`` is the pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``split(key, num)`` hashes ``(0, j)`` for ``j < num`` (fold-in-like split);
* ``bits(key, shape)`` hashes ``(hi, lo)`` of each element's flat row-major
  index and returns ``bits1 ^ bits2``;
* ``randint`` is JAX's two-draw modulus construction, with its uint32
  wrap-around reproduced.

A key is an int64 tensor of shape (2,) holding two uint32 words, kept on
the CPU: keys are host-side control state, only bit tensors are large.
Every uint32 quantity here lives in an int64 tensor masked to 32 bits,
because torch's shifts and adds are not defined on its uint32 dtype.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: IntLike, k1: IntLike, x0: IntLike,
                 x1: IntLike) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) over broadcastable uint32-valued operands.

    Operands are Python ints or int64 tensors holding values in
    [0, 2^32); the result is a pair of int64 tensors in the same range.
    Same round and key-injection schedule as ``jax._src.prng``'s
    unrolled lowering."""
    def t(v):
        return v if isinstance(v, torch.Tensor) else torch.tensor(
            v, dtype=torch.int64)
    k0, k1, x0, x1 = t(k0), t(k1), t(x0), t(x1)
    ks = (k0, k1, (k0 ^ k1 ^ _KS_PARITY) & MASK32)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(step + 1) % 3]) & MASK32
        x1 = (x1 + ks[(step + 2) % 3] + (step + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """The raw threefry key of an integer seed (as ``jax.random.PRNGKey``
    with 64-bit-off semantics: 32-bit seeds give ``(0, seed)``)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise ValueError(f"seed must fit int32, got {seed}")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64)


def key_data(key) -> torch.Tensor:
    """Normalise a key given as a tensor, numpy array or pair of ints."""
    if isinstance(key, torch.Tensor):
        k = key.to(device="cpu", dtype=torch.int64)
    else:
        k = torch.as_tensor(np.asarray(key, dtype=np.uint32).astype(
            np.int64))
    if k.shape != (2,):
        raise ValueError(f"a PRNG key is two uint32 words, got {k.shape}")
    return k & MASK32


def fold_in(key, data: int) -> torch.Tensor:
    k = key_data(key)
    o0, o1 = threefry2x32(k[0], k[1], 0, int(data) & MASK32)
    return torch.stack([o0, o1])


def split(key, num: int = 2) -> torch.Tensor:
    """(num, 2) keys: key j is the hash of counter pair (0, j)."""
    k = key_data(key)
    j = torch.arange(num, dtype=torch.int64)
    o0, o1 = threefry2x32(k[0], k[1], torch.zeros_like(j), j)
    return torch.stack([o0, o1], dim=1)


def bits(key, shape: Sequence[int], device="cpu") -> torch.Tensor:
    """uint32 random bits (as int64) of ``shape``: element with flat index
    c hashes (c >> 32, c & 0xFFFFFFFF) and returns bits1 ^ bits2."""
    k = key_data(key).to(device)
    size = math.prod(shape)
    c = torch.arange(size, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(k[0], k[1], c >> 32, c & MASK32)
    return (o0 ^ o1).reshape(tuple(shape))


def randint(key, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """int32 values in [minval, maxval), bitwise ``jax.random.randint``
    (int32 dtype): two bit draws from ``split(key)`` combined modulo the
    span with JAX's uint32 wrap-around arithmetic."""
    imin, imax = -(1 << 31), (1 << 31) - 1
    out_of_range = maxval > imax
    lo_v = min(max(int(minval), imin), imax)
    hi_v = min(max(int(maxval), imin), imax)
    k1, k2 = split(key)
    higher = bits(k1, shape)
    lower = bits(k2, shape)
    span = (hi_v - lo_v) & MASK32
    if hi_v <= lo_v:
        span = 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & MASK32
    if span == 0:           # wrapped: remainders have no effect
        offset = (higher * 0 + lower) & MASK32
    else:
        mult = (1 << 16) % span
        mult = ((mult * mult) & MASK32) % span
        offset = ((((higher % span) * mult) & MASK32)
                  + (lower % span)) & MASK32
        offset = offset % span
    val = (lo_v + offset) & MASK32
    val = torch.where(val >= (1 << 31), val - (1 << 32), val)
    return val.to(torch.int32)
