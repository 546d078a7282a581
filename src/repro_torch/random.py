"""Threefry-2x32 key derivation and random bits in torch integer ops.

Bitwise equal to ``jax.random`` with ``jax_threefry_partitionable=True``
(the default of the JAX versions this port is held against):

* ``PRNGKey(seed)`` is the pair ``(seed >> 32, seed & 0xFFFFFFFF)``;
* ``fold_in(key, data)`` hashes the counter pair ``(0, data)``;
* ``split(key, num)`` hashes ``(0, j)`` for ``j < num`` (fold-in-like split);
* ``bits(key, shape)`` hashes ``(hi, lo)`` of each element's flat row-major
  index and returns ``bits1 ^ bits2``;
* ``randint`` is JAX's two-draw modulus construction, with its uint32
  wrap-around reproduced;
* ``uniform`` (f32) puts 23 random mantissa bits under the exponent of 1.0
  and subtracts 1.0;
* ``poisson`` for λ < 10 is Knuth's ladder as jax 0.9 runs it: iteration t
  splits the key, draws a uniform over the whole shape and adds its log to
  a running f32 sum; an entry's draw is the number of iterations it took
  for the sum to reach −λ, minus one.  The log is the one place where
  the packages may differ: XLA's and torch's f32 ``log`` (and CUDA's
  ``logf``) can differ by an ulp, which flips an entry only when its sum
  lies within an ulp of −λ.

A key is an int64 tensor of shape (2,) holding two uint32 words, kept on
the CPU: keys are host-side control state, only bit tensors are large.
The draws (``bits``, ``uniform``, ``poisson``, ``randint``,
``permutation``) land where ``jax.random`` puts them, on the default
device: ``device=None`` means the card, and the host takes
``device="cpu"``.
Every uint32 quantity here lives in an int64 tensor masked to 32 bits,
because torch's shifts and adds are not defined on its uint32 dtype.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.device import resolve_device

MASK32 = 0xFFFFFFFF
#: Elements hashed at once by ``poisson`` and ``randint``: bounds their
#: int64 threefry temporaries (about ten of 8 bytes an element).
BLOCK = 1 << 24
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


def bits_at(key, counters: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (as int64) of the draw ``bits`` would make, at
    the flat row-major positions ``counters`` (int64, on their device)."""
    k = key_data(key).to(counters.device)
    o0, o1 = threefry2x32(k[0], k[1], counters >> 32, counters & MASK32)
    return o0 ^ o1


def bits(key, shape: Sequence[int], device=None) -> torch.Tensor:
    """uint32 random bits (as int64) of ``shape``: element with flat index
    c hashes (c >> 32, c & 0xFFFFFFFF) and returns bits1 ^ bits2."""
    c = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=resolve_device(device))
    return bits_at(key, c).reshape(tuple(shape))


def _unit_floats(b: torch.Tensor) -> torch.Tensor:
    """f32 in [0, 1) from uint32 bits: the top 23 bits as the mantissa of
    a float in [1, 2), minus 1 (exact)."""
    f = ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """f32 uniform on [minval, maxval), bitwise ``jax.random.uniform``."""
    device = resolve_device(device)
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    span = torch.tensor(maxval, dtype=torch.float32, device=device) - lo
    f = _unit_floats(bits(key, shape, device))
    return torch.maximum(lo, f * span + lo)


def poisson(key, lam: float, shape: Sequence[int], dtype=torch.int32,
            device=None) -> torch.Tensor:
    """Poisson(``lam``) draws of ``shape``, ``jax.random.poisson``'s
    Knuth ladder for 0 <= lam < 10 (module docstring).

    An entry's draw depends only on the uniforms at its own position, so
    the shape is drawn in blocks of ``BLOCK`` entries, and within a block
    an iteration hashes only the entries whose sum is still above −λ: the
    same values as hashing the whole shape every iteration, for about two
    hashes an entry at λ = 1 instead of the ladder's length.  ``dtype``
    may be a float type (the draws are small whole numbers), which spares
    an integer copy of a large draw."""
    lam = float(lam)
    if not 0.0 <= lam < 10.0:
        raise NotImplementedError("poisson for lam >= 10 (JAX's rejection "
                                  "sampler) is not ported")
    device = resolve_device(device)
    size = math.prod(shape)
    out = torch.zeros(size, dtype=dtype, device=device)
    if lam == 0.0:
        return out.reshape(tuple(shape))
    neg_lam = torch.tensor(-lam, dtype=torch.float32, device=device)
    rng, subkeys = key_data(key), []
    for start in range(0, size, BLOCK):
        live = torch.arange(start, min(size, start + BLOCK),
                            dtype=torch.int64, device=device)
        log_prod = torch.zeros(live.shape, dtype=torch.float32,
                               device=device)
        t = 0
        while live.numel():
            if t == len(subkeys):
                rng, sub = split(rng)
                subkeys.append(sub)
            # uniform(...) is max(0, f) of these floats; f >= +0 already
            log_prod = log_prod + torch.log(
                _unit_floats(bits_at(subkeys[t], live)))
            done = ~(log_prod > neg_lam)
            out[live[done]] = t
            live, log_prod = live[~done], log_prod[~done]
            t += 1
    return out.reshape(tuple(shape))


def permutation(key, n: int, device=None) -> torch.Tensor:
    """A random permutation of [0, n), bitwise ``jax.random.permutation``:
    ceil(3·ln n / ln(2^32 − 1)) rounds, each splitting the key and stably
    sorting by fresh 32-bit bits of the subkey."""
    device = resolve_device(device)
    x = torch.arange(int(n), dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, int(n)))
                         / np.log(np.iinfo(np.uint32).max)))
    k = key_data(key)
    for _ in range(rounds):
        k, sub = split(k)
        order = torch.sort(bits(sub, (int(n),), device),
                           stable=True).indices
        x = x[order]
    return x


def randint(key, shape: Sequence[int], minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 values in [minval, maxval), bitwise ``jax.random.randint``
    (int32 dtype): two bit draws from ``split(key)`` combined modulo the
    span with JAX's uint32 wrap-around arithmetic; hashed in blocks of
    ``BLOCK`` entries."""
    imin, imax = -(1 << 31), (1 << 31) - 1
    out_of_range = maxval > imax
    lo_v = min(max(int(minval), imin), imax)
    hi_v = min(max(int(maxval), imin), imax)
    k1, k2 = split(key)
    span = (hi_v - lo_v) & MASK32
    if hi_v <= lo_v:
        span = 1
    if out_of_range and hi_v > lo_v:
        span = (span + 1) & MASK32
    size = math.prod(shape)
    device = resolve_device(device)
    out = torch.empty(size, dtype=torch.int32, device=device)
    for start in range(0, size, BLOCK):
        c = torch.arange(start, min(size, start + BLOCK), dtype=torch.int64,
                         device=device)
        higher = bits_at(k1, c)
        lower = bits_at(k2, c)
        if span == 0:           # wrapped: remainders have no effect
            offset = lower
        else:
            mult = (1 << 16) % span
            mult = ((mult * mult) & MASK32) % span
            offset = ((((higher % span) * mult) & MASK32)
                      + (lower % span)) & MASK32
            offset = offset % span
        val = (lo_v + offset) & MASK32
        val = torch.where(val >= (1 << 31), val - (1 << 32), val)
        out[start:start + c.numel()] = val.to(torch.int32)
    return out.reshape(tuple(shape))
