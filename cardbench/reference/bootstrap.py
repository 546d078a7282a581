"""A frozen copy of EARL's bootstrap arithmetic for a Mean, in NumPy: the
threefry-2x32 key derivation, the Poisson(1) weights drawn from it, and
the accuracy report, from their definitions (JAX's ``jax.random`` with
``jax_threefry_partitionable``, as the paper's system draws them).

* a key is two uint32 words; ``PRNGKey(s)`` is (0, s) for s < 2^31;
* ``fold_in(key, d)`` hashes the counter pair (0, d); ``split(key)``
  hashes (0, 0) and (0, 1);
* the bits of element c of a draw hash (c >> 32, c & 0xFFFFFFFF) and are
  the two output words xor-ed;
* a uniform in [0, 1) puts a draw's top 23 bits under the exponent of 1.0
  and subtracts 1;
* Poisson(1) is Knuth's ladder: step t splits the key, draws a uniform for
  every element and adds its log to the element's f32 running sum; the
  element's draw is the first step at which the sum is at most -1.
  A log may differ by an ulp between libraries, which moves a draw only
  when its sum lies within an ulp of -1;
* a session over values x grows its sample in extensions: extension s
  takes rows [n_{s-1}, n_s) with weights drawn from fold_in(fold_in(key,
  2), s - 1) of shape (B, n_s - n_{s-1}); resample b's mean is
  Σ w·x / Σ w over every row so far; the estimate is the rows' mean, and
  the report's c_v the resample means' standard deviation (ddof 1) over
  the absolute value of their mean.

``session_report`` follows a session from its inputs and the program's
sizes (B, each extension's n); ``precision`` computes its sums in a
narrower type, for the control.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(key: np.ndarray, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 arrays (adds wrap)."""
    with np.errstate(over="ignore"):
        return _threefry(key, x0, x1)


def _threefry(key, x0, x1):
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(_PARITY)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(step + 1) % 3]
        x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    if not 0 <= seed < 2 ** 31:
        raise ValueError(f"a session key's seed is in [0, 2^31): {seed}")
    return np.array([0, seed], np.uint32)


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.uint32(0), np.uint32(data & MASK32))
    return np.array([a, b], np.uint32)


def split(key: np.ndarray):
    a, b = threefry2x32(key, np.zeros(2, np.uint32),
                        np.arange(2, dtype=np.uint32))
    return np.array([a[0], b[0]], np.uint32), np.array([a[1], b[1]],
                                                       np.uint32)


def bits_at(key: np.ndarray, counters: np.ndarray) -> np.ndarray:
    c = counters.astype(np.uint64)
    a, b = threefry2x32(key, (c >> np.uint64(32)).astype(np.uint32),
                        (c & np.uint64(MASK32)).astype(np.uint32))
    return a ^ b


def unit_floats(bits: np.ndarray) -> np.ndarray:
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def poisson1(key: np.ndarray, shape: Sequence[int]) -> np.ndarray:
    """Poisson(1) draws of ``shape`` (int32)."""
    size = int(np.prod(shape))
    out = np.zeros(size, np.int32)
    live = np.arange(size, dtype=np.uint64)
    acc = np.zeros(size, np.float32)
    rng, t = key, 0
    with np.errstate(divide="ignore"):
        while live.size:
            rng, sub = split(rng)
            acc = acc + np.log(unit_floats(bits_at(sub, live)))
            done = ~(acc > np.float32(-1.0))
            out[live[done].astype(np.int64)] = t
            live, acc = live[~done], acc[~done]
            t += 1
    return out.reshape(tuple(shape))


def _rounded(a, precision):
    if precision is None:
        return np.asarray(a, np.float64)
    import torch
    return torch.as_tensor(np.asarray(a, np.float32)).to(precision).to(
        torch.float64).numpy()


def session_report(values: np.ndarray, key_seed: int, B: int,
                   ns: Sequence[int], precision=None) -> Dict[str, float]:
    """The estimate and c_v a Mean session reports over ``values`` (its
    rows in sample order), resampled ``B`` times, grown through the
    sample sizes ``ns``.  Sums in float64, or with ``precision`` (a torch
    dtype) every input and sum rounded to it."""
    x = _rounded(values, precision)
    pd_key = fold_in(prng_key(key_seed), 2)
    s1, s0, lo = np.zeros(B), np.zeros(B), 0
    for step, n in enumerate(ns):
        w = poisson1(fold_in(pd_key, step), (B, n - lo)).astype(np.float64)
        s1 = _rounded(s1 + w @ x[lo:n], precision)
        s0 = _rounded(s0 + w.sum(axis=1), precision)
        lo = n
    thetas = _rounded(s1 / s0, precision)
    est = _rounded(_rounded(x[:lo].sum(), precision) / lo, precision)
    mean = thetas.mean()
    cv = thetas.std(ddof=1) / (abs(mean) + 1e-12) if B > 1 else 0.0
    return {"estimate": float(est), "cv": float(cv)}
