"""Samplers over the sharded store (paper §3.3).

* ``PermutationSampler`` — a fixed pseudo-random permutation of [0, N);
  ``take(a, b)`` returns permutation rows [a, b), so growing samples are
  prefix extensions (uniform without replacement) and delta maintenance
  gets pure Δs rows.  The permutation is ``np.random.default_rng(seed)``,
  bitwise the JAX package's, so both packages see the same sample.
* ``PreMapSampler`` — the pre-map flavour: samples row indices first and
  reads only those rows (low load cost).
* ``PostMapSampler`` — the post-map flavour: reads the whole store once,
  hash-buckets its rows, then draws (exact key accounting, full load
  cost); the same rows as ``PreMapSampler``.
* ``StratifiedSampler`` — the permutation reordered by stride scheduling
  over an integer key column, so every prefix holds the keys in chosen
  shares (GROUP BY sessions); bitwise the JAX package's order.

``take`` returns a float tensor on the sampler's device (the card unless
``device="cpu"``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.data.store import ShardedStore
from repro_torch.device import resolve_device


class PermutationSampler:
    """Uniform without-replacement prefixes via a fixed permutation.

    ``mode="pre_map"`` reads row-granular (cheap); ``mode="post_map"``
    materializes the full store on first touch (exact counts, expensive);
    both give the same rows."""

    def __init__(self, store: ShardedStore, seed: int = 0,
                 mode: str = "pre_map", device=None):
        if mode not in ("pre_map", "post_map"):
            raise ValueError(mode)
        self.device = resolve_device(device)
        self.store = store
        self.mode = mode
        self.N = store.N
        self.perm = np.random.default_rng(seed).permutation(self.N)
        self._cache: Optional[np.ndarray] = None

    def _rows(self, rows: np.ndarray) -> np.ndarray:
        if self.mode == "post_map":
            if self._cache is None:
                self._cache = self.store.read_all()
            return self._cache[rows]
        # pre-map: group the requested rows by split, read row-granular
        split, local = self.store.locate(rows)
        order = np.argsort(split, kind="stable")
        out = np.empty((len(rows),) + self.store.splits[0].shape[1:],
                       dtype=self.store.splits[0].dtype)
        i = 0
        while i < len(order):
            j = i
            s = split[order[i]]
            while j < len(order) and split[order[j]] == s:
                j += 1
            sel = order[i:j]
            out[sel] = self.store.read_rows(int(s), local[sel])
            i = j
        return out

    def take(self, start: int, stop: int) -> torch.Tensor:
        stop = min(stop, self.N)
        return torch.from_numpy(self._rows(self.perm[start:stop])).to(
            self.device)


class StratifiedSampler(PermutationSampler):
    """Skew-aware prefix sampler for keyed (GROUP BY) sessions.

    A uniform prefix of a skewed table starves rare keys, and a keyed
    session gates on its worst key.  This sampler reorders the base
    permutation by stride scheduling: within each stratum rows keep the
    base order (each stratum's part of a prefix is a uniform sample of that
    key), and row i of stratum g is scheduled at virtual time
    (i+1)/share_g, the global order being the stable ascending sort of
    those times.  ``shares=None`` gives equal shares.

    The stratum is the last column, an integer key, which is the column
    ``GroupedStatistic`` groups on; rows are read pre-map.  Prefixes are
    uniform within each key but not across keys, so keyed sessions correct
    per key with ``stratum_counts(n) / stratum_sizes``."""

    def __init__(self, store: ShardedStore, num_groups: int, seed: int = 0,
                 shares=None, device=None):
        super().__init__(store, seed=seed, device=device)
        self.num_groups = int(num_groups)
        cols = []
        for s in store.splits:
            a = np.asarray(s)
            if a.ndim < 2 or a.shape[1] < 2:
                raise ValueError("StratifiedSampler needs keyed rows: data "
                                 "columns plus an integer key column")
            cols.append(a[:, -1])
        keys = np.concatenate(cols)
        if np.any(keys != np.floor(keys)):
            raise ValueError("key column must hold integers")
        keys = keys.astype(np.int64)
        if keys.min() < 0 or keys.max() >= self.num_groups:
            raise ValueError(f"keys must lie in [0, {self.num_groups}); got "
                             f"range [{keys.min()}, {keys.max()}]")
        if shares is None:
            shares = np.ones(self.num_groups)
        shares = np.asarray(shares, np.float64)
        if shares.shape != (self.num_groups,) or not np.all(shares > 0):
            raise ValueError("shares must be positive, one per group")
        self.shares = shares / shares.sum()
        #: rows of key g in the whole store: the per-key N for correct(p).
        self.stratum_sizes = np.bincount(keys, minlength=self.num_groups)

        kperm = keys[self.perm]
        order = np.argsort(kperm, kind="stable")
        sorted_k = kperm[order]
        starts = np.searchsorted(sorted_k, np.arange(self.num_groups))
        ranks = np.empty(self.N, np.int64)
        ranks[order] = np.arange(self.N) - starts[sorted_k]
        vtime = (ranks + 1) / self.shares[kperm]
        self.perm = self.perm[np.argsort(vtime, kind="stable")]
        self._kperm = keys[self.perm]

    def stratum_counts(self, stop: int) -> np.ndarray:
        """Rows of each key inside the prefix [0, stop)."""
        stop = min(int(stop), self.N)
        return np.bincount(self._kperm[:stop], minlength=self.num_groups)


class PreMapSampler(PermutationSampler):
    def __init__(self, store: ShardedStore, seed: int = 0, device=None):
        super().__init__(store, seed=seed, mode="pre_map", device=device)


class PostMapSampler(PermutationSampler):
    """The paper's post-map: read-then-select with hash bucketing.

    The hash layer reproduces Algorithm 1: every row is assigned a random
    key bucket on load (``np.random.default_rng(0xB0B)``, bitwise the JAX
    package's ``bucket_of``); draws pop buckets without replacement.
    Counting is exact: ``kv_count`` is known after the load (pre-map only
    estimates it)."""

    def __init__(self, store: ShardedStore, seed: int = 0,
                 num_buckets: int = 1024, device=None):
        super().__init__(store, seed=seed, mode="post_map", device=device)
        self.num_buckets = num_buckets
        self._loaded = False
        self.kv_count: Optional[int] = None

    def _load(self) -> None:
        self._cache = self.store.read_all()
        self.kv_count = len(self._cache)
        rng = np.random.default_rng(0xB0B)
        self.bucket_of = rng.integers(0, self.num_buckets,
                                      size=self.kv_count)
        self._loaded = True

    def take(self, start: int, stop: int) -> torch.Tensor:
        if not self._loaded:
            self._load()
        return super().take(start, stop)
