"""Samplers over the sharded store (paper §3.3).

* ``PermutationSampler`` — a fixed pseudo-random permutation of [0, N);
  ``take(a, b)`` returns permutation rows [a, b), so growing samples are
  prefix extensions (uniform without replacement) and delta maintenance
  gets pure Δs rows.  The permutation is ``np.random.default_rng(seed)``,
  bitwise the JAX package's, so both packages see the same sample.
* ``PreMapSampler`` — the pre-map flavour: samples row indices first and
  reads only those rows (low load cost).

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


class PreMapSampler(PermutationSampler):
    def __init__(self, store: ShardedStore, seed: int = 0, device=None):
        super().__init__(store, seed=seed, mode="pre_map", device=device)
