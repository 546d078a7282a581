"""The earl_eval data path of the JAX package's ``repro/data/pipeline.py``.

``EvalSamplePipeline``: per-example rows (documents) from a
PermutationSampler, grown prefix-wise so the EARL loop's Δs is the
literal suffix; bitwise the JAX package's rows, since the store's
interleave and the permutation are the same numpy draws.
``TokenBatchPipeline`` waits with training (ROADMAP.md §1).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.data.sampler import PermutationSampler
from repro_torch.data.store import ShardedStore


class EvalSamplePipeline:
    """Growing per-example eval sample for earl_eval.

    Items are documents; ``take(a, b)`` yields (tokens, labels) of
    permutation rows [a, b) on the sampler's device (the card unless
    ``device="cpu"``).  Each row is one iid sample item (the paper's ⟨k,v⟩
    independence assumption)."""

    def __init__(self, docs: np.ndarray, seq_len: int, seed: int = 0,
                 split_size: int = 4096, device=None):
        store = ShardedStore.from_array(docs, split_size, interleave=True,
                                        seed=seed)
        self.sampler = PermutationSampler(store, seed=seed, mode="pre_map",
                                          device=device)
        self.seq_len = seq_len
        self.N = store.N

    def take(self, start: int, stop: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
        docs = self.sampler.take(start, stop)
        return docs[:, :self.seq_len], docs[:, 1:self.seq_len + 1]
