"""Batch pipelines feeding the training and eval loops, the JAX package's
``repro/data/pipeline.py``.

``TokenBatchPipeline``: deterministic, restartable LM batches.  The epoch
order is a seeded numpy permutation and the cursor is a single integer
pair (``PipelineState``), so a checkpoint restore resumes the exact
stream; the batches are bitwise the JAX package's, across epoch
boundaries too, since the permutations are the same numpy draws.
``EvalSamplePipeline``: per-example rows (documents) from a
PermutationSampler, grown prefix-wise so the EARL loop's Δs is the
literal suffix; bitwise the JAX package's rows, since the store's
interleave and the permutation are the same numpy draws.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.data.sampler import PermutationSampler
from repro_torch.data.store import ShardedStore
from repro_torch.device import resolve_device


@dataclasses.dataclass
class PipelineState:
    """Checkpointable cursor."""
    epoch: int = 0
    step: int = 0


class TokenBatchPipeline:
    """(tokens, labels) batches of shape (batch, seq) from a doc store, as
    int32 tensors on ``device`` (the card unless ``"cpu"``)."""

    def __init__(self, docs: np.ndarray, batch: int, seq_len: int,
                 seed: int = 0, pad_id: int = 0, device=None):
        assert docs.ndim == 2
        self.docs = docs
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.pad_id = pad_id
        self.device = resolve_device(device)
        self.state = PipelineState()
        self._reperm()

    def _reperm(self) -> None:
        rng = np.random.default_rng(self.seed + self.state.epoch)
        self.perm = rng.permutation(len(self.docs))

    def steps_per_epoch(self) -> int:
        return len(self.docs) // self.batch

    def next_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.state.step >= self.steps_per_epoch():
            self.state = PipelineState(self.state.epoch + 1, 0)
            self._reperm()
        i = self.state.step * self.batch
        idx = self.perm[i:i + self.batch]
        self.state.step += 1
        docs = self.docs[idx]
        L = self.seq_len + 1
        if docs.shape[1] < L:
            docs = np.pad(docs, ((0, 0), (0, L - docs.shape[1])),
                          constant_values=self.pad_id)
        rows = torch.from_numpy(np.ascontiguousarray(docs[:, :L])).to(
            self.device)
        return rows[:, :self.seq_len], rows[:, 1:self.seq_len + 1]

    # -- checkpoint hooks ------------------------------------------------
    def state_dict(self) -> dict:
        return dataclasses.asdict(self.state)

    def load_state_dict(self, d: dict) -> None:
        self.state = PipelineState(**d)
        self._reperm()


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
