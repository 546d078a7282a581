"""Synthetic data with a known true answer (paper §6), bitwise the JAX
package's generator: numpy's ``default_rng(seed)``, cast to float32."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_numeric(n: int, mean: float = 10.0, std: float = 2.0,
                      dim: int = 1, seed: int = 0,
                      dist: str = "normal") -> np.ndarray:
    rng = np.random.default_rng(seed)
    if dist == "normal":
        x = rng.normal(mean, std, size=(n, dim))
    elif dist == "lognormal":
        x = rng.lognormal(np.log(max(mean, 1e-6)), std / mean, size=(n, dim))
    elif dist == "uniform":
        x = rng.uniform(mean - std, mean + std, size=(n, dim))
    elif dist == "heavy":   # pareto-ish heavy tail — stresses the bootstrap
        x = mean + std * (rng.pareto(3.0, size=(n, dim)) - 0.5)
    else:
        raise ValueError(dist)
    return x.astype(np.float32)


def synthetic_clusters(n: int, k: int = 5, dim: int = 2, spread: float = 0.4,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Gaussian blobs for the K-Means experiment (paper §6.3)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5.0, 5.0, size=(k, dim)).astype(np.float32)
    assign = rng.integers(0, k, size=n)
    x = centers[assign] + rng.normal(0, spread, size=(n, dim))
    return x.astype(np.float32), centers


def synthetic_tokens(n_docs: int, doc_len: int, vocab: int,
                     seed: int = 0) -> np.ndarray:
    """Zipf-ish token documents for the LM pipeline / earl_eval."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = (1.0 / ranks) / np.sum(1.0 / ranks)
    return rng.choice(vocab, size=(n_docs, doc_len), p=probs).astype(np.int32)
