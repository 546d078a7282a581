"""Synthetic data with a known true answer (paper §6), bitwise the JAX
package's generator: numpy's ``default_rng(seed)``, cast to float32."""
from __future__ import annotations

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
