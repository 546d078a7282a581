"""Gradient compression for a slow all-reduce, the JAX package's
``repro/optim/compression.py``: gradients rounded to bf16 (round to
nearest even, as in the JAX package) with error feedback, the residual
carried into the next step."""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.decoder import tree_map

Params = Any


def compress_decompress(grads: Params, dtype=torch.bfloat16) -> Params:
    """Quantize-dequantize (models the lossy wire format)."""
    return tree_map(lambda g: g.to(dtype).to(g.dtype), grads)


def error_feedback_compress(grads: Params, residual: Params,
                            dtype=torch.bfloat16) -> Tuple[Params, Params]:
    """1-bit-style error feedback at bf16 granularity.

    sent = Q(g + r);  r' = (g + r) - sent.  Returns (sent, new_residual)."""
    def one(g, r):
        total = g.to(torch.float32) + r.to(torch.float32)
        sent = total.to(dtype)
        new_r = total - sent.to(torch.float32)
        return sent.to(g.dtype), new_r.to(r.dtype)

    pairs = tree_map(one, grads, residual)
    return _split(pairs, 0), _split(pairs, 1)


def _split(tree, i: int):
    if isinstance(tree, dict):
        return {k: _split(v, i) for k, v in tree.items()}
    return tree[i]


def init_residual(params: Params) -> Params:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
