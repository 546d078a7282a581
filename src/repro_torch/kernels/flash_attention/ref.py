"""Oracle for flash_attention: direct masked softmax attention."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def attention_mask(seq_q: int, seq_k: int, causal: bool,
                   window: Optional[int], kv_offset: int = 0,
                   device="cpu") -> torch.Tensor:
    """(Sq, Sk) boolean mask; True = attend.  Query row r sits at absolute
    position r + kv_offset (cached decode)."""
    rows = torch.arange(seq_q, device=device)[:, None] + kv_offset
    cols = torch.arange(seq_k, device=device)[None, :]
    mask = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        mask &= cols <= rows
    if window is not None:
        mask &= cols > rows - window
    return mask


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None, kv_offset: int = 0
                  ) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D).  GQA via head repeat.
    f32 arithmetic, f64 for f64 inputs (the oracle of the backward's
    tests: autograd through this function in f64)."""
    hq, d = q.shape[1], q.shape[3]
    hkv = k.shape[1]
    if scale is None:
        scale = d ** -0.5
    group = hq // hkv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    f = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(f), k.to(f)) * scale
    mask = attention_mask(q.shape[2], k.shape[2], causal, window, kv_offset,
                          device=q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(f))
    return out.to(q.dtype)
