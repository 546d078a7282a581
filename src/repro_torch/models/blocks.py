"""Block-level dispatch: init / apply / cache-init for the attention block
kinds the port has (``full``, ``swa``, ``local``, ``global``), as in the
JAX package's ``repro/models/blocks.py``.  The other kinds (``xattn``,
``enc``, ``dec``, ``rglru``, ``mlstm``, ``slstm``) and MoE MLPs raise
``NotImplementedError`` until their layers are ported (ROADMAP.md §1)."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_PORTED = ("full", "swa", "local", "global")


def _kind_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind in ("swa", "local") else 0


def _check(cfg: ModelConfig, kind: str) -> None:
    if kind not in _PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet (ROADMAP.md §1 item 5); "
            f"the port has {_PORTED}")
    if cfg.num_experts:
        raise NotImplementedError("MoE MLPs are not ported yet (ROADMAP.md "
                                  "§1 item 5)")


def init_block(cfg: ModelConfig, kind: str, generator: torch.Generator,
               device, lead: Tuple[int, ...] = ()) -> Params:
    """One block's params; ``lead`` stacks a group of layers, (n_groups,).
    Norm scales start at zero (the norm multiplies by 1 + scale)."""
    _check(cfg, kind)
    zero = torch.zeros(lead + (cfg.d_model,), dtype=L._pdtype(cfg),
                       device=device)
    p: Params = {"attn_norm": zero,
                 "attn": L.init_attention(cfg, generator, device, lead)}
    if cfg.d_ff:
        p["mlp_norm"] = zero.clone()
        p["mlp"] = L.init_mlp(cfg, generator, device, lead)
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, device) -> Dict[str, Any]:
    _check(cfg, kind)
    return {"attn": L.init_attn_cache(cfg, batch, cache_len,
                                      _kind_window(cfg, kind), device)}


def apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[Dict[str, Any]],
                mode: str, cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """mode: train | prefill | decode.  Returns (x, new_cache)."""
    _check(cfg, kind)
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    attn_out, kv = L.self_attention(
        cfg, p["attn"], h, window=_kind_window(cfg, kind),
        positions=positions, causal=True,
        cache=None if cache is None else cache["attn"], mode=mode,
        cache_len=cache_len)
    x = x + attn_out
    if cfg.d_ff:
        h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + L.mlp(cfg, p["mlp"], h)
    return x, (None if kv is None else {"attn": kv})
