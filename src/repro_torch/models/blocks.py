"""Block-level dispatch: init / apply / cache-init for every block kind of
the JAX package's ``repro/models/blocks.py``: ``full``, ``swa``,
``local`` and ``global`` (causal self-attention), ``xattn`` (the VLM's:
causal self-attention, then gated cross-attention to the image
embeddings), ``enc`` (the encoder's non-causal self-attention), ``dec``
(the encoder-decoder's: causal self-attention, then gated cross-attention
to the encoder's output), and the recurrent kinds ``rglru`` (RG-LRU),
``mlstm`` and ``slstm`` (xLSTM), each a norm, its cell and, where the
config has a ``d_ff``, a normed MLP.  A config with experts
(mixtral-8x22b, arctic-480b) takes the mixture-of-experts FFN in place of
an attention block's MLP: ``moe_ffn``, or ``moe_ffn_shard_map`` under
``moe_impl="shard_map"``."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models import layers as L
from repro_torch.models import sharded
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]

_ATTN_SELF = ("full", "swa", "local", "global", "xattn", "enc", "dec")
_CROSS = ("xattn", "dec")
#: a recurrent kind's (init, cache init, block)
_CELLS = {"rglru": (L.init_rglru, L.init_rglru_cache, L.rglru_block),
          "mlstm": (L.init_mlstm, L.init_mlstm_cache, L.mlstm_block),
          "slstm": (L.init_slstm, L.init_slstm_cache, L.slstm_block)}


def _kind_window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window if kind in ("swa", "local") else 0


def _kind_causal(kind: str) -> bool:
    return kind != "enc"


def init_block(cfg: ModelConfig, kind: str, generator: torch.Generator,
               device, lead: Tuple[int, ...] = ()) -> Params:
    """One block's params; ``lead`` stacks a group of layers, (n_groups,).
    Norm scales start at zero (the norm multiplies by 1 + scale), and so
    do cross-attention gates."""
    zero = torch.zeros(lead + (cfg.d_model,), dtype=L._pdtype(cfg),
                       device=device)
    if kind in _CELLS:
        p: Params = {"norm": zero,
                     "cell": _CELLS[kind][0](cfg, generator, device, lead)}
        if cfg.d_ff:
            p["mlp_norm"] = zero.clone()
            p["mlp"] = L.init_mlp(cfg, generator, device, lead)
        return p
    if kind not in _ATTN_SELF:
        raise ValueError(kind)
    p = {"attn_norm": zero,
         "attn": L.init_attention(cfg, generator, device, lead)}
    if kind in _CROSS:
        p["x_norm"] = zero.clone()
        p["xattn"] = L.init_cross_attention(cfg, generator, device, lead)
    if cfg.d_ff:
        p["mlp_norm"] = zero.clone()
        p["mlp"] = (L.init_moe(cfg, generator, device, lead)
                    if cfg.num_experts
                    else L.init_mlp(cfg, generator, device, lead))
    return p


def init_block_cache(cfg: ModelConfig, kind: str, batch: int,
                     cache_len: int, device) -> Dict[str, Any]:
    """A block's serving cache: a recurrent cell's state; the
    self-attention's ring KV cache, and for ``xattn``/``dec`` the
    cross-attention's (batch, n_kv_heads, aux_len, head_dim) K/V, aux_len
    the image tokens or the encoder's frames."""
    if kind in _CELLS:
        return {"cell": _CELLS[kind][1](cfg, batch, device)}
    if kind not in _ATTN_SELF:
        raise ValueError(kind)
    c: Dict[str, Any] = {"attn": L.init_attn_cache(
        cfg, batch, cache_len, _kind_window(cfg, kind), device)}
    if kind in _CROSS:
        aux_len = cfg.vision_tokens if kind == "xattn" else cfg.enc_seq
        shape = (batch, cfg.n_kv_heads, aux_len, cfg.head_dim_)
        cd = L._cdtype(cfg)
        c["xattn"] = {"k": torch.zeros(shape, dtype=cd, device=device),
                      "v": torch.zeros(shape, dtype=cd, device=device)}
    return c


def sublayer_input(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """x as a sublayer reads it: an alias while gradients are recorded, so
    that the gradients of the sublayer's uses of x are summed before the
    residual's is added, as on a mesh, where the sublayer is one
    ``local_map`` (``models/sharded.py``).  The sums then associate alike,
    and a mesh of one rank is bitwise this path."""
    if x is not None and x.requires_grad and torch.is_grad_enabled():
        return x.view_as(x)
    return x


def apply_block(cfg: ModelConfig, kind: str, p: Params, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[Dict[str, Any]],
                aux: Optional[torch.Tensor] = None, mode: str,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, Any]]]:
    """mode: train | prefill | decode.  ``aux`` (B, Ta, d) is what the
    cross-attention of ``xattn``/``dec`` reads in train and prefill mode.
    Returns (x, new_cache); decode writes into ``cache`` in place and
    returns it.  A DTensor stream runs on its mesh
    (``sharded.apply_block``)."""
    if sharded.is_dtensor(x):
        return sharded.apply_block(cfg, kind, p, x, positions=positions,
                                   cache=cache, aux=aux, mode=mode,
                                   cache_len=cache_len)
    new_cache: Dict[str, Any] = {}
    if kind in _CELLS:
        h = L.rms_norm(sublayer_input(x), p["norm"], cfg.norm_eps)
        out, cc = _CELLS[kind][2](cfg, p["cell"], h,
                                  cache=None if cache is None
                                  else cache["cell"], mode=mode)
        x = x + out
        if cc is not None:
            new_cache["cell"] = cc
        if cfg.d_ff:
            h = L.rms_norm(sublayer_input(x), p["mlp_norm"], cfg.norm_eps)
            x = x + L.mlp(cfg, p["mlp"], h)
        return x, (new_cache or None)
    if kind not in _ATTN_SELF:
        raise ValueError(kind)
    h = L.rms_norm(sublayer_input(x), p["attn_norm"], cfg.norm_eps)
    attn_out, kv = L.self_attention(
        cfg, p["attn"], h, window=_kind_window(cfg, kind),
        positions=positions, causal=_kind_causal(kind),
        cache=None if cache is None else cache["attn"], mode=mode,
        cache_len=cache_len)
    x = x + attn_out
    if kv is not None:
        new_cache["attn"] = kv
    if kind in _CROSS:
        h = L.rms_norm(sublayer_input(x), p["x_norm"], cfg.norm_eps)
        xo, xc = L.cross_attention(
            cfg, p["xattn"], h, sublayer_input(aux),
            cache=None if cache is None else cache["xattn"], mode=mode)
        x = x + xo
        if xc is not None:
            new_cache["xattn"] = xc
    if cfg.d_ff:
        h = L.rms_norm(sublayer_input(x), p["mlp_norm"], cfg.norm_eps)
        if cfg.num_experts:
            moe = (L.moe_ffn_shard_map if cfg.moe_impl == "shard_map"
                   else L.moe_ffn)
            x = x + moe(cfg, p["mlp"], h)
        else:
            x = x + L.mlp(cfg, p["mlp"], h)
    return x, (new_cache or None)
