"""Config registry: ``get_config(arch_id, smoke=False)``.

The port runs every architecture of the JAX package's registry: the
dense attention configs (``full``, ``swa``, ``local`` and ``global``
layers with a SwiGLU MLP), the mixture-of-experts ones (mixtral-8x22b,
arctic-480b), the VLM with gated cross-attention layers (``xattn``), the
encoder-decoder (``enc`` and ``dec`` layers) and the recurrent ones
(recurrentgemma-2b: RG-LRU and local attention; xlstm-350m: sLSTM and
mLSTM).  ``smoke`` variants are the JAX package's runnable-on-CPU
reductions of the same family, field for field.  ``input_specs`` gives
every input of a step as ``meta`` tensors (the JAX package's
``ShapeDtypeStruct`` stand-ins; nothing is allocated).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models.config import (SHAPES, SMOKE_SHAPES, ModelConfig,
                                       ShapeConfig, shape_is_supported)

#: every architecture id of the JAX package's registry
ARCH_IDS = (
    "h2o-danube-3-4b",
    "stablelm-3b",
    "gemma3-27b",
    "granite-3-2b",
    "mixtral-8x22b",
    "arctic-480b",
    "xlstm-350m",
    "llama-3.2-vision-90b",
    "recurrentgemma-2b",
    "whisper-small",
)
_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def smoke_of(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: 2 pattern repeats + remainder shape kept."""
    kv = (cfg.n_kv_heads if cfg.n_kv_heads in (1,) else
          (4 if cfg.n_kv_heads == cfg.n_heads else 2))
    rem = min(len(cfg.rem_pattern), 1)
    return dataclasses.replace(
        cfg,
        n_layers=2 * cfg.pattern_len + rem,
        d_model=64,
        n_heads=4,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=509,                       # deliberately non-multiple (padding)
        vocab_pad_multiple=128,
        window=16 if cfg.window else 0,
        num_experts=4 if cfg.num_experts else 0,
        top_k=2 if cfg.num_experts else 0,
        vision_tokens=8 if cfg.vision_tokens else 0,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        rnn_width=64 if cfg.rnn_width else 0,
        mlstm_chunk=16,
        attn_block_q=16,
        attn_block_k=16,
        loss_chunk=16,
        param_dtype="float32",
        compute_dtype="float32",
        adam_dtype="float32",
    )


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    cfg: ModelConfig = importlib.import_module(_MODULES[arch_id]).CONFIG
    cfg.validate()
    return smoke_of(cfg) if smoke else cfg


def get_shape(shape_id: str, smoke: bool = False) -> ShapeConfig:
    table = SMOKE_SHAPES if smoke else SHAPES
    return table[shape_id]


# ---------------------------------------------------------------------------
# input specs (meta-tensor stand-ins; never allocates)
# ---------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _aux_spec(cfg: ModelConfig, batch: int) -> Optional[torch.Tensor]:
    from repro_torch.models.layers import dtype_of
    cd = dtype_of(cfg.compute_dtype)
    if cfg.family == "vlm":
        return _meta((batch, cfg.vision_tokens, cfg.d_model), cd)
    if cfg.is_encdec:
        return _meta((batch, cfg.enc_seq, cfg.d_model), cd)
    return None


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``meta`` tensors for every input of the (train|prefill|decode) step:
    the JAX package's keys, shapes and dtypes."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs: Dict[str, Any] = {"tokens": _meta((b, s), i32),
                                 "labels": _meta((b, s), i32)}
        aux = _aux_spec(cfg, b)
        if aux is not None:
            specs["aux"] = aux
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": _meta((b, s), i32)}
        aux = _aux_spec(cfg, b)
        if aux is not None:
            specs["aux"] = aux
        return specs
    if shape.kind == "decode":
        from repro_torch.models.decoder import init_serve_cache
        return {"token": _meta((b, 1), i32), "pos": _meta((), i32),
                "cache": init_serve_cache(cfg, b, s, device="meta")}
    raise ValueError(shape.kind)


__all__ = ["ARCH_IDS", "get_config", "get_shape", "input_specs",
           "smoke_of", "SHAPES", "SMOKE_SHAPES", "shape_is_supported"]
