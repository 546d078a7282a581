"""Model layers: GQA self-attention (full and sliding-window, with the ring
KV cache), gated cross-attention (the VLM's ``xattn`` layers and the
encoder-decoder's ``dec`` layers) and the SwiGLU MLP, as in the JAX
package's ``repro/models/layers.py``.

Conventions, the JAX package's:
  * params are plain nested dicts of tensors (param_dtype), cast to
    cfg.compute_dtype at use; norms, softmax and the attention recurrence
    run in f32;
  * every block fn returns ``(y, new_cache)``; cache=None in train mode;
  * sequence caches of SWA layers are ring buffers of the window's size.

Prefill and train mode call ``flash_attention`` (kernel 12 on the card),
causal or not.  Decode reads the ring cache, and the cross-attention's
K/V cache, with plain products, as the JAX package's einsum and its
``"direct"`` backend do.  Projections keep the JAX package's output types
(``matmul_out_dtype``): bf16 operands give f32 products (``matmul_out``).
MoE, RG-LRU and xLSTM are not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import mha_reference
from repro_torch.models.config import ModelConfig

Params = Dict[str, Any]
Cache = Optional[Dict[str, Any]]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (B, S, H, Dh); positions: (S,) or (B, S)."""
    half = x.shape[-1] // 2
    # built where x lies: a host tensor copied to the card would make the
    # copy wait for the stream
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=x.device) / half)
    positions = positions.to(x.device)      # a no-op on the serving paths
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs       # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(shape, in_axis_size: int, dtype: torch.dtype,
               generator: torch.Generator, device) -> torch.Tensor:
    """normal · fan_in^-0.5, the JAX package's law (its draws are not
    reproduced: the generators differ)."""
    t = torch.randn(shape, generator=generator, device=device)
    return t.mul_(in_axis_size ** -0.5).to(dtype)


def matmul_out(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype
               ) -> torch.Tensor:
    """a (m, k) @ b (k, n) with the JAX package's ``preferred_element_type``
    semantics: f32 accumulation, the result in ``out_dtype``.  Operands of
    ``out_dtype`` multiply as they are.  Narrower operands (bf16) with an
    f32 output: on the card one bf16 product with an f32 output
    (``torch.mm(..., out_dtype=)``, f32 accumulation, rounded once to f32);
    on the CPU the f32 product of the bf16-valued operands (exact products,
    f32 sums), since the CPU's torch has no such output type.  f32 products
    run in IEEE f32 (the package turns TF32 off)."""
    if a.dtype == out_dtype and b.dtype == out_dtype:
        return a @ b
    if a.is_cuda and out_dtype == torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def _out_dtype(cfg: ModelConfig) -> torch.dtype:
    if cfg.matmul_out_dtype == "compute":
        return _cdtype(cfg)
    return dtype_of(cfg.matmul_out_dtype)


def project(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype,
            contract: int = 1) -> torch.Tensor:
    """The last ``contract`` axes of x against the first ``contract`` axes
    of w, as one product: the JAX package's "bsd,dhk->bshk", "bsd,df->bsf"
    and "bsf,fd->bsd" (contract=1) and "bshk,hkd->bsd" (contract=2)."""
    kshape = tuple(w.shape[:contract])
    if tuple(x.shape[-contract:]) != kshape:
        raise ValueError(f"cannot contract {tuple(x.shape)} with "
                         f"{tuple(w.shape)} over {contract} axes")
    kk = math.prod(kshape)
    out = matmul_out(x.reshape(-1, kk), w.reshape(kk, -1), out_dtype)
    return out.reshape(*x.shape[:-contract], *w.shape[contract:])


def mmc(cfg: ModelConfig, x: torch.Tensor, w: torch.Tensor,
        contract: int = 1) -> torch.Tensor:
    """A projection whose output type follows cfg.matmul_out_dtype."""
    return project(x, w, _out_dtype(cfg), contract)


# ---------------------------------------------------------------------------
# self attention (full / swa / local / global) with KV cache
# ---------------------------------------------------------------------------
def init_attention(cfg: ModelConfig, generator: torch.Generator, device,
                   lead: Tuple[int, ...] = ()) -> Params:
    """``lead`` is the stacking axis of a group of layers, (n_groups,)."""
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    pd = _pdtype(cfg)

    def init(shape, fan_in):
        return dense_init(lead + shape, fan_in, pd, generator, device)
    return {
        "wq": init((d, hq, dh), d),
        "wk": init((d, hkv, dh), d),
        "wv": init((d, hkv, dh), d),
        "wo": init((hq, dh, d), hq * dh),
    }


def init_attn_cache(cfg: ModelConfig, batch: int, cache_len: int,
                    window: int, device) -> Dict[str, torch.Tensor]:
    """Ring-buffer KV cache.  For windowed layers the buffer is the window
    (ring); for full layers it is the whole context."""
    hkv, dh = cfg.n_kv_heads, cfg.head_dim_
    L = min(cache_len, window) if window else cache_len
    cd = _cdtype(cfg)
    return {
        "k": torch.zeros((batch, hkv, L, dh), dtype=cd, device=device),
        "v": torch.zeros((batch, hkv, L, dh), dtype=cd, device=device),
        "slot_pos": torch.full((L,), -1, dtype=torch.int32, device=device),
    }


def self_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                   window: int, positions: torch.Tensor,
                   cache: Cache = None, causal: bool = True,
                   mode: str = "train",
                   cache_len: Optional[int] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    cd = _cdtype(cfg)
    xc = x.to(cd)

    q = mmc(cfg, xc, p["wq"].to(cd)).to(cd)
    k = mmc(cfg, xc, p["wk"].to(cd)).to(cd)
    v = mmc(cfg, xc, p["wv"].to(cd)).to(cd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q * (dh ** -0.5)
    qh = q.transpose(1, 2)                            # (B, Hq, S, Dh)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)

    if mode != "decode":
        out = flash_attention(
            qh, kh, vh, causal=causal, window=window or None, scale=1.0,
            block_q=cfg.attn_block_q, block_k=cfg.attn_block_k)
        y = out.transpose(1, 2)
        y = mmc(cfg, y.to(cd), p["wo"].to(cd), contract=2).to(x.dtype)
        if mode == "train":
            return y, None
        # prefill: materialize the KV cache (ring layout for SWA layers);
        # cache_len > s reserves room for subsequent decode steps
        assert positions.ndim == 1
        cl = cache_len if cache_len is not None else s
        L = min(window, cl) if window else cl
        idxs = torch.arange(max(s - L, 0), s, device=x.device)
        pos_abs = positions[idxs]
        slots = pos_abs % L if window else idxs
        kc = torch.zeros((b, hkv, L, dh), dtype=cd, device=x.device)
        vc = torch.zeros((b, hkv, L, dh), dtype=cd, device=x.device)
        kc[:, :, slots] = kh[:, :, idxs].to(cd)
        vc[:, :, slots] = vh[:, :, idxs].to(cd)
        slot_pos = torch.full((L,), -1, dtype=torch.int32, device=x.device)
        slot_pos[slots] = pos_abs.to(torch.int32)
        return y, {"k": kc, "v": vc, "slot_pos": slot_pos}

    # ---- cached decode: s == 1, ring-buffer update ----------------------
    # The slot is written in place (the JAX package returns a new buffer):
    # the caller's cache is the returned one.  ``positions`` lies on the
    # card, so no step waits on a host read of the position.
    assert s == 1, "cached path is single-token decode"
    L = cache["k"].shape[2]
    group = hq // hkv
    pos = positions.reshape(-1)[:1]                  # absolute position (1,)
    slot = pos % L if window else pos.clamp(0, L - 1)
    newk, newv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    newk.index_copy_(2, slot, kh.to(newk.dtype))
    newv.index_copy_(2, slot, vh.to(newv.dtype))
    slot_pos.index_copy_(0, slot, pos.to(slot_pos.dtype))

    svalid = slot_pos >= 0
    if causal:
        svalid &= slot_pos <= pos
    if window:
        svalid &= slot_pos > pos - window
    qg = qh.reshape(b, hkv, group, 1, dh)            # GQA grouping
    # compute-dtype operands, f32 products and sums: the JAX package's
    # einsum32
    scores = torch.einsum("bhgqk,bhsk->bhgqs", qg.to(torch.float32),
                          newk.to(torch.float32))
    scores = torch.where(svalid[None, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhgqs,bhsk->bhgqk", probs,
                       newv.to(torch.float32))
    ctx = ctx.reshape(b, hq, 1, dh).transpose(1, 2)
    y = project(ctx.to(cd), p["wo"].to(cd), torch.float32, contract=2)
    return y.to(x.dtype), {"k": newk, "v": newv, "slot_pos": slot_pos}


# ---------------------------------------------------------------------------
# cross attention (VLM xattn layers, whisper decoder)
# ---------------------------------------------------------------------------
def init_cross_attention(cfg: ModelConfig, generator: torch.Generator,
                         device, lead: Tuple[int, ...] = ()) -> Params:
    """Self-attention's projections and a scalar gate a layer, zero at
    init (the JAX package's law): a fresh layer adds tanh(0)·y = 0."""
    p = init_attention(cfg, generator, device, lead)
    p["gate"] = torch.zeros(lead, dtype=_pdtype(cfg), device=device)
    return p


def cross_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                    aux: Optional[torch.Tensor], cache: Cache = None,
                    mode: str = "train") -> Tuple[torch.Tensor, Cache]:
    """x: (B, S, d) queries; aux: (B, Ta, d) keys/values (no rope).

    Train and prefill project K/V from ``aux`` and attend with
    ``flash_attention`` (kernel 12 on the card, not causal); decode reads
    the projected K/V from the cache the prefill emitted and attends with
    plain products (the JAX package's ``"direct"`` backend).  The output
    is tanh(gate)·y in f32, returned in x's dtype."""
    dh = cfg.head_dim_
    cd = _cdtype(cfg)
    xc = x.to(cd)
    q = mmc(cfg, xc, p["wq"].to(cd)).to(cd)
    if mode == "decode":
        kh, vh = cache["k"], cache["v"]
    else:
        auxc = aux.to(device=x.device, dtype=cd)
        # (B, Hkv, Ta, Dh) laid out as the cache holds it
        kh = mmc(cfg, auxc, p["wk"].to(cd)).to(cd).transpose(1, 2) \
            .contiguous()
        vh = mmc(cfg, auxc, p["wv"].to(cd)).to(cd).transpose(1, 2) \
            .contiguous()
    qh = (q * (dh ** -0.5)).transpose(1, 2)          # (B, Hq, S, Dh)
    if mode == "decode":
        out = mha_reference(qh, kh, vh, causal=False, scale=1.0)
    else:
        out = flash_attention(qh, kh, vh, causal=False, window=None,
                              scale=1.0, block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    y = out.transpose(1, 2)
    y = mmc(cfg, y.to(cd), p["wo"].to(cd), contract=2)
    y = torch.tanh(p["gate"].to(torch.float32)) * y.to(torch.float32)
    new_cache = {"k": kh, "v": vh} if mode != "train" else None
    return y.to(x.dtype), new_cache


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------
def init_mlp(cfg: ModelConfig, generator: torch.Generator, device,
             lead: Tuple[int, ...] = ()) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    pd = _pdtype(cfg)

    def init(shape, fan_in):
        return dense_init(lead + shape, fan_in, pd, generator, device)
    return {
        "w_gate": init((d, f), d),
        "w_up": init((d, f), d),
        "w_down": init((f, d), f),
    }


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    cd = _cdtype(cfg)
    xc = x.to(cd)
    g = mmc(cfg, xc, p["w_gate"].to(cd))
    u = mmc(cfg, xc, p["w_up"].to(cd))
    h = (torch.nn.functional.silu(g.to(torch.float32))
         * u.to(torch.float32)).to(cd)
    y = mmc(cfg, h, p["w_down"].to(cd))
    return y.to(x.dtype)
