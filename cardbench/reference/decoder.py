"""The plain reference decoder: the model of a configuration file in
float32, written from the layer equations with plain ``torch`` operations.
It imports nothing of the program.

Layers (``full``/``global``: causal; ``swa``/``local``: causal within
``window`` positions, key j visible to query i where i - window < j <= i):

    h = rms_norm(x, attn_norm)      x·rsqrt(mean(x²) + eps)·(1 + scale)
    q, k, v = h·wq, h·wk, h·wv      rope on q and k (halves rotated),
                                    q·D^-0.5; query head i reads kv head
                                    i // (Hq/Hkv)
    x = x + softmax(q·kᵀ)·v·wo
    h = rms_norm(x, mlp_norm)
    x = x + (silu(h·w_gate) ⊙ h·w_up)·w_down

then the final norm, the logits against the embedding (tied) or
``out_proj`` over the published vocabulary, and the cross-entropy of each
position's label.  The port computes its products in bf16 with f32
results; this runs every product in IEEE f32 (TF32 off, ``check_f32``).

Everything runs in blocks, so that it fits beside nothing else on the
card: attention a block of queries at a time over the keys it can see,
the logits and the loss a block of positions at a time.  With gradients
on (training), each layer and each attention block is recomputed in the
backward (``torch.utils.checkpoint``), which changes no value.

``Rounding`` puts the reference in the program's place at a lower
precision (the control): every product's operands, forward and backward,
rounded to a narrower type with one scale a tensor.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

#: queries a block of the attention, positions a block of the logits
BLOCK_Q = 1024
BLOCK_LOGITS = 2048


def check_f32() -> None:
    """Raise unless f32 products run in IEEE f32 on the card."""
    if torch.cuda.is_available() and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the reference needs IEEE f32 products: TF32 "
                           "is on")


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to ``dtype`` under one scale for the tensor (its largest
    magnitude to the type's largest), returned in t's type."""
    amax = t.detach().abs().amax().to(torch.float32)
    scale = torch.clamp_min(amax, 1e-30) / torch.finfo(dtype).max
    return ((t / scale).to(dtype).to(t.dtype) * scale).to(t.dtype)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dtype):
        ctx.dtype = dtype
        return _round(t, dtype)

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.dtype), None


class Rounding:
    """The operands of every product as the reference takes them: as they
    are (``None``), or rounded to a narrower type (the control)."""

    def __init__(self, dtype: Optional[torch.dtype] = None):
        self.dtype = dtype

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return t
        return _Rounded.apply(t, self.dtype)


F32 = Rounding()
WINDOWED = ("swa", "local")


def layers(model: dict, params: Dict[str, Any]) -> List[Tuple[str, dict]]:
    """(kind, that layer's tensors) of every layer in order: the stacked
    pattern groups split by layer (views), then the remainder."""
    pattern = model["layer_pattern"]
    out: List[Tuple[str, dict]] = []

    def at(tree, g):
        if isinstance(tree, dict):
            return {k: at(v, g) for k, v in tree.items()}
        return tree if g is None else tree[g]
    if "groups" in params:
        # a stacked tensor a leaf, or a list of each layer's tensor
        n = len(params["groups"]["0"]["attn"]["wq"])
        for g in range(n):
            for i, kind in enumerate(pattern):
                out.append((kind, at(params["groups"][str(i)], g)))
    for i, kind in enumerate(pattern[:len(params.get("rem", {}))]):
        out.append((kind, at(params["rem"][str(i)], None)))
    return out


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, positions, theta: float):
    """x (B, S, H, D); each head's halves rotated by position·freq."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * freqs       # (S, half)
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend_block(q, k, v, q0: int, k0: int, window: int, rnd: Rounding):
    """Queries at q0.. (B, Hkv, G, n, D) over keys at k0.. (B, Hkv, m, D)."""
    s = torch.einsum("bhgqd,bhkd->bhgqk", rnd(q), rnd(k))
    qi = torch.arange(q0, q0 + q.shape[3], device=q.device)[:, None]
    kj = torch.arange(k0, k0 + k.shape[2], device=q.device)[None, :]
    seen = kj <= qi
    if window:
        seen &= kj > qi - window
    s = torch.where(seen, s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", rnd(p), rnd(v))


def attention(q, k, v, window: int, rnd: Rounding):
    """q (B, Hq, S, D), already scaled; k, v (B, Hkv, S, D); causal."""
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, dh)
    outs = []
    for q0 in range(0, s, BLOCK_Q):
        q1 = min(s, q0 + BLOCK_Q)
        k0 = max(0, q0 - window + 1) if window else 0
        args = (qg[:, :, :, q0:q1], k[:, :, k0:q1], v[:, :, k0:q1])
        if torch.is_grad_enabled():
            o = checkpoint(_attend_block, *args, q0, k0, window, rnd,
                           use_reentrant=False)
        else:
            o = _attend_block(*args, q0, k0, window, rnd)
        outs.append(o)
    return torch.cat(outs, dim=3).reshape(b, hq, s, dh)


def layer(model: dict, kind: str, p: dict, x, positions, rnd: Rounding):
    b, s, d = x.shape
    eps, theta = model["norm_eps"], model["rope_theta"]
    a = p["attn"]
    hq, dh = a["wq"].shape[-2], a["wq"].shape[-1]
    hkv = a["wk"].shape[-2]
    h = rms_norm(x, p["attn_norm"], eps)
    hr = rnd(h)
    q = (hr @ rnd(a["wq"].reshape(d, hq * dh))).reshape(b, s, hq, dh)
    k = (hr @ rnd(a["wk"].reshape(d, hkv * dh))).reshape(b, s, hkv, dh)
    v = (hr @ rnd(a["wv"].reshape(d, hkv * dh))).reshape(b, s, hkv, dh)
    q = rope(q, positions, theta) * dh ** -0.5
    k = rope(k, positions, theta)
    window = model["window"] if kind in WINDOWED else 0
    o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                  window, rnd)
    o = o.transpose(1, 2).reshape(b, s, hq * dh)
    x = x + rnd(o) @ rnd(a["wo"].reshape(hq * dh, d))
    m = p["mlp"]
    h = rnd(rms_norm(x, p["mlp_norm"], eps))
    g = torch.nn.functional.silu(h @ rnd(m["w_gate"]))
    u = h @ rnd(m["w_up"])
    return x + rnd(g * u) @ rnd(m["w_down"])


def hidden(model: dict, params: Dict[str, Any], tokens, rnd: Rounding = F32):
    """The final norm's output (B, S, d) in f32 for token ids (B, S)."""
    x = params["embedding"][tokens].to(torch.float32)
    positions = torch.arange(tokens.shape[1], device=x.device)
    for kind, p in layers(model, params):
        if torch.is_grad_enabled():
            x = checkpoint(layer, model, kind, p, x, positions, rnd,
                           use_reentrant=False)
        else:
            x = layer(model, kind, p, x, positions, rnd)
    return rms_norm(x, params["final_norm"], model["norm_eps"])


def out_weight(model: dict, params: Dict[str, Any]):
    """(d, vocab): the output weight over the published vocabulary."""
    v = model["vocab"]
    if model["tie_embeddings"]:
        return params["embedding"][:v].T
    return params["out_proj"][:, :v]


def logits(model: dict, params: Dict[str, Any], h, rnd: Rounding = F32):
    """(…, vocab) f32 logits of hidden states (…, d)."""
    return rnd(h) @ rnd(out_weight(model, params))


def _ce_block(h, w, labels, rnd):
    z = rnd(h) @ rnd(w)
    return torch.logsumexp(z, dim=-1) - z.gather(-1, labels[:, None])[:, 0]


def token_losses(model: dict, params: Dict[str, Any], h, labels,
                 rnd: Rounding = F32):
    """(B, S) cross-entropy of each position's label, a block of
    positions at a time."""
    b, s, d = h.shape
    hf, lf = h.reshape(b * s, d), labels.reshape(b * s).to(torch.int64)
    w = out_weight(model, params)
    outs = []
    for i in range(0, b * s, BLOCK_LOGITS):
        args = (hf[i:i + BLOCK_LOGITS], w, lf[i:i + BLOCK_LOGITS], rnd)
        if torch.is_grad_enabled():
            outs.append(checkpoint(_ce_block, *args, use_reentrant=False))
        else:
            outs.append(_ce_block(*args))
    return torch.cat(outs).reshape(b, s)


def per_example_loss(model, params, tokens, labels, rnd: Rounding = F32):
    """(B,) mean loss of each sequence."""
    return token_losses(model, params, hidden(model, params, tokens, rnd),
                        labels, rnd).mean(dim=-1)


def loss(model, params, tokens, labels, rnd: Rounding = F32):
    """The mean loss over every position of the batch."""
    return token_losses(model, params, hidden(model, params, tokens, rnd),
                        labels, rnd).mean()
