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
(``matmul_out_dtype``): bf16 operands give f32 products (``matmul_out``,
and ``bmm_out`` for the experts' batched products).

The mixture-of-experts FFN (``init_moe``, ``moe_ffn``,
``moe_ffn_shard_map``) is the JAX package's sort-based capacity routing:
top-k gates, a stable sort of the token-slots by expert, a rank within
each expert, slots past the capacity dropped, a gather into an
(E·C + 1, d) dispatch buffer, the experts' SwiGLU as batched products
and a scatter-add back to the tokens.  The JAX package computes all of it
with XLA ops (no Pallas kernel), so the port's is PyTorch ops too.

The recurrent cells are PyTorch ops as well, as the JAX package computes
them outside any Pallas kernel: the RG-LRU (``rglru_block``: a width-4
causal conv, f32 gates, a log-depth doubling scan, ``linear_scan``, in
place of ``jax.lax.associative_scan``), the mLSTM (``mlstm_block``: a
loop over chunks of ``_mlstm_chunk``) and the sLSTM (``slstm_block``: a
loop of one ``_slstm_step`` a token).  Their decode writes the new state
into the cache it is given, as the self-attention's does.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

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


_CARD_ROUTE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "card_route", default=False)


@contextlib.contextmanager
def card_route():
    """Within the block, tensors on any device take the card's route where
    the layers branch on the device (``matmul_out``/``bmm_out``'s bf16
    products with an f32 output, ``_experts``' batched products over every
    expert).  The dry run (``launch/dryrun.py``) traces the card's steps
    with fake CPU tensors so, and the CPU's route, whose expert skip has a
    data-dependent shape, cannot run under FakeTensorMode."""
    token = _CARD_ROUTE.set(True)
    try:
        yield
    finally:
        _CARD_ROUTE.reset(token)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the card's route: a CUDA tensor, or any tensor
    inside ``card_route()``."""
    return t.is_cuda or _CARD_ROUTE.get()


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.compute_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


class EmbedSplit(NamedTuple):
    """The model dim d split across ranks (a mesh's FSDP split of
    "embed" kept where the activation has no data split): x holds this
    rank's columns of d, and so does every weight's "embed" dim.
    ``width``: the whole d; ``sum(*ts)``: the tensors, partial sums over
    the split, each summed across it (one all-reduce; the gradient passes
    as it is, since what follows runs alike on every rank); ``use(t)``: a
    tensor that every rank of the split holds whole, fed to this rank's
    columns (the identity; its gradient, a share a rank, is summed across
    the split).  A product that contracts d is followed by ``sum``; a
    product whose output is d reads its input through ``use``."""
    width: int
    sum: Any
    use: Any


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float,
             esplit: Optional[EmbedSplit] = None) -> torch.Tensor:
    """With ``esplit``, x and scale are a rank's columns of d: the squares'
    sum is summed across the split (``EmbedSplit``)."""
    xf = x.to(torch.float32)
    if esplit is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        ss, = esplit.sum((xf * xf).sum(dim=-1, keepdim=True))
        var = esplit.use(ss) / esplit.width
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


class _ProductOut(torch.autograd.Function):
    """bf16 operands, one f32 product on the card (``torch.mm`` or
    ``torch.bmm`` with ``out_dtype=torch.float32``), which PyTorch cannot
    differentiate.  The backward is the JAX package's transpose rule for
    ``preferred_element_type``: the f32 cotangent against the other
    operand upcast to f32, an IEEE f32 product (TF32 is off), rounded to
    the operand's dtype.  That is what autograd gives on the CPU path
    (``(a.to(f32) @ b.to(f32))``), so the card's gradients are the
    CPU's."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.ndim == 2:
            return torch.mm(a, b, out_dtype=torch.float32)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(torch.float32)
        da = db = None
        if ctx.needs_input_grad[0]:
            da = torch.matmul(g, b.to(torch.float32).transpose(-1, -2)
                              ).to(a.dtype)
        if ctx.needs_input_grad[1]:
            db = torch.matmul(a.to(torch.float32).transpose(-1, -2), g
                              ).to(b.dtype)
        return da, db


def _product_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _ProductOut.apply(a, b)
    if a.ndim == 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.bmm(a, b, out_dtype=torch.float32)


def matmul_out(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype
               ) -> torch.Tensor:
    """a (m, k) @ b (k, n) with the JAX package's ``preferred_element_type``
    semantics: f32 accumulation, the result in ``out_dtype``.  Operands of
    ``out_dtype`` multiply as they are.  Narrower operands (bf16) with an
    f32 output: on the card one bf16 product with an f32 output
    (``torch.mm(..., out_dtype=)``, f32 accumulation, rounded once to f32;
    differentiable through ``_ProductOut``); on the CPU the f32 product of
    the bf16-valued operands (exact products, f32 sums), since the CPU's
    torch has no such output type.  f32 products run in IEEE f32 (the
    package turns TF32 off)."""
    if a.dtype == out_dtype and b.dtype == out_dtype:
        return a @ b
    if on_card(a) and out_dtype == torch.float32:
        return _product_out(a, b)
    return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def bmm_out(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype
            ) -> torch.Tensor:
    """The batched ``matmul_out``: a (e, m, k) @ b (e, k, n), f32
    accumulation, the result in ``out_dtype``; on the card bf16 operands
    give one ``torch.bmm(..., out_dtype=torch.float32)`` (differentiable
    through ``_ProductOut``), on the CPU the f32 product of their bf16
    values."""
    if a.dtype == out_dtype and b.dtype == out_dtype:
        return torch.bmm(a, b)
    if on_card(a) and out_dtype == torch.float32:
        return _product_out(a, b)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32)).to(out_dtype)


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


def kv_heads_for(cfg: ModelConfig, hq: int, hkv: int, q_head0: int = 0,
                 kv_head0: int = 0):
    """Which of the ``hkv`` kv heads at hand each of the ``hq`` query heads
    at hand reads, where the first query head is global head ``q_head0``
    and the first kv head global ``kv_head0`` (a rank's heads on a mesh):
    query head j reads global kv head (q_head0 + j) // group.  None when
    that is local kv head j // (hq // hkv), the grouping the attention
    kernel applies; a slice of the kv heads when the heads read form a
    run that groups evenly; else the index of each query head's kv
    head."""
    group = cfg.n_heads // cfg.n_kv_heads
    idx = [(q_head0 + j) // group - kv_head0 for j in range(hq)]
    if hq % hkv == 0 and idx == [j // (hq // hkv) for j in range(hq)]:
        return None
    lo, n = idx[0], idx[-1] + 1 - idx[0]
    if hq % n == 0 and idx == [lo + j // (hq // n) for j in range(hq)]:
        return slice(lo, lo + n)
    return idx


def _select_kv(t: torch.Tensor, sel) -> torch.Tensor:
    """(B, Hkv, S, Dh) -> the kv heads ``kv_heads_for`` chose."""
    if sel is None:
        return t
    if isinstance(sel, slice):
        return t[:, sel]
    return t.index_select(1, torch.tensor(sel, device=t.device))


class SeqSplit(NamedTuple):
    """A decode cache whose ring slots are split across ranks (the
    flash-decoding layout: ``cache_seq`` over the data axes when the batch
    cannot split).  ``first``: the global index of this rank's first slot;
    ``length``: the ring's global length; ``all_reduce(t, op)``: ``t``
    reduced ("max" or "sum") over the ranks that split the slots."""
    first: int
    length: int
    all_reduce: Any


def _split_softmax_ctx(scores: torch.Tensor, valid: torch.Tensor,
                       v: torch.Tensor, split: SeqSplit) -> torch.Tensor:
    """softmax(scores) · v over slots split across ranks: each rank's
    partial (max, sum, weighted V) over its own slots, combined by one
    all-reduce of the max, then one of the sums (the weighted V with the
    sum as its last column), each rescaled to the global max."""
    m = split.all_reduce(scores.amax(dim=-1, keepdim=True), "max")
    p = torch.where(valid[None, None, None, None, :], torch.exp(scores - m),
                    0.0)
    acc = torch.einsum("bhgqs,bhsk->bhgqk", p, v.to(torch.float32))
    tot = split.all_reduce(torch.cat([acc, p.sum(dim=-1, keepdim=True)],
                                     dim=-1), "sum")
    return tot[..., :-1] / tot[..., -1:]


def self_attention(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                   window: int, positions: torch.Tensor,
                   cache: Cache = None, causal: bool = True,
                   mode: str = "train",
                   cache_len: Optional[int] = None, q_head0: int = 0,
                   kv_head0: int = 0, cast: bool = True,
                   seq_split: Optional["SeqSplit"] = None,
                   esplit: Optional[EmbedSplit] = None
                   ) -> Tuple[torch.Tensor, Cache]:
    """The head counts are the weights' (a rank's local heads on a mesh,
    whose first query and kv heads are global ``q_head0`` and
    ``kv_head0``; ``kv_heads_for``).  ``cast=False`` returns y in the
    output product's dtype, so that a sum over the ranks' heads comes
    before the cast (the JAX package's all-reduce of the dot output).
    ``seq_split`` (decode only): the cache holds this rank's slice of the
    ring's slots (the flash-decoding layout; ``SeqSplit``).  ``esplit``:
    x and the weights' d are a rank's columns (``EmbedSplit``)."""
    b, s, _ = x.shape
    hq, hkv, dh = p["wq"].shape[-2], p["wk"].shape[-2], cfg.head_dim_
    sel = kv_heads_for(cfg, hq, hkv, q_head0, kv_head0)
    cd = _cdtype(cfg)
    xc = x.to(cd)
    use = (lambda t: t) if esplit is None else esplit.use

    q = mmc(cfg, xc, p["wq"].to(cd))
    k = mmc(cfg, xc, p["wk"].to(cd))
    v = mmc(cfg, xc, p["wv"].to(cd))
    if esplit is not None:
        q, k, v = esplit.sum(q, k, v)
    q, k, v = q.to(cd), k.to(cd), v.to(cd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q * (dh ** -0.5)
    qh = q.transpose(1, 2)                            # (B, Hq, S, Dh)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)

    if mode != "decode":
        out = flash_attention(
            qh, _select_kv(kh, sel), _select_kv(vh, sel), causal=causal,
            window=window or None, scale=1.0, block_q=cfg.attn_block_q,
            block_k=cfg.attn_block_k)
        y = out.transpose(1, 2)
        y = mmc(cfg, use(y.to(cd)), p["wo"].to(cd), contract=2)
        if cast:
            y = y.to(x.dtype)
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
    newk, newv, slot_pos = cache["k"], cache["v"], cache["slot_pos"]
    pos = positions.reshape(-1)[:1]                  # absolute position (1,)
    L = newk.shape[2] if seq_split is None else seq_split.length
    slot = pos % L if window else pos.clamp(0, L - 1)
    kw, vw, pw = kh.to(newk.dtype), vh.to(newv.dtype), pos.to(slot_pos.dtype)
    if seq_split is not None:
        # the rank whose slice holds the slot writes it; the others write
        # their slot's own values back
        slot = slot - seq_split.first
        mine = (slot >= 0) & (slot < newk.shape[2])
        slot = slot.clamp(0, newk.shape[2] - 1)
        kw = torch.where(mine, kw, newk.index_select(2, slot))
        vw = torch.where(mine, vw, newv.index_select(2, slot))
        pw = torch.where(mine, pw, slot_pos.index_select(0, slot))
    newk.index_copy_(2, slot, kw)
    newv.index_copy_(2, slot, vw)
    slot_pos.index_copy_(0, slot, pw)

    svalid = slot_pos >= 0
    if causal:
        svalid &= slot_pos <= pos
    if window:
        svalid &= slot_pos > pos - window
    kr, vr = _select_kv(newk, sel), _select_kv(newv, sel)
    qg = qh.reshape(b, kr.shape[1], hq // kr.shape[1], 1, dh)  # GQA groups
    # compute-dtype operands, f32 products and sums: the JAX package's
    # einsum32
    scores = torch.einsum("bhgqk,bhsk->bhgqs", qg.to(torch.float32),
                          kr.to(torch.float32))
    scores = torch.where(svalid[None, None, None, None, :], scores, -1e30)
    if seq_split is None:
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhgqs,bhsk->bhgqk", probs, vr.to(torch.float32))
    else:
        ctx = _split_softmax_ctx(scores, svalid, vr, seq_split)
    ctx = ctx.reshape(b, hq, 1, dh).transpose(1, 2)
    y = project(use(ctx.to(cd)), p["wo"].to(cd), torch.float32, contract=2)
    return (y.to(x.dtype) if cast else y), \
        {"k": newk, "v": newv, "slot_pos": slot_pos}


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
                    mode: str = "train", q_head0: int = 0,
                    kv_head0: int = 0, cast: bool = True,
                    esplit: Optional[EmbedSplit] = None
                    ) -> Tuple[torch.Tensor, Cache]:
    """x: (B, S, d) queries; aux: (B, Ta, d) keys/values (no rope).

    Train and prefill project K/V from ``aux`` and attend with
    ``flash_attention`` (kernel 12 on the card, not causal); decode reads
    the projected K/V from the cache the prefill emitted and attends with
    plain products (the JAX package's ``"direct"`` backend).  The output
    is tanh(gate)·y in f32, returned in x's dtype (in f32 with
    ``cast=False``; the heads, ``q_head0``/``kv_head0`` and ``esplit``
    as in ``self_attention``; aux's d is split as x's)."""
    dh = cfg.head_dim_
    cd = _cdtype(cfg)
    xc = x.to(cd)
    use = (lambda t: t) if esplit is None else esplit.use
    q = mmc(cfg, xc, p["wq"].to(cd))
    if mode == "decode":
        if esplit is not None:
            q, = esplit.sum(q)
        q = q.to(cd)
        kh, vh = cache["k"], cache["v"]
    else:
        auxc = aux.to(device=x.device, dtype=cd)
        kh = mmc(cfg, auxc, p["wk"].to(cd))
        vh = mmc(cfg, auxc, p["wv"].to(cd))
        if esplit is not None:
            q, kh, vh = esplit.sum(q, kh, vh)
        q = q.to(cd)
        # (B, Hkv, Ta, Dh) laid out as the cache holds it
        kh = kh.to(cd).transpose(1, 2).contiguous()
        vh = vh.to(cd).transpose(1, 2).contiguous()
    qh = (q * (dh ** -0.5)).transpose(1, 2)          # (B, Hq, S, Dh)
    sel = kv_heads_for(cfg, qh.shape[1], kh.shape[1], q_head0, kv_head0)
    if mode == "decode":
        out = mha_reference(qh, _select_kv(kh, sel), _select_kv(vh, sel),
                            causal=False, scale=1.0)
    else:
        out = flash_attention(qh, _select_kv(kh, sel), _select_kv(vh, sel),
                              causal=False, window=None, scale=1.0,
                              block_q=cfg.attn_block_q,
                              block_k=cfg.attn_block_k)
    y = out.transpose(1, 2)
    y = mmc(cfg, use(y.to(cd)), p["wo"].to(cd), contract=2)
    y = use(torch.tanh(p["gate"].to(torch.float32))) * y.to(torch.float32)
    new_cache = {"k": kh, "v": vh} if mode != "train" else None
    return (y.to(x.dtype) if cast else y), new_cache


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


def mlp(cfg: ModelConfig, p: Params, x: torch.Tensor, cast: bool = True,
        esplit: Optional[EmbedSplit] = None) -> torch.Tensor:
    """SwiGLU; ``cast=False`` returns y in the output product's dtype (a
    rank's partial sum over its ``mlp`` slice on a mesh; ``esplit`` as in
    ``self_attention``)."""
    cd = _cdtype(cfg)
    xc = x.to(cd)
    g = mmc(cfg, xc, p["w_gate"].to(cd))
    u = mmc(cfg, xc, p["w_up"].to(cd))
    if esplit is not None:
        g, u = esplit.sum(g, u)
    h = (torch.nn.functional.silu(g.to(torch.float32))
         * u.to(torch.float32)).to(cd)
    if esplit is not None:
        h = esplit.use(h)
    y = mmc(cfg, h, p["w_down"].to(cd))
    return y.to(x.dtype) if cast else y


# ---------------------------------------------------------------------------
# MoE: top-k routing, sort-based capacity dispatch (no (T, E, C) one-hot)
# ---------------------------------------------------------------------------
#: the most expert-weight elements the CPU's products convert to f32 at
#: once (1 GiB of f32): arctic-480b's we_gate alone holds 4.5e9
CPU_EXPERT_ELEMS = 1 << 28


def _init_experts(shape, fan_in: int, dtype: torch.dtype,
                  generator: torch.Generator, device) -> torch.Tensor:
    """``dense_init``'s law drawn one (d, f) expert matrix at a time, so
    no f32 temporary of the whole tensor sits beside a bf16 result."""
    out = torch.empty(shape, dtype=dtype, device=device)
    flat = out.view(-1, *shape[-2:])
    for i in range(flat.shape[0]):
        flat[i] = dense_init(shape[-2:], fan_in, dtype, generator, device)
    return out


def init_moe(cfg: ModelConfig, generator: torch.Generator, device,
             lead: Tuple[int, ...] = ()) -> Params:
    """The router (d, E), the experts' SwiGLU weights (E, d, f), (E, d, f)
    and (E, f, d), and with ``dense_residual`` a dense MLP beside them;
    ``lead`` stacks a group of layers."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    pd = _pdtype(cfg)

    def experts(shape, fan_in):
        return _init_experts(lead + shape, fan_in, pd, generator, device)
    p = {
        "router": dense_init(lead + (d, e), d, pd, generator, device),
        "we_gate": experts((e, d, f), d),
        "we_up": experts((e, d, f), d),
        "we_down": experts((e, f, d), f),
    }
    if cfg.dense_residual:
        p["dense"] = init_mlp(cfg, generator, device, lead)
    return p


class Route(NamedTuple):
    """The routing of T tokens.  Per token: ``logits`` and ``probs``
    (T, E) the router's f32 logits and their softmax, and ``eidx`` (T, k)
    its experts, best first.  Per token-slot, sorted by expert (T·k):
    ``se`` the expert, ``st`` the token, ``sg`` its gate (divided by the
    sum of the token's k gates), ``keep`` whether its rank in its expert
    is below the capacity ``cap``, and ``slot`` its dispatch row, E·cap
    where it is dropped."""
    logits: torch.Tensor
    probs: torch.Tensor
    eidx: torch.Tensor
    cap: int
    se: torch.Tensor
    st: torch.Tensor
    sg: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def router_logits(cfg: ModelConfig, p: Params, xt: torch.Tensor
                  ) -> torch.Tensor:
    """The router's f32 logits (T, E) of the tokens ``xt`` (T, d), from
    compute-dtype operands."""
    cd = _cdtype(cfg)
    return project(xt.to(cd), p["router"].to(cd), torch.float32)


def choose_experts(cfg: ModelConfig, logits: torch.Tensor):
    """(probs, eidx, gate) of router logits (T, E): the softmax in f32,
    each token's top k experts, best first, and their gates divided by
    their sum."""
    k = cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    # jax.lax.top_k: descending, the lower index first on a tie;
    # torch.topk promises no order among ties, a stable sort does
    top, order_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    eidx = order_e[:, :k]
    gate = top[:, :k] / top[:, :k].sum(-1, keepdim=True)
    return probs, eidx, gate


def moe_route(cfg: ModelConfig, p: Params, xt: torch.Tensor) -> Route:
    """Top-k routing of the tokens ``xt`` (T, d) with capacity
    C = ceil(T·k·capacity_factor / E), as the JAX package routes: router
    logits from compute-dtype operands in f32, softmax in f32, top-k,
    then the token-slots in token-major order stably sorted by expert, so
    that the slots past an expert's capacity are the JAX package's."""
    logits = router_logits(cfg, p, xt)
    return route_of(cfg, logits, *choose_experts(cfg, logits))


def route_of(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
             eidx: torch.Tensor, gate: torch.Tensor) -> Route:
    """The Route of T tokens' choices (``choose_experts``): the token-slots
    in token-major order stably sorted by expert, each slot's rank in its
    expert, and the slots past the capacity dropped.  A mesh's routing
    (``models/sharded.py``) calls it on the choices of every rank's
    tokens, so that its kept slots are the unsharded route's."""
    t, k = eidx.shape
    e = cfg.num_experts
    cap = int(math.ceil(t * k * cfg.capacity_factor / e))
    dev = eidx.device
    flat_e = eidx.reshape(-1)                                # (T·k,)
    flat_t = torch.arange(t, device=dev).repeat_interleave(k)
    order = torch.argsort(flat_e, stable=True)
    se, st, sg = flat_e[order], flat_t[order], gate.reshape(-1)[order]
    idx = torch.arange(t * k, device=dev)
    is_start = torch.ones_like(se, dtype=torch.bool)
    is_start[1:] = se[1:] != se[:-1]
    # torch.cummax for the JAX package's associative_scan(max)
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=0).values
    rank = idx - seg_start
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, e * cap)       # drop -> last
    return Route(logits, probs, eidx, cap, se, st, sg, keep, slot)


def dropped_slots(route: Route) -> torch.Tensor:
    """The token-slots past their expert's capacity (a 0-d tensor)."""
    return (~route.keep).sum()


def near_ties(route: Route, rel: float = 1e-3) -> torch.Tensor:
    """(T,) whether a token's k-th and (k+1)-th router probabilities lie
    within ``rel`` of the k-th: a choice that products rounded another way
    (the card's and the CPU's, or a batch of another size) may flip."""
    k = route.eidx.shape[1]
    if route.probs.shape[1] <= k:
        return torch.zeros(route.probs.shape[0], dtype=torch.bool,
                           device=route.probs.device)
    top = torch.topk(route.probs, k + 1, dim=-1).values
    return (top[:, k - 1] - top[:, k]) < rel * top[:, k - 1]


def route_agreement(a: Route, b: Route, rel: float = 1e-3
                    ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Two routings of the same tokens (say the card's and the CPU's), on
    the host: (agree, ties, unexplained).  ``agree`` (T,): the token chose
    the same experts and kept the same slots in both; ``ties`` (T,): a
    near tie in either.  ``unexplained`` counts the tokens whose choice
    differs with no near tie of their own, and, where no choice differs,
    the tokens whose kept slots differ (only a flipped choice can shift
    another token's rank in its expert)."""
    def kept(r):
        out = torch.zeros(r.probs.shape, dtype=torch.bool)
        keep = r.keep.cpu()
        out[r.st.cpu()[keep], r.se.cpu()[keep]] = True
        return out

    chose = (a.eidx.cpu().sort(-1).values
             == b.eidx.cpu().sort(-1).values).all(-1)
    same_kept = (kept(a) == kept(b)).all(-1)
    ties = near_ties(a, rel).cpu() | near_ties(b, rel).cpu()
    unexplained = int((~chose & ~ties).sum())
    if bool(chose.all()):
        unexplained += int((~same_kept).sum())
    return chose & same_kept, ties, unexplained


def _expert_swiglu(cfg: ModelConfig, wg: torch.Tensor, wu: torch.Tensor,
                   wd: torch.Tensor, xe: torch.Tensor,
                   esplit: Optional[EmbedSplit] = None) -> torch.Tensor:
    """SwiGLU of each expert on its rows xe (e, C, d): the JAX package's
    "ecd,edf->ecf" and "ecf,efd->ecd" in matmul_out_dtype, the gate in
    f32, h in the compute dtype (``esplit`` as in ``self_attention``)."""
    cd, od = _cdtype(cfg), _out_dtype(cfg)
    if esplit is not None:
        g, u = esplit.sum(bmm_out(xe, wg.to(cd), od),
                          bmm_out(xe, wu.to(cd), od))
        h = (torch.nn.functional.silu(g.to(torch.float32))
             * u.to(torch.float32)).to(cd)
        return bmm_out(esplit.use(h), wd.to(cd), od)
    g = bmm_out(xe, wg.to(cd), od).to(torch.float32)
    u = bmm_out(xe, wu.to(cd), od)
    # g is this function's own f32 tensor: silu and the product in place
    h = torch.nn.functional.silu(g, inplace=True).mul_(u.to(torch.float32))
    del u
    h = h.to(cd)
    return bmm_out(h, wd.to(cd), od)


def _experts(cfg: ModelConfig, p: Params, xe: torch.Tensor, route: Route,
             e0: int = 0) -> torch.Tensor:
    """Every expert's SwiGLU on its dispatch rows xe (E, C, d), the experts
    at hand being global experts e0, e0 + 1, ... (a rank's on a mesh).  On
    the card one batched product a weight.  On the CPU the experts go a
    chunk of at most CPU_EXPERT_ELEMS weight elements at a time, so their
    f32 copies stay bounded, and an expert with no kept slot is skipped:
    its rows stay zero and no token reads them."""
    if on_card(xe):
        return _expert_swiglu(cfg, p["we_gate"], p["we_up"], p["we_down"],
                              xe)
    e, cap, _ = xe.shape
    d, f = p["we_gate"].shape[-2:]
    out = torch.zeros((e, cap, p["we_down"].shape[-1]),
                      dtype=_out_dtype(cfg))
    used = torch.zeros(e, dtype=torch.bool)
    se = route.se[route.keep] - e0
    used[se[(se >= 0) & (se < e)]] = True
    ids = torch.nonzero(used).flatten()
    for chunk in ids.split(max(1, CPU_EXPERT_ELEMS // (d * f))):
        out[chunk] = _expert_swiglu(cfg, p["we_gate"][chunk],
                                    p["we_up"][chunk], p["we_down"][chunk],
                                    xe[chunk])
    return out


def _moe_route_compute(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       e0: int = 0) -> torch.Tensor:
    """Sort-based capacity routing and the experts' FFNs over the tokens
    of ``x`` (B, S, d): dispatch by index into an (E·C + 1, d) buffer,
    whose last row takes every dropped slot and is read by no expert,
    then combine as a scatter-add of each kept slot's output times its
    gate.  Returns y in f32, without the dense residual (the caller adds
    it).  With f-sliced expert weights, or only the experts e0, e0 + 1,
    ... at hand (an expert-split mesh: the others' slots add zero rows), y
    is a partial sum (the caller sums it over the model axes)."""
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    return moe_experts(cfg, p, xt, moe_route(cfg, p, xt), e0).reshape(
        b, s, d)


def moe_experts(cfg: ModelConfig, p: Params, xt: torch.Tensor, r: Route,
                e0: int = 0, esplit: Optional[EmbedSplit] = None
                ) -> torch.Tensor:
    """The dispatch, the experts' FFNs and the combine of the tokens
    ``xt`` (T, d) routed by ``r``: (T, d) in f32, a partial sum where the
    experts at hand are e0, e0 + 1, ... of E or f-slices of them
    (``_moe_route_compute``).  With ``esplit`` xt and the experts' d are
    a rank's columns (``EmbedSplit``): every expert at hand runs, in one
    batched product a weight (the card's route), whatever the device."""
    t, d = xt.shape
    e = cfg.num_experts
    cd = _cdtype(cfg)
    cap = r.cap
    el = p["we_gate"].shape[-3]                 # the experts at hand
    buf = torch.zeros((e * cap + 1, d), dtype=cd, device=xt.device)
    buf[r.slot] = xt[r.st].to(cd)
    xe = buf[e0 * cap:(e0 + el) * cap].view(el, cap, d)
    if esplit is None:
        out = _experts(cfg, p, xe, r, e0)
    else:
        out = _expert_swiglu(cfg, p["we_gate"], p["we_up"], p["we_down"],
                             xe, esplit)
    del buf, xe
    if el == e:
        outf = torch.cat([out.reshape(e * cap, d).to(torch.float32),
                          torch.zeros((1, d), dtype=torch.float32,
                                      device=xt.device)])
    else:
        outf = torch.zeros((e * cap + 1, d), dtype=torch.float32,
                           device=xt.device)
        outf[e0 * cap:(e0 + el) * cap] = out.reshape(el * cap, d)
    del out
    gate = r.sg * r.keep
    if esplit is not None:
        gate = esplit.use(gate)
    contrib = outf[r.slot] * gate[:, None]
    del outf
    # each token's k addends land on a zero row; at k = 2, 0 + a + b is
    # exact in either order, so the card's atomic adds give one result
    y = torch.zeros((t, d), dtype=torch.float32, device=xt.device)
    y.index_add_(0, r.st, contrib)
    return y


def moe_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Global MoE: one routing problem over all of x's tokens, plus the
    dense MLP under ``dense_residual`` (in f32), cast back to x's dtype."""
    y = _moe_route_compute(cfg, p, x)
    if cfg.dense_residual:
        y = y + mlp(cfg, p["dense"], x).to(torch.float32)
    return y.to(x.dtype)


def _mlp_partial(cfg: ModelConfig, p: Params, x: torch.Tensor
                 ) -> torch.Tensor:
    """SwiGLU on an f-sliced weight slice; returns f32 partial sums (the
    caller sums them over the model axes)."""
    cd = _cdtype(cfg)
    xc = x.to(cd)
    g = mmc(cfg, xc, p["w_gate"].to(cd))
    u = mmc(cfg, xc, p["w_up"].to(cd))
    h = (torch.nn.functional.silu(g.to(torch.float32))
         * u.to(torch.float32)).to(cd)
    return mmc(cfg, h, p["w_down"].to(cd)).to(torch.float32)


def moe_ffn_shard_map(cfg: ModelConfig, p: Params, x: torch.Tensor
                      ) -> torch.Tensor:
    """Group-local MoE (GShard groups = data shards) with expert weights
    sliced along f over the model axes, on the mesh of the installed
    ``act_shard.activation_sharding`` context.

    Every rank holds the global x (B, S, d) and params (``core/_mesh.py``):
    it routes the tokens of its data shard (capacity per group) through
    its f-slice of every expert's weights (and of the dense residual's),
    sums the f32 partial outputs over the model axes by
    ``psum_tensors``'s gather and left fold in flat shard order, and
    gathers the data shards, so it returns the global (B, S, d).  Falls
    back to ``moe_ffn`` where the JAX package does: no context, no
    ``"mlp"`` entry in the mapping, B not divisible by the batch ways or
    d_ff by the model ways."""
    from repro_torch.core._mesh import (data_groups, gather_rows,
                                        num_shards, psum_tensors,
                                        shard_index)
    from repro_torch.models.act_shard import current_mapping, current_mesh
    mesh = current_mesh()
    mapping = current_mapping()
    if mesh is None or mapping is None or "mlp" not in mapping:
        return moe_ffn(cfg, p, x)

    batch_axes = tuple(name for name, _ in mapping.get("batch", ()))
    model_axes = tuple(name for name, _ in mapping["mlp"])
    batch_ways = num_shards(mesh, batch_axes) if batch_axes else 1
    if not model_axes or x.shape[0] % batch_ways != 0 \
            or cfg.d_ff % num_shards(mesh, model_axes):
        return moe_ffn(cfg, p, x)

    rows = x.shape[0] // batch_ways
    b0 = (shard_index(mesh, batch_axes) if batch_axes else 0) * rows
    x_loc = x[b0:b0 + rows]
    width = cfg.d_ff // num_shards(mesh, model_axes)
    f0 = shard_index(mesh, model_axes) * width
    fs = slice(f0, f0 + width)
    p_loc = {"router": p["router"], "we_gate": p["we_gate"][..., fs],
             "we_up": p["we_up"][..., fs], "we_down": p["we_down"][:, fs]}
    y = _moe_route_compute(cfg, p_loc, x_loc)
    if cfg.dense_residual:
        dense = p["dense"]
        y = y + _mlp_partial(cfg, {"w_gate": dense["w_gate"][:, fs],
                                   "w_up": dense["w_up"][:, fs],
                                   "w_down": dense["w_down"][fs]}, x_loc)
    y = psum_tensors([y], data_groups(mesh, model_axes))[0].to(x.dtype)
    if batch_axes:
        y = gather_rows(y, data_groups(mesh, batch_axes))
    return y


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# ---------------------------------------------------------------------------
_LRU_C = 8.0
#: the stabilisers' start: with -inf, m + F - m_new would give NaN
_NEG = -1e30


def init_rglru(cfg: ModelConfig, generator: torch.Generator, device,
               lead: Tuple[int, ...] = ()) -> Params:
    """The input and gate-branch projections (d, r), the width-cw
    depthwise conv (cw, r), the recurrence and input gates (r, r), the
    decay ``lam`` (r,) from uniform [0.7, 0.95) and the output (r, d)."""
    d, r, cw = cfg.d_model, cfg.rnn_width_, cfg.conv_width
    pd = _pdtype(cfg)

    def init(shape, fan_in):
        return dense_init(lead + shape, fan_in, pd, generator, device)
    p = {"w_x": init((d, r), d), "w_y": init((d, r), d),
         "conv": init((cw, r), cw), "w_a": init((r, r), r),
         "w_i": init((r, r), r)}
    lam = torch.rand(lead + (r,), generator=generator, device=device)
    p["lam"] = lam.mul_(0.95 - 0.7).add_(0.7).to(pd)
    p["w_out"] = init((r, d), r)
    return p


def init_rglru_cache(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    r, cw = cfg.rnn_width_, cfg.conv_width
    return {"lru": torch.zeros((batch, r), dtype=torch.float32,
                               device=device),
            "conv_state": torch.zeros((batch, cw - 1, r),
                                      dtype=_cdtype(cfg), device=device)}


def _causal_conv(u: torch.Tensor, kern: torch.Tensor,
                 state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Depthwise causal conv. u: (B, S, r), kern: (cw, r); ``state`` the
    cw - 1 inputs before u (zeros where None).  Returns (out, a copy of
    the last cw - 1 inputs: a view would keep the whole sequence alive in
    a prefill's cache)."""
    cw, s = kern.shape[0], u.shape[1]
    if state is None:
        up = torch.nn.functional.pad(u, (0, 0, cw - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    out = up[:, 0:s] * kern[0]
    for i in range(1, cw):
        out = out + up[:, i:i + s] * kern[i]
    return out, (up[:, -(cw - 1):].clone() if cw > 1 else None)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_(t-1) + b_t over axis 1 from h_(-1) = 0, the JAX
    package's ``associative_scan`` of (a1·a2, b1·a2 + b2), as a log-depth
    doubling scan: ceil(log2 S) levels of (a, b) <- (a · a_shift,
    b + a · b_shift), each out of place.  Its f32 order is neither JAX's
    nor a sequential loop's."""
    s, off = a.shape[1], 1
    while off < s:
        b_new = b.clone()
        b_new[:, off:] += a[:, off:] * b[:, :-off]
        if 2 * off < s:
            a_new = a.clone()
            a_new[:, off:] *= a[:, :-off]
            a = a_new
        b, off = b_new, 2 * off
    return b


def _write(cache: Dict[str, torch.Tensor], new: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """Decode's new state copied into the cache it was given (a stacked
    group's view writes through to the stack), which is returned."""
    for name, t in new.items():
        cache[name].copy_(t)
    return cache


def rglru_in(cfg: ModelConfig, p: Params, x: torch.Tensor,
             conv_state: Optional[torch.Tensor],
             esplit: Optional[EmbedSplit] = None):
    """The RG-LRU's input side: (u = conv(x·w_x), the gate branch x·w_y,
    the new conv state, and the gates' pre-activations u·w_a and u·w_i in
    f32 from compute-dtype operands).  On a mesh that splits ``rnn`` the
    pre-activations are a rank's partial sums, to be summed before the
    sigmoids of ``rglru_out``.  ``esplit`` as in ``self_attention``."""
    cd = _cdtype(cfg)
    xc = x.to(cd)
    u = mmc(cfg, xc, p["w_x"].to(cd))
    gate_branch = mmc(cfg, xc, p["w_y"].to(cd))
    if esplit is not None:
        u, gate_branch = esplit.sum(u, gate_branch)
    u = u.to(cd)
    u, new_conv = _causal_conv(u, p["conv"].to(cd), conv_state)
    ra = project(u, p["w_a"].to(cd), torch.float32)
    ia = project(u, p["w_i"].to(cd), torch.float32)
    return u, gate_branch, new_conv, ra, ia


def rglru_out(cfg: ModelConfig, p: Params, u: torch.Tensor,
              gate_branch: torch.Tensor, ra: torch.Tensor, ia: torch.Tensor,
              lru: Optional[torch.Tensor], mode: str,
              esplit: Optional[EmbedSplit] = None):
    """The RG-LRU's recurrence and output product from ``rglru_in``'s
    tensors: (y in the product's dtype, the last state h)."""
    cd = _cdtype(cfg)
    # the gates, each freed once used: at full width every one is a
    # (B, S, r) f32 tensor
    rt = torch.sigmoid(ra)
    a = torch.exp((-_LRU_C * torch.nn.functional.softplus(
        p["lam"].to(torch.float32))) * rt)
    del rt
    it = torch.sigmoid(ia)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (
        it * u.to(torch.float32))
    del it, u
    if mode == "decode":
        new_h = a[:, 0] * lru + gated[:, 0]
        h = new_h[:, None, :]
    else:
        h = linear_scan(a, gated)
        new_h = h[:, -1].clone()               # not a view of the sequence
        del a, gated
    y = torch.nn.functional.gelu(gate_branch.to(torch.float32),
                                 approximate="tanh") * h
    y = y.to(cd)
    if esplit is not None:
        y = esplit.use(y)
    return mmc(cfg, y, p["w_out"].to(cd)), new_h


def rglru_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                cache: Cache = None, mode: str = "train", cast: bool = True
                ) -> Tuple[torch.Tensor, Cache]:
    """The gated linear recurrence: u = conv(x·w_x), gates
    r, i = sigmoid(u·w_a), sigmoid(u·w_i) in f32 from compute-dtype
    operands, a = exp(-8·softplus(lam)·r), h_t = a·h_(t-1) +
    sqrt(1 - a²)·i·u, out = (gelu_tanh(x·w_y) · h)·w_out.  Train and
    prefill scan the sequence (``linear_scan``); decode takes one step and
    writes ``lru`` and ``conv_state`` into its cache in place.  The
    prefill's conv state is the last cw - 1 raw inputs (the JAX package
    pads them again; ``_causal_conv`` already returns them).
    ``cast=False`` returns y in the output product's dtype."""
    conv_state = cache["conv_state"] if mode == "decode" else None
    u, gate_branch, new_conv, ra, ia = rglru_in(cfg, p, x, conv_state)
    # u read through an alias, as the second half of a mesh's two local
    # maps reads it (``blocks.sublayer_input``)
    y, new_h = rglru_out(cfg, p, u.view_as(u) if u.requires_grad else u,
                         gate_branch, ra, ia,
                         cache["lru"] if mode == "decode" else None, mode)
    del u, ra, ia
    if cast:
        y = y.to(x.dtype)
    if mode == "train":
        return y, None
    new = {"lru": new_h, "conv_state": new_conv}
    return y, (_write(cache, new) if mode == "decode" else new)


# ---------------------------------------------------------------------------
# xLSTM: mLSTM (matrix memory, chunkwise-parallel) and sLSTM (step loop)
# ---------------------------------------------------------------------------
def init_mlstm(cfg: ModelConfig, generator: torch.Generator, device,
               lead: Tuple[int, ...] = ()) -> Params:
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim_
    pd = _pdtype(cfg)

    def init(shape, fan_in):
        return dense_init(lead + shape, fan_in, pd, generator, device)
    return {"wq": init((d, h, dh), d), "wk": init((d, h, dh), d),
            "wv": init((d, h, dh), d), "wi": init((d, h), d),
            "wf": init((d, h), d), "wo": init((h, dh, d), h * dh)}


def init_mlstm_cache(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    h, dh = cfg.n_heads, cfg.head_dim_
    f32 = torch.float32
    return {"mC": torch.zeros((batch, h, dh, dh), dtype=f32, device=device),
            "mn": torch.zeros((batch, h, dh), dtype=f32, device=device),
            "mm": torch.full((batch, h), _NEG, dtype=f32, device=device)}


def _mlstm_chunk(q, k, v, ig, lf, carry):
    """One chunk of the stabilized mLSTM recurrence.

    q, k, v: (B, H, c, dh) f32; ig: (B, H, c) input gate pre-activation;
    lf: (B, H, c) log forget gate; carry: (C (B, H, dh, dh), n (B, H, dh),
    m (B, H)).  Returns (h (B, H, c, dh), the carry after the chunk)."""
    C, nvec, m = carry
    F = torch.cumsum(lf, dim=-1)
    logw = ig - F
    m_loc = torch.cummax(logw, dim=2).values
    m_new = torch.maximum(m[..., None], m_loc) + F     # running stabilizer
    # inter-chunk: the carried state, scaled
    inter_scale = torch.exp(m[..., None] + F - m_new)
    h_inter = (q @ C) * inter_scale[..., None]
    n_inter = (q @ nvec[..., None])[..., 0] * inter_scale
    # intra-chunk: quadratic
    s_qk = q @ k.transpose(-1, -2)
    decay = (F[..., :, None] - F[..., None, :] + ig[..., None, :]
             - m_new[..., :, None])
    c = decay.shape[-1]
    tri = torch.ones((c, c), dtype=torch.bool, device=q.device).tril()
    D = torch.where(tri, torch.exp(decay), 0.0)
    w = s_qk * D
    h_intra = w @ v
    n_intra = w.sum(dim=-1)
    denom = torch.maximum((n_inter + n_intra).abs(), torch.exp(-m_new))
    h = (h_inter + h_intra) / denom[..., None]
    # the carry at the chunk's end
    Fe = F[..., -1]
    m_carry = torch.maximum(m + Fe, logw.max(dim=-1).values + Fe)
    c_scale = torch.exp(m + Fe - m_carry)
    kv_w = torch.exp(Fe[..., None] - F + ig - m_carry[..., None])
    C_new = (C * c_scale[..., None, None]
             + (k * kv_w[..., None]).transpose(-1, -2) @ v)
    n_new = nvec * c_scale[..., None] + (k * kv_w[..., None]).sum(dim=2)
    return h, (C_new, n_new, m_carry)


def mlstm_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                cache: Cache = None, mode: str = "train", cast: bool = True,
                esplit: Optional[EmbedSplit] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """The mLSTM: q, k (both scaled by dh^-0.5) and v in f32, input gate
    pre-activations ig and log forget gates lf = -softplus(-x·wf) in f32
    from compute-dtype operands, then ``_mlstm_chunk`` over chunks of
    ``mlstm_chunk`` tokens (train pads the last; the prefill needs a whole
    number of chunks), and decode as one chunk of length 1, its state
    written into the cache in place.  The heads are the weights' (a
    rank's on a mesh); ``cast=False`` returns y in the product's dtype;
    ``esplit`` as in ``self_attention``."""
    b, s, _ = x.shape
    h_, dh = p["wq"].shape[-2], cfg.head_dim_
    cd = _cdtype(cfg)
    f32 = torch.float32
    xc = x.to(cd)
    qkv = tuple(mmc(cfg, xc, p[n].to(cd)) for n in ("wq", "wk", "wv"))
    gates = tuple(project(xc, p[n].to(cd), f32) for n in ("wi", "wf"))
    if esplit is not None:
        summed = esplit.sum(*qkv, *gates)
        qkv, gates = summed[:3], summed[3:]

    def heads(t, scale=None):                  # (B, H, S, dh) in f32
        t = t.to(f32).transpose(1, 2)
        return t if scale is None else t * scale
    q = heads(qkv[0], dh ** -0.5)
    k = heads(qkv[1], dh ** -0.5)
    v = heads(qkv[2])
    ig = gates[0].transpose(1, 2)
    lf = -torch.nn.functional.softplus(-gates[1]).transpose(1, 2)
    use = (lambda t: t) if esplit is None else esplit.use

    if mode == "decode":
        carry = (cache["mC"], cache["mn"], cache["mm"])
        hout, (C, nvec, m) = _mlstm_chunk(q, k, v, ig, lf, carry)
        y = mmc(cfg, use(hout.transpose(1, 2).to(cd)), p["wo"].to(cd),
                contract=2)
        return (y.to(x.dtype) if cast else y), \
            _write(cache, {"mC": C, "mn": nvec, "mm": m})

    c = min(cfg.mlstm_chunk, s)
    pad = (-s) % c
    # the carry would include the pad steps: exact only when c divides s
    assert mode != "prefill" or pad == 0, \
        "prefill length must be a multiple of mlstm_chunk"
    if pad:
        q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (q, k, v))
        ig, lf = (torch.nn.functional.pad(t, (0, pad)) for t in (ig, lf))
    carry = (torch.zeros((b, h_, dh, dh), dtype=f32, device=x.device),
             torch.zeros((b, h_, dh), dtype=f32, device=x.device),
             torch.full((b, h_), _NEG, dtype=f32, device=x.device))
    hs = []
    for c0 in range(0, s + pad, c):
        sl = slice(c0, c0 + c)
        hout, carry = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                   ig[..., sl], lf[..., sl], carry)
        hs.append(hout)
    hout = torch.cat(hs, dim=2)[:, :, :s]
    y = mmc(cfg, use(hout.transpose(1, 2).to(cd)), p["wo"].to(cd),
            contract=2)
    new_cache = None
    if mode == "prefill":
        new_cache = {"mC": carry[0], "mn": carry[1], "mm": carry[2]}
    return (y.to(x.dtype) if cast else y), new_cache


def init_slstm(cfg: ModelConfig, generator: torch.Generator, device,
               lead: Tuple[int, ...] = ()) -> Params:
    """The gates' input projections (d, 4, H, dh) in z, i, f, o order,
    the per-head recurrent matrices (H, dh, 4, dh) and the output
    (H, dh, d)."""
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.head_dim_
    pd = _pdtype(cfg)

    def init(shape, fan_in):
        return dense_init(lead + shape, fan_in, pd, generator, device)
    return {"wx": init((d, 4, h, dh), d), "r": init((h, dh, 4, dh), dh),
            "wo": init((h, dh, d), h * dh)}


def init_slstm_cache(cfg: ModelConfig, batch: int, device
                     ) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_heads, cfg.head_dim_)

    def zero():
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return {"sc": zero(), "sn": zero(), "sh": zero(),
            "sm": torch.full(shape, _NEG, dtype=torch.float32,
                             device=device)}


def _slstm_step(rmat, state, gx):
    """One sLSTM step, heads first: rmat (H, dh, 4·dh) f32; state (c, n,
    h, m), each (H, B, dh); gx (H, B, 4·dh) the step's input projections
    (z, i, f, o).  The recurrent product and the input add are one
    ``baddbmm`` (f32 products and sums, one rounding each, as the JAX
    package's f32 einsum and add).  Returns the new state; its h is the
    step's output."""
    c, n, hprev, m = state
    g = torch.baddbmm(gx, hprev, rmat).unflatten(-1, (4, -1))
    z = torch.tanh(g[..., 0, :])
    i_t = g[..., 1, :]
    fm = g[..., 2, :] + m
    o = torch.sigmoid(g[..., 3, :])
    m_new = torch.maximum(fm, i_t)
    ip = torch.exp(i_t - m_new)
    fp = torch.exp(fm - m_new)
    c_new = torch.addcmul(fp * c, ip, z)
    n_new = torch.addcmul(ip, fp, n)
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return c_new, n_new, h_new, m_new


def slstm_block(cfg: ModelConfig, p: Params, x: torch.Tensor, *,
                cache: Cache = None, mode: str = "train", cast: bool = True,
                esplit: Optional[EmbedSplit] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """The sLSTM: the gates' input projections for every token in one
    product (f32 from compute-dtype operands), then one ``_slstm_step`` a
    token with the recurrent matrices in f32 (IEEE: the package turns
    TF32 off).  Decode takes one step and writes sc, sn, sh and sm into
    its cache in place.  The heads are the weights' (a rank's on a mesh);
    ``cast=False`` returns y in the product's dtype; ``esplit`` as in
    ``self_attention``."""
    b, s, _ = x.shape
    h_, dh = p["wx"].shape[-2], cfg.head_dim_
    cd = _cdtype(cfg)
    f32 = torch.float32
    # (B, S, 4, H, dh) -> (S, H, B, 4·dh): each step's slice contiguous
    gx = project(x.to(cd), p["wx"].to(cd), f32)
    if esplit is not None:
        gx, = esplit.sum(gx)
    gx = gx.permute(1, 3, 0, 2, 4).reshape(s, h_, b, 4 * dh)
    rmat = p["r"].to(f32).reshape(h_, dh, 4 * dh)

    if mode == "decode":                  # (B, H, dh) -> (H, B, dh) views
        state = tuple(cache[k].transpose(0, 1)
                      for k in ("sc", "sn", "sh", "sm"))
    else:
        z = torch.zeros((h_, b, dh), dtype=f32, device=x.device)
        state = (z, z, z, torch.full((h_, b, dh), _NEG, dtype=f32,
                                     device=x.device))
    hs = []
    for t in range(s):
        state = _slstm_step(rmat, state, gx[t])
        hs.append(state[2])
    hs = torch.stack(hs, dim=2).permute(1, 2, 0, 3)     # (B, S, H, dh)
    # decode's output product is f32 whatever matmul_out_dtype says, as
    # the JAX package's einsum32 there
    hs = hs.to(cd)
    if esplit is not None:
        hs = esplit.use(hs)
    y = project(hs, p["wo"].to(cd),
                f32 if mode == "decode" else _out_dtype(cfg), contract=2)
    if cast:
        y = y.to(x.dtype)
    if mode == "train":
        return y, None
    new = dict(zip(("sc", "sn", "sh", "sm"),
                   (t.transpose(0, 1).contiguous() for t in state)))
    return y, (_write(cache, new) if mode == "decode" else new)
