"""Blockwise (flash) attention with causal and sliding-window masks and GQA,
and its gradient.

``flash_attention`` takes q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D); the
Hq query heads share the Hkv key/value heads in groups of Hq / Hkv.  A
CUDA tensor launches the hand-written kernel (csrc/flash_attention.cu,
replacing the TPU kernel repro/kernels/flash_attention/kernel.py:
flash_attention_kernel) or raises; a CPU tensor runs the plain version,
``flash_attention_plain``: the JAX package's ``"blockwise"`` recurrence in
the same block order, with the same masks.  ``flash_attention_windowed``
is the JAX package's ``"windowed"`` path (causal, small windows), a second
plain version that no path of the port calls: it stays as the parity
oracle of the JAX package's ``"windowed"`` backend (its ``auto`` choice
for small windows).  ``ref.mha_reference`` is the direct oracle.

With a gradient required of q, k or v, the call is an autograd function:
the forward also gives each query row's log-sum-exp ``lse`` (f32,
(B·Hq, Sq), m + log l in natural units), saved for the backward, which
is a second hand-written kernel on the card (csrc/flash_attention_bwd.cu,
``flash_attention_backward_cuda``) and its plain version,
``flash_attention_backward_plain``, on the CPU.  No TPU kernel stands
behind the backward: XLA differentiates the JAX package's blockwise path.
Without a gradient (serving, evaluation, ``torch.no_grad()``) the call is
the single forward launch it always was, with no ``lse`` written.

The JAX package's ``backend=`` is dropped: the device decides.  The
kernel picks its own tiles, so ``block_q``/``block_k`` shape the plain
versions only; the results agree within f32 rounding (the running
maximum and sum see the keys in other groupings).  f64 inputs (on the
CPU, for ``torch.autograd.gradcheck``) run the plain versions in f64.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._pass import BWD_TC_BLOCK, BWD_TC_MAX_D, stream_ptr
from repro_torch.kernels.flash_attention.ref import NEG_INF

#: Largest head dimension the kernel takes (the bf16 route pads D to 256,
#: four 64-column TMA boxes, the widest wgmma N; the f32 route holds a
#: quarter of a 256-wide row in each of a row's four threads).
MAX_HEAD_DIM = 256
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _pad_axis(x: torch.Tensor, mult: int, axis: int) -> torch.Tensor:
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=axis)


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, "
                         f"D), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[1] % k.shape[1]):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"match: batch and D must agree and Hkv divide Hq")


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_plain_lse(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, *, causal: bool = True,
                              window: Optional[int] = None,
                              scale: Optional[float] = None,
                              kv_offset: int = 0, block_q: int = 512,
                              block_k: int = 512):
    """The JAX package's ``_blockwise``: for each (bq)-row query block, the
    running (m, l, acc) in f32 over every (bk)-key block in order.
    Returns the output in q's dtype and each query row's log-sum-exp,
    m + log(l) (f32, (B·Hq, Sq); -inf for a row that sees no key)."""
    _check_shapes(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    f = _acc_dtype(q)
    bq = min(block_q, max(sq, 1))
    bk = min(block_k, max(skv, 1))
    qp = _pad_axis(q, bq, 2)
    kp = _pad_axis(k, bk, 2)
    vp = _pad_axis(v, bk, 2)
    nq, nk = qp.shape[2] // bq, kp.shape[2] // bk
    qb = qp.reshape(b, hkv, group, nq, bq, d).to(f)
    kb = kp.reshape(b, hkv, nk, bk, d).to(f)
    vb = vp.reshape(b, hkv, nk, bk, d).to(f)
    dev = q.device
    out = torch.empty((b, hkv, group, nq, bq, d), dtype=f, device=dev)
    lse = torch.empty((b, hkv, group, nq, bq), dtype=f, device=dev)
    for qi in range(nq):
        qblk = qb[:, :, :, qi]
        rows = qi * bq + torch.arange(bq, device=dev)[:, None] + kv_offset
        m = torch.full((b, hkv, group, bq), NEG_INF, dtype=f, device=dev)
        l = torch.zeros((b, hkv, group, bq), dtype=f, device=dev)
        acc = torch.zeros((b, hkv, group, bq, d), dtype=f, device=dev)
        for kj in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kb[:, :, kj]) * scale
            mask = _visible(rows, kj * bk, bk, sq, skv, causal, window,
                            kv_offset)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            p = torch.where(mask, p, 0.0)
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb[:, :, kj])
            m = m_new
        out[:, :, :, qi] = acc / torch.clamp_min(l, 1e-30)[..., None]
        lse[:, :, :, qi] = m + torch.log(l)
    out = out.reshape(b, hq, nq * bq, d)[:, :, :sq]
    lse = lse.reshape(b * hq, nq * bq)[:, :sq]
    return out.to(q.dtype), lse


def _visible(rows, c0: int, bk: int, sq: int, skv: int, causal: bool,
             window: Optional[int], kv_offset: int) -> torch.Tensor:
    """(bq, bk) mask of the keys c0 .. c0 + bk - 1 that query rows ``rows``
    (absolute positions, (bq, 1)) see."""
    cols = c0 + torch.arange(bk, device=rows.device)[None, :]
    mask = (cols < skv) & (rows < sq + kv_offset)
    if causal:
        mask = mask & (cols <= rows)
    if window is not None:
        mask = mask & (cols > rows - window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True,
                          window: Optional[int] = None,
                          scale: Optional[float] = None, kv_offset: int = 0,
                          block_q: int = 512, block_k: int = 512
                          ) -> torch.Tensor:
    """``flash_attention_plain_lse``'s output alone."""
    return flash_attention_plain_lse(q, k, v, causal=causal, window=window,
                                     scale=scale, kv_offset=kv_offset,
                                     block_q=block_q, block_k=block_k)[0]


def flash_attention_backward_plain(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, o: torch.Tensor,
                                   lse: torch.Tensor, do: torch.Tensor, *,
                                   causal: bool = True,
                                   window: Optional[int] = None,
                                   scale: Optional[float] = None,
                                   kv_offset: int = 0, block_q: int = 512,
                                   block_k: int = 512):
    """(dq, dk, dv) of ``flash_attention`` given its output ``o``, its
    ``lse`` and the output's cotangent ``do``, in q's, k's and v's dtypes,
    with f32 accumulation (f64 for f64 inputs).  Δ = rowsum(dO ∘ O), and
    for each query block, each key block in order: P = exp(scale·q·kᵀ −
    lse) with masked entries 0, dS = P ∘ (dO·Vᵀ − Δ), dV += Pᵀ·dO,
    dK += scale·dSᵀ·Q, dQ += scale·dS·K.  A row that sees no key has
    P = 0 and gets zero gradients."""
    _check_shapes(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    f = _acc_dtype(q)
    bq = min(block_q, max(sq, 1))
    bk = min(block_k, max(skv, 1))
    nq = -(-sq // bq)
    nk = -(-skv // bk)

    def rows_of(x):
        return _pad_axis(x, bq, 2).reshape(b, hkv, group, nq, bq, -1).to(f)

    def keys_of(x):
        return _pad_axis(x, bk, 2).reshape(b, hkv, nk, bk, d).to(f)

    qb, ob, dob = rows_of(q), rows_of(o), rows_of(do)
    kb, vb = keys_of(k), keys_of(v)
    lseb = rows_of(lse.reshape(b, hq, sq, 1))[..., 0]
    delta = (dob * ob).sum(dim=-1)                   # (b, hkv, g, nq, bq)
    dq = torch.zeros_like(qb)
    dk = torch.zeros_like(kb)
    dv = torch.zeros_like(vb)
    dev = q.device
    for qi in range(nq):
        qblk, doblk = qb[:, :, :, qi], dob[:, :, :, qi]
        rows = qi * bq + torch.arange(bq, device=dev)[:, None] + kv_offset
        for kj in range(nk):
            s = torch.einsum("bhgqd,bhkd->bhgqk", qblk, kb[:, :, kj]) * scale
            mask = _visible(rows, kj * bk, bk, sq, skv, causal, window,
                            kv_offset)
            p = torch.where(mask, torch.exp(s - lseb[:, :, :, qi, :, None]),
                            0.0)
            dp = torch.einsum("bhgqd,bhkd->bhgqk", doblk, vb[:, :, kj])
            ds = p * (dp - delta[:, :, :, qi, :, None])
            dv[:, :, kj] += torch.einsum("bhgqk,bhgqd->bhkd", p, doblk)
            dk[:, :, kj] += torch.einsum("bhgqk,bhgqd->bhkd", ds,
                                         qblk) * scale
            dq[:, :, :, qi] += torch.einsum("bhgqk,bhkd->bhgqd", ds,
                                            kb[:, :, kj]) * scale
    dq = dq.reshape(b, hq, nq * bq, d)[:, :, :sq]
    dk = dk.reshape(b, hkv, nk * bk, d)[:, :, :skv]
    dv = dv.reshape(b, hkv, nk * bk, d)[:, :, :skv]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_windowed(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int,
                             scale: Optional[float] = None,
                             kv_offset: int = 0, block_q: int = 512
                             ) -> torch.Tensor:
    """The JAX package's ``_windowed`` (causal sliding window): query block
    i gathers only the ceil(W / bq) + 1 key blocks it can see and takes
    one masked softmax over them."""
    _check_shapes(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = d ** -0.5
    bq = min(block_q, max(sq, 1))
    nrel = -(-window // bq) + 1
    qp = _pad_axis(q, bq, 2)
    kp = _pad_axis(k, bq, 2)
    vp = _pad_axis(v, bq, 2)
    nq, nk = qp.shape[2] // bq, kp.shape[2] // bq
    qb = qp.reshape(b, hkv, group, nq, bq, d).to(torch.float32)
    kb = kp.reshape(b, hkv, nk, bq, d).to(torch.float32)
    vb = vp.reshape(b, hkv, nk, bq, d).to(torch.float32)
    dev = q.device
    ar = torch.arange(bq, device=dev)
    out = torch.empty((b, hkv, group, nq, bq, d), dtype=torch.float32,
                      device=dev)
    for qi in range(nq):
        rel = qi - torch.arange(nrel, device=dev).flip(0)
        relc = rel.clamp(0, nk - 1)
        kctx = kb[:, :, relc].reshape(b, hkv, nrel * bq, d)
        vctx = vb[:, :, relc].reshape(b, hkv, nrel * bq, d)
        s = torch.einsum("bhgqd,bhkd->bhgqk", qb[:, :, :, qi], kctx) * scale
        rows = qi * bq + ar[:, None] + kv_offset
        cols = (rel.repeat_interleave(bq) * bq + ar.repeat(nrel))[None, :]
        mask = ((rel >= 0).repeat_interleave(bq)[None, :]
                & (cols <= rows) & (cols > rows - window)
                & (cols < skv) & (rows < sq + kv_offset))
        s = torch.where(mask, s, NEG_INF)
        p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
        out[:, :, :, qi] = torch.einsum("bhgqk,bhkd->bhgqd", p, vctx)
    out = out.reshape(b, hq, nq * bq, d)[:, :, :sq]
    return out.to(q.dtype)


def _tma_ready(x: torch.Tensor) -> torch.Tensor:
    """x with rows TMA can read: D zero-padded to a multiple of 8 (16
    bytes of bf16) and a 16-byte aligned base."""
    x = _pad_axis(x.contiguous(), 8, 3)
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _check_cuda(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"the kernel takes float32 or bfloat16 q, k and v "
                         f"of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"head dimension {q.shape[3]} is past the kernel's "
                         f"MAX_HEAD_DIM = {MAX_HEAD_DIM}")


def _forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool, window: Optional[int], scale: float,
                  kv_offset: int, with_lse: bool):
    """Kernel 12's launch: (out, lse), lse (B·Hq, Sq) f32 when
    ``with_lse``, else None (a null pointer: nothing is written)."""
    _check_shapes(q, k, v)
    _check_cuda(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if q.dtype == torch.bfloat16:
        q3, k3, v3 = _tma_ready(q), _tma_ready(k), _tma_ready(v)
    else:
        q3, k3, v3 = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q3)
    lse = (torch.empty((b * hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out[..., :d], lse
    flash_attention.launches += 1
    _build.launch("flash_attention", _DTYPES[q.dtype], b * hq, hq, hkv, sq,
                  skv, q3.shape[3], float(scale), int(causal),
                  0 if window is None else int(window), int(kv_offset),
                  q3.data_ptr(), k3.data_ptr(), v3.data_ptr(),
                  out.data_ptr(), None if lse is None else lse.data_ptr(),
                  stream_ptr(q.device))
    return (out if out.shape[3] == d else out[..., :d].contiguous()), lse


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool, window: Optional[int],
                         scale: float, kv_offset: int) -> torch.Tensor:
    """Kernel 12 (csrc/flash_attention.cu) on the card: bf16 on the tensor
    cores (wgmma fed by TMA), f32 on the CUDA cores in IEEE f32."""
    return _forward_cuda(q, k, v, causal=causal, window=window, scale=scale,
                         kv_offset=kv_offset, with_lse=False)[0]


def flash_attention_backward_cuda(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor, o: torch.Tensor,
                                  lse: torch.Tensor, do: torch.Tensor, *,
                                  causal: bool, window: Optional[int],
                                  scale: float, kv_offset: int):
    """Kernel 12's backward (csrc/flash_attention_bwd.cu) on the card:
    (dq, dk, dv) in the inputs' dtype, in three launches of one call (Δ,
    then dK and dV, then dQ); counted once a call in
    ``flash_attention_backward_cuda.launches``.  bf16 up to head dim
    BWD_TC_MAX_D runs on the tensor cores (wgmma fed by TMA, P and dS
    rounded to bf16 before the products that take them, f32
    accumulation; D zero-padded to a multiple of 8 for TMA), also counted
    in ``.tc_launches``; f32, and bf16 past it, on the CUDA cores in IEEE
    f32."""
    _check_shapes(q, k, v)
    _check_cuda(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"o and do must be like q {tuple(q.shape)} "
                         f"{q.dtype}, got {tuple(o.shape)} {o.dtype} and "
                         f"{tuple(do.shape)}")
    if lse.shape != (b * hq, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be ({b * hq}, {sq}) float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    tc = q.dtype == torch.bfloat16 and d <= BWD_TC_MAX_D
    ready = _tma_ready if tc else torch.Tensor.contiguous
    q, k, v, o = (ready(t) for t in (q, k, v, o))
    do = ready(do.to(q.dtype))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or k.numel() == 0:
        return dq[..., :d].zero_(), dk[..., :d].zero_(), dv[..., :d].zero_()
    # the tensor-core route's scratch: lse₂ and Δ, each (B·Hq, Sq rounded
    # up to BWD_TC_BLOCK); the CUDA cores': Δ, (B·Hq, Sq)
    rows = -(-sq // BWD_TC_BLOCK) * BWD_TC_BLOCK
    delta = torch.empty((2, b * hq, rows) if tc else (b * hq, sq),
                        dtype=torch.float32, device=q.device)
    flash_attention_backward_cuda.launches += 1
    flash_attention_backward_cuda.tc_launches += int(tc)
    _build.launch("flash_attention_bwd", _DTYPES[q.dtype], b * hq, hq, hkv,
                  sq, skv, q.shape[3], float(scale), int(causal),
                  0 if window is None else int(window), int(kv_offset),
                  q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                  do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                  dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                  stream_ptr(q.device))
    if q.shape[3] == d:
        return dq, dk, dv
    return tuple(t[..., :d].contiguous() for t in (dq, dk, dv))


flash_attention_backward_cuda.launches = 0
flash_attention_backward_cuda.tc_launches = 0


class _Attention(torch.autograd.Function):
    """flash_attention with a gradient: the forward saves q, k, v, the
    output and lse; the backward is kernel 12's backward on the card and
    its plain version on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, kv_offset, block_q,
                block_k):
        kw = dict(causal=causal, window=window, scale=scale,
                  kv_offset=kv_offset)
        if q.device.type == "cuda":
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            out, lse = _forward_cuda(q, k, v, with_lse=True, **kw)
        else:
            out, lse = flash_attention_plain_lse(q, k, v, block_q=block_q,
                                                 block_k=block_k, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        ctx.blocks = dict(block_q=block_q, block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cuda":
            grads = flash_attention_backward_cuda(q, k, v, o, lse, do,
                                                  **ctx.kw)
        else:
            grads = flash_attention_backward_plain(q, k, v, o, lse, do,
                                                   **ctx.kw, **ctx.blocks)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None, kv_offset: int = 0,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D); GQA by head grouping.
    Output (B, Hq, Sq, D) in q's dtype; f32 accumulation throughout.
    ``block_q``/``block_k`` tile the plain versions on the CPU only; the
    kernels on the card pick their own tiles.  Differentiable in q, k
    and v (``_Attention``)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window, float(scale),
                                int(kv_offset), block_q, block_k)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=float(scale), kv_offset=kv_offset)
    return flash_attention_plain(q, k, v, causal=causal, window=window,
                                 scale=scale, kv_offset=kv_offset,
                                 block_q=block_q, block_k=block_k)


flash_attention.launches = 0
