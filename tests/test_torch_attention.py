"""The port's attention (kernels/flash_attention) against the JAX package on
the CPU.

Inputs are made with numpy from a seed and go through both packages.  The
port's plain version (``flash_attention_plain``, what a CPU tensor runs)
and its second plain version (``flash_attention_windowed``) are held
against the JAX package's ``"blockwise"``, ``"windowed"`` and
``"pallas_interpret"`` backends and against ``mha_reference``, over the
sweep of tests/test_kernels.py plus head_dim 120 and GQA 4, and at head
dims 168 and 256 (gemma3-27b's and recurrentgemma-2b's): f32 within
atol 2e-5 and rtol 1e-4, bf16 within 3e-2 (compared in f32).  The CUDA
kernel is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py); its bf16 route rounds P to
bf16 before P·V, and the last test here emulates that rounding to show
that the card's bf16 bound, one bf16 rounding plus 2^-8·(Σ p·|v|)/l,
holds where a bound without the P term fails.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa
from repro.kernels.flash_attention.ref import attention_mask as j_mask
from repro.kernels.flash_attention.ref import mha_reference as j_mha
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     mha_reference)

torch.set_num_threads(1)

# (b, hq, hkv, sq, skv, d), kwargs: tests/test_kernels.py's sweep, then
# head_dim 120 with GQA 4 (h2o-danube-3-4b's heads), unaligned and windowed
SWEEP = [
    ((2, 4, 2, 64, 64, 32), dict(causal=True)),
    ((1, 4, 4, 128, 128, 32), dict(causal=True, window=32)),
    ((2, 8, 2, 96, 96, 16), dict(causal=False)),
    ((1, 2, 1, 64, 192, 32), dict(causal=True, kv_offset=128)),
    ((1, 8, 1, 80, 80, 64), dict(causal=True)),
    ((1, 8, 2, 67, 67, 120), dict(causal=True)),
    ((2, 8, 2, 96, 96, 120), dict(causal=True, window=40)),
]


def _qkv(shape, dtype=np.float32, seed=0):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, skv, d)).astype(np.float32)
    return q, k, v


def _close(got, want, bf16=False):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if bf16:
        np.testing.assert_allclose(got, want, atol=3e-2, rtol=3e-2)
    else:
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("shape,kw", SWEEP, ids=[str(s) for s, _ in SWEEP])
@pytest.mark.parametrize("backend", ["blockwise", "direct"])
def test_plain_matches_jax(shape, kw, backend):
    q, k, v = _qkv(shape)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), backend=backend, block_q=32,
                               block_k=32, **kw)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block_q=32, block_k=32,
                              **kw)
    _close(got.numpy(), want)


# head dims past 128: gemma3-27b's 168 (5376 / 32) and recurrentgemma-2b's
# 256, causal and windowed, with GQA
WIDE_HEADS = [
    ((1, 4, 2, 64, 64, 168), dict(causal=True)),
    ((1, 4, 1, 80, 80, 168), dict(causal=True, window=24)),
    ((1, 4, 2, 64, 64, 256), dict(causal=True)),
    ((1, 2, 1, 72, 72, 256), dict(causal=True, window=32)),
]


@pytest.mark.parametrize("shape,kw", WIDE_HEADS,
                         ids=[str(s) for s, _ in WIDE_HEADS])
def test_plain_matches_jax_past_head_dim_128(shape, kw):
    """The plain version (what the card's kernel is held to) against the
    JAX package's blockwise attention at D = 168 and 256."""
    q, k, v = _qkv(shape, seed=5)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), backend="blockwise",
                               block_q=32, block_k=32, **kw)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block_q=32, block_k=32,
                              **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape,kw", SWEEP, ids=[str(s) for s, _ in SWEEP])
def test_reference_matches_jax(shape, kw):
    q, k, v = _qkv(shape, seed=1)
    want = j_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    got = mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), **kw)
    _close(got.numpy(), want)
    b, hq, hkv, sq, skv, d = shape
    np.testing.assert_array_equal(
        attention_mask(sq, skv, kw.get("causal", True), kw.get("window"),
                       kw.get("kv_offset", 0)).numpy(),
        np.asarray(j_mask(sq, skv, kw.get("causal", True), kw.get("window"),
                          kw.get("kv_offset", 0))))


@pytest.mark.parametrize("shape,window", [((2, 4, 2, 128, 128, 32), 48),
                                          ((1, 8, 2, 100, 100, 120), 40)])
def test_windowed_matches_jax(shape, window):
    q, k, v = _qkv(shape, seed=2)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), backend="windowed",
                               causal=True, window=window, block_q=32)
    got = tfa.flash_attention_windowed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window=window, block_q=32)
    _close(got.numpy(), want)
    plain = tfa.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=window, block_q=32, block_k=32)
    _close(got.numpy(), plain.numpy())


@pytest.mark.parametrize("shape,kw", [SWEEP[0], SWEEP[5]],
                         ids=["gqa2_d32", "gqa4_d120"])
def test_plain_matches_the_pallas_kernel_interpreted(shape, kw):
    q, k, v = _qkv(shape, seed=3)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), backend="pallas_interpret",
                               block_q=32, block_k=128, **kw)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), block_q=32, block_k=128,
                              **kw)
    _close(got.numpy(), want)


@pytest.mark.parametrize("shape,kw", [SWEEP[0], SWEEP[6]],
                         ids=["causal", "window"])
def test_bf16_matches_jax(shape, kw):
    q, k, v = _qkv(shape, seed=4)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jfa.flash_attention(jq, jk, jv, backend="blockwise", block_q=32,
                               block_k=32, **kw)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk, tv, block_q=32, block_k=32, **kw)
    assert got.dtype == torch.bfloat16
    _close(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
           bf16=True)


def test_rows_with_no_visible_key_are_zero():
    """A query offset before the first key leaves the first rows with no
    visible key: 0, as the reference's acc / max(l, 1e-30) gives."""
    q, k, v = _qkv((1, 4, 2, 40, 40, 16), seed=5)
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), backend="blockwise",
                               causal=True, kv_offset=-8, block_q=16,
                               block_k=16)
    got = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, kv_offset=-8,
                              block_q=16, block_k=16)
    assert torch.all(got[:, :, :8] == 0.0)
    assert torch.isfinite(got).all()
    _close(got.numpy(), want)


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _qkv(SWEEP[1][0], seed=6))
    before = tfa.flash_attention.launches
    got = tfa.flash_attention(q, k, v, causal=True, window=32, block_q=32,
                              block_k=32)
    assert tfa.flash_attention.launches == before
    want = tfa.flash_attention_plain(q, k, v, causal=True, window=32,
                                     block_q=32, block_k=32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("make,error", [
    (lambda q, k, v: tfa.flash_attention(q, k[:, :, :, :8], v), ValueError),
    (lambda q, k, v: tfa.flash_attention(q[:, :3], k, v), ValueError),
    (lambda q, k, v: tfa.flash_attention(q[0], k[0], v[0]), ValueError),
])
def test_bad_shapes_raise(make, error):
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 4, 2, 8, 8, 16)))
    with pytest.raises(error):
        make(q, k, v)


def _kernel_rounding(q, k, v, *, causal=True, window=None, kv_offset=0,
                     block_k=128):
    """The plain recurrence rounded as the card's bf16 kernel rounds it:
    scores, m, l and the accumulator in f32 over key tiles of 128, P
    rounded to bf16 before P·V (l sums the unrounded P), the output
    rounded to bf16 once."""
    q, k, v = (x.to(torch.float32) for x in (q, k, v))
    sq, skv, d = q.shape[2], k.shape[2], q.shape[3]
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    rows = torch.arange(sq)[:, None] + kv_offset
    m = torch.full(q.shape[:3], -1e30)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    for t0 in range(0, skv, block_k):
        cols = torch.arange(t0, min(t0 + block_k, skv))[None, :]
        mask = torch.ones((sq, cols.shape[1]), dtype=torch.bool)
        if causal:
            mask &= cols <= rows
        if window is not None:
            mask &= cols > rows - window
        s = torch.einsum("bhqd,bhkd->bhqk", q, k[:, :, t0:t0 + block_k])
        s = torch.where(mask, s * d ** -0.5, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(torch.bfloat16).to(torch.float32),
            v[:, :, t0:t0 + block_k])
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(torch.bfloat16)


def _adversarial(case):
    """bf16 q, k, v and kwargs: v of cancelling signs (|want| near 0),
    one dominant key, and a query offset that leaves rows with no key."""
    rng = np.random.default_rng(7)
    b, hq, hkv, sq, skv, d = 1, 4, 2, 96, 200, 64
    q = rng.normal(size=(b, hq, sq, d)) * 2.0
    k = rng.normal(size=(b, hkv, skv, d))
    v = rng.normal(size=(b, hkv, skv, d))
    kw = dict(causal=False)
    if case == "cancelling":
        # key pairs a hair apart with v and -v: P·V nearly cancels, while
        # the pair's two probabilities round to bf16 differently
        k[:, :, 1::2] = k[:, :, 0::2] + 0.05 * rng.normal(
            size=(b, hkv, skv // 2, d))
        v = 64.0 * np.sign(rng.normal(size=(b, hkv, skv // 2, d)))
        v = np.stack([v, -v], axis=3).reshape(b, hkv, skv, d)
    elif case == "dominant":
        k[:, :, 37] = 6.0 * q[:, ::2].mean(axis=2)  # one key wins each row
    else:
        kw = dict(causal=True, kv_offset=-40, window=30)
    return tuple(torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                 for x in (q, k, v)), kw


@pytest.mark.parametrize("case", ["cancelling", "dominant", "no_key"])
def test_bf16_p_rounding_term_bounds_the_kernels_error(case):
    """The bf16 bound of tests/test_torch_cuda.py and chip_smoke.py: one
    bf16 rounding of the output (1e-3 + 2^-7·|want|) plus the rounding of
    P to bf16 before P·V, 2^-8·(Σ p·|v|)/l, computed as the plain version
    on |v|.  The kernel's rounding, emulated here, meets it on inputs
    built to break a bound without the P term."""
    (q, k, v), kw = _adversarial(case)
    want = tfa.flash_attention_plain(q, k, v, block_q=32, block_k=32, **kw)
    got = _kernel_rounding(q, k, v, **kw)
    pv_abs = tfa.flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                       block_q=32, block_k=32, **kw)
    diff = (got.float() - want.float()).abs()
    one_rounding = 1e-3 + 2.0 ** -7 * want.float().abs()
    assert bool((diff <= one_rounding + 2.0 ** -8 * pv_abs).all())
    if case == "cancelling":
        assert bool((diff > one_rounding).any())  # the P term is needed
    if case == "no_key":
        assert torch.all(got[:, :, :40] == 0) and torch.all(
            want[:, :, :40] == 0)
