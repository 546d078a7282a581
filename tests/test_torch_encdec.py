"""The port's cross-attention, encoder and ``xattn``/``enc``/``dec`` blocks
against the JAX package on the CPU: llama-3.2-vision-90b (gated
cross-attention to stub image embeddings every 5th layer) and
whisper-small (an encoder over stub audio frames, and ``dec`` layers that
cross-attend to its output).

The JAX package's parameters cross with ``params_from_numpy``.  Its
cross-attention gates start at zero, which would make every
cross-attention add nothing, so every test first draws each gate from
uniform [0.5, 1.0) with numpy (``with_gates``) in both packages' params
and checks that none is zero.  The aux inputs are seeded normal (B, Ta,
d_model) from numpy, as tests/test_models.py makes them.  The JAX side
runs its ``"blockwise"`` backend (and ``"direct"`` in the cross-attention's
decode), never Pallas-interpret.

Tolerances: cross-attention and block outputs within 1e-5·max|y| of the
JAX package's, prefill and decode logits within 1e-4·max|logit|, caches
(self K/V, xattn K/V, enc_out) within 1e-5·max|entry|, ``slot_pos``
bitwise, greedy tokens equal, ``per_example_loss`` within 1e-5 relative.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import blocks as j_blocks
from repro.models import decode_step as j_decode
from repro.models import decoder as j_decoder
from repro.models import init_params as j_init
from repro.models import init_serve_cache as j_init_cache
from repro.models import layers as j_layers
from repro.models import per_example_loss as j_pel
from repro.models import prefill as j_prefill
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import (decode_step, forward_hidden, init_params,
                                init_serve_cache, logits_from_hidden,
                                per_example_loss, prefill)
from repro_torch.models import blocks, decoder, layers
from torch_aux_inputs import (assert_gates_set, aux_for, gate_values,
                              with_gates)

torch.set_num_threads(1)

ARCHS = ("llama-3.2-vision-90b", "whisper-small")
#: the smoke configs with the aux length off the 16-row blocks
OFF_BLOCK = {"llama-3.2-vision-90b": dict(vision_tokens=21),
             "whisper-small": dict(enc_seq=37)}
PROMPT, GEN = 24, 6


# ---------------------------------------------------------------------------
# params of both packages
# ---------------------------------------------------------------------------
def models(arch, **overrides):
    """(jcfg, jparams, cfg, params): the JAX package's smoke params with
    the gates set, and the same params in the port."""
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    tree = with_gates(jax.tree_util.tree_map(
        np.asarray, j_init(jax.random.PRNGKey(0), jcfg)))
    params = params_from_numpy(tree, device="cpu")
    assert_gates_set(params)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, params


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.from_numpy(a)


def close(got, want, rel):
    """|got - want| within rel·max|want|."""
    want = np.asarray(want, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def caches_close(tc, jc):
    """Every leaf of the port's cache tree against the JAX package's:
    ``slot_pos`` bitwise, the rest within 1e-5·max|entry|."""
    assert set(tc) == set(jc)
    for k in tc:
        if isinstance(tc[k], dict):
            caches_close(tc[k], jc[k])
        elif k == "slot_pos":
            np.testing.assert_array_equal(tc[k].numpy(), np.asarray(jc[k]))
        else:
            assert tuple(tc[k].shape) == tuple(jc[k].shape)
            close(tc[k], jc[k], 1e-5)


# ---------------------------------------------------------------------------
# cross-attention alone
# ---------------------------------------------------------------------------
def _xattn_case(ta):
    """llama's smoke config (4 query heads on 2 KV heads of 16, 16-row
    blocks) with ``ta`` aux tokens; the JAX package's cross-attention params
    with the gate set, in both packages; x (2, 5, d) and aux (2, ta, d)."""
    jcfg = dataclasses.replace(j_get_config(ARCHS[0], smoke=True),
                               vision_tokens=ta)
    cfg = dataclasses.replace(get_config(ARCHS[0], smoke=True),
                              vision_tokens=ta)
    assert cfg.n_heads // cfg.n_kv_heads == 2 and cfg.attn_block_k == 16
    tree = with_gates(jax.tree_util.tree_map(
        np.asarray, j_layers.init_cross_attention(jax.random.PRNGKey(3),
                                                  jcfg)))
    rng = np.random.default_rng(ta)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    aux = rng.standard_normal((2, ta, cfg.d_model)).astype(np.float32)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg,
            params_from_numpy(tree, device="cpu"), x, aux)


@pytest.mark.parametrize("ta", [13, 37])
def test_cross_attention_matches_jax(ta):
    """Train, prefill and decode with GQA 2 and Ta off the 16-row block:
    outputs within 1e-5·max|y|; the prefill's K/V cache within 1e-5 of the
    JAX package's, and the decode's the cache it was given."""
    jcfg, jp, cfg, p, x, aux = _xattn_case(ta)
    assert_gates_set(p)
    jy, jc = j_layers.cross_attention(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(aux), mode="train")
    y, c = layers.cross_attention(cfg, p, torch.from_numpy(x),
                                  torch.from_numpy(aux), mode="train")
    assert c is None and jc is None
    close(y, jy, 1e-5)
    jy, jc = j_layers.cross_attention(jcfg, jp, jnp.asarray(x),
                                      jnp.asarray(aux), mode="prefill")
    y, c = layers.cross_attention(cfg, p, torch.from_numpy(x),
                                  torch.from_numpy(aux), mode="prefill")
    close(y, jy, 1e-5)
    caches_close(c, jc)
    assert c["k"].shape == (2, cfg.n_kv_heads, ta, cfg.head_dim_)
    x1 = x[:, :1]
    jy, jc2 = j_layers.cross_attention(jcfg, jp, jnp.asarray(x1), None,
                                       cache=jc, mode="decode")
    y, c2 = layers.cross_attention(cfg, p, torch.from_numpy(x1), None,
                                   cache=c, mode="decode")
    close(y, jy, 1e-5)
    assert c2["k"] is c["k"] and c2["v"] is c["v"]
    caches_close(c2, jc2)


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_cross_attention_fails_the_parity_check(arch, monkeypatch):
    """A mutation: the port's cross-attention made to return zeros (what a
    zero gate gives, and what a kernel that wrote nothing would pass with)
    while the gates are set fails the prefill and decode parity check of
    ``test_prefill_and_greedy_decode_match_jax``; and a zero gate makes
    the layer add exactly nothing."""
    real = layers.cross_attention

    def zero_output(cfg, p, x, aux, cache=None, mode="train"):
        y, c = real(cfg, p, x, aux, cache=cache, mode=mode)
        return torch.zeros_like(y), c
    monkeypatch.setattr(layers, "cross_attention", zero_output)
    with pytest.raises(AssertionError):
        prefill_and_decode_match_jax(arch, {})
    monkeypatch.undo()

    _, _, cfg, p, x, aux = _xattn_case(13)
    p0 = dict(p, gate=torch.zeros_like(p["gate"]))
    y0, _ = layers.cross_attention(cfg, p0, torch.from_numpy(x),
                                   torch.from_numpy(aux), mode="prefill")
    assert torch.equal(y0, torch.zeros_like(y0))
    with pytest.raises(AssertionError):
        assert_gates_set({"xattn": p0})


# ---------------------------------------------------------------------------
# blocks and the encoder
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["xattn", "enc", "dec"])
def test_apply_block_matches_jax(kind):
    """One block of each new kind in train and prefill mode (x (2, 20, d);
    aux (2, 13, d) for the cross-attending kinds), then one decode step
    from the prefill's cache: outputs within 1e-5·max|y|, caches within
    1e-5."""
    arch = ARCHS[0] if kind == "xattn" else ARCHS[1]
    over = dict(vision_tokens=13) if kind == "xattn" else dict(enc_seq=13)
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **over)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **over)
    tree = with_gates(jax.tree_util.tree_map(
        np.asarray, j_blocks.init_block(jax.random.PRNGKey(4), jcfg, kind)))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    p = params_from_numpy(tree, device="cpu")
    if kind != "enc":
        assert_gates_set(p)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    aux = (rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
           if kind != "enc" else None)
    pos = np.arange(20)
    for mode in ("train", "prefill"):
        jy, jc = j_blocks.apply_block(
            jcfg, kind, jp, jnp.asarray(x), positions=jnp.asarray(pos),
            cache=None, aux=_j(aux), mode=mode, cache_len=24)
        y, c = blocks.apply_block(
            cfg, kind, p, torch.from_numpy(x),
            positions=torch.from_numpy(pos), cache=None, aux=_t(aux),
            mode=mode, cache_len=24)
        close(y, jy, 1e-5)
        if mode == "train":
            assert c is None and jc is None
        else:
            caches_close(c, jc)
    if kind == "enc":
        return
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    jy, jc = j_blocks.apply_block(
        jcfg, kind, jp, jnp.asarray(x1), positions=jnp.asarray([20]),
        cache=jc, aux=None, mode="decode")
    y, c = blocks.apply_block(
        cfg, kind, p, torch.from_numpy(x1), positions=torch.tensor([20]),
        cache=c, aux=None, mode="decode")
    close(y, jy, 1e-5)
    caches_close(c, jc)


def test_enc_block_is_not_causal():
    """The encoder's self-attention sees every frame: a change to the last
    frame moves the first frame's output."""
    cfg = get_config(ARCHS[1], smoke=True)
    p = blocks.init_block(cfg, "enc", torch.Generator().manual_seed(1),
                          "cpu")
    x = torch.randn(1, 9, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    pos = torch.arange(9)
    y, _ = blocks.apply_block(cfg, "enc", p, x, positions=pos, cache=None,
                              mode="train")
    x2 = x.clone()
    x2[:, -1] += 1.0
    y2, _ = blocks.apply_block(cfg, "enc", p, x2, positions=pos, cache=None,
                               mode="train")
    assert not torch.allclose(y[:, 0], y2[:, 0])


@pytest.mark.parametrize("enc_seq", [16, 37])
def test_encode_matches_jax(enc_seq):
    jcfg, jp, cfg, p = models(ARCHS[1], enc_seq=enc_seq)
    aux = aux_for(cfg, 2)
    want = j_decoder.encode(jcfg, jp, jnp.asarray(aux))
    got = decoder.encode(cfg, p, torch.from_numpy(aux))
    assert got.shape == (2, enc_seq, cfg.d_model)
    close(got, want, 1e-5)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
_CASES = [(a, {}) for a in ARCHS] + [(a, OFF_BLOCK[a]) for a in ARCHS]


@pytest.mark.parametrize("arch,over", _CASES,
                         ids=[f"{a}-{'off' if o else 'smoke'}"
                              for a, o in _CASES])
def test_prefill_and_greedy_decode_match_jax(arch, over):
    """Prefill logits within 1e-4·max|logit|, every cache leaf (self K/V
    and slot_pos, xattn K/V, enc_out) as ``caches_close`` holds them, and
    GEN greedy decode steps with equal tokens and logits."""
    prefill_and_decode_match_jax(arch, over)


def prefill_and_decode_match_jax(arch, over):
    """The checks of ``test_prefill_and_greedy_decode_match_jax``."""
    jcfg, jp, cfg, p = models(arch, **over)
    toks, aux = _tokens(cfg, 2, PROMPT), aux_for(cfg, 2)
    jl, jc = j_prefill(jcfg, jp, jnp.asarray(toks), aux=jnp.asarray(aux),
                       cache_len=PROMPT + GEN)
    tl, tc = prefill(cfg, p, torch.from_numpy(toks),
                     aux=torch.from_numpy(aux), cache_len=PROMPT + GEN)
    close(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab], 1e-4)
    caches_close(tc, jc)
    for t in range(GEN):
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = j_decode(jcfg, jp, jc, jnp.asarray(jtok),
                          jnp.int32(PROMPT + t))
        tl, tc = decode_step(cfg, p, tc, ttok, PROMPT + t)
        close(tl[:, :cfg.vocab], np.asarray(jl)[:, :cfg.vocab], 1e-4)
    caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_example_loss_matches_jax(arch):
    jcfg, jp, cfg, p = models(arch, **OFF_BLOCK[arch])
    docs = _tokens(cfg, 3, 21, seed=2)
    docs[1, 15:] = -1                      # padded labels are skipped
    batch = {"tokens": np.maximum(docs[:, :20], 0), "labels": docs[:, 1:],
             "aux": aux_for(cfg, 3)}
    want = np.asarray(j_pel(jcfg, jp, {k: jnp.asarray(v)
                                       for k, v in batch.items()}))
    got = per_example_loss(cfg, p, {k: torch.from_numpy(v)
                                    for k, v in batch.items()})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Decode step t's logits equal the full forward's at position S + t,
    both reading the same aux."""
    _, _, cfg, p = models(arch, **OFF_BLOCK[arch])
    B, S = 2, 20
    toks = torch.from_numpy(_tokens(cfg, B, S + 3, seed=3))
    aux = torch.from_numpy(aux_for(cfg, B))
    h, _ = forward_hidden(cfg, p, toks, aux=aux, mode="train")
    full = logits_from_hidden(cfg, p, h)
    lg, cache = prefill(cfg, p, toks[:, :S], aux=aux, cache_len=S + 3)
    np.testing.assert_allclose(lg.numpy(), full[:, S - 1].numpy(),
                               atol=2e-4, rtol=1e-3)
    for t in range(3):
        lg, cache = decode_step(cfg, p, cache, toks[:, S + t:S + t + 1],
                                S + t)
        np.testing.assert_allclose(lg.numpy(), full[:, S + t].numpy(),
                                   atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_follows_the_jax_layout(arch):
    """init_params and init_serve_cache: the JAX package's tree, shapes and
    dtypes (a gate of shape () a layer, stacked on n_groups; the encoder's
    blocks stacked on enc_layers), every gate zero."""
    jcfg = j_get_config(arch, smoke=True)
    cfg = get_config(arch, smoke=True)
    jshapes = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         device="cpu")
    jcache = jax.eval_shape(lambda: j_init_cache(jcfg, 2, 40))
    cache = init_serve_cache(cfg, 2, 40, device="cpu")

    def walk(t, j):
        if isinstance(t, dict):
            assert set(t) == set(j)
            for k in t:
                walk(t[k], j[k])
        else:
            assert tuple(t.shape) == tuple(j.shape)
            assert str(t.dtype).replace("torch.", "") == str(j.dtype)
    walk(params, jshapes)
    walk(cache, jcache)
    gates = gate_values(params)
    assert len(gates) == cfg.n_groups and all(g == 0.0 for g in gates)
    assert params["groups"]["0" if arch == ARCHS[1] else "4"]["xattn"][
        "gate"].shape == (cfg.n_groups,)
    if cfg.is_encdec:
        assert params["encoder"]["groups"]["0"]["attn"]["wq"].shape[0] == (
            cfg.enc_layers)
        assert cache["enc_out"].shape == (2, cfg.enc_seq, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_num_params_leaves_out_the_uncounted_leaves(arch):
    """The reference's analytic ``num_params`` leaves out each gate, and
    for ``dec`` layers each x_norm and the encoder's final norm: the leaves
    counted on the params exceed it by exactly those
    (``ModelConfig.uncounted_params``)."""
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, device="cpu")
    count = decoder.num_params(params)[0]
    assert count == cfg.num_params() + cfg.uncounted_params()
    assert cfg.uncounted_params() == (2 if arch == ARCHS[0] else 194)
