"""The port's model stack (models/, configs/, interop.params_from_numpy)
against the JAX package on the CPU.

The JAX package's own parameters are carried across with
``params_from_numpy``, so both packages run the same model on the same
tokens (numpy, from a seed).  For the smoke configs of every attention
architecture (the VLM and the encoder-decoder with the same seeded aux in
both packages, and their cross-attention gates drawn non-zero first,
``torch_aux_inputs.with_gates``): prefill and 16 greedy decode steps give
logits within 1e-4 of max|logit|, the same greedy tokens, ``slot_pos``
bitwise and k/v (self and cross) and enc_out within 1e-5;
``per_example_loss`` within 1e-5 relative;
the configs equal field for field, apart from the documented drop
``attention_backend``, for all ten architectures (the recurrent ones,
recurrentgemma-2b and xlstm-350m, run against the JAX package in
tests/test_torch_recurrent.py).  gemma3-27b also at its head dimension,
168, in a reduced model of one 5:1 pattern group: the forward's logits
within 1e-4 of max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import decode_step as j_decode
from repro.models import forward_hidden as j_forward_hidden
from repro.models import init_params as j_init
from repro.models import logits_from_hidden as j_logits
from repro.models import per_example_loss as j_pel
from repro.models import prefill as j_prefill
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import (decode_step, forward_hidden, init_params,
                                init_serve_cache, logits_from_hidden,
                                num_params, per_example_loss, prefill)
from repro_torch.train import (make_decode_step, make_eval_step,
                               make_prefill_step)
from torch_aux_inputs import assert_gates_set, aux_for, with_gates

torch.set_num_threads(1)

PROMPT, GEN = 24, 16
#: the architectures without recurrent blocks: the 24-token prompt is not
#: a whole number of xlstm-350m's smoke mlstm_chunk (16), which its
#: prefill asserts; tests/test_torch_recurrent.py serves both recurrent
#: ones at 32 tokens
ATTENTION_ARCH_IDS = tuple(a for a in ARCH_IDS
                           if a not in ("recurrentgemma-2b", "xlstm-350m"))


def _models(arch, **overrides):
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **overrides)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **overrides)
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), jcfg))
    if cfg.vision_tokens or cfg.is_encdec:
        tree = with_gates(tree)
    params = params_from_numpy(tree, device="cpu")
    if cfg.vision_tokens or cfg.is_encdec:
        assert_gates_set(params)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, tree), cfg, params


def _aux(cfg, b):
    """The same seeded aux for both packages (None where a config reads
    none): (jax array, torch tensor)."""
    a = aux_for(cfg, b)
    return (None, None) if a is None else (jnp.asarray(a),
                                           torch.from_numpy(a))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _logits_close(got, want, vocab, rel=1e-4):
    got = got.numpy()[:, :vocab]
    want = np.asarray(want)[:, :vocab]
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale


def _caches_close(tc, jc):
    assert set(tc) == set(jc)
    for name in tc:
        if name == "enc_out":
            np.testing.assert_allclose(tc[name].numpy(),
                                       np.asarray(jc[name]), atol=1e-5,
                                       rtol=0)
            continue
        for i in tc[name]:
            t, j = tc[name][i]["attn"], jc[name][i]["attn"]
            np.testing.assert_array_equal(t["slot_pos"].numpy(),
                                          np.asarray(j["slot_pos"]))
            pairs = [(t, j)]
            if "xattn" in jc[name][i]:
                pairs.append((tc[name][i]["xattn"], jc[name][i]["xattn"]))
            for t, j in pairs:
                for kv in ("k", "v"):
                    np.testing.assert_allclose(t[kv].numpy(),
                                               np.asarray(j[kv]), atol=1e-5,
                                               rtol=0)


@pytest.mark.parametrize("arch", ATTENTION_ARCH_IDS)
def test_prefill_and_greedy_decode_match_jax(arch):
    jcfg, jparams, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, PROMPT)
    jaux, taux = _aux(cfg, 2)
    jl, jc = j_prefill(jcfg, jparams, jnp.asarray(toks), aux=jaux,
                       cache_len=PROMPT + GEN)
    batch = {"tokens": torch.from_numpy(toks)}
    if taux is not None:
        batch["aux"] = taux
    sl, _ = make_prefill_step(cfg)(params, batch)
    tl, tc = prefill(cfg, params, torch.from_numpy(toks), aux=taux,
                     cache_len=PROMPT + GEN)
    _logits_close(sl, jl, cfg.vocab)
    _logits_close(tl, jl, cfg.vocab)
    assert (tl[:, cfg.vocab:] <= -1e29).all()
    _caches_close(tc, jc)
    step = make_decode_step(cfg)
    for t in range(GEN):
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = j_decode(jcfg, jparams, jc, jnp.asarray(jtok),
                          jnp.int32(PROMPT + t))
        tl, tc = step(params, tc, ttok, PROMPT + t)
        _logits_close(tl, jl, cfg.vocab)
    _caches_close(tc, jc)


@pytest.mark.parametrize("arch", ATTENTION_ARCH_IDS)
def test_per_example_loss_matches_jax(arch):
    jcfg, jparams, cfg, params = _models(arch)
    docs = _tokens(cfg, 3, 41, seed=2)
    docs[1, 30:] = -1 + 0 * docs[1, 30:]      # padded labels are skipped
    tokens, labels = np.maximum(docs[:, :40], 0), docs[:, 1:]
    jaux, taux = _aux(cfg, 3)
    jb = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    tb = {"tokens": torch.from_numpy(tokens),
          "labels": torch.from_numpy(labels)}
    if taux is not None:
        jb["aux"], tb["aux"] = jaux, taux
    want = np.asarray(j_pel(jcfg, jparams, jb))
    got = make_eval_step(cfg)(params, tb)
    got2 = per_example_loss(cfg, params, tb)
    assert torch.equal(got, got2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_are_the_jax_configs(arch):
    for smoke in (False, True):
        want = dataclasses.asdict(j_get_config(arch, smoke=smoke))
        got = dataclasses.asdict(get_config(arch, smoke=smoke))
        assert want.pop("attention_backend") == "blockwise"
        assert got == want
        assert (get_config(arch, smoke=smoke).num_params()
                == j_get_config(arch, smoke=smoke).num_params())


def test_gemma3_at_head_dim_168_matches_jax():
    """gemma3-27b's head dimension, 5376 / 32 = 168, at 2 query heads on 1
    KV head, 6 layers (one 5:1 local:global pattern group, the smoke
    window 16 under a 40-token context): the full forward's logits within
    1e-4 of max|logit| of the JAX package's on its own parameters."""
    jcfg, jparams, cfg, params = _models(
        "gemma3-27b", n_layers=6, d_model=336, n_heads=2, n_kv_heads=1,
        head_dim=168, d_ff=256)
    assert cfg.head_dim_ == 168 and cfg.n_groups == 1
    assert cfg.layer_pattern.count("global") == 1
    toks = _tokens(cfg, 2, 40, seed=3)
    jh, _ = j_forward_hidden(jcfg, jparams, jnp.asarray(toks))
    want = j_logits(jcfg, jparams, jh)
    with torch.no_grad():
        h, _ = forward_hidden(cfg, params, torch.from_numpy(toks))
        got = logits_from_hidden(cfg, params, h)
    scale = np.abs(np.asarray(want)[..., :cfg.vocab]).max()
    err = np.abs(got.numpy()[..., :cfg.vocab]
                 - np.asarray(want)[..., :cfg.vocab]).max()
    assert err <= 1e-4 * scale


def test_every_architecture_resolves():
    """Every id of the JAX package's registry is ported and resolves, full
    and smoke, to its own config; an unknown id raises KeyError."""
    assert len(ARCH_IDS) == 10
    for arch in ARCH_IDS:
        for smoke in (False, True):
            assert get_config(arch, smoke=smoke).name == arch
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_decode_matches_teacher_forcing():
    """tests/test_models.py's check in the port: decode step t's logits
    equal the full forward's at position S + t, across the ring wrap (the
    smoke window is 16, the context 35)."""
    _, _, cfg, params = _models("h2o-danube-3-4b")
    B, S = 2, 32
    toks = torch.from_numpy(_tokens(cfg, B, S + 3, seed=3))
    h, _ = forward_hidden(cfg, params, toks, mode="train")
    full = logits_from_hidden(cfg, params, h)
    lg, cache = prefill(cfg, params, toks[:, :S], cache_len=S + 3)
    np.testing.assert_allclose(lg.numpy(), full[:, S - 1].numpy(),
                               atol=2e-4, rtol=1e-3)
    for t in range(3):
        lg, cache = decode_step(cfg, params, cache, toks[:, S + t:S + t + 1],
                                S + t)
        np.testing.assert_allclose(lg.numpy(), full[:, S + t].numpy(),
                                   atol=2e-4, rtol=1e-3)


def test_decode_step_writes_the_cache_in_place():
    """decode_step writes the new slot into the caches it is given and
    returns them (no copy of a layer's cache a step); a one-element
    position tensor gives the step of the int position."""
    _, _, cfg, params = _models("h2o-danube-3-4b")
    S = 20
    toks = torch.from_numpy(_tokens(cfg, 2, S + 1, seed=5))
    _, cache = prefill(cfg, params, toks[:, :S], cache_len=S + 1)
    _, twin = prefill(cfg, params, toks[:, :S], cache_len=S + 1)
    attn = cache["groups"]["0"]["attn"]
    k, v, slot_pos = attn["k"], attn["v"], attn["slot_pos"]
    L = k.shape[-2]
    lg, new = decode_step(cfg, params, cache, toks[:, S:], S)
    lg2, _ = decode_step(cfg, params, twin, toks[:, S:], torch.tensor([S]))
    got = new["groups"]["0"]["attn"]
    assert got["k"] is k and got["v"] is v and got["slot_pos"] is slot_pos
    assert bool((slot_pos[:, S % L] == S).all())
    assert torch.equal(lg, lg2)
    for name in ("k", "v"):
        assert torch.equal(got[name],
                           twin["groups"]["0"]["attn"][name])


def test_init_params_follows_the_jax_layout_and_law():
    jcfg, jparams, cfg, _ = _models("granite-3-2b")
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         device="cpu")
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jparams)

    def walk(t, j):
        if isinstance(t, dict):
            assert set(t) == set(j)
            for k in t:
                walk(t[k], j[k])
        else:
            assert tuple(t.shape) == j and t.dtype == torch.float32
    walk(params, shapes)
    emb = params["embedding"]
    assert torch.all(emb[cfg.vocab:] == 0.0)
    assert abs(float(emb[:cfg.vocab].std()) * cfg.d_model ** 0.5 - 1) < 0.05
    wq = params["groups"]["0"]["attn"]["wq"]
    assert abs(float(wq.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    assert torch.all(params["groups"]["0"]["attn_norm"] == 0.0)
    assert num_params(params)[0] == cfg.num_params()
    cache = init_serve_cache(cfg, 2, 40, device="cpu")
    assert cache["groups"]["0"]["attn"]["k"].shape == (
        cfg.n_groups, 2, cfg.n_kv_heads, 40, cfg.head_dim_)
    assert torch.all(cache["groups"]["0"]["attn"]["slot_pos"] == -1)


def test_params_from_numpy_carries_bf16_bitwise():
    """np.asarray of a bf16 JAX array is an ml_dtypes array that
    torch.from_numpy rejects; it crosses through a uint16 view."""
    jcfg, jparams, cfg, params = _models("h2o-danube-3-4b",
                                         param_dtype="bfloat16")
    wq = jparams["groups"]["0"]["attn"]["wq"]
    got = params["groups"]["0"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got.view(torch.int16).numpy().view(np.uint16),
        np.asarray(wq).view(np.uint16))
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(wq, np.float32))
    f32 = params_from_numpy({"a": np.arange(3, dtype=np.float32),
                             "b": {"c": np.arange(2, dtype=np.int32)}},
                            device="cpu")
    assert f32["a"].dtype == torch.float32
    assert f32["b"]["c"].dtype == torch.int32


def test_bf16_compute_matches_jax():
    """compute_dtype bf16 with f32 projection outputs (matmul_out_dtype):
    the port's f32 product of bf16-valued operands against the JAX
    package's preferred_element_type=f32, within bf16 rounding."""
    jcfg, jparams, cfg, params = _models("h2o-danube-3-4b",
                                         compute_dtype="bfloat16",
                                         param_dtype="bfloat16")
    toks = _tokens(cfg, 2, PROMPT, seed=4)
    jl, jc = j_prefill(jcfg, jparams, jnp.asarray(toks), cache_len=PROMPT)
    tl, tc = prefill(cfg, params, torch.from_numpy(toks), cache_len=PROMPT)
    _logits_close(tl, jl, cfg.vocab, rel=2e-2)
    np.testing.assert_array_equal(
        tc["groups"]["0"]["attn"]["slot_pos"].numpy(),
        np.asarray(jc["groups"]["0"]["attn"]["slot_pos"]))
