"""The port's recurrent blocks (RG-LRU, mLSTM, sLSTM) and the two configs
that use them, recurrentgemma-2b and xlstm-350m, against the JAX package
on the CPU.

The JAX package's parameters cross with ``params_from_numpy``; inputs
are seeded from numpy.  The JAX side runs under ``jax.jit`` (its configs are
static), which compiles each function once instead of dispatching op by
op.  Tolerances, each stated where it is used:
block outputs within 1e-5·max|y| of the JAX package's and every cache
leaf within 1e-5·max(1, max|leaf|); the smoke models' logits within
1e-4·max|logit| with the same greedy tokens, and every cache leaf within
1e-4·max(1, max|leaf|) after the prefill and after 8 decode steps;
``per_example_loss`` within 1e-5 relative; in bf16 compute, the logits
and every cache leaf within half the JAX package's own distance between
its bf16 and f32 compute of the same quantity.  The doubling scan is held
against an f64 sequential loop within (3·levels + 2)·2^-24 of the loop
run on |a| and |b|: its f32 order is neither JAX's nor a loop's.
"""
import contextlib
import copy
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import blocks as j_blocks
from repro.models import decode_step as j_decode_step
from repro.models import init_params as j_init_params
from repro.models import layers as j_layers
from repro.models import per_example_loss as j_per_example_loss
from repro.models import prefill as j_prefill_step
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import (decode_step, forward_hidden, init_params,
                                init_serve_cache, logits_from_hidden,
                                num_params, per_example_loss, prefill)
from repro_torch.models import blocks, layers

torch.set_num_threads(1)

ARCHS = ("recurrentgemma-2b", "xlstm-350m")
ARCH_OF = {"rglru": ARCHS[0], "mlstm": ARCHS[1], "slstm": ARCHS[1]}
#: every recurrent cache leaf, by kind
LEAVES = {"rglru": ("lru", "conv_state"), "mlstm": ("mC", "mn", "mm"),
          "slstm": ("sc", "sn", "sh", "sm")}
#: a multiple of the smoke mlstm_chunk (16); the mLSTM trains off it
#: (padded)
PROMPT, TRAIN_S, GEN = 32, 27, 8

j_apply_block = jax.jit(j_blocks.apply_block, static_argnums=(0, 1),
                        static_argnames=("mode",))
j_init = jax.jit(j_init_params, static_argnums=(1,))
j_prefill = jax.jit(j_prefill_step, static_argnums=(0,),
                    static_argnames=("cache_len",))
j_decode = jax.jit(j_decode_step, static_argnums=(0,))
j_pel = jax.jit(j_per_example_loss, static_argnums=(0,))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaf_close(got, want, rel, what):
    want = np.asarray(want)
    bound = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got.numpy() - want).max())
    assert err <= bound, f"{what}: max |err| {err} over {bound}"


def _tree_close(got, want, rel, path=""):
    """Every leaf of two cache trees (port, JAX): the same keys, integer
    leaves bitwise, float leaves within rel·max(1, max|leaf|)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _tree_close(got[k], want[k], rel, f"{path}/{k}")
        return
    if got.dtype in (torch.int32, torch.int64):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        _leaf_close(got, want, rel, path)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------
_BLOCKS = {}


def _block(kind):
    """(jcfg, jparams, cfg, params) of one block of ``kind`` from the JAX
    package's init, made once a module."""
    if kind not in _BLOCKS:
        cfg = get_config(ARCH_OF[kind], smoke=True)
        jcfg = j_get_config(ARCH_OF[kind], smoke=True)
        tree = _np_tree(j_blocks.init_block(jax.random.PRNGKey(3), jcfg,
                                            kind))
        _BLOCKS[kind] = (jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                         cfg, params_from_numpy(tree, device="cpu"))
    return _BLOCKS[kind]


def _x(cfg, s, seed):
    return np.random.default_rng(seed).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)


def _apply(pkg, cfg, kind, p, x, mode, cache=None, pos=0):
    s = x.shape[1]
    if pkg == "jax":
        return j_apply_block(cfg, kind, p, jnp.asarray(x),
                             positions=jnp.arange(pos, pos + s),
                             cache=cache, aux=None, mode=mode)
    with torch.no_grad():
        return blocks.apply_block(
            cfg, kind, p, torch.from_numpy(x),
            positions=torch.arange(pos, pos + s), cache=cache, mode=mode)


def _y_close(got, want):
    """A block's output within 1e-5·max|y| of the JAX package's."""
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("kind", ["rglru", "mlstm", "slstm"])
def test_block_matches_jax(kind, mode):
    """One block (norm, cell, and the MLP where d_ff) on seeded inputs:
    train over 32 tokens (the mLSTM over 27, padding its last chunk),
    prefill over 32
    with every cache leaf, and decode as 3 steps from that prefill's
    cache, each step's output and cache."""
    jcfg, jp, cfg, p = _block(kind)
    if mode == "train":
        x = _x(cfg, TRAIN_S if kind == "mlstm" else PROMPT, 1)
        want, jc = _apply("jax", jcfg, kind, jp, x, "train")
        got, tc = _apply("torch", cfg, kind, p, x, "train")
        assert jc is None and tc is None
        _y_close(got, want)
        return
    x = _x(cfg, PROMPT, 2)
    want, jc = _apply("jax", jcfg, kind, jp, x, "prefill")
    got, tc = _apply("torch", cfg, kind, p, x, "prefill")
    _y_close(got, want)
    assert set(tc["cell"]) == set(LEAVES[kind])
    _tree_close(tc, _np_tree(jc), 1e-5)
    if mode == "decode":
        for t in range(3):
            x1 = _x(cfg, 1, 10 + t)
            want, jc = _apply("jax", jcfg, kind, jp, x1, "decode", jc,
                              PROMPT + t)
            got, tc = _apply("torch", cfg, kind, p, x1, "decode", tc,
                             PROMPT + t)
            _y_close(got, want)
            _tree_close(tc, _np_tree(jc), 1e-5)


@pytest.mark.parametrize("s", [32, 37])
def test_linear_scan_matches_a_sequential_f64_loop(s):
    """h_t = a_t·h_(t-1) + b_t at S a power of two and not, a in (0.5, 1):
    within (3·levels + 2)·2^-24 of the f64 loop on |a|, |b| (the
    doubling scan's rounding grows with its ceil(log2 S) levels)."""
    rng = np.random.default_rng(s)
    a = rng.uniform(0.5, 1.0, size=(2, s, 8)).astype(np.float32)
    b = rng.normal(size=(2, s, 8)).astype(np.float32)
    got = layers.linear_scan(torch.from_numpy(a), torch.from_numpy(b))

    def loop(a, b):
        h, out = np.zeros_like(a[:, 0], np.float64), []
        for t in range(a.shape[1]):
            h = a[:, t].astype(np.float64) * h + b[:, t]
            out.append(h)
        return np.stack(out, 1)
    want = loop(a, b)
    mag = loop(np.abs(a), np.abs(b))
    levels = math.ceil(math.log2(s))
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= (3 * levels + 2) * 2.0 ** -24 * mag).all()
    assert got.dtype == torch.float32 and got.shape == (2, s, 8)


def test_mlstm_prefill_off_the_chunk_raises_as_the_reference():
    """A 24-token prompt is not a whole number of the smoke mlstm_chunk
    (16): the prefill asserts in both packages, with the same message;
    train pads instead."""
    jcfg, jp, cfg, p = _block("mlstm")
    x = _x(cfg, 24, 4)
    msg = "prefill length must be a multiple of mlstm_chunk"
    with pytest.raises(AssertionError, match=msg):
        j_layers.mlstm_block(jcfg, jp["cell"], jnp.asarray(x),
                             mode="prefill")
    with pytest.raises(AssertionError, match=msg):
        layers.mlstm_block(cfg, p["cell"], torch.from_numpy(x),
                           mode="prefill")
    y, _ = layers.mlstm_block(cfg, p["cell"], torch.from_numpy(x))
    assert y.shape == x.shape


# ---------------------------------------------------------------------------
# the smoke models
# ---------------------------------------------------------------------------
_MODELS = {}


def _models(arch):
    """(jcfg, jparams, cfg, params) from the JAX package's seed-0 params,
    made once a module."""
    if arch not in _MODELS:
        jcfg = j_get_config(arch, smoke=True)
        tree = _np_tree(j_init(jax.random.PRNGKey(0), jcfg))
        _MODELS[arch] = (jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                         get_config(arch, smoke=True),
                         params_from_numpy(tree, device="cpu"))
    return _MODELS[arch]


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s)).astype(np.int32)


def _logits_close(got, want, vocab):
    want = np.asarray(want)[:, :vocab]
    err = np.abs(got.numpy()[:, :vocab] - want).max()
    assert err <= 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_greedy_decode_match_jax(arch):
    jcfg, jparams, cfg, params = _models(arch)
    toks = _tokens(cfg, 2, PROMPT)
    jl, jc = j_prefill(jcfg, jparams, jnp.asarray(toks),
                       cache_len=PROMPT + GEN)
    with torch.no_grad():
        tl, tc = prefill(cfg, params, torch.from_numpy(toks),
                         cache_len=PROMPT + GEN)
    _logits_close(tl, jl, cfg.vocab)
    assert (tl[:, cfg.vocab:] <= -1e29).all()
    _tree_close(tc, _np_tree(jc), 1e-4)
    for t in range(GEN):
        jtok = np.asarray(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        ttok = torch.argmax(tl, -1)[:, None]
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        jl, jc = j_decode(jcfg, jparams, jc, jnp.asarray(jtok),
                          jnp.int32(PROMPT + t))
        with torch.no_grad():
            tl, tc = decode_step(cfg, params, tc, ttok, PROMPT + t)
        _logits_close(tl, jl, cfg.vocab)
    _tree_close(tc, _np_tree(jc), 1e-4)


#: XLA keeps every bf16 rounding the program writes: by default it may run
#: a fused chain of bf16 operations in f32 and round once, which moves the
#: smoke models' bf16 logits about as far as bf16 itself does
_AS_WRITTEN = {"xla_allow_excess_precision": False}
j_prefill_as_written = jax.jit(j_prefill_step, static_argnums=(0,),
                               static_argnames=("cache_len",),
                               compiler_options=_AS_WRITTEN)
j_decode_as_written = jax.jit(j_decode_step, static_argnums=(0,),
                              compiler_options=_AS_WRITTEN)
#: the decode steps of the bf16 comparison, fed seeded tokens
FED = 3


@contextlib.contextmanager
def _f32_dot_operands():
    """The JAX package's ``einsum32`` given f32 operands: XLA's CPU runtime
    has no BF16 x BF16 = F32 dot for the mLSTM's gate layout
    ("bsd,dh->bhs").  A product of two bf16 values is exact in f32, so the
    products are the same and the sums f32 as before."""
    own = j_layers.einsum32
    j_layers.einsum32 = lambda spec, *a: jnp.einsum(
        spec, *(t.astype(jnp.float32) for t in a),
        preferred_element_type=jnp.float32)
    try:
        yield
    finally:
        j_layers.einsum32 = own


def _served(arch, pkg, dtype):
    """The smoke model in ``dtype`` compute: a prefill of PROMPT seeded
    tokens and FED decode steps fed seeded tokens; per call, the logits
    and {path: (dtype, f32 values)} of every recurrent cache leaf."""
    jcfg, jparams, cfg, params = _models(arch)
    jcfg = dataclasses.replace(jcfg, compute_dtype=dtype)
    cfg = dataclasses.replace(cfg, compute_dtype=dtype)
    toks, fed = _tokens(cfg, 2, PROMPT), _tokens(cfg, 2, FED, seed=9)
    out = []
    if pkg == "jax":
        pre, dec = ((j_prefill_as_written, j_decode_as_written)
                    if dtype == "bfloat16" else (j_prefill, j_decode))
        with _f32_dot_operands():
            lg, c = pre(jcfg, jparams, jnp.asarray(toks),
                        cache_len=PROMPT + GEN)
            out.append((lg, c))
            for t in range(FED):
                lg, c = dec(jcfg, jparams, c, jnp.asarray(fed[:, t:t + 1]),
                            jnp.int32(PROMPT + t))
                out.append((lg, c))
        return [(np.asarray(lg, np.float32)[:, :cfg.vocab],
                 {k: (str(t.dtype), np.asarray(t, np.float32))
                  for k, t in _cell_leaves(c)}) for lg, c in out]
    with torch.no_grad():
        lg, c = prefill(cfg, params, torch.from_numpy(toks),
                        cache_len=PROMPT + GEN)
        for t in range(FED + 1):
            # decode writes the cache in place: each call's leaves copied
            out.append((lg.float().numpy()[:, :cfg.vocab],
                        {k: (str(v.dtype).replace("torch.", ""),
                             v.float().numpy().copy())
                         for k, v in _cell_leaves(c)}))
            if t < FED:
                lg, c = decode_step(cfg, params, c,
                                    torch.from_numpy(fed[:, t:t + 1]),
                                    PROMPT + t)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_compute_matches_jax(arch):
    """bf16 compute, the dtype the models are served in: the prefill's and
    FED decode steps' logits, and after each every recurrent cache leaf
    (its dtype the JAX package's), against the JAX package's on the same
    params and tokens, XLA keeping each bf16 rounding as written; each
    within half of the JAX package's own distance between its bf16 and its
    f32 compute of the same quantity (the logits over all calls, each leaf
    at each call).  The port rounds where the JAX package's program does,
    so what is left is the f32 order of its products, and the bf16
    roundings it flips: a rounding added or dropped (gates or a state in
    bf16, the sLSTM's recurrent matrices in bf16) moves the result by
    about bf16's own distance."""
    want32 = _served(arch, "jax", "float32")
    want = _served(arch, "jax", "bfloat16")
    got = _served(arch, "torch", "bfloat16")
    drift = max(float(np.abs(w[0] - w32[0]).max())
                for w, w32 in zip(want, want32))
    err = max(float(np.abs(g[0] - w[0]).max()) for g, w in zip(got, want))
    scale = max(float(np.abs(w[0]).max()) for w in want32)
    print(f"{arch} in bf16: the JAX package's bf16 logits lie {drift / scale}"
          f" of max|logit| from its f32 ones, the port's {err / scale} from "
          f"its bf16 ones")
    assert drift > 0 and err <= 0.5 * drift
    for i, (g, w, w32) in enumerate(zip(got, want, want32)):
        assert set(g[1]) == set(w[1])
        for path, (dtype, t) in w[1].items():
            assert g[1][path][0] == dtype, (i, path)
            d = float(np.abs(t - w32[1][path][1]).max())
            e = float(np.abs(g[1][path][1] - t).max())
            assert e <= 0.5 * d, (i, path, e, d)


@pytest.mark.parametrize("arch", ARCHS)
def test_per_example_loss_matches_jax(arch):
    """Train mode over 40 tokens (the mLSTM pads its last chunk), with
    padded labels skipped."""
    jcfg, jparams, cfg, params = _models(arch)
    docs = _tokens(cfg, 3, 41, seed=2)
    docs[1, 30:] = -1
    tokens, labels = np.maximum(docs[:, :40], 0), docs[:, 1:]
    want = np.asarray(j_pel(jcfg, jparams, {"tokens": jnp.asarray(tokens),
                                            "labels": jnp.asarray(labels)}))
    with torch.no_grad():
        got = per_example_loss(cfg, params,
                               {"tokens": torch.from_numpy(tokens),
                                "labels": torch.from_numpy(labels)})
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """Decode step t's logits equal the full forward's at position S + t
    (recurrentgemma-2b's local layers across the ring wrap: the smoke
    window is 16, the context 35)."""
    _, _, cfg, params = _models(arch)
    B, S = 2, PROMPT
    toks = torch.from_numpy(_tokens(cfg, B, S + 3, seed=3))
    with torch.no_grad():
        h, _ = forward_hidden(cfg, params, toks, mode="train")
        full = logits_from_hidden(cfg, params, h)
        lg, cache = prefill(cfg, params, toks[:, :S], cache_len=S + 3)
        np.testing.assert_allclose(lg.numpy(), full[:, S - 1].numpy(),
                                   atol=2e-4, rtol=1e-3)
        for t in range(3):
            lg, cache = decode_step(cfg, params, cache,
                                    toks[:, S + t:S + t + 1], S + t)
            np.testing.assert_allclose(lg.numpy(), full[:, S + t].numpy(),
                                       atol=2e-4, rtol=1e-3)


def _cell_leaves(cache):
    """(path, tensor) of every recurrent cache leaf: the stacked groups'
    and the remainder's."""
    out = []
    for part in ("groups", "rem"):
        for i, c in cache.get(part, {}).items():
            for name, t in c.get("cell", {}).items():
                out.append((f"{part}/{i}/{name}", t))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_writes_the_recurrent_cache_in_place(arch):
    """decode_step copies every recurrent cell's new state (lru and
    conv_state; mC, mn, mm; sc, sn, sh, sm) into the cache it is given,
    stacked groups through their views, and returns those tensors: each
    leaf is the same object, has changed, and equals a second decode from
    a copy of the prefill's cache at a one-element position tensor."""
    _, _, cfg, params = _models(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, PROMPT + 1, seed=5))
    with torch.no_grad():
        _, cache = prefill(cfg, params, toks[:, :PROMPT],
                           cache_len=PROMPT + 1)
        twin = copy.deepcopy(cache)
        before = {k: t.clone() for k, t in _cell_leaves(cache)}
        lg, new = decode_step(cfg, params, cache, toks[:, PROMPT:], PROMPT)
        lg2, new2 = decode_step(cfg, params, twin, toks[:, PROMPT:],
                                torch.tensor([PROMPT]))
    leaves, twins = dict(_cell_leaves(cache)), dict(_cell_leaves(new2))
    assert len(leaves) == sum(len(LEAVES.get(k, ()))
                              for k in cfg.layer_pattern + cfg.rem_pattern)
    for path, t in _cell_leaves(new):
        assert t is leaves[path], path
        assert not torch.equal(t, before[path]), path
        assert torch.equal(t, twins[path]), path
    assert torch.equal(lg, lg2)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_holds_no_sequence_tensor(arch):
    """Every recurrent leaf of the prefill's cache owns its storage, no
    more: a view of a (B, S, ·) sequence tensor (the scan's output, the
    padded conv input) would keep that whole tensor alive in the cache,
    a layer at a time, until the decode ends."""
    _, _, cfg, params = _models(arch)
    toks = torch.from_numpy(_tokens(cfg, 2, PROMPT, seed=6))
    with torch.no_grad():
        _, cache = prefill(cfg, params, toks, cache_len=PROMPT + 1)
    for path, t in _cell_leaves(cache):
        assert (t.untyped_storage().nbytes()
                == t.numel() * t.element_size()), path


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_follows_the_jax_layout_and_count(arch):
    """The port's own draws in the JAX package's layout (every leaf's
    shape and dtype), norm scales zero, ``lam`` in [0.7, 0.95), and the
    leaves' count the config's ``num_params`` plus its signed
    ``uncounted_params``: +20,160 and -48,384 on the smoke configs (+117,918,720 and
    -75,423,744 at full size); the serving cache holds every cell's
    state, the stabilizers at -1e30."""
    jcfg, _, cfg, _ = _models(arch)
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         device="cpu")
    shapes = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), jcfg))

    def walk(t, j):
        if isinstance(t, dict):
            assert set(t) == set(j)
            for k in t:
                walk(t[k], j[k])
        else:
            assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    walk(params, shapes)
    cell = params["groups"]["0"]["cell"]
    assert torch.all(params["groups"]["0"]["norm"] == 0.0)
    if arch == "recurrentgemma-2b":
        assert bool((cell["lam"] >= 0.7).all() & (cell["lam"] < 0.95).all())
    extra = cfg.uncounted_params()
    assert num_params(params)[0] == cfg.num_params() + extra
    assert extra == {ARCHS[0]: 20_160, ARCHS[1]: -48_384}[arch]
    assert get_config(arch).uncounted_params() == {
        ARCHS[0]: 117_918_720, ARCHS[1]: -75_423_744}[arch]
    cache = init_serve_cache(cfg, 2, 40, device="cpu")
    for path, t in _cell_leaves(cache):
        assert t.dtype == torch.float32 or path.endswith("conv_state")
        fill = -1e30 if path[-2:] in ("mm", "sm") else 0.0
        assert bool((t == fill).all()), path
