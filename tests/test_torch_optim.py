"""The port's optim/ (AdamW in place, bf16 compression, EARL-adaptive
accumulation) and TokenBatchPipeline against the JAX package on the CPU.

Inputs are numpy, from a seed, handed to both packages.  AdamW over 5
steps (warmup, weight decay, clipping active and not, f32 and bf16
states): params, m, v, grad_norm and lr within f32 rounding (2e-6
relative to each leaf's largest value, the sums and the pow taken in
another order), step equal, bf16 states bitwise; ``global_norm`` in
jax.tree_util's leaf order; the compression functions bitwise;
``gradient_cv`` within one f32 ulp; ``earl_accumulate_gradients`` on the
granite-3-2b smoke model (f32 compute) with the same microbatches used
and mean gradients within 1e-5 of each leaf's largest; the pipeline's
batches bitwise across an epoch boundary and after ``load_state_dict``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data.pipeline import TokenBatchPipeline as JPipeline
from repro.models import init_params as j_init
from repro.optim import adamw as jadamw
from repro.optim import adaptive_accum as jaccum
from repro.optim import compression as jcomp
from repro.train.steps import make_grad_step as j_make_grad_step
from repro_torch.configs import get_config
from repro_torch.data import PipelineState, TokenBatchPipeline
from repro_torch.interop import params_from_numpy
from repro_torch.optim import (AdamWConfig, OptState, adamw_init,
                               adamw_update, compress_decompress,
                               earl_accumulate_gradients,
                               error_feedback_compress, global_norm,
                               gradient_cv, init_residual)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_grad_step

torch.set_num_threads(1)

SHAPES = {"b": {"w": (7, 5), "a": (3,)}, "a": (4, 2, 3), "c": {"z": (6,)}}


def _tree(rng, shapes=SHAPES, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def _to_torch(tree):
    return params_from_numpy(tree, device="cpu")


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _close(got, want, rel=2e-6):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale


def _bits(t):
    return t.view(torch.int16).numpy()


def _jbits(a):
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [0.5, 100.0], ids=["clipped", "free"])
def test_adamw_matches_jax_over_five_steps(state_dtype, grad_clip):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    kw = dict(lr=1e-2, weight_decay=0.1, grad_clip=grad_clip,
              warmup_steps=3, state_dtype=state_dtype)
    jcfg, tcfg = jadamw.AdamWConfig(**kw), AdamWConfig(**kw)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jadamw.adamw_init(jp, jcfg), adamw_init(tp, tcfg)
    for step in range(5):
        grads = _tree(rng, scale=0.7)
        jp, js, jm = jadamw.adamw_update(jp, _to_jax(grads), js, jcfg)
        tp_before = dict(tree_leaves(tp))
        out_p, ts_out, tm = adamw_update(tp, _to_torch(grads), ts, tcfg)
        # updated in place: the same tensors come back
        assert out_p is tp and ts_out is ts
        assert all(tp_before[k] is v for k, v in tree_leaves(tp))
        assert int(ts.step) == int(js.step) == step + 1
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"])
        if grad_clip == 0.5:
            assert float(jm["grad_norm"]) > grad_clip
        jl = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jp)))
        for path, t in tree_leaves(tp):
            _close(t, jl[path])
        for name in ("m", "v"):
            jt = dict(tree_leaves(jax.tree_util.tree_map(
                np.asarray, getattr(js, name))))
            for path, t in tree_leaves(getattr(ts, name)):
                if state_dtype == "bfloat16":
                    assert t.dtype == torch.bfloat16
                    np.testing.assert_array_equal(_bits(t), _jbits(jt[path]))
                else:
                    _close(t, jt[path])


def test_global_norm_takes_jax_leaf_order():
    """The port walks a dict by sorted key, as jax.tree_util flattens it,
    whatever the insertion order; the norm agrees with the JAX
    package's."""
    rng = np.random.default_rng(1)
    tree = {"z": _tree(rng, (5, 3)), "b": {"y": _tree(rng, (4,)),
                                           "a": _tree(rng, (2, 2))}}
    paths = [p for p, _ in tree_leaves(_to_torch(tree))]
    jpaths = ["".join(f"/{k.key}" for k in kp)
              for kp, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert paths == jpaths == ["/b/a", "/b/y", "/z"]
    _close(global_norm(_to_torch(tree)), jadamw.global_norm(_to_jax(tree)))


def test_compression_is_bitwise_the_jax_package():
    rng = np.random.default_rng(2)
    grads, residual = _tree(rng), _tree(rng, scale=1e-3)
    cd = compress_decompress(_to_torch(grads))
    jcd = jcomp.compress_decompress(_to_jax(grads))
    sent, res = error_feedback_compress(_to_torch(grads), _to_torch(residual))
    jsent, jres = jcomp.error_feedback_compress(_to_jax(grads),
                                                _to_jax(residual))
    for got, want in ((cd, jcd), (sent, jsent), (res, jres)):
        w = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, want)))
        for path, t in tree_leaves(got):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), w[path])
    zero = init_residual(_to_torch(grads))
    assert all(bool((t == 0).all()) and t.dtype == torch.float32
               for _, t in tree_leaves(zero))


@pytest.mark.parametrize("n,seed", [(2, 2), (3, 3), (4, 0), (7, 5)])
def test_gradient_cv_matches_jax(n, seed):
    norms = np.random.default_rng(n).uniform(0.5, 2.0, n)
    got, want = gradient_cv(norms, seed=seed), jaccum.gradient_cv(norms,
                                                                  seed=seed)
    assert abs(got - want) <= np.spacing(np.float32(want))
    assert gradient_cv(norms[:1]) == float("inf")


def _smoke_models():
    jcfg = dataclasses.replace(j_get_config("granite-3-2b", smoke=True),
                               compute_dtype="float32")
    cfg = dataclasses.replace(get_config("granite-3-2b", smoke=True),
                              compute_dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), jcfg))
    return jcfg, _to_jax(tree), cfg, _to_torch(tree)


@pytest.mark.parametrize("sigma,micro", [(0.02, 4), (1.0, 4)],
                         ids=["full", "early_stop"])
def test_earl_accumulate_gradients_matches_jax(sigma, micro):
    """The same microbatches used (sigma 1.0 stops at min_micro = 2), the
    mean loss and the mean gradients of the used microbatches as the JAX
    package's; the accumulator is the first microbatch's tree."""
    jcfg, jparams, cfg, params = _smoke_models()
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab, size=(micro, 2, 33)).astype(np.int32)
    jmbs = [{"tokens": jnp.asarray(t[:, :32]), "labels": jnp.asarray(t[:, 1:])}
            for t in toks]
    tmbs = [{"tokens": torch.from_numpy(t[:, :32]),
             "labels": torch.from_numpy(t[:, 1:])} for t in toks]
    jgrads, jdec = jaccum.earl_accumulate_gradients(
        jax.jit(j_make_grad_step(jcfg)), jparams, jmbs, sigma=sigma)
    seen = []

    def grad_step(p, mb):
        out = make_grad_step(cfg)(p, mb)
        seen.append(out[0])
        return out

    grads, dec = earl_accumulate_gradients(grad_step, params, tmbs,
                                           sigma=sigma)
    assert dec.microbatches_used == jdec.microbatches_used
    assert dec.stop == jdec.stop
    assert dec.microbatches_used == (2 if sigma == 1.0 else micro)
    assert grads is seen[0]
    assert abs(dec.mean_loss - jdec.mean_loss) <= 1e-6 * abs(jdec.mean_loss)
    assert abs(dec.cv - jdec.cv) <= 1e-5 * abs(jdec.cv)
    jl = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, jgrads)))
    for path, t in tree_leaves(grads):
        _close(t, jl[path], rel=1e-5)


def test_token_batch_pipeline_is_bitwise_jax_across_epochs_and_resume():
    docs = np.random.default_rng(4).integers(0, 509, size=(21, 17)
                                             ).astype(np.int32)
    jp = JPipeline(docs, batch=4, seq_len=16, seed=3)
    tp = TokenBatchPipeline(docs, batch=4, seq_len=16, seed=3, device="cpu")
    assert tp.steps_per_epoch() == 5
    saved = None
    for i in range(12):                  # past two epoch boundaries
        if i == 7:
            saved = tp.state_dict()
        jt, jl = jp.next_batch()
        tt, tl = tp.next_batch()
        assert tt.dtype == torch.int32 and tt.shape == (4, 16)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert tp.state == PipelineState(epoch=2, step=2)
    resumed = TokenBatchPipeline(docs, batch=4, seq_len=16, seed=3,
                                 device="cpu")
    resumed.load_state_dict(saved)
    replay = JPipeline(docs, batch=4, seq_len=16, seed=3)
    replay.load_state_dict(saved)
    for _ in range(6):
        jt, _ = replay.next_batch()
        tt, _ = resumed.next_batch()
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    short = np.random.default_rng(5).integers(0, 9, size=(4, 5)).astype(
        np.int32)
    jt, jl = JPipeline(short, 2, 8, pad_id=7).next_batch()
    tt, tl = TokenBatchPipeline(short, 2, 8, pad_id=7,
                                device="cpu").next_batch()
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_opt_state_keeps_its_dtype_and_device():
    tree = _to_torch(_tree(np.random.default_rng(6)))
    st = adamw_init(tree, AdamWConfig(state_dtype="bfloat16"))
    assert isinstance(st, OptState) and st.step.dtype == torch.int32
    assert all(t.dtype == torch.bfloat16 for _, t in tree_leaves(st.m))
