"""The port's training path against the JAX package on the CPU: kernel
12's backward (its plain version), the train and grad steps, remat and
the training entry point (``launch/train.py``).

``flash_attention_backward_plain`` against ``jax.vjp`` of the JAX
package's ``flash_attention(backend="blockwise")`` (causal and not, a
window, GQA 4:1, Sq != Skv at 37 and 67, D in {16, 20, 64}): f32 within
1e-5·Σ|terms| of each entry (the dense sum of the absolute products that
make it, ``bwd_bounds``); bf16 within one bf16 rounding, 2^-7·|want|,
plus 2^-7·Σ|terms| (the port's Δ reads the forward's bf16 output, the
JAX package's the unrounded f32 one).  ``torch.autograd.gradcheck`` of
``flash_attention`` in f64.  One ``make_train_step`` against the JAX
package's for every smoke config in f32 compute
(tests/test_torch_train_archs.py; params carried across with
``params_from_numpy``, the state with ``train_state_from_numpy``):
loss and grad_norm within 1e-5 relative, m and v within 3e-5 of each
leaf's largest value (the recurrent cells' small gate gradients, through
another scan order, come to 1e-5), and the new params within two f32
ulps of themselves plus 1e-3·lr (a step moves a param by about lr: the
norm scales start at zero, so their new values are the update alone; an
update moves by lr·δg/(|g| + eps), 1e-4·lr where a gradient of 1e-5
differs by 1e-7).  The AdamW eps is 1e-3 here: a
first step's update is g/(|g| + eps), a sign function where |g| is below
eps, so gradients equal within f32 rounding could give updates that
differ by 2·lr at entries near zero.  ``make_grad_step`` likewise (grads
within 1e-5 of each leaf's largest).  Remat on and off bitwise; the
bf16-compute step against the JAX package's with XLA keeping every bf16
rounding: loss and grad_norm within 1e-2 relative, gradients, m and v
within 5e-2 of each leaf's largest (the updates themselves are sign-like
and are held in f32 compute above); ``launch/train.main`` with adaptive
accumulation and EarlEval, and its resume bitwise the uninterrupted
run.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention import ops as jfa
from repro.models import init_params as j_init
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train.steps import TrainState as JTrainState
from repro.train.steps import init_train_state as j_init_state
from repro.train.steps import make_grad_step as j_make_grad_step
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy, train_state_from_numpy
from repro_torch.kernels.flash_attention import ops as tfa
from repro_torch.launch import train as tlaunch
from repro_torch.optim import AdamWConfig
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train import make_grad_step, make_train_step
from torch_aux_inputs import aux_for, with_gates

torch.set_num_threads(1)

#: XLA keeps every bf16 rounding the program writes (as
#: tests/test_torch_recurrent.py's bf16 comparison does)
_AS_WRITTEN = {"xla_allow_excess_precision": False}


def bwd_bounds(q, k, v, o, do, lse, causal, window, kv_offset, scale):
    """Σ|terms| of each entry of dq, dk and dv (dense, f32): P from lse,
    |dS| bounded by P·(|dO|·|V|ᵀ + rowsum|dO ∘ O|)."""
    from repro_torch.kernels.flash_attention.ref import attention_mask
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qf, of, dof = (t.float() for t in (q, o, do))
    kf, vf = (t.float().repeat_interleave(g, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    mask = attention_mask(sq, skv, causal, window, kv_offset)
    p = torch.where(mask, torch.exp(s - lse.reshape(b, hq, sq, 1)), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof.abs(), vf.abs())
              + (dof * of).abs().sum(-1, keepdim=True))
    bq = scale * torch.einsum("bhqk,bhkd->bhqd", ds, kf.abs())
    bk = scale * torch.einsum("bhqk,bhqd->bhkd", ds, qf.abs())
    bv = torch.einsum("bhqk,bhqd->bhkd", p, dof.abs())
    return (bq, bk.reshape(b, hkv, g, skv, d).sum(2),
            bv.reshape(b, hkv, g, skv, d).sum(2))


BWD_CASES = [
    ((1, 4, 1, 37, 37, 16), dict(causal=True)),
    ((2, 4, 4, 67, 67, 20), dict(causal=True, window=13)),
    ((1, 8, 2, 37, 67, 64), dict(causal=False)),
    ((1, 4, 1, 67, 37, 16), dict(causal=False)),
    ((1, 4, 2, 37, 67, 20), dict(causal=True, kv_offset=30)),
    ((1, 2, 1, 37, 16, 16), dict(causal=True, window=8, kv_offset=40)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,kw", BWD_CASES,
                         ids=[str(s) for s, _ in BWD_CASES])
def test_backward_plain_matches_jax_vjp(shape, kw, dtype):
    b, hq, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq * skv + d)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d),
                      (b, hq, sq, d))]
    kw = dict(kw, window=kw.get("window"), kv_offset=kw.get("kv_offset", 0),
              scale=d ** -0.5)
    blocks = dict(block_q=16, block_k=16)
    jd = jnp.dtype(dtype)
    jq, jk, jv, jdo = (jnp.asarray(a).astype(jd) for a in arrs)
    out, vjp = jax.vjp(lambda q, k, v: jfa.flash_attention(
        q, k, v, backend="blockwise", **blocks, **kw), jq, jk, jv)
    want = vjp(jdo)
    td = getattr(torch, dtype)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(td) for a in arrs)
    o, lse = tfa.flash_attention_plain_lse(tq, tk, tv, **blocks, **kw)
    jo = np.asarray(out.astype(jnp.float32))
    assert np.abs(o.float().numpy() - jo).max() <= \
        (1e-6 if dtype == "float32" else 2.0 ** -7) * max(np.abs(jo).max(), 1)
    got = tfa.flash_attention_backward_plain(tq, tk, tv, o, lse, tdo,
                                             **blocks, **kw)
    bounds = bwd_bounds(tq, tk, tv, o, tdo, lse, kw["causal"], kw["window"],
                        kw["kv_offset"], kw["scale"])
    for name, g, w, bd in zip(("dq", "dk", "dv"), got, want, bounds):
        w = torch.from_numpy(np.asarray(w.astype(jnp.float32)))
        assert g.dtype == td and g.shape == w.shape, name
        tol = 1e-5 * bd
        if dtype == "bfloat16":
            tol = 2.0 ** -7 * (w.abs() + bd)
        assert bool(((g.float() - w).abs() <= tol).all()), name
    if kw["kv_offset"] == 40:          # the window ends before every key
        assert bool(torch.isneginf(lse).all())
        assert all(bool((t == 0).all()) for t in got)


@pytest.mark.parametrize("kw", [dict(causal=True, window=3),
                                dict(causal=False),
                                dict(causal=True, kv_offset=2)])
def test_flash_attention_gradcheck_f64(kw):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((1, 4, 5, 4), dtype=torch.float64, generator=g)
    k = torch.randn((1, 2, 7, 4), dtype=torch.float64, generator=g)
    v = torch.randn((1, 2, 7, 4), dtype=torch.float64, generator=g)
    for t in (q, k, v):
        t.requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda q, k, v: tfa.flash_attention(q, k, v, block_q=2, block_k=3,
                                            **kw), (q, k, v))


def test_backward_plain_matches_autograd_of_the_oracle_in_f64():
    """The second oracle: autograd through ref.mha_reference in f64."""
    from repro_torch.kernels.flash_attention.ref import mha_reference
    g = torch.Generator().manual_seed(2)
    q, k, v, do = (torch.randn(s, dtype=torch.float64, generator=g)
                   for s in ((2, 4, 9, 8), (2, 2, 11, 8), (2, 2, 11, 8),
                             (2, 4, 9, 8)))
    kw = dict(causal=True, window=4, kv_offset=2)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    mha_reference(*leaves, **kw).backward(do)
    o, lse = tfa.flash_attention_plain_lse(q, k, v, block_q=4, block_k=4,
                                           **kw)
    got = tfa.flash_attention_backward_plain(q, k, v, o, lse, do,
                                             block_q=4, block_k=4, **kw)
    for a, leaf in zip(got, leaves):
        torch.testing.assert_close(a, leaf.grad, rtol=1e-10, atol=1e-12)


def _configs(arch, compute):
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               compute_dtype=compute)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=compute)
    return jcfg, cfg


def _batch(cfg, b=2, s=32, seed=1):
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks[:, :s]),
          "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :s]),
          "labels": torch.from_numpy(toks[:, 1:])}
    aux = aux_for(cfg, b)
    if aux is not None:
        jb["aux"], tb["aux"] = jnp.asarray(aux), torch.from_numpy(aux)
    return jb, tb


def _states(jcfg, ocfg):
    jstate = j_init_state(jax.random.PRNGKey(0), jcfg, ocfg)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    if jcfg.vision_tokens or jcfg.is_encdec:
        params = with_gates(params)
    jstate = JTrainState(jax.tree_util.tree_map(jnp.asarray, params),
                         jstate.opt)
    opt = jax.tree_util.tree_map(np.asarray, jstate.opt)
    return jstate, train_state_from_numpy(params, opt, device="cpu")


def _close_tree(got, want, rel):
    w = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, want)))
    for path, t in tree_leaves(got):
        ref = np.asarray(w[path], np.float32)
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(t.float().numpy() - ref).max()) <= rel * scale, \
            path


OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1)


def _close_params(got, want, lr, rel_update):
    w = dict(tree_leaves(jax.tree_util.tree_map(np.asarray, want)))
    for path, t in tree_leaves(got):
        ref = np.asarray(w[path], np.float32)
        tol = 2 * np.spacing(np.abs(ref)) + rel_update * lr
        assert bool((np.abs(t.float().numpy() - ref) <= tol).all()), path


def test_grad_step_matches_jax():
    jcfg, cfg = _configs("granite-3-2b", "float32")
    tree = jax.tree_util.tree_map(np.asarray,
                                  j_init(jax.random.PRNGKey(0), jcfg))
    jb, tb = _batch(cfg)
    jg, jn, jl = jax.jit(j_make_grad_step(jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), jb)
    g, n, loss = make_grad_step(cfg)(params_from_numpy(tree, device="cpu"),
                                     tb)
    assert abs(float(n) - float(jn)) <= 1e-5 * float(jn)
    assert abs(float(loss) - float(jl)) <= 1e-5 * float(jl)
    _close_tree(g, jg, 1e-5)


@pytest.mark.parametrize("arch", ["granite-3-2b", "whisper-small"])
def test_remat_on_is_bitwise_remat_off(arch):
    """remat recomputes each pattern group (the encoder's too) in the
    backward: the gradients are the same bits."""
    _, cfg = _configs(arch, "bfloat16")
    _, tb = _batch(cfg)
    tree = jax.tree_util.tree_map(np.asarray, j_init(
        jax.random.PRNGKey(1), _configs(arch, "bfloat16")[0]))
    if cfg.is_encdec:
        tree = with_gates(tree)
    out = []
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        out.append(make_grad_step(c)(params_from_numpy(tree, device="cpu"),
                                     tb))
    (ga, na, la), (gb, nb, lb) = out
    assert torch.equal(na, nb) and torch.equal(la, lb)
    b = dict(tree_leaves(gb))
    for path, t in tree_leaves(ga):
        assert torch.equal(t, b[path]), path


def test_bf16_compute_train_step_matches_jax():
    jcfg, cfg = _configs("granite-3-2b", "bfloat16")
    jstate, state = _states(jcfg, JAdamW(**OPT))
    jb, tb = _batch(cfg)
    jg, jn, jl = jax.jit(j_make_grad_step(jcfg),
                         compiler_options=_AS_WRITTEN)(jstate.params, jb)
    jnew, jm = jax.jit(j_make_train_step(jcfg, JAdamW(**OPT)),
                       compiler_options=_AS_WRITTEN)(jstate, jb)
    g, _, _ = make_grad_step(cfg)(state.params, tb)
    _close_tree(g, jg, 5e-2)
    new, m = make_train_step(cfg, AdamWConfig(**OPT))(state, tb)
    for key in ("loss", "grad_norm"):
        assert abs(float(m[key]) - float(jm[key])) <= \
            1e-2 * abs(float(jm[key])), key
    _close_tree(new.opt.m, jnew.opt.m, 5e-2)
    _close_tree(new.opt.v, jnew.opt.v, 5e-2)


def _main(tmp, steps, *extra):
    return tlaunch.main(["--arch", "granite-3-2b", "--smoke", "--device",
                         "cpu", "--steps", str(steps), "--batch", "2",
                         "--seq", "16", "--docs", "24", "--ckpt-dir",
                         str(tmp), "--ckpt-every", "2", "--eval-every", "2",
                         "--adaptive-accum", "--microbatches", "3", *extra])


def test_launch_train_runs_and_resumes_bitwise(tmp_path, capsys):
    """``launch/train.main`` with adaptive accumulation and EarlEval; a run stopped
    after 2 steps and resumed to 4 gives the uninterrupted run's metrics,
    final state and pipeline cursor, bitwise."""
    from repro_torch.checkpoint import CheckpointManager
    full = _main(tmp_path / "full", 4)
    _main(tmp_path / "part", 2)
    resumed = _main(tmp_path / "part", 4, "--resume")
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out
    assert "[earl_eval] step 4" in out
    assert len(full["history"]) == 4 and len(resumed["history"]) == 2
    assert full["history"][2:] == resumed["history"]
    assert all(h["micro_used"] in (2, 3) for h in full["history"])
    assert full["ckpt"]["saves"] == 3 and full["ckpt"]["bytes"] > 0
    assert [e["step"] for e in full["evals"]] == [2, 4]
    a, b = (CheckpointManager(str(tmp_path / n)) for n in ("full", "part"))
    assert a.meta() == b.meta()
    assert a.meta()["pipeline"] == {"epoch": 0, "step": 12}
    with np.load(tmp_path / "full" / "ckpt_00000004" / "arrays.npz") as za, \
            np.load(tmp_path / "part" / "ckpt_00000004" / "arrays.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for name in za.files:
            np.testing.assert_array_equal(za[name], zb[name])


def test_bf16_train_state_crosses_and_checkpoints_bitwise(tmp_path):
    """arctic-480b's layout: bf16 params and AdamW states.  The JAX
    package's TrainState crosses with every leaf's dtype and bits kept
    (``train_state_from_numpy``), and a checkpoint of it restores
    bitwise (bf16 leaves go through the host as their int16 bits)."""
    from repro_torch.checkpoint import CheckpointManager
    jcfg = dataclasses.replace(j_get_config("arctic-480b", smoke=True),
                               param_dtype="bfloat16",
                               adam_dtype="bfloat16")
    jstate = j_init_state(jax.random.PRNGKey(3), jcfg,
                          JAdamW(state_dtype="bfloat16"))
    jstate = JTrainState(jstate.params, jax.tree_util.tree_map(
        lambda t: (t + 0.5).astype(t.dtype), jstate.opt))
    np_params = jax.tree_util.tree_map(np.asarray, jstate.params)
    np_opt = jax.tree_util.tree_map(np.asarray, jstate.opt)
    state = train_state_from_numpy(np_params, np_opt, device="cpu")
    for got, want in ((state.params, np_params), (state.opt.m, np_opt.m),
                      (state.opt.v, np_opt.v)):
        w = dict(tree_leaves(want))
        for path, t in tree_leaves(got):
            assert t.dtype == torch.bfloat16, path
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          w[path].view(np.int16))
    assert int(state.opt.step) == int(np_opt.step)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, state, extra={"step": 1})
        zeroed = train_state_from_numpy(
            jax.tree_util.tree_map(np.zeros_like, np_params),
            jax.tree_util.tree_map(np.zeros_like, np_opt), device="cpu")
        back, extra = mgr.restore(zeroed)
    assert extra == {"step": 1}
    a, b = dict(tree_leaves(back.params)), dict(tree_leaves(state.params))
    for path in b:
        assert a[path].dtype == torch.bfloat16
        assert torch.equal(a[path].view(torch.int16),
                           b[path].view(torch.int16)), path
    assert torch.equal(back.opt.m["embedding"], state.opt.m["embedding"])
