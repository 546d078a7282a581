"""The port's early-accurate eval (train/earl_eval.py, data/pipeline.py,
MeanLoss, synthetic_tokens) against the JAX package on the CPU.

Fed the JAX package's per-example losses, the port's LossValuesSampler
and session take the JAX run's B, rows, iterations and model forwards,
with the estimate within 1e-6 relative.  With its own forward the port
certifies σ = 0.01 from under half of a 3000-document corpus, as
tests/test_ssabe_session.py asserts for the JAX package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import MeanLoss as JMeanLoss
from repro.data import synthetic_tokens as j_tokens
from repro.data.pipeline import EvalSamplePipeline as JPipeline
from repro.models import init_params as j_init
from repro.train import EarlEval as JEarlEval
from repro.train import make_eval_step as j_make_eval_step
from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.core import Mean, MeanLoss
from repro_torch.data import synthetic_tokens
from repro_torch.data.pipeline import EvalSamplePipeline
from repro_torch.interop import params_from_numpy
from repro_torch.train import EarlEval, LossValuesSampler, make_eval_step

torch.set_num_threads(1)

ARCH, N_DOCS, DOC_LEN, SIGMA, TAU, BATCH = "stablelm-3b", 3000, 33, 0.01, \
    0.05, 64


@pytest.fixture(scope="module")
def corpus():
    jcfg = j_get_config(ARCH, smoke=True)
    jparams = j_init(jax.random.PRNGKey(0), jcfg)
    docs = j_tokens(N_DOCS, DOC_LEN, jcfg.vocab, seed=3)
    return jcfg, jparams, docs


def test_synthetic_tokens_and_pipeline_rows_are_the_jax_rows(corpus):
    _, _, docs = corpus
    np.testing.assert_array_equal(
        synthetic_tokens(N_DOCS, DOC_LEN, get_config(ARCH, smoke=True).vocab,
                         seed=3), docs)
    want = JPipeline(docs, seq_len=32)
    got = EvalSamplePipeline(docs, seq_len=32, device="cpu")
    assert got.N == want.N
    for a, b in ((0, 8), (100, 164), (2990, 3000)):
        for t, j in zip(got.take(a, b), want.take(a, b)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    t1, _ = got.take(0, 8)
    t2, _ = got.take(0, 16)
    assert torch.equal(t1, t2[:8])


def test_mean_loss_is_a_mean():
    assert isinstance(MeanLoss(), Mean)
    x = torch.arange(10.0)
    assert torch.equal(MeanLoss()(x), Mean()(x))
    assert float(MeanLoss()(x).reshape(-1)[0]) == 4.5
    assert float(np.asarray(JMeanLoss()(jnp.arange(10.0))).reshape(-1)[0]) \
        == 4.5


def test_session_on_jax_losses_takes_the_jax_run(corpus):
    jcfg, jparams, docs = corpus
    j_step = jax.jit(j_make_eval_step(jcfg))
    key = 11
    want = JEarlEval(j_step, jparams, JPipeline(docs, seq_len=32),
                     sigma=SIGMA, tau=TAU, eval_batch=BATCH).run(
        jax.random.PRNGKey(key))

    def jax_losses(params, batch):
        del params
        out = j_step(jparams, {k: jnp.asarray(v.numpy())
                               for k, v in batch.items()})
        return torch.from_numpy(np.array(out))

    got = EarlEval(jax_losses, None, EvalSamplePipeline(docs, seq_len=32,
                                                        device="cpu"),
                   sigma=SIGMA, tau=TAU, eval_batch=BATCH,
                   device="cpu").run(trandom.PRNGKey(key))
    assert (got.B, got.n_used, got.iterations, got.fell_back) == (
        want.B, want.n_used, want.iterations, want.fell_back)
    assert got.history[-1] == want.history[-1]
    g = float(np.asarray(got.result).reshape(-1)[0])
    w = float(np.asarray(want.result).reshape(-1)[0])
    assert abs(g - w) <= 1e-6 * abs(w)


def test_port_forward_certifies_from_a_fraction(corpus):
    jcfg, jparams, docs = corpus
    cfg = get_config(ARCH, smoke=True)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    pipe = EvalSamplePipeline(docs, seq_len=32, device="cpu")
    res = EarlEval(make_eval_step(cfg), params, pipe, sigma=SIGMA, tau=TAU,
                   eval_batch=BATCH, device="cpu").run(trandom.PRNGKey(0))
    info = res.history[-1]
    assert info["model_forwards"] < 0.5 * info["full_pass_forwards"], \
        "earl_eval must certify accuracy from a fraction of the corpus"
    assert res.cv <= SIGMA


def test_loss_sampler_evaluates_each_row_once():
    calls = []

    def step(params, batch):
        calls.append(batch["tokens"].shape[0])
        return batch["tokens"][:, 0].to(torch.float32)

    docs = synthetic_tokens(50, 9, 100, seed=1)
    s = LossValuesSampler(step, None, EvalSamplePipeline(docs, 8,
                                                         device="cpu"),
                          eval_batch=16)
    a = s.take(0, 20)
    b = s.take(10, 40)
    assert s.forwards == 40 and calls == [16, 4, 16, 4]
    assert torch.equal(a[10:], b[:10])
