"""The plain reference (``cardbench/reference/``) against the port at a
tiny size on the CPU: the same model for both configurations, the same
bootstrap draws and session report."""
import numpy as np
import pytest
import torch

from cardbench.tests import smoke
from cardbench import harness, weights
from cardbench.reference import bootstrap as rboot
from cardbench.reference import decoder as rdec

torch.set_num_threads(1)
CONFIGS = ["granite-3-2b", "h2o-danube-3-4b"]


def tiny(name, compute="float32"):
    cell = next(w for w in smoke.bench()["workloads"] if w["config"] == name)
    model = smoke.tiny_model(harness.find_cell(smoke.bench(),
                                               cell["name"]).model)
    model["run"]["compute_dtype"] = compute
    return model, harness.model_config(model)


def batch(cfg, b=3, s=40, seed=5):
    t = weights.tokens(torch, cfg, seed, "cpu", (b, s + 1), "test")
    return t[:, :-1], t[:, 1:]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_losses_are_the_ports_in_f32(name):
    from repro_torch.models import decoder
    model, cfg = tiny(name)
    params = weights.make_params(torch, cfg, 3, "cpu")
    toks, labs = batch(cfg)
    with torch.no_grad():
        got = decoder.per_example_loss(cfg, params, {"tokens": toks,
                                                     "labels": labs})
        want = rdec.per_example_loss(model["run"], params, toks, labs)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_gradients_are_the_ports_in_f32(name):
    from repro_torch.train import steps
    model, cfg = tiny(name)
    params = weights.make_params(torch, cfg, 4, "cpu")
    toks, labs = batch(cfg, seed=6)
    grads, m = steps.value_and_grad(cfg, params, {"tokens": toks,
                                                  "labels": labs})
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in {"e": params["embedding"],
                           "wq": params["groups"]["0"]["attn"]["wq"],
                           "wd": params["groups"]["0"]["mlp"]["w_down"]}
              .items()}
    tree = dict(params, embedding=leaves["e"])
    tree["groups"] = {"0": dict(params["groups"]["0"])}
    g0 = tree["groups"]["0"]
    g0["attn"] = dict(g0["attn"], wq=leaves["wq"])
    g0["mlp"] = dict(g0["mlp"], w_down=leaves["wd"])
    with torch.enable_grad():
        loss = rdec.loss(model["run"], tree, toks, labs)
        ge, gq, gd = torch.autograd.grad(loss, list(leaves.values()))
    torch.testing.assert_close(m["loss"], loss.detach(), rtol=1e-5,
                               atol=1e-6)
    for got, want in ((grads["embedding"], ge),
                      (grads["groups"]["0"]["attn"]["wq"], gq),
                      (grads["groups"]["0"]["mlp"]["w_down"], gd)):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_logits_hold_the_ports_bf16_prefill_and_decode(name):
    from repro_torch.models import decoder
    model, cfg = tiny(name, compute="bfloat16")
    params = weights.make_params(torch, cfg, 8, "cpu")
    toks, _ = batch(cfg, b=2, s=36, seed=9)
    with torch.no_grad():
        first, cache = decoder.prefill(cfg, params, toks[:, :30],
                                       cache_len=36)
        steps = [first]
        for j in range(30, 35):
            z, cache = decoder.decode_step(cfg, params, cache,
                                           toks[:, j:j + 1], j)
            steps.append(z)
        got = torch.stack(steps, 1)[..., :cfg.vocab]
        h = rdec.hidden(model["run"], params, toks[:, :35])
        want = rdec.logits(model["run"], params, h[:, 29:35])
    assert float((got - want).abs().max()) < 2e-2 * float(want.abs().max())


def test_weights_are_the_ports_tree():
    from repro_torch.models import decoder
    for name in CONFIGS:
        _, cfg = tiny(name)
        mine = weights.make_params(torch, cfg, 1, "cpu")
        port = decoder.init_params(cfg, device="meta")
        shapes = {}
        decoder.tree_map(lambda a, b: shapes.setdefault(
            len(shapes), (a.shape, b.shape, a.dtype, b.dtype)), mine, port)
        assert all(a == b and c == d for a, b, c, d in shapes.values())
        again = weights.make_params(torch, cfg, 1, "cpu")
        assert torch.equal(mine["embedding"], again["embedding"])
        assert not mine["embedding"][cfg.vocab:].any()


def test_the_frozen_poisson_draw_is_the_ports():
    from repro_torch import random as trandom
    key = trandom.fold_in(trandom.PRNGKey(12345), 2)
    want = trandom.poisson(key, 1.0, (16, 700), device="cpu").numpy()
    got = rboot.poisson1(np.array(key.numpy(), np.uint32), (16, 700))
    assert (got == want).mean() > 0.999
    assert abs(got.mean() - 1.0) < 0.05


class _Rows:
    def __init__(self, x):
        self.x, self.N = x, len(x)

    def take(self, a, b):
        return torch.from_numpy(self.x[a:b])


@pytest.mark.parametrize("sigma", [0.01, 0.0004])
def test_the_frozen_session_report_is_the_ports(sigma):
    from repro_torch import random as trandom
    from repro_torch.core.reduce_api import Mean
    from repro_torch.core.session import EarlSession
    x = (10.0 + np.random.default_rng(3).standard_normal(20000) * 0.05
         ).astype(np.float32)
    res = EarlSession(_Rows(x), Mean(), sigma=sigma, tau=0.05,
                      device="cpu").run(trandom.PRNGKey(77))
    ns = [e["n"] for e in res.history if "n" in e]
    ref = rboot.session_report(x, 77, res.B, ns)
    assert abs(float(res.result) - ref["estimate"]) < 1e-6 * ref["estimate"]
    assert abs(res.cv - ref["cv"]) < 1e-3 * ref["cv"]
    low = rboot.session_report(x, 77, res.B, ns, precision=torch.bfloat16)
    assert abs(low["cv"] - ref["cv"]) > 1e-2 * ref["cv"]
