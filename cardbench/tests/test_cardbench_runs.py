"""Each cell of BENCHMARK.json driven through a whole run on the CPU at a
tiny size: sound, it comes out correct; with the timed path broken
underneath, it does not, once for each fault its traffic can have.  (No
cell spans chips, so none can leave out an exchange between them.)"""
import copy

import numpy as np
import pytest
import torch

from cardbench.tests import smoke

torch.set_num_threads(1)


def _schema(out):
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}
    assert list(out)[-1] == "checks"
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])


@pytest.mark.parametrize("name", smoke.cells())
def test_a_sound_run_is_correct(name):
    out = smoke.execute(smoke.tiny_run(name))
    _schema(out)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    assert len(out["metrics"]) >= 2


def _broken_train(monkeypatch, how):
    from repro_torch import train as T
    from repro_torch.models import decoder
    from repro_torch.train import steps as S
    real = T.make_train_step
    if how == "gradient_doubled":     # as a wrong count in the loss's mean
        real_vg = S.value_and_grad

        def doubled(cfg, params, batch):
            grads, metrics = real_vg(cfg, params, batch)
            return decoder.tree_map(lambda g: 2.0 * g, grads), metrics
        monkeypatch.setattr(S, "value_and_grad", doubled)

    def make(cfg, opt):
        step = real(cfg, opt)

        def broken(state, batch):
            if how == "unchanged":
                _, metrics = step(copy.deepcopy(state), batch)
                return state, metrics
            if how == "half_batch":
                batch = {k: v[: len(v) // 2] for k, v in batch.items()}
            return step(state, batch)
        return broken
    monkeypatch.setattr(T, "make_train_step", make)


@pytest.mark.parametrize("how", ["unchanged", "half_batch",
                                 "gradient_doubled"])
@pytest.mark.parametrize("name", smoke.cells("train"))
def test_a_broken_train_step_is_not_correct(monkeypatch, name, how):
    _broken_train(monkeypatch, how)
    out = smoke.execute(smoke.tiny_run(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("where", ["loss", "estimate"])
@pytest.mark.parametrize("name", smoke.cells("earl_eval"))
def test_an_altered_answer_is_not_correct(monkeypatch, name, where):
    from repro_torch import train as T
    if where == "loss":
        real = T.make_eval_step

        def make(cfg):
            step = real(cfg)
            return lambda params, batch: step(params, batch) + 0.25
        monkeypatch.setattr(T, "make_eval_step", make)
    else:
        real_run = T.EarlEval.run

        def run(self, key):
            res = real_run(self, key)
            res.result = res.result * 1.01
            return res
        monkeypatch.setattr(T.EarlEval, "run", run)
    out = smoke.execute(smoke.tiny_run(name))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", smoke.cells())
def test_a_traced_run_reads_its_per_layer_metrics(name):
    run = smoke.tiny_run(name)
    run.trace = True
    out = smoke.execute(run)
    _schema(out)
    assert out["correct"], out["checks"]
    assert out["metrics"] and "setup_s" not in out["metrics"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in out["breakdown"].values())
