"""One ``make_train_step`` of the port against the JAX package's for every
smoke config, in f32 compute, on the CPU; the tolerances and the helpers
are tests/test_torch_train.py's (see its docstring)."""
import jax
import pytest

from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import ARCH_IDS
from repro_torch.optim import AdamWConfig
from repro_torch.train import make_train_step
from test_torch_train import (OPT, JAdamW, _batch, _close_params,
                              _close_tree, _configs, _states)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch):
    jcfg, cfg = _configs(arch, "float32")
    jstate, state = _states(jcfg, JAdamW(**OPT))
    jb, tb = _batch(cfg)
    jnew, jm = jax.jit(j_make_train_step(jcfg, JAdamW(**OPT)))(jstate, jb)
    new, m = make_train_step(cfg, AdamWConfig(**OPT))(state, tb)
    assert new is state
    assert set(m) == set(jm) == {"loss", "tokens", "grad_norm", "lr"}
    for key in m:
        assert abs(float(m[key]) - float(jm[key])) <= \
            1e-5 * abs(float(jm[key])), key
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    _close_params(new.params, jnew.params, OPT["lr"], 1e-3)
    _close_tree(new.opt.m, jnew.opt.m, 3e-5)
    _close_tree(new.opt.v, jnew.opt.v, 3e-5)
