"""The port's partitioning and sharding rules (``models/partitioning.py``,
``launch/sharding.py``, ``configs.input_specs``, ``act_shard.hint``)
against the JAX package, on the CPU, with no process group; every check
is exact.

For every architecture of ``ARCH_IDS``, full and smoke: ``param_axes``,
``cache_axes`` (the decode shapes' caches), ``batch_axes``,
``train_state_axes`` and ``opt_state_axes`` leaf by leaf (the port's
trees on the ``meta`` device, the JAX package's through
``jax.eval_shape``); ``resolve_spec`` on every leaf of those trees under
all four rule tables on duck-typed 16×16 and 2×16×16 meshes (a mesh
whose ``shape`` maps names to sizes, as the JAX package's tests make
them); ``input_specs`` (keys, shapes, dtypes) for every shape of
``SHAPES`` and ``SMOKE_SHAPES``; ``hint``'s resolved parts against the
JAX ``hint``'s, captured by patching ``jax.lax.with_sharding_constraint``
inside the test.  ``tests/test_sharding.py::TestResolver``'s cases as
they stand, on the port's resolver.
"""
import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.launch import sharding as jsh
from repro.models import act_shard as jact
from repro.models import decoder as jdec
from repro.models import partitioning as jpart
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.optim.adamw import opt_state_axes as j_opt_axes
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.launch import sharding as tsh
from repro_torch.models import act_shard as tact
from repro_torch.models import decoder as tdec
from repro_torch.models import partitioning as tpart
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import opt_state_axes as t_opt_axes
from repro_torch.train import steps as tsteps

ARCHS = tconfigs.ARCH_IDS
RULES = {"train": "TRAIN_RULES", "serve": "SERVE_RULES",
         "zero3": "ZERO3_TRAIN_RULES", "headdim": "SERVE_RULES_HEADDIM"}


class _FakeMesh:
    """Duck-typed mesh: the resolvers read ``.shape`` (name -> size)."""
    def __init__(self, **axes):
        self.shape = dict(axes)


SINGLE = _FakeMesh(data=16, model=16)
MULTI = _FakeMesh(pod=2, data=16, model=16)
MESHES = {"single": SINGLE, "multi": MULTI}


def _flat(tree, path=()):
    """path -> leaf of a nested dict (an axes tuple is one leaf)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _shape(leaf):
    return tuple(int(d) for d in leaf.shape)


def _dtype(leaf):
    return str(leaf.dtype).replace("torch.", "")


def _cfgs(arch, smoke):
    return (jconfigs.get_config(arch, smoke=smoke),
            tconfigs.get_config(arch, smoke=smoke))


_TREES = {}


def _trees(arch, smoke):
    """(JAX, port) shape trees: params, train state, every decode shape's
    cache and every shape's batch."""
    key = (arch, smoke)
    if key not in _TREES:
        jcfg, cfg = _cfgs(arch, smoke)
        jparams = jax.eval_shape(
            lambda: jdec.init_params(jax.random.PRNGKey(0), jcfg))
        params = tdec.init_params(cfg, device="meta")
        jstate = jax.eval_shape(lambda: jsteps.init_train_state(
            jax.random.PRNGKey(0), jcfg, JAdamW()))
        state = tsteps.TrainState(params, adamw_init(params, AdamWConfig()))
        shapes = tconfigs.SMOKE_SHAPES if smoke else tconfigs.SHAPES
        jspecs = {n: jconfigs.input_specs(jcfg, s) for n, s in
                  shapes.items()}
        specs = {n: tconfigs.input_specs(cfg, s) for n, s in shapes.items()}
        _TREES[key] = (jparams, params, jstate, state, jspecs, specs)
    return _TREES[key]


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_axes_match_jax(arch, smoke):
    jparams, params, jstate, state, jspecs, specs = _trees(arch, smoke)
    want = _flat(jpart.param_axes(jparams))
    assert _flat(tpart.param_axes(params)) == want
    jaxes = jsteps.train_state_axes(jstate)
    taxes = tsteps.train_state_axes(state)
    assert _flat(taxes.params) == want
    assert _flat(taxes.opt.m) == _flat(jaxes.opt.m) == want
    assert _flat(taxes.opt.v) == _flat(jaxes.opt.v) == want
    assert taxes.opt.step == jaxes.opt.step == ()
    t_opt = t_opt_axes(tpart.param_axes(params))
    j_opt = j_opt_axes(jpart.param_axes(jparams))
    assert _flat(t_opt.m) == _flat(j_opt.m) == want
    assert _flat(t_opt.v) == _flat(j_opt.v) == want
    assert t_opt.step == j_opt.step == ()
    for name in specs:
        jb = {k: v for k, v in jspecs[name].items() if k != "cache"}
        tb = {k: v for k, v in specs[name].items() if k != "cache"}
        assert _flat(tpart.batch_axes(tb)) == _flat(jpart.batch_axes(jb))
        if "cache" in specs[name]:
            assert _flat(tpart.cache_axes(specs[name]["cache"])) == \
                _flat(jpart.cache_axes(jspecs[name]["cache"]))


@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch, smoke):
    _, _, _, _, jspecs, specs = _trees(arch, smoke)
    shapes = tconfigs.SMOKE_SHAPES if smoke else tconfigs.SHAPES
    assert set(specs) == set(shapes)
    for name in shapes:
        got, want = _flat(specs[name]), _flat(jspecs[name])
        assert set(got) == set(want), name
        for path, leaf in got.items():
            assert leaf.device.type == "meta"
            assert _shape(leaf) == _shape(want[path]), (name, path)
            assert _dtype(leaf) == _dtype(want[path]), (name, path)


def _leaves_with_axes(arch, smoke):
    """(shape, logical axes) of every leaf of the param, train-state,
    cache and batch trees."""
    jparams, params, jstate, state, jspecs, specs = _trees(arch, smoke)
    out = []
    p_axes = _flat(tpart.param_axes(params))
    for path, leaf in _flat(params).items():
        out.append((_shape(leaf), p_axes[path]))
    out.append(((), ()))                              # the step
    for name in specs:
        tb = {k: v for k, v in specs[name].items() if k != "cache"}
        b_axes = _flat(tpart.batch_axes(tb))
        for path, leaf in _flat(tb).items():
            out.append((_shape(leaf), b_axes[path]))
        if "cache" in specs[name]:
            c = specs[name]["cache"]
            c_axes = _flat(tpart.cache_axes(c))
            for path, leaf in _flat(c).items():
                out.append((_shape(leaf), c_axes[path]))
    return sorted(set(out), key=repr)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("smoke", [False, True], ids=["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS)
def test_resolve_spec_matches_jax_on_every_leaf(arch, smoke, mesh):
    m = MESHES[mesh]
    leaves = _leaves_with_axes(arch, smoke)
    assert leaves
    for rules in RULES.values():
        for shape, axes in leaves:
            want = tuple(jsh.resolve_spec(shape, axes, m,
                                          getattr(jsh, rules)))
            got = tsh.resolve_spec(shape, axes, m, getattr(tsh, rules))
            assert got == want, (rules, shape, axes)


def test_rule_tables_are_the_jax_packages():
    for rules in RULES.values():
        assert getattr(tsh, rules) == getattr(jsh, rules)
    assert tpart.PARAM_AXES == jpart.PARAM_AXES
    assert tpart.CACHE_AXES == jpart.CACHE_AXES
    assert tpart.BATCH_AXES == jpart.BATCH_AXES


def test_an_unregistered_leaf_raises_as_in_jax():
    with pytest.raises(KeyError) as want:
        jpart.param_axes({"groups": {"0": {"foo": np.zeros((2, 3))}}})
    with pytest.raises(KeyError) as got:
        tpart.param_axes({"groups": {"0": {"foo": torch.zeros((2, 3))}}})
    assert str(got.value) == str(want.value)


#: activations as the JAX package's three sites hint them, and some
#: shapes where a dim does not divide
HINT_CASES = [((256, 4096, 2048), ("batch", None, None)),
              ((256, 1024, 51200), ("batch", None, "vocab")),
              ((2, 128, 6144), ("batch", None, None)),
              ((1, 1, 262144), ("batch", None, "vocab")),
              ((32, 1024, 49155), ("batch", None, "vocab")),
              ((512, 16, 4096), ("batch", "heads", None)),
              ((8, 56, 128), ("batch", "heads", "head_dim"))]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("rules", list(RULES))
def test_hint_resolves_as_jax(monkeypatch, rules, mesh):
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(spec) or x)
    mapping = jact.mapping_from_mesh(MESHES[mesh],
                                     getattr(jsh, RULES[rules]))
    for shape, axes in HINT_CASES:
        x = types.SimpleNamespace(shape=shape)
        seen.clear()
        with jact.activation_sharding(mapping):
            jact.hint(x, axes)
        with tact.activation_sharding(mapping):
            got = tact.hint_parts(shape, axes)
        want = tuple(seen[0]) if seen else None
        assert got == want, (shape, axes)
    assert tact.hint_parts((8, 4), ("batch", None)) is None  # no context


# ---------------------------------------------------------------------------
# tests/test_sharding.py::TestResolver, on the port's resolver
# ---------------------------------------------------------------------------
class TestResolver:
    def test_fsdp_weight(self):
        spec = tsh.resolve_spec((2048, 8192), ("embed", "mlp"), SINGLE,
                                tsh.TRAIN_RULES)
        assert spec == tuple(P("data", "model"))

    def test_kv_heads_fallback_replicates(self):
        # 8 kv heads unsplittable over model=16 -> replicated
        spec = tsh.resolve_spec((2048, 8, 128), ("embed", "kv_heads",
                                                 "head_dim"), SINGLE,
                                tsh.TRAIN_RULES)
        assert spec == tuple(P("data", None, None))

    def test_batch_takes_pod_and_data(self):
        spec = tsh.resolve_spec((256, 4096), ("batch", "seq"), MULTI,
                                tsh.TRAIN_RULES)
        assert spec == tuple(P(("pod", "data"), None))

    def test_batch_partial_prefix(self):
        # batch 2 divisible by pod(2) but not pod*data(32)
        spec = tsh.resolve_spec((2, 128), ("batch", "seq"), MULTI,
                                tsh.TRAIN_RULES)
        assert spec == tuple(P("pod", None))

    def test_flash_decode_fallback(self):
        """batch=1 can't shard -> the cache sequence axis claims data."""
        spec = tsh.resolve_spec((1, 8, 524288, 128),
                                ("batch", "kv_heads", "cache_seq",
                                 "head_dim"), SINGLE, tsh.SERVE_RULES)
        assert spec == tuple(P(None, None, "data", None))

    def test_no_double_use_of_axis(self):
        spec = tsh.resolve_spec((128, 16, 32768, 128),
                                ("batch", "kv_heads", "cache_seq",
                                 "head_dim"), SINGLE, tsh.SERVE_RULES)
        # batch grabbed data; kv got model; cache_seq must NOT reuse either
        assert spec == tuple(P("data", "model", None, None))

    def test_padded_vocab_divisible(self):
        for arch in tconfigs.ARCH_IDS:
            cfg = tconfigs.get_config(arch)
            assert cfg.padded_vocab % 16 == 0, arch
            assert cfg.padded_vocab >= cfg.vocab

    def test_all_dims_product_divides(self):
        """Property: any resolved spec's axis product divides the dim."""
        rng = np.random.default_rng(0)
        for _ in range(200):
            dims = tuple(int(d) for d in rng.integers(1, 4096, 3))
            axes = tuple(rng.choice(list(tsh.TRAIN_RULES)) for _ in range(3))
            spec = tsh.resolve_spec(dims, axes, MULTI, tsh.TRAIN_RULES)
            for dim, part in zip(dims, spec):
                if part is None:
                    continue
                parts = part if isinstance(part, tuple) else (part,)
                prod = int(np.prod([MULTI.shape[p] for p in parts]))
                assert dim % prod == 0
