"""The port's mixture-of-experts FFN (``models/layers.py``: ``init_moe``,
``moe_route``, ``moe_ffn``, ``moe_ffn_shard_map``; ``models/act_shard.py``)
against the JAX package on the CPU, at the smoke configs of mixtral-8x22b
and arctic-480b (4 experts, top 2, d_model 64, d_ff 128, f32; arctic with
its dense residual).  The JAX package's params cross with
``params_from_numpy``; tokens are numpy draws from a seed.

Tolerances:

* ``moe_ffn`` within 1e-5·max|y| of the JAX package's at capacity factors
  0.05, 1.25 and 8.0 (the tokens are skewed toward some experts, so 1.25
  drops slots), with the dropped token-slots counted alike: the port's
  ``dropped_slots`` equals the count from JAX's ``top_k`` indices, and
  which slots drop equals the reference's (the stable sort, token-major);
* E = 1 with top-1 equals ``mlp``, and permuting the experts (router
  columns with them) leaves y unchanged, within 1e-5·max|y|;
* decode equals teacher forcing at capacity 8.0 (nothing drops) within
  atol 2e-4 and rtol 1e-3 (tests/test_models.py's);
* ``moe_ffn_shard_map`` with no context, or a mapping without ``"mlp"``:
  bitwise ``moe_ffn``; in a world of 1 here (gloo, a 1 x 1 data x model
  mesh): bitwise ``moe_ffn``;
* a gloo world of 4 (data 2 x model 2; tests/torch_moe_ranks.py in fresh
  interpreters): every rank's output bitwise every other's, and within
  1e-5·max|y| of JAX's ``moe_ffn`` applied to each data shard's tokens
  (group-local routing, drops at 1.25); arctic's dense residual also
  within 1e-5·max|y| of the global ``moe_ffn`` at 8.0; the fallbacks (B
  not divisible by the data ways, d_ff by the model ways) bitwise
  ``moe_ffn``;
* ``mapping_from_mesh`` equal to the JAX package's for the same axis
  names and sizes;
* ``init_moe``'s leaves, shapes and dtypes equal JAX's (with and without
  the dense residual, f32 and bf16); ``params_from_numpy`` carries the
  MoE leaves bitwise in f32 and bf16;
* exact router ties go to the lower expert, as JAX's ``top_k``;
  ``route_agreement`` tells a flipped near tie from a flip past it;
  ``apply_block`` takes ``moe_ffn_shard_map`` under ``moe_impl=
  "shard_map"`` (bitwise ``moe_ffn`` with no context).
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

import torch_moe_ranks as R
from repro.configs import get_config as j_get_config
from repro.launch.sharding import TRAIN_RULES
from repro.models import init_params as j_init_params
from repro.models.act_shard import mapping_from_mesh as j_mapping_from_mesh
from repro.models.layers import init_moe as j_init_moe
from repro.models.layers import moe_ffn as j_moe_ffn
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import (decode_step, forward_hidden, init_params,
                                logits_from_hidden, num_params, prefill)
from repro_torch.models.act_shard import (activation_sharding,
                                          current_mapping, current_mesh,
                                          mapping_from_mesh)
from repro_torch.models.layers import (dropped_slots, init_moe, mlp,
                                       moe_ffn, moe_ffn_shard_map, moe_route)

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
RANK_TIMEOUT_S = 300
MOE_ARCHS = ("mixtral-8x22b", "arctic-480b")
REL = 1e-5


def _cfgs(arch, **overrides):
    return (dataclasses.replace(j_get_config(arch, smoke=True), **overrides),
            dataclasses.replace(get_config(arch, smoke=True), **overrides))


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 0
    assert np.abs(got - want).max() <= rel * scale, \
        f"max |err| {np.abs(got - want).max()} over {rel * scale}"


def _jax_dropped(jcfg, p, x) -> int:
    """Token-slots past capacity from the JAX package's router and
    ``top_k`` (the count a capacity drop must take)."""
    d = x.shape[-1]
    xt = jnp.asarray(x).reshape(-1, d)
    logits = jnp.einsum("td,de->te", xt, jnp.asarray(p["router"]),
                        preferred_element_type=jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    t = xt.shape[0]
    cap = int(np.ceil(t * jcfg.top_k * jcfg.capacity_factor
                      / jcfg.num_experts))
    counts = np.bincount(np.asarray(eidx).reshape(-1),
                         minlength=jcfg.num_experts)
    return int(np.maximum(counts - cap, 0).sum())


def _jax_kept(jcfg, p, x) -> np.ndarray:
    """(T, k) whether each of the reference's token-slots passes capacity:
    the first C slots of an expert in token-major order."""
    d = x.shape[-1]
    xt = jnp.asarray(x).reshape(-1, d)
    logits = jnp.einsum("td,de->te", xt, jnp.asarray(p["router"]),
                        preferred_element_type=jnp.float32)
    _, eidx = jax.lax.top_k(jax.nn.softmax(logits, -1), jcfg.top_k)
    eidx = np.asarray(eidx)
    cap = int(np.ceil(eidx.size * jcfg.capacity_factor / jcfg.num_experts))
    seen = np.zeros(jcfg.num_experts, int)
    kept = np.zeros(eidx.shape, bool)
    for t in range(eidx.shape[0]):
        for j in range(eidx.shape[1]):
            e = eidx[t, j]
            kept[t, j] = seen[e] < cap
            seen[e] += 1
    return kept


def _port_kept(route, t, k) -> np.ndarray:
    """(T, k) from the port's Route: the slot (token, its j-th choice)."""
    kept = np.zeros((t, k), bool)
    eidx = route.eidx.numpy()
    for st, se, keep in zip(route.st.numpy(), route.se.numpy(),
                            route.keep.numpy()):
        kept[st, list(eidx[st]).index(se)] = keep
    return kept


# ---------------------------------------------------------------------------
# the gloo world of 4, started with the module
# ---------------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(PYTHONPATH=os.pathsep.join([SRC, TESTS]), OMP_NUM_THREADS="1")
    return env


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Starts the world's four ranks with the module, so they run while
    the in-process tests do; kills what is left at the end."""
    out = tmp_path_factory.mktemp("moe_world4")
    store = str(out / "store")
    procs = []
    try:
        for rank in range(R.WORLD):
            code = (f"import torch_moe_ranks as r; "
                    f"r.main({rank}, {R.WORLD}, {store!r}, {str(out)!r})")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=_env(), cwd=TESTS,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        yield out, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def world4(launched):
    """Each rank's (arrays, mapping); fails if a rank exited nonzero or
    outlived its timeout."""
    out, procs = launched
    logs = [p.communicate(timeout=RANK_TIMEOUT_S)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i} exited {p.returncode}:\n{log}"
    ranks = []
    for rank in range(R.WORLD):
        with np.load(out / f"rank{rank}.npz") as z:
            arrays = {k: z[k] for k in z.files}
        with open(out / f"rank{rank}.json") as f:
            ranks.append((arrays, json.load(f)))
    return ranks


def _case(name):
    return next(c for c in R.CASES if c[0] == name)


def _jax_inputs(name):
    _, arch, cf, batch, d_ff = _case(name)
    cfg = R.config(arch, cf, d_ff)
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True),
                               capacity_factor=cf)
    p = R.moe_params(cfg)
    return jcfg, jax.tree_util.tree_map(jnp.asarray, p), R.tokens(cfg, batch)


def test_world4_ranks_agree_bitwise(world4):
    arrays0 = world4[0][0]
    for arrays, _ in world4[1:]:
        assert set(arrays) == set(arrays0)
        for k in arrays0:
            np.testing.assert_array_equal(arrays[k], arrays0[k], err_msg=k)


@pytest.mark.parametrize("name", ["mixtral_1.25", "arctic_1.25",
                                  "arctic_8.0"])
def test_world4_routes_each_data_shard_locally(world4, name):
    """Each data shard's tokens routed alone (capacity per group) and its
    experts' f-slices summed over the model axis: JAX's moe_ffn on each
    shard's tokens.  At 1.25 the shards drop slots, and the global
    routing would give another answer."""
    jcfg, jp, x = _jax_inputs(name)
    half = x.shape[0] // R.MESH[0]
    shards = [x[i * half:(i + 1) * half] for i in range(R.MESH[0])]
    want = np.concatenate([np.asarray(j_moe_ffn(jcfg, jp, jnp.asarray(s)))
                           for s in shards])
    got = world4[0][0][name]
    _close(got, want)
    drops = [_jax_dropped(jcfg, jp, s) for s in shards]
    if jcfg.capacity_factor == 1.25:
        assert min(drops) > 0, drops
        glob = np.asarray(j_moe_ffn(jcfg, jp, jnp.asarray(x)))
        assert np.abs(glob - want).max() > 100 * REL * np.abs(want).max()
    else:
        assert drops == [0] * len(shards)
        # no drop: group-local routing is the global one
        _close(got, np.asarray(j_moe_ffn(jcfg, jp, jnp.asarray(x))))


@pytest.mark.parametrize("name", R.FALLBACKS)
def test_world4_falls_back_to_moe_ffn(world4, name):
    arrays = world4[0][0]
    np.testing.assert_array_equal(arrays[name], arrays[name + "/moe_ffn"])
    jcfg, jp, x = _jax_inputs(name)
    jcfg = dataclasses.replace(jcfg, d_ff=_case(name)[4] or jcfg.d_ff)
    _close(arrays[name], np.asarray(j_moe_ffn(jcfg, jp, jnp.asarray(x))))


def test_world4_mapping_is_the_jax_mapping(world4):
    want = j_mapping_from_mesh(AbstractMesh(R.MESH, R.AXES), R.RULES)
    want = {k: [list(p) for p in v] for k, v in want.items()}
    for _, mapping in world4:
        assert mapping == want
    assert mapping["batch"] == [["data", 2]]
    assert mapping["mlp"] == [["model", 2]]


# ---------------------------------------------------------------------------
# a world of 1 in this process
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh1(tmp_path_factory):
    from torch.distributed.device_mesh import DeviceMesh
    store = dist.FileStore(str(tmp_path_factory.mktemp("moe_world1")
                               / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield DeviceMesh("cpu", [[0]], mesh_dim_names=R.AXES)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_world1_shard_map_is_moe_ffn(mesh1, arch):
    """One data shard and one f-slice: the shard_map path is moe_ffn to
    the bit (mixtral: no dense residual; arctic's dense residual keeps
    its f32 partial as the reference's does, equal here in f32)."""
    cfg = R.config(arch, 1.25)
    p = params_from_numpy(R.moe_params(cfg), device="cpu")
    x = torch.from_numpy(R.tokens(cfg, R.B))
    mapping = mapping_from_mesh(mesh1, TRAIN_RULES)
    assert mapping == j_mapping_from_mesh(AbstractMesh((1, 1), R.AXES),
                                          TRAIN_RULES)
    assert mapping["batch"] == (("data", 1),)
    assert mapping["mlp"] == (("model", 1),)
    with activation_sharding(mapping, mesh=mesh1):
        assert current_mesh() is mesh1 and current_mapping() == mapping
        got = moe_ffn_shard_map(cfg, p, x)
    assert current_mesh() is None and current_mapping() is None
    assert torch.equal(got, moe_ffn(cfg, p, x))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_shard_map_without_a_context_is_moe_ffn(arch):
    cfg = R.config(arch, 1.25)
    p = params_from_numpy(R.moe_params(cfg), device="cpu")
    x = torch.from_numpy(R.tokens(cfg, R.B))
    want = moe_ffn(cfg, p, x)
    assert torch.equal(moe_ffn_shard_map(cfg, p, x), want)
    with activation_sharding({"batch": (("data", 2),)}, mesh=object()):
        assert torch.equal(moe_ffn_shard_map(cfg, p, x), want)


# ---------------------------------------------------------------------------
# moe_ffn against the JAX package
# ---------------------------------------------------------------------------
def _skewed(cfg, b, s, seed):
    """(b, s, d) tokens skewed toward some experts (as R.tokens)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model))
    x += 1.5 * rng.standard_normal(cfg.d_model)
    return x.astype(np.float32)


def _moe_params(jcfg, seed=0):
    jp = j_init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@pytest.mark.parametrize("cf", [0.05, 1.25, 8.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_ffn_matches_jax(arch, cf):
    jcfg, cfg = _cfgs(arch, capacity_factor=cf)
    jp, p = _moe_params(jcfg)
    x = _skewed(cfg, 2, 32, 5)
    want = np.asarray(j_moe_ffn(jcfg, jp, jnp.asarray(x)))
    got = moe_ffn(cfg, p, torch.from_numpy(x))
    _close(got.numpy(), want)
    route = moe_route(cfg, p, torch.from_numpy(x).reshape(-1, cfg.d_model))
    dropped = int(dropped_slots(route))
    assert dropped == _jax_dropped(jcfg, jp, x)
    np.testing.assert_array_equal(
        _port_kept(route, x.shape[0] * x.shape[1], cfg.top_k),
        _jax_kept(jcfg, jp, x))
    if cf < 8.0:
        assert dropped > 0
    else:
        assert dropped == 0


def test_route_matches_jax_top_k_on_exact_ties():
    """Equal router probabilities: JAX's top_k takes the lower expert
    first, and so does the port (a stable descending sort)."""
    jcfg, cfg = _cfgs("mixtral-8x22b", capacity_factor=8.0)
    jp, p = _moe_params(jcfg)
    p["router"] = torch.zeros_like(p["router"])
    p["router"][:, 3] = 1.0
    x = torch.from_numpy(_skewed(cfg, 1, 8, 2)).abs()
    route = moe_route(cfg, p, x.reshape(-1, cfg.d_model))
    zeros = np.zeros_like(np.asarray(jp["router"]))
    zeros[:, 3] = 1.0
    logits = jnp.einsum("td,de->te", jnp.asarray(x.numpy()).reshape(
        -1, cfg.d_model), jnp.asarray(zeros))
    _, jidx = jax.lax.top_k(jax.nn.softmax(logits, -1), cfg.top_k)
    np.testing.assert_array_equal(route.eidx.numpy(), np.asarray(jidx))
    assert (route.eidx[:, 1] == 0).all()


def test_single_expert_equals_mlp():
    """E = 1, top-1, ample capacity: the expert is the MLP with its
    weights (the JAX package's TestMoE case, in the port)."""
    jcfg, cfg = _cfgs("mixtral-8x22b", num_experts=1, top_k=1,
                      capacity_factor=4.0)
    _, p = _moe_params(jcfg)
    x = torch.from_numpy(_skewed(cfg, 2, 16, 3))
    dense = {"w_gate": p["we_gate"][0], "w_up": p["we_up"][0],
             "w_down": p["we_down"][0]}
    _close(moe_ffn(cfg, p, x).numpy(), mlp(cfg, dense, x).numpy())


def test_expert_permutation_leaves_the_output():
    """Permuting the experts and the router's columns with them changes
    nothing (the JAX package's TestMoE case, in the port)."""
    jcfg, cfg = _cfgs("mixtral-8x22b", capacity_factor=8.0)
    _, p = _moe_params(jcfg)
    x = torch.from_numpy(_skewed(cfg, 1, 8, 4))
    perm = torch.tensor([2, 0, 3, 1])
    p2 = dict(p, router=p["router"][:, perm], we_gate=p["we_gate"][perm],
              we_up=p["we_up"][perm], we_down=p["we_down"][perm])
    _close(moe_ffn(cfg, p2, x).numpy(), moe_ffn(cfg, p, x).numpy())


def test_capacity_drops_shrink_the_output():
    jcfg, cfg = _cfgs("mixtral-8x22b")
    _, p = _moe_params(jcfg)
    x = torch.from_numpy(_skewed(cfg, 2, 32, 6))
    small = moe_ffn(dataclasses.replace(cfg, capacity_factor=0.05), p, x)
    big = moe_ffn(dataclasses.replace(cfg, capacity_factor=8.0), p, x)
    assert float(small.norm()) < 0.8 * float(big.norm())


# ---------------------------------------------------------------------------
# params and the model stack
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dense", [False, True])
def test_init_moe_follows_the_jax_layout(dense, dtype):
    jcfg, cfg = _cfgs("mixtral-8x22b", dense_residual=dense,
                      param_dtype=dtype)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        j_init_moe(jax.random.PRNGKey(0), jcfg))
    for lead in ((), (3,)):
        got = init_moe(cfg, torch.Generator().manual_seed(1), "cpu", lead)
        assert set(got) == set(want) and ("dense" in got) == dense

        def walk(t, w):
            if isinstance(t, dict):
                assert set(t) == set(w)
                for k in t:
                    walk(t[k], w[k])
            else:
                assert tuple(t.shape) == lead + w[0]
                assert str(t.dtype).replace("torch.", "") == w[1]
        walk(got, want)
    we = got["we_gate"].float()
    assert abs(float(we.std()) * cfg.d_model ** 0.5 - 1) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_params_from_numpy_carries_the_moe_leaves(arch, dtype):
    jcfg, cfg = _cfgs(arch, param_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, j_init_params(
        jax.random.PRNGKey(0), jcfg))
    params = params_from_numpy(tree, device="cpu")
    moe = params["groups"]["0"]["mlp"]
    jmoe = tree["groups"]["0"]["mlp"]
    names = ["router", "we_gate", "we_up", "we_down"]
    if jcfg.dense_residual:
        moe = dict(moe, **{f"dense.{k}": v for k, v in moe["dense"].items()})
        jmoe = dict(jmoe, **{f"dense.{k}": v
                             for k, v in jmoe["dense"].items()})
        names += ["dense.w_gate", "dense.w_up", "dense.w_down"]
    for name in names:
        got, want = moe[name], jmoe[name]
        assert got.dtype == getattr(torch, dtype)
        assert tuple(got.shape) == want.shape
        if dtype == "bfloat16":
            np.testing.assert_array_equal(
                got.view(torch.int16).numpy().view(np.uint16),
                want.view(np.uint16))
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    assert num_params(params)[0] == cfg.num_params() == jcfg.num_params()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_params_counts_the_config(arch):
    cfg = get_config(arch, smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    assert num_params(params)[0] == cfg.num_params()
    assert params["groups"]["0"]["mlp"]["we_gate"].shape == (
        cfg.n_groups, cfg.num_experts, cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_matches_teacher_forcing(arch):
    """tests/test_models.py's check at capacity 8.0 (no slot drops, so
    decode's B tokens and the forward's B·(S + 3) route alike)."""
    jcfg, cfg = _cfgs(arch, capacity_factor=8.0)
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    B, S = 2, 32
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(B, S + 3)).astype(np.int32))
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


def test_moe_ffn_follows_moe_impl_in_the_block():
    """apply_block picks moe_ffn_shard_map under moe_impl="shard_map":
    without a context both give the same forward, bitwise."""
    jcfg, cfg = _cfgs("arctic-480b")
    params = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_init_params(jax.random.PRNGKey(0), jcfg)),
        device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, size=(2, 16)).astype(np.int32))
    h, _ = forward_hidden(cfg, params, toks)
    hs, _ = forward_hidden(dataclasses.replace(cfg, moe_impl="shard_map"),
                           params, toks)
    assert torch.equal(h, hs)


def test_route_agreement_tells_near_ties_from_real_flips():
    """Token 0's second choice lies 1e-5 above its third in one routing
    and below it in the other (a near tie that flips); token 1 flips its
    second expert by a wide margin (unexplained); token 2 agrees."""
    from repro_torch.models.layers import near_ties, route_agreement
    _, cfg = _cfgs("mixtral-8x22b", capacity_factor=8.0)
    d = cfg.d_model
    router = torch.zeros((d, cfg.num_experts))
    router[:cfg.num_experts] = torch.eye(cfg.num_experts)
    p = {"router": router}

    def route(rows):
        x = torch.zeros((len(rows), d))
        x[:, :cfg.num_experts] = torch.tensor(rows)
        return moe_route(cfg, p, x)
    a = route([[3.0, 1.0, 1.0 + 1e-5, 0.0], [3.0, 2.0, 0.0, 0.0],
               [0.0, 0.0, 2.0, 3.0]])
    b = route([[3.0, 1.0 + 1e-5, 1.0, 0.0], [3.0, 0.0, 2.0, 0.0],
               [0.0, 0.0, 2.0, 3.0]])
    assert near_ties(a).tolist() == [True, False, False]
    agree, ties, unexplained = route_agreement(a, b)
    assert agree.tolist() == [False, False, True]
    assert ties.tolist() == [True, False, False]
    assert unexplained == 1
    assert route_agreement(a, a)[2] == 0
