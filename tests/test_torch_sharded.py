"""The sharded path (``launch/sharding.distribute_tree``, ``models/
sharded.py``, ``act_shard.hint``, AdamW on local shards) on the CPU.

With the module, seven fresh interpreters start (the rank programs are
tests/torch_sharded_ranks.py's; none forks this process):

* a gloo world of 4 (data 2 x model 2, ``TRAIN_RULES`` for training,
  ``SERVE_RULES`` for serving): every architecture's smoke config (f32)
  through one ``make_train_step`` on a state placed by
  ``distribute_tree``, each rank's local shards of the new params, m and
  v against the slices of the unsharded step's (run on every rank from
  the same seeds) within tests/test_torch_train_archs.py's bounds: loss
  and grad_norm within 1e-5 relative, m and v within 3e-5 of each leaf's
  largest value, params within two f32 ulps plus 1e-3·lr (AdamW eps 1e-3,
  as there); each rank's local shapes equal to ``resolve_spec``'s cut of
  the global shape; a prefill and 2 greedy decode steps whose logits lie
  within 1e-5 of the largest unsharded logit; mixtral-8x22b and
  arctic-480b also under ``moe_impl="shard_map"`` at capacity factor
  8.0, where the group-local routing drops nothing and so is the
  unsharded global routing; granite-3-2b under the rules of
  chip_smoke.py's world of 4 on the card (no FSDP split of "embed"); and
  batch-1 decode in the flash-decoding layout (an unsharded prefill's
  cache placed by ``SERVE_RULES``, its ring slots over data) for a full,
  an swa and a local/global config, 10 greedy steps within 1e-5 of the
  largest unsharded logit (f32), a cache whose slot_pos is replicated
  while its slots are split refused, and at batch 4 a placed cache whose
  slot_pos alone splits (gathered for each step);
* a world of one gloo rank (mesh 1 x 1): two train steps, the prefill and
  the decode steps bitwise the unsharded ones, for every architecture but
  arctic-480b, whose dense residual is a ``local_map`` of its own beside
  the routed experts (its train steps within the bounds above); and
  ``flash_attention`` given a DTensor raises;
* ``make_production_mesh`` over a fake process group of 256 and 512
  ranks: the JAX package's shapes and axis names;
* a JAX subprocess on 4 forced host devices running
  tests/test_distributed.py's sharded train step at 2 x 2 for
  granite-3-2b and mixtral-8x22b (``moe_impl="gspmd"``, capacity factor
  8.0), from the same numpy params and batch; the port's world of 4
  within the bounds above of JAX's new state and metrics.

In-process (no process group): ``hint`` is the identity with no context
or on a plain tensor; a rank's local heads read the kv heads of their
global indices (``kv_heads_for``: granite-3-2b's 32 query and 8 kv heads
at model 16 give rank r query heads 2r, 2r + 1 and kv head r // 2), and
the local self-attentions' partial outputs sum to the whole one.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_sharded_ranks as R
from repro_torch.configs import ARCH_IDS
from repro_torch.models import hint
from repro_torch.models import layers as L
from repro_torch.models.act_shard import activation_sharding
from repro_torch.models.config import ModelConfig

torch.set_num_threads(1)

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(TESTS, "..", "src")
TIMEOUT_S = 300

_JAX4_SCRIPT = r"""
import dataclasses, sys
import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import torch_sharded_ranks as R
from repro.configs import get_config
from repro.launch.sharding import TRAIN_RULES, resolve_tree
from repro.models.act_shard import activation_sharding, mapping_from_mesh
from repro.models.partitioning import batch_axes
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.train.steps import TrainState, make_train_step, train_state_axes

assert jax.device_count() == 4
mesh = Mesh(np.array(jax.devices()).reshape(R.MESH), R.AXES)
opt = AdamWConfig(**R.OPT)


def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{path}/{k}"))
        return out
    return {path: np.asarray(tree, np.float32)}


for arch in R.JAX_ARCHS:
    tcfg = R.config(arch)
    cfg = get_config(arch, smoke=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=R.JAX_CAPACITY,
                                  moe_impl="gspmd")
    params = jax.tree_util.tree_map(jnp.asarray, R.numpy_params(tcfg))
    batch = {k: jnp.asarray(v) for k, v in R.numpy_batch(tcfg).items()}
    state = TrainState(params, adamw_init(params, opt))
    ss = jax.eval_shape(lambda: state)
    st_sh = resolve_tree(ss, train_state_axes(ss), mesh, TRAIN_RULES)
    b_sh = resolve_tree(batch, batch_axes(batch), mesh, TRAIN_RULES)
    state = jax.device_put(state, st_sh)
    batch = jax.device_put(batch, b_sh)
    with mesh, activation_sharding(mapping_from_mesh(mesh, TRAIN_RULES)):
        step = jax.jit(make_train_step(cfg, opt), in_shardings=(st_sh, b_sh),
                       out_shardings=(st_sh, None))
        new, m = step(state, batch)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}
    for part, tree in (("params", new.params), ("m", new.opt.m),
                       ("v", new.opt.v)):
        out.update({part + k: v for k, v in flat(tree).items()})
    np.savez(sys.argv[1] + f"/jaxref_{arch}.npz", **out)
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [TESTS, SRC] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH")
                        else []))
    env.update(extra)
    return env


@pytest.fixture(scope="module", autouse=True)
def launched(tmp_path_factory):
    """Starts the world of 4, the world of one, the fake-group meshes and
    the JAX subprocess, which run while the in-process tests do.  Yields
    (output directory, processes); kills what is left."""
    out = tmp_path_factory.mktemp("sharded")
    procs = []
    codes = [f"import torch_sharded_ranks as r; r.main({rank}, {R.WORLD}, "
             f"{str(out / 'store4')!r}, {str(out)!r})"
             for rank in range(R.WORLD)]
    codes.append(f"import torch_sharded_ranks as r; "
                 f"r.world1({str(out / 'store1')!r}, {str(out)!r})")
    codes.append(f"import torch_sharded_ranks as r; "
                 f"r.production_meshes({str(out)!r})")
    try:
        for code in codes:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], env=_env(), cwd=TESTS,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _JAX4_SCRIPT, str(out)], cwd=TESTS,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=4",
                     JAX_PLATFORMS="cpu")))
        yield out, procs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def spawned(launched):
    """The output directory once every process exited 0 within its
    timeout."""
    out, procs = launched
    logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"process {i} exited {p.returncode}:\n" \
                                  f"{log[-4000:]}"
    return out


@pytest.fixture(scope="module")
def world4(spawned):
    ranks = []
    for rank in range(R.WORLD):
        with open(spawned / f"rank{rank}.json") as f:
            ranks.append(json.load(f))
    return ranks


def _within(pair):
    got, bound = pair
    return got <= bound


@pytest.mark.parametrize("arch", ARCH_IDS + R.CASES)
def test_world4_train_step_matches_the_unsharded_step(world4, arch):
    for res in world4:
        train = res[arch]["train"]
        assert train["step"] == 1
        for key in ("loss", "grad_norm", "tokens", "lr"):
            assert _within(train[f"err/{key}"]), (key, train)
        assert train["state_ok"], train["worst"]


@pytest.mark.parametrize("arch", ARCH_IDS + R.CASES)
def test_world4_local_shards_are_resolve_specs(world4, arch):
    assert sorted(tuple(r["coordinate"]) for r in world4) == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for res in world4:
        assert res[arch]["train"]["shapes_ok"]


@pytest.mark.parametrize("arch", ARCH_IDS + R.CASES)
def test_world4_prefill_and_decode_match_the_unsharded_path(world4, arch):
    for res in world4:
        errs = res[arch]["serve"]["logit_errs"]
        assert len(errs) == 1 + R.DECODE_STEPS
        assert all(_within(e) for e in errs), errs


@pytest.mark.parametrize("arch", R.FLASH_ARCHS)
def test_world4_flash_decoding_matches_the_unsharded_decode(world4, arch):
    for res in world4:
        case = res[f"flash:{arch}"]
        assert case["slots_split"] and all(case["slots_split"])
        assert len(case["logit_errs"]) == R.FLASH_STEPS
        assert all(_within(e) for e in case["logit_errs"]), \
            case["logit_errs"]
        assert case["misplaced_refused"]


def test_world4_decode_of_a_placed_cache_gathers_slot_pos(world4):
    """At batch 4 the batch takes data, so only slot_pos (no batch dim)
    splits its slots: gathered for each step, written back after it."""
    for res in world4:
        case = res["placed:granite-3-2b"]
        assert not any(case["slots_split"])
        assert case["slot_pos_split"] and all(case["slot_pos_split"])
        assert len(case["logit_errs"]) == R.FLASH_STEPS
        assert all(_within(e) for e in case["logit_errs"]), \
            case["logit_errs"]


def test_hint_is_the_identity_without_a_context(world4):
    x = torch.arange(6.0).reshape(2, 3)
    assert hint(x, ("batch", None)) is x
    with activation_sharding({"batch": (("data", 2),)}):
        assert hint(x, ("batch", None)) is x          # a plain tensor
    assert all(r["hint_identity"] for r in world4)


@pytest.fixture(scope="module")
def world1(spawned):
    with open(spawned / "world1.json") as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_world1_is_bitwise_the_unsharded_steps(world1, arch):
    res = world1[arch]
    assert all(res["serve_bitwise"]) and len(res["serve_bitwise"]) == 3
    diffs = res["train_diffs"]
    assert len(diffs) > 2
    if arch == "arctic-480b":
        assert diffs["loss"] <= R.LOSS_REL * res["loss"]
        assert max(diffs.values()) <= 1e-3 * R.OPT["lr"]
    else:
        assert max(diffs.values()) == 0.0, {k: v for k, v in diffs.items()
                                            if v}


def test_world1_flash_attention_rejects_a_dtensor(world1):
    assert world1["flash_attention_dtensor"] == "TypeError"


def test_production_meshes_have_the_jax_shapes(spawned):
    with open(spawned / "meshes.json") as f:
        res = json.load(f)
    assert res["False"]["shape"] == [16, 16]
    assert res["False"]["names"] == ["data", "model"]
    assert res["False"]["data_axes"] == ["data"]
    assert res["False"]["coordinate"] == [2, 5]          # rank 37
    assert res["True"]["shape"] == [2, 16, 16]
    assert res["True"]["names"] == ["pod", "data", "model"]
    assert res["True"]["data_axes"] == ["pod", "data"]
    assert res["True"]["coordinate"] == [1, 2, 12]       # rank 300


@pytest.mark.parametrize("arch", R.JAX_ARCHS)
def test_world4_matches_the_jax_packages_sharded_step(spawned, arch):
    with np.load(spawned / f"jax_{arch}.npz") as z:
        got = {k: z[k] for k in z.files}
    with np.load(spawned / f"jaxref_{arch}.npz") as z:
        want = {k: z[k] for k in z.files}
    assert set(got) == set(want)
    for key in ("loss", "grad_norm"):
        assert abs(float(got[key]) - float(want[key])) <= \
            R.LOSS_REL * abs(float(want[key])), key
    for key in want:
        if key in ("loss", "grad_norm"):
            continue
        g, w = got[key], want[key]
        assert g.shape == w.shape, key
        if key.startswith("params"):
            tol = 2 * np.spacing(np.abs(w)) + R.PARAM_LR * R.OPT["lr"]
            assert bool((np.abs(g - w) <= tol).all()), key
        else:
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= R.STATE_REL * scale, key


# ---------------------------------------------------------------------------
# a rank's local heads (no process group)
# ---------------------------------------------------------------------------
def _gqa_cfg(heads=32, kv=8, dh=4, d=16):
    return ModelConfig(name="gqa", family="dense", n_layers=1, d_model=d,
                       n_heads=heads, n_kv_heads=kv, head_dim=dh, d_ff=0,
                       vocab=64, compute_dtype="float32", attn_block_q=8,
                       attn_block_k=8)


def test_local_query_heads_read_their_global_kv_heads():
    cfg = _gqa_cfg()
    # model = 16: each rank 2 query heads, all 8 kv heads (replicated)
    for r in range(16):
        assert L.kv_heads_for(cfg, 2, 8, 2 * r, 0) == slice(r // 2,
                                                            r // 2 + 1)
    # model = 2: 16 query heads and 4 kv heads a rank, both split
    for r in range(2):
        assert L.kv_heads_for(cfg, 16, 4, 16 * r, 4 * r) is None
    assert L.kv_heads_for(cfg, 32, 8) is None
    # 3 query heads a rank over groups of 4 straddle kv heads
    assert L.kv_heads_for(_gqa_cfg(heads=12, kv=3), 3, 3, 3, 0) == [0, 1, 1]


@pytest.mark.parametrize("ways", [2, 4, 16])
@pytest.mark.parametrize("mode", ["train", "decode"])
def test_local_heads_sum_to_the_whole_attention(ways, mode):
    cfg = _gqa_cfg()
    gen = torch.Generator().manual_seed(3)
    p = L.init_attention(cfg, gen, "cpu")
    b, s = 2, 8
    x = torch.randn((b, 1 if mode == "decode" else s, cfg.d_model),
                    generator=gen)
    pos = torch.arange(s) if mode != "decode" else torch.tensor([s - 1])
    kv_split = cfg.n_kv_heads % ways == 0
    hq, hkv = cfg.n_heads // ways, cfg.n_kv_heads // (ways if kv_split
                                                      else 1)

    def cache():
        g = torch.Generator().manual_seed(5)
        c = L.init_attn_cache(cfg, b, s, 0, "cpu")
        c["k"] = torch.randn((b, cfg.n_kv_heads, s, 4), generator=g)
        c["v"] = torch.randn((b, cfg.n_kv_heads, s, 4), generator=g)
        c["slot_pos"] = torch.arange(s, dtype=torch.int32)
        return c

    def run(pp, c, q0, kv0):
        return L.self_attention(cfg, pp, x, window=0, positions=pos,
                                cache=c, mode=mode, q_head0=q0,
                                kv_head0=kv0, cast=False)[0]

    whole = run(p, cache() if mode == "decode" else None, 0, 0)
    total = torch.zeros_like(whole)
    for r in range(ways):
        qs = slice(r * hq, (r + 1) * hq)
        ks = slice(r * hkv, (r + 1) * hkv) if kv_split else slice(None)
        pp = {"wq": p["wq"][:, qs], "wk": p["wk"][:, ks],
              "wv": p["wv"][:, ks], "wo": p["wo"][qs]}
        c = None
        if mode == "decode":
            full = cache()
            c = {"k": full["k"][:, ks].clone(), "v": full["v"][:, ks].clone(),
                 "slot_pos": full["slot_pos"]}
        total += run(pp, c, r * hq, r * hkv if kv_split else 0)
    assert float((total - whole).abs().max()) <= \
        1e-5 * float(whole.abs().max())
