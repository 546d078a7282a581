"""One rank of tests/test_torch_sharded.py's gloo world: the sharded path
(``launch/sharding``, ``models/sharded``, ``act_shard.hint``) on a
(data 2 x model 2) DeviceMesh of 4 CPU ranks.  Imports no jax: each rank
is a fresh interpreter running

    python -c "import torch_sharded_ranks as r; r.main(RANK, 4, STORE, OUT)"

with this directory and src/ on its path.  Every rank builds the same
global params and batches from seeds, runs the unsharded step itself as
the reference, places the state with ``distribute_tree`` and runs the
same step on the mesh, and holds its local shards against the slices of
the reference.  It writes OUT/rank<R>.json: each case's errors against
their bounds and its local shapes against ``resolve_spec``'s; rank 0 also
writes OUT/jax_<arch>.npz, the whole updated train state of the cases
held against the JAX package (``JAX_ARCHS``).
"""
import dataclasses
import json
import os
import time

import numpy as np
import torch

# a JAX run's (here numpy) params cross as the port's tree, which
# distribute_tree then places on the mesh
from repro_torch.interop import params_from_numpy

WORLD = 4
MESH = (2, 2)
AXES = ("data", "model")
B, S = 4, 32
#: decode steps after the prefill; the prefill reserves room for them
DECODE_STEPS = 2
#: tests/test_torch_train.py's AdamW: with eps 1e-3 a first step's update
#: g/(|g| + eps) is no sign function of gradients near 0
OPT = dict(lr=1e-3, eps=1e-3, warmup_steps=1)
#: the train step's bounds, tests/test_torch_train_archs.py's: loss and
#: grad_norm relative; m and v of each leaf's largest value; params two
#: f32 ulps plus this share of lr
LOSS_REL, STATE_REL, PARAM_LR = 1e-5, 3e-5, 1e-3
#: served logits of the sharded path within this share of max |logit|
LOGIT_REL = 1e-5
#: held against the JAX package's 2 x 2 sharded step (no drops at 8.0)
JAX_ARCHS = ("granite-3-2b", "mixtral-8x22b")
JAX_CAPACITY = 8.0
PARAM_SEED, TOKEN_SEED = 0, 1
#: the MoE models under moe_impl="shard_map" (group-local routing over
#: f-split experts) at JAX_CAPACITY, where nothing drops, so the
#: group-local routing is the unsharded global one
SHARD_MAP_CASES = ("mixtral-8x22b:shard_map", "arctic-480b:shard_map")
#: granite-3-2b with the rules of chip_smoke.py's world of 4 on the card,
#: TRAIN_RULES and SERVE_RULES without the FSDP split of "embed" (the
#: batch over data, the weights over model: all-reduces only)
NO_FSDP_CASE = "granite-3-2b:no_fsdp"
CASES = SHARD_MAP_CASES + (NO_FSDP_CASE,)
#: batch-1 decode with the cache's ring slots over data (SERVE_RULES'
#: cache_seq: the flash-decoding layout), one config a kind of attention
#: cache: full, swa, and local with global
FLASH_ARCHS = ("granite-3-2b", "h2o-danube-3-4b", "gemma3-27b")
#: decode steps of the flash-decoding cases: the swa and local rings (16
#: slots at smoke size, 8 a rank) wrap onto both ranks' slots
FLASH_STEPS = 10
#: the dry run's smoke cells held against a real world of 4
#: (tests/test_torch_dryrun.py): (arch, smoke shape)
DRYRUN_REAL_CELLS = (("granite-3-2b", "train_4k"),
                     ("granite-3-2b", "decode_32k"),
                     ("granite-3-2b", "long_500k"),
                     ("mixtral-8x22b", "train_4k"),
                     ("h2o-danube-3-4b", "long_500k"))


def rules(case: str, name: str) -> dict:
    from repro_torch.launch import sharding as sh
    table = getattr(sh, name)
    return dict(table, embed=None) if case == NO_FSDP_CASE else table


def config(case: str):
    from repro_torch.configs import get_config
    arch, _, impl = case.partition(":")
    cfg = get_config(arch, smoke=True)
    if impl == "no_fsdp":
        return cfg
    if impl:
        cfg = dataclasses.replace(cfg, capacity_factor=JAX_CAPACITY,
                                  moe_impl=impl)
    elif arch in JAX_ARCHS and cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=JAX_CAPACITY,
                                  moe_impl="gspmd")
    return cfg


def numpy_params(cfg, seed: int = PARAM_SEED) -> dict:
    """The global params as numpy: the port's init law from a CPU
    generator, gates drawn non-zero (``with_gates``), so the JAX
    subprocess can take the same values."""
    from repro_torch.models import init_params
    from torch_aux_inputs import with_gates
    gen = torch.Generator().manual_seed(seed)
    tree = init_params(cfg, gen, device="cpu")

    def walk(t):
        return {k: walk(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.numpy()
    return with_gates(walk(tree))


def numpy_batch(cfg, b: int = B, s: int = S, seed: int = TOKEN_SEED):
    from torch_aux_inputs import aux_for
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab, size=(b, s + 1)).astype(np.int32)
    out = {"tokens": toks[:, :s], "labels": toks[:, 1:]}
    aux = aux_for(cfg, b)
    if aux is not None:
        out["aux"] = aux
    return out


def _tensors(tree):
    return {k: _tensors(v) for k, v in tree.items()} \
        if isinstance(tree, dict) else torch.from_numpy(np.array(tree))


def _leaves(tree, path=""):
    from repro_torch.optim.adamw import tree_leaves
    return list(tree_leaves(tree, path))


def _train_case(cfg, mesh, rules):
    from repro_torch.launch import sharding as sh
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import TrainState, train_state_axes
    opt = AdamWConfig(**OPT)
    params = numpy_params(cfg)
    batch = numpy_batch(cfg)
    ref_p = params_from_numpy(params, device="cpu")
    ref = TrainState(ref_p, adamw_init(ref_p, opt))
    t0 = time.perf_counter()
    ref, ref_m = make_train_step(cfg, opt)(ref, _tensors(batch))
    t_ref = time.perf_counter() - t0

    glob_p = params_from_numpy(params, device="cpu")
    glob = TrainState(glob_p, adamw_init(glob_p, opt))
    shard = sh.resolve_tree(glob, train_state_axes(glob), mesh, rules)
    state = sh.distribute_tree(glob, shard, mesh)
    tb = _tensors(batch)
    b_sh = sh.distribute_tree(tb, sh.resolve_tree(tb, batch_axes(tb), mesh,
                                                  rules), mesh)
    shapes_ok = _local_shapes_match(glob, state, mesh, rules)
    t0 = time.perf_counter()
    with activation_sharding(mapping_from_mesh(mesh, rules), mesh):
        new, m = make_train_step(cfg, opt)(state, b_sh)
    t_sh = time.perf_counter() - t0
    assert new is state
    out = {"shapes_ok": shapes_ok, "ref_s": t_ref, "sharded_s": t_sh}
    for key in ("loss", "grad_norm", "tokens", "lr"):
        got, want = float(m[key]), float(ref_m[key])
        out[f"err/{key}"] = [abs(got - want), LOSS_REL * abs(want)]
    worst = {"params": 0.0, "m": 0.0, "v": 0.0}
    ok = True
    for part, got_tree, want_tree in (
            ("params", new.params, ref.params), ("m", new.opt.m, ref.opt.m),
            ("v", new.opt.v, ref.opt.v)):
        want_leaves = dict(_leaves(want_tree))
        for path, g in _leaves(got_tree):
            w = sh.local_shard(want_leaves[path], mesh, g.placements)
            gl = g.to_local().float()
            w = w.float()
            if part == "params":
                tol = 2 * torch.from_numpy(np.spacing(np.abs(
                    w.numpy()))) + PARAM_LR * OPT["lr"]
                ok &= bool(((gl - w).abs() <= tol).all())
                worst[part] = max(worst[part], float(
                    ((gl - w).abs() - tol).max()))
            else:
                scale = max(float(want_leaves[path].abs().max()), 1e-30)
                err = float((gl - w).abs().max()) / scale
                ok &= err <= STATE_REL
                worst[part] = max(worst[part], err)
    out["state_ok"] = ok
    out["worst"] = worst
    out["step"] = int(new.opt.step.to_local())
    return out, new, m


def _local_shapes_match(glob, state, mesh, rules) -> bool:
    """Each leaf's local shape is its global shape cut by resolve_spec's
    parts (every part divides, so evenly)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.train.steps import train_state_axes
    axes = train_state_axes(glob)
    sizes = sh.mesh_sizes(mesh)
    ok = True

    def check(t, a, d):
        nonlocal ok
        parts = sh.resolve_spec(tuple(t.shape), tuple(a), mesh, rules)
        want = []
        for n, part in zip(t.shape, parts):
            group = () if part is None else (
                (part,) if isinstance(part, str) else part)
            for name in group:
                n //= sizes[name]
            want.append(n)
        ok &= tuple(d.to_local().shape) == tuple(want)
        return t
    sh._map(check, glob, axes, state)
    return ok


def _serve_case(cfg, mesh, rules):
    from repro_torch.launch import sharding as sh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    params = params_from_numpy(numpy_params(cfg), device="cpu")
    batch = _tensors(numpy_batch(cfg))
    tokens, aux = batch["tokens"], batch.get("aux")
    cache_len = S + DECODE_STEPS
    with torch.no_grad():
        ref_logits, ref_cache = prefill(cfg, params, tokens, aux=aux,
                                        cache_len=cache_len)
    p_sh = sh.distribute_tree(params, sh.resolve_tree(
        params, param_axes(params), mesh, rules), mesh)
    inputs = {"tokens": tokens} if aux is None else {"tokens": tokens,
                                                      "aux": aux}
    in_sh = sh.distribute_tree(inputs, sh.resolve_tree(
        inputs, batch_axes(inputs), mesh, rules), mesh)
    errs = []
    with torch.no_grad(), activation_sharding(
            mapping_from_mesh(mesh, rules), mesh):
        logits, cache = prefill(cfg, p_sh, in_sh["tokens"],
                                aux=in_sh.get("aux"), cache_len=cache_len)
        errs.append(_logit_err(logits.full_tensor(), ref_logits, cfg))
        for i in range(DECODE_STEPS):
            tok = ref_logits.argmax(-1, keepdim=True).to(torch.int32)
            ref_logits, ref_cache = decode_step(cfg, params, ref_cache, tok,
                                                S + i)
            t_sh = sh.distribute_tree({"token": tok}, sh.resolve_tree(
                {"token": tok}, batch_axes({"token": tok}), mesh, rules),
                mesh)["token"]
            logits, cache = decode_step(cfg, p_sh, cache, t_sh, S + i)
            errs.append(_logit_err(logits.full_tensor(), ref_logits, cfg))
    return {"logit_errs": errs}


def _placed_cache_decode_case(cfg, mesh, b=1):
    """A batch-``b`` prefill on every rank (unsharded), its cache placed by
    ``SERVE_RULES``' ``cache_axes`` and FLASH_STEPS greedy decode steps on
    the mesh against the unsharded decode: the logits' errors, whether each
    self-attention cache split its ring slots over data (at batch 1: the
    flash-decoding layout; at a batch that splits over data only slot_pos
    splits, gathered for each step), and whether a cache whose slot_pos is
    replicated while k's slots are split is refused."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import (batch_axes, cache_axes,
                                                 param_axes)
    from repro_torch.models.sharded import _decode_cache
    from torch.distributed.tensor import Replicate, Shard
    rules = sh.SERVE_RULES
    params = params_from_numpy(numpy_params(cfg), device="cpu")
    tokens = _tensors(numpy_batch(cfg, b=b))["tokens"]
    with torch.no_grad():
        ref_logits, ref_cache = prefill(cfg, params, tokens,
                                        cache_len=S + FLASH_STEPS)
    p_sh = sh.distribute_tree(params, sh.resolve_tree(
        params, param_axes(params), mesh, rules), mesh)
    c_sh = sh.distribute_tree(ref_cache, sh.resolve_tree(
        ref_cache, cache_axes(ref_cache), mesh, rules), mesh)
    split = [t.placements[0] == Shard(t.ndim - 2)
             for p, t in _leaves(c_sh) if p.endswith("/k")]
    pos_split = [t.placements[0] == Shard(t.ndim - 1)
                 for p, t in _leaves(c_sh) if p.endswith("/slot_pos")]
    errs = []
    with torch.no_grad(), activation_sharding(mapping_from_mesh(mesh, rules),
                                              mesh):
        for i in range(FLASH_STEPS):
            tok = ref_logits.argmax(-1, keepdim=True).to(torch.int32)
            ref_logits, ref_cache = decode_step(cfg, params, ref_cache, tok,
                                                S + i)
            t_sh = sh.distribute_tree({"token": tok}, sh.resolve_tree(
                {"token": tok}, batch_axes({"token": tok}), mesh, rules),
                mesh)["token"]
            logits, c_sh = decode_step(cfg, p_sh, c_sh, t_sh, S + i)
            errs.append(_logit_err(logits.full_tensor(), ref_logits, cfg))
    k = next(t for p, t in _leaves(c_sh) if p.endswith("/k"))[0]
    layer = {"k": k, "v": k,
             "slot_pos": sh.distribute_tree(
                 {"s": torch.zeros(k.shape[-2], dtype=torch.int32)},
                 {"s": (Replicate(), Replicate())}, mesh)["s"]}
    try:
        _decode_cache(layer, (Replicate(), Shard(1)))
        refused = False
    except ValueError:
        refused = True
    return {"logit_errs": errs, "slots_split": split,
            "slot_pos_split": pos_split, "misplaced_refused": refused}


def _logit_err(got, want, cfg):
    """[max |got - want|, its bound]: LOGIT_REL of the largest logit of the
    vocab (the padding columns sit at -1e30 in both)."""
    return [float((got - want).abs().max()),
            LOGIT_REL * float(want[..., :cfg.vocab].abs().max())]


def world1(store: str, out: str) -> None:
    """A world of one gloo rank, mesh (1, 1): every architecture's two
    train steps and its prefill and decode steps, each leaf and logit
    against the unsharded steps': bitwise, and the largest difference
    (OUT/world1.json)."""
    import torch.distributed as dist
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.train.steps import TrainState, train_state_axes
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, 1), rank=0,
                            world_size=1)
    mesh = make_mesh((1, 1), AXES, device="cpu")
    opt = AdamWConfig(**OPT)
    res = {}
    for arch in ARCH_IDS:
        cfg = config(arch)
        params, batch = numpy_params(cfg), numpy_batch(cfg)
        step = make_train_step(cfg, opt)
        rp = params_from_numpy(params, device="cpu")
        ref = TrainState(rp, adamw_init(rp, opt))
        gp = params_from_numpy(params, device="cpu")
        glob = TrainState(gp, adamw_init(gp, opt))
        st = sh.distribute_tree(glob, sh.resolve_tree(
            glob, train_state_axes(glob), mesh, sh.TRAIN_RULES), mesh)
        tb = _tensors(batch)
        bs = sh.distribute_tree(tb, sh.resolve_tree(
            tb, batch_axes(tb), mesh, sh.TRAIN_RULES), mesh)
        for _ in range(2):
            ref, rm = step(ref, _tensors(batch))
            with activation_sharding(mapping_from_mesh(mesh, sh.TRAIN_RULES),
                                     mesh):
                st, m = step(st, bs)
        diffs = {k: float((m[k] - rm[k]).abs()) for k in ("loss",
                                                          "grad_norm")}
        for part, a, b in (("params", st.params, ref.params),
                           ("m", st.opt.m, ref.opt.m),
                           ("v", st.opt.v, ref.opt.v)):
            want = dict(_leaves(b))
            for path, t in _leaves(a):
                diffs[part + path] = float(
                    (t.to_local().float() - want[path].float()).abs().max())
        p = params_from_numpy(params, device="cpu")
        toks, aux = tb["tokens"], tb.get("aux")
        serve = []
        with torch.no_grad():
            rl, rc = prefill(cfg, p, toks, aux=aux,
                             cache_len=S + DECODE_STEPS)
            ps = sh.distribute_tree(p, sh.resolve_tree(
                p, param_axes(p), mesh, sh.SERVE_RULES), mesh)
            inp = {"tokens": toks} if aux is None else {"tokens": toks,
                                                        "aux": aux}
            ins = sh.distribute_tree(inp, sh.resolve_tree(
                inp, batch_axes(inp), mesh, sh.SERVE_RULES), mesh)
            with activation_sharding(mapping_from_mesh(mesh, sh.SERVE_RULES),
                                     mesh):
                lg, c = prefill(cfg, ps, ins["tokens"], aux=ins.get("aux"),
                                cache_len=S + DECODE_STEPS)
                serve.append(bool(torch.equal(lg.to_local(), rl)))
                for i in range(DECODE_STEPS):
                    tok = rl.argmax(-1, keepdim=True).to(torch.int32)
                    rl, rc = decode_step(cfg, p, rc, tok, S + i)
                    lg, c = decode_step(cfg, ps, c, tok, S + i)
                    serve.append(bool(torch.equal(lg.to_local(), rl)))
        res[arch] = {"train_diffs": diffs, "serve_bitwise": serve,
                     "loss": float(rm["loss"])}
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = DTensor.from_local(torch.zeros((1, 1, 4, 8)), mesh,
                           [Replicate(), Replicate()])
    try:
        flash_attention(q, q, q)
        res["flash_attention_dtensor"] = "no error"
    except TypeError:
        res["flash_attention_dtensor"] = "TypeError"
    with open(os.path.join(out, "world1.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def production_meshes(out: str) -> None:
    """``make_production_mesh`` on a fake process group of 256 ranks, then
    of 512 (multi-pod): shapes, axis names, ``data_axes_of`` and a rank's
    coordinate (OUT/meshes.json)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import data_axes_of, make_production_mesh
    res = {}
    for multi, world, rank in ((False, 256, 37), (True, 512, 300)):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
        mesh = make_production_mesh(multi_pod=multi, device="cpu")
        res[str(multi)] = {"shape": list(mesh.shape),
                           "names": list(mesh.mesh_dim_names),
                           "data_axes": list(data_axes_of(mesh)),
                           "coordinate": list(mesh.get_coordinate())}
        dist.destroy_process_group()
    with open(os.path.join(out, "meshes.json"), "w") as f:
        json.dump(res, f)


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import hint
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    t_start = time.perf_counter()
    mesh = make_mesh(MESH, AXES, device="cpu")
    res = {"coordinate": list(mesh.get_coordinate())}
    x = torch.arange(6.0).reshape(2, 3)
    res["hint_identity"] = hint(x, ("batch", None)) is x
    for arch in ARCH_IDS + CASES:
        cfg = config(arch)
        train, new, m = _train_case(cfg, mesh, rules(arch, "TRAIN_RULES"))
        res[arch] = {"train": train, "serve": _serve_case(
            cfg, mesh, rules(arch, "SERVE_RULES"))}
        if arch in JAX_ARCHS:
            full = {}
            for part, tree in (("params", new.params), ("m", new.opt.m),
                               ("v", new.opt.v)):
                for path, t in _leaves(tree):
                    full[part + path] = t.full_tensor().float().numpy()
            if rank == 0:
                np.savez(os.path.join(out, f"jax_{arch}.npz"),
                         loss=float(m["loss"]),
                         grad_norm=float(m["grad_norm"]), **full)
    for arch in FLASH_ARCHS:
        res[f"flash:{arch}"] = _placed_cache_decode_case(config(arch), mesh)
    res["placed:granite-3-2b"] = _placed_cache_decode_case(
        config("granite-3-2b"), mesh, B)
    res["seconds"] = time.perf_counter() - t_start
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _dryrun_cells(mesh, cells, fake: bool) -> dict:
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import trace_step
    return {f"{arch}.{shape}": trace_step(get_config(arch, smoke=True),
                                          get_shape(shape, smoke=True), mesh,
                                          fake=fake)
            for arch, shape in cells}


def dryrun_real(rank: int, world: int, store: str, out: str) -> None:
    """One rank of tests/test_torch_dryrun.py's gloo world of 4 (2 x 2):
    ``trace_step`` with real tensors (``fake=False``) on
    DRYRUN_REAL_CELLS, the counts of the real steps (OUT/real<R>.json)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(MESH, AXES, device="cpu")
        res = _dryrun_cells(mesh, DRYRUN_REAL_CELLS, fake=False)
        with open(os.path.join(out, f"real{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


def dryrun_fake(out: str, cells) -> None:
    """The dry run of ``cells`` (and DRYRUN_REAL_CELLS) on a 2 x 2 mesh
    over a fake process group of 4 ranks, as rank 0 (OUT/fake.json)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=WORLD)
    try:
        mesh = make_mesh(MESH, AXES, device="cpu")
        res = _dryrun_cells(mesh, tuple(dict.fromkeys(
            tuple(map(tuple, cells)) + DRYRUN_REAL_CELLS)), fake=True)
        with open(os.path.join(out, "fake.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
