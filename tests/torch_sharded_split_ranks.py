"""One rank of tests/test_torch_sharded_split.py's gloo world: the FSDP
split of "embed" kept where the activation has no data split
(``models/sharded.py``) on a (data 2 x model 2) DeviceMesh of 4 CPU
ranks.  Imports no jax: each rank is a fresh interpreter running

    python -c "import torch_sharded_split_ranks as r; r.main(R, 4, S, O)"

(rank R, a FileStore path S, an output directory O) with this directory
and src/ on its path.  Every rank builds the same global params and
batches from seeds (``torch_sharded_ranks``), runs the unsharded steps
itself as the reference and writes O/rank<R>.json; rank 0 also writes
O/port.npz, the arrays the test holds against the JAX package's 2 x 2
program (tests/torch_sharded_split_jax.py).

The cases:

* mixtral-8x22b (``moe_impl="gspmd"``, capacity ``MOE_CAPACITY``, which
  drops slots) prefilled at batch ``MOE_B`` (the batch split over data:
  each rank's own rows, the dispatch by one all-to-all) and at batch 1
  (d split over data: the rows by one all-to-all too), under
  SERVE_RULES: the logits against the unsharded prefill's, each MoE
  layer's kept slots against the unsharded route of the same input
  (``layers.moe_route`` on the layer's input, gathered here) and against
  the unsharded prefill's routing, and the collectives of each MoE layer
  (``CommDebugMode``);
* one mixtral grad step under TRAIN_RULES against the unsharded one;
* h2o-danube-3-4b's batch-1 decode with "embed" split over data (the
  params and the unsharded prefill's cache placed by SERVE_RULES): the
  logits of ``DECODE_STEPS`` teacher-forced steps against the unsharded
  decode's, the stream's placements and each step's collectives;
* every architecture's smoke config at batch 1 (the stream d-split at
  every sublayer of each kind: attention, cross-attention, MLP, MoE,
  RG-LRU, mLSTM, sLSTM): one grad step under TRAIN_RULES, and a prefill
  with R.DECODE_STEPS greedy decode steps under SERVE_RULES, against the
  unsharded ones;
* the local operands of every product: h2o-danube-3-4b's ``long_500k``
  decode step and mixtral-8x22b's MoE layers in its ``train_4k`` step
  (the dry run's smoke cells, ``launch/dryrun.trace_step`` with real
  tensors), as (batch, M, K, N) sizes.
"""
import dataclasses
import json
import os

import numpy as np
import torch

import torch_sharded_ranks as R
from repro_torch.interop import params_from_numpy

MOE_ARCH, DECODE_ARCH = "mixtral-8x22b", "h2o-danube-3-4b"
#: the MoE cases' capacity factor: slots drop, so the kept slots matter
MOE_CAPACITY = 1.25
MOE_B = 4
#: the batch-1 decode: an unsharded prefill of R.S tokens, then this many
#: teacher-forced steps on the mesh
DECODE_STEPS = 6
#: the dry run's smoke cells whose products are held against the JAX HLO
SHAPE_CELLS = ((DECODE_ARCH, "long_500k"), (MOE_ARCH, "train_4k"))
#: the products the shape cells compare: every mm of the decode step; the
#: MoE layer's mm and bmm
PRODUCTS = ("mm", "bmm", "addmm")


def moe_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH, smoke=True),
                               capacity_factor=MOE_CAPACITY,
                               moe_impl="gspmd")


def decode_config():
    from repro_torch.configs import get_config
    return get_config(DECODE_ARCH, smoke=True)


def decode_tokens(cfg):
    """(the prompt (1, R.S), the teacher tokens (1, DECODE_STEPS))."""
    toks = R.numpy_batch(cfg, b=1, s=R.S + DECODE_STEPS)["tokens"]
    return toks[:, :R.S], toks[:, R.S:R.S + DECODE_STEPS]


class Products:
    """A dispatch mode below DTensor's (as ``hlo_analysis.CollectiveBytes``)
    recording each product's local (batch, M, K, N) while ``on``."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode
        outer = self
        self.on, self.seen = True, set()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if any(t is DTensor for t in types):
                    return NotImplemented
                name = func._overloadpacket.__name__
                if outer.on and func.namespace == "aten" \
                        and name in PRODUCTS:
                    a, b = args[-2], args[-1]
                    if name == "bmm":
                        dims = (a.shape[0], a.shape[1], a.shape[2],
                                b.shape[2])
                    else:
                        dims = (1, a.shape[0], a.shape[1], b.shape[1])
                    outer.seen.add(tuple(int(n) for n in dims))
                return func(*args, **(kwargs or {}))
        self.mode = Mode()

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


class MoeTap:
    """Wraps ``sharded._moe`` and ``layers.route_of`` while entered: each
    MoE layer's input gathered whole, the collectives it issued
    (``CommDebugMode``, by op) and the Route it sorted."""

    def __init__(self):
        from repro_torch.models import layers as L
        from repro_torch.models import sharded
        self.mods = (sharded, L)
        self.inputs, self.comms, self.routes = [], [], []

    def __enter__(self):
        from torch.distributed.tensor.debug import CommDebugMode
        sharded, L = self.mods
        self.orig = (sharded._moe, L.route_of)
        moe, route_of = self.orig

        def tap_moe(cfg, norm, p, x):
            with CommDebugMode() as comm:
                y = moe(cfg, norm, p, x)
            self.comms.append({str(k).split(".")[-1]: v for k, v in
                               comm.get_comm_counts().items()})
            self.inputs.append((x.full_tensor(), p, norm.full_tensor(),
                                [str(q) for q in x.placements]))
            return y

        def tap_route(*a):
            r = route_of(*a)
            self.routes.append(r)
            return r
        sharded._moe, L.route_of = tap_moe, tap_route
        return self

    def __exit__(self, *exc):
        sharded, L = self.mods
        sharded._moe, L.route_of = self.orig


def _full(tree):
    """The global values of a layer's MoE params (DTensors)."""
    return {k: _full(v) if isinstance(v, dict) else v.full_tensor()
            for k, v in tree.items()}


def _same_kept(a, b) -> bool:
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("eidx", "se", "st", "keep", "slot"))


def moe_forward_case(mesh, b: int) -> dict:
    """mixtral's prefill at batch ``b`` on the mesh against the unsharded
    one: the logits' error, and for each MoE layer its kept slots bitwise
    against the unsharded route of the same input and against the
    unsharded prefill's routing, its router logits' largest difference
    from the unsharded product's, its dropped slots and its collectives."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers as L
    from repro_torch.models import prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    cfg = moe_config()
    rules = sh.SERVE_RULES
    params = params_from_numpy(R.numpy_params(cfg), device="cpu")
    tokens = R._tensors(R.numpy_batch(cfg, b=b))["tokens"]
    ref_routes = []
    orig = L.moe_route

    def tap(c, p, xt):
        r = orig(c, p, xt)
        ref_routes.append(r)
        return r
    L.moe_route = tap
    try:
        with torch.no_grad():
            ref_logits, _ = prefill(cfg, params, tokens, cache_len=R.S)
    finally:
        L.moe_route = orig
    p_sh = sh.distribute_tree(params, sh.resolve_tree(
        params, param_axes(params), mesh, rules), mesh)
    t_sh = sh.distribute_tree({"tokens": tokens}, sh.resolve_tree(
        {"tokens": tokens}, batch_axes({"tokens": tokens}), mesh, rules),
        mesh)["tokens"]
    with torch.no_grad(), activation_sharding(
            mapping_from_mesh(mesh, rules), mesh), MoeTap() as tap_:
        logits, _ = prefill(cfg, p_sh, t_sh, cache_len=R.S)
    layers = []
    for (x, p, scale, places), r, ref in zip(tap_.inputs, tap_.routes,
                                             ref_routes):
        h = L.rms_norm(x, scale, cfg.norm_eps).reshape(-1, x.shape[-1])
        own = L.moe_route(cfg, _full(p), h)
        layers.append({
            "kept_as_same_input": _same_kept(r, own),
            "kept_as_unsharded_run": _same_kept(r, ref),
            "logits_max_diff": float((r.logits - own.logits).abs().max()),
            "dropped": int(L.dropped_slots(r)), "stream": places})
    return {"logit_err": R._logit_err(logits.full_tensor(), ref_logits, cfg),
            "layers": layers, "comms": tap_.comms}


def moe_grad_case(mesh) -> tuple:
    """One mixtral grad step (``make_grad_step``) under TRAIN_RULES at
    batch MOE_B against the unsharded one: loss and grad_norm relative,
    each gradient leaf's local shard within R.STATE_REL of the leaf's
    largest entry.  Returns (the record, the whole gradients)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    from repro_torch.train import make_grad_step
    cfg = moe_config()
    rules = sh.TRAIN_RULES
    params = R.numpy_params(cfg)
    batch = R._tensors(R.numpy_batch(cfg, b=MOE_B))
    step = make_grad_step(cfg)
    ref_g, ref_norm, ref_loss = step(params_from_numpy(params, device="cpu"),
                                     batch)
    p = params_from_numpy(params, device="cpu")
    p_sh = sh.distribute_tree(p, sh.resolve_tree(p, param_axes(p), mesh,
                                                 rules), mesh)
    b_sh = sh.distribute_tree(batch, sh.resolve_tree(
        batch, batch_axes(batch), mesh, rules), mesh)
    with activation_sharding(mapping_from_mesh(mesh, rules), mesh):
        g, gnorm, loss = step(p_sh, b_sh)
    want = dict(R._leaves(ref_g))
    worst, whole = 0.0, {}
    for path, t in R._leaves(g):
        w = sh.local_shard(want[path], mesh, t.placements)
        scale = max(float(want[path].abs().max()), 1e-30)
        worst = max(worst, float((t.to_local() - w).abs().max()) / scale)
        whole[path] = t.full_tensor().numpy()
    rec = {"loss": [abs(float(loss) - float(ref_loss)),
                    R.LOSS_REL * abs(float(ref_loss))],
           "grad_norm": [abs(float(gnorm) - float(ref_norm)),
                         R.LOSS_REL * abs(float(ref_norm))],
           "grad_share": worst, "grad_bound": R.STATE_REL}
    return rec, dict(whole, loss=np.float32(loss), grad_norm=np.float32(
        gnorm))


def decode_case(mesh) -> tuple:
    """h2o-danube-3-4b's batch-1 decode with "embed" split over data: the
    unsharded prefill's cache and the params placed by SERVE_RULES, then
    DECODE_STEPS teacher-forced steps on the mesh against the unsharded
    ones.  Returns (the record, the mesh's logits of each step)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.launch import sharding as sh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models import sharded
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import (batch_axes, cache_axes,
                                                 param_axes)
    cfg = decode_config()
    rules = sh.SERVE_RULES
    params = params_from_numpy(R.numpy_params(cfg), device="cpu")
    prompt, teacher = (torch.from_numpy(t) for t in decode_tokens(cfg))
    cache_len = R.S + DECODE_STEPS
    with torch.no_grad():
        _, ref_cache = prefill(cfg, params, prompt, cache_len=cache_len)
    p_sh = sh.distribute_tree(params, sh.resolve_tree(
        params, param_axes(params), mesh, rules), mesh)
    c_sh = sh.distribute_tree(ref_cache, sh.resolve_tree(
        ref_cache, cache_axes(ref_cache), mesh, rules), mesh)
    streams, errs, comms, out = [], [], [], []
    orig = sharded._attention

    def tap(cfg_, kind, norm, p, x, **kw):
        streams.append([str(q) for q in x.placements])
        return orig(cfg_, kind, norm, p, x, **kw)
    sharded._attention = tap
    try:
        with torch.no_grad(), activation_sharding(
                mapping_from_mesh(mesh, rules), mesh):
            for i in range(DECODE_STEPS):
                tok = teacher[:, i:i + 1].contiguous()
                ref_logits, ref_cache = decode_step(cfg, params, ref_cache,
                                                    tok, R.S + i)
                t_sh = sh.distribute_tree({"token": tok}, sh.resolve_tree(
                    {"token": tok}, batch_axes({"token": tok}), mesh,
                    rules), mesh)["token"]
                with CommDebugMode() as comm:
                    logits, c_sh = decode_step(cfg, p_sh, c_sh, t_sh,
                                               R.S + i)
                comms.append({str(k).split(".")[-1]: v for k, v in
                              comm.get_comm_counts().items()})
                full = logits.full_tensor()
                errs.append(R._logit_err(full, ref_logits, cfg))
                out.append(full.numpy())
    finally:
        sharded._attention = orig
    return {"logit_errs": errs, "comms": comms,
            "streams": sorted(set(map(tuple, streams)))}, np.stack(out)


def batch1_case(mesh, arch: str) -> dict:
    """``arch``'s smoke config (``R.config``) at batch 1: a grad step under
    TRAIN_RULES (loss and grad_norm relative, each gradient leaf's local
    shard against the leaf's largest entry) and the prefill and decode
    steps under SERVE_RULES (the logits against the largest unsharded
    logit), against the unsharded steps."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models import decode_step, prefill
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.partitioning import batch_axes, param_axes
    from repro_torch.train import make_grad_step
    cfg = R.config(arch)
    params = R.numpy_params(cfg)
    batch = R._tensors(R.numpy_batch(cfg, b=1))

    def placed(tree, axes_of, rules):
        return sh.distribute_tree(tree, sh.resolve_tree(
            tree, axes_of(tree), mesh, rules), mesh)
    step = make_grad_step(cfg)
    ref_g, ref_norm, ref_loss = step(params_from_numpy(params, device="cpu"),
                                     batch)
    rules = sh.TRAIN_RULES
    with activation_sharding(mapping_from_mesh(mesh, rules), mesh):
        g, gnorm, loss = step(placed(params_from_numpy(params, device="cpu"),
                                     param_axes, rules),
                              placed(batch, batch_axes, rules))
    want = dict(R._leaves(ref_g))
    worst = 0.0
    for path, t in R._leaves(g):
        w = sh.local_shard(want[path], mesh, t.placements)
        scale = max(float(want[path].abs().max()), 1e-30)
        worst = max(worst, float((t.to_local() - w).abs().max()) / scale)
    rules = sh.SERVE_RULES
    p = params_from_numpy(params, device="cpu")
    p_sh = placed(p, param_axes, rules)
    inputs = {k: v for k, v in batch.items() if k in ("tokens", "aux")}
    in_sh = placed(inputs, batch_axes, rules)
    cache_len = R.S + R.DECODE_STEPS
    errs = []
    with torch.no_grad():
        ref_logits, ref_cache = prefill(cfg, p, inputs["tokens"],
                                        aux=inputs.get("aux"),
                                        cache_len=cache_len)
        with activation_sharding(mapping_from_mesh(mesh, rules), mesh):
            logits, cache = prefill(cfg, p_sh, in_sh["tokens"],
                                    aux=in_sh.get("aux"),
                                    cache_len=cache_len)
            errs.append(R._logit_err(logits.full_tensor(), ref_logits, cfg))
            for i in range(R.DECODE_STEPS):
                tok = ref_logits.argmax(-1, keepdim=True).to(torch.int32)
                ref_logits, ref_cache = decode_step(cfg, p, ref_cache, tok,
                                                    R.S + i)
                logits, cache = decode_step(
                    cfg, p_sh, cache, placed({"token": tok}, batch_axes,
                                             rules)["token"], R.S + i)
                errs.append(R._logit_err(logits.full_tensor(), ref_logits,
                                         cfg))
    return {"loss": [abs(float(loss) - float(ref_loss)),
                     R.LOSS_REL * abs(float(ref_loss))],
            "grad_norm": [abs(float(gnorm) - float(ref_norm)),
                          R.LOSS_REL * abs(float(ref_norm))],
            "grad_share": worst, "logit_errs": errs}


def shape_cases(mesh) -> dict:
    """The local (batch, M, K, N) of every product of the h2o long_500k
    decode step and of the mixtral train_4k step's MoE layers (the dry
    run's smoke cells, run with real tensors on this mesh)."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch.dryrun import trace_step
    from repro_torch.models import sharded
    out = {}
    for arch, shape in SHAPE_CELLS:
        cfg = get_config(arch, smoke=True)
        rec = Products()
        orig = sharded._moe
        if cfg.num_experts:
            rec.on = False

            def tap(*a, _orig=orig, _rec=rec):
                _rec.on = True
                try:
                    return _orig(*a)
                finally:
                    _rec.on = False
            sharded._moe = tap
        try:
            with rec:
                trace_step(cfg, get_shape(shape, smoke=True), mesh,
                           fake=False)
        finally:
            sharded._moe = orig
        out[f"{arch}.{shape}"] = sorted(rec.seen)
    return out


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh(R.MESH, R.AXES, device="cpu")
        res = {"coordinate": list(mesh.get_coordinate())}
        for b in (MOE_B, 1):
            res[f"moe_b{b}"] = moe_forward_case(mesh, b)
        res["moe_grad"], grads = moe_grad_case(mesh)
        res["decode"], logits = decode_case(mesh)
        res["shapes"] = shape_cases(mesh)
        from repro_torch.configs import ARCH_IDS
        for arch in ARCH_IDS:
            res[f"batch1:{arch}"] = batch1_case(mesh, arch)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if rank == 0:
            np.savez(os.path.join(out, "port.npz"), decode_logits=logits,
                     **{"grad" + k if k.startswith("/") else k: v
                        for k, v in grads.items()})
    finally:
        dist.destroy_process_group()
