"""The JAX side of tests/test_torch_dryrun.py: the JAX package's dry run
(``repro/launch/dryrun.py``'s ``lower_cell``) of smoke cells on a 2 x 2
mesh of 4 forced host devices, its analyses read from its own partitioned
HLO.  Run as

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python torch_dryrun_jax.py OUT.json

with src/ on the path.  For each cell of ``CELLS``: ``model_params``,
``model_active_params``, ``state_bytes_global`` and ``_per_chip``, each
leaf's local shape by path (the port's ``launch/dryrun.leaves`` naming),
``collective_bytes`` and ``dot_flops`` as the package reads them, and
``dot_flops_fused``, which enters fused computations too; for a train
cell with attention also ``dot_flops_fused`` with the attention replaced
by a stand-in without products (``ATTENTION_FREE``): the HLO dot FLOPs
less the attention's.
Skip reasons come from ``shape_is_supported`` for every (arch, shape)."""
import json
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import repro.models.layers as JL
from repro.configs import (ARCH_IDS, SHAPES, SMOKE_SHAPES, get_config,
                           input_specs, shape_is_supported)
from repro.launch.hlo_analysis import collective_bytes
import repro.launch.hlo_flops as HF
from repro.launch.hlo_flops import dot_flops
from repro.launch.sharding import (SERVE_RULES, TRAIN_RULES, replicated_like,
                                   resolve_tree)
from repro.models import decoder
from repro.models.act_shard import activation_sharding, mapping_from_mesh
from repro.models.partitioning import batch_axes, cache_axes, param_axes
from repro.optim.adamw import AdamWConfig
from repro.train.steps import (init_train_state, make_decode_step,
                               make_prefill_step, make_train_step,
                               train_state_axes)

#: (arch, smoke shape) cells, the port's tests/test_torch_dryrun.py's
CELLS = (("granite-3-2b", "train_4k"), ("granite-3-2b", "decode_32k"),
         ("mixtral-8x22b", "train_4k"), ("recurrentgemma-2b", "decode_32k"),
         ("xlstm-350m", "train_4k"), ("h2o-danube-3-4b", "long_500k"))
#: the train cells whose attention runs the blockwise path
ATTENTION_FREE = (("granite-3-2b", "train_4k"), ("mixtral-8x22b", "train_4k"))
KEY0 = jax.random.PRNGKey(0)
#: hlo_flops' call edges plus a fusion's ``calls=``: XLA's CPU backend
#: wraps small products (a decode's one token a rank) in fusions, which
#: the package's ``dot_flops`` does not enter
_FUSED_CALL_RE = re.compile(
    r"\b(?:call|fusion)\(.*?(?:to_apply|calls)=%?([\w.\-]+)")


def dot_flops_fused(hlo: str) -> dict:
    """``hlo_flops.dot_flops`` entering fused computations too."""
    plain = HF._CALL_RE
    HF._CALL_RE = _FUSED_CALL_RE
    try:
        return dot_flops(hlo)
    finally:
        HF._CALL_RE = plain


def _name(entry) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(entry, attr):
            return str(getattr(entry, attr))
    return str(entry)


def local_shapes(prefix, shapes, shardings) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(shapes)
    shs = jax.tree_util.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, jax.sharding.Sharding))
    return {prefix + "".join("/" + _name(e) for e in path):
            list(sh.shard_shape(leaf.shape))
            for (path, leaf), sh in zip(flat, shs)}


def standin_attention(q, k, v, **_):
    """(B, Hq, S, D) from q, k and v without a product: the gradients
    reach q, k and v as the attention's do, so the projections' products
    and their backward stay."""
    g = q.shape[1] // k.shape[1]
    kv = k.mean(axis=2, keepdims=True) + v.mean(axis=2, keepdims=True)
    return q * jnp.repeat(kv, g, axis=1)


def lower(mesh, arch, shape_name, keep_hlo=False):
    """``lower_cell``'s body on ``mesh`` with the smoke config and shape
    (with ``keep_hlo`` the compiled HLO's text too, under "hlo")."""
    cfg = get_config(arch, smoke=True)
    shape = SMOKE_SHAPES[shape_name]
    specs = input_specs(cfg, shape)
    rules_act = TRAIN_RULES if shape.kind == "train" else SERVE_RULES
    rec = {}
    with mesh, activation_sharding(mapping_from_mesh(mesh, rules_act),
                                   mesh=mesh):
        if shape.kind == "train":
            opt_cfg = AdamWConfig(state_dtype=cfg.adam_dtype)
            state_shapes = jax.eval_shape(
                lambda: init_train_state(KEY0, cfg, opt_cfg))
            st_sh = resolve_tree(state_shapes, train_state_axes(state_shapes),
                                 mesh, TRAIN_RULES)
            b_sh = resolve_tree(specs, batch_axes(specs), mesh, TRAIN_RULES)
            lowered = jax.jit(make_train_step(cfg, opt_cfg),
                              in_shardings=(st_sh, b_sh),
                              out_shardings=(st_sh, None)).lower(
                state_shapes, specs)
            shapes = {**local_shapes("state", state_shapes, st_sh),
                      **local_shapes("batch", specs, b_sh)}
            leaves = jax.tree_util.tree_leaves(state_shapes)
        else:
            params_shapes = jax.eval_shape(
                lambda: decoder.init_params(KEY0, cfg))
            p_sh = resolve_tree(params_shapes, param_axes(params_shapes),
                                mesh, SERVE_RULES)
            leaves = jax.tree_util.tree_leaves(params_shapes)
            shapes = local_shapes("state", params_shapes, p_sh)
            if shape.kind == "prefill":
                b_sh = resolve_tree(specs, batch_axes(specs), mesh,
                                    SERVE_RULES)
                lowered = jax.jit(make_prefill_step(cfg),
                                  in_shardings=(p_sh, b_sh)).lower(
                    params_shapes, specs)
                shapes.update(local_shapes("batch", specs, b_sh))
            else:
                cache_shapes = specs["cache"]
                c_sh = resolve_tree(cache_shapes, cache_axes(cache_shapes),
                                    mesh, SERVE_RULES)
                tok = {"token": specs["token"]}
                tok_sh = resolve_tree(tok, batch_axes(tok), mesh,
                                      SERVE_RULES)["token"]
                pos_sh = replicated_like(specs["pos"], mesh)
                lowered = jax.jit(
                    make_decode_step(cfg),
                    in_shardings=(p_sh, c_sh, tok_sh, pos_sh)).lower(
                    params_shapes, cache_shapes, specs["token"],
                    specs["pos"])
                shapes.update(local_shapes("cache", cache_shapes, c_sh))
                shapes["token"] = list(tok_sh.shard_shape(
                    specs["token"].shape))
        hlo = lowered.compile().as_text()
    n_state = sum(s.size * s.dtype.itemsize for s in leaves)
    rec.update(model_params=cfg.num_params(),
               model_active_params=cfg.num_active_params(),
               state_bytes_global=n_state,
               state_bytes_per_chip=n_state / mesh.size,
               local_shapes=shapes, collective_bytes=collective_bytes(hlo),
               dot_flops=dot_flops(hlo), dot_flops_fused=dot_flops_fused(hlo))
    if keep_hlo:
        rec["hlo"] = hlo
    return rec


_DEF_RE = re.compile(r"%([\w.\-]+) = (\w+)\[([\d,]*)\]")
_DOT_RE = re.compile(r"%[\w.\-]+ = \S+ dot\(%([\w.\-]+), %([\w.\-]+)\)")


def hlo_dots(hlo: str) -> list:
    """Every ``dot`` of a compiled HLO text as (einsum, forward, (batch,
    M, K, N)): the einsum of its ``op_name`` ("" where none), whether it
    lies outside the backward pass and the remat's recompute, and its
    batch, free and contracted sizes, each a product of the local operand
    dims it names."""
    shapes = {m.group(1): [int(n) for n in m.group(3).split(",") if n]
              for m in _DEF_RE.finditer(hlo)}
    out = []
    for line in hlo.splitlines():
        m = _DOT_RE.search(line)
        if not m:
            continue
        dims = {k: [int(n) for n in v.split(",") if n] for k, v in re.findall(
            r"(\w+_(?:contracting|batch)_dims)=\{([\d,]*)\}", line)}
        lhs, rhs = shapes[m.group(1)], shapes[m.group(2)]

        def size(shape, idx):
            return int(np.prod([shape[i] for i in idx])) if idx else 1
        lb, lc = dims.get("lhs_batch_dims", []), dims["lhs_contracting_dims"]
        rb, rc = dims.get("rhs_batch_dims", []), dims["rhs_contracting_dims"]
        free_l = [i for i in range(len(lhs)) if i not in lb + lc]
        free_r = [i for i in range(len(rhs)) if i not in rb + rc]
        op = re.search(r'op_name="([^"]*)"', line)
        name = op.group(1) if op else ""
        ein = re.search(r"/([^/]*->[^/]*)/dot_general$", name)
        forward = "transpose(" not in name and "rematted" not in name
        out.append((ein.group(1) if ein else "", forward,
                    (size(lhs, lb), size(lhs, free_l), size(lhs, lc),
                     size(rhs, free_r))))
    return out


def main(out: str) -> None:
    assert jax.device_count() == 4
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    res = {"skips": {f"{a}.{s}": shape_is_supported(get_config(a),
                                                     SHAPES[s])
                     for a in ARCH_IDS for s in SHAPES}}
    for arch, shape in CELLS:
        t0 = time.time()
        rec = lower(mesh, arch, shape)
        if (arch, shape) in ATTENTION_FREE:
            fa = JL.fa_ops
            JL.fa_ops = type("StandIn", (), {"flash_attention": staticmethod(
                standin_attention)})
            try:
                rec["dot_flops_attention_free"] = lower(
                    mesh, arch, shape)["dot_flops_fused"]
            finally:
                JL.fa_ops = fa
        rec["seconds"] = time.time() - t0
        res[f"{arch}.{shape}"] = rec
    with open(out, "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    main(sys.argv[1])
