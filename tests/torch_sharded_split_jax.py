"""The JAX side of tests/test_torch_sharded_split.py: the JAX package's
program on a 2 x 2 mesh of 4 forced host devices, from the same numpy
params and tokens as the port's ranks (tests/torch_sharded_split_ranks.py).
Run as

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python torch_sharded_split_jax.py OUT

with this directory and src/ on the path.  Writes OUT/jax.npz: mixtral's
grad step under TRAIN_RULES ("grad/..." leaves, loss, grad_norm) and
h2o-danube-3-4b's batch-1 decode logits under SERVE_RULES (an unsharded
prefill, its cache placed by ``cache_axes``); and OUT/jax_dots.json: the
forward products of the dry run's smoke cells ``SHAPE_CELLS``, each as
(batch, M, K, N) of its local operands in the compiled HLO.
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import torch_dryrun_jax as J
import torch_sharded_ranks as R
import torch_sharded_split_ranks as S
from repro.configs import get_config
from repro.launch.sharding import (SERVE_RULES, TRAIN_RULES, resolve_tree)
from repro.models import decoder
from repro.models.act_shard import activation_sharding, mapping_from_mesh
from repro.models.partitioning import batch_axes, cache_axes, param_axes
from repro.train.steps import make_decode_step, make_grad_step

#: the MoE layer's products in the HLO (its op names)
MOE_EINSUMS = ("td,de->te", "ecd,edf->ecf", "ecf,efd->ecd")


def flat(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], f"{path}/{k}"))
        return out
    return {path: np.asarray(tree, np.float32)}


def dots(mesh) -> dict:
    out = {}
    for arch, shape in S.SHAPE_CELLS:
        hlo = J.lower(mesh, arch, shape, keep_hlo=True)["hlo"]
        moe = get_config(arch, smoke=True).num_experts
        out[f"{arch}.{shape}"] = sorted(
            {dims for ein, fwd, dims in J.hlo_dots(hlo)
             if fwd and (not moe or ein in MOE_EINSUMS)})
    return out


def moe_grads(mesh) -> dict:
    cfg = dataclasses.replace(get_config(S.MOE_ARCH, smoke=True),
                              capacity_factor=S.MOE_CAPACITY,
                              moe_impl="gspmd")
    params = jax.tree_util.tree_map(jnp.asarray,
                                    R.numpy_params(S.moe_config()))
    batch = {k: jnp.asarray(v) for k, v in
             R.numpy_batch(S.moe_config(), b=S.MOE_B).items()}
    p_sh = resolve_tree(params, param_axes(params), mesh, TRAIN_RULES)
    b_sh = resolve_tree(batch, batch_axes(batch), mesh, TRAIN_RULES)
    with mesh, activation_sharding(mapping_from_mesh(mesh, TRAIN_RULES)):
        step = jax.jit(make_grad_step(cfg), in_shardings=(p_sh, b_sh))
        grads, gnorm, loss = step(jax.device_put(params, p_sh),
                                  jax.device_put(batch, b_sh))
    out = {"grad" + k: v for k, v in flat(grads).items()}
    out.update(loss=np.float32(loss), grad_norm=np.float32(gnorm))
    return out


def decode_logits(mesh) -> np.ndarray:
    cfg = get_config(S.DECODE_ARCH, smoke=True)
    params = jax.tree_util.tree_map(jnp.asarray,
                                    R.numpy_params(S.decode_config()))
    prompt, teacher = S.decode_tokens(S.decode_config())
    _, cache = jax.jit(lambda p, t: decoder.prefill(
        cfg, p, t, cache_len=R.S + S.DECODE_STEPS))(params,
                                                    jnp.asarray(prompt))
    p_sh = resolve_tree(params, param_axes(params), mesh, SERVE_RULES)
    c_sh = resolve_tree(cache, cache_axes(cache), mesh, SERVE_RULES)
    tok = {"token": jnp.asarray(teacher[:, :1])}
    t_sh = resolve_tree(tok, batch_axes(tok), mesh, SERVE_RULES)["token"]
    pos_sh = NamedSharding(mesh, PartitionSpec())
    out = []
    with mesh, activation_sharding(mapping_from_mesh(mesh, SERVE_RULES),
                                   mesh=mesh):
        step = jax.jit(make_decode_step(cfg),
                       in_shardings=(p_sh, c_sh, t_sh, pos_sh))
        params, cache = jax.device_put(params, p_sh), jax.device_put(cache,
                                                                     c_sh)
        for i in range(S.DECODE_STEPS):
            logits, cache = step(params, cache,
                                 jnp.asarray(teacher[:, i:i + 1]),
                                 jnp.asarray(R.S + i, jnp.int32))
            out.append(np.asarray(logits, np.float32))
    return np.stack(out)


def main(out: str) -> None:
    assert jax.device_count() == 4
    mesh = Mesh(np.array(jax.devices()).reshape(R.MESH), R.AXES)
    with open(os.path.join(out, "jax_dots.json"), "w") as f:
        json.dump(dots(mesh), f)
    np.savez(os.path.join(out, "jax.npz"), decode_logits=decode_logits(mesh),
             **moe_grads(mesh))


if __name__ == "__main__":
    main(sys.argv[1])
