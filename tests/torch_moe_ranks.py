"""One rank of tests/test_torch_moe.py's gloo world: ``moe_ffn_shard_map``
on a (data 2 x model 2) DeviceMesh of 4 CPU ranks.

Run in a fresh interpreter per rank (the test starts them):

    python -c "import torch_moe_ranks as r; r.main(RANK, 4, STORE, OUT)"

It imports torch and the port only.  The params and tokens are numpy
draws from fixed seeds, so the test hands the same values to the JAX
package.  Each rank writes ``rank{R}.npz`` (every case's output, and
``moe_ffn``'s beside the fallback cases) and ``rank{R}.json`` (the
mapping it built).
"""
import dataclasses
import json
import os

import numpy as np
import torch

WORLD = 4
MESH = (2, 2)                          # data x model
AXES = ("data", "model")
#: the JAX package's TRAIN_RULES entries that the shard_map path reads
#: ("pod" is not on this mesh, so the mapping leaves it out)
RULES = {"batch": ("pod", "data"), "mlp": ("model",)}
B, S = 4, 16
#: (case, arch, capacity_factor, batch, d_ff or None for the smoke's):
#: group-local routing with drops at the published 1.25, none at 8.0, and
#: the two fallbacks (B not divisible by the data ways, d_ff by the model
#: ways) that must be ``moe_ffn``
CASES = (
    ("mixtral_1.25", "mixtral-8x22b", 1.25, B, None),
    ("arctic_1.25", "arctic-480b", 1.25, B, None),
    ("arctic_8.0", "arctic-480b", 8.0, B, None),
    ("fallback_batch", "mixtral-8x22b", 1.25, 3, None),
    ("fallback_dff", "arctic-480b", 1.25, B, 129),
)
FALLBACKS = ("fallback_batch", "fallback_dff")


def config(arch: str, cf: float, d_ff=None):
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              capacity_factor=cf, moe_impl="shard_map")
    return cfg if d_ff is None else dataclasses.replace(cfg, d_ff=d_ff)


def moe_params(cfg, seed: int = 0) -> dict:
    """init_moe's leaves, normal · fan_in^-0.5, as numpy f32."""
    rng = np.random.default_rng(seed)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def init(shape, fan_in):
        return (rng.standard_normal(shape) * fan_in ** -0.5).astype(
            np.float32)
    p = {"router": init((d, e), d), "we_gate": init((e, d, f), d),
         "we_up": init((e, d, f), d), "we_down": init((e, f, d), f)}
    if cfg.dense_residual:
        p["dense"] = {"w_gate": init((d, f), d), "w_up": init((d, f), d),
                      "w_down": init((f, d), f)}
    return p


def tokens(cfg, batch: int, seed: int = 1) -> np.ndarray:
    """(batch, S, d) f32 normal values plus one shared direction, which
    skews the routing: some experts get more than their capacity at the
    published capacity factor."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, S, cfg.d_model))
    x += 1.5 * rng.standard_normal(cfg.d_model)
    return x.astype(np.float32)


def main(rank: int, world: int, store: str, out: str) -> None:
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.interop import params_from_numpy
    from repro_torch.models.act_shard import (activation_sharding,
                                              mapping_from_mesh)
    from repro_torch.models.layers import moe_ffn, moe_ffn_shard_map

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", np.arange(world).reshape(MESH).tolist(),
                          mesh_dim_names=AXES)
        mapping = mapping_from_mesh(mesh, RULES)
        res = {}
        for case, arch, cf, batch, d_ff in CASES:
            cfg = config(arch, cf, d_ff)
            p = params_from_numpy(moe_params(cfg), device="cpu")
            x = torch.from_numpy(tokens(cfg, batch))
            with activation_sharding(mapping, mesh=mesh):
                res[case] = moe_ffn_shard_map(cfg, p, x).numpy()
            if case in FALLBACKS:
                res[case + "/moe_ffn"] = moe_ffn(cfg, p, x).numpy()
        np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({k: [list(p) for p in v] for k, v in mapping.items()},
                      f)
    finally:
        dist.destroy_process_group()
