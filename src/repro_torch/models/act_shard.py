"""The activation-sharding context of the JAX package's
``repro/models/act_shard.py``: a mapping (logical axis -> ((mesh axis,
size), ...)) and a mesh, installed for the duration of a block of code.

``layers.moe_ffn_shard_map`` reads both: with no context installed it is
``moe_ffn``.  The mesh is the port's (``core/_mesh.py``): a
``torch.distributed`` ``DeviceMesh`` with named axes, one process a rank.

``hint`` (the JAX package's ``with_sharding_constraint`` on activations)
is not here: it waits for the ``partitioning``/``act_shard`` item of
ROADMAP.md §1 item 5, and ``repro_torch.models.hint`` is the identity
until then.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Tuple

Mapping = Dict[str, Tuple[Tuple[str, int], ...]]

_MAP: contextvars.ContextVar[Optional[Mapping]] = contextvars.ContextVar(
    "activation_sharding_map", default=None)
_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding_mesh", default=None)


@contextlib.contextmanager
def activation_sharding(mapping: Mapping, mesh=None):
    token = _MAP.set(dict(mapping))
    token_m = _MESH.set(mesh)
    try:
        yield
    finally:
        _MAP.reset(token)
        _MESH.reset(token_m)


def current_mapping() -> Optional[Mapping]:
    return _MAP.get()


def current_mesh():
    return _MESH.get()


def mapping_from_mesh(mesh, rules) -> Mapping:
    """The mapping from a ``DeviceMesh`` and a rule table (logical axis ->
    mesh axis name, a tuple of them, or None): each logical axis gets the
    (name, size) pairs of its mesh axes that the mesh has, read from the
    mesh's ``mesh_dim_names`` and sizes, where a ``jax.sharding.Mesh``
    gives its ``shape`` dict."""
    from repro_torch.core._mesh import check_mesh
    check_mesh(mesh)
    sizes = {name: int(mesh.size(i))
             for i, name in enumerate(mesh.mesh_dim_names)}
    out: Mapping = {}
    for logical, targets in rules.items():
        if targets is None:
            continue
        if isinstance(targets, str):
            targets = (targets,)
        pairs = tuple((t, sizes[t]) for t in targets if t in sizes)
        if pairs:
            out[logical] = pairs
    return out


__all__ = ["Mapping", "activation_sharding", "current_mapping",
           "current_mesh", "mapping_from_mesh"]
