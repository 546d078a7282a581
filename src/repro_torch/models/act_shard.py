"""Activation sharding hints (``with_sharding_constraint``) behind a
context, the JAX package's ``repro/models/act_shard.py``.

Without hints, GSPMD is free to satisfy an FSDP-sharded ("embed" over
data) weight by computing contracting-dim partial sums and all-reducing
full activations every layer, far more traffic than all-gathering the
(much smaller) weights.  Pinning the activation batch axis at block
boundaries forces the weight-gather strategy.

The mapping (logical axis -> ((mesh axis, size), ...)) and a mesh are
installed for the duration of a block of code.  The mesh is the port's
(``core/_mesh.py``): a ``torch.distributed`` ``DeviceMesh`` with named
axes, one process a rank.  ``hint`` redistributes a DTensor activation to
the placements the mapping resolves for its logical axes; with no context
installed, or given a plain tensor, it returns x itself, so unsharded
runs are untouched.  ``layers.moe_ffn_shard_map`` reads both the mapping
and the mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional, Sequence, Tuple

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


def hint_parts(shape, axes: Sequence[Optional[str]]):
    """The parts ``hint`` resolves for a tensor of ``shape`` under the
    installed mapping (divisibility-checked like
    ``launch/sharding.resolve_spec``), or None without a context or where
    every part is None (the JAX package's no-op)."""
    m = _MAP.get()
    if not m:
        return None
    from repro_torch.launch.sharding import resolve_parts
    parts = resolve_parts(tuple(shape), tuple(axes), m.get)
    if all(p is None for p in parts):
        return None
    return parts


def hint(x, axes: Sequence[Optional[str]]):
    """Constrain activation ``x``'s dims to the context's mesh axes: a
    DTensor is redistributed to the resolved placements (a Partial sum is
    all-reduced, a replicated batch sliced); no-op without an installed
    context, on a plain tensor, or where nothing resolves."""
    from repro_torch.models.sharded import is_dtensor
    if not is_dtensor(x):
        return x
    parts = hint_parts(x.shape, axes)
    if parts is None:
        return x
    from repro_torch.launch.sharding import placements
    return x.redistribute(x.device_mesh, placements(parts, x.device_mesh))


__all__ = ["Mapping", "activation_sharding", "current_mapping",
           "current_mesh", "hint", "hint_parts", "mapping_from_mesh"]
