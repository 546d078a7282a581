"""Logical axes -> mesh placements with divisibility fallback, the JAX
package's ``repro/launch/sharding.py`` over ``torch.distributed.tensor``.

Rules map logical axis names to an ordered tuple of candidate mesh axes;
the resolver takes the longest prefix whose product divides the dim and
isn't already used in the same spec.  Non-divisible dims fall back to
replication instead of failing: 8 KV heads or 8 experts on a 16-way model
axis replicate; a batch of 1 frees the data axis for the KV-cache
sequence (the flash-decoding layout).

``resolve_spec`` returns the JAX package's ``PartitionSpec`` parts as a
plain tuple (None, a mesh axis name, or a tuple of names a dim);
``placements`` turns those parts into one DTensor placement per mesh
dimension.  ``resolve_tree`` gives a tree of such placement tuples (the
JAX package's ``NamedSharding`` tree), and ``distribute_tree`` puts a
tree on the mesh with them (``jax.device_put(tree, shardings)``): every
rank holds the same global values and keeps its own shard.

Two profiles (and two variants):
  TRAIN: ZeRO-3 style; params FSDP-shard "embed" over the in-pod data
  axis and tensor-shard heads/mlp/vocab/experts over "model"; batch over
  ("pod", "data").
  SERVE: the same tensor sharding; the KV cache sequence claims ("pod",
  "data") whenever the batch dim can't.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

Rules = Dict[str, Optional[Tuple[str, ...]]]
#: one dim's resolved part: None, a mesh axis, or several (outermost first)
Part = Optional[Any]

TRAIN_RULES: Rules = {
    "batch": ("pod", "data"),
    "embed": ("data",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "mlp": ("model",),
    "vocab": ("model",),
    "expert": ("model",),
    "rnn": ("model",),
    "rnn2": None,
    "head_dim": None,
    "head_dim2": None,
    "seq": None,
    "cache_seq": None,
    "aux_seq": None,
    "layers": None,
}

SERVE_RULES: Rules = dict(
    TRAIN_RULES,
    cache_seq=("pod", "data"),      # flash-decode: claims what batch didn't
)

#: pure ZeRO-3 for dense training: batch data-parallel over the whole
#: mesh, weights sharded over every axis on "embed".
ZERO3_TRAIN_RULES: Rules = dict(
    TRAIN_RULES,
    batch=("pod", "data", "model"),
    heads=None, kv_heads=None, mlp=None, rnn=None,
    embed=("data", "model"),
)

#: when "heads" cannot split over the model axis, head_dim claims the
#: data axis.
SERVE_RULES_HEADDIM: Rules = dict(SERVE_RULES, head_dim=("data",))


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size: a ``DeviceMesh``'s ``mesh_dim_names`` and sizes,
    or a mesh whose ``shape`` is already that mapping (as a
    ``jax.sharding.Mesh``'s is)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return {n: int(s) for n, s in zip(names, tuple(mesh.shape))}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


def resolve_parts(shape, axes, pairs_of) -> Tuple[Part, ...]:
    """The resolver's core: each dim takes the longest run of its
    candidates (``pairs_of(axis)``: (mesh axis, size) pairs in order) whose
    product divides it, skipping a mesh axis used by an earlier dim."""
    parts = []
    used = set()
    for dim, ax in zip(shape, axes):
        pairs = pairs_of(ax) if ax is not None else None
        if not pairs:
            parts.append(None)
            continue
        sel = []
        prod = 1
        for name, size in pairs:
            if name in used:
                continue
            if dim % (prod * size) == 0:
                sel.append(name)
                prod *= size
        if not sel:
            parts.append(None)
        else:
            parts.append(sel[0] if len(sel) == 1 else tuple(sel))
            used.update(sel)
    return tuple(parts)


def resolve_spec(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
                 mesh, rules: Rules) -> Tuple[Part, ...]:
    sizes = mesh_sizes(mesh)

    def pairs_of(ax):
        targets = rules.get(ax)
        if targets is None:
            return None
        if isinstance(targets, str):
            targets = (targets,)
        return tuple((m, sizes[m]) for m in targets if m in sizes)

    return resolve_parts(tuple(shape), tuple(axes), pairs_of)


def placements(parts: Tuple[Part, ...], mesh) -> tuple:
    """One DTensor placement per mesh dimension: ``Shard(i)`` on each mesh
    axis that splits tensor dim i (a dim split over several axes is
    ``Shard(i)`` on each, which DTensor nests in mesh-dimension order, so
    the names must come outermost first, as the JAX package flattens
    them), ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for i, part in enumerate(parts):
        if part is None:
            continue
        group = (part,) if isinstance(part, str) else tuple(part)
        dims = [names.index(a) for a in group]
        if dims != sorted(dims):
            raise ValueError(f"dim {i} splits over {group}, not in the "
                             f"mesh's order {tuple(names)}")
        for m in dims:
            out[m] = Shard(i)
    return tuple(out)


def _map(fn, tree, *others):
    """``fn`` over the tensor leaves of ``tree`` (nested dicts and
    dataclasses such as ``TrainState``/``OptState``), the matching nodes
    of ``others`` arriving whole at each leaf (an axes tuple stays one
    leaf), as ``jax.tree_util.tree_map`` flattens up to its first tree."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(o[k] for o in others)) for k in tree}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name),
                         *(getattr(o, f.name) for o in others))
            for f in dataclasses.fields(tree)})
    return fn(tree, *others)


def resolve_tree(shapes_tree: Any, axes_tree: Any, mesh, rules: Rules
                 ) -> Any:
    """Tree of tensors (or ``meta`` stand-ins) x tree of logical-axis
    tuples -> tree of placement tuples, one placement a mesh dim."""
    return _map(lambda s, a: placements(
        resolve_spec(tuple(s.shape), tuple(a), mesh, rules), mesh),
        shapes_tree, axes_tree)


def replicated_like(tree: Any, mesh) -> Any:
    from torch.distributed.tensor import Replicate
    return _map(lambda _: tuple(Replicate() for _ in mesh.mesh_dim_names),
                tree)


def local_shard(t: torch.Tensor, mesh, places) -> torch.Tensor:
    """This rank's block of the global ``t`` under ``places``: each
    ``Shard(i)``, in mesh-dimension order, cuts dim i into equal chunks and
    keeps the chunk at this rank's coordinate on that mesh dimension."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    out = t
    for m, p in enumerate(places):
        if isinstance(p, Shard):
            n = int(mesh.size(m))
            dim = p.dim % t.ndim
            if out.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide into {n} shards")
            out = out.chunk(n, dim=dim)[coord[m]]
    return out


def distribute_tree(tree: Any, shardings: Any, mesh) -> Any:
    """``jax.device_put(tree, shardings)``: each leaf of ``tree`` (the same
    global values on every rank) as a DTensor on ``mesh`` with its
    placements from ``shardings`` (``resolve_tree``), holding this rank's
    shard only, a contiguous copy on the mesh's device."""
    from torch.distributed.tensor import DTensor
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)

    def one(t, places):
        places = tuple(places)
        local = local_shard(t, mesh, places).to(dev).clone(
            memory_format=torch.contiguous_format)
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=t.shape, stride=_stride(t.shape))

    return _map(one, tree, shardings)


def _stride(shape) -> Tuple[int, ...]:
    out, acc = [], 1
    for s in reversed(tuple(shape)):
        out.append(acc)
        acc *= s
    return tuple(reversed(out))


__all__ = ["Rules", "SERVE_RULES", "SERVE_RULES_HEADDIM", "TRAIN_RULES",
           "ZERO3_TRAIN_RULES", "distribute_tree", "local_shard",
           "mesh_sizes", "placements", "replicated_like", "resolve_parts",
           "resolve_spec", "resolve_tree"]
