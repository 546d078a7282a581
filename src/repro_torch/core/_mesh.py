"""The port's mesh: a ``torch.distributed`` ``DeviceMesh`` with named axes.

The JAX package is single-controller: ``shard_map`` slices one global
array over ``jax.sharding.Mesh`` axes.  The port runs one process per rank
(SPMD): every rank holds the same global values, takes its own contiguous
block of rows, and ends with the same replicated states.  The JAX calls
map onto a ``DeviceMesh`` as

* ``mesh.shape[a]`` -> ``axis_size(mesh, a)`` (``mesh.size(dim)``);
* ``jax.lax.axis_index(a)`` -> ``mesh.get_local_rank(a)``;
* ``jax.lax.psum(x, axes)`` -> ``psum_tree(x, data_groups(mesh, axes))``,
  a gather of every rank's leaves in flat shard order folded left to
  right: ``acc = s0; acc = acc + s1; ...``.  That is the order in which
  the sequential ``nshards=`` oracle merges its shards, so the mesh run
  is bitwise the oracle.  An ``all_reduce`` (ring or tree) associates the
  sum another way and is never used.

A group whose backend cannot take CUDA tensors (gloo) gets each leaf
through pinned host memory, and the folded result goes back to the card:
the same fold, on the host.  The collectives stay outside the kernels.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.reduce_api import tree_map


def check_mesh(mesh):
    """``mesh`` itself, or TypeError naming what a mesh must be."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh= must be a torch.distributed.device_mesh.DeviceMesh with "
            f"mesh_dim_names (the port's jax.sharding.Mesh), got "
            f"{type(mesh).__name__}")
    if not mesh.mesh_dim_names:
        raise TypeError("mesh= needs mesh_dim_names: its axes are named, "
                        "as a jax.sharding.Mesh's are")
    return mesh


def _axes(axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axis: str) -> int:
    """``jax.sharding.Mesh.shape[axis]``."""
    names = mesh.mesh_dim_names
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r} (axes {names})")
    return int(mesh.size(names.index(axis)))


def num_shards(mesh, axes) -> int:
    """The number of shards over ``axes`` (the product of their sizes)."""
    n = 1
    for a in _axes(axes):
        n *= axis_size(mesh, a)
    return n


def shard_index(mesh, axes) -> int:
    """This rank's flat shard index over ``axes``, the first axis outermost:
    ``idx = idx * size(a) + local_rank(a)``, as the JAX package flattens
    ``axis_index`` over several data axes."""
    idx = 0
    for a in _axes(axes):
        idx = idx * axis_size(mesh, a) + int(mesh.get_local_rank(a))
    return idx


def data_groups(mesh, axes) -> Tuple:
    """The psum handle of ``axes``: their process groups, outermost first
    (``Statistic.psum_state``'s ``axis_names``)."""
    axes = _axes(axes)
    for a in axes:
        axis_size(mesh, a)
    return tuple(mesh.get_group(a) for a in axes)


def _groups(groups) -> Tuple:
    if isinstance(groups, (tuple, list)):
        return tuple(groups)
    return (groups,)


def _gather(flat: torch.Tensor, groups) -> list:
    """Every rank's ``flat`` in flat shard order: gathered over the
    innermost group first, then outward, so rank (i, j) of an (I, J) pair
    of axes lands at i·J + j."""
    parts = [flat]
    for g in reversed(groups):
        stacked = torch.stack(parts)
        out = [torch.empty_like(stacked)
               for _ in range(dist.get_world_size(g))]
        dist.all_gather(out, stacked, group=g)
        parts = [p for o in out for p in o.unbind(0)]
    return parts


def _stages_through_host(t: torch.Tensor, groups) -> bool:
    if not t.is_cuda:
        for g in groups:
            if dist.get_backend(g) == "nccl":
                raise ValueError("an NCCL group gathers CUDA tensors only; "
                                 "a CPU state needs a gloo mesh")
        return False
    return any("nccl" not in str(dist.get_backend(g)) for g in groups)


def psum_tensors(tensors: Sequence[torch.Tensor], groups) -> list:
    """Each tensor summed over the ranks of ``groups`` (a process group, or
    a sequence of them outermost first) by a fixed left fold in flat shard
    order.  Tensors of one dtype and device travel as one flat buffer a
    gather; the fold is elementwise, so that changes no bit."""
    groups = _groups(groups)
    out = list(tensors)
    buckets = {}
    for i, t in enumerate(tensors):
        buckets.setdefault((t.dtype, t.device), []).append(i)
    for idx in buckets.values():
        ts = [tensors[i] for i in idx]
        flat = torch.cat([t.reshape(-1) for t in ts])
        host = _stages_through_host(flat, groups)
        if host:
            staged = torch.empty(flat.shape, dtype=flat.dtype,
                                 pin_memory=True)
            staged.copy_(flat)
            flat = staged
        parts = _gather(flat, groups)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        if host:
            acc = acc.to(ts[0].device)
        off = 0
        for i, t in zip(idx, ts):
            out[i] = acc[off:off + t.numel()].reshape(t.shape)
            off += t.numel()
    return out


def gather_rows(t: torch.Tensor, groups) -> torch.Tensor:
    """Every rank's ``t`` over ``groups``, concatenated along dim 0 in flat
    shard order: ``shard_map``'s out_specs over a sharded leading axis,
    where every rank ends with the global array."""
    groups = _groups(groups)
    flat = t.reshape(-1)
    host = _stages_through_host(flat, groups)
    if host:
        flat = flat.cpu().pin_memory()
    parts = _gather(flat, groups)
    out = torch.cat([p.reshape(t.shape) for p in parts])
    return out.to(t.device) if host else out


def psum_tree(state, groups):
    """``psum_tensors`` over every leaf of a state tree."""
    leaves = []

    def take(t):
        leaves.append(t)
        return t

    tree_map(take, state)
    summed = iter(psum_tensors(leaves, groups))
    return tree_map(lambda _: next(summed), state)


def is_writer(mesh) -> bool:
    """Whether this rank writes what the mesh writes once (a checkpoint):
    the rank at coordinate 0 on every axis."""
    return all(c == 0 for c in mesh.get_coordinate())


def barrier(mesh) -> None:
    """Every rank of the mesh waits for every other: a barrier over each
    axis's group in turn (rank (i, j) waits for (i, 0), which waited for
    (0, 0))."""
    for a in mesh.mesh_dim_names:
        dist.barrier(group=mesh.get_group(a))
