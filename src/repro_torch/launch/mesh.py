"""Production meshes, the JAX package's ``repro/launch/mesh.py`` as
``torch.distributed`` ``DeviceMesh``es with named axes.

Single pod: 16×16 = 256 ranks, axes ("data", "model").
Multi-pod:  2×16×16 = 512 ranks, axes ("pod", "data", "model"); batch
shards over "pod" too.

Functions, not module-level constants: importing this module touches no
process group.  ``init_device_mesh`` needs the default process group of
the mesh's size (``torch.distributed.init_process_group``, which the
caller starts); a mesh lives on the card unless ``device="cpu"``.
"""
from __future__ import annotations

from typing import Sequence


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group's ranks, in rank order (the last axis
    innermost)."""
    from torch.distributed.device_mesh import init_device_mesh
    if len(tuple(shape)) != len(tuple(axes)):
        raise ValueError(f"shape {tuple(shape)} and axes {tuple(axes)} "
                         f"differ in length")
    kind = "cuda" if device is None else str(device)
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}: use 'cuda' or "
                         f"'cpu'")
    return init_device_mesh(kind, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def data_axes_of(mesh) -> tuple:
    """The batch/sample-sharding axes of a production mesh."""
    names = tuple(mesh.mesh_dim_names or ())
    return tuple(a for a in ("pod", "data") if a in names)


__all__ = ["data_axes_of", "make_mesh", "make_production_mesh"]
