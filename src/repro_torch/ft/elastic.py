"""Elastic scaling: rebuild the mesh at a new size and put a restored
checkpoint onto it.

Checkpoints hold full (unsharded) arrays keyed by tree path, so a restore
onto a mesh of any size is ``distribute_tensor`` of each leaf with that
mesh's placements (``CheckpointManager.restore(shardings=)``).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.device import resolve_device


def mesh_for_devices(n_devices: int, model_parallel: int = 16,
                     devices: Optional[Sequence[int]] = None,
                     device_type: Optional[str] = None):
    """The largest ("data", "model") ``DeviceMesh`` that fits
    ``n_devices``: the model axis halves from ``model_parallel`` until it
    divides them.  ``devices`` are the ranks to lay out (default: ranks
    0..n-1 of the default process group); ``device_type=None`` means the
    card ("cpu" for a gloo world on the host).  Every rank in the world
    calls it, as it creates each axis's process group."""
    from torch.distributed.device_mesh import DeviceMesh
    model = model_parallel
    while model > 1 and (n_devices % model or n_devices // model < 1):
        model //= 2
    data = n_devices // model
    ranks = list(range(n_devices)) if devices is None else list(devices)
    grid = torch.tensor(ranks[:data * model]).reshape(data, model)
    return DeviceMesh(resolve_device(device_type).type, grid,
                      mesh_dim_names=("data", "model"))


def elastic_restore(manager: CheckpointManager, template: Any,
                    shardings: Any, step: Optional[int] = None
                    ) -> Tuple[Any, dict]:
    """Restore a checkpoint onto a (possibly different-size) mesh."""
    return manager.restore(template, step=step, shardings=shardings)
