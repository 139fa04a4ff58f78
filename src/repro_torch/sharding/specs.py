"""The batch axes of a mesh.

The port of two helpers of the JAX package's ``sharding/specs.py``,
``mesh_batch_axes`` and ``batch_axis_size``, over a
``torch.distributed.device_mesh.DeviceMesh``: its ``mesh_dim_names``
and ``size(dim)``.  The batch shards over ``("pod", "data")``, the
experts over ``"model"``.  The partition rules of the rest of that file
(parameter, optimizer and activation specs) serve the dry-run's 512-device
layout and are not ported (ROADMAP.md queue 1, layout and dryrun).
"""
from __future__ import annotations

from typing import Tuple


def mesh_batch_axes(mesh) -> Tuple[str, ...]:
    """The mesh's batch axes, of ``("pod", "data")``, in that order."""
    names = mesh.mesh_dim_names or ()
    return tuple(a for a in ("pod", "data") if a in names)


def batch_axis_size(mesh) -> int:
    """How many shards the batch is cut into: the product of the batch
    axes' sizes."""
    n = 1
    for a in mesh_batch_axes(mesh):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n
