"""A debug device mesh over ``torch.distributed``.

The port of the JAX package's ``launch/mesh.py::make_debug_mesh``: a
``("data", "model")`` mesh of ``data × model`` ranks, one device each.
``make_production_mesh`` (a TPU pod's 16 × 16 layout) waits for the
port's layout work (ROADMAP.md queue 1, layout and dryrun).

Where no process group exists, ``make_debug_mesh`` sets one up for a
single rank: ``nccl`` on CUDA (the default device) and ``gloo`` on the
CPU, over an in-memory ``HashStore``, so nothing opens a port.  A run of
more ranks sets up its own group first (its rendezvous, world size and
rank), and the mesh is laid over it.  ``destroy_process_group`` tears
either down.  Even at one rank the MoE's expert-parallel modes run their
collectives through the group, so NCCL's path runs on one card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

AXES = ("data", "model")


def make_debug_mesh(data: int = 1, model: int = 1,
                    device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh of shape (data, model) on ``device``'s
    type (CUDA unless asked otherwise).  Sets up a one-rank process group
    when none exists; raises when the group's world size is not
    ``data * model``."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if data * model != 1:
            raise ValueError(f"make_debug_mesh: a ({data}, {model}) mesh "
                             "needs a process group of that many ranks; "
                             "set one up first")
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_world_size() != data * model:
        raise ValueError(f"make_debug_mesh: ({data}, {model}) mesh over a "
                         f"process group of {dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)
