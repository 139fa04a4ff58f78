"""Device meshes over ``torch.distributed``, and the card's constants.

The port of the JAX package's ``launch/mesh.py``:

* ``make_production_mesh`` lays the production layout, a ``(16, 16)``
  ``("data", "model")`` mesh (a ``(2, 16, 16)`` ``("pod", "data",
  "model")`` one with ``multi_pod``), over a FAKE process group of 256
  or 512 ranks (``torch.testing``'s ``FakeProcessGroup``: every
  collective returns at once and moves nothing), this process being rank
  0.  It is torch's counterpart of XLA's forced host device count: the
  dry run (launch/dryrun.py) reckons one rank's program on it, on the
  ``meta`` device.  It raises if a process group exists already, and only
  the dry run's own process calls it; ``make_fake_mesh`` lays any shape
  out the same way (the card's meta check reckons a (1, 1) one).
* ``make_debug_mesh``: a ``("data", "model")`` mesh of ``data × model``
  ranks, one device each.

Where no process group exists, ``make_debug_mesh`` (and
sharding/specs.py ``make_client_mesh``, through ``ensure_group``) set
one up for a single rank: ``nccl`` on CUDA (the default device) and
``gloo`` on the CPU, over an in-memory ``HashStore``, so nothing opens a
port.  A run of more ranks sets up its own group first (its rendezvous,
world size and rank), and the mesh is laid over it.
``destroy_process_group`` tears any of them down.  Even at one rank the
MoE's expert-parallel modes run their collectives through the group, so
NCCL's path runs on one card.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

AXES = ("data", "model")

# NVIDIA H100 SXM5 80GB data-sheet figures (dense, no sparsity, at the
# full 700 W power limit): the dry run's and chip_smoke.py's bounds
PEAK_FLOPS_BF16 = 989e12      # bf16 tensor-core rate, FLOP/s
PEAK_FLOPS_FP32 = 67e12       # float32 outside the tensor cores, FLOP/s
HBM_BW = 3.35e12              # device memory, bytes/s
NVLINK_BW = 450e9             # NVLink 4, bytes/s each way to the host's
                              # other cards (900 GB/s both ways)


def make_production_mesh(multi_pod: bool = False) -> DeviceMesh:
    """The production mesh over a fake process group of 256 (512 with
    ``multi_pod``) ranks; this process is rank 0."""
    if multi_pod:
        return make_fake_mesh((2, 16, 16), ("pod", "data", "model"))
    return make_fake_mesh((16, 16), AXES)


def make_fake_mesh(shape, axes=AXES) -> DeviceMesh:
    """A CPU mesh of ``shape`` over a fake process group of as many ranks,
    this process rank 0 (the dry run's reckoning at any size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("make_production_mesh: a process group exists "
                           "already; the fake group is for the dry run's "
                           "own process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(torch.tensor(shape).prod()))
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)


def ensure_group(device=None) -> torch.device:
    """Set up a process group of one rank where none exists: ``nccl`` on
    CUDA (the default device), ``gloo`` on the CPU, over a
    ``HashStore``.  Returns the device."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev


def make_debug_mesh(data: int = 1, model: int = 1,
                    device=None) -> DeviceMesh:
    """A ``("data", "model")`` mesh of shape (data, model) on ``device``'s
    type (CUDA unless asked otherwise).  Sets up a one-rank process group
    when none exists; raises when the group's world size is not
    ``data * model``."""
    dev = resolve_device(device)
    if not dist.is_initialized() and data * model != 1:
        raise ValueError(f"make_debug_mesh: a ({data}, {model}) mesh "
                         "needs a process group of that many ranks; "
                         "set one up first")
    ensure_group(dev)
    if dist.get_world_size() != data * model:
        raise ValueError(f"make_debug_mesh: ({data}, {model}) mesh over a "
                         f"process group of {dist.get_world_size()} ranks")
    return init_device_mesh(dev.type, (data, model), mesh_dim_names=AXES)

