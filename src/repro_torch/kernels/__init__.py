"""Hand-written CUDA kernels of the port, one package per kernel family.

Each family's ``cost.py`` gives a launch's bytes and operations from its
shapes.  Every launch adds its floating-point operations to ``FLOPS``
under its kernel's name: on the card where the kernel runs, and on the
``meta`` device, where a launch computes nothing and returns empty
outputs of the card's shapes and types (the dry run,
launch/dryrun.py).  ``torch.utils.flop_counter.FlopCounterMode`` sees
aten's products but not a ctypes launch, so a step's FLOPs are the aten
count plus ``total_flops()``, on the card and on meta alike.
"""
from __future__ import annotations

from typing import Dict

import torch

FLOPS: Dict[str, int] = {}


def add_flops(kernel: str, flops: int) -> None:
    """Count a launch's floating-point operations under ``kernel``."""
    FLOPS[kernel] = FLOPS.get(kernel, 0) + int(flops)


def reset_flops() -> None:
    FLOPS.clear()


def total_flops() -> int:
    return sum(FLOPS.values())


def raw_stream(device_index: int) -> int:
    """The raw handle of the current CUDA stream on ``device_index``, the
    last argument of every kernel launch.  ``torch._C`` is private: this
    call skips building a ``torch.cuda.Stream`` at every launch, and was
    checked on torch 2.11 (cu128) to return
    ``torch.cuda.current_stream(device_index).cuda_stream``;
    ``chip_smoke.py`` phase 3 checks that again on a side stream, so a
    torch that drops or changes it fails there."""
    return torch._C._cuda_getCurrentRawStream(device_index)
def refuse_grad(kernel: str, *tensors) -> None:
    """Raise if autograd would need a gradient through a raw ``launch``:
    an output filled through ctypes carries no ``grad_fn``, so a loss on
    the card would otherwise train nothing upstream of the kernel without
    an error.  Three kernels have a backward kernel: ``ops.flash_attention``,
    ``ops.ssd_scan`` and ``ops.grouped_matmul`` route an input that needs
    grad through their ``torch.autograd.Function`` (whose forward calls
    ``launch`` with grad off), but their raw ``launch`` still refuses, as
    the DDPM step's does (it has no backward).  Under ``no_grad`` (the
    samplers) or with no input that requires grad, it returns.  The plain
    versions on the CPU stay differentiable."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel's raw launch has no backward; an "
            "input requires grad with grad enabled.  Run it under "
            "torch.no_grad(), go through the op's autograd route where it "
            "has one (flash_attention, ssd_scan, grouped_matmul), or train "
            "on the CPU (the plain version is differentiable)")
