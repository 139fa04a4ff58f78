"""Loader and launch of the CUDA DDPM-step kernel (csrc/ddpm_step.cu).

One kernel serves both entry points of the JAX package's Pallas kernel:
the scalar entry is K = 1 slab, the batched entry K slabs, each with its
row of a (K, 3) fp32 coefficient table (inv_sqrt_alpha, coef, sigma).
The library is built with nvcc on first use (kernels/build.py).

``COUNTS`` holds one launch counter per entry point; each is bumped only
where that entry launches the kernel, so a run can show that its path went
through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build, refuse_grad

SOURCE = "ddpm_step.cu"
COUNTS: Dict[str, int] = {"ddpm_step": 0, "ddpm_step_batched": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SLABS = 65535          # grid.y
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def launch(x_t: torch.Tensor, eps_pred: torch.Tensor, noise: torch.Tensor,
           coef: torch.Tensor, entry: str) -> torch.Tensor:
    """Run the kernel on CUDA tensors: x_t/eps_pred/noise share one shape
    (K, ...) and dtype (float32 or bfloat16), ``coef`` is a (K, 3) float32
    table on the same device.  Returns a new tensor of x_t's dtype.
    Refuses inputs that need a gradient (no backward yet)."""
    refuse_grad("ddpm_step", x_t, eps_pred, noise, coef)
    if entry not in COUNTS:
        raise ValueError(f"unknown entry {entry!r}")
    dev = x_t.device
    for name, a in (("x_t", x_t), ("eps_pred", eps_pred), ("noise", noise),
                    ("coef", coef)):
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"ddpm_step kernel: {name} on {a.device}, "
                             f"expected the CUDA device of x_t ({dev})")
        if not a.is_contiguous():
            raise ValueError(f"ddpm_step kernel: {name} is not contiguous")
    if x_t.dtype not in _DTYPE_CODES:
        raise TypeError(f"ddpm_step kernel takes float32 or bfloat16, "
                        f"got {x_t.dtype}")
    for name, a in (("eps_pred", eps_pred), ("noise", noise)):
        if a.shape != x_t.shape or a.dtype != x_t.dtype:
            raise ValueError(
                f"ddpm_step kernel: {name} is {tuple(a.shape)} {a.dtype}, "
                f"x_t is {tuple(x_t.shape)} {x_t.dtype}")
    K = coef.shape[0]
    if coef.dtype != torch.float32 or coef.shape != (K, 3) or \
            not 1 <= K <= _MAX_SLABS or x_t.numel() % K:
        raise ValueError(f"ddpm_step kernel: coef {tuple(coef.shape)} "
                         f"{coef.dtype} does not fit x_t {tuple(x_t.shape)}")
    out = torch.empty_like(x_t)
    per = x_t.numel() // K
    if per == 0:
        return out
    rc = build.bind(SOURCE, "ddpm_step_launch", _ARGTYPES)(
        x_t.data_ptr(), eps_pred.data_ptr(), noise.data_ptr(),
        coef.data_ptr(), out.data_ptr(), K, per, _DTYPE_CODES[x_t.dtype],
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ddpm_step kernel launch failed: cudaError {rc}")
    COUNTS[entry] += 1
    return out
