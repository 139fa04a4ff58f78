"""Loader and launch of the CUDA grouped-matmul kernel
(csrc/grouped_matmul.cu), built with nvcc on first use (kernels/build.py).

``COUNTS["grouped_matmul"]`` is bumped only where the kernel is launched,
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import build

SOURCE = "grouped_matmul.cu"
COUNTS: Dict[str, int] = {"grouped_matmul": 0}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535
_TILE_F = 64            # the smaller of the two variants' F-tiles
# tokens, weights, out, E, C, D, F, stride_e, stride_c, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + \
    [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p]


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def launch(tokens: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Run the kernel on CUDA tensors tokens (E, C, D) — any expert and
    row strides (0 for tokens broadcast to every expert), unit inner
    stride — and contiguous weights (E, D, F) of the same dtype (float32
    or bfloat16).  Returns a new contiguous (E, C, F) tensor of that
    dtype."""
    if tokens.ndim != 3 or weights.ndim != 3:
        raise ValueError(f"grouped_matmul kernel: tokens "
                         f"{tuple(tokens.shape)} and weights "
                         f"{tuple(weights.shape)} need 3 dimensions")
    if tokens.dtype not in _DTYPE_CODES or weights.dtype != tokens.dtype:
        raise TypeError(f"grouped_matmul kernel takes float32 or bfloat16 "
                        f"of one dtype, got {tokens.dtype} and "
                        f"{weights.dtype}")
    E, C, D = tokens.shape
    F = weights.shape[-1]
    if weights.shape != (E, D, F):
        raise ValueError(f"grouped_matmul kernel: tokens "
                         f"{tuple(tokens.shape)} do not fit weights "
                         f"{tuple(weights.shape)}")
    if not weights.is_contiguous():
        raise ValueError("grouped_matmul kernel: weights are not contiguous")
    if D > 1 and tokens.stride(2) != 1:
        raise ValueError("grouped_matmul kernel: tokens need a unit inner "
                         f"stride, got strides {tokens.stride()}")
    if E > _MAX_GRID_YZ or -(-F // _TILE_F) > _MAX_GRID_YZ:
        raise ValueError(f"grouped_matmul kernel: grid over "
                         f"{_MAX_GRID_YZ} for E {E}, F {F}")
    for name, a in (("tokens", tokens), ("weights", weights)):
        if a.device.type != "cuda" or a.device != tokens.device:
            raise ValueError(f"grouped_matmul kernel: {name} on {a.device}, "
                             "expected one CUDA device")
    out = torch.empty((E, C, F), dtype=tokens.dtype, device=tokens.device)
    if out.numel() == 0:
        return out
    se = tokens.stride(0) if E > 1 else 0
    sc = tokens.stride(1) if C > 1 else D
    rc = build.bind(SOURCE, "grouped_matmul_launch", _ARGTYPES)(
        tokens.data_ptr(), weights.data_ptr(), out.data_ptr(), E, C, D, F,
        se, sc, _DTYPE_CODES[tokens.dtype],
        torch.cuda.current_stream(tokens.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"grouped_matmul kernel launch failed: "
                           f"cudaError {rc}")
    COUNTS["grouped_matmul"] += 1
    return out
