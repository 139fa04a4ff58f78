"""Loader and launch of the CUDA SSD-scan kernel (csrc/ssd_scan.cu), built
with nvcc on first use (kernels/build.py).

``COUNTS["ssd_scan"]`` is bumped only where the kernel is launched, so a
run can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import build

SOURCE = "ssd_scan.cu"
COUNTS: Dict[str, int] = {"ssd_scan": 0}
MAX_TILE = 64               # steps per tile inside the kernel
SMEM_BYTES = 232448         # shared memory one block can hold (227 KB)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# x, dt, A, B, C, y, fs, batch, S, H, P, N, tq, dtype, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def smem_bytes(tq: int, p: int, n: int) -> int:
    """The kernel's shared memory for tiles of tq steps (csrc smem_floats)."""
    return 4 * (4 * tq + tq * (p + 1) + 2 * tq * (n + 1) + tq * (tq + 1) +
                p * (n + 1))


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           B: torch.Tensor, C: torch.Tensor, chunk: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the kernel on contiguous CUDA tensors: x (b, s, h, p) float32
    or bfloat16, dt (b, s, h) and A (h,) float32, B/C (b, s, n) of x's
    dtype.  Chunks of ``chunk`` steps are walked in tiles of at most 64.
    Returns (y (b, s, h, p) of x's dtype, final state (b, h, p, n)
    float32)."""
    dev = x.device
    for name, a in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if a.device != dev or dev.type != "cuda":
            raise ValueError(f"ssd_scan kernel: {name} on {a.device}, "
                             f"expected the CUDA device of x ({dev})")
        if not a.is_contiguous():
            raise ValueError(f"ssd_scan kernel: {name} is not contiguous")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"ssd_scan kernel takes float32 or bfloat16, got "
                        f"{x.dtype}")
    b, s, h, p = x.shape
    n = B.shape[-1]
    if dt.shape != (b, s, h) or A.shape != (h,) or B.shape != (b, s, n) or \
            C.shape != B.shape or dt.dtype != torch.float32 or \
            A.dtype != torch.float32 or B.dtype != x.dtype or \
            C.dtype != x.dtype:
        raise ValueError(
            f"ssd_scan kernel: x {tuple(x.shape)} {x.dtype}, dt "
            f"{tuple(dt.shape)} {dt.dtype}, A {tuple(A.shape)} {A.dtype}, "
            f"B {tuple(B.shape)} {B.dtype}, C {tuple(C.shape)} {C.dtype}")
    if chunk < 1:
        raise ValueError(f"ssd_scan kernel: chunk {chunk} < 1")
    tq = min(chunk, MAX_TILE)
    if smem_bytes(tq, p, n) > SMEM_BYTES:
        raise ValueError(f"ssd_scan kernel: head dim {p} and state {n} need "
                         f"{smem_bytes(tq, p, n)} bytes of shared memory, "
                         f"over {SMEM_BYTES}")
    if h > 65535 or b > 65535:
        raise ValueError(f"ssd_scan kernel: grid ({h}, {b}) over 65535")
    y = torch.empty_like(x)
    fs = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    if y.numel() == 0:
        return y, fs.zero_()
    rc = build.bind(SOURCE, "ssd_scan_launch", _ARGTYPES)(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), y.data_ptr(), fs.data_ptr(), b, s, h, p, n, tq,
        _DTYPE_CODES[x.dtype], torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: cudaError {rc}")
    COUNTS["ssd_scan"] += 1
    return y, fs
